// The train-mode 3x3 conv kernels on the CUDA cores (fp32 FMA), the fp32
// route: forward with BN prologue and batch-stat epilogue, and the two
// backward convolutions with the BN-backward cotangent built while staging.
//
// Routes (kernels/train_conv.py), replacing tpu_unet/kernels/train_conv.py:
//   conv3x3_fwd  z = conv3x3_same(relu(x*a + c), w), optional (sum z, sum z^2)
//                (:128);
//   conv3x3_dx   dx = conv3x3_same(dz, flip(w)^T), dz = alpha*g + beta*z + gamma
//                (:289);
//   conv3x3_dw   dw[ky,kx,ci,co] = sum over N*H*W of prologue(x) * dz
//                (:441).
// All three take fp32 only and refuse bf16 (cudaErrorInvalidValue): their
// bf16 calls run on the tensor cores (csrc/tc_conv.cu), which also call
// reduce_rows below.
//
// What bounds them on the H100: arithmetic. Every one is a 9*Cin*Cout
// contraction per pixel against a few values moved, so they are compute-
// bound. They run on the CUDA cores in fp32 FMA (67 TFLOP/s peak at 700 W),
// a kernel differing from its plain version only by summation order. What
// the design keeps out of device memory is what the Pallas kernels keep
// out: the normalized activation relu(x*a + c) and the cotangent dz exist
// only in shared memory, built from the raw tensors while they are staged.
//
// fwd and dx share the direct-conv core of common.cuh (8 x 16 output pixels
// x 64 output channels per block, the reduction streamed 8 input channels at
// a time); they differ only in the loader that stages the input. The Pallas
// kernels' whole-Cin weight blocks (several MB) do not fit the 227 KB of
// shared memory; streaming the reduction axis does.
//
// Rounding, as in the Pallas kernels: the prologue output is rounded to x's
// dtype, dz to g's dtype, both zeroed outside the image AFTER the affine
// (relu(c) != 0 would otherwise leak into the SAME padding); z is rounded to
// the output dtype before its statistics are taken.
//
// Blocks run in any order, and the batch statistics and dw are sums over
// N*H*W. Each block writes fp32 partial sums; reduce_rows (one or two more
// launches) adds them in a fixed order, so every result is deterministic.
//   * fwd stats: one [2][Cout] partial row per (image, 8x16 tile).
//   * dw: the N*H*W reduction is split across blocks (grid.z) so that the
//     shallow levels, whose dw has only 9*64*64 entries, still fill the card;
//     each split writes a whole [9][Cin][Cout] partial.

#include "common.cuh"

namespace tuk {

constexpr int kTH = 8;   // fwd/dx output tile rows
constexpr int kTW = 16;  // fwd/dx output tile columns

// ---- loaders: the value a kernel stages for pixel p, channel k (in-image) --

// Two fp32 operations rounded one at a time (no FMA contraction), as the
// plain PyTorch version computes them.
__device__ __forceinline__ float affine(float v, float a, float c) {
  return __fadd_rn(__fmul_rn(v, a), c);
}

template <typename T>
struct RawIn {
  const T* x;
  int c;
  __device__ __forceinline__ float operator()(size_t p, int k) const { return to_f(x[p * c + k]); }
};

// relu(x*a + c), rounded to x's dtype.
template <typename T>
struct ProIn {
  const T* x;
  const float* a;
  const float* b;
  int c;
  __device__ __forceinline__ float operator()(size_t p, int k) const {
    return to_f(from_f<T>(relu_f(affine(to_f(x[p * c + k]), a[k], b[k]))));
  }
};

// dz = alpha*g + beta*z + gamma, rounded to g's dtype. coef is fp32 [3][c].
template <typename T>
struct DzIn {
  const T* g;
  const T* z;
  const float* coef;
  int c;
  __device__ __forceinline__ float operator()(size_t p, int k) const {
    const size_t i = p * c + k;
    const float v = __fadd_rn(__fadd_rn(__fmul_rn(coef[k], to_f(g[i])),
                                        __fmul_rn(coef[c + k], to_f(z[i]))),
                              coef[2 * c + k]);
    return to_f(from_f<T>(v));
  }
};

// in_s[(c * ih + r) * iw + col] = ld(pixel (gh0 + r, gw0 + col) of image n,
// channel k0 + c); zero outside the image and past cin.
template <typename Loader>
__device__ __forceinline__ void stage_loaded(float* __restrict__ in_s, const Loader& ld, int cin,
                                             int n, int H, int W, int gh0, int gw0, int ih,
                                             int iw, int k0) {
  const int total = kKC * ih * iw;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int c = idx % kKC;
    const int pix = idx / kKC;
    const int r = pix / iw;
    const int col = pix - r * iw;
    const int gh = gh0 + r;
    const int gw = gw0 + col;
    const int k = k0 + c;
    float v = 0.f;
    if (k < cin && gh >= 0 && gh < H && gw >= 0 && gw < W)
      v = ld(((size_t)n * H + gh) * W + gw, k);
    in_s[(c * ih + r) * iw + col] = v;
  }
}

// ---- fwd and dx: out = conv3x3_same(staged input, w) ----------------------
//
// Grid: (tiles of the image, output-channel blocks of 64, batch). With
// `partials`, block (t, cb, n) also writes the (sum, sum of squares) of its
// rounded outputs per channel to partials[(n * tiles + t) * 2 * cout + s *
// cout + co].
template <typename TW, typename TO, typename Loader>
__global__ void __launch_bounds__(kThreads)
    tconv_kernel(Loader ld, int cin, const TW* __restrict__ w, TO* __restrict__ out,
                 float* __restrict__ partials, int H, int W, int cout, int tiles_w) {
  __shared__ __align__(16) float w_s[kWChunk];
  __shared__ float in_s[kKC * (kTH + 2) * (kTW + 2)];
  __shared__ float red_s[kThreads / 32][2][kCOB];

  const int n = blockIdx.z;
  const int co0 = blockIdx.y * kCOB;
  const int h0 = (blockIdx.x / tiles_w) * kTH;
  const int w0 = (blockIdx.x % tiles_w) * kTW;
  const int cg = threadIdx.x % kCGroups;
  const int slot = threadIdx.x / kCGroups;
  const int row = slot / (kTW / kPX);
  const int col = (slot % (kTW / kPX)) * kPX;
  const int off[1] = {row * (kTW + 2) + col};

  float acc[1][kPX][kCG] = {};
  for (int k0 = 0; k0 < cin; k0 += kKC) {
    __syncthreads();
    stage_loaded(in_s, ld, cin, n, H, W, h0 - 1, w0 - 1, kTH + 2, kTW + 2, k0);
    stage_weights(w_s, w, cin, cout, k0, co0);
    __syncthreads();
    accum_chunk<float, 1>(in_s, kTH + 2, kTW + 2, kKC, w_s, cg, off, acc);
  }

  const int gh = h0 + row;
  float s1[kCG], s2[kCG];
#pragma unroll
  for (int j = 0; j < kCG; ++j) {
    s1[j] = 0.f;
    s2[j] = 0.f;
    const int co = co0 + cg * kCG + j;
#pragma unroll
    for (int i = 0; i < kPX; ++i) {
      const int gw = w0 + col + i;
      if (gh < H && gw < W && co < cout) {
        const TO y = from_f<TO>(acc[0][i][j]);
        out[(((size_t)n * H + gh) * W + gw) * cout + co] = y;
        const float yf = to_f(y);
        s1[j] += yf;
        s2[j] += yf * yf;
      }
    }
  }
  if (partials == nullptr) return;

  // Threads of one channel group sit 8 lanes apart: add the warp's 4 of them,
  // then the 8 warps, in a fixed order.
#pragma unroll
  for (int j = 0; j < kCG; ++j) {
    s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], 8);
    s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], 16);
    s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], 8);
    s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], 16);
  }
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (lane < kCGroups) {
#pragma unroll
    for (int j = 0; j < kCG; ++j) {
      red_s[warp][0][lane * kCG + j] = s1[j];
      red_s[warp][1][lane * kCG + j] = s2[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * kCOB) {
    const int s = threadIdx.x / kCOB;
    const int j = threadIdx.x % kCOB;
    const int co = co0 + j;
    if (co < cout) {
      float v = 0.f;
      for (int q = 0; q < kThreads / 32; ++q) v += red_s[q][s][j];
      const size_t prow = (size_t)n * gridDim.x + blockIdx.x;
      partials[(prow * 2 + s) * cout + co] = v;
    }
  }
}

// Fixed-order sums of fp32 rows. Block (bx, g) adds rows g * group ...
// min(rows, (g + 1) * group) - 1 (row r at in + r * in_stride) of columns
// bx * 32 ...: thread (tx, ty) adds rows ty, ty + 32, ... of the group, then
// row 0 of the block adds the 32 sums in order and writes them to
// out + g * out_stride. out may be in itself: a block reads only its own
// rows and columns, and writes after it has read them.
__global__ void __launch_bounds__(1024)
    reduce_rows_kernel(const float* in, float* out, int rows, long long cols, long long in_stride,
                       int group, long long out_stride) {
  __shared__ float part[32][33];
  const long long c = (long long)blockIdx.x * 32 + threadIdx.x;
  const int r0 = blockIdx.y * group;
  const int r1 = min(rows, r0 + group);
  float v = 0.f;
  if (c < cols)
#pragma unroll 8
    for (int r = r0 + threadIdx.y; r < r1; r += 32) v += in[(size_t)r * in_stride + c];
  part[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float s = 0.f;
    for (int q = 0; q < 32; ++q) s += part[q][threadIdx.x];
    out[blockIdx.y * out_stride + c] = s;
  }
}

// out[c] = sum over r of in[r * cols + c], in an order fixed by rows and
// cols. Few columns (the batch statistics: 2 * cout) would give a handful of
// blocks, each reading thousands of rows: then a first launch sums groups
// of >= 256 rows into each group's first row, in place, with enough groups
// for about 4 blocks an SM, and a second launch adds the groups' rows.
// Wide ones (dw) take one launch. `in` is scratch: its contents are lost.
cudaError_t reduce_rows(float* in, float* out, int rows, long long cols, cudaStream_t stream) {
  const dim3 block(32, 32);
  const unsigned col_blocks = (unsigned)((cols + 31) / 32);
  const long long want = 4LL * 132 / col_blocks;  // row groups for ~4 blocks an SM
  int groups = (int)(want < (rows + 255) / 256 ? want : (rows + 255) / 256);
  if (groups <= 1) {
    reduce_rows_kernel<<<dim3(col_blocks, 1), block, 0, stream>>>(in, out, rows, cols, cols, rows,
                                                                   0);
    return cudaGetLastError();
  }
  const int group = (rows + groups - 1) / groups;
  groups = (rows + group - 1) / group;
  const long long stride = (long long)group * cols;
  reduce_rows_kernel<<<dim3(col_blocks, groups), block, 0, stream>>>(in, in, rows, cols, cols,
                                                                      group, stride);
  reduce_rows_kernel<<<dim3(col_blocks, 1), block, 0, stream>>>(in, out, groups, cols, stride,
                                                                 groups, 0);
  return cudaGetLastError();
}

inline int tiles_of(int h, int wd) { return ((h + kTH - 1) / kTH) * ((wd + kTW - 1) / kTW); }

template <typename TW, typename TO, typename Loader>
cudaError_t launch_tconv(const Loader& ld, int cin, const void* w, void* out, float* partials,
                         int n, int h, int wd, int cout, cudaStream_t stream) {
  const int tiles_w = (wd + kTW - 1) / kTW;
  const dim3 grid(tiles_of(h, wd), (cout + kCOB - 1) / kCOB, n);
  tconv_kernel<TW, TO, Loader><<<grid, kThreads, 0, stream>>>(
      ld, cin, static_cast<const TW*>(w), static_cast<TO*>(out), partials, h, wd, cout, tiles_w);
  return cudaGetLastError();
}

// fp32 only: the bf16 forward runs on the tensor cores (csrc/tc_conv.cu).
cudaError_t launch_fwd(const void* x, const float* a, const float* c, const void* w, void* z,
                       float* partials, float* stats, int n, int h, int wd, int cin, int cout,
                       cudaStream_t stream) {
  cudaError_t err;
  if (a != nullptr)
    err = launch_tconv<float, float>(ProIn<float>{static_cast<const float*>(x), a, c, cin}, cin,
                                     w, z, partials, n, h, wd, cout, stream);
  else
    err = launch_tconv<float, float>(RawIn<float>{static_cast<const float*>(x), cin}, cin, w, z,
                                     partials, n, h, wd, cout, stream);
  if (err != cudaSuccess || partials == nullptr) return err;
  return reduce_rows(partials, stats, n * tiles_of(h, wd), 2LL * cout, stream);
}

// ---- dw: partials[split][ky*3+kx][ci][co] over this split's tiles -----------
//
// A block owns 32 input x 64 output channels for all 9 taps (72 fp32
// accumulators a thread: 2 input x 4 output channels x 9 taps) and walks its
// split's 4 x 16 pixel tiles. Per tile it stages prologue(x) over the tile
// plus a 1-px halo, [6*18][32], and dz over the tile, [64][64], both fp32.
// Per pixel a thread reads 3 float2 of x (one new column per kernel row; the
// other two slide along the row in registers) and one float4 of dz for 72
// FMAs.
constexpr int kDwTH = 4;
constexpr int kDwTW = 16;
constexpr int kDwCI = 32;
constexpr int kDwCO = 64;
constexpr int kDwXW = kDwTW + 2;

template <typename XL, typename DL>
__global__ void __launch_bounds__(kThreads)
    dw_kernel(XL xl, int cin, DL dl, int cout, float* __restrict__ partials, int H, int W,
              int tiles_w, int tiles_per_img, int total_tiles, int tiles_per_split) {
  __shared__ __align__(16) float x_s[(kDwTH + 2) * kDwXW * kDwCI];
  __shared__ __align__(16) float d_s[kDwTH * kDwTW * kDwCO];

  const int ci0 = blockIdx.x * kDwCI;
  const int co0 = blockIdx.y * kDwCO;
  const int tx = threadIdx.x % (kDwCI / 2);  // input-channel pair
  const int ty = threadIdx.x / (kDwCI / 2);  // output-channel quad

  float acc[9][2][4] = {};
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(total_tiles, t_begin + tiles_per_split);
  for (int t = t_begin; t < t_end; ++t) {
    const int n = t / tiles_per_img;
    const int rem = t - n * tiles_per_img;
    const int h0 = (rem / tiles_w) * kDwTH;
    const int w0 = (rem % tiles_w) * kDwTW;
    __syncthreads();
    for (int idx = threadIdx.x; idx < (kDwTH + 2) * kDwXW * kDwCI; idx += kThreads) {
      const int ci = idx % kDwCI;
      const int pix = idx / kDwCI;
      const int gh = h0 - 1 + pix / kDwXW;
      const int gw = w0 - 1 + pix % kDwXW;
      const int k = ci0 + ci;
      float v = 0.f;
      if (k < cin && gh >= 0 && gh < H && gw >= 0 && gw < W)
        v = xl(((size_t)n * H + gh) * W + gw, k);
      x_s[idx] = v;
    }
    for (int idx = threadIdx.x; idx < kDwTH * kDwTW * kDwCO; idx += kThreads) {
      const int co = idx % kDwCO;
      const int pix = idx / kDwCO;
      const int gh = h0 + pix / kDwTW;
      const int gw = w0 + pix % kDwTW;
      const int k = co0 + co;
      float v = 0.f;
      if (k < cout && gh < H && gw < W) v = dl(((size_t)n * H + gh) * W + gw, k);
      d_s[idx] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int r = 0; r < kDwTH; ++r) {
      float2 win[3][3];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float2* xr = reinterpret_cast<const float2*>(x_s + (r + ky) * kDwXW * kDwCI) + tx;
        win[ky][0] = xr[0];
        win[ky][1] = xr[kDwCI / 2];
      }
#pragma unroll
      for (int j = 0; j < kDwTW; ++j) {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
          win[ky][2] = reinterpret_cast<const float2*>(
              x_s + ((r + ky) * kDwXW + j + 2) * kDwCI)[tx];
        const float4 d = reinterpret_cast<const float4*>(d_s + (r * kDwTW + j) * kDwCO)[ty];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            float* a0 = acc[ky * 3 + kx][0];
            float* a1 = acc[ky * 3 + kx][1];
            const float2 xv = win[ky][kx];
            a0[0] = fmaf(xv.x, d.x, a0[0]); a0[1] = fmaf(xv.x, d.y, a0[1]);
            a0[2] = fmaf(xv.x, d.z, a0[2]); a0[3] = fmaf(xv.x, d.w, a0[3]);
            a1[0] = fmaf(xv.y, d.x, a1[0]); a1[1] = fmaf(xv.y, d.y, a1[1]);
            a1[2] = fmaf(xv.y, d.z, a1[2]); a1[3] = fmaf(xv.y, d.w, a1[3]);
          }
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          win[ky][0] = win[ky][1];
          win[ky][1] = win[ky][2];
        }
      }
    }
  }

  float* dst = partials + (size_t)blockIdx.z * 9 * cin * cout;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ci = ci0 + 2 * tx + i;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int co = co0 + 4 * ty + q;
        if (ci < cin && co < cout) dst[((size_t)tap * cin + ci) * cout + co] = acc[tap][i][q];
      }
    }
}

struct DwPlan {
  int tiles_w, tiles_per_img, total_tiles, splits, tiles_per_split;
};

// Enough blocks for about 8 per SM (2 are resident at a time), as few
// splits as that allows: every split adds a [9][Cin][Cout] fp32 partial.
inline DwPlan dw_plan(int n, int h, int wd, int cin, int cout, int num_sms) {
  DwPlan p;
  p.tiles_w = (wd + kDwTW - 1) / kDwTW;
  p.tiles_per_img = ((h + kDwTH - 1) / kDwTH) * p.tiles_w;
  p.total_tiles = n * p.tiles_per_img;
  // Empty shapes (no tiles or no channels) must not divide by zero: they
  // plan 0 splits, and tuk_conv3x3_dw launches nothing for them.
  int blocks = ((cin + kDwCI - 1) / kDwCI) * ((cout + kDwCO - 1) / kDwCO);
  if (blocks < 1) blocks = 1;
  int splits = (8 * num_sms + blocks - 1) / blocks;
  if (splits > p.total_tiles) splits = p.total_tiles;
  if (splits < 1) splits = 1;
  p.tiles_per_split = (p.total_tiles + splits - 1) / splits;
  if (p.tiles_per_split < 1) p.tiles_per_split = 1;
  p.splits = (p.total_tiles + p.tiles_per_split - 1) / p.tiles_per_split;
  return p;
}

template <typename T, typename XL>
cudaError_t launch_dw(const XL& xl, const void* g, const void* z, const float* coef,
                      float* partials, float* dw, int n, int h, int wd, int cin, int cout,
                      int num_sms, cudaStream_t stream) {
  const DwPlan p = dw_plan(n, h, wd, cin, cout, num_sms);
  const DzIn<T> dl{static_cast<const T*>(g), static_cast<const T*>(z), coef, cout};
  const dim3 grid((cin + kDwCI - 1) / kDwCI, (cout + kDwCO - 1) / kDwCO, p.splits);
  dw_kernel<XL, DzIn<T>><<<grid, kThreads, 0, stream>>>(
      xl, cin, dl, cout, partials, h, wd, p.tiles_w, p.tiles_per_img, p.total_tiles,
      p.tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_rows(partials, dw, p.splits, 9LL * cin * cout, stream);
}

}  // namespace tuk

// Rows of the fp32 [rows][2][cout] stats scratch that tuk_conv3x3_fwd needs.
extern "C" int tuk_conv3x3_fwd_rows(int n, int h, int wd) { return n * tuk::tiles_of(h, wd); }

// z[N,H,W,cout] = conv3x3_same(pro(x), w) in x's dtype, pro(x) = relu(x*a + c)
// rounded to x's dtype when a is not null, else x. x: [N,H,W,cin],
// w: [3,3,cin,cout] HWIO, a/c: fp32 [cin]. With partials (fp32
// [tuk_conv3x3_fwd_rows][2][cout] scratch), stats (fp32 [2][cout]) receives
// (sum z, sum z^2) over the image, a second launch. dtype must be 0 (fp32):
// bf16 (1) returns cudaErrorInvalidValue, its route is tuk_tc_conv3x3_fwd.
extern "C" int tuk_conv3x3_fwd(const void* x, const float* a, const float* c, const void* w,
                               void* z, float* partials, float* stats, int n, int h, int wd,
                               int cin, int cout, int dtype, void* stream) {
  if (dtype != tuk::kF32) return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || wd == 0 || cout == 0) return 0;
  return tuk::launch_fwd(x, a, c, w, z, partials, stats, n, h, wd, cin, cout,
                         static_cast<cudaStream_t>(stream));
}

// out[N,H,W,cin] = conv3x3_same(dz, wT), dz = coef[0]*g + coef[1]*z + coef[2]
// per channel, never written out. g, z: [N,H,W,c]; wT: [3,3,c,cin] (the
// forward weights flipped and transposed); coef: fp32 [3][c]. dtype is g's,
// z's and wT's, out_dtype the output's: both must be 0 (fp32); bf16 (1)
// returns cudaErrorInvalidValue, its route is tuk_tc_conv3x3_dx.
extern "C" int tuk_conv3x3_dx(const void* g, const void* z, const float* coef, const void* wt,
                              void* out, int n, int h, int wd, int c, int cin, int dtype,
                              int out_dtype, void* stream) {
  if (dtype != tuk::kF32 || out_dtype != tuk::kF32) return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || wd == 0 || cin == 0) return 0;
  const tuk::DzIn<float> ld{static_cast<const float*>(g), static_cast<const float*>(z), coef, c};
  return tuk::launch_tconv<float, float>(ld, c, wt, out, nullptr, n, h, wd, cin,
                                         static_cast<cudaStream_t>(stream));
}

// Splits of the N*H*W reduction tuk_conv3x3_dw makes: its partials scratch is
// fp32 [splits][9][cin][cout].
extern "C" int tuk_conv3x3_dw_splits(int n, int h, int wd, int cin, int cout, int num_sms) {
  return tuk::dw_plan(n, h, wd, cin, cout, num_sms).splits;
}

// dw[3,3,cin,cout] fp32 = sum over N,H,W of pro(x)[n, y+ky-1, x+kx-1, ci] *
// dz[n, y, x, co], pro as in tuk_conv3x3_fwd (zero outside the image) and dz
// as in tuk_conv3x3_dx. x: [N,H,W,cin]; g, z: [N,H,W,cout]; all fp32 (dtype
// 0): bf16 (1) returns cudaErrorInvalidValue, its route is tuk_tc_conv3x3_dw.
extern "C" int tuk_conv3x3_dw(const void* x, const float* a, const float* c, const void* g,
                              const void* z, const float* coef, float* partials, float* dw, int n,
                              int h, int wd, int cin, int cout, int num_sms, int dtype,
                              void* stream) {
  if (dtype != tuk::kF32) return (int)cudaErrorInvalidValue;
  if (cin == 0 || cout == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0 || h == 0 || wd == 0)
    return (int)cudaMemsetAsync(dw, 0, sizeof(float) * 9 * (size_t)cin * cout, s);
  const float* xp = static_cast<const float*>(x);
  if (a != nullptr)
    return tuk::launch_dw<float>(tuk::ProIn<float>{xp, a, c, cin}, g, z, coef, partials, dw, n,
                                 h, wd, cin, cout, num_sms, s);
  return tuk::launch_dw<float>(tuk::RawIn<float>{xp, cin}, g, z, coef, partials, dw, n, h, wd,
                               cin, cout, num_sms, s);
}
