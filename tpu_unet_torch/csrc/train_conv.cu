// conv3x3_dx's fp32 route on the CUDA cores (fp32 FMA), and reduce_rows, the
// fixed-order sum that every tensor-core kernel's partials go through.
//
// Routes (kernels/train_conv.py), replacing tpu_unet/kernels/train_conv.py:
//   conv3x3_dx   dx = conv3x3_same(dz, flip(w)^T), dz = alpha*g + beta*z + gamma
//                (:289), fp32 here; its bf16 calls run on the tensor cores
//                (csrc/tc_conv.cu). conv3x3_fwd (:128) and conv3x3_dw (:441)
//                run on the tensor cores in both dtypes: fp32 in 3xTF32
//                (each operand split into a TF32 high part and the TF32
//                rounding of the rest, three products summed in fp32: about
//                2^-21 relative per product, fp32 accuracy where one TF32 pass
//                would lose about 2^-11), so no fp32 kernel of theirs is left
//                here.
//
// What bounds dx on the H100: arithmetic, a 9*Cin*Cout contraction per pixel
// against a few values moved. It runs on the CUDA cores in fp32 FMA (67
// TFLOP/s peak at 700 W), differing from its plain version only by summation
// order. What the design keeps out of device memory is what the Pallas
// kernel keeps out: the cotangent dz exists only in shared memory, built
// from g and z while they are staged (rounded to g's dtype, zero outside the
// image AFTER the affine).
//
// dx runs the direct-conv core of common.cuh (8 x 16 output pixels x 64
// output channels per block, the reduction streamed 8 input channels at a
// time). The Pallas kernel's whole-Cin weight blocks (several MB) do not fit
// the 227 KB of shared memory; streaming the reduction axis does.
//
// Blocks run in any order. reduce_rows adds fp32 partial rows (the tensor-
// core kernels' per-tile batch statistics and dw's per-split partials) in a
// fixed order, so every result is deterministic.

#include "common.cuh"

namespace tuk {

constexpr int kTH = 8;   // dx output tile rows
constexpr int kTW = 16;  // dx output tile columns

// ---- the loader: the value dx stages for pixel p, channel k (in-image) -----

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

// ---- dx: out = conv3x3_same(staged input, w) -------------------------------
//
// Grid: (tiles of the image, output-channel blocks of 64, batch).
template <typename TW, typename TO, typename Loader>
__global__ void __launch_bounds__(kThreads)
    tconv_kernel(Loader ld, int cin, const TW* __restrict__ w, TO* __restrict__ out, int H, int W,
                 int cout, int tiles_w) {
  __shared__ __align__(16) float w_s[kWChunk];
  __shared__ float in_s[kKC * (kTH + 2) * (kTW + 2)];

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
#pragma unroll
  for (int j = 0; j < kCG; ++j) {
    const int co = co0 + cg * kCG + j;
#pragma unroll
    for (int i = 0; i < kPX; ++i) {
      const int gw = w0 + col + i;
      if (gh < H && gw < W && co < cout)
        out[(((size_t)n * H + gh) * W + gw) * cout + co] = from_f<TO>(acc[0][i][j]);
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
cudaError_t launch_tconv(const Loader& ld, int cin, const void* w, void* out, int n, int h, int wd,
                         int cout, cudaStream_t stream) {
  const int tiles_w = (wd + kTW - 1) / kTW;
  const dim3 grid(tiles_of(h, wd), (cout + kCOB - 1) / kCOB, n);
  tconv_kernel<TW, TO, Loader><<<grid, kThreads, 0, stream>>>(
      ld, cin, static_cast<const TW*>(w), static_cast<TO*>(out), h, wd, cout, tiles_w);
  return cudaGetLastError();
}

}  // namespace tuk

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
  return tuk::launch_tconv<float, float>(ld, c, wt, out, n, h, wd, cin,
                                         static_cast<cudaStream_t>(stream));
}
