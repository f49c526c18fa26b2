// 3x3 SAME conv + per-channel scale/bias + optional ReLU on NHWC, written as
// one contraction of depth K = 9*Cin over an implicit patch matrix, for
// fp32 x (bf16 or fp32 output). bf16 x runs on the tensor cores
// (tuk_tc_im2col_conv3x3 in tc_conv.cu, the implicit GEMM whose staged tile
// plus halo takes the patch matrix's place) and is refused here.
//
// Replaces the TPU kernel tpu_unet/kernels/im2col_conv.py
//   im2col_conv3x3  y = [relu](conv3x3_same(x, w) * scale + bias)
// whose weights are flattened [9*Cin, Cout], row (3*dy + dx)*Cin + c. The K
// loop below walks that order.
//
// What bounds it on the H100: at the narrow levels it is meant for (Cin <=
// 128) a pixel does 2*9*Cin*Cout FLOPs against (Cin + Cout) values moved, a
// few hundred FLOPs per byte, far above the fp32 ridge. It runs on the CUDA
// cores in fp32 FMA (67 TFLOP/s peak at 700 W; the port runs fp32 without
// TF32), so it is compute-bound. The TPU version was bound by its patch
// traffic: it wrote the whole [rows, 9*Cin] patch slab to VMEM and read it
// back. Here the patch never exists outside shared memory, and only kImKC of
// its K columns at a time: a block stages its input tile plus a 1-pixel halo
// once (all Cin channels, fp32, [180][Cin|1]), then for each K-chunk builds
// the [kImKC][128-pixel] patch slice from that tile, stages the matching
// [kImKC][64] slice of the flattened weights, and accumulates 4 pixels x 8
// output channels a thread in registers. Device memory sees each input pixel
// of the tile once per output-channel block, each weight once per block,
// each output once. Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py
// phase 2c): 5.39 ms at [4,572,572,64]->64 and 17.45 ms at
// [4,572,572,128]->64 (18 and 11 TFLOP/s), 1.6x and 3.1x cuDNN's fp32
// conv.
//
// Tile: 8 x 16 output pixels x 64 output channels per block, 256 threads.
// Grid: (tiles of the image, output-channel blocks, batch). Ragged tiles at
// the image edge are zero-filled on load and masked on store; a K-chunk past
// 9*Cin (Cin = 3 gives K = 27) is zero-filled.
//
// Rounding, as in the Pallas kernel and the plain version: inputs and
// weights in the input dtype, fp32 accumulation, the epilogue in fp32 as two
// separately rounded operations (acc*scale, then +bias), one rounding to the
// output dtype.

#include "common.cuh"

namespace tuk {

constexpr int kImTH = 8;                            // output tile rows
constexpr int kImTW = 16;                           // output tile columns
constexpr int kImP = kImTH * kImTW;                 // 128 output pixels a block
constexpr int kImHalo = (kImTH + 2) * (kImTW + 2);  // 180 staged input pixels
constexpr int kImKC = 32;                           // K columns per chunk
constexpr int kImMaxCin = 256;                      // the staged tile must fit

// Shared memory of one block: the patch chunk, the weight chunk, the tile.
// The tile's pixel stride is Cin rounded up to odd, so that threads reading
// neighbouring pixels of one channel hit different banks.
inline size_t im2col_smem_bytes(int cin) {
  return sizeof(float) * ((size_t)kImKC * kImP + (size_t)kImKC * kCOB + (size_t)kImHalo * (cin | 1));
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
    im2col_conv3x3_kernel(const TI* __restrict__ x, const TI* __restrict__ w,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          TO* __restrict__ out, int H, int W, int cin, int cout, int relu,
                          int tiles_w) {
  extern __shared__ __align__(16) float smem[];
  float* patch_s = smem;                    // [kImKC][kImP]
  float* w_s = patch_s + kImKC * kImP;      // [kImKC][kCOB]
  float* x_s = w_s + kImKC * kCOB;          // [kImHalo][cs]
  const int cs = cin | 1;

  const int n = blockIdx.z;
  const int co0 = blockIdx.y * kCOB;
  const int h0 = (blockIdx.x / tiles_w) * kImTH;
  const int w0 = (blockIdx.x % tiles_w) * kImTW;

  // The input tile plus its halo, every channel, zero outside the image.
  for (int idx = threadIdx.x; idx < kImHalo * cin; idx += kThreads) {
    const int c = idx % cin;
    const int pix = idx / cin;
    const int gh = h0 - 1 + pix / (kImTW + 2);
    const int gw = w0 - 1 + pix % (kImTW + 2);
    float v = 0.f;
    if (gh >= 0 && gh < H && gw >= 0 && gw < W) v = to_f(x[(((size_t)n * H + gh) * W + gw) * cin + c]);
    x_s[pix * cs + c] = v;
  }

  const int cg = threadIdx.x % (kCOB / kCG);       // 8 channel groups of 8
  const int p0 = (threadIdx.x / (kCOB / kCG)) * kPX;  // 32 groups of 4 pixels
  float acc[kPX][kCG] = {};
  const int K = 9 * cin;
  for (int k0 = 0; k0 < K; k0 += kImKC) {
    __syncthreads();  // the tile is staged; the previous chunk is consumed
    // patch_s[kk][p] = patch row p, column k0 + kk: tap (dy, dx), channel c.
    for (int idx = threadIdx.x; idx < kImKC * kImP; idx += kThreads) {
      const int p = idx % kImP;
      const int k = k0 + idx / kImP;
      float v = 0.f;
      if (k < K) {
        const int tap = k / cin;
        const int c = k - tap * cin;
        const int dy = tap / 3;
        const int dx = tap - 3 * dy;
        v = x_s[((p / kImTW + dy) * (kImTW + 2) + p % kImTW + dx) * cs + c];
      }
      patch_s[idx] = v;
    }
    // w_s[kk][j] = wflat[k0 + kk][co0 + j], zero past K or cout.
    for (int idx = threadIdx.x; idx < kImKC * kCOB; idx += kThreads) {
      const int j = idx % kCOB;
      const int k = k0 + idx / kCOB;
      const int co = co0 + j;
      w_s[idx] = (k < K && co < cout) ? to_f(w[(size_t)k * cout + co]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kImKC; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(patch_s + kk * kImP + p0);
      const float4* wp = reinterpret_cast<const float4*>(w_s + kk * kCOB + cg * kCG);
      const float4 wa = wp[0];
      const float4 wb = wp[1];
      const float pa[kPX] = {pv.x, pv.y, pv.z, pv.w};
      const float wv[kCG] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int i = 0; i < kPX; ++i)
#pragma unroll
        for (int j = 0; j < kCG; ++j) acc[i][j] = fmaf(pa[i], wv[j], acc[i][j]);
    }
  }

  const int gh = h0 + p0 / kImTW;
  const int gw0 = w0 + p0 % kImTW;
  if (gh >= H) return;
#pragma unroll
  for (int j = 0; j < kCG; ++j) {
    const int co = co0 + cg * kCG + j;
    if (co >= cout) continue;
    const float s = scale[co];
    const float t = bias[co];
#pragma unroll
    for (int i = 0; i < kPX; ++i) {
      const int gw = gw0 + i;
      if (gw < W) {
        float y = __fadd_rn(__fmul_rn(acc[i][j], s), t);
        if (relu) y = relu_f(y);
        out[(((size_t)n * H + gh) * W + gw) * cout + co] = from_f<TO>(y);
      }
    }
  }
}

template <typename TI, typename TO>
cudaError_t launch_im2col(const void* x, const void* w, const float* scale, const float* bias,
                          void* out, int n, int h, int wd, int cin, int cout, int relu,
                          cudaStream_t stream) {
  const size_t smem = im2col_smem_bytes(cin);
  cudaError_t err = cudaFuncSetAttribute(im2col_conv3x3_kernel<TI, TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (wd + kImTW - 1) / kImTW;
  const int tiles_h = (h + kImTH - 1) / kImTH;
  const dim3 grid(tiles_w * tiles_h, (cout + kCOB - 1) / kCOB, n);
  im2col_conv3x3_kernel<TI, TO><<<grid, kThreads, smem, stream>>>(
      static_cast<const TI*>(x), static_cast<const TI*>(w), scale, bias, static_cast<TO*>(out), h,
      wd, cin, cout, relu, tiles_w);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t launch_im2col_out(const void* x, const void* w, const float* scale, const float* bias,
                              void* out, int n, int h, int wd, int cin, int cout, int relu,
                              int out_dtype, cudaStream_t stream) {
  if (out_dtype == kBF16)
    return launch_im2col<TI, __nv_bfloat16>(x, w, scale, bias, out, n, h, wd, cin, cout, relu,
                                            stream);
  return launch_im2col<TI, float>(x, w, scale, bias, out, n, h, wd, cin, cout, relu, stream);
}

}  // namespace tuk

// The largest Cin whose staged tile fits a block's shared memory.
extern "C" int tuk_im2col_max_cin() { return tuk::kImMaxCin; }

// out[N,H,W,cout] = [relu](conv3x3_same(x, w) * scale + bias). x: [N,H,W,cin];
// wflat: [9*cin, cout], row (3*dy + dx)*cin + c (HWIO weights reshaped), in
// x's dtype; scale/bias: fp32 [cout]. dtype is x's, 0 (fp32: bf16 x runs on
// the tensor cores in tc_conv.cu and is refused here); out_dtype the
// output's, 0 fp32 or 1 bf16. Returns cudaGetLastError() after the launch.
extern "C" int tuk_im2col_conv3x3(const void* x, const void* wflat, const float* scale,
                                  const float* bias, void* out, int n, int h, int wd, int cin,
                                  int cout, int relu, int dtype, int out_dtype, void* stream) {
  if (dtype != tuk::kF32 || cin < 1 || cin > tuk::kImMaxCin) return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || wd == 0 || cout == 0) return 0;
  return tuk::launch_im2col_out<float>(x, wflat, scale, bias, out, n, h, wd, cin, cout, relu,
                                       out_dtype, static_cast<cudaStream_t>(stream));
}
