// Fused 3x3 SAME conv + per-channel scale/bias (folded BatchNorm) + optional
// ReLU on NHWC, on the CUDA cores in fp32 FMA, for fp32 tensors only. It
// serves one route (kernels/fused_conv.py): the fp32
// fused_conv3x3_scale_relu (tpu_unet/kernels/fused_conv.py:75, cb == 0).
// The kernel still reads an optional second input as if it were
// channel-concatenated after the first (cb > 0), but no wrapper passes one:
// fused_conv3x3_concat_scale_relu (tpu_unet/kernels/fused_conv.py:192) runs
// on the tensor cores in both dtypes (csrc/tc_conv.cu; fp32 in 3xTF32), as
// does the bf16 single conv, and bf16 is refused here.
//
// What bounds it on the H100: arithmetic. A U-Net level does 2*9*Cin*Cout
// FLOPs per pixel against (Cin + Cout) activations moved, hundreds of FLOPs
// per byte, so the kernel is compute-bound. It runs on the CUDA cores in
// fp32 FMA (67 TFLOP/s peak at 700 W): the port runs fp32 without TF32, so
// fp32 results differ from the plain version only by summation order. Its
// design keeps the FMA units fed from registers: each thread holds a
// 4-pixel x 8-channel accumulator tile, and each staged (channel, kernel
// row) costs 6 + 24 shared-memory reads for 96 FMAs. The Pallas kernel's
// whole-Cin weight block (several MB at Cin=1024) does not fit the 227 KB of
// shared memory, so the reduction axis streams in chunks of kKC input
// channels (24 KB per chunk). Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 2): 2.2-2.9 ms at the served single-conv shapes
// (about 4.5e10 FLOP each), 1.4-1.7x cuDNN's fp32 conv. Its route waits
// first in the queue of fp32 tensor-core work (ROADMAP Queue 2): one TF32
// pass (about 2^-11 a product) would change the numerics the port holds
// fp32 to, but 3xTF32 does not (each operand split into a TF32 high part
// and the TF32 rounding of the rest, three products summed in fp32: about
// 2^-21 a product), as the fp32 convs of csrc/tc_conv.cu already run.
//
// Tile: 8 x 16 output pixels x 64 output channels per block, 256 threads.
// Grid: (tiles of the image, output-channel blocks, batch). Ragged tiles at
// the image edge are masked on load (zero padding) and on store.

#include "common.cuh"

namespace tuk {

constexpr int kTH = 8;   // output tile rows
constexpr int kTW = 16;  // output tile columns

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const T* __restrict__ a, const T* __restrict__ b, int ca, int cb,
                   const T* __restrict__ w, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ out, int H, int W, int cout,
                   int relu, int tiles_w) {
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
  const int cin = ca + cb;

  float acc[1][kPX][kCG] = {};
  for (int k0 = 0; k0 < cin; k0 += kKC) {
    __syncthreads();
    stage_input(in_s, a, b, ca, cb, n, H, W, h0 - 1, w0 - 1, kTH + 2, kTW + 2, k0);
    stage_weights(w_s, w, cin, cout, k0, co0);
    __syncthreads();
    accum_chunk<float, 1>(in_s, kTH + 2, kTW + 2, kKC, w_s, cg, off, acc);
  }

  const int gh = h0 + row;
  if (gh >= H) return;
  const int cbase = co0 + cg * kCG;
#pragma unroll
  for (int j = 0; j < kCG; ++j) {
    const int co = cbase + j;
    if (co < cout) {
      const float s = scale[co];
      const float t = bias[co];
#pragma unroll
      for (int i = 0; i < kPX; ++i) {
        const int gw = w0 + col + i;
        if (gw < W) {
          float y = acc[0][i][j] * s + t;
          if (relu) y = relu_f(y);
          out[(((size_t)n * H + gh) * W + gw) * cout + co] = from_f<T>(y);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_conv(const void* a, const void* b, int ca, int cb, const void* w, const float* scale,
                   const float* bias, void* out, int n, int h, int wd, int cout, int relu,
                   cudaStream_t stream) {
  const int tiles_w = (wd + kTW - 1) / kTW;
  const int tiles_h = (h + kTH - 1) / kTH;
  const dim3 grid(tiles_w * tiles_h, (cout + kCOB - 1) / kCOB, n);
  conv3x3_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), ca, cb, static_cast<const T*>(w), scale,
      bias, static_cast<T*>(out), h, wd, cout, relu, tiles_w);
  return cudaGetLastError();
}

}  // namespace tuk

// out[N,H,W,cout] = [relu](conv3x3_same(concat(a, b), w) * scale + bias).
// a: [N,H,W,ca], b: [N,H,W,cb] (cb may be 0; b is then not read),
// w: [3,3,ca+cb,cout] HWIO, scale/bias: fp32 [cout]. dtype: 0 fp32 (bf16,
// 1, runs on the tensor cores in tc_conv.cu and is refused here). Returns
// cudaGetLastError() after the launch.
extern "C" int tuk_conv3x3(const void* a, const void* b, int ca, int cb, const void* w,
                           const float* scale, const float* bias, void* out, int n, int h, int wd,
                           int cout, int relu, int dtype, void* stream) {
  if (dtype != tuk::kF32) return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || wd == 0 || cout == 0) return 0;
  return tuk::launch_conv<float>(a, b, ca, cb, w, scale, bias, out, n, h, wd, cout, relu,
                                 static_cast<cudaStream_t>(stream));
}
