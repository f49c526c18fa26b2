// Device helpers shared by the direct 3x3 convolution kernels
// (fused_conv.cu, fused_double_conv.cu) and the pool (pooling.cu).
//
// The conv kernels are direct convolutions on NHWC activations and HWIO
// weights, accumulated in fp32 on the CUDA cores. One block of kThreads
// threads owns a tile of output pixels and kCOB output channels; each thread
// owns kPX consecutive output columns of one row times kCG consecutive output
// channels (32 fp32 accumulators). The reduction axis (input channels x 9
// taps) streams through shared memory kKC input channels at a time: the input
// halo of the tile for those channels, converted to fp32, and the matching
// [9][kKC][kCOB] weight slice. Per staged (channel, kernel row) a thread reads
// 6 input values and 24 weights from shared memory and runs 96 FMAs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace tuk {

// dtype codes of the C interface (tpu_unet_torch/kernels/_build.py).
enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;            // threads per block
constexpr int kKC = 8;                   // input channels per staged chunk
constexpr int kCOB = 64;                 // output channels per block pass
constexpr int kCG = 8;                   // output channels per thread
constexpr int kPX = 4;                   // consecutive output columns per thread
constexpr int kCGroups = kCOB / kCG;     // 8 channel groups
constexpr int kSlots = kThreads / kCGroups;  // 32 pixel groups per pass
constexpr int kWChunk = 9 * kKC * kCOB;  // floats in one staged weight slice

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ReLU that keeps NaN, as torch.relu and jnp.maximum(x, 0) do.
__device__ __forceinline__ float relu_f(float y) { return y < 0.f ? 0.f : y; }

// w_s[(tap * kKC + c) * kCOB + j] = w[tap][k0 + c][co0 + j] (HWIO weights),
// zero past cin or cout.
template <typename T>
__device__ __forceinline__ void stage_weights(float* __restrict__ w_s, const T* __restrict__ w,
                                              int cin, int cout, int k0, int co0) {
  for (int idx = threadIdx.x; idx < kWChunk; idx += kThreads) {
    const int j = idx % kCOB;
    const int c = (idx / kCOB) % kKC;
    const int tap = idx / (kCOB * kKC);
    const int k = k0 + c;
    const int co = co0 + j;
    float v = 0.f;
    if (k < cin && co < cout) v = to_f(w[((size_t)tap * cin + k) * cout + co]);
    w_s[idx] = v;
  }
}

// in_s[(c * ih + r) * iw + col] = input channel k0 + c at image pixel
// (gh0 + r, gw0 + col) of batch item n, zero outside the image and past the
// channel count. The input is the channel concat of a [N,H,W,ca] and
// b [N,H,W,cb] without building it: channel k < ca reads a, others read b.
template <typename T>
__device__ __forceinline__ void stage_input(float* __restrict__ in_s, const T* __restrict__ a,
                                            const T* __restrict__ b, int ca, int cb, int n, int H,
                                            int W, int gh0, int gw0, int ih, int iw, int k0) {
  const int cin = ca + cb;
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
    if (k < cin && gh >= 0 && gh < H && gw >= 0 && gw < W) {
      const size_t p = ((size_t)n * H + gh) * W + gw;
      v = k < ca ? to_f(a[p * ca + k]) : to_f(b[p * cb + (k - ca)]);
    }
    in_s[(c * ih + r) * iw + col] = v;
  }
}

// acc[p][i][j] += sum over c < kc, ky, kx of
//   in_s[c][row_p + ky][col_p + i + kx] * w_s[ky * 3 + kx][c][cg * kCG + j]
// where off[p] = row_p * iw + col_p locates pixel group p in the staged
// region, whose origin is one pixel up and left of the output region.
template <typename TI, int NP>
__device__ __forceinline__ void accum_chunk(const TI* __restrict__ in_s, int ih, int iw, int kc,
                                            const float* __restrict__ w_s, int cg,
                                            const int (&off)[NP], float (&acc)[NP][kPX][kCG]) {
  const int plane = ih * iw;
#pragma unroll 2
  for (int c = 0; c < kc; ++c) {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      float wv[3][kCG];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float4* wp =
            reinterpret_cast<const float4*>(w_s + ((ky * 3 + kx) * kKC + c) * kCOB + cg * kCG);
        const float4 w0 = wp[0];
        const float4 w1 = wp[1];
        wv[kx][0] = w0.x; wv[kx][1] = w0.y; wv[kx][2] = w0.z; wv[kx][3] = w0.w;
        wv[kx][4] = w1.x; wv[kx][5] = w1.y; wv[kx][6] = w1.z; wv[kx][7] = w1.w;
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const TI* ir = in_s + c * plane + off[p] + ky * iw;
        float v[kPX + 2];
#pragma unroll
        for (int i = 0; i < kPX + 2; ++i) v[i] = to_f(ir[i]);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int i = 0; i < kPX; ++i)
#pragma unroll
            for (int j = 0; j < kCG; ++j) acc[p][i][j] = fmaf(v[i + kx], wv[kx][j], acc[p][i][j]);
      }
    }
  }
}

}  // namespace tuk
