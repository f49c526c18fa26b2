// Device helpers and constants of the CUDA-core kernels: the fp32 im2col
// conv (im2col_conv.cu) and the 2x2 max pool (pooling.cu). The im2col conv
// owns a block of kThreads threads, a tile of output pixels and kCOB output
// channels; each thread owns kPX consecutive output columns of one row times
// kCG consecutive output channels, accumulated in fp32 on the CUDA cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace tuk {

// dtype codes of the C interface (tpu_unet_torch/kernels/_build.py).
enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;            // threads per block
constexpr int kCOB = 64;                 // output channels per block pass
constexpr int kCG = 8;                   // output channels per thread
constexpr int kPX = 4;                   // consecutive output columns per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ReLU that keeps NaN, as torch.relu and jnp.maximum(x, 0) do.
__device__ __forceinline__ float relu_f(float y) { return y < 0.f ? 0.f : y; }

}  // namespace tuk
