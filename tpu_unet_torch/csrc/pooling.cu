// 2x2 / stride-2 max pool on NHWC, floor mode (a trailing odd row or column
// is dropped, as torch.nn.MaxPool2d(2) does).
//
// Replaces the TPU kernel tpu_unet/kernels/pooling.py max_pool2x2. In the
// served forward (bf16 and fp32) the first three encoder pools come from the
// double conv's epilogue (tc_double_conv.cu); this kernel runs the fourth.
//
// What bounds it on the H100: device-memory bandwidth (3.35 TB/s). It reads
// each input element once and writes a quarter as many, with no arithmetic to
// speak of. Design: one elementwise pass in which each thread loads a 16-byte
// vector of channels (8 bf16 or 4 fp32) from each of the four window pixels,
// so neighbouring threads read neighbouring addresses. When the channel row is
// not a multiple of 16 bytes, or a pointer is not 16-byte aligned, it falls
// back to one element per thread. Grid-stride loop; no shared memory.

#include "common.cuh"

namespace tuk {

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// max that keeps NaN, as torch.maximum does; returns one of its inputs.
template <typename T>
__device__ __forceinline__ T max_keep_nan(T a, T b) {
  const float fa = to_f(a);
  const float fb = to_f(b);
  return (fa > fb || fa != fa) ? a : b;
}

template <typename T, int V>
__global__ void __launch_bounds__(256)
    max_pool2x2_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W, int C, int H2,
                       int W2, size_t total) {
  using VT = Vec<T, V>;
  const int cv = C / V;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int v = (int)(idx % cv);
    size_t pix = idx / cv;
    const int j = (int)(pix % W2);
    pix /= W2;
    const int i = (int)(pix % H2);
    const size_t n = pix / H2;
    const size_t base = ((n * H + 2 * i) * W + 2 * j) * C + (size_t)v * V;
    const size_t down = (size_t)W * C;
    const VT p00 = *reinterpret_cast<const VT*>(x + base);
    const VT p01 = *reinterpret_cast<const VT*>(x + base + C);
    const VT p10 = *reinterpret_cast<const VT*>(x + base + down);
    const VT p11 = *reinterpret_cast<const VT*>(x + base + down + C);
    VT r;
#pragma unroll
    for (int e = 0; e < V; ++e)
      r.v[e] = max_keep_nan(max_keep_nan(p00.v[e], p10.v[e]), max_keep_nan(p01.v[e], p11.v[e]));
    *reinterpret_cast<VT*>(out + ((n * H2 + i) * W2 + j) * C + (size_t)v * V) = r;
  }
}

template <typename T, int V>
cudaError_t launch_pool(const void* x, void* out, int n, int h, int w, int c, cudaStream_t stream) {
  const int h2 = h / 2;
  const int w2 = w / 2;
  const size_t total = (size_t)n * h2 * w2 * (c / V);
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  size_t blocks = (total + threads - 1) / threads;
  if (blocks > (1u << 20)) blocks = 1u << 20;
  max_pool2x2_kernel<T, V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), h, w, c, h2, w2, total);
  return cudaGetLastError();
}

}  // namespace tuk

// out[N,H/2,W/2,C] = max over each 2x2 window of x[N,H,W,C] (floor mode).
// dtype: 0 fp32, 1 bf16. Returns cudaGetLastError() after the launch.
extern "C" int tuk_max_pool2x2(const void* x, void* out, int n, int h, int w, int c, int dtype,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t elem = dtype == tuk::kBF16 ? 2 : 4;
  const bool vec = ((size_t)c * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (dtype == tuk::kBF16)
    return vec ? tuk::launch_pool<__nv_bfloat16, 8>(x, out, n, h, w, c, s)
               : tuk::launch_pool<__nv_bfloat16, 1>(x, out, n, h, w, c, s);
  return vec ? tuk::launch_pool<float, 4>(x, out, n, h, w, c, s)
             : tuk::launch_pool<float, 1>(x, out, n, h, w, c, s);
}

// Text of a CUDA error code, for the Python wrappers' messages.
extern "C" const char* tuk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
