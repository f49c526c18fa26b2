// 2x2 / stride-2 max pool on NHWC, floor mode (a trailing odd row or column
// is dropped, as torch.nn.MaxPool2d(2) does).
//
// Replaces the TPU kernel tpu_unet/kernels/pooling.py max_pool2x2. In the
// served forward (bf16 and fp32) the first three encoder pools come from the
// double conv's epilogue (tc_double_conv.cu); this kernel runs the fourth,
// at down3's output [1,80,119,512].
//
// What bounds it on the H100: device-memory bandwidth (3.35 TB/s). It reads
// each input element once and writes a quarter as many, with no arithmetic to
// speak of. At the served shape (12.2 MB in bf16, just written by down3's
// conv, so mostly in L2) the kernel takes a few microseconds of device time,
// less than the host's time to launch it (PERF.md). Its first version, one
// 16-byte vector a thread in a grid-stride loop, paid six 64-bit divides and
// modulos a vector and converted each bf16 element to float twice a max.
// Design:
// * no divide on the hot path: a block of tx x py threads owns one output
//   row (n, i) and py of its pixels, found from blockIdx.x once; thread
//   (tx, ty) moves channel vectors tx, tx + tx_count, ... of one output
//   pixel; offsets inside a row pair are 32-bit (the wrapper checks that
//   2 * W * C fits);
// * bf16 maxima two at a time, __hmax2_nan on __nv_bfloat162 (NaN kept, as
//   torch.maximum and jnp.maximum keep it); fp32 by compare and select;
// * bf16 loads read-only with no L1 allocation (each byte is read once),
//   which timed faster at [1,640,959,64] on the H100 than a plain or __ldg
//   load; fp32 loads by __ldg, where no_allocate timed slower;
// * one output vector a thread: 2 or 4 a thread, each thread's loads issued
//   before its first max, timed no faster at [1,640,959,64] and slower at
//   the served shape, whose fewer blocks then leave SMs idle;
// * the plan (kernels/pooling.py pool_plan) says whether the vectors are
//   16 bytes: a channel row that is not a multiple of 16 bytes, or a
//   pointer that is not 16-byte aligned, takes the scalar path (one
//   element a vector).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tuk {

// dtype codes of the C interface (tpu_unet_torch/kernels/_build.py).
enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kPoolThreads = 128;  // the most threads a block (tx * py)

// max that keeps NaN, as torch.maximum does.
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ __nv_bfloat16 max_nan(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __hmax_nan(a, b);
}

// The same on a 32-bit word: two bf16 or one fp32.
template <typename T>
__device__ __forceinline__ uint32_t max_word(uint32_t a, uint32_t b);
template <>
__device__ __forceinline__ uint32_t max_word<__nv_bfloat16>(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmax2_nan(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                       *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}
template <>
__device__ __forceinline__ uint32_t max_word<float>(uint32_t a, uint32_t b) {
  return __float_as_uint(max_nan(__uint_as_float(a), __uint_as_float(b)));
}

// A channel vector: 16 bytes (V = 16 / sizeof(T)) or one element (V = 1).
template <typename T, int V>
struct Pack {
  using type = uint4;
  static __device__ __forceinline__ uint4 load(const T* p) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      uint4 v;
      asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
          : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
          : "l"(p));
      return v;
    } else {
      return __ldg(reinterpret_cast<const uint4*>(p));
    }
  }
  static __device__ __forceinline__ uint4 max(uint4 a, uint4 b) {
    return make_uint4(max_word<T>(a.x, b.x), max_word<T>(a.y, b.y), max_word<T>(a.z, b.z),
                      max_word<T>(a.w, b.w));
  }
  static __device__ __forceinline__ void store(T* p, uint4 v) { *reinterpret_cast<uint4*>(p) = v; }
};
template <typename T>
struct Pack<T, 1> {
  using type = T;
  static __device__ __forceinline__ T load(const T* p) { return __ldg(p); }
  static __device__ __forceinline__ T max(T a, T b) { return max_nan(a, b); }
  static __device__ __forceinline__ void store(T* p, T v) { *p = v; }
};

// Grid: rows * chunks blocks, rows = N * H2 output rows, chunks =
// ceil(W2 / py); block b is row b / chunks, chunk b % chunks. Thread
// (tx, ty) owns channel vectors tx, tx + tx_count, ... of output pixel
// chunk * py + ty.
template <typename T, int V>
__global__ void __launch_bounds__(kPoolThreads)
    max_pool2x2_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W, int C, int H2,
                       int W2, int chunks) {
  using P = Pack<T, V>;
  const int row = blockIdx.x / chunks;
  const int j = (blockIdx.x - row * chunks) * blockDim.y + threadIdx.y;
  if (j >= W2) return;
  const int n = row / H2;
  const int i = row - n * H2;
  const T* in0 = x + ((size_t)n * H + 2 * i) * (size_t)W * C;  // input row 2i
  const T* in1 = in0 + (size_t)W * C;                           // and 2i + 1
  T* o = out + (size_t)row * W2 * C + j * C;
  for (int cv = threadIdx.x; cv < C / V; cv += blockDim.x) {
    const int off = 2 * j * C + cv * V;  // pixel 2j of both rows
    const typename P::type p00 = P::load(in0 + off), p01 = P::load(in0 + off + C);
    const typename P::type p10 = P::load(in1 + off), p11 = P::load(in1 + off + C);
    // rows first, then columns: the plain version's order
    P::store(o + cv * V, P::max(P::max(p00, p10), P::max(p01, p11)));
  }
}

template <typename T, int V>
cudaError_t launch_pool(const void* x, void* out, int n, int h, int w, int c, int tx, int py,
                        cudaStream_t stream) {
  const int h2 = h / 2;
  const int w2 = w / 2;
  if (n == 0 || h2 == 0 || w2 == 0 || c == 0) return cudaSuccess;
  const long long chunks = (w2 + py - 1) / py;
  const long long blocks = (long long)n * h2 * chunks;
  if (tx < 1 || py < 1 || tx * py > kPoolThreads || c % V != 0 || 2LL * w * c > 0x7fffffffLL ||
      blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  max_pool2x2_kernel<T, V><<<(unsigned)blocks, dim3(tx, py), 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), h, w, c, h2, w2, (int)chunks);
  return cudaGetLastError();
}

}  // namespace tuk

// out[N,H/2,W/2,C] = max over each 2x2 window of x[N,H,W,C] (floor mode).
// dtype: 0 fp32, 1 bf16. The plan (kernels/pooling.py pool_plan): vec, the
// channels of a vector (16 bytes' worth: x and out 16-byte aligned and C a
// multiple; or 1), and the block's tx x py threads. Returns
// cudaGetLastError() after the launch.
extern "C" int tuk_max_pool2x2(const void* x, void* out, int n, int h, int w, int c, int dtype,
                               int vec, int tx, int py, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int wide = dtype == tuk::kBF16 ? 8 : 4;  // channels in 16 bytes
  if (vec == wide && (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                      reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (vec != wide && vec != 1) return (int)cudaErrorInvalidValue;
  if (dtype == tuk::kBF16)
    return vec == 8 ? (int)tuk::launch_pool<__nv_bfloat16, 8>(x, out, n, h, w, c, tx, py, s)
                    : (int)tuk::launch_pool<__nv_bfloat16, 1>(x, out, n, h, w, c, tx, py, s);
  return vec == 4 ? (int)tuk::launch_pool<float, 4>(x, out, n, h, w, c, tx, py, s)
                  : (int)tuk::launch_pool<float, 1>(x, out, n, h, w, c, tx, py, s);
}

// Text of a CUDA error code, for the Python wrappers' messages.
extern "C" const char* tuk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
