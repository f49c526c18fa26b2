// Multi-tensor kernels of the train step's update: the gradient clip's
// squared sums and its scaling, and the RMSprop update, each over every leaf
// of the params tree in one launch.
//
// Replaces no Pallas kernel: the JAX package leaves the clip and the update
// to XLA, which fuses each into a few loops over the whole tree. The port ran
// them as PyTorch ops on each leaf, about 18 a leaf (64 leaves in the U-Net,
// 100 in Attention U-Net), and the host's time to dispatch them, 25-35 us
// each, was as long as the rest of a bf16 step's device work: the step was
// paced by the host. These kernels do the same arithmetic in 4 launches a
// step (kernels/multi_tensor.py says which).
//
// What bounds them on the H100: device-memory bandwidth (3.35 TB/s). The
// update reads p, g, square_avg and momentum_buf once each and writes p,
// square_avg and momentum_buf: 28 bytes a value in fp32, about 0.87 GB for
// the U-Net's 31.0M values, 0.26 ms. The clip reads g twice (the squared
// sums, then the scaling) and writes it once, 12 bytes a value, 0.11 ms.
// Design:
// * a table of leaves passed by value as the kernel's parameter (CUDA 12.1
//   and later take 32 KB of parameters), up to kMaxLeaves leaves a launch;
//   a larger tree takes one launch per kMaxLeaves leaves;
// * each block owns one chunk of kChunk values of one leaf, found by a
//   binary search of the table's first block of each leaf; a thread walks
//   groups of 4 values, as one 16-byte (fp32) or 8-byte (bf16) vector where
//   every pointer of the leaf is aligned to it, else value by value;
// * the arithmetic is the plain version's, op for op: each torch op rounds
//   its fp32 result, so each step here is an __f*_rn intrinsic (no
//   contraction into FMA), with the constants rounded to fp32 as torch rounds
//   a Python scalar, and results rounded to bf16 as torch's cast rounds
//   (__float2bfloat16 on sm_80 and later). The update is then bitwise the
//   plain version's;
// * the squared sums are deterministic: each block adds its chunk's squares
//   (each squared in fp32, as the plain version squares) in double, in an
//   order fixed by the shapes, into one partial a chunk; one more block adds
//   each leaf's partials in chunk order, rounds the sum to fp32 and then
//   adds the leaves' sums in leaf order in fp32, as the plain version adds
//   them, before the square root;
// * the clip's coefficient is computed on the device from the norm there:
//   no value goes to the host and nothing synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12010
#error "multi_tensor.cu passes its leaf tables as kernel parameters of up to 32 KB: CUDA >= 12.1"
#endif

namespace tuk {
namespace mt {

// dtype codes of the C interface (tpu_unet_torch/kernels/_build.py).
enum DType : int { kF32 = 0, kBF16 = 1 };

// Mirrored in kernels/multi_tensor.py (a CPU test checks that they agree).
constexpr int kChunk = 32768;     // values of one leaf a block
constexpr int kMaxLeaves = 256;   // leaves of one launch's table
constexpr int kThreads = 256;     // threads a block

// The leaves of one launch: K pointers each, their values, and the first
// block of each (first_block[count] is the launch's number of blocks).
template <int K>
struct Table {
  void* ptr[kMaxLeaves][K];
  long long numel[kMaxLeaves];
  int first_block[kMaxLeaves + 1];
  int count;
};
static_assert(sizeof(Table<7>) + 64 <= 32764, "a table must fit the kernel parameter space");

// The leaf of block b: the last leaf whose first block is at most b.
template <int K>
__device__ __forceinline__ int leaf_of(const Table<K>& t, int b) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_block[mid] <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four values from i on: one vector when `vec`, else value by value; values
// at or past `end` read as 0.
template <typename T>
__device__ __forceinline__ void load4(const T* p, long long i, long long end, bool vec,
                                      float v[4]) {
  if (vec && i + 4 <= end) {
    if constexpr (sizeof(T) == 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(p + i);
      v[0] = __uint_as_float(x.x << 16), v[1] = __uint_as_float(x.x & 0xffff0000u);
      v[2] = __uint_as_float(x.y << 16), v[3] = __uint_as_float(x.y & 0xffff0000u);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = i + k < end ? to_float(p[i + k]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store4(T* p, long long i, long long end, bool vec,
                                       const float v[4]) {
  if (vec && i + 4 <= end) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      const __nv_bfloat162 lo = __halves2bfloat162(from_float<T>(v[0]), from_float<T>(v[1]));
      const __nv_bfloat162 hi = __halves2bfloat162(from_float<T>(v[2]), from_float<T>(v[3]));
      *reinterpret_cast<uint2*>(p + i) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                     *reinterpret_cast<const uint32_t*>(&hi));
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (i + k < end) p[i + k] = from_float<T>(v[k]);
}

// Whether a pointer takes 4-value vectors of T.
template <typename T>
__device__ __forceinline__ bool aligned4(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

// The block's chunk of its leaf: [start, end).
struct Span {
  int leaf;
  long long start, end;
};
template <int K>
__device__ __forceinline__ Span chunk_of(const Table<K>& t) {
  const int leaf = leaf_of(t, blockIdx.x);
  const long long start = (long long)(blockIdx.x - t.first_block[leaf]) * kChunk;
  const long long end = min(t.numel[leaf], start + kChunk);
  return {leaf, start, end};
}

// partial[b] = the sum of the squares of block b's chunk, in double.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sumsq_kernel(const __grid_constant__ Table<1> t, double* partial) {
  const Span s = chunk_of(t);
  const T* g = static_cast<const T*>(t.ptr[s.leaf][0]);
  const bool vec = aligned4<T>(g);
  double acc = 0.0;
  for (long long i = s.start + 4LL * threadIdx.x; i < s.end; i += 4LL * kThreads) {
    float v[4];
    load4(g, i, s.end, vec, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc += (double)__fmul_rn(v[k], v[k]);
  }
  __shared__ double part[kThreads];
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.x] = part[0];
}

// The chunks of each leaf of one page of leaves: leaf leaf0 + i owns
// partials first[i] ... first[i + 1] - 1.
struct FinishTable {
  int first[kMaxLeaves + 1];
  int count;
  int leaf0;
};

// leaf_sq[leaf0 + i] = leaf i's partials added in chunk order, rounded to
// fp32; with `total`, then *total = sqrt of leaf_sq[0 .. leaves) added in
// leaf order in fp32 (the leaves of earlier pages were written by earlier
// launches on the same stream).
__global__ void __launch_bounds__(kMaxLeaves)
    sumsq_finish_kernel(const __grid_constant__ FinishTable t, const double* partial,
                        float* leaf_sq, float* total, int leaves) {
  for (int i = threadIdx.x; i < t.count; i += blockDim.x) {
    double s = 0.0;
    for (int c = t.first[i]; c < t.first[i + 1]; ++c) s += partial[c];
    leaf_sq[t.leaf0 + i] = (float)s;
  }
  if (total == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int i = 0; i < leaves; ++i) sum = __fadd_rn(sum, leaf_sq[i]);
    *total = __fsqrt_rn(sum);
  }
}

// out = g * coef rounded to g's dtype, coef = min(max_norm / (total +
// clip_eps), 1) as torch computes it: reciprocal, times max_norm, clamped
// (a NaN kept).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    scale_kernel(const __grid_constant__ Table<2> t, const float* total, float max_norm,
                 float clip_eps) {
  const Span s = chunk_of(t);
  const T* g = static_cast<const T*>(t.ptr[s.leaf][0]);
  T* out = static_cast<T*>(t.ptr[s.leaf][1]);
  const bool vec = aligned4<T>(g) && aligned4<T>(out);
  float coef = __fmul_rn(__fdiv_rn(1.f, __fadd_rn(*total, clip_eps)), max_norm);
  coef = coef > 1.f ? 1.f : coef;
  for (long long i = s.start + 4LL * threadIdx.x; i < s.end; i += 4LL * kThreads) {
    float v[4];
    load4(g, i, s.end, vec, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __fmul_rn(v[k], coef);
    store4(out, i, s.end, vec, v);
  }
}

// The fp32 constants of the update, each a Python float rounded to fp32.
struct RmspropArgs {
  float lr, weight_decay, alpha, one_minus_alpha, eps, momentum;
  int decay;  // weight_decay != 0
};

// Leaf pointers: p, g, square_avg, momentum_buf, then the new p, square_avg
// and momentum_buf. The state is fp32; p and g both fp32 or both bf16.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsprop_kernel(const __grid_constant__ Table<7> t, const RmspropArgs a) {
  const Span s = chunk_of(t);
  void* const* q = t.ptr[s.leaf];
  const T* p = static_cast<const T*>(q[0]);
  const T* g = static_cast<const T*>(q[1]);
  const float* sq = static_cast<const float*>(q[2]);
  const float* buf = static_cast<const float*>(q[3]);
  T* p_out = static_cast<T*>(q[4]);
  float* sq_out = static_cast<float*>(q[5]);
  float* buf_out = static_cast<float*>(q[6]);
  const bool vec = aligned4<T>(p) && aligned4<T>(g) && aligned4<float>(sq) &&
                   aligned4<float>(buf) && aligned4<T>(p_out) && aligned4<float>(sq_out) &&
                   aligned4<float>(buf_out);
  for (long long i = s.start + 4LL * threadIdx.x; i < s.end; i += 4LL * kThreads) {
    float pv[4], gv[4], sv[4], bv[4];
    load4(p, i, s.end, vec, pv);
    load4(g, i, s.end, vec, gv);
    load4(sq, i, s.end, vec, sv);
    load4(buf, i, s.end, vec, bv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float gk = gv[k];
      if (a.decay) gk = __fadd_rn(gk, __fmul_rn(pv[k], a.weight_decay));  // g + wd*p
      // alpha*sq + (1 - alpha)*(g*g)
      sv[k] = __fadd_rn(__fmul_rn(sv[k], a.alpha), __fmul_rn(__fmul_rn(gk, gk), a.one_minus_alpha));
      // momentum*buf + g / (sqrt(sq) + eps)
      bv[k] = __fadd_rn(__fmul_rn(bv[k], a.momentum),
                        __fdiv_rn(gk, __fadd_rn(__fsqrt_rn(sv[k]), a.eps)));
      pv[k] = __fsub_rn(pv[k], __fmul_rn(bv[k], a.lr));  // p - lr*buf
    }
    store4(p_out, i, s.end, vec, pv);
    store4(sq_out, i, s.end, vec, sv);
    store4(buf_out, i, s.end, vec, bv);
  }
}

// Calls launch(table, blocks) for each page of up to kMaxLeaves non-empty
// leaves, in leaf order; leaf i's K pointers are ptrs[i * K ...]. Empty
// leaves take no block.
template <int K, typename Launch>
cudaError_t for_pages(const void* const* ptrs, const long long* numel, int count, Launch launch) {
  Table<K> t;
  t.count = 0;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    const long long n = numel[i];
    if (n < 0) return cudaErrorInvalidValue;
    if (n == 0) continue;
    const long long chunks = (n + kChunk - 1) / kChunk;
    if (chunks > INT_MAX) return cudaErrorInvalidValue;
    if (t.count == kMaxLeaves || blocks + chunks > INT_MAX) {
      t.first_block[t.count] = (int)blocks;
      launch(t, (int)blocks);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      t.count = 0;
      blocks = 0;
    }
    for (int k = 0; k < K; ++k) t.ptr[t.count][k] = const_cast<void*>(ptrs[(size_t)i * K + k]);
    t.numel[t.count] = n;
    t.first_block[t.count] = (int)blocks;
    ++t.count;
    blocks += chunks;
  }
  if (t.count > 0) {
    t.first_block[t.count] = (int)blocks;
    launch(t, (int)blocks);
  }
  return cudaGetLastError();
}

}  // namespace mt
}  // namespace tuk

using tuk::mt::kChunk;
using tuk::mt::kMaxLeaves;
using tuk::mt::kThreads;

// The squared sums of `count` leaves (`dtype` 0 fp32, 1 bf16; leaf i at
// ptrs[i] with numel[i] values): leaf_sq[i] (fp32) and *total = their
// global norm (fp32). `partial` is scratch of sum(ceil(numel[i] / kChunk))
// doubles. Returns cudaGetLastError() after the launches.
extern "C" int tuk_mt_sumsq(const void* const* ptrs, const long long* numel, int count, int dtype,
                            double* partial, float* leaf_sq, float* total, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (count < 0 || (dtype != tuk::mt::kF32 && dtype != tuk::mt::kBF16))
    return (int)cudaErrorInvalidValue;
  double* out = partial;
  const cudaError_t err = tuk::mt::for_pages<1>(
      ptrs, numel, count, [&](const tuk::mt::Table<1>& t, int blocks) {
        if (dtype == tuk::mt::kBF16)
          tuk::mt::sumsq_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(t, out);
        else
          tuk::mt::sumsq_kernel<float><<<blocks, kThreads, 0, st>>>(t, out);
        out += blocks;
      });
  if (err != cudaSuccess) return (int)err;
  // Each leaf's partials, empty leaves included (none: a sum of 0).
  tuk::mt::FinishTable f;
  int chunk = 0;
  for (int lo = 0; lo < count || lo == 0; lo += kMaxLeaves) {
    f.count = count - lo < kMaxLeaves ? count - lo : kMaxLeaves;
    f.leaf0 = lo;
    for (int i = 0; i < f.count; ++i) {
      f.first[i] = chunk;
      chunk += (int)((numel[lo + i] + kChunk - 1) / kChunk);
    }
    f.first[f.count] = chunk;
    const bool last = lo + kMaxLeaves >= count;
    tuk::mt::sumsq_finish_kernel<<<1, kMaxLeaves, 0, st>>>(f, partial, leaf_sq,
                                                          last ? total : nullptr, count);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || last) return (int)e;
  }
  return (int)cudaGetLastError();
}

// out_i = g_i * min(max_norm / (*total + clip_eps), 1) in g's dtype, for
// `count` leaves: leaf i's g at ptrs[2i], its output at ptrs[2i + 1].
extern "C" int tuk_mt_scale(const void* const* ptrs, const long long* numel, int count, int dtype,
                            const float* total, float max_norm, float clip_eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (count < 0 || (dtype != tuk::mt::kF32 && dtype != tuk::mt::kBF16))
    return (int)cudaErrorInvalidValue;
  return (int)tuk::mt::for_pages<2>(
      ptrs, numel, count, [&](const tuk::mt::Table<2>& t, int blocks) {
        if (dtype == tuk::mt::kBF16)
          tuk::mt::scale_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(t, total, max_norm,
                                                                             clip_eps);
        else
          tuk::mt::scale_kernel<float><<<blocks, kThreads, 0, st>>>(t, total, max_norm, clip_eps);
      });
}

// One RMSprop step of `count` leaves: leaf i's p, g, square_avg,
// momentum_buf, new p, new square_avg and new momentum_buf at ptrs[7i ...];
// p and g in `dtype` (0 fp32, 1 bf16), the state fp32.
extern "C" int tuk_mt_rmsprop(const void* const* ptrs, const long long* numel, int count,
                              int dtype, float lr, float weight_decay, float alpha,
                              float one_minus_alpha, float eps, float momentum, int decay,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (count < 0 || (dtype != tuk::mt::kF32 && dtype != tuk::mt::kBF16))
    return (int)cudaErrorInvalidValue;
  const tuk::mt::RmspropArgs a{lr, weight_decay, alpha, one_minus_alpha, eps, momentum, decay};
  return (int)tuk::mt::for_pages<7>(
      ptrs, numel, count, [&](const tuk::mt::Table<7>& t, int blocks) {
        if (dtype == tuk::mt::kBF16)
          tuk::mt::rmsprop_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(t, a);
        else
          tuk::mt::rmsprop_kernel<float><<<blocks, kThreads, 0, st>>>(t, a);
      });
}
