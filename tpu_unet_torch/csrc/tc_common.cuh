// Device helpers and host tensor-map set-up shared by the tensor-core kernels
// (tc_conv.cu, tc_double_conv.cu): mma.sync on bf16 fragments fed by
// ldmatrix, and on TF32 fragments for the fp32 routes (each fp32 operand
// split into a TF32 high part and the TF32 rounding of the rest, three
// products summed: 3xTF32), mbarriers and TMA loads, and the swizzled byte
// offsets of staged chunks (64-byte swizzle) and weight slices (128-byte
// swizzle), and the operand traits of the bf16 and fp32 mainloops. The host
// functions are defined in tc_conv.cu.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace tuk {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int KC = 32;        // input channels per staged chunk (64 bytes a pixel)
constexpr int kAlign = 1024;  // slot alignment: the swizzle patterns repeat every 1024 bytes
constexpr int kMaxDevices = 64;

// The operands of a mainloop. Bf16Op: bf16 activations and HWIO weights,
// KC = 32 channels a chunk, mma.sync m16n8k16. Tf32x3Op: fp32 activations,
// KC_F32 = 16 channels a chunk (the same 64 bytes a staged pixel, so the
// same box, swizzle and ldmatrix addresses), weights repacked per call as
// K-contiguous [2][9][Cout][Cin] TF32 hi and lo planes (split_weights),
// mma.sync m16n8k8 in 3xTF32 with A split in registers.
struct Bf16Op {
  static constexpr bool kTf32 = false;
  static constexpr int KC = tc::KC;
};
struct Tf32x3Op {
  static constexpr bool kTf32 = true;
  static constexpr int KC = 16;
};
constexpr int KC_F32 = Tf32x3Op::KC;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v rounded to TF32 (10 mantissa bits), half away from zero, as fp32 bits.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
// v = hi + lo + (at most 2^-22 |v|): hi the TF32 rounding of v, lo that of
// the exact remainder v - hi.
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& hi, uint32_t& lo) {
  const float f = __uint_as_float(v);
  hi = tf32_rna(f);
  lo = tf32_rna(f - __uint_as_float(hi));
}
// d += a (16x8, row) * b (8x8, col), TF32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// acc += a * b in 3xTF32 over the split fragments of a (ah, al) and of G n8
// blocks of b (bh[g], bl[g]: the b0, b1 pairs). The three products of each
// block, small ones first (lo*hi, hi*lo, then hi*hi; the lo*lo term, about
// 2^-22 of the product, is left out), go into a fresh fragment, which is
// then added to acc in fp32 with round-to-nearest. The tensor cores round
// an accumulation toward zero: summed into acc directly, three MMAs a k8
// step lose up to three of acc's ulps a step, all of one sign, which over
// K = 9 * 512 (or 19,600 pixels of a dw) leaves fp32's tolerance.
template <int G>
__device__ __forceinline__ void mma_3xtf32(float (*acc)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (*bh)[2],
                                           const uint32_t (*bl)[2]) {
  float t[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) t[g][e] = 0.f;
    mma_tf32(t[g], al, bh[g][0], bh[g][1]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) mma_tf32(t[g], ah, bl[g][0], bl[g][1]);
#pragma unroll
  for (int g = 0; g < G; ++g) mma_tf32(t[g], ah, bh[g][0], bh[g][1]);
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = __fadd_rn(acc[g][e], t[g][e]);
}

// mbarriers and TMA loads (sm_90).
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  } while (!done);
}
// Orders this thread's earlier generic-proxy shared-memory accesses before
// later async-proxy ones (the TMA writes into a reused slot).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Byte offset of 16-byte chunk c of staged pixel q in an input slot (64-byte
// swizzle), and of chunk c of weight row r in a 64-channel half (128-byte).
__device__ __forceinline__ int in_off(int q, int c) { return q * 64 + ((c ^ ((q >> 1) & 3)) << 4); }
__device__ __forceinline__ int w_off(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// ReLU that keeps NaN, as torch.relu does.
__device__ __forceinline__ float relu_f(float y) { return y < 0.f ? 0.f : y; }

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + kAlign - 1) & ~(uintptr_t)(kAlign - 1));
}

// A bf16 (or, with f32, fp32) tensor map of `rank` dims (innermost first)
// with zero fill outside.
cudaError_t make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides_bytes, const cuuint32_t* box,
                     CUtensorMapSwizzle swizzle, bool f32 = false);

// A 4-D map over an NHWC bf16 (or fp32) tensor (dims c, W, H, N) with box
// (bc, bw, bh, 1).
cudaError_t make_nhwc_map(CUtensorMap* map, const void* base, int n, int h, int wd, int c, int bc,
                          int bw, int bh, CUtensorMapSwizzle swizzle, bool f32 = false);

// The shared-memory opt-in of `kernel`, once per device (`done` is the
// kernel's own flags).
cudaError_t opt_in_smem(const void* kernel, size_t bytes, std::atomic<bool>* done);

// out[2][9][cout][cin] = the TF32 hi and lo planes of fp32 HWIO w
// [9][cin][cout], K (cin) contiguous: the fp32 convs' B operand. One launch
// on `stream`; returns cudaGetLastError().
cudaError_t split_weights(const float* w, float* out, int cin, int cout, cudaStream_t stream);

}  // namespace tc
}  // namespace tuk
