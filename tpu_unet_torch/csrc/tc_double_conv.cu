// A whole folded-BN DoubleConv in one kernel on the Hopper tensor cores, bf16
// or fp32 in and out:
//
//   y   = relu(conv3x3_same(mid, w2) * s2 + b2),
//   mid = relu(conv3x3_same(x, w1) * s1 + b1)   (kept in shared memory),
//
// and, when asked, the 2x2 / stride-2 max pool of y (floor mode) from the
// same epilogue. Replaces tpu_unet/kernels/fused_double_conv.py:94
// fused_double_conv (pallas_call at :150), and for the encoder's pools
// tpu_unet/kernels/pooling.py:33 max_pool2x2 (pallas_call at :48). The
// kernel is templated on the operand trait of tc_common.cuh: Bf16Op (mid
// rounded to bf16, mma.sync m16n8k16) or Tf32x3Op (fp32 mid, unrounded; each
// fp32 operand split into TF32 hi and lo parts, lo*hi + hi*lo + hi*hi summed
// per k8 step into a fresh fragment added to the accumulator with
// round-to-nearest, as tc_conv.cu's fp32 convs: fp32 accuracy).
//
// What bounds it on the H100: at the served shapes ([1,640,959,3]->64->64,
// [1,320,479,64]->128->128, [1,160,239,128]->256->256) the two convs do
// 2*9*(Cin*Cmid + Cmid*Cout) FLOPs a pixel against (Cin + Cout) * 2 (bf16)
// or 4 (fp32) bytes moved (mid never reaches device memory): operations, far
// above the ridge of the 989 TFLOP/s bf16 or the 494.7 / 3 TFLOP/s 3xTF32
// rate. The CUDA-core versions ran at 1.2-1.6% (bf16) and 8-10% (fp32 FMA,
// 2.9-5.0 ms) of that bound.
//
// Design (the mainloop, swizzles and TMA loads are tc_conv.cu's):
// * A block owns a th x tw output tile of one image (both even, so the pool's
//   2x2 windows lie inside it) and all Cout channels, 8 warps, one block an
//   SM. The tile comes from dc_plan (kernels/tc_conv.py), which weighs waves
//   on the card's SMs against the halo's extra work.
// * Phase 1 (conv1): an implicit GEMM over the (th+2) x (tw+2) mid region at
//   origin (h0-1, w0-1), M = mid pixels, N = 128 mid channels a pass (64
//   when Cmid <= 64), K = 9 * Cin. Each chunk of x (KC = 32 bf16 or 16 fp32
//   channels, 64 bytes a pixel in both) arrives as one TMA box (KC, tw+4,
//   th+4) at (h0-2, w0-2), whose out-of-bounds fill gives both convs' SAME
//   zeros for x (and the channels past Cin: Cin = 3 is padded to 8 by the
//   wrapper, read as one chunk whose second k16 half, or second k8 step in
//   fp32, all zeros, is skipped); the 9 taps are 9 shifted windows of it.
//   The epilogue computes relu(acc*s1 + b1) (__fmul_rn then __fadd_rn, the
//   plain version's order), rounds to bf16 (fp32 stays as it is), writes 0
//   for mid pixels outside the image (conv1 there gives relu(b1) != 0, but
//   conv2's SAME padding reads zeros:
//   tpu_unet/kernels/fused_double_conv.py:64-73), and stores the values
//   into the mid buffer: Cmid / KC slots, each the mid region x 64 bytes in
//   the input slot's 64-byte swizzle (in_off).
// * Phase 2 (conv2): the same mainloop on the th x tw tile, its A chunks the
//   resident mid slots read as 9 shifted windows, N = 128 output channels a
//   pass (64 when Cout <= 64), w2 through the weight ring. The epilogue
//   computes relu(acc*s2 + b2), rounds it to the output dtype into an output
//   tile in shared memory (over the input ring, free by then) and stores it
//   with coalesced 16-byte stores; with a pooled output it also takes the
//   NaN-keeping max of each 2x2 window of that tile whose pooled pixel lies
//   in [H/2, W/2] and stores it with 16-byte stores: bit-identical to
//   pooling y separately.
// * B operand. bf16: ldmatrix.trans straight from the HWIO weights, one
//   k-step a [32][128] slice (8 KB). fp32: ldmatrix has no 32-bit transpose,
//   so the wrapper's call splits w1 and w2 (split_weights, tc_conv.cu) into
//   K-contiguous [2][9][C][K] hi and lo planes, and one k-step's slice is
//   [half][plane][64 columns][16 K] (16 KB), read by ldmatrix without .trans
//   as tc_conv.cu's fp32 B.
// * One global k-step sequence runs through both phases: weights in a ring
//   of STAGES slots (bf16 6, fp32 3: a slot is twice the bytes and mid twice
//   the slots) and x's chunks in a ring of two, issued STAGES - 1 steps ahead
//   by one thread after the step's __syncthreads, so phase 2's first weights
//   are in flight during phase 1's last steps and epilogue.
// * Warps split M (and the two 64-column halves of a 128-column pass): warp
//   tiles of up to MI_MAX (bf16 4, fp32 3) m16 fragments x 64 columns. Every
//   warp computes the busiest warp's fragment count of its phase (the
//   template arguments MI1, MI2: the block takes that warp's time anyway),
//   so no MMA sits behind a per-warp branch; rows past the region read
//   staged pixel 0 and are discarded. A bf16 k16 step loads all its A and B
//   fragments before its MMAs; an fp32 k8 step loads B for 4 n8 blocks at a
//   time and each fragment's A once for them (registers: 3 fragments x 64
//   columns of accumulators beside the hi/lo fragments).
// * Shared memory: mid (128 KB at Cmid = 256, bf16 on 6 x 30 tiles and fp32
//   on 8 x 10), the input ring or output tile (bf16 or fp32), the weight
//   ring (48 KB). Cmid = 256 does not fit a 16 x 16 tile (bf16 mid
//   alone 168 KB).
// * Halo recompute: conv1 runs on (th+2)(tw+2) / (th*tw) times the pixels,
//   1.30-1.42x at the bf16 served tiles (8 x 48, 16 x 12, 6 x 30), and the
//   waves' tails add more (6.1 waves at down1, 1.6 at down2, of one block an
//   SM): the kernel issues more MMAs than two tc_conv.cu calls.
//
// Variants measured on the H100 (bf16, timed one against another on one
// card): the compile-time fragment counts and the loads-before-MMAs order
// each made the kernel faster than the first version, which branched per
// fragment on each warp's own count. Dropped, both slower: a dedicated
// producer warp (9 warps cap ptxas at 168 registers a thread, and the 128
// accumulators spill), and per-slot empty mbarriers in place of the step's
// __syncthreads. 128-column conv1 passes (half the steps, fewer B loads an
// MMA at down2) and the skipped zero half of inc's chunk moved the times
// by a few percent only. A %globaltimer probe of the first version found
// thread 0 waiting on TMA bytes and in __syncthreads for under a tenth of
// a block's time, and the kernel with its MMAs removed took most of its
// time still: what bounds it is the mma.sync + ldmatrix issue stream of 8
// warps, one block an SM, as for the tc_conv.cu kernels (PERF.md has the
// committed measurements).

#include "tc_common.cuh"

#include <type_traits>

namespace tuk {
namespace tc {
namespace dc {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MI_MAX = 4;                  // m16 fragments a warp holds, bf16
constexpr int NI = 8;                      // n8 fragments of a warp's 64 columns
constexpr int STAGES = 6;                  // k-steps in the weight ring, bf16
constexpr int W_SLOT = 2 * KC * 128;       // one bf16 k-step's weights: 32 rows x 128 columns
constexpr int MI_MAX_F32 = 3;              // m16 fragments a warp holds, fp32
constexpr int STAGES_F32 = 3;              // k-steps in the weight ring, fp32
constexpr int F32_PLANE = 64 * KC_F32 * 4;  // one plane of a 64-column half: 64 rows x 16 K
constexpr int W_SLOT_F32 = 2 * 2 * F32_PLANE;  // one fp32 k-step: [half][plane][64][16]
constexpr int MAX_SMEM = 232448;           // 227 KB, a block's most on the H100

// The per-operand constants: channels a staged chunk, bytes an element, the
// weight ring, the most fragments a warp holds, the activations' type.
template <class Op>
struct Traits {
  static constexpr bool kF32 = Op::kTf32;
  static constexpr int KCH = Op::KC;
  static constexpr int ES = kF32 ? 4 : 2;
  static constexpr int EPV = 16 / ES;  // elements a 16-byte vector
  static constexpr int STAGES = kF32 ? STAGES_F32 : dc::STAGES;
  static constexpr int W_SLOT = kF32 ? W_SLOT_F32 : dc::W_SLOT;
  static constexpr int MI_MAX = kF32 ? MI_MAX_F32 : dc::MI_MAX;
  using T = std::conditional_t<kF32, float, bf16>;
};

__host__ __device__ inline int up_align(int v) { return (v + kAlign - 1) / kAlign * kAlign; }

// Byte offsets of the dynamic shared memory (after alignment to 1024):
// mid slots, then the ring (two input slots in phase 1, the output tile in
// phase 2), the weight ring, the barriers. A staged pixel's chunk is 64
// bytes in both dtypes. kernels/tc_conv.py dc_smem mirrors it.
struct Layout {
  int mid_slot, in_slot, ring, w, bars, total;
};
__host__ __device__ inline int out_row(int cout) { return (cout > 64 ? 128 : 64) + 8; }
template <class Op>
__host__ __device__ inline Layout layout(int th, int tw, int cmid, int cout) {
  using C = Traits<Op>;
  Layout l;
  l.mid_slot = up_align((th + 2) * (tw + 2) * 64);
  l.in_slot = up_align((th + 4) * (tw + 4) * 64);
  const int out_tile = up_align(th * tw * out_row(cout) * C::ES);
  const int ring = out_tile > 2 * l.in_slot ? out_tile : 2 * l.in_slot;
  l.ring = (cmid / C::KCH) * l.mid_slot;
  l.w = l.ring + ring;
  l.bars = l.w + C::STAGES * C::W_SLOT;
  l.total = kAlign + l.bars + (2 + C::STAGES) * 8;
  return l;
}

// The most m16 fragments a warp holds for M rows over `warps` warps.
__host__ __device__ inline int frags(int m, int warps) {
  return ((m + 15) / 16 + warps - 1) / warps;
}

// One k-step's MMAs of a warp over the staged chunk at a_base (rows a_q +
// tap_q) and the weight slot at b_base. bf16: for each of the first KK k16
// halves of the 32-channel chunk (a half past the channels holds zeros
// only), its MI A fragments and the four n16 groups of B (ldmatrix.trans at
// b_off), then MI x 8 MMAs. fp32: for each of the first KK k8 steps of the
// 16-channel chunk and each group of 4 n8 blocks, both planes' B fragments
// (ldmatrix at the rows b_off of the warp's half), then per fragment its A
// split into hi and lo and the 3xTF32 products (mma_3xtf32).
template <class Op, int MI, int KK, int kMI>
__device__ __forceinline__ void mma_step(float (&acc)[kMI][NI][4], const int (&a_q)[kMI],
                                         const int (&b_off)[NI / 2], uint32_t a_base,
                                         uint32_t b_base, int tap_q, int lane) {
  if constexpr (Op::kTf32) {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int g0 = 0; g0 < NI; g0 += 4) {
        uint32_t bh[2][4], bl[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int off = in_off(b_off[g0 / 2 + j], 2 * kk + (lane / 8) % 2);
          ldmatrix_x4(bh[j], b_base + off);
          ldmatrix_x4(bl[j], b_base + F32_PLANE + off);
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          uint32_t ar[4], ah[4], al[4];
          ldmatrix_x4(ar, a_base + in_off(a_q[mi] + tap_q, 2 * kk + lane / 16));
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(ar[e], ah[e], al[e]);
          mma_3xtf32<4>(&acc[mi][g0], ah, al, reinterpret_cast<const uint32_t(*)[2]>(bh),
                        reinterpret_cast<const uint32_t(*)[2]>(bl));
        }
      }
  } else {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t af[MI][4];
      uint32_t bfr[NI / 2][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(af[mi], a_base + in_off(a_q[mi] + tap_q, 2 * kk + lane / 16));
#pragma unroll
      for (int j = 0; j < NI / 2; ++j)
        ldmatrix_x4_trans(bfr[j], b_base + b_off[j] + kk * 16 * 128);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bfr[ni / 2][(ni % 2) * 2],
                   bfr[ni / 2][(ni % 2) * 2 + 1]);
    }
  }
}

// max that keeps NaN, as torch.maximum does; returns one of its inputs.
__device__ __forceinline__ bf16 max_keep_nan(bf16 a, bf16 b) {
  const float fa = __bfloat162float(a);
  const float fb = __bfloat162float(b);
  return (fa > fb || fa != fa) ? a : b;
}
__device__ __forceinline__ float max_keep_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Two consecutive channels' values, rounded to T (bf16) or as they are.
__device__ __forceinline__ void store2(bf16* p, float y0, float y1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y0, y1);
}
__device__ __forceinline__ void store2(float* p, float y0, float y1) {
  *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
}

// Grid: (tiles_h * tiles_w, 1, N). Block (t, 0, n) computes output pixels
// (h0 + p / tw, w0 + p % tw), p < th * tw, of image n, all cout channels.
// tmx: x as [N][H][W][cin] (dims cin, W, H, N), box (KC, tw + 4, th + 4, 1).
// bf16: tmw1: w1 as [9][cin][cmid], tmw2: w2 as [9][cmid][cout], box (64,
// KC, 1). fp32: tmw1: the split w1 [2][9][cmid][cin] (dims cin, cmid, 9, 2),
// tmw2: the split w2 [2][9][cout][cmid], box (KC_F32, 64, 1, 2).
// pooled: [N][H/2][W/2][cout] or null. MI1, MI2: the m16 fragments every
// warp computes in phase 1 and 2, those of the busiest warp (the block's
// time is its), so no warp branches on its own count; rows past the region
// are discarded.
template <class Op, int MI1, int MI2>
__global__ void __launch_bounds__(THREADS, 1)
    tc_double_conv_kernel(const __grid_constant__ CUtensorMap tmx,
                          const __grid_constant__ CUtensorMap tmw1,
                          const __grid_constant__ CUtensorMap tmw2, const float* __restrict__ s1,
                          const float* __restrict__ b1, const float* __restrict__ s2,
                          const float* __restrict__ b2, typename Traits<Op>::T* __restrict__ out,
                          typename Traits<Op>::T* __restrict__ pooled, int H, int W, int cin,
                          int cmid, int cout, int th, int tw, int tiles_w) {
  using C = Traits<Op>;
  using T = typename C::T;
  constexpr int KCH = C::KCH;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const Layout L = layout<Op>(th, tw, cmid, cout);
  unsigned char* mid_s = smem;
  unsigned char* in_s = smem + L.ring;  // phase 1: 2 input slots; phase 2: the output tile
  unsigned char* w_s = smem + L.w;
  uint64_t* in_bar = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* w_bar = in_bar + 2;
  T* out_s = reinterpret_cast<T*>(in_s);

  const int n = blockIdx.z;
  const int h0 = (int)(blockIdx.x / tiles_w) * th;
  const int w0 = (int)(blockIdx.x % tiles_w) * tw;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int msw = tw + 2;  // mid region row
  const int isw = tw + 4;  // staged input row
  const int m1 = (th + 2) * msw;
  const int m2 = th * tw;
  const int c1 = (cin + KCH - 1) / KCH;  // x's chunks
  const int n1 = (cmid + 127) / 128;     // phase-1 passes of up to 128 mid channels
  const int c2 = cmid / KCH;             // mid chunks
  const int steps1 = n1 * c1 * 9;
  const int nsteps = steps1 + (cout + 127) / 128 * c2 * 9;
  const int orow = out_row(cout);        // elements per output-tile row

  // One thread issues the loads of k-step g: phase 1, at a chunk's first tap
  // its x box, and its (up to) 128 columns of w1; phase 2 its (up to) 128
  // columns of w2; one box per 64 columns.
  auto issue = [&](int g) {
    if (threadIdx.x != 0) return;
    uint64_t* wb = w_bar + g % STAGES;
    unsigned char* wdst = w_s + (g % STAGES) * C::W_SLOT;
    fence_proxy_async();
    // A half's weights: bf16 [KC][64] of HWIO; fp32 both planes [2][64][16].
    auto load_w = [&](const CUtensorMap* tmw, int hh, int c0, int chunk, int tap) {
      if constexpr (C::kF32)
        tma_load_4d(wdst + hh * (C::W_SLOT / 2), tmw, wb, chunk * KCH, c0 + hh * 64, tap, 0);
      else
        tma_load_3d(wdst + hh * (C::W_SLOT / 2), tmw, wb, c0 + hh * 64, chunk * KCH, tap);
    };
    if (g < steps1) {
      const int gc = g / 9;
      const int tap = g - gc * 9;
      const int pass = gc / c1;
      const int chunk = gc - pass * c1;
      if (tap == 0) {
        uint64_t* b = in_bar + (gc & 1);
        mbar_expect_tx(b, (uint32_t)((th + 4) * isw * 64));
        tma_load_4d(in_s + (gc & 1) * L.in_slot, &tmx, b, chunk * KCH, w0 - 2, h0 - 2, n);
      }
      const int halves = cmid - pass * 128 > 64 ? 2 : 1;
      mbar_expect_tx(wb, (uint32_t)(halves * (C::W_SLOT / 2)));
      for (int hh = 0; hh < halves; ++hh) load_w(&tmw1, hh, pass * 128, chunk, tap);
    } else {
      const int gc = (g - steps1) / 9;
      const int tap = g - steps1 - gc * 9;
      const int pass = gc / c2;
      const int chunk = gc - pass * c2;
      const int halves = cout - pass * 128 > 64 ? 2 : 1;
      mbar_expect_tx(wb, (uint32_t)(halves * (C::W_SLOT / 2)));
      for (int hh = 0; hh < halves; ++hh) load_w(&tmw2, hh, pass * 128, chunk, tap);
    }
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 + STAGES; ++i) mbar_init(in_bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int g = 0; g < STAGES - 1 && g < nsteps; ++g) issue(g);

  constexpr int kMI = MI1 > MI2 ? MI1 : MI2;
  float acc[kMI][NI][4];
  int a_q[kMI];        // staged pixel of tap (0, 0) for this lane's row of fragment mi
  int b_off[NI / 2];   // B offsets (bf16) or rows (fp32) of the warp's four n16 groups
  int wpc = WARPS;     // warps per 64-column half
  int wm = warp, wn = 0;

#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    const bool p1 = s < steps1;
    const int gc = (p1 ? s : s - steps1) / 9;
    const int tap = (p1 ? s : s - steps1) - gc * 9;
    const int per_pass = p1 ? c1 : c2;
    const int pass = gc / per_pass;
    const int chunk = gc - pass * per_pass;
    if (p1 && tap == 0) mbar_wait(in_bar + (gc & 1), (gc >> 1) & 1);
    mbar_wait(w_bar + s % STAGES, (s / STAGES) & 1);
    __syncthreads();  // every thread is past step s - 1: its weight slot is free
    if (s + STAGES - 1 < nsteps) issue(s + STAGES - 1);

    if (chunk == 0 && tap == 0) {
      // A pass begins: this warp's fragments, their rows' staged pixels,
      // its B offsets, zero accumulators.
      const int halves = (p1 ? cmid : cout) - pass * 128 > 64 ? 2 : 1;
      wpc = WARPS / halves;
      wm = warp % wpc;
      wn = warp / wpc;
      const int m = p1 ? m1 : m2;
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        const int r = (wm + wpc * mi) * 16 + lane % 16;
        // phase 1: mid pixel r of the (th+2) x msw region over the isw-wide
        // staged box; phase 2: output pixel r over the msw-wide mid region
        a_q[mi] = r >= m ? 0 : p1 ? (r / msw) * isw + r % msw : (r / tw) * msw + r % tw;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        if constexpr (C::kF32) {
          // row (output channel) of n16 group j in the warp's half, whose
          // planes sit wn * 128 rows on: matrix lane / 8 is n8 block 2 j +
          // lane / 16, k half (lane / 8) % 2
          b_off[j] = wn * 128 + j * 16 + (lane / 16) * 8 + lane % 8;
        } else {
          const int col8 = (wn * 64 + j * 16) / 8 + lane / 16;
          b_off[j] = (col8 / 8) * (KC * 128) + w_off((lane / 8) % 2 * 8 + lane % 8, col8 % 8);
        }
      }
    }

    const int sw = p1 ? isw : msw;
    const int tap_q = (tap / 3) * sw + tap % 3;
    const uint32_t a_base =
        smem_addr(p1 ? in_s + (gc & 1) * L.in_slot : mid_s + chunk * L.mid_slot);
    const uint32_t b_base = smem_addr(w_s + (s % STAGES) * C::W_SLOT);
    if (!p1)
      mma_step<Op, MI2, 2>(acc, a_q, b_off, a_base, b_base, tap_q, lane);
    else if (cin - chunk * KCH > KCH / 2)
      mma_step<Op, MI1, 2>(acc, a_q, b_off, a_base, b_base, tap_q, lane);
    else  // x's last chunk holds half a chunk of channels or fewer (inc: Cin 3 padded to 8)
      mma_step<Op, MI1, 1>(acc, a_q, b_off, a_base, b_base, tap_q, lane);
    if (chunk != per_pass - 1 || tap != 8) continue;

    // A pass ends. Lane holds rows f*16 + lane/4 (+8) of fragment f = wm +
    // wpc*mi, columns wn*64 + ni*8 + (lane%4)*2 (+1) of the pass.
    if (p1) {
      // relu(acc*s1 + b1) (bf16: rounded), 0 outside the image, into the
      // mid slots of channels pass*128 ...
#pragma unroll
      for (int mi = 0; mi < MI1; ++mi) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = (wm + wpc * mi) * 16 + lane / 4 + hf * 8;
          if (r >= m1) continue;
          const int gh = h0 - 1 + r / msw;
          const int gw = w0 - 1 + r % msw;
          const bool inside = gh >= 0 && gh < H && gw >= 0 && gw < W;
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            const int cm = pass * 128 + wn * 64 + ni * 8 + (lane % 4) * 2;
            if (cm >= cmid) continue;  // cmid % KCH == 0: cm + 1 < cmid too
            float y0 = 0.f, y1 = 0.f;
            if (inside) {
              y0 = relu_f(__fadd_rn(__fmul_rn(acc[mi][ni][hf * 2], s1[cm]), b1[cm]));
              y1 = relu_f(__fadd_rn(__fmul_rn(acc[mi][ni][hf * 2 + 1], s1[cm + 1]), b1[cm + 1]));
            }
            store2(reinterpret_cast<T*>(mid_s + (cm / KCH) * L.mid_slot +
                                        in_off(r, (cm % KCH) / C::EPV)) + cm % C::EPV,
                   y0, y1);
          }
        }
      }
      continue;
    }

    // Phase 2: relu(acc*s2 + b2) (bf16: rounded) into the output tile
    // [th*tw][orow] (the input ring, unused since phase 1 ended), ...
    const int co0 = pass * 128;
#pragma unroll
    for (int mi = 0; mi < MI2; ++mi) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = (wm + wpc * mi) * 16 + lane / 4 + hf * 8;
        if (p >= m2) continue;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int j = wn * 64 + ni * 8 + (lane % 4) * 2;
          const int co = co0 + j;
          float y0 = 0.f, y1 = 0.f;
          if (co < cout) {  // cout % 8 == 0: co + 1 < cout too
            y0 = relu_f(__fadd_rn(__fmul_rn(acc[mi][ni][hf * 2], s2[co]), b2[co]));
            y1 = relu_f(__fadd_rn(__fmul_rn(acc[mi][ni][hf * 2 + 1], s2[co + 1]), b2[co + 1]));
          }
          store2(out_s + p * orow + j, y0, y1);
        }
      }
    }
    __syncthreads();
    // ... then coalesced 16-byte stores of its pixels in the image, and of
    // the 2x2 maxima of its pooled pixels in [H/2, W/2]. A thread keeps one
    // 16-byte group of channels (8 bf16, 4 fp32). The next pass rewrites the
    // tile only after at least 9 more k-steps, each behind a __syncthreads.
    const int vec = (cout - co0 > 64 ? 128 : 64) / C::EPV;
    const int v = threadIdx.x % vec;
    const int co = co0 + v * C::EPV;
    if (co >= cout) continue;
    for (int p = threadIdx.x / vec; p < m2; p += THREADS / vec) {
      const int gh = h0 + p / tw;
      const int gw = w0 + p % tw;
      if (gh < H && gw < W)
        *reinterpret_cast<uint4*>(out + (((size_t)n * H + gh) * W + gw) * cout + co) =
            *reinterpret_cast<const uint4*>(out_s + p * orow + v * C::EPV);
    }
    if (pooled == nullptr) continue;
    const int H2 = H / 2, W2 = W / 2, ptw = tw / 2;
    for (int q = threadIdx.x / vec; q < m2 / 4; q += THREADS / vec) {
      const int pr = q / ptw;
      const int pc = q - pr * ptw;
      const int gh = h0 / 2 + pr;
      const int gw = w0 / 2 + pc;
      if (gh >= H2 || gw >= W2) continue;
      const T* t00 = out_s + (2 * pr * tw + 2 * pc) * orow + v * C::EPV;
      uint4 r00 = *reinterpret_cast<const uint4*>(t00);
      const uint4 r01 = *reinterpret_cast<const uint4*>(t00 + orow);
      const uint4 r10 = *reinterpret_cast<const uint4*>(t00 + tw * orow);
      const uint4 r11 = *reinterpret_cast<const uint4*>(t00 + (tw + 1) * orow);
      T* m = reinterpret_cast<T*>(&r00);
      const T* e01 = reinterpret_cast<const T*>(&r01);
      const T* e10 = reinterpret_cast<const T*>(&r10);
      const T* e11 = reinterpret_cast<const T*>(&r11);
#pragma unroll
      for (int e = 0; e < C::EPV; ++e)  // max(max(p00, p10), max(p01, p11)), as pooling.cu
        m[e] = max_keep_nan(max_keep_nan(m[e], e10[e]), max_keep_nan(e01[e], e11[e]));
      *reinterpret_cast<uint4*>(pooled + (((size_t)n * H2 + gh) * W2 + gw) * cout + co) = r00;
    }
  }
}

// The tensor maps' bases and the launch of one instantiation.
struct Args {
  const float *s1, *b1, *s2, *b2;
  void *out, *pooled;
  int n, h, wd, cin, cmid, cout, th, tw;
};

template <class Op, int MI1, int MI2>
cudaError_t launch_mi(const CUtensorMap& tmx, const CUtensorMap& tmw1, const CUtensorMap& tmw2,
                      const Args& a, cudaStream_t stream) {
  using T = typename Traits<Op>::T;
  auto kernel = tc_double_conv_kernel<Op, MI1, MI2>;
  static std::atomic<bool> opted_in[kMaxDevices];
  const cudaError_t err = opt_in_smem(reinterpret_cast<const void*>(kernel), MAX_SMEM, opted_in);
  if (err != cudaSuccess) return err;
  const int tiles_w = (a.wd + a.tw - 1) / a.tw;
  const int tiles_h = (a.h + a.th - 1) / a.th;
  kernel<<<dim3(tiles_w * tiles_h, 1, a.n), THREADS,
           layout<Op>(a.th, a.tw, a.cmid, a.cout).total, stream>>>(
      tmx, tmw1, tmw2, a.s1, a.b1, a.s2, a.b2, static_cast<T*>(a.out),
      static_cast<T*>(a.pooled), a.h, a.wd, a.cin, a.cmid, a.cout, a.th, a.tw, tiles_w);
  return cudaGetLastError();
}

// A weight map: bf16 HWIO [9][k][c] (dims c, k, 9), box (64, KC, 1), 128-byte
// swizzle; fp32 split planes [2][9][c][k] (dims k, c, 9, 2), box (KC_F32, 64,
// 1, 2), 64-byte swizzle.
template <class Op>
cudaError_t make_w_map(CUtensorMap* map, const void* w, int k, int c) {
  if constexpr (Op::kTf32) {
    const cuuint64_t dims[4] = {(cuuint64_t)k, (cuuint64_t)c, 9, 2};
    const cuuint64_t strides[3] = {(cuuint64_t)k * 4, (cuuint64_t)c * k * 4, 9ull * c * k * 4};
    const cuuint32_t box[4] = {(cuuint32_t)KC_F32, 64, 1, 2};
    return make_map(map, w, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B, true);
  } else {
    const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)k, 9};
    const cuuint64_t strides[2] = {(cuuint64_t)c * 2, (cuuint64_t)k * c * 2};
    const cuuint32_t box[3] = {64, (cuuint32_t)KC, 1};
    return make_map(map, w, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
}

// w1, w2: bf16 HWIO, or with Tf32x3Op the split planes.
template <class Op>
cudaError_t launch(const void* x, const void* w1, const void* w2, const Args& a,
                   cudaStream_t stream) {
  using C = Traits<Op>;
  const int th = a.th, tw = a.tw;
  // The fragments of the busiest warp: conv1's mid pixels and conv2's
  // pixels over 8 warps, or 4 for each 64-column half of a 128-column pass.
  const int mi1 = frags((th + 2) * (tw + 2), a.cmid > 64 ? WARPS / 2 : WARPS);
  const int mi2 = frags(th * tw, a.cout > 64 ? WARPS / 2 : WARPS);
  if (a.cin % 8 != 0 || a.cin < 8 || a.cmid % C::KCH != 0 || a.cmid < C::KCH ||
      a.cout % 8 != 0 || a.cout < 8 || th < 2 || tw < 2 || th % 2 != 0 || tw % 2 != 0 ||
      th + 4 > 256 || tw + 4 > 256 || mi1 > C::MI_MAX || mi2 > C::MI_MAX ||
      layout<Op>(th, tw, a.cmid, a.cout).total > MAX_SMEM)
    return cudaErrorInvalidValue;
  CUtensorMap tmx, tmw1, tmw2;
  cudaError_t err = make_nhwc_map(&tmx, x, a.n, a.h, a.wd, a.cin, C::KCH, tw + 4, th + 4,
                                  CU_TENSOR_MAP_SWIZZLE_64B, C::kF32);
  if (err != cudaSuccess) return err;
  err = make_w_map<Op>(&tmw1, w1, a.cin, a.cmid);
  if (err != cudaSuccess) return err;
  err = make_w_map<Op>(&tmw2, w2, a.cmid, a.cout);
  if (err != cudaSuccess) return err;
#define TUK_DC_CASE(A, B)                         \
  case (A - 1) * MI_MAX + B - 1:                  \
    if constexpr (A <= C::MI_MAX && B <= C::MI_MAX) \
      return launch_mi<Op, A, B>(tmx, tmw1, tmw2, a, stream); \
    break;
  switch ((mi1 - 1) * MI_MAX + mi2 - 1) {
    TUK_DC_CASE(1, 1) TUK_DC_CASE(1, 2) TUK_DC_CASE(1, 3) TUK_DC_CASE(1, 4)
    TUK_DC_CASE(2, 1) TUK_DC_CASE(2, 2) TUK_DC_CASE(2, 3) TUK_DC_CASE(2, 4)
    TUK_DC_CASE(3, 1) TUK_DC_CASE(3, 2) TUK_DC_CASE(3, 3) TUK_DC_CASE(3, 4)
    TUK_DC_CASE(4, 1) TUK_DC_CASE(4, 2) TUK_DC_CASE(4, 3) TUK_DC_CASE(4, 4)
  }
#undef TUK_DC_CASE
  return cudaErrorInvalidValue;
}

}  // namespace dc
}  // namespace tc
}  // namespace tuk

// y[N,H,W,cout] = relu(conv3x3_same(relu(conv3x3_same(x, w1) * s1 + b1), w2)
// * s2 + b2), bf16 in and out, mid rounded to bf16 and never written to
// device memory; with pooled (else null) also pooled[N,H/2,W/2,cout] = the
// 2x2 max pool of y. x: [N,H,W,cin], w1: [3,3,cin,cmid], w2: [3,3,cmid,cout]
// HWIO; s*/b*: fp32. cin and cout multiples of 8, cmid of 32; (th, tw): the
// tile plan (kernels/tc_conv.py dc_plan), both even. Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for shapes or a
// tile it does not take.
extern "C" int tuk_tc_double_conv(const void* x, const void* w1, const float* s1, const float* b1,
                                  const void* w2, const float* s2, const float* b2, void* out,
                                  void* pooled, int n, int h, int wd, int cin, int cmid, int cout,
                                  int th, int tw, void* stream) {
  if (n == 0 || h == 0 || wd == 0) return 0;
  using namespace tuk::tc;
  const dc::Args a{s1, b1, s2, b2, out, pooled, n, h, wd, cin, cmid, cout, th, tw};
  return (int)dc::launch<Bf16Op>(x, w1, w2, a, static_cast<cudaStream_t>(stream));
}

// The same in fp32 on the tensor cores (3xTF32), mid fp32 (unrounded) in
// shared memory. x: fp32 [N,H,W,cin]; w1: fp32 [3,3,cin,cmid], w2: fp32
// [3,3,cmid,cout] HWIO; w1split: fp32 [2][9][cmid][cin], w2split: fp32
// [2][9][cout][cmid] scratch for their splits; out, pooled fp32. cin and cout
// multiples of 8, cmid of 16; (th, tw) from dc_plan with f32. One call: the
// two splits, then the double conv.
extern "C" int tuk_tc_double_conv_f32(const float* x, const float* w1, float* w1split,
                                      const float* s1, const float* b1, const float* w2,
                                      float* w2split, const float* s2, const float* b2,
                                      float* out, float* pooled, int n, int h, int wd, int cin,
                                      int cmid, int cout, int th, int tw, void* stream) {
  if (n == 0 || h == 0 || wd == 0) return 0;
  using namespace tuk::tc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin % 8 != 0 || cmid % KC_F32 != 0 || cout % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = split_weights(w1, w1split, cin, cmid, s);
  if (err != cudaSuccess) return (int)err;
  err = split_weights(w2, w2split, cmid, cout, s);
  if (err != cudaSuccess) return (int)err;
  const dc::Args a{s1, b1, s2, b2, out, pooled, n, h, wd, cin, cmid, cout, th, tw};
  return (int)dc::launch<Tf32x3Op>(x, w1split, w2split, a, s);
}
