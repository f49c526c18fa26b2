// 3x3 SAME convolutions on NHWC bf16 (and, for conv3x3_fwd, conv3x3_dx,
// conv3x3_dw and the concat conv, fp32) activations on the Hopper tensor
// cores: one implicit-GEMM mainloop
// over output pixels (tc_conv_kernel) with operand, loader and epilogue
// policies, and one over the pixels of a weight gradient (tc_dw_kernel,
// below the first, and its fp32 sibling tc_dw_f32_kernel):
//
//   tuk_tc_fused_conv3x3  y = [relu](conv3x3_same(x, w) * scale + bias)
//     replaces tpu_unet/kernels/fused_conv.py:75 fused_conv3x3_scale_relu
//     (its pallas_call at :115), bf16 route;
//   tuk_tc_concat_conv3x3 the same over concat([a, b], -1), never built:
//     replaces tpu_unet/kernels/fused_conv.py:192
//     fused_conv3x3_concat_scale_relu (pallas_call at :242), bf16 route;
//   tuk_tc_im2col_conv3x3 the same as one K = 9 * Cin contraction, bf16 or
//     fp32 out: replaces tpu_unet/kernels/im2col_conv.py:84 im2col_conv3x3
//     (pallas_call at :118), bf16 route (tuk_tc_im2col_conv3x3_f32: fp32 x);
//   tuk_tc_conv3x3_fwd    z = conv3x3_same(pro(x), w), optional (sum z, sum z^2)
//     replaces tpu_unet/kernels/train_conv.py:128 conv3x3_fwd (pallas_call at
//     :204), bf16 route. pro(x) = relu(x*a + c) rounded to bf16, or x;
//   tuk_tc_conv3x3_dx     dx = conv3x3_same(dz, flip(w)^T), bf16 or fp32 out,
//     dz = alpha*g + beta*z + gamma (the BN-backward cotangent) built in
//     shared memory: replaces tpu_unet/kernels/train_conv.py:289 conv3x3_dx
//     (pallas_call at :329), bf16 route;
//   tuk_tc_conv3x3_dw     dw[ky,kx,ci,co] = sum over pixels of pro(x) * dz,
//     fp32: replaces tpu_unet/kernels/train_conv.py:441 conv3x3_dw
//     (pallas_call at :508), bf16 route;
//   tuk_tc_fused_conv3x3_f32, tuk_tc_concat_conv3x3_f32,
//     tuk_tc_im2col_conv3x3_f32, tuk_tc_conv3x3_fwd_f32,
//     tuk_tc_conv3x3_dx_f32, tuk_tc_conv3x3_dw_f32: the fp32 routes of the
//     single, the concat and the im2col conv, fwd, dx and dw, in 3xTF32
//     (described below "fp32 in 3xTF32").
//
// The fp32 double conv runs in 3xTF32 in tc_double_conv.cu. No conv of the
// port runs on the CUDA cores.
//
// fp32 in 3xTF32. The port holds fp32 to fp32 accuracy (TF32 off in its
// library calls, ops/conv.py). One TF32 pass rounds each operand to 10
// mantissa bits, about 2^-11 a product, about 5e-4 on a unit output at K =
// 9 * 512: outside the fp32 tolerance. Each fp32 operand is split instead
// into hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi) (v - hi is
// exact), and lo*hi + hi*lo + hi*hi are summed (m16n8k8 TF32 MMAs, small
// terms first; lo*lo, about 2^-22, is left out): about 2^-21 a product. The
// tensor cores round the sum of an MMA toward zero, so three MMAs a k8 step
// summed straight into a large accumulator lose up to three of its ulps a
// step, all of one sign: over the 19,600 pixels of dw at [16,35,35,512] ->
// 1024 that left the fp32 tolerance on the H100 (chip_smoke.py's DW_TOL).
// Each k8 step's three products therefore go into a fresh fragment that is
// added to the accumulator with round-to-nearest (mma_3xtf32,
// tc_common.cuh); chip_smoke.py phase 2b reports the errors left, and
// PERF.md keeps them. The card's fp32-accurate
// rate is then the dense TF32 rate over three, 494.7 / 3 = 164.9 TFLOP/s
// (the bound chip_smoke.py states), against 67 TFLOP/s of fp32 FMA.
// * fwd (Tf32x3Op): KC_F32 = 16 fp32 channels a chunk, the same 64 bytes a
//   staged pixel as bf16's 32, so the same box, swizzle, ring and tc_plan
//   tiles; a k-step is two k8 steps. A: ldmatrix.x4 on the 32-bit words of
//   the staged tile is the m16n8k8 TF32 A layout as it is; split in
//   registers. B: ldmatrix has no 32-bit transpose, so the HWIO weights are
//   split and transposed per call (split_weights_kernel, in the timed call)
//   into K-contiguous [2][9][Cout][Cin] hi and lo planes; one 4-D box
//   brings a k-step's [2][BN][16] slice. The prologue (ProLoadF32) is fp32,
//   unrounded. z is stored from the accumulators, and its stats summed from
//   the same registers into the same per-(image, tile) partial rows.
// * dx (DzLoadF32): the fwd's mainloop over dz, with bf16 dx's one aux slot
//   for z; dz = alpha*g + beta*z + gamma is rewritten in place in fp32,
//   unrounded, in the plain version's order. Its B operand [2][9][Cin][C]
//   is the forward weights' own HWIO layout [9][Cin][C] with the taps
//   reversed, so its split (split_dx_weights_kernel) is elementwise: no
//   transpose and no flipped copy. The aux slot would leave F32Cfg0 one
//   block an SM; F32DxCfg0 keeps two with a 3-k-step weight ring.
// * the concat conv: ConcatLoad over 16-channel chunks (weight rows Ca + 16
//   j for b's chunk j), AffineEpi on the fp32 accumulators, the weights
//   split as the fwd's.
// * the single folded conv: the concat conv's instantiation with one source
//   (RawLoad, AffineEpi), the weights split as the fwd's.
// * im2col: the single conv's mainloop, stored as fp32 from the accumulators
//   or, for out_dtype bf16, through the bf16 output tile (the rings are free
//   by then; F32Cfg*'s rings hold it as Cfg*'s do), rounded once after the
//   ReLU. Its CUDA-core kernel (fp32 FMA over a patch built in shared
//   memory, Cin <= 256) ran at 7-11% of its bound on the H100 and 1.7-3.2x
//   behind cuDNN's fp32 conv at [4,572,572,64|128]->64 (PERF.md).
// * dw (tc_dw_f32_kernel): see there.
//
// The concat conv is the forward's mainloop with a second input tensor map
// (the ConcatLoad policy): the first ceil(Ca / KC) K chunks come from the
// skip's map, the rest from the upsampled tensor's, whose chunk j meets
// weight rows Ca + KC j of the one [9][Ca + Cb][Cout] map (KC = 32 bf16 or
// 16 fp32 channels). Only the load issue picks the map and the row, at
// compile time, so the single-source instantiations keep their code (a
// run-time choice there cost the level-0 conv3x3_fwd and down4's dx 3-4% of
// device time on the H100); the mainloop, swizzles, tile plan and epilogue
// are the single conv's.
// A partial last chunk of the skip (Ca % KC != 0) reads the fill's zeros
// past Ca against the upsampled tensor's first weight rows, which then add
// nothing; the upsampled tensor's last chunk reads the zero rows past Ca +
// Cb. Bound: ~9e10 FLOP at each of the four served decoder shapes, far
// above the ridge (operations). Its CUDA-core version ran at 2% of that and
// 11x behind cuDNN on a prebuilt concat; here the concat costs one more
// tensor map. im2col's K = 9 * Cin contraction over w flattened to [9 *
// Cin][Cout] is that weight map as it is: the staged tile plus halo and
// its 9 shifted windows take the place of the patch matrix, whose VMEM
// traffic bounded the TPU kernel, and which is never built. Its K order is
// chunk-major with the taps inside (the Pallas kernel's is tap-major):
// another fp32 summation order of the same exact products. Its fp32 output
// is stored from the accumulators, as dx's is. Predicted one call on the
// H100: concat 0.35-0.6 ms a served shape, im2col 0.4-0.6 ms at
// [4,572,572,64]->64 and 0.7-0.9 ms at [4,572,572,128]->64; measured (H100
// 80GB HBM3, 700 W, chip_smoke.py phases 2 and 2c, tools/tc_conv_ab.py):
// concat 0.34-0.40 ms one call, 0.25-0.34 ms on the device (was 4.1-4.6 on
// the CUDA cores; cuDNN 0.18-0.36 on the prebuilt concat), im2col 0.49 and
// 0.71 ms, 0.36 and 0.55 on the device (was 5.43 and 18.79; cuDNN 0.50 and
// 0.70).
//
// bf16 dx is the forward's GEMM with Cin' = C and Cout' = Cin over the
// flipped, transposed weights, with the DzLoad policy: each chunk stages g's
// box in the input ring and z's box in ONE aux slot (a second ring of two
// would push the 256 x 64 configuration past two blocks an SM); chunk k + 1's z
// box is issued right after chunk k's rewrite has read the slot, 9 k-steps
// before it is needed. SMEM a block: 96,312 bytes (256 x 64, Cfg1) and
// 93,240 (128 x 128, Cfg0) with the slot, two blocks an SM. A two-slot z
// ring issued with g's box measured no faster on the H100 where both keep
// two blocks an SM (128 x 128), so the one slot does not stall the ring;
// at 256 x 64 it left one block an SM and was 1.5x slower. Its fp32 output
// (ConvStatsPro's backward asks for it) is stored straight from the
// accumulators, a quad of lanes writing whole 32-byte sectors, so it needs
// no fp32 tile in shared memory.
//
// dw is described at tc_dw_kernel. What bounds it is the same as for the
// convolutions (2*9*Cin*Cout FLOPs a pixel). Its first version, blocks of
// one kernel row (3 taps) of 4 warps, two an SM, rewrote each staged tile
// (the prologue and dz, on the CUDA cores) once per kernel row and ran 1.8x
// (level 0) to 2.8x ([16,35,35,512] -> 1024) slower on the H100 than the
// 9-tap block of 12 warps kept here. Unrolling its k-step loop by two
// measured 1-2% slower.
//
// What bounds it on the H100 in bf16: at the deep levels (Cin, Cout >= 256)
// a pixel does 2*9*Cin*Cout FLOPs against (Cin + Cout) * 2 bytes moved, far
// above the 295 FLOP/byte ridge of the 989 TFLOP/s tensor cores, so those
// calls are operations-bound; at level 0 (Cin = Cout = 64) it is 288 FLOP/B,
// bytes and operations about equal.
//
// Design.
// * GEMM view: M = output pixels, N = Cout, K = 9 * Cin. A block owns a
//   th x tw rectangle of output pixels (th * tw <= BM) of one image and BN
//   output channels, split over WM x WN warps (warp tiles of m16 x n8
//   fragments). The rectangle comes from the shape (tc_plan in
//   kernels/tc_conv.py, the one tile plan that the wrapper sizes the stats
//   partials by and that the kernel receives as th/tw): any tw, so 35 x 35
//   or 40 x 59 do not waste most of a fixed 8 x 16 tile.
// * Math: mma.sync.m16n8k16 bf16 -> fp32, fed by ldmatrix.x4 (A) and
//   ldmatrix.x4.trans (B, straight from the HWIO layout: Cout contiguous, so
//   no per-call repack). A wgmma version (A from registers, B by descriptor)
//   measured no faster here, because the loads, not the MMA issue, bounded
//   both; it was dropped to keep one mainloop.
// * Implicit GEMM over a staged halo: for each chunk of KC = 32 input
//   channels the block stages its input rectangle plus a 1-pixel halo,
//   (th+2) x (tw+2) pixels x 32 channels (64 bytes a pixel), once, and reads
//   the 9 taps as 9 shifted windows of it. No patch matrix is built.
// * Loads by the Tensor Memory Accelerator, one request per tile: the input
//   chunk is one box of a 4-D tensor map over NHWC whose out-of-bounds fill
//   gives the halo's zeros (and the channels past Cin); each k-step's weight
//   slice [KC][BN] is one or two boxes of a 3-D map over [9][Cin][Cout].
//   One thread issues them; mbarriers count their bytes. Per-thread 16-byte
//   cp.async copies were the kernel's bottleneck on the H100: their address
//   math and load-store traffic competed with ldmatrix; so were many small
//   bulk copies issued by one thread.
// * Swizzle: the input chunk lands with the 64-byte swizzle (16-byte chunk c
//   of pixel q at c ^ (q/2 % 4)), the weights with the 128-byte one (chunk c
//   of row r at c ^ (r % 8)), so the 8 rows of an ldmatrix phase fall in
//   distinct banks; the ldmatrix addresses apply the same XOR.
// * K order: chunk-major, 9 taps inside a chunk (k-step s = 9 * chunk + tap).
//   Weights run in a ring of STAGES k-steps, the input in a ring of 2
//   chunks, both issued STAGES - 1 k-steps ahead. One __syncthreads per
//   k-step frees the slot of the step before.
// * Prologue policy (ProLoad): at a chunk's first k-step one pass rewrites
//   it in place as relu(x*a + c) rounded to bf16 (__fmul_rn then __fadd_rn,
//   as the plain version), skipping positions outside the image or past
//   Cin, which stay the zeros of the fill: relu(c) never leaks into the
//   SAME padding. Tiles whose halo lies inside the image skip that test per
//   pixel. (Rewriting the next chunk in pieces beside the MMAs of the
//   current one measured slower on the H100, most at the deep shapes.)
// * Epilogue policies: AffineEpi (scale * acc + bias, optional ReLU) or the
//   bare rounding; the bf16 tile goes through shared memory so that global
//   stores are 16-byte and coalesced. With stats, each thread sums the
//   ROUNDED values of the 8 channels it stores, read back from that tile,
//   then lane shuffles and the warps in order make one partial row per
//   (image, tile); reduce_rows (train_conv.cu) adds the rows in a fixed
//   order. Summing in the store loop, not from the accumulators, keeps 32
//   registers out of the epilogue (the 256 x 64 block sits at 255).
//   Results are bitwise deterministic: nothing is atomic.
// * Cin and Cout must be multiples of 8 (the tensor maps' 16-byte strides):
//   the wrapper zero-pads Cin = 3 to 8 channels, as the Pallas kernel does.

#include "tc_common.cuh"

#include <type_traits>

namespace tuk {

// Fixed-order sum of fp32 rows (train_conv.cu); `in` is scratch.
cudaError_t reduce_rows(float* in, float* out, int rows, long long cols, cudaStream_t stream);

namespace tc {

constexpr int STAGES = 4;  // k-steps in the weight ring (a Config may take fewer)

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// A block configuration: BM output pixels x BN output channels, WM x WN
// warps (each a (BM / WM) x (BN / WN) warp tile), MAX_STAGED pixels of the
// tile plus its halo, MIN_BLOCKS resident blocks an SM (launch bounds), the
// operands Op, a weight ring of STAGES k-steps.
template <int BM_, int BN_, int WM_, int WN_, int MAX_STAGED_, int MIN_BLOCKS_,
          class Op_ = Bf16Op, int STAGES_ = STAGES>
struct Config {
  using Op = Op_;
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int MAX_STAGED = MAX_STAGED_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int STAGES = STAGES_;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MI = BM / WM / 16;  // m16 fragments per warp
  static constexpr int NI = BN / WN / 8;   // n8 fragments per warp
  // A staged pixel's chunk is 64 bytes: KC bf16 or KC_F32 fp32 channels.
  static constexpr int IN_SLOT = round_up(MAX_STAGED * 64, kAlign);  // bytes
  // A k-step's weights: [KC][BN] bf16, or the hi and lo planes [2][BN][KC_F32].
  static constexpr int W_SLOT = Op::kTf32 ? 2 * BN * KC_F32 * 4 : KC * BN * 2;  // bytes
  static constexpr int RED = WM * WN * 2 * BN * 4;                       // stats scratch
  static constexpr size_t SMEM =
      kAlign + 2 * IN_SLOT + STAGES * W_SLOT + RED + (2 + STAGES) * 8;
  static_assert(MI >= 1 && NI % 2 == 0 && BN % 64 == 0, "fragment shape");
  static_assert(BM * (BN + 8) * 2 <= 2 * IN_SLOT + STAGES * W_SLOT,
                "the output tile reuses the rings");
};

// The configurations tc_plan (kernels/tc_conv.py) chooses from, by id:
// Cout > 64 and Cout <= 64. Both are 4 warps of 64 pixels x 64 channels
// (128 fp32 accumulators a thread), two blocks an SM: on the H100 they were
// as fast as 8 warps of 32 x 64, 256 x 128 blocks or 128 x 64 blocks at four
// an SM at level 0, and faster at the deep shapes.
using Cfg0 = Config<128, 128, 2, 2, 288, 2>;
using Cfg1 = Config<256, 64, 4, 1, 400, 2>;
// The fp32 (3xTF32) forward's, by the same ids and tile shapes (tc_plan),
// two blocks an SM: 128 accumulators a thread, beside a k8 step's split A
// fragment (12 registers), both planes' B fragments of 4 n8 blocks (16) and
// their fresh sums (16).
using F32Cfg0 = Config<128, 128, 2, 2, 288, 2, Tf32x3Op>;
using F32Cfg1 = Config<256, 64, 4, 1, 400, 2, Tf32x3Op>;
// The fp32 dx's, by the same ids and tiles. Its aux slot (z) adds IN_SLOT +
// 8 bytes a block: F32Cfg0 would take 126,008 bytes, one block an SM (two
// need each at most (233,472 - 2 * 1,024) / 2 = 115,712, the 1 KB a block
// the card reserves included); a 3-k-step weight ring takes 109,624. F32Cfg1
// with the slot takes 112,696 bytes at 4 k-steps: kept as it is.
using F32DxCfg0 = Config<128, 128, 2, 2, 288, 2, Tf32x3Op, 3>;
using F32DxCfg1 = F32Cfg1;

// Where a block's tile lies, and what it stages.
struct Tile {
  int n, h0, w0, th, tw, H, W;
  __device__ __forceinline__ int sw() const { return tw + 2; }
  __device__ __forceinline__ int staged() const { return (th + 2) * (tw + 2); }
  // Staged pixel q (row-major over the halo rectangle) lies in the image.
  __device__ __forceinline__ bool staged_in_image(int q) const {
    const int r = q / sw();
    const int gh = h0 - 1 + r;
    const int gw = w0 - 1 + (q - r * sw());
    return gh >= 0 && gh < H && gw >= 0 && gw < W;
  }
};

// ---- the two in-place rewrites of staged bf16 values ------------------------
//
// Each rewrites one 16-byte chunk (8 channels) of a staged position, in fp32
// with separately rounded operations in the plain version's order, rounded
// to bf16 once.

// v = relu(v * a + c).
__device__ __forceinline__ void pro_chunk(uint4* p, const float (&av)[8], const float (&cv)[8]) {
  uint4 raw = *p;
  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(v[e]);
    v[e] = __floats2bfloat162_rn(relu_f(__fadd_rn(__fmul_rn(f.x, av[2 * e]), cv[2 * e])),
                                 relu_f(__fadd_rn(__fmul_rn(f.y, av[2 * e + 1]), cv[2 * e + 1])));
  }
  *p = raw;
}

// g = alpha * g + beta * z + gamma (the BN-backward cotangent dz).
__device__ __forceinline__ void dz_chunk(uint4* g, const uint4* z, const float (&al)[8],
                                         const float (&be)[8], const float (&ga)[8]) {
  uint4 graw = *g;
  const uint4 zraw = *z;
  __nv_bfloat162* gv = reinterpret_cast<__nv_bfloat162*>(&graw);
  const __nv_bfloat162* zv = reinterpret_cast<const __nv_bfloat162*>(&zraw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 fg = __bfloat1622float2(gv[e]);
    const float2 fz = __bfloat1622float2(zv[e]);
    gv[e] = __floats2bfloat162_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(al[2 * e], fg.x), __fmul_rn(be[2 * e], fz.x)), ga[2 * e]),
        __fadd_rn(__fadd_rn(__fmul_rn(al[2 * e + 1], fg.y), __fmul_rn(be[2 * e + 1], fz.y)),
                  ga[2 * e + 1]));
  }
  *g = graw;
}

// Eight consecutive fp32 values (16-byte aligned).
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

// v = relu(v * a + c) on 4 fp32 channels, in place (no rounding: fp32 x).
__device__ __forceinline__ void pro_chunk_f32(float4* p, const float4& a, const float4& c) {
  float4 v = *p;
  v.x = relu_f(__fadd_rn(__fmul_rn(v.x, a.x), c.x));
  v.y = relu_f(__fadd_rn(__fmul_rn(v.y, a.y), c.y));
  v.z = relu_f(__fadd_rn(__fmul_rn(v.z, a.z), c.z));
  v.w = relu_f(__fadd_rn(__fmul_rn(v.w, a.w), c.w));
  *p = v;
}

// g = alpha * g + beta * z + gamma on 4 fp32 channels, in place, in the
// plain version's order (no rounding: fp32 g).
__device__ __forceinline__ void dz_chunk_f32(float4* g, const float4* z, const float4& al,
                                             const float4& be, const float4& ga) {
  float4 v = *g;
  const float4 w = *z;
  v.x = __fadd_rn(__fadd_rn(__fmul_rn(al.x, v.x), __fmul_rn(be.x, w.x)), ga.x);
  v.y = __fadd_rn(__fadd_rn(__fmul_rn(al.y, v.y), __fmul_rn(be.y, w.y)), ga.y);
  v.z = __fadd_rn(__fadd_rn(__fmul_rn(al.z, v.z), __fmul_rn(be.z, w.z)), ga.z);
  v.w = __fadd_rn(__fadd_rn(__fmul_rn(al.w, v.w), __fmul_rn(be.w, w.w)), ga.w);
  *g = v;
}

// ---- loader policies: what the staged chunk holds --------------------------
//
// kAux: the policy stages a second box of the same shape (z) in a slot of
// its own, which transform() reads. kConcat: the input is the channel
// concat of two tensors, each with a map of its own (only the load issue
// differs; the single-source policies keep their code as it was).

// The raw input, as loaded.
struct RawLoad {
  static constexpr bool kTransform = false;
  static constexpr bool kAux = false;
  static constexpr bool kConcat = false;
  template <class C>
  __device__ __forceinline__ void transform(unsigned char*, const unsigned char*, const Tile&,
                                            int, int) const {}
};

// concat([x, b], -1), raw, never built: x's chunks, then b's.
struct ConcatLoad : RawLoad {
  static constexpr bool kConcat = true;
};

// relu(x*a + c) rounded to bf16, rewritten in place over the loaded chunk.
// Positions outside the image or past Cin keep the zeros of the fill.
struct ProLoad {
  static constexpr bool kTransform = true;
  static constexpr bool kAux = false;
  static constexpr bool kConcat = false;
  const float* a;
  const float* c;
  template <class C>
  __device__ __forceinline__ void transform(unsigned char* slot, const unsigned char*,
                                            const Tile& t, int k0, int cin) const {
    constexpr int kVec = KC / 8;  // 16-byte chunks per staged pixel
    static_assert(C::THREADS % kVec == 0, "a thread keeps its 8 channels");
    const int ch = threadIdx.x % kVec;
    const int k = k0 + ch * 8;
    // Most tiles' halo lies in the image: they skip the per-pixel test.
    const bool inside = t.h0 >= 1 && t.h0 + t.th < t.H && t.w0 >= 1 && t.w0 + t.tw < t.W;
    if (k < cin) {
      float av[8], cv[8];
      load8(av, a + k);
      load8(cv, c + k);
      for (int q = threadIdx.x / kVec; q < t.staged(); q += C::THREADS / kVec) {
        if (!inside && !t.staged_in_image(q)) continue;
        pro_chunk(reinterpret_cast<uint4*>(slot + in_off(q, ch)), av, cv);
      }
    }
    fence_proxy_async();  // the slot is TMA-written again two chunks later
  }
};

// relu(x*a + c) over an fp32 chunk (KC_F32 channels, 4 to a 16-byte piece),
// as ProLoad; the fp32 forward's loader.
struct ProLoadF32 {
  static constexpr bool kTransform = true;
  static constexpr bool kAux = false;
  static constexpr bool kConcat = false;
  const float* a;
  const float* c;
  template <class C>
  __device__ __forceinline__ void transform(unsigned char* slot, const unsigned char*,
                                            const Tile& t, int k0, int cin) const {
    static_assert(C::Op::kTf32, "fp32 operands");
    constexpr int kVec = KC_F32 / 4;  // 16-byte pieces per staged pixel
    static_assert(C::THREADS % kVec == 0, "a thread keeps its 4 channels");
    const int ch = threadIdx.x % kVec;
    const int k = k0 + ch * 4;
    const bool inside = t.h0 >= 1 && t.h0 + t.th < t.H && t.w0 >= 1 && t.w0 + t.tw < t.W;
    if (k < cin) {
      const float4 av = *reinterpret_cast<const float4*>(a + k);
      const float4 cv = *reinterpret_cast<const float4*>(c + k);
      for (int q = threadIdx.x / kVec; q < t.staged(); q += C::THREADS / kVec) {
        if (!inside && !t.staged_in_image(q)) continue;
        pro_chunk_f32(reinterpret_cast<float4*>(slot + in_off(q, ch)), av, cv);
      }
    }
    fence_proxy_async();  // the slot is TMA-written again two chunks later
  }
};

// dz = alpha*g + beta*z + gamma rounded to bf16 (coef: fp32 [3][C]),
// rewritten in place over the loaded g chunk from the z chunk of the aux
// slot. Positions outside the image or past C keep the zeros of the fill:
// gamma != 0 never leaks into the SAME padding.
struct DzLoad {
  static constexpr bool kTransform = true;
  static constexpr bool kAux = true;
  static constexpr bool kConcat = false;
  const float* coef;
  template <class C>
  __device__ __forceinline__ void transform(unsigned char* slot, const unsigned char* zs,
                                            const Tile& t, int k0, int c) const {
    constexpr int kVec = KC / 8;
    static_assert(C::THREADS % kVec == 0, "a thread keeps its 8 channels");
    const int ch = threadIdx.x % kVec;
    const int k = k0 + ch * 8;
    const bool inside = t.h0 >= 1 && t.h0 + t.th < t.H && t.w0 >= 1 && t.w0 + t.tw < t.W;
    if (k < c) {
      float al[8], be[8], ga[8];
      load8(al, coef + k);
      load8(be, coef + c + k);
      load8(ga, coef + 2 * c + k);
      for (int q = threadIdx.x / kVec; q < t.staged(); q += C::THREADS / kVec) {
        if (!inside && !t.staged_in_image(q)) continue;
        dz_chunk(reinterpret_cast<uint4*>(slot + in_off(q, ch)),
                 reinterpret_cast<const uint4*>(zs + in_off(q, ch)), al, be, ga);
      }
    }
    fence_proxy_async();  // both slots are TMA-written again
  }
};

// dz = alpha*g + beta*z + gamma over an fp32 chunk (KC_F32 channels, 4 to a
// 16-byte piece), as DzLoad but unrounded; the fp32 dx's loader.
struct DzLoadF32 {
  static constexpr bool kTransform = true;
  static constexpr bool kAux = true;
  static constexpr bool kConcat = false;
  const float* coef;
  template <class C>
  __device__ __forceinline__ void transform(unsigned char* slot, const unsigned char* zs,
                                            const Tile& t, int k0, int c) const {
    static_assert(C::Op::kTf32, "fp32 operands");
    constexpr int kVec = KC_F32 / 4;
    static_assert(C::THREADS % kVec == 0, "a thread keeps its 4 channels");
    const int ch = threadIdx.x % kVec;
    const int k = k0 + ch * 4;
    const bool inside = t.h0 >= 1 && t.h0 + t.th < t.H && t.w0 >= 1 && t.w0 + t.tw < t.W;
    if (k < c) {
      const float4 al = *reinterpret_cast<const float4*>(coef + k);
      const float4 be = *reinterpret_cast<const float4*>(coef + c + k);
      const float4 ga = *reinterpret_cast<const float4*>(coef + 2 * c + k);
      for (int q = threadIdx.x / kVec; q < t.staged(); q += C::THREADS / kVec) {
        if (!inside && !t.staged_in_image(q)) continue;
        dz_chunk_f32(reinterpret_cast<float4*>(slot + in_off(q, ch)),
                     reinterpret_cast<const float4*>(zs + in_off(q, ch)), al, be, ga);
      }
    }
    fence_proxy_async();  // both slots are TMA-written again
  }
};

// ---- epilogue policies: the fp32 value rounded to bf16 for channel co ------

struct RoundEpi {
  __device__ __forceinline__ float operator()(float acc, int) const { return acc; }
};

// [relu](acc * scale + bias), two separately rounded fp32 operations.
struct AffineEpi {
  const float* scale;
  const float* bias;
  int relu;
  __device__ __forceinline__ float operator()(float acc, int co) const {
    const float y = __fadd_rn(__fmul_rn(acc, scale[co]), bias[co]);
    return relu ? relu_f(y) : y;
  }
};

// Dynamic shared memory of tc_conv_kernel<C, Load, ...>: the aux slot and
// its barrier when the loader stages one.
template <class C, class Load>
constexpr size_t smem_bytes() {
  return C::SMEM + (Load::kAux ? C::IN_SLOT + 8 : 0);
}

// ---- the kernel -------------------------------------------------------------
//
// Grid: (tiles_h * tiles_w, ceil(cout / BN), N). Block (t, cb, n) computes
// output pixels h0 + p / tw, w0 + p % tw (p < th * tw) of image n, channels
// cb * BN ... With partials, it writes the (sum, sum of squares) of its
// rounded outputs per channel to partials[((n * tiles + t) * 2 + s) * cout + co].
// The input is x (ca == cin), or with Load::kConcat the channel concat of x
// (ca channels) and b (cin - ca), which is never built.
// tmx: x as [N][H][W][ca] (dims ca, W, H, N), box (KC, tw + 2, th + 2, 1);
// tmb: b as [N][H][W][cin - ca], the same box (unused without kConcat);
// tmz: the aux input (z), x's dims and box (unused without kAux);
// tmw: w as [9][cin][cout] (dims cout, cin, 9), box (64, KC, 1); with
// Tf32x3Op the split weights [2][9][cout][cin] (dims cin, cout, 9, 2), box
// (KC_F32, BN, 1, 2).
// out: bf16, or fp32 with kF32Out (stored from the accumulators; with
// Tf32x3Op and stats always, the stats then summed from the accumulators too).
template <class C, class Load, class Epi, bool kStats, bool kF32Out>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
    tc_conv_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmb,
                   const __grid_constant__ CUtensorMap tmz, const __grid_constant__ CUtensorMap tmw,
                   Load ld, Epi epi, void* __restrict__ out_ptr, float* __restrict__ partials,
                   int H, int W, int ca, int cin, int cout, int th, int tw, int tiles_w) {
  using Op = typename C::Op;
  static_assert(!Op::kTf32 || kF32Out || !kStats, "fp32 stats are summed from the accumulators");
  static_assert(!(kStats && kF32Out) || Op::kTf32, "bf16 stats are taken from the bf16 tile");
  constexpr int KCH = Op::KC;  // channels a staged chunk
  constexpr int STAGES = C::STAGES;
  constexpr int BN = C::BN;
  constexpr int MI = C::MI;
  constexpr int NI = C::NI;
  constexpr int kWarpM = C::BM / C::WM;
  constexpr int kWarpN = C::BN / C::WN;
  constexpr int kORow = BN + 8;  // halves per output-tile row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* in_s = smem;                    // 2 input slots
  unsigned char* w_s = in_s + 2 * C::IN_SLOT;    // STAGES weight slots
  unsigned char* aux_s = w_s + STAGES * C::W_SLOT;  // 1 aux slot with kAux
  float* red_s = reinterpret_cast<float*>(aux_s + (Load::kAux ? C::IN_SLOT : 0));
  uint64_t* in_bar = reinterpret_cast<uint64_t*>(red_s + C::WM * C::WN * 2 * BN);
  uint64_t* w_bar = in_bar + 2;
  uint64_t* aux_bar = w_bar + STAGES;
  bf16* out = static_cast<bf16*>(out_ptr);

  const Tile t{(int)blockIdx.z, (int)(blockIdx.x / tiles_w) * th,
               (int)(blockIdx.x % tiles_w) * tw, th, tw, H, W};
  const int co0 = blockIdx.y * BN;
  const int tile_px = th * tw;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp % C::WM;
  const int wn = warp / C::WM;
  const int a_chunks = (ca + KCH - 1) / KCH;  // x's, with kConcat
  const int nchunks =
      Load::kConcat ? a_chunks + (cin - ca + KCH - 1) / KCH : (cin + KCH - 1) / KCH;
  const int nsteps = 9 * nchunks;

  // This lane's ldmatrix row in each m16 fragment: the staged pixel that tap
  // (0, 0) of its output pixel reads (rows past the tile read pixel 0 and
  // are discarded); its 8-channel half of a k16 step is chunk 2 * kk + lane / 16.
  int a_q[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int p = wm * kWarpM + mi * 16 + lane % 16;
    a_q[mi] = p < tile_px ? (p / tw) * t.sw() + p % tw : 0;
  }
  // ldmatrix.trans of four 8x8 blocks of n16 group j: k rows
  // (lane / 8 % 2) * 8 + lane % 8 (+ 16 kk), channels (lane / 16) * 8.
  // With Tf32x3Op, ldmatrix (no .trans) of the K-contiguous planes: matrix
  // lane / 8 is n8 block 2 j + lane / 16, k half (lane / 8) % 2; b_off holds
  // the lane's row (output channel) of the slice.
  int b_off[NI / 2];
#pragma unroll
  for (int j = 0; j < NI / 2; ++j) {
    if constexpr (Op::kTf32) {
      b_off[j] = wn * kWarpN + j * 16 + (lane / 16) * 8 + lane % 8;
    } else {
      const int col8 = (wn * kWarpN + j * 16) / 8 + lane / 16;  // n8 block in the slice
      b_off[j] = (col8 / 8) * (KC * 128) + w_off((lane / 8) % 2 * 8 + lane % 8, col8 % 8);
    }
  }

  // One thread issues the loads of k-step g: at a chunk's first tap its
  // input box, always its weight boxes. A concat's chunks past x's come
  // from b: chunk a_chunks + j is b's channels 32 j ..., weight rows ca +
  // 32 j .... x's last chunk, when ca % 32 != 0, reads zeros past ca (the
  // fill), against b's first weight rows: they add nothing.
  auto issue = [&](int g) {
    if (threadIdx.x != 0) return;
    const int chunk = g / 9;
    const int tap = g - chunk * 9;
    const CUtensorMap* src = &tmx;
    int k = chunk * KCH;  // the chunk's first channel in its source
    int row = k;          // and its first weight row
    if constexpr (Load::kConcat) {
      if (chunk >= a_chunks) {
        src = &tmb;
        k = (chunk - a_chunks) * KCH;
        row = ca + k;
      }
    }
    fence_proxy_async();
    if (tap == 0) {
      uint64_t* bar = in_bar + (chunk & 1);
      mbar_expect_tx(bar, (uint32_t)(t.staged() * 64));
      tma_load_4d(in_s + (chunk & 1) * C::IN_SLOT, src, bar, k, t.w0 - 1, t.h0 - 1, t.n);
    }
    uint64_t* bar = w_bar + g % STAGES;
    mbar_expect_tx(bar, (uint32_t)C::W_SLOT);
    if constexpr (Op::kTf32) {
      // Both planes' [BN][KC_F32] slices, one box: plane 1 lands BN * 64 bytes on.
      tma_load_4d(w_s + (g % STAGES) * C::W_SLOT, &tmw, bar, row, co0, tap, 0);
    } else {
#pragma unroll
      for (int hh = 0; hh < BN / 64; ++hh)
        tma_load_3d(w_s + (g % STAGES) * C::W_SLOT + hh * KC * 128, &tmw, bar, co0 + hh * 64,
                    row, tap);
    }
  };
  // The aux box of a chunk goes into the one aux slot: chunk k + 1's is
  // issued once chunk k's transform has read the slot, 9 k-steps before it
  // is needed.
  auto issue_aux = [&](int chunk) {
    if (threadIdx.x != 0) return;
    fence_proxy_async();
    mbar_expect_tx(aux_bar, (uint32_t)(t.staged() * 64));
    tma_load_4d(aux_s, &tmz, aux_bar, chunk * KCH, t.w0 - 1, t.h0 - 1, t.n);
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 + STAGES + (Load::kAux ? 1 : 0); ++i) mbar_init(in_bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (Load::kAux) issue_aux(0);
#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g)
    if (g < nsteps) issue(g);

#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    const int chunk = s / 9;
    const int tap = s - chunk * 9;
    unsigned char* slot = in_s + (chunk & 1) * C::IN_SLOT;
    if (tap == 0) mbar_wait(in_bar + (chunk & 1), (chunk >> 1) & 1);
    if (Load::kAux && tap == 0) mbar_wait(aux_bar, chunk & 1);
    mbar_wait(w_bar + s % STAGES, (s / STAGES) & 1);
    __syncthreads();  // every thread is past step s - 1: its weight slot is free
    if (Load::kTransform && tap == 0) {
      ld.template transform<C>(slot, aux_s, t, chunk * KCH, cin);
      __syncthreads();
      if (Load::kAux && chunk + 1 < nchunks) issue_aux(chunk + 1);
    }
    if (s + STAGES - 1 < nsteps) issue(s + STAGES - 1);

    const int tap_q = (tap / 3) * t.sw() + tap % 3;
    const uint32_t a_base = smem_addr(slot);
    const uint32_t b_base = smem_addr(w_s + (s % STAGES) * C::W_SLOT);
    if constexpr (Op::kTf32) {
      // Two k8 steps of the 16-channel chunk. A's ldmatrix.x4 on the 32-bit
      // words of the staged pixels gives the m16n8k8 TF32 layout as it is
      // (matrix = rows 0-7 / 8-15 x k 0-3 / 4-7); each word is split in
      // registers. B comes split from the planes, 4 n8 blocks at a time (16
      // registers, not 32: with all 8 the 128 x 128 block spilled at 255);
      // mma_3xtf32 runs each pass over the 4 blocks in turn, so no MMA
      // waits on the one before it.
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int g0 = 0; g0 < NI; g0 += 4) {
          uint32_t bh[2][4], bl[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int off = in_off(b_off[g0 / 2 + j], 2 * kk + (lane / 8) % 2);
            ldmatrix_x4(bh[j], b_base + off);
            ldmatrix_x4(bl[j], b_base + BN * 64 + off);
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
      for (int kk = 0; kk < KC / 16; ++kk) {
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

  // Epilogue: lane holds rows p = wm*kWarpM + mi*16 + lane/4 (+8) and
  // channels j = wn*kWarpN + ni*8 + (lane%4)*2 (+1) of the [BM][BN] tile.
  if constexpr (kF32Out) {
    // fp32 out: each quad of lanes stores 8 channels (32 bytes) of a pixel
    // straight from the accumulators, whole 32-byte sectors. With stats
    // (fp32 z is the accumulator itself) each thread sums its own channels'
    // values over its pixels in order, from the same registers.
    float* outf = static_cast<float*>(out_ptr);
    float s1[kStats ? NI : 1][2], s2[kStats ? NI : 1][2];
    if constexpr (kStats) {
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) s1[ni][0] = s1[ni][1] = s2[ni][0] = s2[ni][1] = 0.f;
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = wm * kWarpM + mi * 16 + lane / 4 + hf * 8;
        const int gh = t.h0 + p / tw;
        const int gw = t.w0 + p % tw;
        if (p >= tile_px || gh >= H || gw >= W) continue;
        float* row = outf + (((size_t)t.n * H + gh) * W + gw) * cout;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int co = co0 + wn * kWarpN + ni * 8 + (lane % 4) * 2;
          if (co < cout) {
            const float y0 = epi(acc[mi][ni][hf * 2], co);
            const float y1 = epi(acc[mi][ni][hf * 2 + 1], co + 1);
            *reinterpret_cast<float2*>(row + co) = make_float2(y0, y1);
            if constexpr (kStats) {
              s1[ni][0] += y0;
              s1[ni][1] += y1;
              s2[ni][0] += y0 * y0;
              s2[ni][1] += y1 * y1;
            }
          }
        }
      }
    if constexpr (kStats) {
      // The lanes of one channel pair sit 4 apart: add a warp's 8 with
      // shuffles, then the WM warps of a channel in order.
#pragma unroll
      for (int m = 4; m < 32; m *= 2)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s1[ni][e] += __shfl_xor_sync(0xffffffffu, s1[ni][e], m);
            s2[ni][e] += __shfl_xor_sync(0xffffffffu, s2[ni][e], m);
          }
      if (lane < 4) {
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = wn * kWarpN + ni * 8 + lane * 2 + e;
            red_s[(wm * 2 + 0) * BN + j] = s1[ni][e];
            red_s[(wm * 2 + 1) * BN + j] = s2[ni][e];
          }
      }
      __syncthreads();
      const size_t prow = (size_t)t.n * gridDim.x + blockIdx.x;
      for (int i = threadIdx.x; i < 2 * BN; i += C::THREADS) {
        const int st = i / BN;
        const int j = i % BN;
        if (co0 + j < cout) {
          float sum = 0.f;
#pragma unroll
          for (int q = 0; q < C::WM; ++q) sum += red_s[(q * 2 + st) * BN + j];
          partials[(prow * 2 + st) * cout + co0 + j] = sum;
        }
      }
    }
    return;
  }
  __syncthreads();  // the rings are free: the output tile [BM][BN + 8] reuses them
  bf16* out_s = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = wm * kWarpM + mi * 16 + lane / 4 + hf * 8;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int j = wn * kWarpN + ni * 8 + (lane % 4) * 2;
        const int co = co0 + j;
        float y0 = 0.f, y1 = 0.f;
        if (co < cout) {  // cout % 8 == 0: co + 1 < cout too
          y0 = epi(acc[mi][ni][hf * 2], co);
          y1 = epi(acc[mi][ni][hf * 2 + 1], co + 1);
        }
        *reinterpret_cast<__nv_bfloat162*>(out_s + p * kORow + j) = __floats2bfloat162_rn(y0, y1);
      }
    }
  __syncthreads();

  // Coalesced 16-byte stores of the valid part of the tile. A thread keeps
  // one 8-channel group of every pixel it stores; with stats it also sums
  // those channels' rounded values over its pixels, in order.
  constexpr int kVecOut = BN / 8;
  static_assert(C::THREADS % kVecOut == 0 && 32 % kVecOut == 0, "a thread keeps its group");
  const int v = threadIdx.x % kVecOut;
  const int co = co0 + v * 8;
  float s1[8], s2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s1[e] = s2[e] = 0.f;
  for (int p = threadIdx.x / kVecOut; p < tile_px; p += C::THREADS / kVecOut) {
    const int gh = t.h0 + p / tw;
    const int gw = t.w0 + p % tw;
    if (gh < H && gw < W && co < cout) {
      const uint4 val = *reinterpret_cast<const uint4*>(out_s + p * kORow + v * 8);
      *reinterpret_cast<uint4*>(out + (((size_t)t.n * H + gh) * W + gw) * cout + co) = val;
      if (kStats) {
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&val);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          s1[2 * e] += f.x;
          s1[2 * e + 1] += f.y;
          s2[2 * e] += f.x * f.x;
          s2[2 * e + 1] += f.y * f.y;
        }
      }
    }
  }

  if (kStats) {
    // The threads of one channel group sit kVecOut lanes apart: add a
    // warp's with lane shuffles, then the warps in order.
#pragma unroll
    for (int m = kVecOut; m < 32; m *= 2)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], m);
        s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], m);
      }
    if (lane < kVecOut) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        red_s[(warp * 2 + 0) * BN + v * 8 + e] = s1[e];
        red_s[(warp * 2 + 1) * BN + v * 8 + e] = s2[e];
      }
    }
    __syncthreads();
    const size_t row = (size_t)t.n * gridDim.x + blockIdx.x;
    for (int i = threadIdx.x; i < 2 * BN; i += C::THREADS) {
      const int st = i / BN;
      const int j = i % BN;
      if (co0 + j < cout) {
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < C::THREADS / 32; ++q) sum += red_s[(q * 2 + st) * BN + j];
        partials[(row * 2 + st) * cout + co0 + j] = sum;
      }
    }
  }
}

// ---- dw: the weight gradient, a GEMM reducing over pixels -------------------
//
// Per tap (ky, kx): dw[tap][ci][co] = sum over pixels p of
// pro(x)[p + (ky - 1, kx - 1)][ci] * dz[p][co], i.e. M = ci, N = co, K = the
// split's pixels. A block owns DW_CI input x DW_CO output channels and all
// 9 taps: 12 warps, 4 for each kernel row ky, each 32 ci x 32 co x the 3
// taps of its row (96 fp32 accumulators a thread). For each pixel tile (th x
// tw of one image, at most DW_MAX_PX pixels) it stages, by TMA with the
// 128-byte swizzle:
//   x: the tile plus a 1-pixel halo, 64 channels (128 bytes) a pixel, the
//      BN prologue rewritten in place (A, read with ldmatrix.x4.trans: each
//      lane gives one pixel of the shifted window, 16 bytes of 8 ci);
//   g and z: the tile's pixels, 64 channels; dz = alpha*g + beta*z + gamma
//      is rewritten in place over g (B, ldmatrix.x4.trans as the forward
//      reads its weights). A k16 step loads its dz fragment once for the 3
//      taps of the warp's row.
// The rewrites run on the CUDA cores, so a tile is rewritten once for all 9
// taps (blocks of one kernel row, 4 warps, rewrote it three times and
// measured 1.8x to 2.8x slower on the H100). Rings: x and g two tiles deep
// (the next tile's boxes are in flight during a tile's MMAs), z one slot
// (the next tile's z box is issued once this tile's dz is built). Rows of dz
// past th * tw (K padded to 16) are zeroed once and never written; pixels
// outside the image keep the fill's zeros.
constexpr int DW_CI = 64;          // input channels of a block
constexpr int DW_CO = 64;          // output channels of a block
constexpr int DW_THREADS = 384;    // 3 (ky) x 2 (ci) x 2 (co) warps
constexpr int DW_MAX_PX = 256;     // pixels of a tile: its K rows
constexpr int DW_MAX_STAGED = 400; // pixels of the tile plus its halo
constexpr int DW_X_SLOT = round_up(DW_MAX_STAGED * DW_CI * 2, kAlign);
constexpr int DW_D_SLOT = DW_MAX_PX * DW_CO * 2;
constexpr int DW_VEC = 5 * 64 * 4;  // a, c, alpha, beta, gamma of the block's channels
constexpr size_t DW_SMEM = kAlign + 2 * DW_X_SLOT + 3 * DW_D_SLOT + DW_VEC + 3 * 8;
static_assert(DW_D_SLOT % kAlign == 0, "slots keep the swizzle's 1024-byte alignment");

// Grid: (ci blocks * co blocks, splits). Block (b, s) adds tiles s *
// tiles_per_split ... of the N * tiles_h * tiles_w tiles (image-major) into
// out[s][tap][ci][co] (fp32 [splits][9][cin][cout]).
// tmx: x (dims cin, W, H, N), box (64, tw + 2, th + 2, 1); tmg, tmz: g and z
// (dims cout, W, H, N), box (64, tw, th, 1).
template <bool kPro>
__global__ void __launch_bounds__(DW_THREADS, 1)
    tc_dw_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmg,
                 const __grid_constant__ CUtensorMap tmz, const float* __restrict__ a,
                 const float* __restrict__ c, const float* __restrict__ coef,
                 float* __restrict__ out, int H, int W, int cin, int cout, int th, int tw,
                 int tiles_w, int tiles_per_img, int total_tiles, int tiles_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* x_s = smem;                    // 2 x slots
  unsigned char* d_s = x_s + 2 * DW_X_SLOT;     // 2 g slots, rewritten as dz
  unsigned char* z_s = d_s + 2 * DW_D_SLOT;     // 1 z slot
  float* vec_s = reinterpret_cast<float*>(z_s + DW_D_SLOT);  // [5][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(vec_s + 5 * 64);  // x + g of slot 0, 1; z

  const int ci_blocks = (cin + DW_CI - 1) / DW_CI;
  const int ci0 = (blockIdx.x % ci_blocks) * DW_CI;
  const int co0 = (blockIdx.x / ci_blocks) * DW_CO;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int ntiles = min(total_tiles, t_begin + tiles_per_split) - t_begin;
  const int px = th * tw;
  const int ksteps = (px + 15) / 16;
  const int sw = tw + 2;
  const int staged = (th + 2) * sw;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp % 2;
  const int wn = (warp / 2) % 2;
  const int ky = warp / 4;

  auto tile_of = [&](int i) {
    const int tt = t_begin + i;
    const int n = tt / tiles_per_img;
    const int r = tt - n * tiles_per_img;
    return Tile{n, (r / tiles_w) * th, (r % tiles_w) * tw, th, tw, H, W};
  };
  // Thread 0 issues the boxes of tile i: x and g into slot i % 2, z alone.
  auto issue_xg = [&](int i) {
    const Tile t = tile_of(i);
    uint64_t* b = bar + (i & 1);
    fence_proxy_async();
    mbar_expect_tx(b, (uint32_t)((staged + px) * DW_CI * 2));
    tma_load_4d(x_s + (i & 1) * DW_X_SLOT, &tmx, b, ci0, t.w0 - 1, t.h0 - 1, t.n);
    tma_load_4d(d_s + (i & 1) * DW_D_SLOT, &tmg, b, co0, t.w0, t.h0, t.n);
  };
  auto issue_z = [&](int i) {
    const Tile t = tile_of(i);
    fence_proxy_async();
    mbar_expect_tx(bar + 2, (uint32_t)(px * DW_CO * 2));
    tma_load_4d(z_s, &tmz, bar + 2, co0, t.w0, t.h0, t.n);
  };

  // dz rows px ... 16 * ksteps - 1 of both g slots: zero, never loaded.
  const int pad = (16 * ksteps - px) * 8;  // 16-byte chunks a slot
  for (int i = threadIdx.x; i < 2 * pad; i += DW_THREADS)
    reinterpret_cast<uint4*>(d_s + (i / pad) * DW_D_SLOT + px * 128)[i % pad] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  // The block's per-channel vectors, zero past cin / cout: a, c (prologue),
  // then alpha, beta, gamma (dz).
  for (int i = threadIdx.x; i < 5 * 64; i += DW_THREADS) {
    const int v = i / 64, k = i % 64;
    const int ci = ci0 + k, co = co0 + k;
    float val = 0.f;
    if (v < 2) {
      if (kPro && ci < cin) val = (v == 0 ? a : c)[ci];
    } else if (co < cout) {
      val = coef[(v - 2) * cout + co];
    }
    vec_s[i] = val;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && ntiles > 0) {
    issue_xg(0);
    issue_z(0);
    if (ntiles > 1) issue_xg(1);
  }

  // The rewrites: a thread keeps one 16-byte chunk (8 channels) of a pixel.
  const int ch = threadIdx.x % 8;
  const bool x_ch = ci0 + ch * 8 < cin;
  const bool d_ch = co0 + ch * 8 < cout;

  // ldmatrix lanes. A (x, trans): matrix lane / 8 holds ci half (lane / 8) % 2
  // and k half lane / 16; the lane's row is pixel (lane / 16) * 8 + lane % 8
  // of the k16 step. B (dz, trans): k half (lane / 8) % 2, co half lane / 16.
  const int a_row = (lane / 16) * 8 + lane % 8;
  const int a_chunk = wm * 4 + (lane / 8) % 2;  // + 2 * mi
  const int b_row = ((lane / 8) % 2) * 8 + lane % 8;
  const int b_chunk = wn * 4 + lane / 16;       // + 2 * j

  float acc[3][2][4][4];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[kx][mi][ni][e] = 0.f;

#pragma unroll 1
  for (int i = 0; i < ntiles; ++i) {
    const Tile t = tile_of(i);
    unsigned char* xs = x_s + (i & 1) * DW_X_SLOT;
    unsigned char* ds = d_s + (i & 1) * DW_D_SLOT;
    mbar_wait(bar + (i & 1), (i >> 1) & 1);
    mbar_wait(bar + 2, i & 1);
    if (kPro && x_ch) {
      // Most tiles' halo lies in the image: they skip the per-pixel test.
      const bool inside = t.h0 >= 1 && t.h0 + th < H && t.w0 >= 1 && t.w0 + tw < W;
      float av[8], cv[8];
      load8(av, vec_s + ch * 8);
      load8(cv, vec_s + 64 + ch * 8);
      for (int q = threadIdx.x / 8; q < staged; q += DW_THREADS / 8) {
        if (!inside && !t.staged_in_image(q)) continue;
        pro_chunk(reinterpret_cast<uint4*>(xs + w_off(q, ch)), av, cv);
      }
    }
    if (d_ch) {
      const bool inside = t.h0 + th <= H && t.w0 + tw <= W;
      float al[8], be[8], ga[8];
      load8(al, vec_s + 128 + ch * 8);
      load8(be, vec_s + 192 + ch * 8);
      load8(ga, vec_s + 256 + ch * 8);
      for (int p = threadIdx.x / 8; p < px; p += DW_THREADS / 8) {
        if (!inside && (t.h0 + p / tw >= H || t.w0 + p % tw >= W)) continue;
        dz_chunk(reinterpret_cast<uint4*>(ds + w_off(p, ch)),
                 reinterpret_cast<const uint4*>(z_s + w_off(p, ch)), al, be, ga);
      }
    }
    fence_proxy_async();  // the slots are TMA-written again
    __syncthreads();
    if (threadIdx.x == 0 && i + 1 < ntiles) issue_z(i + 1);

    const uint32_t xa = smem_addr(xs);
    const uint32_t da = smem_addr(ds);
#pragma unroll 1
    for (int ks = 0; ks < ksteps; ++ks) {
      // The pixel of this lane's A row; rows past the tile read pixel 0
      // against dz rows of zeros.
      const int p = ks * 16 + a_row;
      const int q = (p < px ? (p / tw) * sw + p % tw : 0) + ky * sw;
      uint32_t bfr[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) ldmatrix_x4_trans(bfr[j], da + w_off(ks * 16 + b_row, b_chunk + 2 * j));
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) ldmatrix_x4_trans(af[mi], xa + w_off(q + kx, a_chunk + 2 * mi));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(acc[kx][mi][ni], af[mi], bfr[ni / 2][(ni % 2) * 2], bfr[ni / 2][(ni % 2) * 2 + 1]);
      }
    }
    __syncthreads();  // slot i % 2 is read
    if (threadIdx.x == 0 && i + 2 < ntiles) issue_xg(i + 2);
  }

  // Lane holds ci = ci0 + wm*32 + mi*16 + lane/4 (+8), co = co0 + wn*32 +
  // ni*8 + (lane%4)*2 (+1): whole 32-byte sectors per quad.
  float* dst = out + (size_t)blockIdx.y * 9 * cin * cout;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int ci = ci0 + wm * 32 + mi * 16 + lane / 4 + hf * 8;
        if (ci >= cin) continue;
        float* row = dst + ((size_t)(ky * 3 + kx) * cin + ci) * cout;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int co = co0 + wn * 32 + ni * 8 + (lane % 4) * 2;
          if (co < cout)
            *reinterpret_cast<float2*>(row + co) =
                make_float2(acc[kx][mi][ni][hf * 2], acc[kx][mi][ni][hf * 2 + 1]);
        }
      }
}

// ---- fp32 dw in 3xTF32 --------------------------------------------------------
//
// The same GEMM (M = ci, N = co, K = pixels; a block owns 64 x 64 channels
// and all 9 taps, 12 warps of 32 ci x 32 co x the 3 taps of one kernel row)
// on m16n8k8 TF32 fragments. K is the strided axis of both staged operands
// (pixel-major, channels contiguous), and ldmatrix has no 32-bit transpose,
// so the rewrite pass that builds pro(x) and dz on the CUDA cores also
// writes them K-contiguous: xT[ci][staged pixel] and dzT[co][pixel], with
// row strides of 4 mod 32 words, so that a fragment's 8 rows x 4 pixels
// fall in 32 distinct banks whatever the tap's shift along K. A comes from
// xT by 32-bit loads (the tap's shift breaks 16-byte alignment), B from dzT
// by ldmatrix; both are split into TF32 hi and lo in registers (B once per
// k8 step for the warp's 3 taps) and summed as lo*hi + hi*lo + hi*hi
// (mma_3xtf32).
// The raw TMA boxes (x over the tile plus halo, g and z over the tile; each
// two 32-channel halves of 128-byte rows, 128-byte swizzle: w_off) sit in
// one slot each: the next
// tile's are issued as soon as this tile's rewrite has read them, and land
// during its MMAs. Fewer pixels a tile than bf16 (fp32 and the transposed
// copies): DWF_MAX_PX = 128 and DWF_MAX_STAGED = 200 fill 211 KB of the
// 227 KB a block may use, one block an SM.
constexpr int DWF_CI = 64;           // input channels of a block
constexpr int DWF_CO = 64;           // output channels of a block
constexpr int DWF_THREADS = 384;     // 3 (ky) x 2 (ci) x 2 (co) warps
constexpr int DWF_MAX_PX = 128;      // pixels of a tile: its K rows
constexpr int DWF_MAX_STAGED = 200;  // pixels of the tile plus its halo
constexpr int DWF_XROW = 228;        // xT row stride in floats: >= DWF_MAX_STAGED, 4 mod 32
constexpr int DWF_DROW = 132;        // dzT row stride in floats: >= DWF_MAX_PX, 4 mod 32
constexpr int DWF_X_HALF = round_up(DWF_MAX_STAGED * 128, kAlign);  // 32 fp32 a staged pixel
constexpr int DWF_D_HALF = DWF_MAX_PX * 128;
constexpr size_t DWF_SMEM = kAlign + 2 * DWF_X_HALF + 4 * DWF_D_HALF + DWF_CI * DWF_XROW * 4 +
                            DWF_CO * DWF_DROW * 4 + 5 * 64 * 4 + DWF_MAX_PX * 4 + 8;
static_assert(DWF_D_HALF % kAlign == 0, "halves keep the swizzle's 1024-byte alignment");
static_assert(DWF_XROW % 32 == 4 && DWF_DROW % 32 == 4, "conflict-free fragment rows");
static_assert(DWF_SMEM <= 232448, "one block's shared memory on the H100");

// Grid, out and tile walk as tc_dw_kernel's. tmx: fp32 x (dims cin, W, H, N),
// box (32, tw + 2, th + 2, 1); tmg, tmz: fp32 g and z (dims cout, W, H, N),
// box (32, tw, th, 1).
template <bool kPro>
__global__ void __launch_bounds__(DWF_THREADS, 1)
    tc_dw_f32_kernel(const __grid_constant__ CUtensorMap tmx,
                     const __grid_constant__ CUtensorMap tmg,
                     const __grid_constant__ CUtensorMap tmz, const float* __restrict__ a,
                     const float* __restrict__ c, const float* __restrict__ coef,
                     float* __restrict__ out, int H, int W, int cin, int cout, int th, int tw,
                     int tiles_w, int tiles_per_img, int total_tiles, int tiles_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* x_r = smem;                        // raw x, two 32-channel halves
  unsigned char* g_r = x_r + 2 * DWF_X_HALF;        // raw g, two halves
  unsigned char* z_r = g_r + 2 * DWF_D_HALF;        // raw z, two halves
  float* xT = reinterpret_cast<float*>(z_r + 2 * DWF_D_HALF);  // [DWF_CI][DWF_XROW]
  float* dzT = xT + DWF_CI * DWF_XROW;                          // [DWF_CO][DWF_DROW]
  float* vec_s = dzT + DWF_CO * DWF_DROW;                       // [5][64]
  int* q_of = reinterpret_cast<int*>(vec_s + 5 * 64);  // [DWF_MAX_PX]: staged pixel of p
  uint64_t* bar = reinterpret_cast<uint64_t*>(q_of + DWF_MAX_PX);

  const int ci_blocks = (cin + DWF_CI - 1) / DWF_CI;
  const int ci0 = (blockIdx.x % ci_blocks) * DWF_CI;
  const int co0 = (blockIdx.x / ci_blocks) * DWF_CO;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int ntiles = min(total_tiles, t_begin + tiles_per_split) - t_begin;
  const int px = th * tw;
  const int ksteps = (px + 7) / 8;
  const int sw = tw + 2;
  const int staged = (th + 2) * sw;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp % 2;
  const int wn = (warp / 2) % 2;
  const int ky = warp / 4;
  // Halves past cin / cout are not loaded; their channels are written as 0.
  const int x_halves = min(2, (cin - ci0 + 31) / 32);
  const int d_halves = min(2, (cout - co0 + 31) / 32);

  auto tile_of = [&](int i) {
    const int tt = t_begin + i;
    const int n = tt / tiles_per_img;
    const int r = tt - n * tiles_per_img;
    return Tile{n, (r / tiles_w) * th, (r % tiles_w) * tw, th, tw, H, W};
  };
  // Thread 0 issues the raw boxes of tile i.
  auto issue = [&](int i) {
    const Tile t = tile_of(i);
    fence_proxy_async();
    mbar_expect_tx(bar, (uint32_t)(x_halves * staged * 128 + 2 * d_halves * px * 128));
    for (int hh = 0; hh < x_halves; ++hh)
      tma_load_4d(x_r + hh * DWF_X_HALF, &tmx, bar, ci0 + 32 * hh, t.w0 - 1, t.h0 - 1, t.n);
    for (int hh = 0; hh < d_halves; ++hh) {
      tma_load_4d(g_r + hh * DWF_D_HALF, &tmg, bar, co0 + 32 * hh, t.w0, t.h0, t.n);
      tma_load_4d(z_r + hh * DWF_D_HALF, &tmz, bar, co0 + 32 * hh, t.w0, t.h0, t.n);
    }
  };

  // dzT columns px ... 8 * ksteps - 1: zero, never written.
  const int pad = 8 * ksteps - px;
  for (int i = threadIdx.x; i < DWF_CO * pad; i += DWF_THREADS)
    dzT[(i / pad) * DWF_DROW + px + i % pad] = 0.f;
  // The staged pixel (tap (0, 0)) of each of a tile's K rows; rows past the
  // tile read pixel 0 against dz columns of zeros.
  for (int p = threadIdx.x; p < 8 * ksteps; p += DWF_THREADS)
    q_of[p] = p < px ? (p / tw) * sw + p % tw : 0;
  for (int i = threadIdx.x; i < 5 * 64; i += DWF_THREADS) {
    const int v = i / 64, k = i % 64;
    const int ci = ci0 + k, co = co0 + k;
    float val = 0.f;
    if (v < 2) {
      if (kPro && ci < cin) val = (v == 0 ? a : c)[ci];
    } else if (co < cout) {
      val = coef[(v - 2) * cout + co];
    }
    vec_s[i] = val;
  }
  if (threadIdx.x == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && ntiles > 0) issue(0);

  // Fragment lanes: A (xT) rows ci = wm*32 + mi*16 + lane/4 (+8), pixels
  // lane%4 (+4) of the k8 step; B (dzT, ldmatrix.x4 of n16 group j) rows co
  // = wn*32 + 16 j + (lane/16)*8 + lane%8, pixels ((lane/8)%2)*4.
  const int a_row = wm * 32 + lane / 4;
  const int b_row = wn * 32 + (lane / 16) * 8 + lane % 8;
  const int b_col = ((lane / 8) % 2) * 4;
  // m16 fragments of ci past cin hold zeros: their MMAs are skipped (warp-
  // uniform; at inc.conv1, Cin = 3 padded to 8, 7 of the 8 are).
  const int live_mi = max(0, min(2, (cin - ci0 - wm * 32 + 15) / 16));

  float acc[3][2][4][4];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[kx][mi][ni][e] = 0.f;

#pragma unroll 1
  for (int i = 0; i < ntiles; ++i) {
    const Tile t = tile_of(i);
    mbar_wait(bar, i & 1);
    // x: piece c4 (channels 4 c4 ...) of staged pixel q, consecutive threads
    // on consecutive pixels (conflict-free swizzled reads, xT row writes).
    {
      const bool inside = t.h0 >= 1 && t.h0 + th < H && t.w0 >= 1 && t.w0 + tw < W;
      for (int idx = threadIdx.x; idx < 16 * staged; idx += DWF_THREADS) {
        const int c4 = idx / staged;
        const int q = idx - c4 * staged;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ci0 + c4 * 4 < cin) {
          v = *reinterpret_cast<const float4*>(x_r + (c4 / 8) * DWF_X_HALF + w_off(q, c4 % 8));
          if (kPro && (inside || t.staged_in_image(q))) {
            const float4 av = *reinterpret_cast<const float4*>(vec_s + c4 * 4);
            const float4 cv = *reinterpret_cast<const float4*>(vec_s + 64 + c4 * 4);
            pro_chunk_f32(&v, av, cv);
          }
        }
        float* col = xT + (c4 * 4) * DWF_XROW + q;
        col[0] = v.x;
        col[DWF_XROW] = v.y;
        col[2 * DWF_XROW] = v.z;
        col[3 * DWF_XROW] = v.w;
      }
    }
    // dz = alpha*g + beta*z + gamma over the tile's in-image pixels.
    {
      const bool inside = t.h0 + th <= H && t.w0 + tw <= W;
      for (int idx = threadIdx.x; idx < 16 * px; idx += DWF_THREADS) {
        const int c4 = idx / px;
        const int p = idx - c4 * px;
        float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
        if (co0 + c4 * 4 < cout && (inside || (t.h0 + p / tw < H && t.w0 + p % tw < W))) {
          const int off = (c4 / 8) * DWF_D_HALF + w_off(p, c4 % 8);
          const float4 g = *reinterpret_cast<const float4*>(g_r + off);
          const float4 z = *reinterpret_cast<const float4*>(z_r + off);
          const float* al = vec_s + 128 + c4 * 4;
          const float* be = vec_s + 192 + c4 * 4;
          const float* ga = vec_s + 256 + c4 * 4;
          d.x = __fadd_rn(__fadd_rn(__fmul_rn(al[0], g.x), __fmul_rn(be[0], z.x)), ga[0]);
          d.y = __fadd_rn(__fadd_rn(__fmul_rn(al[1], g.y), __fmul_rn(be[1], z.y)), ga[1]);
          d.z = __fadd_rn(__fadd_rn(__fmul_rn(al[2], g.z), __fmul_rn(be[2], z.z)), ga[2]);
          d.w = __fadd_rn(__fadd_rn(__fmul_rn(al[3], g.w), __fmul_rn(be[3], z.w)), ga[3]);
        }
        float* col = dzT + (c4 * 4) * DWF_DROW + p;
        col[0] = d.x;
        col[DWF_DROW] = d.y;
        col[2 * DWF_DROW] = d.z;
        col[3 * DWF_DROW] = d.w;
      }
    }
    fence_proxy_async();  // the raw slots are TMA-written again
    __syncthreads();
    if (threadIdx.x == 0 && i + 1 < ntiles) issue(i + 1);

    const uint32_t da = smem_addr(dzT);
#pragma unroll 1
    for (int ks = 0; ks < (live_mi > 0 ? ksteps : 0); ++ks) {
      // This lane's two pixels of the step, in the staged tile.
      const int qa = q_of[ks * 8 + lane % 4] + ky * sw;
      const int qb = q_of[ks * 8 + lane % 4 + 4] + ky * sw;
      uint32_t bh[2][4], bl[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t br[4];
        ldmatrix_x4(br, da + ((b_row + 16 * j) * DWF_DROW + ks * 8 + b_col) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(br[e], bh[j][e], bl[j][e]);
      }
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (mi >= live_mi) continue;
          const float* r0 = xT + (a_row + mi * 16) * DWF_XROW + kx;
          const float* r1 = r0 + 8 * DWF_XROW;
          uint32_t ah[4], al[4];
          split_tf32(__float_as_uint(r0[qa]), ah[0], al[0]);
          split_tf32(__float_as_uint(r1[qa]), ah[1], al[1]);
          split_tf32(__float_as_uint(r0[qb]), ah[2], al[2]);
          split_tf32(__float_as_uint(r1[qb]), ah[3], al[3]);
          mma_3xtf32<4>(acc[kx][mi], ah, al, reinterpret_cast<const uint32_t(*)[2]>(bh),
                        reinterpret_cast<const uint32_t(*)[2]>(bl));
        }
    }
    __syncthreads();  // xT and dzT are read
  }

  // Lane holds ci = ci0 + wm*32 + mi*16 + lane/4 (+8), co = co0 + wn*32 +
  // ni*8 + (lane%4)*2 (+1), as tc_dw_kernel's.
  float* dst = out + (size_t)blockIdx.y * 9 * cin * cout;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int ci = ci0 + wm * 32 + mi * 16 + lane / 4 + hf * 8;
        if (ci >= cin) continue;
        float* row = dst + ((size_t)(ky * 3 + kx) * cin + ci) * cout;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int co = co0 + wn * 32 + ni * 8 + (lane % 4) * 2;
          if (co < cout)
            *reinterpret_cast<float2*>(row + co) =
                make_float2(acc[kx][mi][ni][hf * 2], acc[kx][mi][ni][hf * 2 + 1]);
        }
      }
}

// out[2][9][cout][cin] = the TF32 high part (plane 0) and the TF32 rounding
// of the rest (plane 1) of fp32 HWIO w [9][cin][cout], transposed so that K
// (cin) is contiguous: the fp32 forward's B operand, loaded by ldmatrix.
// Block (co / 32, ci / 32, tap): a 32 x 32 tile through shared memory.
__global__ void __launch_bounds__(256)
    split_weights_kernel(const float* __restrict__ w, float* __restrict__ out, int cin, int cout) {
  __shared__ float tile[32][33];
  const int tap = blockIdx.z;
  const int co0 = blockIdx.x * 32, ci0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int ci = ci0 + r, co = co0 + threadIdx.x;
    tile[r][threadIdx.x] = ci < cin && co < cout ? w[((size_t)tap * cin + ci) * cout + co] : 0.f;
  }
  __syncthreads();
  const size_t plane = 9 * (size_t)cin * cout;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int co = co0 + r, ci = ci0 + threadIdx.x;
    if (co < cout && ci < cin) {
      uint32_t hi, lo;
      split_tf32(__float_as_uint(tile[threadIdx.x][r]), hi, lo);
      const size_t o = ((size_t)tap * cout + co) * cin + ci;
      out[o] = __uint_as_float(hi);
      out[plane + o] = __uint_as_float(lo);
    }
  }
}

// out[2][9][cout][k] = the TF32 hi and lo planes of w[8 - tap] for plane row
// tap: fp32 dx's B operand (cout = the forward's Cin, k = its Cout). The
// forward weights [9][cin][cout] with the taps reversed are already
// K-contiguous, so this is an elementwise pass: no transpose, no flipped copy.
// Thread i splits 4 consecutive values (cout * k % 4 == 0: a quad stays in
// its tap).
__global__ void __launch_bounds__(256)
    split_dx_weights_kernel(const float4* __restrict__ w, uint4* __restrict__ out, int tap_quads) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= 9 * tap_quads) return;
  const int tap = i / tap_quads;
  const float4 v = w[(8 - tap) * tap_quads + (i - tap * tap_quads)];
  uint4 hi, lo;
  split_tf32(__float_as_uint(v.x), hi.x, lo.x);
  split_tf32(__float_as_uint(v.y), hi.y, lo.y);
  split_tf32(__float_as_uint(v.z), hi.z, lo.z);
  split_tf32(__float_as_uint(v.w), hi.w, lo.w);
  out[i] = hi;
  out[9 * tap_quads + i] = lo;
}

// ---- host side --------------------------------------------------------------

cudaError_t split_weights(const float* w, float* out, int cin, int cout, cudaStream_t stream) {
  split_weights_kernel<<<dim3((cout + 31) / 32, (cin + 31) / 32, 9), dim3(32, 8), 0, stream>>>(
      w, out, cin, cout);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 (or, with f32, fp32) tensor map of `rank` dims (innermost first)
// with zero fill outside.
cudaError_t make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides_bytes, const cuuint32_t* box,
                     CUtensorMapSwizzle swizzle, bool f32) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                            const_cast<void*>(base), dims, strides_bytes, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 4-D map over an NHWC bf16 (or fp32) tensor (dims c, W, H, N) with box
// (bc, bw, bh, 1).
cudaError_t make_nhwc_map(CUtensorMap* map, const void* base, int n, int h, int wd, int c, int bc,
                          int bw, int bh, CUtensorMapSwizzle swizzle, bool f32) {
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * es, (cuuint64_t)wd * c * es,
                                 (cuuint64_t)h * wd * c * es};
  const cuuint32_t box[4] = {(cuuint32_t)bc, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  return make_map(map, base, 4, dims, strides, box, swizzle, f32);
}

// The shared-memory opt-in of `kernel`, once per device (`done` is the
// kernel's own flags): a CUDA API call on every launch would add to the host
// time before it.
cudaError_t opt_in_smem(const void* kernel, size_t bytes, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return err;
}

// The input: x with ca == cin, or with Load::kConcat the concat of x (ca
// channels) and b (cin - ca channels). aux: the loader's second input (z,
// with kAux), the shape of x. With C::Op = Tf32x3Op, x is fp32 and w the
// split weights [2][9][cout][cin] (split_weights_kernel).
template <class C, class Load, class Epi, bool kStats, bool kF32Out>
cudaError_t launch(const void* x, const void* b, int ca, const void* aux, const void* w,
                   const Load& ld, const Epi& epi, void* out, float* partials, int n, int h,
                   int wd, int cin, int cout, int th, int tw, cudaStream_t stream) {
  if (cin % 8 != 0 || ca % 8 != 0 || ca < 1 ||
      (Load::kConcat ? ca >= cin || b == nullptr : ca != cin) || cout % 8 != 0 || th < 1 ||
      tw < 1 || th * tw > C::BM ||
      (th + 2) * (tw + 2) > C::MAX_STAGED || th + 2 > 256 || tw + 2 > 256 ||
      (Load::kAux && aux == nullptr))
    return cudaErrorInvalidValue;
  constexpr bool kF32 = C::Op::kTf32;
  CUtensorMap tmx, tmb, tmz, tmw;
  cudaError_t err = make_nhwc_map(&tmx, x, n, h, wd, ca, C::Op::KC, tw + 2, th + 2,
                                  CU_TENSOR_MAP_SWIZZLE_64B, kF32);
  if (err != cudaSuccess) return err;
  tmb = tmz = tmx;  // unused copies, unless encoded below
  if (Load::kConcat) {
    err = make_nhwc_map(&tmb, b, n, h, wd, cin - ca, C::Op::KC, tw + 2, th + 2,
                        CU_TENSOR_MAP_SWIZZLE_64B, kF32);
    if (err != cudaSuccess) return err;
  }
  if (Load::kAux) {
    err = make_nhwc_map(&tmz, aux, n, h, wd, cin, C::Op::KC, tw + 2, th + 2,
                        CU_TENSOR_MAP_SWIZZLE_64B, kF32);
    if (err != cudaSuccess) return err;
  }
  if constexpr (kF32) {
    const cuuint64_t wdims[4] = {(cuuint64_t)cin, (cuuint64_t)cout, 9, 2};
    const cuuint64_t wstrides[3] = {(cuuint64_t)cin * 4, (cuuint64_t)cout * cin * 4,
                                    9ull * cout * cin * 4};
    const cuuint32_t wbox[4] = {(cuuint32_t)KC_F32, (cuuint32_t)C::BN, 1, 2};
    err = make_map(&tmw, w, 4, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_64B, true);
  } else {
    const cuuint64_t wdims[3] = {(cuuint64_t)cout, (cuuint64_t)cin, 9};
    const cuuint64_t wstrides[2] = {(cuuint64_t)cout * 2, (cuuint64_t)cin * cout * 2};
    const cuuint32_t wbox[3] = {64, (cuuint32_t)KC, 1};
    err = make_map(&tmw, w, 3, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != cudaSuccess) return err;
  auto kernel = tc_conv_kernel<C, Load, Epi, kStats, kF32Out>;
  constexpr size_t smem = smem_bytes<C, Load>();
  static std::atomic<bool> opted_in[kMaxDevices];
  err = opt_in_smem(reinterpret_cast<const void*>(kernel), smem, opted_in);
  if (err != cudaSuccess) return err;
  const int tiles_w = (wd + tw - 1) / tw;
  const int tiles_h = (h + th - 1) / th;
  const dim3 grid(tiles_w * tiles_h, (cout + C::BN - 1) / C::BN, n);
  kernel<<<grid, C::THREADS, smem, stream>>>(tmx, tmb, tmz, tmw, ld, epi, out, partials, h, wd,
                                             ca, cin, cout, th, tw, tiles_w);
  return cudaGetLastError();
}

template <class Load, class Epi, bool kStats, bool kF32Out = false>
cudaError_t launch_cfg(int cfg, const void* x, const void* b, int ca, const void* aux,
                       const void* w, const Load& ld, const Epi& epi, void* out, float* partials,
                       int n, int h, int wd, int cin, int cout, int th, int tw,
                       cudaStream_t stream) {
#define TUK_TC_CASE(ID)                                                                     \
  case ID:                                                                                  \
    return launch<Cfg##ID, Load, Epi, kStats, kF32Out>(x, b, ca, aux, w, ld, epi, out,     \
                                                        partials, n, h, wd, cin, cout, th, \
                                                        tw, stream);
  switch (cfg) {
    TUK_TC_CASE(0)
    TUK_TC_CASE(1)
  }
#undef TUK_TC_CASE
  return cudaErrorInvalidValue;
}

// An fp32 (3xTF32) conv: split the weights w into wsplit (fp32 [2][9][cout]
// [cin] scratch), then the conv of configuration cfg (F32DxCfg* for a
// loader with an aux slot). The forward and the concat conv split HWIO w
// [9][cin][cout] (split_weights_kernel); dx (Load::kAux) splits the forward
// weights [9][cout][cin] with the taps reversed (split_dx_weights_kernel).
// out: fp32, or bf16 without kF32Out (im2col's out_dtype).
template <class Load, class Epi, bool kStats, bool kF32Out = true>
cudaError_t launch_f32(int cfg, const float* x, const float* b, int ca, const float* aux,
                       const float* w, float* wsplit, const Load& ld, const Epi& epi, void* out,
                       float* partials, int n, int h, int wd, int cin, int cout, int th, int tw,
                       cudaStream_t stream) {
  if (cin % 8 != 0 || cout % 8 != 0) return cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (Load::kAux) {
    const int tap_quads = cout * cin / 4;
    split_dx_weights_kernel<<<(9 * tap_quads + 255) / 256, 256, 0, stream>>>(
        reinterpret_cast<const float4*>(w), reinterpret_cast<uint4*>(wsplit), tap_quads);
    err = cudaGetLastError();
  } else {
    err = split_weights(w, wsplit, cin, cout, stream);
  }
  if (err != cudaSuccess) return err;
#define TUK_F32_CASE(ID)                                                                  \
  case ID:                                                                                \
    return launch<std::conditional_t<Load::kAux, F32DxCfg##ID, F32Cfg##ID>, Load, Epi,    \
                  kStats, kF32Out>(x, b, ca, aux, wsplit, ld, epi, out, partials, n, h, wd,   \
                                   cin, cout, th, tw, stream);
  switch (cfg) {
    TUK_F32_CASE(0)
    TUK_F32_CASE(1)
  }
#undef TUK_F32_CASE
  return cudaErrorInvalidValue;
}

template <bool kPro>
cudaError_t launch_dw(const void* x, const float* a, const float* c, const void* g, const void* z,
                      const float* coef, float* out, int n, int h, int wd, int cin, int cout,
                      int th, int tw, int tiles_per_split, int splits, cudaStream_t stream) {
  if (cin % 8 != 0 || cout % 8 != 0 || th < 1 || tw < 1 || th * tw > DW_MAX_PX ||
      (th + 2) * (tw + 2) > DW_MAX_STAGED || tiles_per_split < 1 || splits < 1)
    return cudaErrorInvalidValue;
  CUtensorMap tmx, tmg, tmz;
  cudaError_t err =
      make_nhwc_map(&tmx, x, n, h, wd, cin, DW_CI, tw + 2, th + 2, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = make_nhwc_map(&tmg, g, n, h, wd, cout, DW_CO, tw, th, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = make_nhwc_map(&tmz, z, n, h, wd, cout, DW_CO, tw, th, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  auto kernel = tc_dw_kernel<kPro>;
  static std::atomic<bool> opted_in[kMaxDevices];
  err = opt_in_smem(reinterpret_cast<const void*>(kernel), DW_SMEM, opted_in);
  if (err != cudaSuccess) return err;
  const int tiles_w = (wd + tw - 1) / tw;
  const int tiles_per_img = ((h + th - 1) / th) * tiles_w;
  const int blocks = ((cin + DW_CI - 1) / DW_CI) * ((cout + DW_CO - 1) / DW_CO);
  kernel<<<dim3(blocks, splits), DW_THREADS, DW_SMEM, stream>>>(
      tmx, tmg, tmz, a, c, coef, out, h, wd, cin, cout, th, tw, tiles_w, tiles_per_img,
      n * tiles_per_img, tiles_per_split);
  return cudaGetLastError();
}

template <bool kPro>
cudaError_t launch_dw_f32(const void* x, const float* a, const float* c, const void* g,
                          const void* z, const float* coef, float* out, int n, int h, int wd,
                          int cin, int cout, int th, int tw, int tiles_per_split, int splits,
                          cudaStream_t stream) {
  if (cin % 8 != 0 || cout % 8 != 0 || th < 1 || tw < 1 || th * tw > DWF_MAX_PX ||
      (th + 2) * (tw + 2) > DWF_MAX_STAGED || tiles_per_split < 1 || splits < 1)
    return cudaErrorInvalidValue;
  CUtensorMap tmx, tmg, tmz;
  cudaError_t err = make_nhwc_map(&tmx, x, n, h, wd, cin, 32, tw + 2, th + 2,
                                  CU_TENSOR_MAP_SWIZZLE_128B, true);
  if (err != cudaSuccess) return err;
  err = make_nhwc_map(&tmg, g, n, h, wd, cout, 32, tw, th, CU_TENSOR_MAP_SWIZZLE_128B, true);
  if (err != cudaSuccess) return err;
  err = make_nhwc_map(&tmz, z, n, h, wd, cout, 32, tw, th, CU_TENSOR_MAP_SWIZZLE_128B, true);
  if (err != cudaSuccess) return err;
  auto kernel = tc_dw_f32_kernel<kPro>;
  static std::atomic<bool> opted_in[kMaxDevices];
  err = opt_in_smem(reinterpret_cast<const void*>(kernel), DWF_SMEM, opted_in);
  if (err != cudaSuccess) return err;
  const int tiles_w = (wd + tw - 1) / tw;
  const int tiles_per_img = ((h + th - 1) / th) * tiles_w;
  const int blocks = ((cin + DWF_CI - 1) / DWF_CI) * ((cout + DWF_CO - 1) / DWF_CO);
  kernel<<<dim3(blocks, splits), DWF_THREADS, DWF_SMEM, stream>>>(
      tmx, tmg, tmz, a, c, coef, out, h, wd, cin, cout, th, tw, tiles_w, tiles_per_img,
      n * tiles_per_img, tiles_per_split);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace tuk

// y[N,H,W,cout] = [relu](conv3x3_same(x, w) * scale + bias), bf16 in and out.
// x: [N,H,W,cin], w: [3,3,cin,cout] HWIO, scale/bias: fp32 [cout]; cin and
// cout multiples of 8, pointers 16-byte aligned. (cfg, th, tw): the tile plan
// (kernels/tc_conv.py tc_plan). Returns cudaGetLastError() after the launch.
extern "C" int tuk_tc_fused_conv3x3(const void* x, const void* w, const float* scale,
                                    const float* bias, void* out, int n, int h, int wd, int cin,
                                    int cout, int relu, int cfg, int th, int tw, void* stream) {
  if (n == 0 || h == 0 || wd == 0 || cout == 0) return 0;
  using namespace tuk::tc;
  return (int)launch_cfg<RawLoad, AffineEpi, false>(
      cfg, x, nullptr, cin, nullptr, w, RawLoad{}, AffineEpi{scale, bias, relu}, out, nullptr, n,
      h, wd, cin, cout, th, tw, static_cast<cudaStream_t>(stream));
}

// y = [relu](conv3x3_same(concat([a, b], -1), w) * scale + bias), bf16 in
// and out, the concat never built. a: [N,H,W,ca] (the skip), b: [N,H,W,cb]
// (the upsampled tensor), w: [3,3,ca+cb,cout]; ca, cb, cout multiples of 8.
// Otherwise as tuk_tc_fused_conv3x3.
extern "C" int tuk_tc_concat_conv3x3(const void* a, const void* b, const void* w,
                                     const float* scale, const float* bias, void* out, int n,
                                     int h, int wd, int ca, int cb, int cout, int relu, int cfg,
                                     int th, int tw, void* stream) {
  if (n == 0 || h == 0 || wd == 0 || cout == 0) return 0;
  using namespace tuk::tc;
  return (int)launch_cfg<ConcatLoad, AffineEpi, false>(
      cfg, a, b, ca, nullptr, w, ConcatLoad{}, AffineEpi{scale, bias, relu}, out, nullptr, n, h,
      wd, ca + cb, cout, th, tw, static_cast<cudaStream_t>(stream));
}

// im2col_conv3x3's function, y = [relu](conv3x3_same(x, w) * scale + bias),
// the K = 9 * cin contraction over w flattened to [9 * cin][cout] (which is
// the HWIO layout). bf16 x and w; out bf16, or fp32 when out_f32 (stored from
// the accumulators, rounded once). Otherwise as tuk_tc_fused_conv3x3.
extern "C" int tuk_tc_im2col_conv3x3(const void* x, const void* w, const float* scale,
                                     const float* bias, void* out, int n, int h, int wd, int cin,
                                     int cout, int relu, int out_f32, int cfg, int th, int tw,
                                     void* stream) {
  if (n == 0 || h == 0 || wd == 0 || cout == 0) return 0;
  using namespace tuk::tc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AffineEpi epi{scale, bias, relu};
  if (out_f32)
    return (int)launch_cfg<RawLoad, AffineEpi, false, true>(
        cfg, x, nullptr, cin, nullptr, w, RawLoad{}, epi, out, nullptr, n, h, wd, cin, cout, th,
        tw, s);
  return (int)launch_cfg<RawLoad, AffineEpi, false>(cfg, x, nullptr, cin, nullptr, w, RawLoad{},
                                                    epi, out, nullptr, n, h, wd, cin, cout, th,
                                                    tw, s);
}

// z[N,H,W,cout] = conv3x3_same(pro(x), w) in bf16, pro(x) = relu(x*a + c)
// rounded to bf16 when a is not null, else x. a/c: fp32 [cin]. With partials
// (fp32 [n * tiles][2][cout], tiles from the plan), stats (fp32 [2][cout])
// receives (sum z, sum z^2) of the rounded z (reduce_rows, one or two more
// launches; partials is scratch).
extern "C" int tuk_tc_conv3x3_fwd(const void* x, const float* a, const float* c, const void* w,
                                  void* z, float* partials, float* stats, int n, int h, int wd,
                                  int cin, int cout, int cfg, int th, int tw, void* stream) {
  if (n == 0 || h == 0 || wd == 0 || cout == 0) return 0;
  using namespace tuk::tc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a != nullptr) {
    const ProLoad ld{a, c};
    err = partials ? launch_cfg<ProLoad, RoundEpi, true>(cfg, x, nullptr, cin, nullptr, w, ld,
                                                         RoundEpi{}, z, partials, n, h, wd, cin,
                                                         cout, th, tw, s)
                   : launch_cfg<ProLoad, RoundEpi, false>(cfg, x, nullptr, cin, nullptr, w, ld,
                                                          RoundEpi{}, z, nullptr, n, h, wd, cin,
                                                          cout, th, tw, s);
  } else {
    err = partials ? launch_cfg<RawLoad, RoundEpi, true>(cfg, x, nullptr, cin, nullptr, w,
                                                         RawLoad{}, RoundEpi{}, z, partials, n,
                                                         h, wd, cin, cout, th, tw, s)
                   : launch_cfg<RawLoad, RoundEpi, false>(cfg, x, nullptr, cin, nullptr, w,
                                                          RawLoad{}, RoundEpi{}, z, nullptr, n,
                                                          h, wd, cin, cout, th, tw, s);
  }
  if (err != cudaSuccess || partials == nullptr) return (int)err;
  const int rows = n * ((h + th - 1) / th) * ((wd + tw - 1) / tw);
  return (int)tuk::reduce_rows(partials, stats, rows, 2LL * cout, s);
}

// out[N,H,W,cin] = conv3x3_same(dz, wt), dz = coef[0]*g + coef[1]*z + coef[2]
// per channel, rounded to bf16, built in shared memory and never written
// out. g, z: bf16 [N,H,W,c]; wt: bf16 [3,3,c,cin] (the forward weights
// flipped and transposed); coef: fp32 [3][c]. out: bf16, or fp32 when
// out_f32. c and cin multiples of 8; (cfg, th, tw): the tile plan of the
// output width cin (kernels/tc_conv.py tc_plan).
extern "C" int tuk_tc_conv3x3_dx(const void* g, const void* z, const float* coef, const void* wt,
                                 void* out, int n, int h, int wd, int c, int cin, int out_f32,
                                 int cfg, int th, int tw, void* stream) {
  if (n == 0 || h == 0 || wd == 0 || cin == 0) return 0;
  using namespace tuk::tc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DzLoad ld{coef};
  if (out_f32)
    return (int)launch_cfg<DzLoad, RoundEpi, false, true>(cfg, g, nullptr, c, z, wt, ld,
                                                          RoundEpi{}, out, nullptr, n, h, wd, c,
                                                          cin, th, tw, s);
  return (int)launch_cfg<DzLoad, RoundEpi, false>(cfg, g, nullptr, c, z, wt, ld, RoundEpi{}, out,
                                                  nullptr, n, h, wd, c, cin, th, tw, s);
}

// dw[3,3,cin,cout] fp32 = sum over N,H,W of pro(x)[n, y+ky-1, x+kx-1, ci] *
// dz[n, y, x, co]: pro as in tuk_tc_conv3x3_fwd (zero outside the image), dz
// as in tuk_tc_conv3x3_dx. x: bf16 [N,H,W,cin]; g, z: bf16 [N,H,W,cout];
// a/c: fp32 [cin] or null; coef: fp32 [3][cout]. (th, tw, tiles_per_split,
// splits): the plan (kernels/tc_conv.py dw_plan). With splits > 1, partials
// (fp32 [splits][9][cin][cout], scratch) receives one sum per split and
// reduce_rows adds them in a fixed order; with one split the kernel writes
// dw itself.
extern "C" int tuk_tc_conv3x3_dw(const void* x, const float* a, const float* c, const void* g,
                                 const void* z, const float* coef, float* partials, float* dw,
                                 int n, int h, int wd, int cin, int cout, int th, int tw,
                                 int tiles_per_split, int splits, void* stream) {
  if (cin == 0 || cout == 0) return 0;
  using namespace tuk::tc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0 || h == 0 || wd == 0)
    return (int)cudaMemsetAsync(dw, 0, sizeof(float) * 9 * (size_t)cin * cout, s);
  if (splits > 1 && partials == nullptr) return (int)cudaErrorInvalidValue;
  float* out = splits > 1 ? partials : dw;
  const cudaError_t err =
      a != nullptr ? launch_dw<true>(x, a, c, g, z, coef, out, n, h, wd, cin, cout, th, tw,
                                     tiles_per_split, splits, s)
                   : launch_dw<false>(x, a, c, g, z, coef, out, n, h, wd, cin, cout, th, tw,
                                      tiles_per_split, splits, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)tuk::reduce_rows(partials, dw, splits, 9LL * cin * cout, s);
}

// z[N,H,W,cout] = conv3x3_same(pro(x), w) in fp32 on the tensor cores
// (3xTF32), pro(x) = relu(x*a + c) when a is not null, else x. x: fp32
// [N,H,W,cin]; w: fp32 [3,3,cin,cout] HWIO; wsplit: fp32 [2][9][cout][cin]
// scratch for its split; a/c: fp32 [cin]. With partials (fp32 [n * tiles][2]
// [cout]), stats (fp32 [2][cout]) receives (sum z, sum z^2) summed from the
// accumulators. cin and cout multiples of 8; (cfg, th, tw) the plan
// (kernels/tc_conv.py tc_plan with f32). One call: the split, the conv,
// then reduce_rows.
extern "C" int tuk_tc_conv3x3_fwd_f32(const float* x, const float* a, const float* c,
                                      const float* w, float* wsplit, float* z, float* partials,
                                      float* stats, int n, int h, int wd, int cin, int cout,
                                      int cfg, int th, int tw, void* stream) {
  if (n == 0 || h == 0 || wd == 0 || cout == 0) return 0;
  using namespace tuk::tc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a != nullptr) {
    const ProLoadF32 ld{a, c};
    err = partials ? launch_f32<ProLoadF32, RoundEpi, true>(cfg, x, nullptr, cin, nullptr, w,
                                                            wsplit, ld, RoundEpi{}, z, partials,
                                                            n, h, wd, cin, cout, th, tw, s)
                   : launch_f32<ProLoadF32, RoundEpi, false>(cfg, x, nullptr, cin, nullptr, w,
                                                             wsplit, ld, RoundEpi{}, z, nullptr,
                                                             n, h, wd, cin, cout, th, tw, s);
  } else {
    err = partials ? launch_f32<RawLoad, RoundEpi, true>(cfg, x, nullptr, cin, nullptr, w, wsplit,
                                                         RawLoad{}, RoundEpi{}, z, partials, n,
                                                         h, wd, cin, cout, th, tw, s)
                   : launch_f32<RawLoad, RoundEpi, false>(cfg, x, nullptr, cin, nullptr, w,
                                                          wsplit, RawLoad{}, RoundEpi{}, z,
                                                          nullptr, n, h, wd, cin, cout, th, tw,
                                                          s);
  }
  if (err != cudaSuccess || partials == nullptr) return (int)err;
  const int rows = n * ((h + th - 1) / th) * ((wd + tw - 1) / tw);
  return (int)tuk::reduce_rows(partials, stats, rows, 2LL * cout, s);
}

// dw[3,3,cin,cout] fp32 on the tensor cores (3xTF32), as tuk_tc_conv3x3_dw
// with fp32 x, g and z; (th, tw, tiles_per_split, splits) from
// kernels/tc_conv.py dw_plan with f32.
extern "C" int tuk_tc_conv3x3_dw_f32(const void* x, const float* a, const float* c, const void* g,
                                     const void* z, const float* coef, float* partials,
                                     float* dw, int n, int h, int wd, int cin, int cout, int th,
                                     int tw, int tiles_per_split, int splits, void* stream) {
  if (cin == 0 || cout == 0) return 0;
  using namespace tuk::tc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0 || h == 0 || wd == 0)
    return (int)cudaMemsetAsync(dw, 0, sizeof(float) * 9 * (size_t)cin * cout, s);
  if (splits > 1 && partials == nullptr) return (int)cudaErrorInvalidValue;
  float* out = splits > 1 ? partials : dw;
  const cudaError_t err =
      a != nullptr ? launch_dw_f32<true>(x, a, c, g, z, coef, out, n, h, wd, cin, cout, th, tw,
                                         tiles_per_split, splits, s)
                   : launch_dw_f32<false>(x, a, c, g, z, coef, out, n, h, wd, cin, cout, th, tw,
                                          tiles_per_split, splits, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)tuk::reduce_rows(partials, dw, splits, 9LL * cin * cout, s);
}

// out[N,H,W,cin] = conv3x3_same(dz, flip(w)^T) in fp32 on the tensor cores
// (3xTF32), dz = coef[0]*g + coef[1]*z + coef[2] per channel (fp32, unrounded)
// built in shared memory and never written out. g, z: fp32 [N,H,W,c]; w: the
// forward weights, fp32 [3,3,cin,c] HWIO; wsplit: fp32 [2][9][cin][c] scratch
// for their split (taps reversed); coef: fp32 [3][c]. c and cin multiples of
// 8; (cfg, th, tw): kernels/tc_conv.py tc_plan of the output width cin with
// f32. One call: the split, then the conv.
extern "C" int tuk_tc_conv3x3_dx_f32(const float* g, const float* z, const float* coef,
                                     const float* w, float* wsplit, float* out, int n, int h,
                                     int wd, int c, int cin, int cfg, int th, int tw,
                                     void* stream) {
  if (n == 0 || h == 0 || wd == 0 || cin == 0) return 0;
  using namespace tuk::tc;
  return (int)launch_f32<DzLoadF32, RoundEpi, false>(
      cfg, g, nullptr, c, z, w, wsplit, DzLoadF32{coef}, RoundEpi{}, out, nullptr, n, h, wd, c,
      cin, th, tw, static_cast<cudaStream_t>(stream));
}

// y[N,H,W,cout] = [relu](conv3x3_same(x, w) * scale + bias) in fp32 on the
// tensor cores (3xTF32). x: fp32 [N,H,W,cin], w: fp32 [3,3,cin,cout] HWIO;
// wsplit: fp32 [2][9][cout][cin] scratch for its split; scale/bias: fp32
// [cout]. cin and cout multiples of 8; (cfg, th, tw) from kernels/tc_conv.py
// tc_plan with f32. One call: the split, then the conv.
extern "C" int tuk_tc_fused_conv3x3_f32(const float* x, const float* w, float* wsplit,
                                        const float* scale, const float* bias, float* out, int n,
                                        int h, int wd, int cin, int cout, int relu, int cfg,
                                        int th, int tw, void* stream) {
  if (n == 0 || h == 0 || wd == 0 || cout == 0) return 0;
  using namespace tuk::tc;
  return (int)launch_f32<RawLoad, AffineEpi, false>(
      cfg, x, nullptr, cin, nullptr, w, wsplit, RawLoad{}, AffineEpi{scale, bias, relu}, out,
      nullptr, n, h, wd, cin, cout, th, tw, static_cast<cudaStream_t>(stream));
}

// im2col_conv3x3's function, y = [relu](conv3x3_same(x, w) * scale + bias),
// in fp32 on the tensor cores (3xTF32): as tuk_tc_fused_conv3x3_f32, with
// out fp32 when out_f32 (stored from the accumulators), else bf16 (rounded
// once, after the ReLU). One call: the split, then the conv.
extern "C" int tuk_tc_im2col_conv3x3_f32(const float* x, const float* w, float* wsplit,
                                         const float* scale, const float* bias, void* out, int n,
                                         int h, int wd, int cin, int cout, int relu, int out_f32,
                                         int cfg, int th, int tw, void* stream) {
  if (n == 0 || h == 0 || wd == 0 || cout == 0) return 0;
  using namespace tuk::tc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AffineEpi epi{scale, bias, relu};
  if (out_f32)
    return (int)launch_f32<RawLoad, AffineEpi, false>(cfg, x, nullptr, cin, nullptr, w, wsplit,
                                                      RawLoad{}, epi, out, nullptr, n, h, wd,
                                                      cin, cout, th, tw, s);
  return (int)launch_f32<RawLoad, AffineEpi, false, false>(cfg, x, nullptr, cin, nullptr, w,
                                                           wsplit, RawLoad{}, epi, out, nullptr,
                                                           n, h, wd, cin, cout, th, tw, s);
}

// y = [relu](conv3x3_same(concat([a, b], -1), w) * scale + bias) in fp32 on
// the tensor cores (3xTF32), the concat never built: a's ceil(ca / 16) K
// chunks, then b's, whose chunk j meets rows ca + 16 j of the split weights.
// a: fp32 [N,H,W,ca], b: fp32 [N,H,W,cb], w: fp32 [3,3,ca+cb,cout] HWIO;
// wsplit: fp32 [2][9][cout][ca+cb] scratch for its split; scale/bias: fp32
// [cout]. ca, cb, cout multiples of 8; (cfg, th, tw) from tc_plan with f32.
// One call: the split, then the conv.
extern "C" int tuk_tc_concat_conv3x3_f32(const float* a, const float* b, const float* w,
                                         float* wsplit, const float* scale, const float* bias,
                                         float* out, int n, int h, int wd, int ca, int cb,
                                         int cout, int relu, int cfg, int th, int tw,
                                         void* stream) {
  if (n == 0 || h == 0 || wd == 0 || cout == 0) return 0;
  using namespace tuk::tc;
  return (int)launch_f32<ConcatLoad, AffineEpi, false>(
      cfg, a, b, ca, nullptr, w, wsplit, ConcatLoad{}, AffineEpi{scale, bias, relu}, out, nullptr,
      n, h, wd, ca + cb, cout, th, tw, static_cast<cudaStream_t>(stream));
}
