// 3x3 SAME convolution on NHWC bf16 activations and HWIO bf16 weights as an
// implicit GEMM on the Hopper tensor cores, with two loader/epilogue policies:
//
//   tuk_tc_fused_conv3x3  y = [relu](conv3x3_same(x, w) * scale + bias)
//     replaces tpu_unet/kernels/fused_conv.py:75 fused_conv3x3_scale_relu
//     (its pallas_call at :115), bf16 route;
//   tuk_tc_conv3x3_fwd    z = conv3x3_same(pro(x), w), optional (sum z, sum z^2)
//     replaces tpu_unet/kernels/train_conv.py:128 conv3x3_fwd (pallas_call at
//     :204), bf16 route. pro(x) = relu(x*a + c) rounded to bf16, or x.
//
// fp32 calls stay on the CUDA-core kernels of fused_conv.cu / train_conv.cu
// (the port runs fp32 without TF32).
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace tuk {

// Fixed-order sum of fp32 rows (train_conv.cu); `in` is scratch.
cudaError_t reduce_rows(float* in, float* out, int rows, long long cols, cudaStream_t stream);

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int KC = 32;        // input channels per staged chunk (64 bytes a pixel)
constexpr int STAGES = 4;     // k-steps in the weight ring
constexpr int kAlign = 1024;  // slot alignment: the swizzle patterns repeat every 1024 bytes
constexpr int kMaxDevices = 64;

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// A block configuration: BM output pixels x BN output channels, WM x WN
// warps (each a (BM / WM) x (BN / WN) warp tile), MAX_STAGED pixels of the
// tile plus its halo, MIN_BLOCKS resident blocks an SM (launch bounds).
template <int BM_, int BN_, int WM_, int WN_, int MAX_STAGED_, int MIN_BLOCKS_>
struct Config {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int MAX_STAGED = MAX_STAGED_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MI = BM / WM / 16;  // m16 fragments per warp
  static constexpr int NI = BN / WN / 8;   // n8 fragments per warp
  static constexpr int IN_SLOT = round_up(MAX_STAGED * KC * 2, kAlign);  // bytes
  static constexpr int W_SLOT = KC * BN * 2;                             // bytes
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

// ---- loader policies: what the staged chunk holds --------------------------

// The raw input, as loaded.
struct RawLoad {
  static constexpr bool kTransform = false;
  template <class C>
  __device__ __forceinline__ void transform(unsigned char*, const Tile&, int, int) const {}
};

// relu(x*a + c) rounded to bf16, rewritten in place over the loaded chunk.
// Positions outside the image or past Cin keep the zeros of the fill.
struct ProLoad {
  static constexpr bool kTransform = true;
  const float* a;
  const float* c;
  template <class C>
  __device__ __forceinline__ void transform(unsigned char* slot, const Tile& t, int k0,
                                            int cin) const {
    constexpr int kVec = KC / 8;  // 16-byte chunks per staged pixel
    static_assert(C::THREADS % kVec == 0, "a thread keeps its 8 channels");
    const int ch = threadIdx.x % kVec;
    const int k = k0 + ch * 8;
    // Most tiles' halo lies in the image: they skip the per-pixel test.
    const bool inside = t.h0 >= 1 && t.h0 + t.th < t.H && t.w0 >= 1 && t.w0 + t.tw < t.W;
    if (k < cin) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + k);
      const float4 a1 = *reinterpret_cast<const float4*>(a + k + 4);
      const float4 c0 = *reinterpret_cast<const float4*>(c + k);
      const float4 c1 = *reinterpret_cast<const float4*>(c + k + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      for (int q = threadIdx.x / kVec; q < t.staged(); q += C::THREADS / kVec) {
        if (!inside && !t.staged_in_image(q)) continue;
        uint4* p = reinterpret_cast<uint4*>(slot + in_off(q, ch));
        uint4 raw = *p;
        __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(v[e]);
          v[e] = __floats2bfloat162_rn(
              relu_f(__fadd_rn(__fmul_rn(f.x, av[2 * e]), cv[2 * e])),
              relu_f(__fadd_rn(__fmul_rn(f.y, av[2 * e + 1]), cv[2 * e + 1])));
        }
        *p = raw;
      }
    }
    fence_proxy_async();  // the slot is TMA-written again two chunks later
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

// ---- the kernel -------------------------------------------------------------
//
// Grid: (tiles_h * tiles_w, ceil(cout / BN), N). Block (t, cb, n) computes
// output pixels h0 + p / tw, w0 + p % tw (p < th * tw) of image n, channels
// cb * BN ... With partials, it writes the (sum, sum of squares) of its
// rounded outputs per channel to partials[((n * tiles + t) * 2 + s) * cout + co].
// tmx: x as [N][H][W][cin] (dims cin, W, H, N), box (KC, tw + 2, th + 2, 1);
// tmw: w as [9][cin][cout] (dims cout, cin, 9), box (64, KC, 1).
template <class C, class Load, class Epi, bool kStats>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
    tc_conv_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                   Load ld, Epi epi, bf16* __restrict__ out, float* __restrict__ partials, int H,
                   int W, int cin, int cout, int th, int tw, int tiles_w) {
  constexpr int BN = C::BN;
  constexpr int MI = C::MI;
  constexpr int NI = C::NI;
  constexpr int kWarpM = C::BM / C::WM;
  constexpr int kWarpN = C::BN / C::WN;
  constexpr int kORow = BN + 8;  // halves per output-tile row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~(uintptr_t)(kAlign - 1));
  unsigned char* in_s = smem;                    // 2 input slots
  unsigned char* w_s = in_s + 2 * C::IN_SLOT;    // STAGES weight slots
  float* red_s = reinterpret_cast<float*>(w_s + STAGES * C::W_SLOT);
  uint64_t* in_bar = reinterpret_cast<uint64_t*>(red_s + C::WM * C::WN * 2 * BN);
  uint64_t* w_bar = in_bar + 2;

  const Tile t{(int)blockIdx.z, (int)(blockIdx.x / tiles_w) * th,
               (int)(blockIdx.x % tiles_w) * tw, th, tw, H, W};
  const int co0 = blockIdx.y * BN;
  const int tile_px = th * tw;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp % C::WM;
  const int wn = warp / C::WM;
  const int nchunks = (cin + KC - 1) / KC;
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
  int b_off[NI / 2];
#pragma unroll
  for (int j = 0; j < NI / 2; ++j) {
    const int col8 = (wn * kWarpN + j * 16) / 8 + lane / 16;  // n8 block in the slice
    b_off[j] = (col8 / 8) * (KC * 128) + w_off((lane / 8) % 2 * 8 + lane % 8, col8 % 8);
  }

  // One thread issues the loads of k-step g: at a chunk's first tap its
  // input box, always its weight boxes.
  auto issue = [&](int g) {
    if (threadIdx.x != 0) return;
    const int chunk = g / 9;
    const int tap = g - chunk * 9;
    fence_proxy_async();
    if (tap == 0) {
      uint64_t* bar = in_bar + (chunk & 1);
      mbar_expect_tx(bar, (uint32_t)(t.staged() * KC * 2));
      tma_load_4d(in_s + (chunk & 1) * C::IN_SLOT, &tmx, bar, chunk * KC, t.w0 - 1, t.h0 - 1,
                  t.n);
    }
    uint64_t* bar = w_bar + g % STAGES;
    mbar_expect_tx(bar, (uint32_t)C::W_SLOT);
#pragma unroll
    for (int hh = 0; hh < BN / 64; ++hh)
      tma_load_3d(w_s + (g % STAGES) * C::W_SLOT + hh * KC * 128, &tmw, bar, co0 + hh * 64,
                  chunk * KC, tap);
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 + STAGES; ++i) mbar_init(in_bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g)
    if (g < nsteps) issue(g);

#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    const int chunk = s / 9;
    const int tap = s - chunk * 9;
    unsigned char* slot = in_s + (chunk & 1) * C::IN_SLOT;
    if (tap == 0) mbar_wait(in_bar + (chunk & 1), (chunk >> 1) & 1);
    mbar_wait(w_bar + s % STAGES, (s / STAGES) & 1);
    __syncthreads();  // every thread is past step s - 1: its weight slot is free
    if (Load::kTransform && tap == 0) {
      ld.template transform<C>(slot, t, chunk * KC, cin);
      __syncthreads();
    }
    if (s + STAGES - 1 < nsteps) issue(s + STAGES - 1);

    const int tap_q = (tap / 3) * t.sw() + tap % 3;
    const uint32_t a_base = smem_addr(slot);
    const uint32_t b_base = smem_addr(w_s + (s % STAGES) * C::W_SLOT);
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
          mma_bf16(acc[mi][ni], af[mi], bfr[ni / 2][(ni % 2) * 2], bfr[ni / 2][(ni % 2) * 2 + 1]);
    }
  }
  __syncthreads();  // the rings are free: the output tile [BM][BN + 8] reuses them

  // Epilogue: lane holds rows p = wm*kWarpM + mi*16 + lane/4 (+8) and
  // channels j = wn*kWarpN + ni*8 + (lane%4)*2 (+1) of the [BM][BN] tile.
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

// ---- host side --------------------------------------------------------------

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

// A bf16 tensor map of `rank` dims (innermost first) with zero fill outside.
cudaError_t make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides_bytes, const cuuint32_t* box,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                            const_cast<void*>(base), dims, strides_bytes, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class C, class Load, class Epi, bool kStats>
cudaError_t launch(const void* x, const void* w, const Load& ld, const Epi& epi, void* out,
                   float* partials, int n, int h, int wd, int cin, int cout, int th, int tw,
                   cudaStream_t stream) {
  if (cin % 8 != 0 || cout % 8 != 0 || th < 1 || tw < 1 || th * tw > C::BM ||
      (th + 2) * (tw + 2) > C::MAX_STAGED || th + 2 > 256 || tw + 2 > 256)
    return cudaErrorInvalidValue;
  CUtensorMap tmx, tmw;
  const cuuint64_t xdims[4] = {(cuuint64_t)cin, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t xstrides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)wd * cin * 2,
                                  (cuuint64_t)h * wd * cin * 2};
  const cuuint32_t xbox[4] = {(cuuint32_t)KC, (cuuint32_t)(tw + 2), (cuuint32_t)(th + 2), 1};
  cudaError_t err = make_map(&tmx, x, 4, xdims, xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdims[3] = {(cuuint64_t)cout, (cuuint64_t)cin, 9};
  const cuuint64_t wstrides[2] = {(cuuint64_t)cout * 2, (cuuint64_t)cin * cout * 2};
  const cuuint32_t wbox[3] = {64, (cuuint32_t)KC, 1};
  err = make_map(&tmw, w, 3, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  auto kernel = tc_conv_kernel<C, Load, Epi, kStats>;
  // The shared-memory opt-in, once per device: a CUDA API call on every launch
  // would add to the host time before it.
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !opted_in[dev].load()) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) opted_in[dev].store(true);
  }
  const int tiles_w = (wd + tw - 1) / tw;
  const int tiles_h = (h + th - 1) / th;
  const dim3 grid(tiles_w * tiles_h, (cout + C::BN - 1) / C::BN, n);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(tmx, tmw, ld, epi, static_cast<bf16*>(out),
                                                partials, h, wd, cin, cout, th, tw, tiles_w);
  return cudaGetLastError();
}

template <class Load, class Epi, bool kStats>
cudaError_t launch_cfg(int cfg, const void* x, const void* w, const Load& ld, const Epi& epi,
                       void* out, float* partials, int n, int h, int wd, int cin, int cout, int th,
                       int tw, cudaStream_t stream) {
#define TUK_TC_CASE(ID)                                                                      \
  case ID:                                                                                   \
    return launch<Cfg##ID, Load, Epi, kStats>(x, w, ld, epi, out, partials, n, h, wd, cin, \
                                               cout, th, tw, stream);
  switch (cfg) {
    TUK_TC_CASE(0)
    TUK_TC_CASE(1)
  }
#undef TUK_TC_CASE
  return cudaErrorInvalidValue;
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
      cfg, x, w, RawLoad{}, AffineEpi{scale, bias, relu}, out, nullptr, n, h, wd, cin, cout, th,
      tw, static_cast<cudaStream_t>(stream));
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
    err = partials ? launch_cfg<ProLoad, RoundEpi, true>(cfg, x, w, ld, RoundEpi{}, z, partials,
                                                         n, h, wd, cin, cout, th, tw, s)
                   : launch_cfg<ProLoad, RoundEpi, false>(cfg, x, w, ld, RoundEpi{}, z, nullptr,
                                                          n, h, wd, cin, cout, th, tw, s);
  } else {
    err = partials ? launch_cfg<RawLoad, RoundEpi, true>(cfg, x, w, RawLoad{}, RoundEpi{}, z,
                                                         partials, n, h, wd, cin, cout, th, tw, s)
                   : launch_cfg<RawLoad, RoundEpi, false>(cfg, x, w, RawLoad{}, RoundEpi{}, z,
                                                          nullptr, n, h, wd, cin, cout, th, tw, s);
  }
  if (err != cudaSuccess || partials == nullptr) return (int)err;
  const int rows = n * ((h + th - 1) / th) * ((wd + tw - 1) / tw);
  return (int)tuk::reduce_rows(partials, stats, rows, 2LL * cout, s);
}
