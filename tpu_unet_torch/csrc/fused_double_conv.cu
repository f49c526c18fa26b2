// A whole folded-BN DoubleConv in one kernel:
//   out = relu(conv3x3(mid, w2) * s2 + b2),  mid = relu(conv3x3(x, w1) * s1 + b1)
// with both convs SAME-padded and mid never written to device memory.
//
// Replaces the TPU kernel tpu_unet/kernels/fused_double_conv.py
// fused_double_conv, fp32 route; bf16 runs on the tensor cores
// (tc_double_conv.cu), and tuk_double_conv refuses it.
//
// What bounds it on the H100: arithmetic, as for fused_conv.cu (CUDA-core fp32
// FMA), plus shared-memory capacity. What the fusion
// saves is the write and re-read of mid (H*W*Cmid elements), which matters at
// the wide, shallow levels where it runs (Cin/Cmid <= 256). Design:
//   * A block owns an 8 x 16 output tile and ALL output channels, so mid is
//     computed once per tile. conv1 is evaluated over the tile plus a 1-px
//     halo (10 x 18 mid pixels, computed as 10 x 20 so every thread owns whole
//     4-pixel groups; the 2 extra columns are dropped): the halo recompute
//     costs ~1.5x conv1's work.
//   * mid lives in dynamic shared memory as [Cmid][10][18] in the input dtype,
//     rounded exactly as the plain version rounds it. At Cmid = 256 in fp32
//     that is 180 KB, which with the 8 KB input chunk and the 18 KB weight
//     chunk stays under the 227 KB a block may use.
//   * mid pixels outside the image are zeroed: conv1 evaluated there gives
//     relu(b1), but conv2's SAME padding must read zeros
//     (tpu_unet/kernels/fused_double_conv.py, lines 64-73).
//   * conv2 streams its weights kKC mid channels at a time and loops over
//     64-channel output blocks inside the block.
// Any Cin works (inc has Cin = 3): input chunks are zero-filled past Cin and
// no alignment of the channel axis is assumed.

#include "common.cuh"

namespace tuk {

constexpr int kDTH = 8;                  // output tile rows
constexpr int kDTW = 16;                 // output tile columns
constexpr int kMH = kDTH + 2;            // mid rows held (1-px halo)
constexpr int kMWS = kDTW + 2;           // mid columns held
constexpr int kMWC = kDTW + 4;           // mid columns computed (whole 4-px groups)
constexpr int kIH = kMH + 2;             // conv1 input rows staged
constexpr int kIW = kMWC + 2;            // conv1 input columns staged
constexpr int kMidRowGroups = kMWC / kPX;
constexpr int kMidGroups = kMH * kMidRowGroups;
constexpr int kNP1 = (kMidGroups + kSlots - 1) / kSlots;
constexpr size_t kFixedSmem = sizeof(float) * (kWChunk + kKC * kIH * kIW);

template <typename T>
size_t double_conv_smem(int cmid) {
  return kFixedSmem + sizeof(T) * (size_t)cmid * kMH * kMWS;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    double_conv_kernel(const T* __restrict__ x, int cin, const T* __restrict__ w1,
                       const float* __restrict__ s1, const float* __restrict__ b1, int cmid,
                       const T* __restrict__ w2, const float* __restrict__ s2,
                       const float* __restrict__ b2, int cout, T* __restrict__ out, int H, int W,
                       int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);
  float* in_s = w_s + kWChunk;
  T* mid = reinterpret_cast<T*>(smem + kFixedSmem);

  const int n = blockIdx.z;
  const int h0 = (blockIdx.x / tiles_w) * kDTH;
  const int w0 = (blockIdx.x % tiles_w) * kDTW;
  const int cg = threadIdx.x % kCGroups;
  const int slot = threadIdx.x / kCGroups;

  // conv1 over the mid region: pixel group g = slot + p * kSlots. Groups past
  // the region compute on group 0's pixels and store nothing.
  int off1[kNP1], mrow[kNP1], mcol[kNP1];
  bool live[kNP1];
#pragma unroll
  for (int p = 0; p < kNP1; ++p) {
    const int g = slot + p * kSlots;
    live[p] = g < kMidGroups;
    const int gg = live[p] ? g : 0;
    mrow[p] = gg / kMidRowGroups;
    mcol[p] = (gg % kMidRowGroups) * kPX;
    off1[p] = mrow[p] * kIW + mcol[p];
  }
  for (int cm0 = 0; cm0 < cmid; cm0 += kCOB) {
    float acc[kNP1][kPX][kCG] = {};
    for (int k0 = 0; k0 < cin; k0 += kKC) {
      __syncthreads();
      stage_input(in_s, x, x, cin, 0, n, H, W, h0 - 2, w0 - 2, kIH, kIW, k0);
      stage_weights(w_s, w1, cin, cmid, k0, cm0);
      __syncthreads();
      accum_chunk<float, kNP1>(in_s, kIH, kIW, kKC, w_s, cg, off1, acc);
    }
#pragma unroll
    for (int p = 0; p < kNP1; ++p) {
      if (!live[p]) continue;
      const int gh = h0 - 1 + mrow[p];
      const bool row_in = gh >= 0 && gh < H;
#pragma unroll
      for (int j = 0; j < kCG; ++j) {
        const int c = cm0 + cg * kCG + j;
        if (c < cmid) {
          const float s = s1[c];
          const float t = b1[c];
#pragma unroll
          for (int i = 0; i < kPX; ++i) {
            const int mc = mcol[p] + i;
            if (mc < kMWS) {
              const int gw = w0 - 1 + mc;
              float y = relu_f(acc[p][i][j] * s + t);
              if (!row_in || gw < 0 || gw >= W) y = 0.f;
              mid[((size_t)c * kMH + mrow[p]) * kMWS + mc] = from_f<T>(y);
            }
          }
        }
      }
    }
  }

  // conv2 over the output tile, reading mid from shared memory.
  const int row = slot / (kDTW / kPX);
  const int col = (slot % (kDTW / kPX)) * kPX;
  const int off2[1] = {row * kMWS + col};
  const int gh = h0 + row;
  for (int co0 = 0; co0 < cout; co0 += kCOB) {
    float acc[1][kPX][kCG] = {};
    for (int k0 = 0; k0 < cmid; k0 += kKC) {
      __syncthreads();
      stage_weights(w_s, w2, cmid, cout, k0, co0);
      __syncthreads();
      const int kc = cmid - k0 < kKC ? cmid - k0 : kKC;
      accum_chunk<T, 1>(mid + (size_t)k0 * kMH * kMWS, kMH, kMWS, kc, w_s, cg, off2, acc);
    }
    if (gh < H) {
#pragma unroll
      for (int j = 0; j < kCG; ++j) {
        const int co = co0 + cg * kCG + j;
        if (co < cout) {
          const float s = s2[co];
          const float t = b2[co];
#pragma unroll
          for (int i = 0; i < kPX; ++i) {
            const int gw = w0 + col + i;
            if (gw < W)
              out[(((size_t)n * H + gh) * W + gw) * cout + co] =
                  from_f<T>(relu_f(acc[0][i][j] * s + t));
          }
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_double_conv(const void* x, int cin, const void* w1, const float* s1,
                               const float* b1, int cmid, const void* w2, const float* s2,
                               const float* b2, int cout, void* out, int n, int h, int wd,
                               cudaStream_t stream) {
  const size_t smem = double_conv_smem<T>(cmid);
  cudaError_t err = cudaFuncSetAttribute(double_conv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (wd + kDTW - 1) / kDTW;
  const int tiles_h = (h + kDTH - 1) / kDTH;
  const dim3 grid(tiles_w * tiles_h, 1, n);
  double_conv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), cin, static_cast<const T*>(w1), s1, b1, cmid,
      static_cast<const T*>(w2), s2, b2, cout, static_cast<T*>(out), h, wd, tiles_w);
  return cudaGetLastError();
}

}  // namespace tuk

// Dynamic shared memory the kernel needs for this Cmid (fp32), so the
// wrapper can refuse a Cmid that does not fit before launching.
extern "C" size_t tuk_double_conv_smem(int cmid) { return tuk::double_conv_smem<float>(cmid); }

// out[N,H,W,cout] = relu(conv3x3(relu(conv3x3(x, w1) * s1 + b1), w2) * s2 + b2).
// x: [N,H,W,cin], w1: [3,3,cin,cmid], w2: [3,3,cmid,cout] HWIO; s*/b*: fp32.
// dtype: 0 fp32 (x, weights, mid and out); bf16 (1) is refused with
// cudaErrorInvalidValue: it runs on the tensor cores (tuk_tc_double_conv).
// Returns the CUDA error.
extern "C" int tuk_double_conv(const void* x, int cin, const void* w1, const float* s1,
                               const float* b1, int cmid, const void* w2, const float* s2,
                               const float* b2, int cout, void* out, int n, int h, int wd,
                               int dtype, void* stream) {
  if (dtype != tuk::kF32) return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || wd == 0 || cout == 0) return 0;
  return tuk::launch_double_conv<float>(x, cin, w1, s1, b1, cmid, w2, s2, b2, cout, out, n, h, wd,
                                        static_cast<cudaStream_t>(stream));
}
