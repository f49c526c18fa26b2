// reduce_rows: the fixed-order sum of fp32 partial rows that the tensor-core
// kernels of tc_conv.cu end with (conv3x3_fwd's per-tile batch statistics,
// conv3x3_dw's per-split partials), so that every result is deterministic.
//
// The train kernels it serves replace tpu_unet/kernels/train_conv.py:128
// conv3x3_fwd, :289 conv3x3_dx and :441 conv3x3_dw, and all run on the
// tensor cores of tc_conv.cu, in bf16 and in fp32 (3xTF32: each operand
// split into a TF32 high part and the TF32 rounding of the rest, three
// products summed in fp32, fp32 accuracy). The Pallas kernels carry their
// sums across a sequential grid axis; blocks on the H100 run in no order, so
// their partial rows are added here in an order fixed by the shapes.

#include <cuda_runtime.h>

namespace tuk {

// Fixed-order sums of fp32 rows. Block (bx, g) adds rows g * group ...
// min(rows, (g + 1) * group) - 1 (row r at in + r * in_stride) of columns
// bx * 32 ...: thread (tx, ty) adds rows ty, ty + 32, ... of the group, then
// row 0 of the block adds the 32 sums in order and writes them to
// out + g * out_stride. out may be in itself: a block reads only its own
// rows and columns, and writes after it has read them.
__global__ void __launch_bounds__(1024)
    reduce_rows_kernel(const float* in, float* out, int rows, long long cols, long long in_stride,
                       int group, long long out_stride) {
  __shared__ float part[32][33];
  const long long c = (long long)blockIdx.x * 32 + threadIdx.x;
  const int r0 = blockIdx.y * group;
  const int r1 = min(rows, r0 + group);
  float v = 0.f;
  if (c < cols)
#pragma unroll 8
    for (int r = r0 + threadIdx.y; r < r1; r += 32) v += in[(size_t)r * in_stride + c];
  part[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float s = 0.f;
    for (int q = 0; q < 32; ++q) s += part[q][threadIdx.x];
    out[blockIdx.y * out_stride + c] = s;
  }
}

// out[c] = sum over r of in[r * cols + c], in an order fixed by rows and
// cols. Few columns (the batch statistics: 2 * cout) would give a handful of
// blocks, each reading thousands of rows: then a first launch sums groups
// of >= 256 rows into each group's first row, in place, with enough groups
// for about 4 blocks an SM, and a second launch adds the groups' rows.
// Wide ones (dw) take one launch. `in` is scratch: its contents are lost.
cudaError_t reduce_rows(float* in, float* out, int rows, long long cols, cudaStream_t stream) {
  const dim3 block(32, 32);
  const unsigned col_blocks = (unsigned)((cols + 31) / 32);
  const long long want = 4LL * 132 / col_blocks;  // row groups for ~4 blocks an SM
  int groups = (int)(want < (rows + 255) / 256 ? want : (rows + 255) / 256);
  if (groups <= 1) {
    reduce_rows_kernel<<<dim3(col_blocks, 1), block, 0, stream>>>(in, out, rows, cols, cols, rows,
                                                                   0);
    return cudaGetLastError();
  }
  const int group = (rows + groups - 1) / groups;
  groups = (rows + group - 1) / group;
  const long long stride = (long long)group * cols;
  reduce_rows_kernel<<<dim3(col_blocks, groups), block, 0, stream>>>(in, in, rows, cols, cols,
                                                                      group, stride);
  reduce_rows_kernel<<<dim3(col_blocks, 1), block, 0, stream>>>(in, out, groups, cols, stride,
                                                                 groups, 0);
  return cudaGetLastError();
}

}  // namespace tuk
