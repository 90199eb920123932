// Working-set plane scoring: the approximate max-oracle of MP-BCFW
// (paper Sec. 3.3), written by hand for Hopper (sm_90a).
//
// Replaces repro/kernels/plane_scores.py::plane_scores, the Pallas TPU
// kernel.  Computes
//
//     out[r] = <P[r, 0:d], w> + b[r]          for r in [0, n)
//
// with P a row-strided fp32 view (row stride `row_stride` floats, unit
// column stride) and b a strided fp32 vector (stride `b_stride`).  On the
// main path P and b are the two halves of one block of the plane cache,
// planes[i, :, :-1] and planes[i, :, -1]: rows of d+1 = 4005 floats, so
// neither view is contiguous nor 16-byte aligned.  The kernel takes the
// strides instead of a copy and issues scalar loads, never float4.
//
// Bound: bytes.  A call reads the n x d block once: n*d*4 bytes, which at
// the main-path shape (n = cap = 64, d = 4004) is 1.03 MB, about 0.31 us
// at 3.35 TB/s.  Its 2*n*d flops take about 8 ns at 67 TFLOP/s fp32.  In
// practice each main-path call is bound by launch latency (a few us),
// since an approximate pass launches once per block.
//
// Design: one warp per row, kRowsPerBlock rows per block.  Lane k reads
// columns k, k+32, ..., so each warp load is one coalesced 128-byte
// stretch of its row.  Each lane accumulates in fp32; a fixed xor-shuffle
// butterfly then reduces the 32 partial sums.  The order of operations
// depends only on d, so equal rows always get bit-equal scores and the
// caller's first-argmax keeps ties as ties.  The Pallas (8, 128) tiling
// and its d-tile accumulation grid are not carried over: a GPU block
// loops over d itself.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;

__global__ void plane_scores_kernel(const float* __restrict__ P,
                                    long long row_stride,
                                    const float* __restrict__ w,
                                    const float* __restrict__ b,
                                    long long b_stride,
                                    float* __restrict__ out, int n, int d) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n) return;  // uniform per warp: the shuffles below stay full
  const float* p = P + static_cast<long long>(row) * row_stride;
  float acc = 0.0f;
  for (int j = lane; j < d; j += kWarp) acc += p[j] * w[j];
  for (int off = kWarp / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[row] = acc + b[static_cast<long long>(row) * b_stride];
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int plane_scores_launch(const float* P, long long row_stride,
                                   const float* w, const float* b,
                                   long long b_stride, float* out, int n,
                                   int d, void* stream) {
  const dim3 block(kWarp * kRowsPerBlock);
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock);
  plane_scores_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      P, row_stride, w, b, b_stride, out, n, d);
  return static_cast<int>(cudaGetLastError());
}
