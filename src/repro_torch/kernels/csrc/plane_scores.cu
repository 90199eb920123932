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
// main path (mpbcfw-gram) P is one block of the plane cache,
// planes[i, :, :-1], and w the plane just inserted into it: each insert's
// Gram row (cache/ops.py::row_dots, b = 0), inside the exact step's
// captured CUDA graph.  Rows of d+1 = 4005 floats: P is neither contiguous
// nor 16-byte aligned, so the kernel takes the strides and copies 4 bytes
// at a time.
//
// The order contract: lane l of a row's warp sums columns l, l+32, ... in
// ascending order with fmaf(p, w, acc), then a xor butterfly over offsets
// 16, 8, 4, 2, 1 adds the lanes, then + b.  plane_select.cu and
// approx_pass.cu reduce a row in the same order, and the tests hold their
// scores equal bit for bit, so one row stays one warp here: equal rows get
// bit-equal scores and a first argmax keeps ties as ties.
//
// Bound: bytes.  A call reads the n x d block once: n*d*4 bytes, which at
// the main-path shape (n = cap = 64, d = 4004) is 1.03 MB, about 0.31 us
// at 3.35 TB/s; its 2*n*d flops take about 8 ns at 67 TFLOP/s fp32.  The
// order contract leaves each row one dependent chain of ceil(d/32) FMAs
// (126 at d = 4004) behind the row's loads, so a call is bound by one DRAM
// round trip plus that chain, a few us, not by bytes.
//
// Design: `rows` warps per CTA, one row each; the host's plan
// (kernels/plane_scores.py::plan) takes 1 row per CTA while the CTAs fit
// on the 132 SMs (a 64-row block spreads over 64 SMs), up to 8 for the
// flat multi-block calls.  Each lane streams its own columns of p and w
// through a private ring of kStages chunks of 32 columns in shared memory,
// filled by 4-byte cp.async kStages - 1 chunks ahead of its FMAs: at 1-2
// rows per CTA the ring holds 4096 columns, so a whole 4004-wide row is in
// flight at once.  A lane reads back only what it copied, so cp.async's
// wait_group orders it and no barrier is needed.
#include <cuda_runtime.h>

#include "builds.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kPerLane = 32;              // columns a lane copies per chunk
constexpr int kChunk = kWarp * kPerLane;  // a chunk: 1024 columns of a row

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending)
               : "memory");
}

template <int kStages>
__global__ void plane_scores_kernel(const float* __restrict__ P,
                                    long long row_stride,
                                    const float* __restrict__ w,
                                    const float* __restrict__ b,
                                    long long b_stride,
                                    float* __restrict__ out, int n, int d) {
  extern __shared__ float ring[];  // per warp: kStages x (p, w) chunks
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int row = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (row >= n) return;  // uniform per warp: the shuffles below stay full
  const float* p = P + static_cast<long long>(row) * row_stride;
  float* mine = ring + warp * kStages * 2 * kChunk + lane;
  const int chunks = (d + kChunk - 1) / kChunk;

  // Chunk c goes to slot c % kStages: p at [0, kChunk), w after it.
  auto fetch = [&](int c) {
    float* slot = mine + (c % kStages) * 2 * kChunk;
    const int j0 = c * kChunk + lane;
    if (c * kChunk + kChunk <= d) {
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        cp_async4(slot + u * kWarp, p + j0 + u * kWarp);
        cp_async4(slot + kChunk + u * kWarp, w + j0 + u * kWarp);
      }
    } else {
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        if (j0 + u * kWarp < d) {
          cp_async4(slot + u * kWarp, p + j0 + u * kWarp);
          cp_async4(slot + kChunk + u * kWarp, w + j0 + u * kWarp);
        }
      }
    }
  };

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) fetch(c);
    cp_async_commit();
  }
  float acc = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    __syncwarp();  // this lane's reads of slot (c - 1) % kStages are done
    if (c + kStages - 1 < chunks) fetch(c + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // chunk c has landed
    const float* slot = mine + (c % kStages) * 2 * kChunk;
    const int j0 = c * kChunk + lane;
    if (c * kChunk + kChunk <= d) {
#pragma unroll
      for (int u = 0; u < kPerLane; ++u)
        acc = fmaf(slot[u * kWarp], slot[kChunk + u * kWarp], acc);
    } else {
#pragma unroll
      for (int u = 0; u < kPerLane; ++u)
        if (j0 + u * kWarp < d)
          acc = fmaf(slot[u * kWarp], slot[kChunk + u * kWarp], acc);
    }
  }
  for (int off = kWarp / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[row] = acc + b[static_cast<long long>(row) * b_stride];
}

template <int kStages>
size_t smem_bytes(int rows) {
  return sizeof(float) * static_cast<size_t>(rows) * kStages * 2 * kChunk;
}

// The builds: the largest plans' dynamic shared memory, 2 rows of 4
// stages and 8 rows of 2.
const repro::Build kBuilds[] = {
    REPRO_BUILD(smem_bytes<4>(2), plane_scores_kernel<4>),
    REPRO_BUILD(smem_bytes<2>(8), plane_scores_kernel<2>),
};

}  // namespace

// Once, when the library loads (never inside a graph capture): dynamic
// shared memory above 48 KB for the largest plans.  Returns a cudaError_t.
extern "C" int plane_scores_init(void) {
  return static_cast<int>(repro::grant(kBuilds));
}

// One build's attributes (builds.cuh repro::attributes).
extern "C" int plane_scores_attributes(int build, int threads,
                                       long long dyn_smem, int cluster,
                                       long long* out) {
  return repro::attributes(kBuilds, build, threads, dyn_smem, cluster, out);
}

// Launches on `stream` with the plan's rows per CTA (1, 2, 4 or 8) and
// ring depth (4 up to 2 rows, else 2) and returns cudaGetLastError() (0 on
// success).
extern "C" int plane_scores_launch(const float* P, long long row_stride,
                                   const float* w, const float* b,
                                   long long b_stride, float* out, int n,
                                   int d, int rows, int stages,
                                   void* stream) {
  const bool ok_rows = rows == 1 || rows == 2 || rows == 4 || rows == 8;
  if (!ok_rows || (stages == 4 && rows > 2) || (stages != 4 && stages != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kWarp * rows);
  const dim3 grid((n + rows - 1) / rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stages == 4)
    plane_scores_kernel<4><<<grid, block, smem_bytes<4>(rows), s>>>(
        P, row_stride, w, b, b_stride, out, n, d);
  else
    plane_scores_kernel<2><<<grid, block, smem_bytes<2>(rows), s>>>(
        P, row_stride, w, b, b_stride, out, n, d);
  return static_cast<int>(cudaGetLastError());
}
