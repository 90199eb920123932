// Fused masked score-and-select over the plane cache: the batched
// approximate max-oracle of MP-BCFW (paper Sec. 3.3), which backs the
// straggler fallback of the pipelined engine, written by hand for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/plane_select.py:64 plane_select, the Pallas
// TPU kernel.  For every selected block b in [0, k), with cache row
// r = rows[b] (r = b when rows is null):
//
//     s_j     = valid[r, j] ? <P[r, j, 0:d], w> + off[r, j] : neg
//     best[b] = max_j s_j,  idx[b] = the first j attaining it
//
// so a row with no valid slot gives (neg, 0).  P is the (n, cap, d) view
// planes[..., :-1] of the cache and off the view planes[..., -1]: rows of
// d+1 = 4005 floats on the main path, neither contiguous nor 16-byte
// aligned.  Both come with their row and slot strides; loads are scalar,
// never float4.  The gather of the selected rows (rows[b]) is fused into
// the loads, so the caller never copies the 7.05 GB cache to permute it.
// A row index outside [0, n) yields (NaN, -1) for that block.
//
// Bound: bytes.  Only valid slots are read: an invalid slot scores `neg`
// whatever its row holds.  The least traffic is the valid slots' d+1
// floats, the k*cap validity bytes, w, the row indices and the outputs.
// After a few iterations of the main path a block holds one or two valid
// planes of 64, so a call reads ~0.1-0.2 GB instead of the full 7.05 GB
// (2.10 ms at 3.35 TB/s); the 2*d flops per valid slot are far below the
// fp32 peak.
//
// Design: one CTA of 8 warps per selected block.  Warp q scores slots
// q, q+8, ...; it reads the slot's validity first and skips an invalid
// slot without touching its plane.  A valid slot is scored in
// plane_scores.cu's exact order (lane j sums columns j, j+32, ..., then a
// fixed xor butterfly, then + offset), so equal planes tie bit for bit and
// the fused result equals plane_scores followed by a first argmax.  The
// scores go to shared memory, one float per slot; warp 0 then scans them:
// each lane keeps the first maximum of its slots (strict >), and a xor
// butterfly over (score, slot) pairs keeps the larger score and, on a tie,
// the lower slot.  No atomics: the result is deterministic.  The Pallas
// slot-major VMEM grid is not carried over; a GPU block walks its own
// slots.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;

__global__ void plane_select_kernel(
    const float* __restrict__ P, long long p_row, long long p_slot,
    const float* __restrict__ w, const float* __restrict__ off,
    long long off_row, long long off_slot,
    const unsigned char* __restrict__ valid, long long v_row,
    long long v_slot, const long long* __restrict__ rows, int n, int cap,
    int d, float neg, float* __restrict__ best, int* __restrict__ idx) {
  extern __shared__ float scores[];  // cap floats
  const int b = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long r = rows != nullptr ? rows[b] : b;
  if (r < 0 || r >= n) {  // uniform per block
    if (threadIdx.x == 0) {
      best[b] = __int_as_float(0x7fc00000);  // NaN
      idx[b] = -1;
    }
    return;
  }
  for (int s = warp; s < cap; s += kWarps) {
    // Every lane reads the same byte: one broadcast load, a uniform branch.
    if (valid[r * v_row + s * v_slot] == 0) {
      if (lane == 0) scores[s] = neg;
      continue;
    }
    const float* p = P + r * p_row + s * p_slot;
    float acc = 0.0f;
    for (int j = lane; j < d; j += kWarp) acc += p[j] * w[j];
    for (int o = kWarp / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) scores[s] = acc + off[r * off_row + s * off_slot];
  }
  __syncthreads();
  if (warp != 0) return;
  float bv = 0.0f;
  int bi = -1;  // -1: this lane has seen no slot
  for (int s = lane; s < cap; s += kWarp) {
    const float v = scores[s];
    if (bi < 0 || v > bv) {
      bv = v;
      bi = s;
    }
  }
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (oi >= 0 && (bi < 0 || ov > bv || (ov == bv && oi < bi))) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    best[b] = bv;
    idx[b] = bi;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `rows` may be null (block b reads cache row b); `k` blocks are selected.
extern "C" int plane_select_launch(
    const float* P, long long p_row, long long p_slot, const float* w,
    const float* off, long long off_row, long long off_slot,
    const unsigned char* valid, long long v_row, long long v_slot,
    const long long* rows, int k, int n, int cap, int d, float neg,
    float* best, int* idx, void* stream) {
  const dim3 block(kWarp * kWarps);
  const dim3 grid(k);
  const size_t smem = static_cast<size_t>(cap) * sizeof(float);
  plane_select_kernel<<<grid, block, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      P, p_row, p_slot, w, off, off_row, off_slot, valid, v_row, v_slot,
      rows, n, cap, d, neg, best, idx);
  return static_cast<int>(cudaGetLastError());
}
