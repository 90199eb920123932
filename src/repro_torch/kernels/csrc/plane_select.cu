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
// aligned.  Both come with their row and slot strides.  The gather of the
// selected rows (rows[b]) is fused into the loads, so the caller never
// copies the 7.05 GB cache to permute it.  A row index outside [0, n)
// yields (NaN, -1) for that block.
//
// Bound: bytes.  Only valid slots are read: an invalid slot scores `neg`
// whatever its row holds.  The least traffic is the valid slots' d+1
// floats, the k*cap validity bytes, w, the row indices and the outputs.
// After a few iterations of the main path a block holds one or two valid
// planes of 64, so a call reads ~0.25 GB instead of the full 7.05 GB
// (2.10 ms at 3.35 TB/s); the 2*d flops per valid slot are far below the
// fp32 peak.  Under load a read takes ~2 us, so to stream at the card's
// rate an SM must keep ~60 KB of loads in flight (Little's law), whatever
// the density.  At the path's density the valid planes are scattered
// 16 KB reads, which the card serves at ~2.2 TB/s (PERF.md, B2), not
// at its sequential rate.
//
// Design (the launch plan, kernels/plane_select.py::plan, is a function
// of (k, cap, d) alone):
// - A CTA of kWarps warps takes `rows_per_cta` selected blocks.  It reads
//   their row indices, then all their validity bytes at once (one round
//   trip), and warp 0 packs the valid (row, slot) pairs, in row and slot
//   order, into a shared list with __ballot_sync/__popc.  Warp q scores
//   pairs q, q + kWarps, ...: every warp streams planes whatever the
//   density, and a row with no valid slot costs its validity bytes only.
// - Each warp owns a ring of kStages slots in shared memory.  Its lane 0
//   stages a pair's plane with one Hopper bulk copy (the TMA engine's
//   cp.async.bulk, counted by the slot's mbarrier), kStages - 1 pairs
//   ahead of the one the warp scores, so that many 16 KB rows per warp are
//   in flight while the warp computes and no thread spends an instruction
//   per word copied.  Several CTAs share an SM, so one CTA's prologue (its
//   row indices and validity) overlaps the others' streaming.
//   A bulk copy moves whole 16-byte units between 16-byte aligned
//   addresses, and rows start at any 4-byte offset: each copy covers its
//   columns rounded out to 16 bytes (never past the row's own 16-byte
//   units, so never off its page) into a slot 6 floats longer, and the row
//   is read at its offset in the slot (as approx_pass.cu does).  A
//   row wider than `chunk` columns (a multiple of 32) is staged chunk by
//   chunk; each lane's sum runs on across them.
// - The pairs' offsets are read by all threads while the first copies are
//   in flight.  w is either staged once per CTA by one more bulk copy
//   (`w_shared`) or read through L1, where every warp of the SM finds it.
// - Scores go to shared memory, one per pair.  One warp per row then
//   takes the first maximum over its pairs (strict >, the lower slot on a
//   tie, by a xor butterfly over (score, slot)), and against `neg` at the
//   row's first invalid slot, so the result equals a first argmax over all
//   cap slots with invalid ones at `neg`.
//
// The order contract: a pair is scored in plane_scores.cu's exact order
// (lane l sums columns l, l+32, ... ascending with fmaf(p, w, acc), then
// the xor butterfly over 16, 8, 4, 2, 1, then + offset), so equal planes
// tie bit for bit and the fused result equals plane_scores followed by a
// first argmax.  Only the loads move ahead: each lane's chain keeps its
// order.  Which warp scores a pair, and which CTA a row falls in, changes
// no bit, and no atomics decide a result: every plan gives the same bits.
#include <cuda_runtime.h>

#include <cstdint>

#include "builds.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = repro::kSmemLimit;   // what a CTA may opt into
// Warps per CTA and ring slots per warp: the plan measured fastest at the
// path's density (PERF.md, B2).
constexpr int kWarps = 2;
constexpr int kStages = 3;
constexpr int kMaxRows = 32;
constexpr long long kNoBlock = -2;   // a CTA's row past k
constexpr long long kOutside = -1;   // rows[b] outside [0, n)

struct Args {
  const float* P;
  long long p_row, p_slot;
  const float* w;
  const float* off;
  long long off_row, off_slot;
  const unsigned char* valid;
  long long v_row, v_slot;
  const long long* rows;
  float* best;
  int* idx;
  int k, n, cap, d;
  float neg;
  int rows_per_cta, chunk;
};

// Shared memory, in 4-byte words from its start (16-byte aligned): the
// warps' rings, w's slot, the mbarriers (one per ring slot, one for w),
// the rows' cache indices, the pair list, one value per pair (its offset,
// then its score), each row's first pair and first invalid slot, and the
// validity bytes.  kernels/plane_select.py::smem_bytes mirrors it.
struct Layout {
  int slot, w, mbar, rowr, pairs, val, start, gap, vbytes, words;
};

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

__host__ __device__ inline Layout make_layout(int R, int chunk, int d,
                                              int cap, bool w_shared) {
  Layout L;
  L.slot = round4((d < chunk ? d : chunk) + 6);
  int at = kWarps * kStages * L.slot;
  L.w = at;
  if (w_shared) at += round4(d + 6);
  L.mbar = at;
  at += 2 * (kWarps * kStages + 1);
  L.rowr = at;
  at += 2 * R;
  L.pairs = at;
  at += R * cap;
  L.val = at;
  at += R * cap;
  L.start = at;
  at += R + 1;
  L.gap = at;
  at += R;
  L.vbytes = at;
  at += (R * cap + 3) / 4;
  L.words = round4(at);
  return L;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The 16-byte units that hold `len` floats from `src`.
__device__ __forceinline__ void units(const float* src, int len,
                                      const char*& lo, unsigned& bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t b = a + 4 * static_cast<uintptr_t>(len);
  lo = reinterpret_cast<const char*>(a & ~uintptr_t{15});
  const uintptr_t end = (b + 15) & ~uintptr_t{15};
  bytes = static_cast<unsigned>(end - reinterpret_cast<uintptr_t>(lo));
}

// Where `src`'s first float lands in a slot filled from its 16-byte unit.
__device__ __forceinline__ const float* in_slot(const float* slot,
                                                const float* src) {
  return slot + ((reinterpret_cast<uintptr_t>(src) & 15) >> 2);
}

// Stage `len` floats from `src` into `slot` by one bulk copy whose bytes
// `mbar` counts; the phase completes at once when there is nothing to
// copy.  The caller orders the slot's earlier reads before this.
__device__ __forceinline__ void stage(float* slot, const float* src,
                                      int len, unsigned mbar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (len <= 0) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(mbar)
                 : "memory");
    return;
  }
  const char* lo;
  unsigned bytes;
  units(src, len, lo, bytes);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(mbar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(slot)),
      "l"(lo), "r"(bytes), "r"(mbar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned mbar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
}

// acc += <p[0:len], w[0:len]> over lane l's columns l, l+32, ... in
// ascending order with fmaf (plane_scores.cu's order).  Eight columns'
// operands are loaded at a time, so their loads are in flight together
// while the chain keeps its order.
template <bool kWShared>
__device__ __forceinline__ float dot(const float* p, const float* w,
                                     int len, int lane, float acc) {
  auto wv = [&](int j) { return kWShared ? w[j] : __ldg(w + j); };
  int j = lane;
  for (; j + 7 * kWarp < len; j += 8 * kWarp) {
    float x[8], y[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      x[u] = p[j + u * kWarp];
      y[u] = wv(j + u * kWarp);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = fmaf(x[u], y[u], acc);
  }
  for (; j < len; j += kWarp) acc = fmaf(p[j], wv(j), acc);
  return acc;
}

// Compiled for up to 256 threads, though a CTA launches kWarps * 32:
// under a 64-thread bound ptxas schedules the w-staged build ~33 % slower
// on the path (PERF.md, B2).
template <bool kWShared>
__global__ void __launch_bounds__(256)
plane_select_kernel(const Args a) {
  constexpr int W = kWarps, S = kStages;
  extern __shared__ __align__(16) float smem[];
  const int R = a.rows_per_cta, CH = a.chunk;
  const int cap = a.cap, d = a.d;
  const Layout L = make_layout(R, CH, d, cap, kWShared);
  const int tid = threadIdx.x, lane = tid % kWarp;
  // The warp index as a warp-uniform value, so that a branch on it is one.
  const int warp = __shfl_sync(kFull, tid / kWarp, 0);
  const long long b0 = static_cast<long long>(blockIdx.x) * R;
  long long* row_r = reinterpret_cast<long long*>(smem + L.rowr);
  int* pairs = reinterpret_cast<int*>(smem + L.pairs);
  float* val = smem + L.val;
  int* start = reinterpret_cast<int*>(smem + L.start);
  int* gap = reinterpret_cast<int*>(smem + L.gap);
  unsigned char* vb = reinterpret_cast<unsigned char*>(smem + L.vbytes);
  const unsigned mbar0 = smem_addr(smem + L.mbar);
  const unsigned wbar = mbar0 + 8 * W * S;

  // 1. The rows' cache indices; the mbarriers; w's copy.
  if (tid < R) {
    const long long b = b0 + tid;
    long long r = kNoBlock;
    if (b < a.k) {
      r = a.rows != nullptr ? a.rows[b] : b;
      if (r < 0 || r >= a.n) r = kOutside;
    }
    row_r[tid] = r;
  }
  if (tid == 0) {
    for (int i = 0; i <= W * S; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       mbar0 + 8 * i)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (kWShared && tid == 0) stage(smem + L.w, a.w, d, wbar);

  // 2. All validity bytes of the CTA's rows in one round trip.
#pragma unroll 8
  for (int e = tid; e < R * cap; e += W * kWarp) {
    const int t = e / cap;
    const long long r = row_r[t];
    vb[e] = r >= 0 ? a.valid[r * a.v_row + (e - t * cap) * a.v_slot] : 0;
  }
  __syncthreads();

  // 3. Warp 0 packs the valid (row, slot) pairs in row and slot order:
  // row t's pairs are [start[t], start[t+1]), each (t << 16) | slot, and
  // gap[t] is its first invalid slot (cap if none).
  if (warp == 0) {
    int count = 0;
    for (int t = 0; t < R; ++t) {
      if (lane == 0) start[t] = count;
      int g = cap;
      for (int c0 = 0; c0 < cap; c0 += kWarp) {
        const int s = c0 + lane;
        const bool in = s < cap;
        const bool v = in && vb[t * cap + s] != 0;
        const unsigned m = __ballot_sync(kFull, v);
        const unsigned h = __ballot_sync(kFull, in && !v);
        if (g == cap && h != 0u) g = c0 + __ffs(h) - 1;
        if (v) pairs[count + __popc(m & ((1u << lane) - 1u))] = (t << 16) | s;
        count += __popc(m);
      }
      if (lane == 0) gap[t] = g;
    }
    if (lane == 0) start[R] = count;
  }
  __syncthreads();

  // 4. Warp q scores pairs q, q + W, ..., each in `nch` chunks of at most
  // CH columns: its item t is chunk t % nch of its (t / nch)-th pair, in
  // ring slot t % S, that slot's (t / S)-th use.
  const int nv = start[R];
  const int nch = d > CH ? (d + CH - 1) / CH : 1;
  const int mine = nv > warp ? (nv - 1 - warp) / W + 1 : 0;
  const int items = mine * nch;
  float* ring = smem + warp * S * L.slot;
  const unsigned bar = mbar0 + 8 * warp * S;
  auto source = [&](int t, int& q, int& c, int& len) {
    q = warp + (t / nch) * W;
    c = t - (t / nch) * nch;
    len = min(CH, d - c * CH);
    const int pr = pairs[q];
    return a.P + row_r[pr >> 16] * a.p_row +
           static_cast<long long>(pr & 0xffff) * a.p_slot +
           static_cast<long long>(c) * CH;
  };
  auto issue = [&](int t) {
    int q, c, len;
    const float* src = source(t, q, c, len);
    stage(ring + (t % S) * L.slot, src, len, bar + 8 * (t % S));
  };
  if (lane == 0)
    for (int t = 0; t < S - 1 && t < items; ++t) issue(t);
  // The pairs' offsets, while the first copies are in flight.
  for (int q = tid; q < nv; q += W * kWarp) {
    const int pr = pairs[q];
    val[q] = a.off[row_r[pr >> 16] * a.off_row +
                   static_cast<long long>(pr & 0xffff) * a.off_slot];
  }
  __syncthreads();
  if (kWShared) mbar_wait(wbar, 0);
  const float* wv = kWShared ? in_slot(smem + L.w, a.w) : a.w;
  float acc = 0.0f;
  for (int t = 0; t < items; ++t) {
    __syncwarp();  // the warp's reads of slot (t - 1) % S are done
    if (lane == 0 && t + S - 1 < items) issue(t + S - 1);
    int q, c, len;
    const float* src = source(t, q, c, len);
    mbar_wait(bar + 8 * (t % S), (t / S) & 1);
    if (c == 0) acc = 0.0f;
    acc = dot<kWShared>(in_slot(ring + (t % S) * L.slot, src),
                        wv + static_cast<long long>(c) * CH, len, lane, acc);
    if (c == nch - 1) {
      for (int o = kWarp / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(kFull, acc, o);
      if (lane == 0) val[q] = acc + val[q];
    }
  }
  __syncthreads();

  // 5. One warp per row: the first maximum over its pairs, then `neg` at
  // its first invalid slot.
  for (int t = warp; t < R; t += W) {
    const long long b = b0 + t;
    if (b >= a.k) break;
    if (row_r[t] == kOutside) {
      if (lane == 0) {
        a.best[b] = __int_as_float(0x7fc00000);  // NaN
        a.idx[b] = -1;
      }
      continue;
    }
    float bv = 0.0f;
    int bi = -1;  // -1: this lane has seen no pair
    for (int q = start[t] + lane; q < start[t + 1]; q += kWarp) {
      const float v = val[q];
      if (bi < 0 || v > bv) {
        bv = v;
        bi = pairs[q] & 0xffff;
      }
    }
    for (int o = kWarp / 2; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (oi >= 0 && (bi < 0 || ov > bv || (ov == bv && oi < bi))) {
        bv = ov;
        bi = oi;
      }
    }
    const int g = gap[t];
    if (g < cap && (bi < 0 || a.neg > bv || (a.neg == bv && g < bi))) {
      bv = a.neg;
      bi = g;
    }
    if (lane == 0) {
      a.best[b] = bv;
      a.idx[b] = bi;
    }
  }
}

bool plan_ok(int R, int chunk) {
  return R >= 1 && R <= kMaxRows && chunk >= kWarp && chunk % kWarp == 0;
}

// The builds: w staged in shared memory or read through L1.
const repro::Build kBuilds[] = {
    REPRO_BUILD(kSmemLimit, plane_select_kernel<true>),
    REPRO_BUILD(kSmemLimit, plane_select_kernel<false>),
};

}  // namespace

// Shared-memory bytes of a launch (kernels/plane_select.py checks its own
// layout against this on the card).
extern "C" long long plane_select_smem_bytes(int R, int chunk, int d,
                                             int cap, int w_shared) {
  return 4LL * make_layout(R, chunk, d, cap, w_shared != 0).words;
}

// Once, when the library loads (never inside a graph capture): dynamic
// shared memory up to the card's limit for both builds.  Returns a
// cudaError_t.
extern "C" int plane_select_init(void) {
  return static_cast<int>(repro::grant(kBuilds));
}

// One build's attributes (builds.cuh repro::attributes).
extern "C" int plane_select_attributes(int build, int threads,
                                       long long dyn_smem, int cluster,
                                       long long* out) {
  return repro::attributes(kBuilds, build, threads, dyn_smem, cluster, out);
}

// Launches on `stream` with the plan's rows per CTA, columns per chunk and
// w's place, and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for a plan the kernel does not take).
// `rows` may be null (block b reads cache row b); `k` blocks are selected.
extern "C" int plane_select_launch(
    const float* P, long long p_row, long long p_slot, const float* w,
    const float* off, long long off_row, long long off_slot,
    const unsigned char* valid, long long v_row, long long v_slot,
    const long long* rows, int k, int n, int cap, int d, float neg,
    float* best, int* idx, int R, int chunk, int w_shared, void* stream) {
  const long long smem = plane_select_smem_bytes(R, chunk, d, cap, w_shared);
  if (!plan_ok(R, chunk) || cap < 1 || cap > 0xffff || d < 0 || k < 1 ||
      smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{P,     p_row, p_slot, w,    off,  off_row, off_slot,
               valid, v_row, v_slot, rows, best, idx,     k,
               n,     cap,   d,      neg,  R,    chunk};
  const dim3 block(kWarp * kWarps);
  const dim3 grid((k + R - 1) / R);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_shared)
    plane_select_kernel<true><<<grid, block, smem, s>>>(a);
  else
    plane_select_kernel<false><<<grid, block, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
