// One whole approximate pass of MP-BCFW (paper Alg. 3 step 4) in one
// launch, written by hand for Hopper (sm_90a).
//
// Not a port of a TPU kernel: the reference runs the pass as a lax.scan
// over blocks inside the lax.while_loop of repro/core/mpbcfw.py
// (multi_approx_pass), one XLA program per batch of passes.  The port's
// eager version of the same pass (core/mpbcfw.py::eager_pass) enqueues
// ~37 small ops per block (~550 in the Sec-3.5 mode), so a pass was bound
// by host launch overhead.  Here the whole pass is one launch.
//
// For each block i of `perm`, in order (all state updated in place):
//   plain mode (steps == 0), as core/mpbcfw.py's eager pass:
//     w = -phi*/lam; score block i's valid cached planes <p*, w> + p_o and
//     take the first maximum (an empty set gives the zero plane, slot 0);
//     exact line search and block update (core/bcfw.py::block_update);
//     last_active[i, slot] = outer_it;
//   Sec-3.5 mode (steps > 0), as core/gram.py::multi_step_block_update:
//     a = P_i* phi*, b = P_i* phi_i*, c = |phi_i*|^2, e = <phi_i*, phi*>,
//     `steps` scalar recurrences over the block's Gram leaf, then
//     phi_i' = beta0 phi_i + beta P_i, phi' = phi + (phi_i' - phi_i), and
//     last_active = outer_it on every slot the recurrence picked;
//   and then one averaging step bar = k/(k+2) bar + 2/(k+2) phi, with
//   k = k0 + k_stride * (position of i in perm) (core/averaging.py).  The
//   stride is 1 on one device; a rank of S walking its share of the
//   blocks in step with S - 1 others advances the count by S per block
//   (shard/engine.py), as the reference's sharded pass does.  A stride
//   other than 1 runs builds of its own (kStride), the stride a kernel
//   parameter after Args that the stride-1 builds do not read: with the
//   stride a field of Args, or read by every build, ptxas gave the
//   stride-1 builds other registers and the plain pass ran 5.5-7 % slower
//   on an H100.
// A `go` flag (device bool, may be null) gates the launch: false returns
// at once, so a batch of passes queued behind the slope rule's on-device
// flag runs only the passes the rule allows.  In the plain mode a `gap`
// vector (float32 (n,), may be null) takes each visited block's gap
// estimate, the cache's underestimate of its duality gap, as
// core/mpbcfw.py's eager pass computes it: gap[i] = max(s - (<phi_i*, w>
// + phi_i o), 0) at the block's w, with s the chosen plane's score (0 for
// an empty set) and phi_i the row before its update.  The extra dot
// product runs on the warp with the fewest rows to score, beside them,
// and writes nothing else.  The gap output is a build of its own (the
// kGap flag of the plain mode's kernels, the vector a parameter after
// Args): a launch without it runs the kernel that has none.
//
// Bound.  A pass reads each visited block's valid planes, its phi_i row
// (read and written) and, in the Sec-3.5 mode, its Gram leaf: ~16 KB x
// (2 + valid planes) per block at d = 4004, ~0.46 GB per full-size OCR
// pass, 0.14 ms at 3.35 TB/s.  In practice it is latency bound: the blocks
// depend on each other through phi, so the pass is sequential, and each
// block is a few dependent chains (a 125-long fmaf chain per scored row,
// the Sec-3.5 recurrence) and barriers on one SM.
//
// Design: one CTA of 512 threads walks the permutation, with phi in
// shared memory and the average in registers (element j = tid + k * 512
// of thread tid, the only mapping that touches it); both go back to
// device memory once, at the end.  Each mode and each count of average
// elements per thread is its own build.  512 threads give each thread up
// to 128 registers (1024 would cap it at 64), so the pass's state does
// not spill to local memory, which the 227 KB of staged shared memory
// leaves no L1 to cache.
//
// What a block reads from device memory does not depend on phi, so it is
// staged a block ahead (plan: kernels/approx_pass.py::plan).  Shared
// memory holds two buffers (one when two do not fit; then a block's copies
// are issued just before it); each holds a block's phi_i row, its first
// `rows` valid plane rows and, in the Sec-3.5 mode, its Gram leaf.  At the
// top of block t one thread of the last warp issues block t+1's copies as
// Hopper bulk copies (the TMA engine's cp.async.bulk, one per row, done
// when the buffer's mbarrier has counted their bytes), so the copies
// neither wait on nor occupy the threads that compute block t.  A bulk
// copy moves whole 16-byte units between 16-byte-aligned addresses, and
// rows of d+1 = 4005 floats start at any 4-byte offset: each copy covers
// its row rounded out to 16 bytes (never past the row's aligned 16-byte
// units, so never off its page), into a slot 6 floats longer than the row,
// and the row is read at its own offset within the slot.  The same warp
// reads block t+2's validity at the top of block t, turns it into a list
// of valid slots at the end, and asks L2 for block t+2's rows then (a
// bulk prefetch), so block t+1's copies can be issued at once and find
// their rows in L2; block ids are read three ahead, and the next block's
// averaging weights are taken there too.  Scores, the line search, the
// recurrences and the update read the staged copies; phi_i[i] is written
// back once.  A block with more valid planes than staged rows streams the
// rest from device memory in the same lane order (shape-driven, not a
// fallback).
//
// Plain mode, per block: one warp per valid row takes, in one
// lane-strided pass, the row's score and the line search's two sums
// should the row be chosen (<phi_i* - p*, phi*>, |phi_i* - p*|^2); after
// one barrier, warp 0 picks the first maximum and the step size, and
// after a second all threads update.  Sec-3.5 mode: one warp per valid
// row takes a and b, the last warp c and e; then warp 0 runs the `steps`
// recurrences with each lane's slots (l, l+32, ...) in registers, the
// first maximum by two warp reductions; then all threads mix phi_i' from
// the staged rows.
//
// A block may repeat within the prefetch distance (no path does so today:
// perm is a permutation).  Only phi_i changes in a pass, so a block that
// comes again in the next buffer's turn (distance 1) gets its new phi_i
// row written straight into that buffer, and a block that comes again in
// its own buffer's next turn (distance 2, or 1 with one buffer) keeps its
// buffer, updated in place, and stages nothing; any later repeat is staged
// after the rewrite and the barriers between.
//
// Shapes past what shared memory and the builds hold (d + 1 > 20,480, a
// fixed part or one buffer past 227 KB, Sec-3.5 caps past 256) take the
// wide plan: approx_pass_wide_kernel below, the same pass with phi, the
// average and the per-slot scratch in device memory (see there).
//
// Every dot product is lane-strided in one warp (lane l sums columns l,
// l+32, ... with fmaf, then the fixed xor butterfly), so a pass is
// deterministic, and scores are plane_scores.cu's: equal planes score
// bit-equally and the first maximum wins, as in the eager pass.  Where
// the eager pass rounds twice (a*x + b*y as two products and a sum), the
// kernel uses __fmul_rn/__fadd_rn so that nvcc does not contract it into
// one FMA.  The line-search sums (and c, e) reduce in another order than
// cuBLAS's: the kernel and the eager pass agree to ~1e-6 relative, not bit
// for bit.  w_j is (-phi_j) * fl32(1/lam), the reciprocal taken in
// double: the eager op's form on the card (PyTorch multiplies by the
// reciprocal for a scalar divisor).
#include <cuda_runtime.h>

#include <cstdint>

#include "builds.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;   // kernels/ref.py INVALID_SCORE
constexpr int kSmemLimit = repro::kSmemLimit;   // what a CTA may opt into
constexpr int kIdRing = 8;     // block ids, read three blocks ahead
constexpr int kMetaRing = 4;   // valid-slot lists, built two blocks ahead
constexpr int kMaskChunks = 4; // validity held in registers: cap <= 128
constexpr int kLoader = kWarps - 1;  // the warp that reads ahead
// The most elements of d + 1 a launch takes: the kernel is built for 8,
// 16, 24 and 40 elements of the average per thread, and a launch takes
// the smallest count that covers d + 1 (kernels/approx_pass.py::MAX_D1).
constexpr int kMaxD1 = 40 * kThreads;

struct Args {
  float* phi;                  // (d+1,)
  float* phi_i;                // (n, d+1)
  float* bar;                  // (d+1,)
  const float* planes;         // (n, cap, d+1)
  const bool* valid;           // (n, cap)
  int* last_active;            // (n, cap)
  const float* gram;           // (n, cap, cap) or null
  const long long* perm;       // (n_perm,)
  const bool* go;              // () or null
  long long n;
  int n_perm, cap, d, steps, outer_it, rows, nbuf;
  float lam, inv_lam;
  long long k0;
};

// Words of a slot that takes `len` floats at any 4-byte offset, rounded
// out to 16 bytes: 6 more, in whole 16-byte units.
__host__ __device__ constexpr long long slot_words(long long len) {
  return (len + 6 + 3) / 4 * 4;
}

// Shared-memory layout in 4-byte words, the same on host and device
// (kernels/approx_pass.py::plan mirrors it).  Every buffer starts on a
// 16-byte boundary.
struct Layout {
  int ids;     // long long [kIdRing]
  int mbar;    // 8-byte mbarrier [2]
  int rowp;    // const float* [cap]: rows phi_i' mixes in
  int scal;    // float [8]: per-block scalars
  int wts;     // float [2][2]: averaging weights, by block parity
  int a, b, beta, off;   // float [cap]
  int mix;     // int [cap]: slots phi_i' mixes in
  int meta;    // int [kMetaRing][2 * cap + 1]: pos, list, count
  int vec;     // float [d+1]: phi
  int buf;     // nbuf buffers of buf_words
  int row;     // words of a row slot (phi_i and planes)
  int buf_words;   // phi_i slot, `rows` row slots, the Gram leaf's slot
  long long total;
};

__host__ __device__ inline Layout make_layout(long long d1, long long cap,
                                              int steps, long long rows,
                                              int nbuf) {
  Layout l;
  long long w = 0;
  auto take = [&w](long long words) {
    const long long at = w;
    w += words;
    return static_cast<int>(at);
  };
  l.ids = take(2 * kIdRing);
  l.mbar = take(4);
  l.rowp = take(2 * cap);
  l.scal = take(8);
  l.wts = take(4);
  l.a = take(cap);
  l.b = take(cap);
  l.beta = take(cap);
  l.off = take(cap);
  l.mix = take(cap);
  l.meta = take(kMetaRing * (2 * cap + 1));
  l.vec = take(d1);
  w = (w + 3) / 4 * 4;
  l.row = static_cast<int>(slot_words(d1));
  const long long buf_words =
      slot_words(d1) * (1 + rows) + (steps > 0 ? slot_words(cap * cap) : 0);
  l.buf_words = static_cast<int>(buf_words);
  l.buf = take(nbuf * buf_words);
  l.total = w;
  return l;
}

__device__ __forceinline__ float minus_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The slot of the first maximum over (score, slot) pairs held one per
// lane (the larger score, then the lower slot), by two warp reductions:
// the largest score as an order-preserving integer key (-0 taken as +0,
// so equal floats have equal keys), then the lowest slot holding it.
__device__ __forceinline__ int warp_first_max(float best, int slot) {
  const float v = best == 0.0f ? 0.0f : best;
  const int bits = __float_as_int(v);
  const int key = bits >= 0 ? bits : bits ^ 0x7fffffff;
  const int top = __reduce_max_sync(kFull, key);
  return static_cast<int>(__reduce_min_sync(
      kFull, key == top ? static_cast<unsigned>(slot) : 0xffffffffu));
}

// The averaging weights k/(k+2), 2/(k+2) from a float32 k, in float32.
__device__ __forceinline__ void avg_weights(long long k, float& a, float& b) {
  const float kf = __ll2float_rn(k);
  const float den = __fadd_rn(kf, 2.0f);
  a = __fdiv_rn(kf, den);
  b = __fdiv_rn(2.0f, den);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The 16-byte units that hold `len` floats from `src`.
__device__ __forceinline__ void units(const float* src, long long len,
                                      const char*& lo, unsigned& bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t b = a + 4 * static_cast<uintptr_t>(len);
  lo = reinterpret_cast<const char*>(a & ~uintptr_t{15});
  const uintptr_t end = (b + 15) & ~uintptr_t{15};
  bytes = static_cast<unsigned>(end - reinterpret_cast<uintptr_t>(lo));
}

// Where `src`'s first float lands in a slot filled from its 16-byte unit.
__device__ __forceinline__ float* in_slot(float* slot, const float* src) {
  return slot + ((reinterpret_cast<uintptr_t>(src) & 15) >> 2);
}

// One bulk copy of `len` floats from `src` into `slot`, counted by `mbar`.
__device__ __forceinline__ void bulk_copy(float* slot, const float* src,
                                          long long len, unsigned mbar) {
  const char* lo;
  unsigned bytes;
  units(src, len, lo, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(slot)),
      "l"(lo), "r"(bytes), "r"(mbar)
      : "memory");
}

__device__ __forceinline__ unsigned bulk_bytes(const float* src,
                                               long long len) {
  const char* lo;
  unsigned bytes;
  units(src, len, lo, bytes);
  return bytes;
}

__device__ __forceinline__ void prefetch_l2(const float* src, long long len) {
  const char* lo;
  unsigned bytes;
  units(src, len, lo, bytes);
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(lo),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned mbar, unsigned bytes) {
  if (bytes > 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(mbar), "r"(bytes)
                 : "memory");
  else
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(mbar)
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

// The dot products below run lane-strided over one warp: lane l takes
// columns l, l+32, ... in that order with fmaf, then the xor butterfly
// (plane_scores.cu's order).  They load eight columns' operands at a
// time, so the loads are in flight together while each chain keeps its
// order.

// One valid row p of the plain mode: its score <p*, w> + p_o (w_j =
// -phi_j * fl32(1/lam), formed here from phi), and what the line search
// needs should the row be chosen: <phi_i* - p*, phi*> and
// |phi_i* - p*|^2.
__device__ __forceinline__ void plain_row(const float* p, const float* phi,
                                          const float* pi, int d, int lane,
                                          float inv_lam, float& s,
                                          float& num, float& den) {
  float acc = 0.0f, nu = 0.0f, de = 0.0f;
  auto one = [&](float x, float f, float q) {
    acc = fmaf(x, __fmul_rn(-f, inv_lam), acc);
    const float df = __fsub_rn(q, x);
    nu = fmaf(df, f, nu);
    de = fmaf(df, df, de);
  };
  int j = lane;
  for (; j + 7 * kWarp < d; j += 8 * kWarp) {
    float x[8], f[8], q[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      x[u] = p[j + u * kWarp];
      f[u] = phi[j + u * kWarp];
      q[u] = pi[j + u * kWarp];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) one(x[u], f[u], q[u]);
  }
  for (; j < d; j += kWarp) one(p[j], phi[j], pi[j]);
  s = warp_sum(acc) + p[d];
  num = warp_sum(nu);
  den = warp_sum(de);
}

// <p*, w> + p_o alone (w_j = -phi_j * fl32(1/lam)): plain_row's score,
// for the gap output's <phi_i*, w> + phi_i o.
__device__ __forceinline__ float score_row(const float* p, const float* phi,
                                           int d, int lane, float inv_lam) {
  float acc = 0.0f;
  int j = lane;
  for (; j + 7 * kWarp < d; j += 8 * kWarp) {
    float x[8], f[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      x[u] = p[j + u * kWarp];
      f[u] = phi[j + u * kWarp];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      acc = fmaf(x[u], __fmul_rn(-f[u], inv_lam), acc);
  }
  for (; j < d; j += kWarp) acc = fmaf(p[j], __fmul_rn(-phi[j], inv_lam), acc);
  return warp_sum(acc) + p[d];
}

// <phi_i*, phi*> and |phi_i*|^2: the line search against the zero plane
// (plain mode), e and c of the Sec-3.5 recurrence.
__device__ __forceinline__ void self_dots(const float* pi, const float* phi,
                                          int d, int lane, float& e,
                                          float& c) {
  float ev = 0.0f, cv = 0.0f;
  int j = lane;
  for (; j + 7 * kWarp < d; j += 8 * kWarp) {
    float q[8], f[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      q[u] = pi[j + u * kWarp];
      f[u] = phi[j + u * kWarp];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      ev = fmaf(q[u], f[u], ev);
      cv = fmaf(q[u], q[u], cv);
    }
  }
  for (; j < d; j += kWarp) {
    const float q = pi[j];
    ev = fmaf(q, phi[j], ev);
    cv = fmaf(q, q, cv);
  }
  e = warp_sum(ev);
  c = warp_sum(cv);
}

// a = <p*, phi*>, b = <p*, phi_i*> (cache.row_dots: plus a zero offset).
__device__ __forceinline__ void dots_row(const float* p, const float* phi,
                                         const float* pi, int d, int lane,
                                         float& av, float& bv) {
  av = 0.0f;
  bv = 0.0f;
  int j = lane;
  for (; j + 7 * kWarp < d; j += 8 * kWarp) {
    float x[8], y[8], z[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      x[u] = p[j + u * kWarp];
      y[u] = phi[j + u * kWarp];
      z[u] = pi[j + u * kWarp];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      av = fmaf(x[u], y[u], av);
      bv = fmaf(x[u], z[u], bv);
    }
  }
  for (; j < d; j += kWarp) {
    const float pj = p[j];
    av = fmaf(pj, phi[j], av);
    bv = fmaf(pj, pi[j], bv);
  }
  av = warp_sum(av) + 0.0f;
  bv = warp_sum(bv) + 0.0f;
}

// The Sec-3.5 recurrences of one block (core/gram.py), in one warp: lane
// l owns slots l, l+32, ... (kQ of them, cap <= 32 kQ) and keeps their a,
// b, beta and offset in registers, so a step touches shared memory only
// for the Gram leaf's row h.  a, b and the offsets come in by slot (0
// for invalid slots); beta goes out by slot, with beta0 as the return
// value.  Stamps the slots it picks.  Each update is the one
// core/gram.py::multi_step_block_update takes, in its order of roundings.
template <int kQ>
__device__ __forceinline__ float recurrence(
    const int* pos, const float* s_a, const float* s_b, const float* s_off,
    const float* s_g, float* s_beta, int cap, int steps, float lam, float e,
    float c, float oi, int* stamps, int outer_it, int lane) {
  float a[kQ], b[kQ], be[kQ], off[kQ];
  bool v[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int r = lane + q * kWarp;
    v[q] = r < cap && pos[r] >= 0;
    a[q] = r < cap ? s_a[r] : 0.0f;
    b[q] = r < cap ? s_b[r] : 0.0f;
    off[q] = v[q] ? s_off[r] : 0.0f;
    be[q] = 0.0f;
  }
  float beta0 = 1.0f;
  for (int step = 0; step < steps; ++step) {
    float best = minus_inf();
    int h = cap;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      // (An invalid slot divides 1, not its unused a, so no division
      // leaves the fast path for a zero numerator.)
      const float sr = __fsub_rn(off[q], __fdiv_rn(v[q] ? a[q] : 1.0f, lam));
      const float s = v[q] ? sr : kNeg;
      if (lane + q * kWarp < cap && s > best) {
        best = s;
        h = lane + q * kWarp;
      }
    }
    h = warp_first_max(best, h);
    const int hq = h / kWarp, hl = h % kWarp;
    float ah = a[0], bh = b[0], ch = off[0];
#pragma unroll
    for (int q = 1; q < kQ; ++q)
      if (hq == q) {
        ah = a[q];
        bh = b[q];
        ch = off[q];
      }
    ah = __shfl_sync(kFull, ah, hl);
    bh = __shfl_sync(kFull, bh, hl);
    ch = __shfl_sync(kFull, ch, hl);
    const float* gh_row = s_g + h;   // G[r, h] at gh_row[r * cap]
    const float ghh = gh_row[h * cap];
    float gh[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int r = lane + q * kWarp;
      gh[q] = r < cap ? gh_row[r * cap] : 0.0f;
    }
    const float num = __fsub_rn(__fsub_rn(e, ah),
                                __fmul_rn(lam, __fsub_rn(oi, ch)));
    const float den = __fadd_rn(__fsub_rn(c, __fmul_rn(2.0f, bh)), ghh);
    float g = den > 0.0f ? __fdiv_rn(num, fmaxf(den, 1e-30f)) : 0.0f;
    g = fminf(fmaxf(g, 0.0f), 1.0f);
    const float omg = __fsub_rn(1.0f, g);
    const float e_new = __fadd_rn(
        __fmul_rn(omg, __fadd_rn(e, __fmul_rn(g, __fsub_rn(bh, c)))),
        __fmul_rn(g, __fadd_rn(ah, __fmul_rn(g, __fsub_rn(ghh, bh)))));
    const float c_new = __fadd_rn(
        __fadd_rn(__fmul_rn(__fmul_rn(omg, omg), c),
                  __fmul_rn(__fmul_rn(__fmul_rn(2.0f, g), omg), bh)),
        __fmul_rn(__fmul_rn(g, g), ghh));
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      a[q] = __fadd_rn(a[q], __fmul_rn(g, __fsub_rn(gh[q], b[q])));
      b[q] = __fadd_rn(__fmul_rn(omg, b[q]), __fmul_rn(g, gh[q]));
      be[q] = __fmul_rn(omg, be[q]);
      if (lane + q * kWarp == h) be[q] = __fadd_rn(be[q], g);
    }
    // The slot was returned by the approximate oracle.
    if (lane == 0) stamps[h] = outer_it;
    e = e_new;
    c = c_new;
    oi = __fadd_rn(__fmul_rn(omg, oi), __fmul_rn(g, ch));
    beta0 = __fmul_rn(omg, beta0);
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    if (lane + q * kWarp < cap) s_beta[lane + q * kWarp] = be[q];
  __syncwarp();
  return beta0;
}

// One warp turns a block's validity (one flag per slot) into pos[slot]
// (index among the valid slots, -1 if invalid), list[k] (the k-th valid
// slot) and the count.  `flag(c)` gives the lane's flag for chunk c.
template <typename Flag>
__device__ __forceinline__ void compact(int* meta, int cap, int lane,
                                        Flag flag) {
  int* pos = meta;
  int* list = meta + cap;
  int count = 0;
  for (int c = 0; c * kWarp < cap; ++c) {
    const int r = c * kWarp + lane;
    const bool v = r < cap && flag(c);
    const unsigned m = __ballot_sync(kFull, v);
    const int at = count + __popc(m & ((1u << lane) - 1u));
    if (r < cap) pos[r] = v ? at : -1;
    if (v) list[at] = r;
    count += __popc(m);
  }
  if (lane == 0) meta[2 * cap] = count;
}

template <int NJ, bool kSec35, bool kGap, bool kStride>
__global__ void __launch_bounds__(kThreads, 1)
approx_pass_kernel(const Args args, float* gap, long long k_stride) {
  if (args.go != nullptr && !*args.go) return;
  extern __shared__ __align__(16) float smem[];
  const int d1 = args.d + 1, d = args.d, cap = args.cap;
  const int R = args.rows, NB = args.nbuf, n_perm = args.n_perm;
  const Layout ly = make_layout(d1, cap, args.steps, R, NB);
  long long* s_id = reinterpret_cast<long long*>(smem + ly.ids);
  const float** s_rowp = reinterpret_cast<const float**>(smem + ly.rowp);
  float* s_a = smem + ly.a;
  int* s_meta = reinterpret_cast<int*>(smem + ly.meta);
  float* s_vec = smem + ly.vec;   // phi
  const unsigned mbar0 = smem_addr(smem + ly.mbar);
  const int tid = threadIdx.x, lane = tid % kWarp;
  // The warp index as a warp-uniform value, so that a branch on it is one
  // (the bulk copies' issue stays out of the other warps' paths).
  const int warp = __shfl_sync(kFull, tid / kWarp, 0);
  float* s_wts = smem + ly.wts;
  const float lam = args.lam, inv_lam = args.inv_lam;
  const long long n = args.n;

  auto in_range = [n](long long i) { return i >= 0 && i < n; };
  auto id_of = [&](int u) { return s_id[u & (kIdRing - 1)]; };
  auto meta_of = [&](int u) {
    return s_meta + (u & (kMetaRing - 1)) * (2 * cap + 1);
  };
  auto buffer = [&](int u) {
    return smem + ly.buf + (NB == 2 ? (u & 1) : 0) * ly.buf_words;
  };
  auto mbar_of = [&](int u) { return mbar0 + 8 * (NB == 2 ? (u & 1) : 0); };
  auto plane = [&](long long i, int r) {
    return args.planes + (i * cap + r) * static_cast<long long>(d1);
  };
  auto gram_of = [&](long long i) {
    return args.gram + i * static_cast<long long>(cap) * cap;
  };

  // Stage block u (one thread): phi_i row, first R valid rows and in the
  // Sec-3.5 mode the Gram leaf, as bulk copies; the buffer's mbarrier
  // completes its phase for block u once their bytes have landed (at
  // once if there is nothing to copy).
  auto stage = [&](int u) {
    const long long i = id_of(u);
    const unsigned mbar = mbar_of(u);
    // Nothing to copy for a skipped block, or if the buffer still holds
    // block i, kept current by block u - NB.
    if (!in_range(i) || (u >= NB && id_of(u - NB) == i)) {
      mbar_arrive(mbar, 0);
      return;
    }
    float* B = buffer(u);
    const int* meta = meta_of(u);
    const int* list = meta + cap;
    const int nr = min(meta[2 * cap], R);
    // Distance 1 with two buffers: block u-1 writes the new phi_i here.
    const bool own_pi = !(NB == 2 && u >= 1 && id_of(u - 1) == i);
    const float* pi_src = args.phi_i + i * d1;
    unsigned bytes = own_pi ? bulk_bytes(pi_src, d1) : 0;
    for (int k = 0; k < nr; ++k) bytes += bulk_bytes(plane(i, list[k]), d1);
    if (kSec35) bytes += bulk_bytes(gram_of(i), cap * cap);
    // The buffer was last read and written by the threads (generic
    // proxy); order that before the bulk copies (async proxy) refill it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(mbar, bytes);
    if (own_pi) bulk_copy(B, pi_src, d1, mbar);
    for (int k = 0; k < nr; ++k)
      bulk_copy(B + ly.row * (1 + k), plane(i, list[k]), d1, mbar);
    if (kSec35)
      bulk_copy(B + ly.row * (1 + R), gram_of(i), cap * cap, mbar);
  };

  // phi into shared memory, the average into registers.
  float bar_r[NJ];
#pragma unroll
  for (int k = 0; k < NJ; ++k) {
    const int j = tid + k * kThreads;
    bar_r[k] = 0.0f;
    if (j < d1) {
      s_vec[j] = args.phi[j];
      bar_r[k] = args.bar[j];
    }
  }
  // Prologue: the mbarriers, ids of blocks 0-2, the valid lists of
  // blocks 0 and 1.
  if (tid == 0) {
    for (int b = 0; b < NB; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       mbar0 + 8 * b)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 3) s_id[tid] = tid < n_perm ? args.perm[tid] : -1;
  if (tid == 0) avg_weights(args.k0, s_wts[0], s_wts[1]);
  __syncthreads();
  if (warp < 2) {
    const long long i = s_id[warp];
    const bool ok = warp < n_perm && in_range(i);
    const bool* V = args.valid + (ok ? i * cap : 0);
    compact(meta_of(warp), cap, lane,
            [&](int c) { return ok && V[c * kWarp + lane]; });
  }
  __syncthreads();
  if (NB == 2 && warp == kLoader && lane == 0) stage(0);

  for (int t = 0; t < n_perm; ++t) {
    if (NB == 1) {   // one buffer: block t-1 is done with it first
      __syncthreads();
      if (warp == kLoader && lane == 0) stage(t);
    }
    mbar_wait(mbar_of(t), (NB == 2 ? t >> 1 : t) & 1);
    __syncthreads();
    if (NB == 2 && t + 1 < n_perm && warp == kLoader && lane == 0)
      stage(t + 1);

    // The loader warp reads ahead: block t+2's validity, block t+3's id.
    bool vreg[kMaskChunks];
    long long next_id = -1;
    if (warp == kLoader) {
      const long long i2 = t + 2 < n_perm ? id_of(t + 2) : -1;
      const bool* V = args.valid + (in_range(i2) ? i2 * cap : 0);
#pragma unroll
      for (int c = 0; c < kMaskChunks; ++c) {
        const int r = c * kWarp + lane;
        vreg[c] = in_range(i2) && r < cap && V[r];
      }
      if (lane == 0 && t + 3 < n_perm) next_id = args.perm[t + 3];
    }

    const long long i = id_of(t);
    const float wa = s_wts[2 * (t & 1)], wb = s_wts[2 * (t & 1) + 1];
    if (in_range(i)) {
      float* B = buffer(t);
      float* pi = in_slot(B, args.phi_i + i * d1);   // the staged row
      const int* meta = meta_of(t);
      const int* pos = meta;
      const int* list = meta + cap;
      const int nv = meta[2 * cap];
      float* pi_row = args.phi_i + i * d1;
      // Where the new phi_i row also goes: this buffer, if block i comes
      // again in its next turn; the other one, if it comes next.
      const bool keep = t + NB < n_perm && id_of(t + NB) == i;
      float* also = (NB == 2 && t + 1 < n_perm && id_of(t + 1) == i)
                        ? in_slot(buffer(t + 1), pi_row)
                        : nullptr;
      // Valid row r at its index k < R among the valid slots, staged;
      // row_at: staged or streamed.
      auto staged = [&](int k, int r) -> const float* {
        return in_slot(B + ly.row * (1 + k), plane(i, r));
      };
      auto row_at = [&](int k, int r) -> const float* {
        return k < R ? staged(k, r) : plane(i, r);
      };

      if (!kSec35) {
        // -- plain mode: score, first argmax, exact line search ----------
        // One warp per valid row: its score and its line-search sums
        // (s_a, s_b, s_beta, s_off by index among the valid rows); with
        // no valid row, warp 0 takes the zero plane's.
        float* s_num = smem + ly.b;
        float* s_den = smem + ly.beta;
        float* s_off = smem + ly.off;
        float* s_scal = smem + ly.scal;
        for (int k = warp; k < nv; k += kWarps) {
          const int r = list[k];
          float sc, nu, de;
          if (k < R)
            plain_row(staged(k, r), s_vec, pi, d, lane, inv_lam, sc, nu, de);
          else
            plain_row(plane(i, r), s_vec, pi, d, lane, inv_lam, sc, nu, de);
          if (lane == 0) {
            s_a[k] = sc;
            s_num[k] = nu;
            s_den[k] = de;
            s_off[k] = row_at(k, r)[d];
          }
        }
        if (nv == 0 && warp == 0) {
          float e0, c0;
          self_dots(pi, s_vec, d, lane, e0, c0);
          if (lane == 0) {
            s_scal[0] = e0;
            s_scal[1] = c0;
          }
        }
        // The gap output's score of the staged phi_i row, before it is
        // rewritten, on a warp with the fewest rows.
        if (kGap && warp == nv % kWarps) {
          const float sw = score_row(pi, s_vec, d, lane, inv_lam);
          if (lane == 0) s_scal[4] = sw;
        }
        __syncthreads();
        // Warp 0 picks the row and the step size for all: the first
        // maximum over the valid rows in slot order (a valid plane scores
        // far above the invalid marker kNeg, so this is the eager pass's
        // first maximum over all slots), the zero plane in slot 0 if there
        // is none, and the exact line search.
        if (warp == 0) {
          float best = minus_inf();
          int kb = 0;
          for (int k = 0; k < nv; ++k) {
            const float sc = s_a[k];
            if (sc > best) {
              best = sc;
              kb = k;
            }
          }
          const bool any = nv > 0;
          const float dot = any ? s_num[kb] : s_scal[0];
          const float den = any ? s_den[kb] : s_scal[1];
          const float diff_o = __fsub_rn(pi[d], any ? s_off[kb] : 0.0f);
          const float num = __fsub_rn(dot, __fmul_rn(lam, diff_o));
          float g = den > 0.0f ? __fdiv_rn(num, fmaxf(den, 1e-30f)) : 0.0f;
          g = fminf(fmaxf(g, 0.0f), 1.0f);
          if (lane == 0) {
            s_scal[2] = __int_as_float(any ? kb : -1);
            s_scal[3] = g;
            args.last_active[i * cap + (any ? list[kb] : 0)] = args.outer_it;
            if (kGap)
              gap[i] =
                  fmaxf(__fsub_rn(any ? s_a[kb] : 0.0f, s_scal[4]), 0.0f);
          }
        }
        __syncthreads();
        const int kb = __float_as_int(s_scal[2]);
        const float g = s_scal[3];
        const bool any = kb >= 0;
        const float omg = __fsub_rn(1.0f, g);
        // The chosen row (phi_i's own staged row stands in, unread, for
        // the zero plane, so the loads need no branch).
        const float* ph = any ? row_at(kb, list[kb]) : pi;
#pragma unroll
        for (int k = 0; k < NJ; ++k) {
          const int j = tid + k * kThreads;
          if (j < d1) {
            const float pij = pi[j];
            const float h = ph[j];
            const float hj = any ? h : 0.0f;
            const float npi =
                __fadd_rn(__fmul_rn(omg, pij), __fmul_rn(g, hj));
            const float p = __fadd_rn(s_vec[j], __fsub_rn(npi, pij));
            pi_row[j] = npi;
            if (keep) pi[j] = npi;
            if (also != nullptr) also[j] = npi;
            s_vec[j] = p;
            bar_r[k] = __fadd_rn(__fmul_rn(wa, bar_r[k]), __fmul_rn(wb, p));
          }
        }
      } else if (nv == 0) {
        // -- Sec-3.5 mode, no cached plane: the recurrence takes no step
        // (g = 0 throughout), phi and phi_i stay; only the average moves.
#pragma unroll
        for (int k = 0; k < NJ; ++k) {
          const int j = tid + k * kThreads;
          if (j < d1) {
            bar_r[k] = __fadd_rn(__fmul_rn(wa, bar_r[k]),
                                 __fmul_rn(wb, s_vec[j]));
            if (also != nullptr) also[j] = pi[j];
          }
        }
      } else {
        // -- Sec-3.5 mode: Gram recurrences, then one materialisation ----
        float* s_b = smem + ly.b;
        float* s_beta = smem + ly.beta;
        float* s_off = smem + ly.off;
        int* s_mix = reinterpret_cast<int*>(smem + ly.mix);
        float* s_scal = smem + ly.scal;
        const float* s_g = in_slot(B + ly.row * (1 + R), gram_of(i));
        for (int r = tid; r < cap; r += kThreads)
          if (pos[r] < 0) {
            s_a[r] = 0.0f;
            s_b[r] = 0.0f;
          }
        for (int k = warp; k < nv; k += kWarps) {
          const int r = list[k];
          float av, bv;
          if (k < R)
            dots_row(staged(k, r), s_vec, pi, d, lane, av, bv);
          else
            dots_row(plane(i, r), s_vec, pi, d, lane, av, bv);
          if (lane == 0) {
            s_a[r] = av;
            s_b[r] = bv;
            s_off[r] = row_at(k, r)[d];
          }
        }
        // c and e: the last warp, after any row of its own.
        if (warp == kLoader) {
          float e0, c0;
          self_dots(pi, s_vec, d, lane, e0, c0);
          if (lane == 0) {
            s_scal[2] = e0;
            s_scal[3] = c0;
          }
        }
        __syncthreads();
        if (warp == 0) {
          const float e = s_scal[2], c = s_scal[3], oi = pi[d];
          int* stamps = args.last_active + i * cap;
          const float beta0 =
              cap <= 2 * kWarp
                  ? recurrence<2>(pos, s_a, s_b, s_off, s_g, s_beta, cap,
                                  args.steps, lam, e, c, oi, stamps,
                                  args.outer_it, lane)
                  : recurrence<8>(pos, s_a, s_b, s_off, s_g, s_beta, cap,
                                  args.steps, lam, e, c, oi, stamps,
                                  args.outer_it, lane);
          // The rows phi_i' mixes in: those with a non-zero coefficient,
          // staged or streamed.
          int count = 0;
          for (int base = 0; base < cap; base += kWarp) {
            const int r = base + lane;
            const bool nz = r < cap && s_beta[r] != 0.0f;
            const unsigned m = __ballot_sync(kFull, nz);
            if (nz) {
              const int q = count + __popc(m & ((1u << lane) - 1u));
              s_mix[q] = r;
              s_rowp[q] = row_at(pos[r], r);
            }
            count += __popc(m);
          }
          if (lane == 0) {
            s_scal[0] = beta0;
            s_scal[1] = __int_as_float(count);
          }
        }
        __syncthreads();
        const float beta0 = s_scal[0];
        const int count = __float_as_int(s_scal[1]);
        float mix[NJ];
#pragma unroll
        for (int k = 0; k < NJ; ++k) mix[k] = 0.0f;
        for (int q = 0; q < count; ++q) {   // rows in slot order, as before
          const float bq = s_beta[s_mix[q]];
          const float* row = s_rowp[q];
#pragma unroll
          for (int k = 0; k < NJ; ++k) {
            const int j = tid + k * kThreads;
            if (j < d1) mix[k] = fmaf(bq, row[j], mix[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < NJ; ++k) {
          const int j = tid + k * kThreads;
          if (j < d1) {
            const float pij = pi[j];
            const float npi = __fadd_rn(__fmul_rn(beta0, pij), mix[k]);
            const float p = __fadd_rn(s_vec[j], __fsub_rn(npi, pij));
            pi_row[j] = npi;
            if (keep) pi[j] = npi;
            if (also != nullptr) also[j] = npi;
            s_vec[j] = p;
            bar_r[k] = __fadd_rn(__fmul_rn(wa, bar_r[k]), __fmul_rn(wb, p));
          }
        }
      }
    }

    // The loader warp files what it read: block t+3's id, block t+2's
    // valid list (chunks past the registers are read now); then it asks
    // L2 for the rows block t+2 will stage.
    if (warp == kLoader) {
      if (lane == 0 && t + 3 < n_perm)
        s_id[(t + 3) & (kIdRing - 1)] = next_id;
      if (lane == 0)
        avg_weights(kStride ? args.k0 + k_stride * (t + 1)
                            : args.k0 + t + 1,
                    s_wts[2 * ((t + 1) & 1)],
                    s_wts[2 * ((t + 1) & 1) + 1]);
      const long long i2 = t + 2 < n_perm ? id_of(t + 2) : -1;
      if (t + 2 < n_perm) {
        const bool ok = in_range(i2);
        const bool* V = args.valid + (ok ? i2 * cap : 0);
        int* meta = meta_of(t + 2);
        compact(meta, cap, lane, [&](int c) {
          bool v = false;
#pragma unroll
          for (int q = 0; q < kMaskChunks; ++q)
            if (q == c) v = vreg[q];
          return c < kMaskChunks ? v : ok && V[c * kWarp + lane];
        });
        __syncwarp();
        if (ok) {
          if (lane < min(meta[2 * cap], R))
            prefetch_l2(plane(i2, meta[cap + lane]), d1);
          if (lane == kWarp - 1) prefetch_l2(args.phi_i + i2 * d1, d1);
          if (kSec35 && lane == kWarp - 2)
            prefetch_l2(gram_of(i2), cap * cap);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < NJ; ++k) {
    const int j = tid + k * kThreads;
    if (j < d1) {
      args.phi[j] = s_vec[j];
      args.bar[j] = bar_r[k];
    }
  }
}

// -- The wide plan ------------------------------------------------------------
//
// Shapes the staged kernel cannot take (kernels/approx_pass.py::plan: d + 1
// past the 40 elements of the average a thread holds, a fixed part or one
// buffer past shared memory, Sec-3.5 caps past 8 x 32) run here.  The same
// pass, one CTA of 512 threads, but phi and the average stay in device
// memory (the phi and bar tensors, updated in place; L2-resident: 240 KB
// each at d = 60,000 against 50 MB), each block's phi_i row, plane rows and
// Gram leaf are read from device memory where they are used (the staged
// kernel's streamed rows, for every row), and the per-slot lists and
// scalars live in a device scratch the wrapper allocates (wide_scratch).
// The Sec-3.5 recurrence loops over the slots 32 at a time with its a, b,
// beta in that scratch, so it takes any cap.  A __syncthreads() orders
// each block's writes to phi before the next block's reads.  The order
// contract is the staged kernel's: each dot product lane-strided in one
// warp (plain_row, dots_row, self_dots), the same roundings, the first
// maximum by warp_first_max.  Slow (every operand a device-memory or L2
// round trip on one SM) but any shape the reference's pass takes runs.

constexpr int kWideScalars = 4;   // the wide kernel's shared memory: floats

// Words of the wide plan's device scratch: a block's valid-slot list (pos,
// list, count: compact's layout), then a, b, beta, the offsets and the mix
// list, one word per slot each.
__host__ __device__ constexpr long long wide_scratch(long long cap) {
  return (2 * cap + 1) + 5 * cap;
}

// The Sec-3.5 recurrences of one block (as recurrence<kQ>, the same
// updates in the same order of roundings), in one warp, over the slots 32
// at a time with a, b and beta in device scratch: lane l owns slots l,
// l+32, ...; a __syncwarp() after each step makes its writes visible to
// the lane that reads slot h next.
__device__ float recurrence_wide(const int* pos, float* s_a, float* s_b,
                                 const float* s_off, const float* G,
                                 float* s_beta, int cap, int steps,
                                 float lam, float e, float c, float oi,
                                 int* stamps, int outer_it, int lane) {
  for (int r = lane; r < cap; r += kWarp) s_beta[r] = 0.0f;
  __syncwarp();
  float beta0 = 1.0f;
  for (int step = 0; step < steps; ++step) {
    float best = minus_inf();
    int h = cap;
    for (int r = lane; r < cap; r += kWarp) {
      const bool v = pos[r] >= 0;
      const float sr = __fsub_rn(v ? s_off[r] : 0.0f,
                                 __fdiv_rn(v ? s_a[r] : 1.0f, lam));
      const float s = v ? sr : kNeg;
      if (s > best) {
        best = s;
        h = r;
      }
    }
    h = warp_first_max(best, h);
    const float ah = s_a[h], bh = s_b[h];
    const float ch = pos[h] >= 0 ? s_off[h] : 0.0f;
    const float* gh_row = G + h;   // G[r, h] at gh_row[r * cap]
    const float ghh = gh_row[static_cast<long long>(h) * cap];
    const float num = __fsub_rn(__fsub_rn(e, ah),
                                __fmul_rn(lam, __fsub_rn(oi, ch)));
    const float den = __fadd_rn(__fsub_rn(c, __fmul_rn(2.0f, bh)), ghh);
    float g = den > 0.0f ? __fdiv_rn(num, fmaxf(den, 1e-30f)) : 0.0f;
    g = fminf(fmaxf(g, 0.0f), 1.0f);
    const float omg = __fsub_rn(1.0f, g);
    const float e_new = __fadd_rn(
        __fmul_rn(omg, __fadd_rn(e, __fmul_rn(g, __fsub_rn(bh, c)))),
        __fmul_rn(g, __fadd_rn(ah, __fmul_rn(g, __fsub_rn(ghh, bh)))));
    const float c_new = __fadd_rn(
        __fadd_rn(__fmul_rn(__fmul_rn(omg, omg), c),
                  __fmul_rn(__fmul_rn(__fmul_rn(2.0f, g), omg), bh)),
        __fmul_rn(__fmul_rn(g, g), ghh));
    __syncwarp();   // every lane has read slot h before it is rewritten
    for (int r = lane; r < cap; r += kWarp) {
      const float gh = gh_row[static_cast<long long>(r) * cap];
      const float br = s_b[r];
      s_a[r] = __fadd_rn(s_a[r], __fmul_rn(g, __fsub_rn(gh, br)));
      s_b[r] = __fadd_rn(__fmul_rn(omg, br), __fmul_rn(g, gh));
      float be = __fmul_rn(omg, s_beta[r]);
      if (r == h) be = __fadd_rn(be, g);
      s_beta[r] = be;
    }
    // The slot was returned by the approximate oracle.
    if (lane == 0) stamps[h] = outer_it;
    e = e_new;
    c = c_new;
    oi = __fadd_rn(__fmul_rn(omg, oi), __fmul_rn(g, ch));
    beta0 = __fmul_rn(omg, beta0);
    __syncwarp();
  }
  return beta0;
}

template <bool kSec35, bool kGap, bool kStride>
__global__ void __launch_bounds__(kThreads, 1)
approx_pass_wide_kernel(const Args args, int* scratch, float* gap,
                        long long k_stride) {
  if (args.go != nullptr && !*args.go) return;
  __shared__ float s_scal[kWideScalars];
  const int d1 = args.d + 1, d = args.d, cap = args.cap;
  const float lam = args.lam, inv_lam = args.inv_lam;
  const long long n = args.n;
  const int tid = threadIdx.x, lane = tid % kWarp;
  const int warp = __shfl_sync(kFull, tid / kWarp, 0);
  float* phi = args.phi;
  float* bar = args.bar;
  int* meta = scratch;                 // pos [cap], list [cap], count
  const int* pos = meta;
  const int* list = meta + cap;
  float* s_a = reinterpret_cast<float*>(scratch + 2 * cap + 1);
  float* s_b = s_a + cap;
  float* s_beta = s_b + cap;
  float* s_off = s_beta + cap;
  int* s_mix = reinterpret_cast<int*>(s_off + cap);
  auto plane = [&](long long i, int r) {
    return args.planes + (i * cap + r) * static_cast<long long>(d1);
  };

  for (int t = 0; t < args.n_perm; ++t) {
    const long long i = args.perm[t];
    if (i < 0 || i >= n) continue;   // uniform: every thread read i
    float wa, wb;
    avg_weights(kStride ? args.k0 + k_stride * t : args.k0 + t, wa, wb);
    float* pi = args.phi_i + i * d1;
    if (warp == 0) {
      const bool* V = args.valid + i * cap;
      compact(meta, cap, lane, [&](int c) { return V[c * kWarp + lane]; });
    }
    __syncthreads();
    const int nv = meta[2 * cap];

    if (!kSec35) {
      // -- plain mode: as the staged kernel, rows read where they lie ----
      float* s_num = s_b;
      float* s_den = s_beta;
      for (int k = warp; k < nv; k += kWarps) {
        const float* p = plane(i, list[k]);
        float sc, nu, de;
        plain_row(p, phi, pi, d, lane, inv_lam, sc, nu, de);
        if (lane == 0) {
          s_a[k] = sc;
          s_num[k] = nu;
          s_den[k] = de;
          s_off[k] = p[d];
        }
      }
      if (nv == 0 && warp == 0) {
        float e0, c0;
        self_dots(pi, phi, d, lane, e0, c0);
        if (lane == 0) {
          s_scal[0] = e0;
          s_scal[1] = c0;
        }
      }
      // The gap output's score of the iterate's row, in the first word
      // of the mix list (the Sec-3.5 mode's; unused here).
      float* g_score = reinterpret_cast<float*>(s_mix);
      if (kGap && warp == nv % kWarps) {
        const float sw = score_row(pi, phi, d, lane, inv_lam);
        if (lane == 0) *g_score = sw;
      }
      __syncthreads();
      if (warp == 0) {
        // The first maximum over the valid rows: each lane the first of
        // its rows (k = lane, lane + 32, ...), then the lowest k among
        // the lanes holding the largest score.
        float best = minus_inf();
        int kb = nv;
        for (int k = lane; k < nv; k += kWarp) {
          const float sc = s_a[k];
          if (sc > best) {
            best = sc;
            kb = k;
          }
        }
        kb = warp_first_max(best, kb);
        if (kb >= nv) kb = 0;
        const bool any = nv > 0;
        const float dot = any ? s_num[kb] : s_scal[0];
        const float den = any ? s_den[kb] : s_scal[1];
        const float diff_o = __fsub_rn(pi[d], any ? s_off[kb] : 0.0f);
        const float num = __fsub_rn(dot, __fmul_rn(lam, diff_o));
        float g = den > 0.0f ? __fdiv_rn(num, fmaxf(den, 1e-30f)) : 0.0f;
        g = fminf(fmaxf(g, 0.0f), 1.0f);
        if (lane == 0) {
          s_scal[2] = __int_as_float(any ? kb : -1);
          s_scal[3] = g;
          args.last_active[i * cap + (any ? list[kb] : 0)] = args.outer_it;
          if (kGap)
            gap[i] =
                fmaxf(__fsub_rn(any ? s_a[kb] : 0.0f, *g_score), 0.0f);
        }
      }
      __syncthreads();
      const int kb = __float_as_int(s_scal[2]);
      const float g = s_scal[3];
      const bool any = kb >= 0;
      const float omg = __fsub_rn(1.0f, g);
      const float* ph = any ? plane(i, list[kb]) : pi;
      for (int j = tid; j < d1; j += kThreads) {
        const float pij = pi[j];
        const float h = ph[j];
        const float hj = any ? h : 0.0f;
        const float npi = __fadd_rn(__fmul_rn(omg, pij), __fmul_rn(g, hj));
        const float p = __fadd_rn(phi[j], __fsub_rn(npi, pij));
        pi[j] = npi;
        phi[j] = p;
        bar[j] = __fadd_rn(__fmul_rn(wa, bar[j]), __fmul_rn(wb, p));
      }
    } else if (nv == 0) {
      // -- Sec-3.5 mode, no cached plane: only the average moves ---------
      for (int j = tid; j < d1; j += kThreads)
        bar[j] = __fadd_rn(__fmul_rn(wa, bar[j]), __fmul_rn(wb, phi[j]));
    } else {
      // -- Sec-3.5 mode: Gram recurrences, then one materialisation ------
      for (int r = tid; r < cap; r += kThreads)
        if (pos[r] < 0) {
          s_a[r] = 0.0f;
          s_b[r] = 0.0f;
        }
      for (int k = warp; k < nv; k += kWarps) {
        const int r = list[k];
        const float* p = plane(i, r);
        float av, bv;
        dots_row(p, phi, pi, d, lane, av, bv);
        if (lane == 0) {
          s_a[r] = av;
          s_b[r] = bv;
          s_off[r] = p[d];
        }
      }
      if (warp == kLoader) {
        float e0, c0;
        self_dots(pi, phi, d, lane, e0, c0);
        if (lane == 0) {
          s_scal[2] = e0;
          s_scal[3] = c0;
        }
      }
      __syncthreads();
      if (warp == 0) {
        const float beta0 = recurrence_wide(
            pos, s_a, s_b, s_off,
            args.gram + i * static_cast<long long>(cap) * cap, s_beta, cap,
            args.steps, lam, s_scal[2], s_scal[3], pi[d],
            args.last_active + i * cap, args.outer_it, lane);
        // The slots phi_i' mixes in: those with a non-zero coefficient.
        int count = 0;
        for (int base = 0; base < cap; base += kWarp) {
          const int r = base + lane;
          const bool nz = r < cap && s_beta[r] != 0.0f;
          const unsigned m = __ballot_sync(kFull, nz);
          if (nz) s_mix[count + __popc(m & ((1u << lane) - 1u))] = r;
          count += __popc(m);
        }
        if (lane == 0) {
          s_scal[0] = beta0;
          s_scal[1] = __int_as_float(count);
        }
      }
      __syncthreads();
      const float beta0 = s_scal[0];
      const int count = __float_as_int(s_scal[1]);
      // Eight elements per thread at a time, each summing its rows in slot
      // order (the staged kernel's order).
      constexpr int kJ = 8;
      for (int j0 = 0; j0 < d1; j0 += kJ * kThreads) {
        float mix[kJ];
#pragma unroll
        for (int u = 0; u < kJ; ++u) mix[u] = 0.0f;
        for (int q = 0; q < count; ++q) {
          const int r = s_mix[q];
          const float bq = s_beta[r];
          const float* row = plane(i, r);
#pragma unroll
          for (int u = 0; u < kJ; ++u) {
            const int j = j0 + tid + u * kThreads;
            if (j < d1) mix[u] = fmaf(bq, row[j], mix[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kJ; ++u) {
          const int j = j0 + tid + u * kThreads;
          if (j < d1) {
            const float pij = pi[j];
            const float npi = __fadd_rn(__fmul_rn(beta0, pij), mix[u]);
            const float p = __fadd_rn(phi[j], __fsub_rn(npi, pij));
            pi[j] = npi;
            phi[j] = p;
            bar[j] = __fadd_rn(__fmul_rn(wa, bar[j]), __fmul_rn(wb, p));
          }
        }
      }
    }
    // Block t's writes (phi, phi_i, the scratch) before block t+1 reads.
    __syncthreads();
  }
}

template <bool kSec35, bool kGap, bool kStride>
void launch_nj(const Args& args, float* gap, long long k_stride,
               long long d1, size_t bytes, cudaStream_t s) {
  if (d1 <= 8 * kThreads)
    approx_pass_kernel<8, kSec35, kGap, kStride>
        <<<1, kThreads, bytes, s>>>(args, gap, k_stride);
  else if (d1 <= 16 * kThreads)
    approx_pass_kernel<16, kSec35, kGap, kStride>
        <<<1, kThreads, bytes, s>>>(args, gap, k_stride);
  else if (d1 <= 24 * kThreads)
    approx_pass_kernel<24, kSec35, kGap, kStride>
        <<<1, kThreads, bytes, s>>>(args, gap, k_stride);
  else
    approx_pass_kernel<40, kSec35, kGap, kStride>
        <<<1, kThreads, bytes, s>>>(args, gap, k_stride);
}

template <bool kSec35, bool kGap>
void launch(const Args& args, float* gap, long long k_stride, long long d1,
            size_t bytes, cudaStream_t s) {
  if (k_stride != 1)
    launch_nj<kSec35, kGap, true>(args, gap, k_stride, d1, bytes, s);
  else
    launch_nj<kSec35, kGap, false>(args, gap, k_stride, d1, bytes, s);
}

template <bool kSec35, bool kGap>
void launch_wide(const Args& args, int* scratch, float* gap,
                 long long k_stride, cudaStream_t s) {
  if (k_stride != 1)
    approx_pass_wide_kernel<kSec35, kGap, true><<<1, kThreads, 0, s>>>(
        args, scratch, gap, k_stride);
  else
    approx_pass_wide_kernel<kSec35, kGap, false><<<1, kThreads, 0, s>>>(
        args, scratch, gap, k_stride);
}

// The builds: the staged kernel by elements of the average per thread
// (NJ), mode (plain, plain with the gap output, Sec-3.5) and averaging
// stride, each granted the card's limit; the wide kernel (static shared
// memory only) by mode and stride.
const repro::Build kBuilds[] = {
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<8, false, false, false>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<16, false, false, false>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<24, false, false, false>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<40, false, false, false>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<8, false, false, true>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<16, false, false, true>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<24, false, false, true>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<40, false, false, true>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<8, false, true, false>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<16, false, true, false>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<24, false, true, false>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<40, false, true, false>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<8, false, true, true>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<16, false, true, true>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<24, false, true, true>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<40, false, true, true>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<8, true, false, false>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<16, true, false, false>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<24, true, false, false>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<40, true, false, false>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<8, true, false, true>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<16, true, false, true>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<24, true, false, true>),
    REPRO_BUILD(kSmemLimit, approx_pass_kernel<40, true, false, true>),
    REPRO_BUILD(0, approx_pass_wide_kernel<false, false, false>),
    REPRO_BUILD(0, approx_pass_wide_kernel<false, false, true>),
    REPRO_BUILD(0, approx_pass_wide_kernel<false, true, false>),
    REPRO_BUILD(0, approx_pass_wide_kernel<false, true, true>),
    REPRO_BUILD(0, approx_pass_wide_kernel<true, false, false>),
    REPRO_BUILD(0, approx_pass_wide_kernel<true, false, true>),
};

}  // namespace

// Shared memory one launch of the plan (rows staged per buffer, nbuf
// buffers) takes.
extern "C" long long approx_pass_smem_bytes(int d, int cap, int steps,
                                            int rows, int nbuf) {
  return 4 * make_layout(static_cast<long long>(d) + 1, cap, steps, rows,
                         nbuf)
                 .total;
}

// Once, when the library loads (never inside a graph capture): dynamic
// shared memory above 48 KB for every staged build.  Returns a
// cudaError_t.
extern "C" int approx_pass_init(void) {
  return static_cast<int>(repro::grant(kBuilds));
}

// One build's attributes (builds.cuh repro::attributes).
extern "C" int approx_pass_attributes(int build, int threads,
                                      long long dyn_smem, int cluster,
                                      long long* out) {
  return repro::attributes(kBuilds, build, threads, dyn_smem, cluster, out);
}

// Words of the wide plan's device scratch at `cap` slots
// (kernels/approx_pass.py::wide_scratch_words mirrors it).
extern "C" long long approx_pass_wide_scratch_words(int cap) {
  return wide_scratch(cap);
}

// The wide kernel's shared memory in bytes (plan's smem_bytes for it).
extern "C" long long approx_pass_wide_smem_bytes(void) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr,
                            approx_pass_wide_kernel<false, false, false>) !=
      cudaSuccess)
    return -1;
  return static_cast<long long>(attr.sharedSizeBytes);
}

// The wide plan: launches on `stream` and returns cudaGetLastError().
// `scratch` holds approx_pass_wide_scratch_words(cap) 4-byte words of
// device memory, allocated by the caller; any d >= 1 and cap >= 1.
extern "C" int approx_pass_wide_launch(float* phi, float* phi_i, float* bar,
                                       const float* planes,
                                       const bool* valid, int* last_active,
                                       const float* gram,
                                       const long long* perm, const bool* go,
                                       float* gap, long long n, int n_perm,
                                       int cap,
                                       int d, int steps, int outer_it,
                                       float lam, float inv_lam,
                                       long long k0, long long k_stride,
                                       int* scratch, void* stream) {
  if (n_perm < 0 || cap < 1 || d < 1 || steps < 0 || k_stride < 1 ||
      (steps > 0 && (gram == nullptr || gap != nullptr)) ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_perm == 0) return 0;
  Args args{phi,  phi_i, bar,   planes, valid, last_active, gram,
            perm, go,    n,     n_perm, cap,   d,           steps,
            outer_it, 0, 1, lam, inv_lam, k0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (steps > 0)
    launch_wide<true, false>(args, scratch, nullptr, k_stride, s);
  else if (gap != nullptr)
    launch_wide<false, true>(args, scratch, gap, k_stride, s);
  else
    launch_wide<false, false>(args, scratch, nullptr, k_stride, s);
  return static_cast<int>(cudaGetLastError());
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// steps == 0 runs the plain pass (gram unread; `gap` may take the gap
// estimates), steps > 0 the Sec-3.5 one (gap must be null); `rows` and
// `nbuf` are the plan's (kernels/approx_pass.py::plan).
extern "C" int approx_pass_launch(float* phi, float* phi_i, float* bar,
                                  const float* planes, const bool* valid,
                                  int* last_active, const float* gram,
                                  const long long* perm, const bool* go,
                                  float* gap, long long n, int n_perm,
                                  int cap, int d,
                                  int steps, int outer_it, float lam,
                                  float inv_lam, long long k0,
                                  long long k_stride, int rows, int nbuf,
                                  void* stream) {
  const long long d1 = static_cast<long long>(d) + 1;
  if (n_perm < 0 || cap < 1 || d < 1 || steps < 0 || k_stride < 1 ||
      (steps > 0 && (gram == nullptr || gap != nullptr)) || rows < 0 ||
      rows > cap ||
      (nbuf != 1 && nbuf != 2) || d1 > kMaxD1 ||
      (steps > 0 && cap > 8 * kWarp))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_perm == 0) return 0;
  const long long smem = approx_pass_smem_bytes(d, cap, steps, rows, nbuf);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  Args args{phi,  phi_i, bar,   planes, valid, last_active, gram,
            perm, go,    n,     n_perm, cap,   d,           steps,
            outer_it, rows, nbuf, lam, inv_lam, k0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
  if (steps > 0)
    launch<true, false>(args, nullptr, k_stride, d1, bytes, s);
  else if (gap != nullptr)
    launch<false, true>(args, gap, k_stride, d1, bytes, s);
  else
    launch<false, false>(args, nullptr, k_stride, d1, bytes, s);
  return static_cast<int>(cudaGetLastError());
}
