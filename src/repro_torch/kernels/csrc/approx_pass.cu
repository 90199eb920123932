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
//   k = k0 + (position of i in perm) (core/averaging.py).
// A `go` flag (device bool, may be null) gates the launch: false returns
// at once, so a batch of passes queued behind the slope rule's on-device
// flag runs only the passes the rule allows.
//
// Bound.  A pass reads each visited block's valid planes, its phi_i row
// (read and written) and, in the Sec-3.5 mode, its Gram leaf: ~16 KB x
// (2 + valid planes) per block at d = 4004, ~0.46 GB per full-size OCR
// pass, 0.14 ms at 3.35 TB/s.  In practice it is latency bound: the blocks
// depend on each other through phi, so the pass is sequential, and each
// block costs a few block-wide reductions.
//
// Design: one CTA of 1024 threads walks the permutation.  phi, the
// average and w = -phi*/lam stay in shared memory for the whole pass and
// are written back once at the end.  Per block the valid planes are scored
// one warp per plane with plane_scores.cu's lane order and xor butterfly,
// so equal planes score bit-equally and the first maximum wins, as in the
// eager pass.  Every block-wide reduction is a fixed butterfly per warp and
// a fixed butterfly over the 32 warp sums, so a pass is deterministic.
// Where the eager pass rounds twice (a*x + b*y as two products and a sum),
// the kernel uses __fmul_rn/__fadd_rn so that nvcc does not contract it
// into one FMA.  The line-search dot products reduce in another order than
// cuBLAS's: the kernel and the eager pass agree to ~1e-6 relative, not bit
// for bit.  w is (-phi_j) * fl32(1/lam), the reciprocal taken in double:
// the eager op's form on the card (PyTorch multiplies by the reciprocal
// for a scalar divisor).  Later: a cluster of CTAs sharing phi through
// distributed shared memory.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;   // kernels/ref.py INVALID_SCORE

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
  int n_perm, cap, d, steps, outer_it;
  float lam, inv_lam;
  long long k0;
};

__device__ __forceinline__ float minus_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// First maximum over (score, index) pairs held one per lane: the larger
// score wins, equal scores keep the lower index.
__device__ __forceinline__ void warp_argmax(float& best, int& idx) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
}

// Every warp reduces the 32 per-warp partials of `red` alike, so all
// threads get the same block-wide sums without another barrier.
__device__ __forceinline__ float block_total(const float* red, int lane) {
  return warp_sum(red[lane]);
}

// The averaging weights k/(k+2), 2/(k+2) from a float32 k, in float32.
__device__ __forceinline__ void avg_weights(long long k, float& a, float& b) {
  const float kf = __ll2float_rn(k);
  const float den = __fadd_rn(kf, 2.0f);
  a = __fdiv_rn(kf, den);
  b = __fdiv_rn(2.0f, den);
}

__global__ void __launch_bounds__(kThreads, 1)
approx_pass_kernel(const Args args) {
  if (args.go != nullptr && !*args.go) return;
  extern __shared__ float smem[];
  const int d1 = args.d + 1, d = args.d, cap = args.cap;
  float* s_phi = smem;                 // [d1]
  float* s_bar = s_phi + d1;           // [d1]
  float* s_w = s_bar + d1;             // [d]  (w = -phi*/lam)
  float* s_pi = s_w + d1;              // [d1] Sec-3.5 mode: phi_i row
  float* s_g = s_pi + (args.steps > 0 ? d1 : 0);   // [cap*cap] Gram leaf
  float* s_a = s_g + (args.steps > 0 ? cap * cap : 0);   // [cap] scores, a
  float* s_b = s_a + cap;              // [cap]
  float* s_beta = s_b + cap;           // [cap]
  int* s_rows = reinterpret_cast<int*>(s_beta + cap);    // [cap]
  float* s_red = reinterpret_cast<float*>(s_rows + cap); // [2 * kWarps]
  float* s_scal = s_red + 2 * kWarps;  // [4]
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const float lam = args.lam, inv_lam = args.inv_lam;

  for (int j = tid; j < d1; j += kThreads) {
    const float p = args.phi[j];
    s_phi[j] = p;
    s_bar[j] = args.bar[j];
    if (j < d) s_w[j] = __fmul_rn(-p, inv_lam);
  }
  __syncthreads();

  for (int t = 0; t < args.n_perm; ++t) {
    const long long i = args.perm[t];
    float wa, wb;
    avg_weights(args.k0 + t, wa, wb);
    if (i < 0 || i >= args.n) continue;   // uniform: every thread skips
    const float* P = args.planes + i * cap * static_cast<long long>(d1);
    const bool* V = args.valid + i * cap;
    float* pi_row = args.phi_i + i * static_cast<long long>(d1);

    if (args.steps == 0) {
      // -- plain mode: score, first argmax, exact line search ------------
      for (int r = warp; r < cap; r += kWarps) {
        float s = kNeg;
        if (V[r]) {
          const float* p = P + static_cast<long long>(r) * d1;
          float acc = 0.0f;
          for (int j = lane; j < d; j += kWarp) acc = fmaf(p[j], s_w[j], acc);
          s = warp_sum(acc) + p[d];
        }
        if (lane == 0) s_a[r] = s;
      }
      __syncthreads();
      float best = minus_inf();
      int slot = cap;
      for (int r = lane; r < cap; r += kWarp)
        if (s_a[r] > best) {
          best = s_a[r];
          slot = r;
        }
      warp_argmax(best, slot);
      bool any = false;
      for (int r = lane; r < cap; r += kWarp) any = any || V[r];
      any = __any_sync(kFull, any);
      const float* ph = P + static_cast<long long>(slot) * d1;
      float num_p = 0.0f, den_p = 0.0f;
      for (int j = tid; j < d; j += kThreads) {
        const float diff = __fsub_rn(pi_row[j], any ? ph[j] : 0.0f);
        num_p = fmaf(diff, s_phi[j], num_p);
        den_p = fmaf(diff, diff, den_p);
      }
      num_p = warp_sum(num_p);
      den_p = warp_sum(den_p);
      if (lane == 0) {
        s_red[warp] = num_p;
        s_red[kWarps + warp] = den_p;
      }
      // Every thread reads the row's offset before the barrier: after it,
      // the update loop below rewrites pi_row[d].
      const float diff_o = __fsub_rn(pi_row[d], any ? ph[d] : 0.0f);
      __syncthreads();
      const float dot = block_total(s_red, lane);
      const float den = block_total(s_red + kWarps, lane);
      const float num = __fsub_rn(dot, __fmul_rn(lam, diff_o));
      float g = den > 0.0f ? __fdiv_rn(num, fmaxf(den, 1e-30f)) : 0.0f;
      g = fminf(fmaxf(g, 0.0f), 1.0f);
      const float omg = __fsub_rn(1.0f, g);
      if (tid == 0) args.last_active[i * cap + slot] = args.outer_it;
      for (int j = tid; j < d1; j += kThreads) {
        const float pij = pi_row[j];
        const float hj = any ? ph[j] : 0.0f;
        const float npi = __fadd_rn(__fmul_rn(omg, pij), __fmul_rn(g, hj));
        const float p = __fadd_rn(s_phi[j], __fsub_rn(npi, pij));
        pi_row[j] = npi;
        s_phi[j] = p;
        if (j < d) s_w[j] = __fmul_rn(-p, inv_lam);
        s_bar[j] = __fadd_rn(__fmul_rn(wa, s_bar[j]), __fmul_rn(wb, p));
      }
      __syncthreads();
      continue;
    }

    // -- Sec-3.5 mode: Gram recurrences, then one materialisation --------
    const float* G = args.gram + i * static_cast<long long>(cap) * cap;
    for (int j = tid; j < d1; j += kThreads) s_pi[j] = pi_row[j];
    for (int j = tid; j < cap * cap; j += kThreads) s_g[j] = G[j];
    bool any = false;
    for (int r = lane; r < cap; r += kWarp) any = any || V[r];
    any = __syncthreads_or(any);
    if (!any) {
      // No cached plane: the recurrence takes no step (g = 0 throughout),
      // phi and phi_i stay; only the average moves.
      for (int j = tid; j < d1; j += kThreads)
        s_bar[j] = __fadd_rn(__fmul_rn(wa, s_bar[j]),
                             __fmul_rn(wb, s_phi[j]));
      __syncthreads();
      continue;
    }
    // a_r = <p_r*, phi*>, b_r = <p_r*, phi_i*> (cache.row_dots: the
    // plane_scores order, plus a zero offset); c and e over the block.
    for (int r = warp; r < cap; r += kWarps) {
      float av = 0.0f, bv = 0.0f;
      if (V[r]) {
        const float* p = P + static_cast<long long>(r) * d1;
        for (int j = lane; j < d; j += kWarp) {
          const float pj = p[j];
          av = fmaf(pj, s_phi[j], av);
          bv = fmaf(pj, s_pi[j], bv);
        }
        av = warp_sum(av) + 0.0f;
        bv = warp_sum(bv) + 0.0f;
      }
      if (lane == 0) {
        s_a[r] = av;
        s_b[r] = bv;
        s_beta[r] = 0.0f;
      }
    }
    float c_p = 0.0f, e_p = 0.0f;
    for (int j = tid; j < d; j += kThreads) {
      const float q = s_pi[j];
      c_p = fmaf(q, q, c_p);
      e_p = fmaf(q, s_phi[j], e_p);
    }
    c_p = warp_sum(c_p);
    e_p = warp_sum(e_p);
    if (lane == 0) {
      s_red[warp] = c_p;
      s_red[kWarps + warp] = e_p;
    }
    __syncthreads();
    if (warp == 0) {
      float c = block_total(s_red, lane);
      float e = block_total(s_red + kWarps, lane);
      float oi = s_pi[d], beta0 = 1.0f;
      for (int step = 0; step < args.steps; ++step) {
        float best = minus_inf();
        int h = cap;
        for (int r = lane; r < cap; r += kWarp) {
          const float s =
              V[r] ? __fsub_rn(P[static_cast<long long>(r) * d1 + d],
                               __fdiv_rn(s_a[r], lam))
                   : kNeg;
          if (s > best) {
            best = s;
            h = r;
          }
        }
        warp_argmax(best, h);
        const float ah = s_a[h], bh = s_b[h];
        const float ch = P[static_cast<long long>(h) * d1 + d];
        const float ghh = s_g[h * cap + h];
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
        __syncwarp();   // every lane has read a[h], b[h]
        for (int r = lane; r < cap; r += kWarp) {
          const float gh = s_g[r * cap + h];
          const float br = s_b[r];
          s_a[r] = __fadd_rn(s_a[r], __fmul_rn(g, __fsub_rn(gh, br)));
          s_b[r] = __fadd_rn(__fmul_rn(omg, br), __fmul_rn(g, gh));
          float be = __fmul_rn(omg, s_beta[r]);
          if (r == h) {
            be = __fadd_rn(be, g);
            // The slot was returned by the approximate oracle.
            args.last_active[i * cap + h] = args.outer_it;
          }
          s_beta[r] = be;
        }
        e = e_new;
        c = c_new;
        oi = __fadd_rn(__fmul_rn(omg, oi), __fmul_rn(g, ch));
        beta0 = __fmul_rn(omg, beta0);
        __syncwarp();
      }
      // The rows phi_i' mixes in: those with a non-zero coefficient.
      int count = 0;
      for (int base = 0; base < cap; base += kWarp) {
        const int r = base + lane;
        const bool nz = r < cap && s_beta[r] != 0.0f;
        const unsigned m = __ballot_sync(kFull, nz);
        if (nz) s_rows[count + __popc(m & ((1u << lane) - 1u))] = r;
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
    for (int j = tid; j < d1; j += kThreads) {
      float mix = 0.0f;
      for (int q = 0; q < count; ++q) {
        const int r = s_rows[q];
        mix = fmaf(s_beta[r], P[static_cast<long long>(r) * d1 + j], mix);
      }
      const float pij = s_pi[j];
      const float npi = __fadd_rn(__fmul_rn(beta0, pij), mix);
      const float p = __fadd_rn(s_phi[j], __fsub_rn(npi, pij));
      pi_row[j] = npi;
      s_phi[j] = p;
      if (j < d) s_w[j] = __fmul_rn(-p, inv_lam);
      s_bar[j] = __fadd_rn(__fmul_rn(wa, s_bar[j]), __fmul_rn(wb, p));
    }
    __syncthreads();
  }

  for (int j = tid; j < d1; j += kThreads) {
    args.phi[j] = s_phi[j];
    args.bar[j] = s_bar[j];
  }
}

size_t smem_bytes(int d, int cap, int steps) {
  const size_t d1 = static_cast<size_t>(d) + 1;
  size_t floats = 3 * d1 + 3 * static_cast<size_t>(cap) + 2 * kWarps + 4;
  if (steps > 0) floats += d1 + static_cast<size_t>(cap) * cap;
  return 4 * (floats + cap);   // + s_rows
}

}  // namespace

// Shared memory one launch needs (the wrapper refuses what does not fit).
extern "C" long long approx_pass_smem_bytes(int d, int cap, int steps) {
  return static_cast<long long>(smem_bytes(d, cap, steps));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// steps == 0 runs the plain pass (gram unread), steps > 0 the Sec-3.5 one.
extern "C" int approx_pass_launch(float* phi, float* phi_i, float* bar,
                                  const float* planes, const bool* valid,
                                  int* last_active, const float* gram,
                                  const long long* perm, const bool* go,
                                  long long n, int n_perm, int cap, int d,
                                  int steps, int outer_it, float lam,
                                  float inv_lam, long long k0, void* stream) {
  if (n_perm < 0 || cap < 1 || d < 1 || steps < 0 ||
      (steps > 0 && gram == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_perm == 0) return 0;
  const size_t smem = smem_bytes(d, cap, steps);
  static size_t configured = 0;
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        approx_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  Args args{phi,  phi_i,  bar,   planes, valid,    last_active, gram,
            perm, go,     n,     n_perm, cap,      d,           steps,
            outer_it, lam, inv_lam, k0};
  approx_pass_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      args);
  return static_cast<int>(cudaGetLastError());
}
