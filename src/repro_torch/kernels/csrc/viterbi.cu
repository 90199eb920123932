// Whole-sequence masked Viterbi decode: the chain max-oracle's DP, written
// by hand for Hopper (sm_90a).
//
// Replaces repro/kernels/viterbi.py::viterbi_step (the Pallas max-plus
// step) together with viterbi_decode_batch, the lax.scan around it.
// Each row b computes exactly repro/core/oracles/chain.py::viterbi_decode:
//
//     u[l]  = mask[l] ? unary[l] : 0
//     m     = u[0]
//     step l = 1..L-1:  cand[c', c] = m[c'] + (mask[l] ? T[c', c] : 0)
//                       back[l-1, c] = first argmax_c' cand[c', c]
//                       m[c] = max_c' cand[c', c] + u[l, c]
//     y[L-1] = first argmax m;  y[l] = back[l, y[l+1]]
//
// The adds are the reference's own, in the same order and in fp32, and a
// maximum takes a candidate only when it is strictly larger, so the first
// maximum wins as in jnp.argmax: labels are bit-equal to the reference on
// the same unaries.
//
// Bound: latency and dependence.  A row is L-1 dependent steps of C*C
// max-adds (13 x 676 on OCR); its bytes (L*C unaries, the C x C table)
// are a few KB.  At B = 1 (one exact-oracle call inside the captured exact
// step) nothing hides a device-memory round trip or a dependent chain, so
// the design spends one round trip and keeps the steps on chip: one block
// per sequence loads the table and issues 4-byte cp.async copies of its
// row's unaries (and loads its mask bytes) all before the first wait;
// each step reads its unaries and writes its back pointers in shared
// memory, and after the last step one thread walks the back pointers in
// shared memory and writes the labels once.
//
// C <= 32 (OCR's 26 labels, the SSVM head's tags): one warp, lane c owning
// label c, with column c of the table in registers; a step forms its
// candidates m[c'] + T[c', c] from m read four at a time (a broadcast
// 16-byte load) in four chains (c' mod 4) joined by value, then index;
// a padded step is one first-argmax butterfly over m.  C > 32 (up to
// MAX_LABELS): ceil(C/32) warps, the table and a double-buffered m in
// shared memory, each step's candidates formed eight at a time in the
// same eight chains.
//
// Plan (kernels/viterbi.py::plan): a row whose table, scores, unaries,
// back pointers and mask bytes do not fit the 227 KB a block may opt into
// runs the scratch variant: each step's unaries read from device memory,
// back pointers in a (B, L-1, C) scratch tensor the caller allocates.
// Both variants compute the same labels.
#include <cuda_runtime.h>

#include <cstdint>

#include "builds.cuh"

namespace {

constexpr int kSmemLimit = repro::kSmemLimit;   // what a block may opt into

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float minus_inf() {
  return __int_as_float(0xff800000);
}

// The first maximum over mp[c'] + (valid ? t[c' * C + c] : 0), c' = 0..C-1,
// as a serial scan with a strict compare finds it.  The candidates are
// formed eight at a time (all loads of a batch in flight together) and go
// to eight chains by c' mod 8, each keeping its own first maximum; the
// chains join by the larger value, then the lower index.
__device__ __forceinline__ float first_max(const float* mp, const float* t,
                                           bool valid, int C, int c,
                                           int& arg) {
  float best[8];
  int at[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    best[k] = minus_inf();
    at[k] = k;
  }
  for (int base = 0; base < C; base += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int cp = base + u;
      const int cl = min(cp, C - 1);   // in bounds: the loads need no branch
      const float tv = t[cl * C + c];
      const float x = mp[cl] + (valid ? tv : 0.0f);
      v[u] = cp < C ? x : minus_inf();
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (v[u] > best[u]) {
        best[u] = v[u];
        at[u] = base + u;
      }
  }
  float b = best[0];
  arg = at[0];
#pragma unroll
  for (int k = 1; k < 8; ++k)
    if (k < C && (best[k] > b || (best[k] == b && at[k] < arg))) {
      b = best[k];
      arg = at[k];
    }
  return b;
}

constexpr unsigned kFull = 0xffffffffu;

// Words before a staged row's unaries: the block kernel's table and two
// score rows, or the warp kernel's two 32-float score rows, whichever is
// larger (kernels/viterbi.py::plan).
__host__ __device__ inline int table_words(int C) {
  return C * C + 2 * C > 64 ? C * C + 2 * C : 64;
}

// First maximum over (value, index) pairs held one per lane: the larger
// value wins, equal values keep the lower index.
__device__ __forceinline__ void warp_first_max(float& best, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
}

// C <= 32: one warp per sequence, lane c owning label c, built for the
// kG = ceil(C/4) groups of four candidates.  Lane c keeps column c of the
// table in registers (-inf past C, so lanes and labels past C never win)
// and m[c] in a register and in a double-buffered 32-float row of shared
// memory; step l forms its 4 kG candidates m[c'] + T[c', c], reading m
// four at a time (one broadcast 16-byte load), in four chains (c' mod 4)
// joined by value, then index.  A padded step (mask[l] false) adds zeros:
// every label takes the same first argmax of m, one butterfly.  Unaries
// (staged, or read one step ahead from device memory) and back pointers
// as the plan says.
template <int kG, bool kStaged>
__global__ void __launch_bounds__(32)
viterbi_warp_kernel(const float* __restrict__ unary,
                    const float* __restrict__ trans,
                    const unsigned char* __restrict__ mask,
                    int* __restrict__ back, int* __restrict__ labels, int L,
                    int C) {
  extern __shared__ __align__(16) float smem[];
  float* mb = smem;                     // 2 x 32 scores, double-buffered
  float* su = smem + table_words(C);    // staged: L * C unaries
  int* sb = reinterpret_cast<int*>(su + L * C);   // staged: (L-1) * C
  unsigned char* sm = reinterpret_cast<unsigned char*>(sb + (L - 1) * C);
  const int c = threadIdx.x;
  const long long row = blockIdx.x;
  const float* u = unary + row * L * C;
  const unsigned char* mk = mask + row * L;

  // One round trip: the table column, the unaries and the mask in flight
  // together.
  float tc[4 * kG];
#pragma unroll
  for (int cp = 0; cp < 4 * kG; ++cp)
    tc[cp] = (cp < C && c < C) ? trans[cp * C + c] : minus_inf();
  if (kStaged) {
    for (int k = c; k < L * C; k += 32) cp_async4(su + k, u + k);
    for (int k = c; k < L; k += 32) sm[k] = mk[k];
  }
  cp_async_wait_all();
  __syncwarp();
  const unsigned char* mrow = kStaged ? sm : mk;
  const float* urow = kStaged ? su : u;
  int* brow = kStaged ? sb : back + row * (L - 1) * C;

  float mc = (c < C && mrow[0]) ? urow[c] : 0.0f;
  mb[32 + c] = mc;   // step l reads half l % 2
  __syncwarp();
  float un = (L > 1 && c < C) ? urow[C + c] : 0.0f;   // step 1's unary
  for (int l = 1; l < L; ++l) {
    const bool valid = mrow[l] != 0;
    const float ul = un;
    if (l + 1 < L && c < C) un = urow[static_cast<long long>(l + 1) * C + c];
    float best;
    int arg;
    if (valid) {
      float b4[4];
      int a4[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        b4[k] = minus_inf();
        a4[k] = k;
      }
      const float4* m4 = reinterpret_cast<const float4*>(mb + (l & 1) * 32);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float4 mg = m4[g];
        const float v[4] = {mg.x + tc[4 * g], mg.y + tc[4 * g + 1],
                            mg.z + tc[4 * g + 2], mg.w + tc[4 * g + 3]};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (v[k] > b4[k]) {
            b4[k] = v[k];
            a4[k] = 4 * g + k;
          }
      }
      best = b4[0];
      arg = a4[0];
#pragma unroll
      for (int k = 1; k < 4; ++k)
        if (b4[k] > best || (b4[k] == best && a4[k] < arg)) {
          best = b4[k];
          arg = a4[k];
        }
    } else {
      // cand[c', c] = m[c'] + 0.0 for every c: the first argmax of m.
      float v = c < C ? mc + 0.0f : minus_inf();
      int at = c;
      warp_first_max(v, at);
      best = v;
      arg = at;
    }
    if (c < C) {
      mc = best + (valid ? ul : 0.0f);
      brow[static_cast<long long>(l - 1) * C + c] = arg;
    }
    mb[((l + 1) & 1) * 32 + c] = mc;
    __syncwarp();
  }
  float v = c < C ? mc : minus_inf();
  int y = c;
  warp_first_max(v, y);
  __syncwarp();   // the back pointers are written
  if (c == 0) {
    int* lab = labels + row * L;
    lab[L - 1] = y;
    const int* bp = brow + static_cast<long long>(L - 2) * C;
    for (int l = L - 2; l >= 0; --l, bp -= C) {
      y = bp[y];
      lab[l] = y;
    }
  }
}

// C > 32: one block of ceil(C/32) warps per sequence, thread c owning
// label c; the table and a double-buffered m in shared memory.
template <bool kStaged>
__global__ void viterbi_block_kernel(const float* __restrict__ unary,
                                      const float* __restrict__ trans,
                                      const unsigned char* __restrict__ mask,
                                      int* __restrict__ back,
                                      int* __restrict__ labels, int L,
                                      int C) {
  extern __shared__ float smem[];
  float* t = smem;          // C * C transition table
  float* m = t + C * C;     // 2 * C running scores, double-buffered
  float* su = smem + table_words(C);    // staged: L * C unaries
  int* sb = reinterpret_cast<int*>(su + L * C);   // staged: (L-1) * C
  unsigned char* sm = reinterpret_cast<unsigned char*>(sb + (L - 1) * C);
  const int c = threadIdx.x, nt = blockDim.x;
  const long long row = blockIdx.x;
  const float* u = unary + row * L * C;
  const unsigned char* mk = mask + row * L;

  // One round trip: every copy is in flight before the first wait.
  for (int k = c; k < C * C; k += nt) cp_async4(t + k, trans + k);
  if (kStaged) {
    for (int k = c; k < L * C; k += nt) cp_async4(su + k, u + k);
    for (int k = c; k < L; k += nt) sm[k] = mk[k];
  }
  cp_async_wait_all();
  __syncthreads();
  const unsigned char* mrow = kStaged ? sm : mk;
  const float* urow = kStaged ? su : u;
  int* brow = kStaged ? sb : back + row * (L - 1) * C;
  if (c < C) m[c] = mrow[0] ? urow[c] : 0.0f;
  __syncthreads();

  int cur = 0;
  for (int l = 1; l < L; ++l) {
    const bool valid = mrow[l] != 0;
    const float* mp = m + cur * C;
    float* mn = m + (cur ^ 1) * C;
    if (c < C) {
      int arg;
      const float best = first_max(mp, t, valid, C, c, arg);
      mn[c] = best + (valid ? urow[static_cast<long long>(l) * C + c] : 0.0f);
      brow[static_cast<long long>(l - 1) * C + c] = arg;
    }
    __syncthreads();
    cur ^= 1;
  }

  if (c == 0) {
    int y;
    first_max(m + cur * C, t, false, C, 0, y);
    int* lab = labels + row * L;
    lab[L - 1] = y;
    for (int l = L - 2; l >= 0; --l) {
      y = brow[static_cast<long long>(l) * C + y];
      lab[l] = y;
    }
  }
}

size_t smem_bytes(int L, int C, bool staged) {
  size_t words = static_cast<size_t>(table_words(C));
  if (!staged) return 4 * words;
  words += static_cast<size_t>(L) * C + static_cast<size_t>(L - 1) * C;
  return 4 * words + 4 * ((static_cast<size_t>(L) + 3) / 4);
}

struct WarpLaunch {
  const float* unary;
  const float* trans;
  const unsigned char* mask;
  int* back;
  int* labels;
  int B, L, C;
  size_t smem;
  cudaStream_t stream;
};

template <int kG>
void warp_launch(const WarpLaunch& a, bool staged) {
  if (staged)
    viterbi_warp_kernel<kG, true><<<a.B, 32, a.smem, a.stream>>>(
        a.unary, a.trans, a.mask, a.back, a.labels, a.L, a.C);
  else
    viterbi_warp_kernel<kG, false><<<a.B, 32, a.smem, a.stream>>>(
        a.unary, a.trans, a.mask, a.back, a.labels, a.L, a.C);
}

// The warp kernel's builds, by candidate groups kG = 1..8.
constexpr void (*kWarpLaunch[8])(const WarpLaunch&, bool) = {
    warp_launch<1>, warp_launch<2>, warp_launch<3>, warp_launch<4>,
    warp_launch<5>, warp_launch<6>, warp_launch<7>, warp_launch<8>};

// The builds: the staged kernels may take dynamic shared memory above 48
// KB; the scratch ones hold the table and two score rows (at most 48 KB:
// kernels/viterbi.py::MAX_LABELS).
const repro::Build kBuilds[] = {
    REPRO_BUILD(kSmemLimit, viterbi_block_kernel<true>),
    REPRO_BUILD(0, viterbi_block_kernel<false>),
    REPRO_BUILD(kSmemLimit, viterbi_warp_kernel<1, true>),
    REPRO_BUILD(kSmemLimit, viterbi_warp_kernel<2, true>),
    REPRO_BUILD(kSmemLimit, viterbi_warp_kernel<3, true>),
    REPRO_BUILD(kSmemLimit, viterbi_warp_kernel<4, true>),
    REPRO_BUILD(kSmemLimit, viterbi_warp_kernel<5, true>),
    REPRO_BUILD(kSmemLimit, viterbi_warp_kernel<6, true>),
    REPRO_BUILD(kSmemLimit, viterbi_warp_kernel<7, true>),
    REPRO_BUILD(kSmemLimit, viterbi_warp_kernel<8, true>),
    REPRO_BUILD(0, viterbi_warp_kernel<1, false>),
    REPRO_BUILD(0, viterbi_warp_kernel<2, false>),
    REPRO_BUILD(0, viterbi_warp_kernel<3, false>),
    REPRO_BUILD(0, viterbi_warp_kernel<4, false>),
    REPRO_BUILD(0, viterbi_warp_kernel<5, false>),
    REPRO_BUILD(0, viterbi_warp_kernel<6, false>),
    REPRO_BUILD(0, viterbi_warp_kernel<7, false>),
    REPRO_BUILD(0, viterbi_warp_kernel<8, false>),
};

}  // namespace

// Shared memory one block of the given plan takes.
extern "C" long long viterbi_smem_bytes(int L, int C, int staged) {
  return static_cast<long long>(smem_bytes(L, C, staged != 0));
}

// Once, when the library loads (never inside a graph capture): the staged
// variant may take dynamic shared memory above 48 KB.  Returns a
// cudaError_t.
extern "C" int viterbi_init(void) {
  return static_cast<int>(repro::grant(kBuilds));
}

// One build's attributes (builds.cuh repro::attributes).
extern "C" int viterbi_attributes(int build, int threads, long long dyn_smem,
                                  int cluster, long long* out) {
  return repro::attributes(kBuilds, build, threads, dyn_smem, cluster, out);
}

// Launches one block per row on `stream` and returns cudaGetLastError().
// `staged` picks the plan's variant; the scratch variant needs `back`
// ((B, L-1, C) int32), the staged one ignores it.  The Python wrapper
// checks beforehand that C fits one block (kernels/viterbi.py::MAX_LABELS)
// and that the plan's shared memory fits.
extern "C" int viterbi_decode_launch(const float* unary, const float* trans,
                                     const unsigned char* mask, int* back,
                                     int* labels, int B, int L, int C,
                                     int staged, void* stream) {
  const size_t smem = smem_bytes(L, C, staged != 0);
  if (L < 1 || C < 1 || smem > static_cast<size_t>(kSmemLimit) ||
      (!staged && L > 1 && back == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((C + 31) / 32) * 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 32) {
    const WarpLaunch args{unary, trans, mask, back, labels, B, L, C, smem, s};
    kWarpLaunch[(C + 3) / 4 - 1](args, staged != 0);
  } else if (staged)
    viterbi_block_kernel<true><<<B, threads, smem, s>>>(
        unary, trans, mask, back, labels, L, C);
  else
    viterbi_block_kernel<false><<<B, threads, smem, s>>>(
        unary, trans, mask, back, labels, L, C);
  return static_cast<int>(cudaGetLastError());
}
