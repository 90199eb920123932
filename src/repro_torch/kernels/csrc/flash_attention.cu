// Flash attention (the LM backbone's prefill attention), written by hand
// for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention, the Pallas
// TPU kernel.  For every (batch, head) and query row i < S:
//
//     s[j] = <q[i], k[j]> * sm_scale            for j in the row's mask
//     o[i] = sum_j softmax(s)[j] v[j]
//
// Three masks, each a build of its own (the MASK template parameter):
// causal, j <= i (the TPU kernel's); window, i - W < j <= i with W a
// trailing kernel parameter (zamba2's shared attention under its
// long-context override; chunked_causal_attention's sliding_window); and
// bidirectional, every j < S (whisper's encoder).  The window build starts
// a CTA's k/v loop at the first block any of its rows can see, so its work
// is ~S W, not S^2 / 2.  A row whose first visited block lies wholly
// outside its window scores only INVALID_SCORE there: its running max
// stays at INVALID_SCORE and that block adds exp(0) = 1 per key to the
// sum and the accumulator, which the first real score's
// alpha = exp(INVALID_SCORE - m) = 0 wipes out (the diagonal block always
// brings one).  The bidirectional build masks the zero-filled tile past S
// explicitly, where the causal mask's j <= i did it before.
//
// q and k have head dim D, v and o head dim Dv (MLA: D = 192, Dv = 128;
// GQA: D = Dv), with the TPU kernel's numerics: scores, running max,
// running sum and the accumulator in fp32; masked scores at INVALID_SCORE
// (-1e30); each block's probabilities p are rounded to v's type before
// p.v (bf16 on the model path), while the running sum takes them
// unrounded; o = acc / max(l, 1e-30), written in q's type.
//
// Layout: q, k, v and o are read and written in the model's (B, S, H, hd)
// layout through their strides (unit stride over hd), so the caller makes
// no transposed copies.  k and v may have fewer heads than q (grouped-query
// attention): head h reads kv head h / (H / K), so they are never repeated
// either.  A (BH, S, D) tensor is the case B = BH, H = K = 1.
//
// Bound: bytes at the backbone's shape.  At BH = 16384, S = 32, D = 128
// bf16 a call reads q, k, v once and writes o once: 4 * 16384*32*128*2 B =
// 0.54 GB, 0.16 ms at 3.35 TB/s, against 2*2*16384*32*32*128/2 = 2.2e9
// causal flops, ~2 us of the bf16 tensor cores.  So the design is about
// keeping enough bytes in flight, not about the math.
//
// bfloat16 design (the model path): one CTA of NW warps per (bh, q block of
// BQ = 16 NW rows), each warp owning 16 query rows, a loop over BK-row k/v
// blocks up to the diagonal only.  q, k and v stay bf16 in shared memory
// (rows padded by 16 bytes, so ldmatrix's eight 16-byte row reads hit 32
// distinct banks), loaded with 16-byte cp.async copies (zero-filled past S
// and past D); with more than one k/v block, block kb+1 is in flight while
// block kb computes (a two-stage ring).  At the backbone's S = 32 a CTA is
// 2 warps and 26 KB, one k/v block, so ~7 CTAs share an SM and their loads
// overlap each other's math: the "next (b, h) tile in flight" comes from
// occupancy, not from a persistent loop.  QK^T and P.V run on the tensor
// cores as warp-level mma.sync.m16n8k16 (bf16 inputs, fp32 accumulators):
// a 64-row wgmma tile would be half empty at S = 32 for one head, and the
// kernel is bound by bytes, so the warp-level instruction loses nothing.
// The S accumulator fragments become P's A fragments in registers (p
// rounded to bf16 there, the row sum taken before the rounding); V's B
// fragments come from ldmatrix.trans.  The output goes through the warp's
// own q rows in shared memory to 16-byte stores.  A shape whose rows are
// not 16-byte aligned (D or a stride not a multiple of 8 elements, or an
// unaligned base) loads and stores element by element, same math.
//
// Builds.  A head-dim pair is a build of its own (the loop bounds and the
// fragment arrays are compile-time): bf16 D = Dv padded to 32, 64 or 128,
// and the MLA build, D <= 192 with Dv <= 128 (q and k tiles 192 wide, the
// accumulator and the output 128).  At 64 query rows and two k/v stages
// the MLA build takes 2 (64 x 200 + 2 x 64 x (200 + 136)) = 111,616 bytes
// of shared memory, under the 227 KB a block can use (checked at compile
// time).  The Pallas kernel pads D to 128 lanes and takes one D for q, k
// and v; here nothing is padded past the build's width.
//
// bf16 scores (the model's attn_score_dtype = "bf16",
// repro/models/attention.py:81-124: q.k taken in bf16, scaled by a bf16
// scale) are a build of their own of each bf16 causal and window build
// and of the MLA build (the SB template parameter): the score is rounded
// to bf16 after the mma's fp32 accumulation and again after the product
// with the bf16-rounded scale, before the mask and the running max;
// everything after is the fp32-score build's.  The reference keeps its
// bidirectional (encoder) attention in fp32, so no bidirectional build
// takes bf16 scores.
//
// The window and bidirectional builds run 64-row tiles whatever S (bf16:
// 4 warps and 64-key blocks; the 32-row tiles are the backbone's short
// causal sequences'), and the MLA build is causal only: the reference
// windows no MLA layer.
//
// float32 design: fp32 inputs stay on plain FMAs, because the tensor
// cores would take them as TF32 and change the reference's numbers.  One
// CTA of 256 threads per (bh, q block of 64 rows, or 32 for S <= 32);
// fp32 tiles in shared memory (rows padded to 129 floats); thread (ty, tx)
// owns score rows ty + 16i and columns tx + 16j and output columns tx +
// 16j; 256/BQ adjacent threads share a row for the online-softmax update.
// D and Dv are run-time values up to 128 each.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "builds.cuh"

namespace {

constexpr int kMaxD = 128;        // largest head dim of the fp32 path
constexpr int kSmemLimit = repro::kSmemLimit;  // what a block may opt into
constexpr int kPad = kMaxD + 1;   // shared row stride (floats)
constexpr int kThreads = 256;
constexpr float kInvalid = -1e30f;   // INVALID_SCORE, as the TPU kernel
// The masks (a build each): j <= i; i - W < j <= i; j < S.
constexpr int kCausal = 0, kWindow = 1, kBidir = 2;

// Whether query row `row` sees key `col` under MASK (W: the window).
template <int MASK>
__device__ __forceinline__ bool visible(int row, int col, int S, int W) {
  if (MASK == kBidir) return col < S;
  if (MASK == kWindow) return row >= col && col > row - W;
  return row >= col;
}

// The k/v blocks [first, end) a CTA of query rows [q0, q0 + BQ) visits.
template <int MASK>
__device__ __forceinline__ int2 kv_blocks(int q0, int BQ, int BK, int S,
                                          int W) {
  if (MASK == kBidir) return make_int2(0, (S - 1) / BK + 1);
  const int end = (min(q0 + BQ, S) - 1) / BK + 1;
  return make_int2(MASK == kWindow ? max(0, q0 - W + 1) / BK : 0, end);
}

struct Strides {   // in elements; unit stride over the head dim
  long long b, s, h;
};

// ---------------------------------------------------------------------------
// float32: plain FMAs (instantiated for T = float only).

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          Strides st, int b, int h, int row0,
                                          int S, int D, int rows) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, s = row0 + r;
    float val = 0.0f;
    if (s < S)
      val = to_f(base[b * st.b + static_cast<long long>(s) * st.s +
                      h * st.h + d]);
    dst[r * kPad + d] = val;
  }
}

// BQ q rows per CTA and BK = BQ k/v rows per inner block (32 or 64).
template <typename T, int BQ, int MASK>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int group, int S, int D, Strides qs, Strides ks,
                       Strides vs, Strides os, float sm_scale, int Dv,
                       int W) {
  constexpr int kBQ = BQ, kBK = BQ;
  constexpr int RI = kBQ / 16, RJ = kBK / 16;   // score rows, cols / thread
  constexpr int TPR = kThreads / kBQ;           // threads per softmax row
  constexpr int CPR = kBK / TPR;                // their columns each
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBQ][kPad]
  float* Ks = Qs + kBQ * kPad;         // [kBK][kPad]
  float* Vs = Ks + kBK * kPad;         // [kBK][kPad]
  float* Ps = Vs + kBK * kPad;         // [kBQ][kBK + 1]: scores, then p
  float* m_s = Ps + kBQ * (kBK + 1);   // [kBQ] running max
  float* l_s = m_s + kBQ;              // [kBQ] running sum
  float* a_s = l_s + kBQ;              // [kBQ] rescale of this block

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / group;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile(Qs, q, qs, b, h, q0, S, D, kBQ);
  if (tid < kBQ) {
    m_s[tid] = kInvalid;
    l_s[tid] = 0.0f;
  }
  float acc[RI][8];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // k blocks up to the diagonal of this q block (and within S), from the
  // first one the window lets a row see; every block within S when
  // bidirectional.
  const int2 kbs = kv_blocks<MASK>(q0, kBQ, kBK, S, W);
  for (int kb = kbs.x; kb < kbs.y; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();   // the previous block's Ks/Vs/Ps reads are done
    load_tile(Ks, k, ks, b, hk, k0, S, D, kBK);
    load_tile(Vs, v, vs, b, hk, k0, S, Dv, kBK);
    __syncthreads();

    // Scores: rows ty + 16i, columns tx + 16j.
    float s[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * kPad + d];
#pragma unroll
      for (int j = 0; j < RJ; ++j) kv[j] = Ks[(tx + 16 * j) * kPad + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int row = q0 + ty + 16 * i, col = k0 + tx + 16 * j;
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] =
            visible<MASK>(row, col, S, W) ? s[i][j] * sm_scale : kInvalid;
      }
    __syncthreads();

    // Online softmax: TPR adjacent threads per row, CPR columns each.
    {
      const int r = tid / TPR, part = tid % TPR;
      float* prow = Ps + r * (kBK + 1) + part * CPR;
      float mx = kInvalid;
#pragma unroll
      for (int c = 0; c < CPR; ++c) mx = fmaxf(mx, prow[c]);
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < CPR; ++c) {
        const float p = expf(prow[c] - m_new);
        sum += p;
        prow[c] = to_f(from_f<T>(p));   // p cast to v's type before p.v
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + p . v
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[RI], vv[8];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        vv[j] = (tx + 16 * j) < Dv ? Vs[kk * kPad + tx + 16 * j] : 0.0f;
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i, s = q0 + r;
    if (s >= S) continue;
    const float inv = 1.0f / fmaxf(l_s[r], 1e-30f);
    T* orow = o + b * os.b + static_cast<long long>(s) * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = tx + 16 * j;
      if (d < Dv) orow[d] = from_f<T>(acc[i][j] * inv);
    }
  }
}

constexpr size_t smem_bytes(int bq) {
  return sizeof(float) * (3 * bq * kPad + bq * (bq + 1) + 3 * bq);
}

template <typename T, int BQ, int MASK>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int K, int S, int D, int Dv, const long long* st,
           float sm_scale, int W, cudaStream_t stream) {
  constexpr size_t kSmem = smem_bytes(BQ);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_attention_kernel<T, BQ, MASK><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / K, S, D, qs, ks, vs,
      os, sm_scale, Dv, W);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores.

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) . b (16x8, col), bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to bf16 (nearest even), back in fp32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two floats rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ROWS x DP tile of rows row0.. of head h into shared rows of LD elements:
// 16-byte cp.async chunks (vec), or element loads; zeros past S and D.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* base,
                                               Strides st, int b, int h,
                                               int row0, int S, int D,
                                               bool vec) {
  constexpr int LD = DP + 8, CH = DP / 8;
  const bf16* head = base + b * st.b + h * st.h;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH, s = row0 + r;
    bf16* d = dst + r * LD + c * 8;
    if (vec) {
      const bool ok = s < S && c * 8 < D;
      cp_async16(d, ok ? head + s * st.s + c * 8 : head, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = c * 8 + e;
        d[e] = (s < S && col < D) ? head[s * st.s + col]
                                  : __float2bfloat16(0.0f);
      }
    }
  }
}

// DQ: q/k head dim padded (32, 64, 128 or 192), DV: v's (DV <= DQ); NW
// warps of 16 q rows; BK-row k/v blocks; MASK one of the three masks, W
// the window's width; SB: bf16 scores (each score rounded to bf16 after
// the mma and again after the bf16 scale).  Dynamic shared memory: q
// [BQ][LDQ], then one or two stages of k [BK][LDQ] and v [BK][LDV].
template <int DQ, int DV, int NW, int BK, int MASK, bool SB>
__global__ void __launch_bounds__(NW * 32)
flash_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o,
                            int H, int group, int S, int D, Strides qs,
                            Strides ks, Strides vs, Strides os,
                            float sm_scale, int vec, int Dv, int W) {
  static_assert(DV <= DQ, "the output goes through q's shared rows");
  static_assert(!SB || MASK != kBidir, "bf16 scores are causal only");
  if (SB) sm_scale = round_bf16(sm_scale);
  constexpr int NT = NW * 32, BQ = 16 * NW, LDQ = DQ + 8, LDV = DV + 8;
  constexpr int NS = BK / 8;    // score n-tiles (8 keys each)
  constexpr int NKD = DQ / 16;  // k-steps over the q/k head dim
  constexpr int NO = DV / 8;    // output n-tiles (8 dims each)
  constexpr int STAGE = BK * (LDQ + LDV);   // one stage: k, then v
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KV = Qs + BQ * LDQ;     // stage x at KV + x STAGE

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / group;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // fragment row, column pair
  const int2 kbs = kv_blocks<MASK>(q0, BQ, BK, S, W);
  const int kb0 = kbs.x, n_kb = kbs.y;

  load_tile_bf16<BQ, DQ, NT>(Qs, q, qs, b, h, q0, S, D, vec);
  load_tile_bf16<BK, DQ, NT>(KV, k, ks, b, hk, kb0 * BK, S, D, vec);
  load_tile_bf16<BK, DV, NT>(KV + BK * LDQ, v, vs, b, hk, kb0 * BK, S, Dv,
                             vec);
  cp_async_commit();

  uint32_t qf[NKD][4];
  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;
  float m_r[2] = {kInvalid, kInvalid}, l_r[2] = {0.0f, 0.0f};
  const int row0 = q0 + 16 * warp + g;     // this thread's rows: +0, +8

  for (int kb = kb0; kb < n_kb; ++kb) {
    const int stage = (kb - kb0) & 1;
    if (kb + 1 < n_kb) {                   // next block into the other stage
      bf16* nxt = KV + (stage ^ 1) * STAGE;
      load_tile_bf16<BK, DQ, NT>(nxt, k, ks, b, hk, (kb + 1) * BK, S, D, vec);
      load_tile_bf16<BK, DV, NT>(nxt + BK * LDQ, v, vs, b, hk, (kb + 1) * BK,
                                 S, Dv, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kb == kb0) {
#pragma unroll
      for (int kd = 0; kd < NKD; ++kd)
        ldmatrix_x4(qf[kd], Qs + (16 * warp + (lane & 15)) * LDQ + kd * 16 +
                                (lane >> 4) * 8);
    }
    const bf16* Ks = KV + stage * STAGE;
    const bf16* Vs = Ks + BK * LDQ;

    // S = Q K^T for this warp's 16 rows and the block's BK keys.
    float sacc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < NKD; ++kd)
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t r[4];
        ldmatrix_x4(r, Ks + (16 * jp + (lane >> 4) * 8 + (lane & 7)) * LDQ +
                           kd * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sacc[2 * jp], qf[kd], r[0], r[1]);
        mma_bf16(sacc[2 * jp + 1], qf[kd], r[2], r[3]);
      }

    // Scale and mask; the rows' maxima over the 4 threads sharing them.
    const int k0 = kb * BK;
    float mx[2] = {kInvalid, kInvalid};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const float raw = SB ? round_bf16(round_bf16(sacc[j][e]) * sm_scale)
                             : sacc[j][e] * sm_scale;
        const float sc = visible<MASK>(row, col, S, W) ? raw : kInvalid;
        sacc[j][e] = sc;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc);
      }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }
    // p = exp(s - m): the sum unrounded, P's A fragments rounded to bf16.
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p0 = expf(sacc[j][0] - m_r[0]);
      const float p1 = expf(sacc[j][1] - m_r[0]);
      const float p2 = expf(sacc[j][2] - m_r[1]);
      const float p3 = expf(sacc[j][3] - m_r[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_r[r] = alpha[r] * l_r[r] + sum[r];
    }

    // acc = alpha acc + P V.
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Vs + (kk * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * LDV +
                                 np * 16 + (lane >> 4) * 8);
        mma_bf16(oacc[2 * np], pa[kk], r[0], r[1]);
        mma_bf16(oacc[2 * np + 1], pa[kk], r[2], r[3]);
      }
    __syncthreads();   // every warp is done with this stage
  }

  // o = acc / max(l, 1e-30) in bf16, through this warp's q rows.
  const float inv0 = 1.0f / fmaxf(l_r[0], 1e-30f);
  const float inv1 = 1.0f / fmaxf(l_r[1], 1e-30f);
  bf16* Os = Qs + 16 * warp * LDQ;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(Os + g * LDQ + 8 * n + 2 * t) =
        __floats2bfloat162_rn(oacc[n][0] * inv0, oacc[n][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(Os + (g + 8) * LDQ + 8 * n + 2 * t) =
        __floats2bfloat162_rn(oacc[n][2] * inv1, oacc[n][3] * inv1);
  }
  __syncwarp();
  constexpr int CH = DV / 8;
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c = idx % CH, s = q0 + 16 * warp + r;
    if (s >= S || c * 8 >= Dv) continue;
    bf16* dst = o + b * os.b + s * os.s + h * os.h + c * 8;
    const bf16* src = Os + r * LDQ + c * 8;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c * 8 + e < Dv; ++e) dst[e] = src[e];
    }
  }
}

// The bf16 build's dynamic shared memory at two k/v stages (its init's
// grant; a launch over one k/v block takes one stage).
constexpr size_t bf16_smem(int dq, int dv, int nw, int bk) {
  return sizeof(bf16) * (16 * nw * (dq + 8) + 2 * bk * (dq + 8 + dv + 8));
}

template <int DQ, int DV, int NW, int BK, int MASK, bool SB>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int H, int K, int S, int D, int Dv, const Strides* st,
                float sm_scale, int vec, int W, cudaStream_t stream) {
  constexpr int BQ = 16 * NW, LDQ = DQ + 8, LDV = DV + 8;
  static_assert(bf16_smem(DQ, DV, NW, BK) <= kSmemLimit,
                "tiles past a block's shared memory");
  const int stages = S > BK ? 2 : 1;
  const size_t smem = sizeof(bf16) * (BQ * LDQ + stages * BK * (LDQ + LDV));
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_attention_bf16_kernel<DQ, DV, NW, BK, MASK, SB>
      <<<grid, NW * 32, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(o), H, H / K, S, D,
          st[0], st[1], st[2], st[3], sm_scale, vec, Dv, W);
  return static_cast<int>(cudaGetLastError());
}

// Causal: 2 warps and 32-key blocks for S <= 32 (the backbone's sequences:
// one k/v block, ~7 CTAs per SM); 4 warps and 64-key blocks above.  The
// window and bidirectional builds: 4 warps and 64-key blocks at every S.
template <int DQ, int DV, int MASK, bool SB>
int dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                  int B, int H, int K, int S, int D, int Dv,
                  const Strides* st, float sm_scale, int vec, int W,
                  cudaStream_t stream) {
  if constexpr (MASK == kCausal) {
    if (S <= 32)
      return launch_bf16<DQ, DV, 2, 32, kCausal, SB>(q, k, v, o, B, H, K, S,
                                                     D, Dv, st, sm_scale, vec,
                                                     W, stream);
  }
  return launch_bf16<DQ, DV, 4, 64, MASK, SB>(q, k, v, o, B, H, K, S, D, Dv,
                                              st, sm_scale, vec, W, stream);
}

// The D = Dv builds (padded to 32, 64 or 128) under one mask.
template <int MASK, bool SB>
int dispatch_square(const void* q, const void* k, const void* v, void* o,
                    int B, int H, int K, int S, int D, const Strides* st,
                    float sm_scale, int vec, int W, cudaStream_t stream) {
  if (D <= 32)
    return dispatch_bf16<32, 32, MASK, SB>(q, k, v, o, B, H, K, S, D, D, st,
                                           sm_scale, vec, W, stream);
  if (D <= 64)
    return dispatch_bf16<64, 64, MASK, SB>(q, k, v, o, B, H, K, S, D, D, st,
                                           sm_scale, vec, W, stream);
  return dispatch_bf16<128, 128, MASK, SB>(q, k, v, o, B, H, K, S, D, D, st,
                                           sm_scale, vec, W, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The bf16 builds of one score type: the MLA build (causal) or the D = Dv
// builds under `mask`.
template <bool SB>
int dispatch_scores(const void* q, const void* k, const void* v, void* o,
                    int B, int H, int K, int S, int D, int Dv,
                    const Strides* sv, float sm_scale, int vec, int mask,
                    int W, cudaStream_t st) {
  if (Dv < D && D <= 192 && Dv <= 128) {
    if (mask != kCausal) return static_cast<int>(cudaErrorInvalidValue);
    return dispatch_bf16<192, 128, kCausal, SB>(q, k, v, o, B, H, K, S, D, Dv,
                                                sv, sm_scale, vec, W, st);
  }
  if (Dv != D || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (mask == kWindow)
    return dispatch_square<kWindow, SB>(q, k, v, o, B, H, K, S, D, sv,
                                        sm_scale, vec, W, st);
  if constexpr (!SB) {
    if (mask == kBidir)
      return dispatch_square<kBidir, false>(q, k, v, o, B, H, K, S, D, sv,
                                            sm_scale, vec, W, st);
  }
  return dispatch_square<kCausal, SB>(q, k, v, o, B, H, K, S, D, sv, sm_scale,
                                      vec, W, st);
}

// The builds (masks: 0 causal, 1 window, 2 bidirectional), each granted
// its own largest dynamic shared memory.
const repro::Build kBuilds[] = {
    // float32 on FMAs: 32-row causal tiles for S <= 32, else 64 rows.
    REPRO_BUILD(smem_bytes(32), flash_attention_kernel<float, 32, 0>),
    REPRO_BUILD(smem_bytes(64), flash_attention_kernel<float, 64, 0>),
    REPRO_BUILD(smem_bytes(64), flash_attention_kernel<float, 64, 1>),
    REPRO_BUILD(smem_bytes(64), flash_attention_kernel<float, 64, 2>),
    // bfloat16 on mma.sync, fp32 scores: (q/k, v) head dims, warps,
    // keys per block, mask.
    REPRO_BUILD(bf16_smem(32, 32, 2, 32),
                flash_attention_bf16_kernel<32, 32, 2, 32, 0, false>),
    REPRO_BUILD(bf16_smem(32, 32, 4, 64),
                flash_attention_bf16_kernel<32, 32, 4, 64, 0, false>),
    REPRO_BUILD(bf16_smem(32, 32, 4, 64),
                flash_attention_bf16_kernel<32, 32, 4, 64, 1, false>),
    REPRO_BUILD(bf16_smem(32, 32, 4, 64),
                flash_attention_bf16_kernel<32, 32, 4, 64, 2, false>),
    REPRO_BUILD(bf16_smem(64, 64, 2, 32),
                flash_attention_bf16_kernel<64, 64, 2, 32, 0, false>),
    REPRO_BUILD(bf16_smem(64, 64, 4, 64),
                flash_attention_bf16_kernel<64, 64, 4, 64, 0, false>),
    REPRO_BUILD(bf16_smem(64, 64, 4, 64),
                flash_attention_bf16_kernel<64, 64, 4, 64, 1, false>),
    REPRO_BUILD(bf16_smem(64, 64, 4, 64),
                flash_attention_bf16_kernel<64, 64, 4, 64, 2, false>),
    REPRO_BUILD(bf16_smem(128, 128, 2, 32),
                flash_attention_bf16_kernel<128, 128, 2, 32, 0, false>),
    REPRO_BUILD(bf16_smem(128, 128, 4, 64),
                flash_attention_bf16_kernel<128, 128, 4, 64, 0, false>),
    REPRO_BUILD(bf16_smem(128, 128, 4, 64),
                flash_attention_bf16_kernel<128, 128, 4, 64, 1, false>),
    REPRO_BUILD(bf16_smem(128, 128, 4, 64),
                flash_attention_bf16_kernel<128, 128, 4, 64, 2, false>),
    REPRO_BUILD(bf16_smem(192, 128, 2, 32),
                flash_attention_bf16_kernel<192, 128, 2, 32, 0, false>),
    REPRO_BUILD(bf16_smem(192, 128, 4, 64),
                flash_attention_bf16_kernel<192, 128, 4, 64, 0, false>),
    // bfloat16 on mma.sync, bf16 scores (-s16): (q/k, v) head dims, warps,
    // keys per block, mask.
    REPRO_BUILD(bf16_smem(32, 32, 2, 32),
                flash_attention_bf16_kernel<32, 32, 2, 32, 0, true>),
    REPRO_BUILD(bf16_smem(32, 32, 4, 64),
                flash_attention_bf16_kernel<32, 32, 4, 64, 0, true>),
    REPRO_BUILD(bf16_smem(32, 32, 4, 64),
                flash_attention_bf16_kernel<32, 32, 4, 64, 1, true>),
    REPRO_BUILD(bf16_smem(64, 64, 2, 32),
                flash_attention_bf16_kernel<64, 64, 2, 32, 0, true>),
    REPRO_BUILD(bf16_smem(64, 64, 4, 64),
                flash_attention_bf16_kernel<64, 64, 4, 64, 0, true>),
    REPRO_BUILD(bf16_smem(64, 64, 4, 64),
                flash_attention_bf16_kernel<64, 64, 4, 64, 1, true>),
    REPRO_BUILD(bf16_smem(128, 128, 2, 32),
                flash_attention_bf16_kernel<128, 128, 2, 32, 0, true>),
    REPRO_BUILD(bf16_smem(128, 128, 4, 64),
                flash_attention_bf16_kernel<128, 128, 4, 64, 0, true>),
    REPRO_BUILD(bf16_smem(128, 128, 4, 64),
                flash_attention_bf16_kernel<128, 128, 4, 64, 1, true>),
    REPRO_BUILD(bf16_smem(192, 128, 2, 32),
                flash_attention_bf16_kernel<192, 128, 2, 32, 0, true>),
    REPRO_BUILD(bf16_smem(192, 128, 4, 64),
                flash_attention_bf16_kernel<192, 128, 4, 64, 0, true>),
};

}  // namespace

// Once, when the library loads (never inside a graph capture): each build
// may take its dynamic shared memory.  Returns a cudaError_t.
extern "C" int flash_attention_init(void) {
  return static_cast<int>(repro::grant(kBuilds));
}

// One build's attributes (builds.cuh repro::attributes).
extern "C" int flash_attention_attributes(int build, int threads,
                                          long long dyn_smem, int cluster,
                                          long long* out) {
  return repro::attributes(kBuilds, build, threads, dyn_smem, cluster, out);
}

// dtype: 0 = float32, 1 = bfloat16.  D: q's and k's head dim, Dv: v's
// and o's.  strides: 12 element strides, (batch, seq, head) of q, k, v and
// o in turn.  mask: 0 causal, 1 causal within a window of W keys (W >= 1),
// 2 bidirectional.  score_bf16: 1 runs the bf16-score builds (bfloat16,
// causal or window: each score rounded to bf16 after the mma and after
// the bf16-rounded scale), 0 the fp32-score ones.  Launches on `stream`
// and returns cudaGetLastError() (0 on success); an argument no build
// takes returns cudaErrorInvalidValue without launching: float32 takes D,
// Dv <= 128 under each mask; bfloat16 D = Dv <= 128 under each mask, or
// Dv < D <= 192 with Dv <= 128 causal (the MLA build).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int K, int S, int D, int Dv,
                                      const long long* strides, float sm_scale,
                                      void* stream, int mask, int W,
                                      int score_bf16) {
  if (D < 1 || Dv < 1 || K < 1 || H % K != 0 || S < 1 || B < 1 ||
      mask < kCausal || mask > kBidir || (mask == kWindow && W < 1) ||
      (score_bf16 && (dtype != 1 || mask == kBidir)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D > kMaxD || Dv > kMaxD)
      return static_cast<int>(cudaErrorInvalidValue);
    if (mask == kWindow)
      return launch<float, 64, kWindow>(q, k, v, o, B, H, K, S, D, Dv,
                                        strides, sm_scale, W, st);
    if (mask == kBidir)
      return launch<float, 64, kBidir>(q, k, v, o, B, H, K, S, D, Dv,
                                       strides, sm_scale, W, st);
    if (S <= 32)
      return launch<float, 32, kCausal>(q, k, v, o, B, H, K, S, D, Dv,
                                        strides, sm_scale, W, st);
    return launch<float, 64, kCausal>(q, k, v, o, B, H, K, S, D, Dv, strides,
                                      sm_scale, W, st);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sv[4] = {{strides[0], strides[1], strides[2]},
                         {strides[3], strides[4], strides[5]},
                         {strides[6], strides[7], strides[8]},
                         {strides[9], strides[10], strides[11]}};
  // 16-byte rows: D, Dv and every stride a multiple of 8 elements, bases
  // 16-byte aligned.
  bool vec = D % 8 == 0 && Dv % 8 == 0 && aligned16(q) && aligned16(k) &&
             aligned16(v) && aligned16(o);
  for (int i = 0; i < 12; ++i) vec = vec && strides[i] % 8 == 0;
  if (score_bf16)
    return dispatch_scores<true>(q, k, v, o, B, H, K, S, D, Dv, sv, sm_scale,
                                 vec, mask, W, st);
  return dispatch_scores<false>(q, k, v, o, B, H, K, S, D, Dv, sv, sm_scale,
                                vec, mask, W, st);
}
