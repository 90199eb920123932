// Causal flash attention (the LM backbone's prefill attention), written by
// hand for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention, the Pallas
// TPU kernel.  For every (batch, head) and query row i < S:
//
//     s[j] = <q[i], k[j]> * sm_scale            for j <= i
//     o[i] = sum_j softmax(s)[j] v[j]
//
// with the TPU kernel's numerics: scores, running max, running sum and the
// accumulator in fp32; masked scores at INVALID_SCORE (-1e30); each block's
// probabilities p are rounded to v's type before p.v (bf16 on the model
// path), while the running sum takes them unrounded; o = acc / max(l,
// 1e-30), written in q's type.
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
// causal flops.
//
// Design: one CTA of 256 threads per (bh, q block of BQ = 64 rows, or 32
// for S <= 32), a loop over BQ-row k/v blocks up to the diagonal only.
// The q tile and each k/v tile sit in shared memory as fp32 (rows padded
// to 129 floats, so a warp's 16 distinct k rows fall in 16 banks).  Thread
// (ty, tx) owns score rows ty + 16i and columns tx + 16j (BQ/16 x BQ/16),
// and output rows ty + 16i and columns tx + 16j (BQ/16 x 8, D <= 128) in
// registers.  256/BQ adjacent threads share a row for the online-softmax
// update.  Plain fp32 FMAs: no tensor cores, no atomics, nothing carried
// between CTAs.  A simple kernel that is right; a wgmma/TMA version is
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 128;        // largest head dim
constexpr int kPad = kMaxD + 1;   // shared row stride (floats)
constexpr int kThreads = 256;
constexpr float kInvalid = -1e30f;   // INVALID_SCORE, as the TPU kernel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);      // round to nearest even, as astype()
}

struct Strides {   // in elements; unit stride over the head dim
  long long b, s, h;
};

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
template <typename T, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int group, int S, int D, Strides qs, Strides ks,
                       Strides vs, Strides os, float sm_scale) {
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

  // k blocks up to the diagonal of this q block (and within S).
  const int q_last = min(q0 + kBQ, S) - 1;
  const int n_kb = q_last / kBK + 1;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();   // the previous block's Ks/Vs/Ps reads are done
    load_tile(Ks, k, ks, b, hk, k0, S, D, kBK);
    load_tile(Vs, v, vs, b, hk, k0, S, D, kBK);
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
            row >= col ? s[i][j] * sm_scale : kInvalid;
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
        vv[j] = (tx + 16 * j) < D ? Vs[kk * kPad + tx + 16 * j] : 0.0f;
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
      if (d < D) orow[d] = from_f<T>(acc[i][j] * inv);
    }
  }
}

constexpr size_t smem_bytes(int bq) {
  return sizeof(float) * (3 * bq * kPad + bq * (bq + 1) + 3 * bq);
}

template <typename T, int BQ>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int K, int S, int D, const long long* st, float sm_scale,
           cudaStream_t stream) {
  constexpr size_t kSmem = smem_bytes(BQ);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, BQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_attention_kernel<T, BQ><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / K, S, D, qs, ks, vs,
      os, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// 32-row blocks for S <= 32 (the backbone's sequences: a quarter of the
// work of a 64-row block, and four CTAs per SM), 64-row blocks above.
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int K, int S, int D, const long long* st, float sm_scale,
             cudaStream_t stream) {
  if (S <= 32)
    return launch<T, 32>(q, k, v, o, B, H, K, S, D, st, sm_scale, stream);
  return launch<T, 64>(q, k, v, o, B, H, K, S, D, st, sm_scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, (batch,
// seq, head) of q, k, v and o in turn.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); an argument the kernel cannot take
// returns cudaErrorInvalidValue without launching.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int K, int S, int D,
                                      const long long* strides, float sm_scale,
                                      void* stream) {
  if (D < 1 || D > kMaxD || K < 1 || H % K != 0 || S < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, H, K, S, D, strides, sm_scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, K, S, D, strides,
                                   sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
