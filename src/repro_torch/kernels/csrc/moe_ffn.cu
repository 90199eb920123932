// Grouped SwiGLU expert FFN of the MoE layers, written by hand for Hopper
// (sm_90a).
//
// Replaces repro/kernels/moe_ffn.py::moe_ffn, the Pallas TPU kernel.  For
// every expert e and capacity slot c:
//
//     g = x[e, c] wg[e],  u = x[e, c] wu[e]          (D -> F, fp32 sums)
//     h = silu(g) * u, rounded to wd's type
//     y[e, c] = h wd[e]                              (F -> D, fp32 sums)
//
// y written in x's type: the TPU kernel's numerics.  xs (E, C, D), wg and
// wu (E, D, F), wd (E, F, D), all contiguous, float32 or bfloat16 alike.
//
// Bound.  The backbone's shape (E, C, D, F) = (64, 5120, 2048, 1024) does
// 6*E*C*D*F = 4.12e12 flops against ~3.5 GB of traffic: operations, about
// 4.2 ms at the bf16 tensor-core peak.  The decode shape (64, 1, 2048,
// 1024) reads all experts' weights, 805 MB for 0.8 GFLOP: bytes, about
// 0.24 ms at 3.35 TB/s.
//
// Design: one CTA of 256 threads per (expert, tile of BC capacity rows),
// the C tiles of one expert adjacent in the grid so that they share its
// weights in L2.  Like the TPU kernel, the (C, F) activations never reach
// device memory:
//   phase 1: for each 64-wide F tile, g and u of the BC rows accumulate
//            over D chunks staged in shared memory; h is rounded and kept
//            in shared memory for the whole F (BC x F, 128 KB at BC = 64,
//            F = 1024 in bf16);
//   phase 2: for each 64-wide D tile, y accumulates over F chunks of wd
//            staged in shared memory, and is written straight to y.
// No atomics and no (C, D) fp32 accumulator anywhere.  Ragged C, D and F
// are masked in the loads and stores.  Two paths share that structure:
//   - bf16 on the tensor cores (the model path): wmma 16 x 16 x 16 bf16
//     tiles with fp32 accumulators, BC = 64 (32 when C <= 32, the decode
//     shape), 64-deep chunks fetched into registers one chunk ahead;
//   - fp32 FMAs in registers (float32, and a bf16 F too wide for the
//     tensor-core tiles), BC = 32 (8 when C is small or F wide), 32-deep
//     chunks.
// Both round as the TPU kernel does.  Later work: wgmma with TMA-fed
// multi-stage rings, and keeping an expert's weights on chip across its C
// tiles (each CTA re-reads them from L2 today).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;    // F tile (phase 1) and D tile (phase 2)
constexpr int kDepth = 32;   // D chunk (phase 1) and F chunk (phase 2)

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

// Threads as TY x TX: thread (ty, tx) owns rows ty*RPT .. ty*RPT+RPT-1 of
// the BC rows and columns tx + TX*j, j < CPT, of a 64-wide tile.
template <int BC, int RPT>
struct Shape {
  static constexpr int TY = BC / RPT;
  static constexpr int TX = kThreads / TY;
  static constexpr int CPT = kTile / TX;
  static_assert(TY * TX == kThreads && TX * CPT == kTile, "tiling");
};

template <typename T, int BC, int RPT>
__global__ void __launch_bounds__(kThreads)
moe_ffn_kernel(const T* __restrict__ xs, const T* __restrict__ wg,
               const T* __restrict__ wu, const T* __restrict__ wd,
               T* __restrict__ y, int C, int D, int F) {
  using S = Shape<BC, RPT>;
  constexpr int CPT = S::CPT, TX = S::TX;
  extern __shared__ float smem[];
  float* xt = smem;                        // [BC][kDepth + 1]
  float* gt = xt + BC * (kDepth + 1);      // [kDepth][kTile]  (wg, then wd)
  float* ut = gt + kDepth * kTile;         // [kDepth][kTile]  (wu)
  T* hs = reinterpret_cast<T*>(ut + kDepth * kTile);   // [BC][F]

  const int e = blockIdx.y, c0 = blockIdx.x * BC;
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const long long DF = static_cast<long long>(D) * F;
  const T* x_e = xs + (static_cast<long long>(e) * C + c0) * D;
  const T* wg_e = wg + e * DF;
  const T* wu_e = wu + e * DF;
  const T* wd_e = wd + e * DF;
  const int rows = min(BC, C - c0);

  // Phase 1: h = silu(x wg) * (x wu) for all F, into shared memory.
  for (int f0 = 0; f0 < F; f0 += kTile) {
    float g[RPT][CPT], u[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) g[i][j] = u[i][j] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += kDepth) {
      __syncthreads();
      for (int idx = tid; idx < BC * kDepth; idx += kThreads) {
        const int r = idx / kDepth, kk = idx % kDepth;
        xt[r * (kDepth + 1) + kk] =
            (r < rows && d0 + kk < D)
                ? to_f(x_e[static_cast<long long>(r) * D + d0 + kk]) : 0.0f;
      }
      for (int idx = tid; idx < kDepth * kTile; idx += kThreads) {
        const int kk = idx / kTile, col = idx % kTile;
        const bool in = d0 + kk < D && f0 + col < F;
        const long long off = static_cast<long long>(d0 + kk) * F + f0 + col;
        gt[idx] = in ? to_f(wg_e[off]) : 0.0f;
        ut[idx] = in ? to_f(wu_e[off]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kDepth; ++kk) {
        float xv[RPT], gw[CPT], uw[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          xv[i] = xt[(ty * RPT + i) * (kDepth + 1) + kk];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          gw[j] = gt[kk * kTile + tx + TX * j];
          uw[j] = ut[kk * kTile + tx + TX * j];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            g[i][j] = fmaf(xv[i], gw[j], g[i][j]);
            u[i][j] = fmaf(xv[i], uw[j], u[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int f = f0 + tx + TX * j;
        if (f < F) {
          const float gv = g[i][j];
          const float silu = gv / (1.0f + expf(-gv));
          hs[(ty * RPT + i) * F + f] = from_f<T>(silu * u[i][j]);
        }
      }
  }

  // Phase 2: y = h wd, one 64-wide D tile at a time.
  for (int dc0 = 0; dc0 < D; dc0 += kTile) {
    float acc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.0f;
    for (int f0 = 0; f0 < F; f0 += kDepth) {
      __syncthreads();   // phase 1's h and the previous wd chunk are done
      for (int idx = tid; idx < kDepth * kTile; idx += kThreads) {
        const int kk = idx / kTile, col = idx % kTile;
        gt[idx] = (f0 + kk < F && dc0 + col < D)
                      ? to_f(wd_e[static_cast<long long>(f0 + kk) * D + dc0 +
                                  col])
                      : 0.0f;
      }
      __syncthreads();
      const int depth = min(kDepth, F - f0);
      for (int kk = 0; kk < depth; ++kk) {
        float hv[RPT], wv[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          hv[i] = to_f(hs[(ty * RPT + i) * F + f0 + kk]);
#pragma unroll
        for (int j = 0; j < CPT; ++j) wv[j] = gt[kk * kTile + tx + TX * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            acc[i][j] = fmaf(hv[i], wv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int dcol = dc0 + tx + TX * j;
        if (dcol < D)
          y[(static_cast<long long>(e) * C + c0 + r) * D + dcol] =
              from_f<T>(acc[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync through nvcuda::wmma, 16 x 16 x 16
// bf16 tiles, fp32 accumulators).  8 warps as (BC/16) x (128/BC): each
// warp owns 16 rows and a 1024/BC-wide slice of each 64-wide tile.  The x
// chunk and the weight chunks (64 deep) are staged in shared memory as
// bf16; the accumulators go through fp32 shared scratch for the silu * u
// epilogue and for the bf16 store of y.  h is kept as bf16 for the whole F,
// padded to a multiple of 64 with zeros.

constexpr int kMK = 64;            // depth chunk of the tensor-core path
constexpr int kLdX = kMK + 8;      // bf16 row stride of the staged chunks
constexpr int kLdS = kTile + 4;    // fp32 row stride of the scratch

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void set_zero(uint4& v) {
  v = make_uint4(0, 0, 0, 0);
}
__device__ __forceinline__ void set_zero(bf16& v) {
  v = __float2bfloat16(0.0f);
}

// A chunk of ROWS x 64 bf16 of a row-major global matrix (row stride ld),
// zero outside [0, nrows) x [0, ncols), held in registers between its
// global loads and its shared-memory stores (row stride kLdX): all of a
// thread's loads are in flight at once, and the next chunk's loads run
// while the tensor cores work on this one.  kVec: 8 columns per 16-byte
// load (ncols a multiple of 8, 16-byte aligned rows); else one column.
template <int ROWS, bool kVec>
struct Chunk {
  static constexpr int kW = kVec ? 8 : 1;
  static constexpr int kPer = ROWS * (kMK / kW) / kThreads;
  static_assert(kPer * kThreads == ROWS * (kMK / kW), "chunk");
  using Piece = typename std::conditional<kVec, uint4, bf16>::type;
  Piece v[kPer];

  __device__ __forceinline__ void fetch(const bf16* src, long long ld,
                                        int nrows, int ncols) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kMK / kW), c = (idx % (kMK / kW)) * kW;
      if (r < nrows && c < ncols)
        v[i] = *reinterpret_cast<const Piece*>(src + r * ld + c);
      else
        set_zero(v[i]);
    }
  }
  __device__ __forceinline__ void put(bf16* dst) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kMK / kW), c = (idx % (kMK / kW)) * kW;
      *reinterpret_cast<Piece*>(dst + r * kLdX + c) = v[i];
    }
  }
};

template <int BC, bool kVec>
__global__ void __launch_bounds__(kThreads)
moe_ffn_mma_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ wg,
                   const bf16* __restrict__ wu, const bf16* __restrict__ wd,
                   bf16* __restrict__ y, int C, int D, int F, int Fp) {
  namespace wmma = nvcuda::wmma;
  constexpr int WM = BC / 16, WN = (kThreads / 32) / WM;
  constexpr int FN = kTile / 16 / WN;   // 16-wide fragments per warp
  static_assert(WM * WN == kThreads / 32 && FN * WN * 16 == kTile, "tiles");
  extern __shared__ __align__(128) unsigned char raw[];
  const int ldh = Fp + 8;
  bf16* hs = reinterpret_cast<bf16*>(raw);          // [BC][ldh]
  bf16* xt = hs + BC * ldh;                          // [BC][kLdX]
  bf16* gt = xt + BC * kLdX;                         // [kMK][kLdX]
  bf16* ut = gt + kMK * kLdX;                        // [kMK][kLdX]
  float* cg = reinterpret_cast<float*>(ut + kMK * kLdX);   // [BC][kLdS]
  float* cu = cg + BC * kLdS;                              // [BC][kLdS]

  const int e = blockIdx.y, c0 = blockIdx.x * BC;
  const int warp = threadIdx.x / 32, wm = warp / WN, wn = warp % WN;
  const long long DF = static_cast<long long>(D) * F;
  const bf16* x_e = xs + (static_cast<long long>(e) * C + c0) * D;
  const int rows = min(BC, C - c0);

  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                               wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                               wmma::row_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

  const bf16* wg_e = wg + e * DF;
  const bf16* wu_e = wu + e * DF;
  const bf16* wd_e = wd + e * DF;

  // Phase 1: h = silu(x wg) * (x wu) over [0, Fp); the zero-padded weight
  // columns past F give h = 0 there, which phase 2's last chunk reads.
  Chunk<BC, kVec> cx;
  Chunk<kMK, kVec> cwg, cwu;
  for (int f0 = 0; f0 < Fp; f0 += kTile) {
    FragC accg[FN], accu[FN];
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::fill_fragment(accg[j], 0.0f);
      wmma::fill_fragment(accu[j], 0.0f);
    }
    auto fetch = [&](int d0) {
      cx.fetch(x_e + d0, D, rows, D - d0);
      const long long off = static_cast<long long>(d0) * F + f0;
      cwg.fetch(wg_e + off, F, D - d0, F - f0);
      cwu.fetch(wu_e + off, F, D - d0, F - f0);
    };
    fetch(0);
    for (int d0 = 0; d0 < D; d0 += kMK) {
      __syncthreads();   // the previous chunk's fragments are loaded
      cx.put(xt);
      cwg.put(gt);
      cwu.put(ut);
      __syncthreads();
      if (d0 + kMK < D) fetch(d0 + kMK);   // in flight during the MMAs
#pragma unroll
      for (int kk = 0; kk < kMK; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, xt + wm * 16 * kLdX + kk, kLdX);
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          FragB b;
          const int col = (wn * FN + j) * 16;
          wmma::load_matrix_sync(b, gt + kk * kLdX + col, kLdX);
          wmma::mma_sync(accg[j], a, b, accg[j]);
          wmma::load_matrix_sync(b, ut + kk * kLdX + col, kLdX);
          wmma::mma_sync(accu[j], a, b, accu[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int col = (wn * FN + j) * 16;
      wmma::store_matrix_sync(cg + wm * 16 * kLdS + col, accg[j], kLdS,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(cu + wm * 16 * kLdS + col, accu[j], kLdS,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BC * kTile; idx += kThreads) {
      const int r = idx / kTile, c = idx % kTile;
      const float gv = cg[r * kLdS + c];
      const float silu = gv / (1.0f + expf(-gv));
      hs[r * ldh + f0 + c] = __float2bfloat16(silu * cu[r * kLdS + c]);
    }
  }

  // Phase 2: y = h wd, one 64-wide D tile at a time.
  Chunk<kMK, kVec> cwd;
  for (int dc0 = 0; dc0 < D; dc0 += kTile) {
    FragC acc[FN];
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[j], 0.0f);
    cwd.fetch(wd_e + dc0, D, F, D - dc0);
    for (int f0 = 0; f0 < Fp; f0 += kMK) {
      __syncthreads();   // phase 1's h and the previous wd chunk are done
      cwd.put(gt);
      __syncthreads();
      if (f0 + kMK < Fp)
        cwd.fetch(wd_e + static_cast<long long>(f0 + kMK) * D + dc0, D,
                  F - f0 - kMK, D - dc0);
#pragma unroll
      for (int kk = 0; kk < kMK; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, hs + wm * 16 * ldh + f0 + kk, ldh);
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          FragB b;
          wmma::load_matrix_sync(b, gt + kk * kLdX + (wn * FN + j) * 16,
                                 kLdX);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(cg + wm * 16 * kLdS + (wn * FN + j) * 16,
                              acc[j], kLdS, wmma::mem_row_major);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BC * kTile; idx += kThreads) {
      const int r = idx / kTile, c = idx % kTile, d = dc0 + c;
      if (r < rows && d < D)
        y[(static_cast<long long>(e) * C + c0 + r) * D + d] =
            __float2bfloat16(cg[r * kLdS + c]);
    }
  }
}

size_t mma_smem_bytes(int bc, int Fp) {
  return sizeof(bf16) * (static_cast<size_t>(bc) * (Fp + 8) + bc * kLdX +
                         2 * kMK * kLdX) +
         sizeof(float) * 2 * bc * kLdS;
}

template <int BC, bool kVec>
int launch_mma(const void* xs, const void* wg, const void* wu, const void* wd,
               void* y, int E, int C, int D, int F, cudaStream_t stream) {
  const int Fp = (F + kTile - 1) / kTile * kTile;
  const size_t smem = mma_smem_bytes(BC, Fp);
  static size_t configured = 0;
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        moe_ffn_mma_kernel<BC, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const dim3 grid((C + BC - 1) / BC, E);
  moe_ffn_mma_kernel<BC, kVec><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(xs), static_cast<const bf16*>(wg),
      static_cast<const bf16*>(wu), static_cast<const bf16*>(wd),
      static_cast<bf16*>(y), C, D, F, Fp);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int dispatch_mma(int bc, const void* xs, const void* wg, const void* wu,
                 const void* wd, void* y, int E, int C, int D, int F,
                 cudaStream_t stream) {
  if (bc == 64)
    return launch_mma<64, kVec>(xs, wg, wu, wd, y, E, C, D, F, stream);
  if (bc == 32)
    return launch_mma<32, kVec>(xs, wg, wu, wd, y, E, C, D, F, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int BC>
size_t smem_bytes(int F) {
  return sizeof(float) * (BC * (kDepth + 1) + 2 * kDepth * kTile) +
         sizeof(T) * static_cast<size_t>(BC) * F;
}

template <typename T, int BC, int RPT>
int launch(const void* xs, const void* wg, const void* wu, const void* wd,
           void* y, int E, int C, int D, int F, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, BC>(F);
  static size_t configured = 0;
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        moe_ffn_kernel<T, BC, RPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const dim3 grid((C + BC - 1) / BC, E);
  moe_ffn_kernel<T, BC, RPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xs), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd),
      static_cast<T*>(y), C, D, F);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int bc, const void* xs, const void* wg, const void* wu,
             const void* wd, void* y, int E, int C, int D, int F,
             cudaStream_t stream) {
  if (bc == 32) return launch<T, 32, 2>(xs, wg, wu, wd, y, E, C, D, F, stream);
  if (bc == 8) return launch<T, 8, 1>(xs, wg, wu, wd, y, E, C, D, F, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  mma: 1 for the tensor-core path
// (bfloat16 only; bc 32 or 64), 0 for the fp32-FMA path (bc 8 or 32).
// Launches on `stream` and returns cudaGetLastError() (0 on success); an
// argument the kernel cannot take returns cudaErrorInvalidValue without
// launching.
extern "C" int moe_ffn_launch(int dtype, int mma, int bc, const void* xs,
                              const void* wg, const void* wu, const void* wd,
                              void* y, int E, int C, int D, int F,
                              void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = D % 8 == 0 && F % 8 == 0 && aligned16(xs) &&
                     aligned16(wg) && aligned16(wu) && aligned16(wd);
    return vec ? dispatch_mma<true>(bc, xs, wg, wu, wd, y, E, C, D, F, st)
               : dispatch_mma<false>(bc, xs, wg, wu, wd, y, E, C, D, F, st);
  }
  if (dtype == 0)
    return dispatch<float>(bc, xs, wg, wu, wd, y, E, C, D, F, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(bc, xs, wg, wu, wd, y, E, C, D, F, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
