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
// Two paths.
//
// bf16 with D and F multiples of 8 (the model path): two warp-specialised
// GEMM launches on the tensor cores.
//   phase 1: g and u of a 128 x 128 tile of (capacity rows, F) over D,
//            h = silu(g) * u rounded to bf16 and written to a (E, C, F)
//            scratch in device memory;
//   phase 2: y of a 128 x 256 tile of (capacity rows, D) over F, from h.
// The TPU kernel keeps h on chip; here it makes one round trip through
// device memory (0.67 GB each way at the backbone shape, ~0.4 ms), and in
// exchange every weight tile read from L2 feeds 128 rows, twice the rows of
// the fused design this replaces, whose CTAs each re-read their expert's
// 12.6 MB of weights for 64 rows.  Each CTA is three warpgroups: one
// producer thread keeps a 4-stage ring of 48 KB stages full with TMA
// (cp.async.bulk.tensor, 128-byte swizzle, completion on an mbarrier per
// stage), and two consumer warpgroups, 64 rows each, run
// wgmma.mma_async m64n64k16 (bf16 in, fp32 accumulators in registers) on
// the stages that have arrived and hand them back through a second
// mbarrier per stage.  x and h are K-major operands, the weights MN-major
// ones (their F or D columns are contiguous), so no copy transposes them.
// Ragged C, D and F come from TMA's zero fill at the tensor's edge and
// masked stores.  At the decode shape (C = 1) the grid is 512 CTAs per
// phase, each streaming a distinct slice of the weights through its ring,
// so all 132 SMs keep copies in flight.
//
// fp32 FMAs (float32, and bf16 shapes TMA cannot describe): one CTA of 256
// threads per (expert, tile of BC capacity rows), h kept in shared memory
// as the TPU kernel keeps it, g and u (then y) accumulated over 32-deep
// chunks staged in shared memory; BC = 32 (8 when C is small or F wide).
// No atomics anywhere.  Both paths round as the TPU kernel does.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "builds.cuh"

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
// bf16 on the tensor cores: wgmma fed by a TMA ring.

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                 // capacity rows per CTA
constexpr int kBK = 64;                  // depth per stage: 128 bytes
constexpr int kChunk = 64;               // columns per B box (128 bytes)
constexpr int kStages = 4;
constexpr int kConsumers = 2;            // warpgroups of 64 rows
constexpr int kGemmThreads = 128 * (1 + kConsumers);
constexpr int kABytes = kBM * kBK * 2;   // 16 KB
constexpr int kBBytes = kBK * kChunk * 2;  // 8 KB
// Per stage: A and 4 B boxes (phase 1: 2 of wg, 2 of wu; phase 2: 4 of wd).
constexpr int kStageBytes = kABytes + 4 * kBBytes;   // 48 KB
constexpr int kGemmSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all >> 4).  A (K-major): 8-row groups 1024 bytes
// apart.  B (MN-major, one 64-wide chunk): 8-deep groups 1024 bytes apart;
// both offsets are given 1024, since a 64-wide chunk has no second MN atom.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads and writes across the
// asynchronous wgmma instructions.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, fp32) += A (64 x 16, K-major) B (16 x 64, MN-major).
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// One GEMM phase.  GATED (phase 1): A = x (E, C, D), B = wg and wu
// (E, D, F), 128 output columns, out = h = bf16(silu(A wg) * (A wu)).
// Otherwise (phase 2): A = h (E, C, F), B = wd (E, F, D), 256 output
// columns, out = y = bf16(A wd).  N is the output width, K the depth.
template <bool GATED>
__global__ void __launch_bounds__(kGemmThreads, 1)
moe_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_b0,
                const __grid_constant__ CUtensorMap tm_b1,
                bf16* __restrict__ out, int C, int N, int K) {
  constexpr int kNB = GATED ? 2 : 1;      // B operands
  constexpr int kNC = GATED ? 2 : 4;      // 64-wide chunks per operand
  extern __shared__ unsigned char raw[];
  const uint32_t base = (smem_u32(raw) + 1023u) & ~1023u;   // swizzle atom
  const uint32_t full = base + kStages * kStageBytes;   // kStages barriers
  const uint32_t empty = full + kStages * 8;
  const int e = blockIdx.z, m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kNC * kChunk;
  const int ktiles = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (t == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty + 8 * s, ((kt / kStages) - 1) & 1);
        const uint32_t st = base + s * kStageBytes;
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, kStageBytes);
        tma_load(st, &tm_a, bar, kt * kBK, m0, e);
#pragma unroll
        for (int b = 0; b < kNB; ++b)
#pragma unroll
          for (int c = 0; c < kNC; ++c)
            tma_load(st + kABytes + (b * kNC + c) * kBBytes,
                     b == 0 ? &tm_b0 : &tm_b1, bar, n0 + c * kChunk,
                     kt * kBK, e);
      }
    }
    return;
  }

  // Consumers: warpgroup wg (1 or 2) owns rows (wg-1)*64 .. +63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  float acc[kNB][kNC][32];
#pragma unroll
  for (int b = 0; b < kNB; ++b)
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[b][c][i] = 0.0f;
      fence_acc(acc[b][c]);
    }
  const uint32_t a_off = (wg - 1) * 64 * kBK * 2;   // 64 rows of 128 bytes
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + 8 * s, (kt / kStages) & 1);
    const uint32_t st = base + s * kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = smem_desc(st + a_off + kk * 32, 16, 1024);
#pragma unroll
      for (int b = 0; b < kNB; ++b)
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          const uint64_t db = smem_desc(
              st + kABytes + (b * kNC + c) * kBBytes + kk * 16 * 128, 1024,
              1024);
          wgmma_64x64x16(acc[b][c], da, db);
        }
    }
    wgmma_commit();
    wgmma_wait<1>();   // the previous stage's products are done
    if (kt > 0 && t == 0) mbar_arrive(empty + 8 * ((kt - 1) % kStages));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < kNB; ++b)
#pragma unroll
    for (int c = 0; c < kNC; ++c) fence_acc(acc[b][c]);

  // Accumulator layout of m64nNk16: thread t holds rows
  // 16*(t/32) + (t%32)/4 (+8) and columns 8*j + 2*(t%4) (+1).
  const int r0 = m0 + (wg - 1) * 64 + 16 * (t / 32) + (t % 32) / 4;
  const int cc = 2 * (t % 4);
  bf16* out_e = out + static_cast<long long>(e) * C * N;
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + 8 * hf;
        const int col = n0 + c * kChunk + 8 * j + cc;
        if (row >= C || col >= N) continue;   // N is even: col + 1 < N
        float v0, v1;
        if constexpr (GATED) {
          const float g0 = acc[0][c][4 * j + 2 * hf];
          const float g1 = acc[0][c][4 * j + 2 * hf + 1];
          v0 = g0 / (1.0f + expf(-g0)) * acc[1][c][4 * j + 2 * hf];
          v1 = g1 / (1.0f + expf(-g1)) * acc[1][c][4 * j + 2 * hf + 1];
        } else {
          v0 = acc[0][c][4 * j + 2 * hf];
          v1 = acc[0][c][4 * j + 2 * hf + 1];
        }
        __nv_bfloat162 pair;
        pair.x = __float2bfloat16(v0);
        pair.y = __float2bfloat16(v1);
        *reinterpret_cast<__nv_bfloat162*>(
            out_e + static_cast<long long>(row) * N + col) = pair;
      }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, cols) bf16 matrix per expert, row-major, as a 3-D tensor map
// with boxes of box_rows x 64 columns, 128-byte swizzle, zero fill.
bool make_map(CUtensorMap* map, const void* ptr, int E, int rows, int cols,
              int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kChunk),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(const void* xs, const void* wg, const void* wu,
                 const void* wd, void* y, void* h, int E, int C, int D, int F,
                 cudaStream_t stream) {
  CUtensorMap m_x, m_wg, m_wu, m_h, m_wd;
  if (!make_map(&m_x, xs, E, C, D, kBM) ||
      !make_map(&m_wg, wg, E, D, F, kBK) ||
      !make_map(&m_wu, wu, E, D, F, kBK) ||
      !make_map(&m_h, h, E, C, F, kBM) || !make_map(&m_wd, wd, E, F, D, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mt = (C + kBM - 1) / kBM;
  const dim3 g1((F + 2 * kChunk - 1) / (2 * kChunk), mt, E);
  moe_gemm_kernel<true><<<g1, kGemmThreads, kGemmSmem, stream>>>(
      m_x, m_wg, m_wu, static_cast<bf16*>(h), C, F, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g2((D + 4 * kChunk - 1) / (4 * kChunk), mt, E);
  moe_gemm_kernel<false><<<g2, kGemmThreads, kGemmSmem, stream>>>(
      m_h, m_wd, m_wd, static_cast<bf16*>(y), C, D, F);
  return static_cast<int>(cudaGetLastError());
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


// The builds: the tensor-core pair (gate-and-up, down) at its ring's
// shared memory; the fp32-FMA kernel by type and row tile, each granted
// the card's limit (its h grows with F; kernels/moe_ffn.py::plan refuses
// an F past it).
const repro::Build kBuilds[] = {
    REPRO_BUILD(kGemmSmem, moe_gemm_kernel<true>),
    REPRO_BUILD(kGemmSmem, moe_gemm_kernel<false>),
    REPRO_BUILD(repro::kSmemLimit, moe_ffn_kernel<float, 32, 2>),
    REPRO_BUILD(repro::kSmemLimit, moe_ffn_kernel<float, 8, 1>),
    REPRO_BUILD(repro::kSmemLimit, moe_ffn_kernel<__nv_bfloat16, 32, 2>),
    REPRO_BUILD(repro::kSmemLimit, moe_ffn_kernel<__nv_bfloat16, 8, 1>),
};

}  // namespace

// Once, when the library loads (never inside a graph capture): each build
// may take its dynamic shared memory.  Returns a cudaError_t.
extern "C" int moe_ffn_init(void) {
  return static_cast<int>(repro::grant(kBuilds));
}

// One build's attributes (builds.cuh repro::attributes).
extern "C" int moe_ffn_attributes(int build, int threads, long long dyn_smem,
                                  int cluster, long long* out) {
  return repro::attributes(kBuilds, build, threads, dyn_smem, cluster, out);
}

// dtype: 0 = float32, 1 = bfloat16.  path 1: the tensor-core pair
// (bfloat16, D and F multiples of 8, 16-byte aligned; h is an (E, C, F)
// bfloat16 scratch); path 0: the fp32-FMA kernel (bc 8 or 32, h unused).
// Launches on `stream` and returns cudaGetLastError() (0 on success); an
// argument the kernels cannot take returns cudaErrorInvalidValue without
// launching.
extern "C" int moe_ffn_launch(int dtype, int path, int bc, const void* xs,
                              const void* wg, const void* wu, const void* wd,
                              void* y, void* h, int E, int C, int D, int F,
                              void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (dtype != 1 || D % 8 != 0 || F % 8 != 0 || h == nullptr ||
        !aligned16(xs) || !aligned16(wg) || !aligned16(wu) ||
        !aligned16(wd) || !aligned16(h) || !aligned16(y))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma(xs, wg, wu, wd, y, h, E, C, D, F, st);
  }
  if (dtype == 0)
    return dispatch<float>(bc, xs, wg, wu, wd, y, E, C, D, F, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(bc, xs, wg, wu, wd, y, E, C, D, F, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
