// Plane Gram matrix G = P P^T of the paper's Sec.-3.5 multi-step scheme,
// written by hand for Hopper (sm_90a).
//
// Replaces repro/kernels/gram.py::gram, the Pallas TPU kernel.  Computes
//
//     G[a, b] = <P[a, 0:d], P[b, 0:d]>        for a, b in [0, n)
//
// in fp32 on FMAs (no TF32: the parity tolerance is 3e-5 |p_a| |p_b|), with
// P a row-strided fp32 view (row stride `ld` floats, unit column stride)
// and G a contiguous n x n output.  On the gram path P is one block of the
// plane cache, planes[i, :, :-1]: rows of d = 4004 floats at a stride of
// 4005, so no row starts on a 16-byte boundary; the kernel reads in place
// with 4-byte copies and never copies the cache.
//
// Bound: G is symmetric, so the function needs n(n+1)/2 entries of 2*d
// flops, n(n+1)*d flops, against 4*(n*d + n*n) bytes.  One block (n = 64,
// d = 4004): 16.7 MFLOP (0.25 us at 67 TFLOP/s) against 1.04 MB (0.31 us
// at 3.35 TB/s), so bytes bound it.  A flattened 64-block working set
// (n = 4096): 6.72e10 flops, 1.00 ms, against 0.040 ms for its 133 MB.
//
// Design: a SIMT SGEMM over the upper triangle of output tiles, split
// along K across a thread-block cluster where the tiles alone leave the
// card idle.  The host's plan (kernels/gram.py::plan) picks, from (n, d)
// alone, the tile edge and the split S (a power of two up to 16):
// 128-tiles with S = 1 once their triangle fills the 132 SMs, else
// 32-tiles with the smallest S that fills the card.  The grid is
// (upper-triangle tiles, S); a cluster is the S CTAs of one tile, and
// cluster rank r sums K steps [r*steps/S, (r+1)*steps/S) of 32 columns
// each (kernels/gram.py::k_ranges mirrors the formula).  One cache block
// (n = 64) is 3 tiles x 16 = 48 CTAs, one per SM.  A CTA alone on its SM
// is bound by latency, not by its FMAs (its time falls as 1/S, and 2 warps
// on an SM reach a third of the FMA rate that 16 reach:
// scripts/gram_plan_sweep.py on an H100), so every CTA keeps 8 warps.
//   - Every CTA is 256 threads.  On a 128-tile they hold 8 x 8 entries
//     each.  On a 32-tile they are 4 groups of 64 threads with 4 x 4
//     entries each, group g summing K steps g, g + 4, ... of the CTA's
//     range.  Entries lie in 4-wide strips so that the 16-byte
//     shared reads are free of bank conflicts; every thread sums its
//     entries over its steps in ascending k.
//   - The panels of a stage (32 columns, 128 on a 32-tile) are staged
//     k-major in shared memory through a ring of kStages buffers filled by
//     4-byte cp.async (rows are 16,020 bytes apart: no 16-byte copies and
//     no TMA), so the next two stages' loads are in flight during this
//     stage's FMAs; one barrier per stage.  A warp copies patches of 4 rows
//     x 8 columns, and with a row pitch of tile + 4 floats the transposing
//     stores hit 32 distinct banks.  A diagonal tile stages its one panel
//     once and reads it as both sides.
//   - The partials go through shared memory: a CTA's is its groups' sum in
//     group order.  With S > 1, cluster.sync(); each entry (r <= c on a
//     diagonal tile) has one owner thread in one rank, which adds the S
//     partials in rank order 0..S-1 through distributed shared memory.  The
//     owner writes G[r][c] and G[c][r] from one register (rows of G
//     coalesce).  A second cluster.sync() keeps every CTA resident until
//     its peers have read it.
// So G is exactly symmetric, and the result depends only on (n, d) and P:
// a relaunch gives the same bits.  Ragged n and d are zero-filled in the
// copies and masked in the stores.  3xTF32 on wgmma is later work.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "builds.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kK = 32;          // K step: columns per staged panel
constexpr int kStages = 3;      // cp.async ring depth
constexpr int kMaxSplit = 16;   // non-portable cluster size on H100

// Every CTA is 256 threads.  A 128-tile is one group of 16 x 16 threads;
// a 32-tile is 4 groups of 8 x 8, each summing its own K steps of the
// CTA's range (group g takes steps g, g + 4, ...), so a block of a few
// tiles still keeps 8 warps on each SM.  A thread holds kN x kN
// entries in 4-wide strips 4 * kSide apart.
template <int kTile>
struct Shape {
  static constexpr int kSide = kTile == 32 ? 8 : 16;
  static constexpr int kGroups = kTile == 32 ? 4 : 1;
  static constexpr int kThreads = kSide * kSide * kGroups;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kN = kTile / kSide;     // entries per side a thread
  static constexpr int kStrips = kN / 4;       // 4-wide strips per side
  static constexpr int kCols = kK * kGroups;   // columns per stage
  static constexpr int kPitch = kTile + 4;     // shared row pitch, floats
  static constexpr int kPanel = kCols * kPitch;  // one k-major panel
  static constexpr int kStage = 2 * kPanel;    // the A and B panels
  static constexpr int kRowGroups = kTile / 4;
  static constexpr int kPasses = kTile * kCols / 32 / kWarps;  // per panel
  static constexpr size_t kSmem = sizeof(float) * kStages * kStage;
  static_assert(kThreads == 256 && kN % 4 == 0, "layout");
  static constexpr int kSlots = kGroups > 1 ? kGroups + 1 : 1;
  static_assert(kSlots * kTile * kTile <= kStages * kStage,
                "the partials fit in the ring");
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
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

// Copies the kTile x kCols panel of rows [row0, row0 + kTile), columns
// [k0, k0 + kCols) into `panel`, k-major; rows >= n and columns >= kend
// read 0.  A warp copies patches of 4 rows x 8 columns.
template <int kTile>
__device__ __forceinline__ void stage_panel(float* panel, const float* P,
                                            long long ld, int row0, int k0,
                                            int n, int kend, int warp,
                                            int lane) {
  using S = Shape<kTile>;
#pragma unroll
  for (int p = 0; p < S::kPasses; ++p) {
    const int q = warp + S::kWarps * p;
    const int r = 4 * (q % S::kRowGroups) + lane / 8;
    const int kc = 8 * (q / S::kRowGroups) + lane % 8;
    const bool valid = row0 + r < n && k0 + kc < kend;
    const float* src =
        valid ? P + static_cast<long long>(row0 + r) * ld + k0 + kc : P;
    cp_async4(panel + kc * S::kPitch + r, src, valid);
  }
}

template <int kTile>
__global__ void __launch_bounds__(Shape<kTile>::kThreads)
gram_kernel(const float* __restrict__ P, long long ld, float* __restrict__ G,
            int n, int d, int split) {
  using S = Shape<kTile>;
  extern __shared__ __align__(16) float smem[];
  // Linear upper-triangle tile index -> (ti, tj), ti <= tj.
  const int tiles = (n + kTile - 1) / kTile;
  int ti = 0, rem = blockIdx.x;
  while (rem >= tiles - ti) {
    rem -= tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const bool diag = ti == tj;
  const int row_a = ti * kTile, row_b = tj * kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int group = tid / (S::kSide * S::kSide);
  const int gt = tid % (S::kSide * S::kSide);
  const int tx = gt % S::kSide, ty = gt / S::kSide;
  const int rank = blockIdx.y;  // the cluster is (1, split, 1)
  const int steps = (d + kK - 1) / kK;
  const int s0 = static_cast<int>(static_cast<long long>(rank) * steps /
                                  split);
  const int s1 = static_cast<int>(static_cast<long long>(rank + 1) * steps /
                                  split);
  const int kend = min(d, s1 * kK);
  const int nstages = (s1 - s0 + S::kGroups - 1) / S::kGroups;

  auto stage = [&](int t, int slot) {
    float* a = smem + slot * S::kStage;
    const int k0 = (s0 + t * S::kGroups) * kK;
    stage_panel<kTile>(a, P, ld, row_a, k0, n, kend, warp, lane);
    if (!diag) stage_panel<kTile>(a + S::kPanel, P, ld, row_b, k0, n, kend,
                                  warp, lane);
  };

  float acc[S::kN][S::kN];
#pragma unroll
  for (int i = 0; i < S::kN; ++i)
#pragma unroll
    for (int j = 0; j < S::kN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nstages) stage(t, t);
    cp_async_commit();
  }
  for (int t = 0; t < nstages; ++t) {
    cp_async_wait<kStages - 2>();  // stage t has landed (this thread's part)
    __syncthreads();               // ... everyone's; slot t-1 is free
    const int next = t + kStages - 1;
    if (next < nstages) stage(next, next % kStages);
    cp_async_commit();
    if (s0 + t * S::kGroups + group >= s1) continue;  // uniform per group
    const float* a = smem + (t % kStages) * S::kStage + group * kK * S::kPitch;
    const float* b = diag ? a : a + S::kPanel;
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk) {
      float av[S::kN], bv[S::kN];
#pragma unroll
      for (int h = 0; h < S::kStrips; ++h) {
        const float4 u = *reinterpret_cast<const float4*>(
            a + kk * S::kPitch + 4 * S::kSide * h + 4 * ty);
        const float4 v = *reinterpret_cast<const float4*>(
            b + kk * S::kPitch + 4 * S::kSide * h + 4 * tx);
        av[4 * h] = u.x, av[4 * h + 1] = u.y, av[4 * h + 2] = u.z,
        av[4 * h + 3] = u.w;
        bv[4 * h] = v.x, bv[4 * h + 1] = v.y, bv[4 * h + 2] = v.z,
        bv[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < S::kN; ++i)
#pragma unroll
        for (int j = 0; j < S::kN; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring's last reads are done: reuse it

  // Each group's partial to shared memory, row-major; then the CTA's
  // partial is their sum in group order 0..kGroups-1, in slot kGroups (a
  // lone group's partial is the CTA's).
  constexpr int kEntries = kTile * kTile;
  float* part = smem;
  float* cta = smem + (S::kSlots - 1) * kEntries;
#pragma unroll
  for (int i = 0; i < S::kN; ++i) {
    const int r = 4 * S::kSide * (i / 4) + 4 * ty + i % 4;
#pragma unroll
    for (int h = 0; h < S::kStrips; ++h)
      *reinterpret_cast<float4*>(part + group * kEntries + r * kTile +
                                 4 * S::kSide * h + 4 * tx) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                      acc[i][4 * h + 3]);
  }
  __syncthreads();
  if (S::kGroups > 1) {
    for (int e = tid; e < kEntries; e += S::kThreads) {
      float v = part[e];
#pragma unroll
      for (int g = 1; g < S::kGroups; ++g) v += part[g * kEntries + e];
      cta[e] = v;
    }
  }

  // The owner of entry e adds the split's CTA partials in rank order (one
  // rank: its own) and writes G[r][c] and G[c][r] from one register.
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1)
    cluster.sync();
  else
    __syncthreads();
  const int per_rank = kEntries / split;  // split divides 2^k
  const int end = (rank + 1) * per_rank;
  for (int e = rank * per_rank + tid; e < end; e += S::kThreads) {
    const int r = e / kTile, c = e % kTile;
    const int gr = row_a + r, gc = row_b + c;
    if (gr >= n || gc >= n || (diag && r > c)) continue;
    float v[kMaxSplit];
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q)
      if (q < split) v[q] = split > 1 ? *cluster.map_shared_rank(cta + e, q)
                                      : cta[e];
    float sum = v[0];
#pragma unroll
    for (int q = 1; q < kMaxSplit; ++q)
      if (q < split) sum += v[q];
    G[static_cast<long long>(gr) * n + gc] = sum;
    G[static_cast<long long>(gc) * n + gr] = sum;
  }
  if (split > 1) cluster.sync();  // no CTA leaves while a peer reads it
}

template <int kTile>
cudaError_t launch(const float* P, long long ld, float* G, int n, int d,
                   int split, cudaStream_t stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * (tiles + 1) / 2),
                     static_cast<unsigned>(split), 1);
  cfg.blockDim = dim3(Shape<kTile>::kThreads, 1, 1);
  cfg.dynamicSmemBytes = Shape<kTile>::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = static_cast<unsigned>(split);
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, gram_kernel<kTile>, P, ld, G, n, d,
                            split);
}

// The builds: 32- and 128-tiles, each granted its ring's shared memory;
// both may run in clusters of 16, above the portable 8.
const repro::Build kBuilds[] = {
    REPRO_BUILD(Shape<32>::kSmem, gram_kernel<32>),
    REPRO_BUILD(Shape<128>::kSmem, gram_kernel<128>),
};

}  // namespace

// Once, when the library loads (never inside a graph capture): dynamic
// shared memory above 48 KB and clusters of 16.  Returns a cudaError_t.
extern "C" int gram_init(void) {
  cudaError_t err = repro::grant(kBuilds);
  for (const repro::Build& b : kBuilds)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          b.fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return static_cast<int>(err);
}

// One build's attributes (builds.cuh repro::attributes).
extern "C" int gram_attributes(int build, int threads, long long dyn_smem,
                               int cluster, long long* out) {
  return repro::attributes(kBuilds, build, threads, dyn_smem, cluster, out);
}

// Launches on `stream` with the plan's tile (32 or 128) and split (a
// power of two, at most 16) and returns the launch's cudaError_t (0 on
// success): a cluster the card cannot place is refused, not run another
// way.
extern "C" int gram_launch(const float* P, long long ld, float* G, int n,
                           int d, int tile, int split, void* stream) {
  if ((tile != 32 && tile != 128) || split < 1 || split > kMaxSplit ||
      (split & (split - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = tile == 32
                              ? launch<32>(P, ld, G, n, d, split, s)
                              : launch<128>(P, ld, G, n, d, split, s);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
