// Plane Gram matrix G = P P^T of the paper's Sec.-3.5 multi-step scheme,
// written by hand for Hopper (sm_90a).
//
// Replaces repro/kernels/gram.py::gram, the Pallas TPU kernel.  Computes
//
//     G[a, b] = <P[a, 0:d], P[b, 0:d]>        for a, b in [0, n)
//
// in fp32 on FMAs (no TF32: the parity tolerance is 3e-5), with P a
// row-strided fp32 view (row stride `ld` floats, unit column stride) and G
// a contiguous n x n output.  On the gram path P is one block of the plane
// cache, planes[i, :, :-1]: rows of d = 4004 floats at a stride of 4005,
// neither a multiple of 4, so the kernel reads in place with scalar global
// loads and never copies the cache.
//
// Bound: G is symmetric, so the function needs n(n+1)/2 entries of 2*d
// flops, n(n+1)*d flops, against 4*(n*d + n*n) bytes.  One block (n = 64,
// d = 4004): 16.7 MFLOP (0.25 us at 67 TFLOP/s) against 1.04 MB (0.31 us
// at 3.35 TB/s), so bytes bound it; a call is bound by latency in
// practice: it is a single 64 x 64 tile, one CTA.  A flattened 64-block
// working set (n = 4096): 6.72e10 flops, 1.00 ms, against 0.040 ms for
// its 133 MB.
//
// Design: a classic SIMT SGEMM, not the Pallas grid.  Each CTA owns one
// 64 x 64 output tile (ti, tj) and only tiles with ti <= tj run, so half
// the product is skipped.  For each K step of 32 columns it stages the two
// 64 x 32 panels, k-major, in shared memory (2 x 8.5 KB).  A warp stages a
// patch of 4 rows x 8 columns per load: 32-byte stretches of 4 rows in the
// global read, and with a row pitch of 68 floats the transposing shared
// stores hit 32 distinct banks.  Each of the 256 threads then accumulates
// a 4 x 4 register tile (rows 4 ty.., columns 4 tx..) from one 16-byte
// shared load of each panel per k.  Every thread sums its entries over
// k = 0..d-1 in the same order.  Each entry is written to G[r][c] and
// G[c][r] from the same register (on a diagonal tile only by the thread
// with r <= c), so G is exactly symmetric.  Ragged n and d are masked in
// the loads (zeros) and n in the stores.  Single-buffered; split-K for the
// one-tile shape, wgmma, TMA and 3xTF32 are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;           // output tile edge
constexpr int kK = 32;              // K step
constexpr int kPitch = kTile + 4;   // shared row pitch: 16-byte rows
constexpr int kThreads = 256;       // 16 x 16 threads, 4 x 4 entries each
constexpr int kSide = 16;

__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ P, long long ld,
            float* __restrict__ G, int n, int d) {
  const int ti = blockIdx.y, tj = blockIdx.x;
  if (ti > tj) return;                        // the mirror writes it
  __shared__ __align__(16) float As[kK][kPitch];
  __shared__ __align__(16) float Bs[kK][kPitch];
  const int tid = threadIdx.x;
  const int tx = tid % kSide, ty = tid / kSide;
  const int row_a = ti * kTile, row_b = tj * kTile;
  // Staging: warp w, pass p stages patch q = w + 8p of 16 row groups x 4
  // column groups; lane l takes row 4*(q % 16) + l/8, column 8*(q/16) + l%8.
  const int warp = tid / 32, lane = tid % 32;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kK) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int q = warp + 8 * p;
      const int r = 4 * (q % 16) + lane / 8;
      const int kc = 8 * (q / 16) + lane % 8;
      const int k = k0 + kc;
      const int ra = row_a + r, rb = row_b + r;
      As[kc][r] = (ra < n && k < d)
                      ? P[static_cast<long long>(ra) * ld + k] : 0.0f;
      Bs[kc][r] = (rb < n && k < d)
                      ? P[static_cast<long long>(rb) * ld + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row_a + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = row_b + 4 * tx + j;
      if (r >= n || c >= n || (ti == tj && r > c)) continue;
      G[static_cast<long long>(r) * n + c] = acc[i][j];
      G[static_cast<long long>(c) * n + r] = acc[i][j];
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int gram_launch(const float* P, long long ld, float* G, int n,
                           int d, void* stream) {
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles);
  gram_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      P, ld, G, n, d);
  return static_cast<int>(cudaGetLastError());
}
