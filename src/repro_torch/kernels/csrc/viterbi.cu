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
// The adds are the reference's own, in the same order and in fp32, and the
// running maximum takes a candidate only when it is strictly larger, so
// the first maximum wins as in jnp.argmax: labels are bit-equal to the
// reference on the same unaries.
//
// Bound: latency and dependence.  A row is L-1 dependent steps of C*C
// max-adds (13 x 676 on OCR); its bytes (L*C unaries, the C x C table)
// are a few KB.  Design: one block per sequence, thread c owns m[c]; T and
// a double-buffered m live in shared memory, so a step reads nothing from
// device memory but its C unaries.  Back pointers go to a (B, L-1, C)
// scratch tensor allocated by the caller; after the last step one thread
// takes the final argmax and walks the back pointers.
#include <cuda_runtime.h>

namespace {

__global__ void viterbi_decode_kernel(const float* __restrict__ unary,
                                      const float* __restrict__ trans,
                                      const unsigned char* __restrict__ mask,
                                      int* __restrict__ back,
                                      int* __restrict__ labels, int L,
                                      int C) {
  extern __shared__ float smem[];
  float* t = smem;          // C * C transition table
  float* m = t + C * C;     // 2 * C running scores, double-buffered
  const int c = threadIdx.x;
  const long long row = blockIdx.x;
  const float* u = unary + row * L * C;
  const unsigned char* mk = mask + row * L;
  int* bk = back + row * (L - 1) * C;

  for (int k = threadIdx.x; k < C * C; k += blockDim.x) t[k] = trans[k];
  if (c < C) m[c] = mk[0] ? u[c] : 0.0f;
  __syncthreads();

  int cur = 0;
  for (int l = 1; l < L; ++l) {
    const bool valid = mk[l] != 0;
    const float* mp = m + cur * C;
    float* mn = m + (cur ^ 1) * C;
    if (c < C) {
      float best = mp[0] + (valid ? t[c] : 0.0f);
      int arg = 0;
      for (int cp = 1; cp < C; ++cp) {
        const float v = mp[cp] + (valid ? t[cp * C + c] : 0.0f);
        if (v > best) {
          best = v;
          arg = cp;
        }
      }
      mn[c] = best + (valid ? u[static_cast<long long>(l) * C + c] : 0.0f);
      bk[static_cast<long long>(l - 1) * C + c] = arg;
    }
    __syncthreads();
    cur ^= 1;
  }

  if (threadIdx.x == 0) {
    const float* mf = m + cur * C;
    float best = mf[0];
    int y = 0;
    for (int cp = 1; cp < C; ++cp) {
      if (mf[cp] > best) {
        best = mf[cp];
        y = cp;
      }
    }
    int* lab = labels + row * L;
    lab[L - 1] = y;
    for (int l = L - 2; l >= 0; --l) {
      y = bk[static_cast<long long>(l) * C + y];
      lab[l] = y;
    }
  }
}

}  // namespace

// Launches one block per row on `stream` and returns cudaGetLastError().
// The Python wrapper checks beforehand that C fits one block and its
// shared memory (kernels/viterbi.py::MAX_LABELS).
extern "C" int viterbi_decode_launch(const float* unary, const float* trans,
                                     const unsigned char* mask, int* back,
                                     int* labels, int B, int L, int C,
                                     void* stream) {
  const int threads = ((C + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(C * C + 2 * C) * sizeof(float);
  viterbi_decode_kernel<<<B, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      unary, trans, mask, back, labels, L, C);
  return static_cast<int>(cudaGetLastError());
}
