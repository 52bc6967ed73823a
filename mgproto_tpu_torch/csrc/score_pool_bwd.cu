// Feature gradient of the fused scoring pool, for sm_90a.
//
// Replaces the TPU kernel mgproto_tpu/ops/fused_scoring.py::_bwd_kernel
// (pallas_call in _score_pool_bwd). The forward kept, for sample b and
// prototype p, the T best patches idx[b, p, :] (distinct) with values
// dens[idx] = const + x.msc[p] - 1/2 (x*x).ivar[p]. With g = dL/dvals,
//     grad[b, n, :] = sum_p w[n, p] * msc[p, :] - x[b, n, :] * sum_p w[n, p] * ivar[p, :]
//     w[n, p]       = sum_t g[b, p, t] * [idx[b, p, t] == n]
// (prototypes are constants: no gradient for msc/ivar). An index outside
// [0, HW) never matches, so padded slots contribute exactly 0.
//
// Bound on the H100: counted sparse, 4*B*P*T*d FLOPs (each nonzero entry
// of w costs 2*d FMAs) against reading g and idx (8*B*P*T bytes), the
// features and the constants and writing the gradient.
//
// Design, deterministic by construction: no float atomics, and every
// output element is summed by ONE thread in a fixed order (prototypes
// ascending), so two launches on the same inputs give bitwise-equal output.
// One block owns R rows of one sample (grid = HW/R x B) and walks the
// prototypes in tiles of TP, in order:
//   1. scatter the tile's (p, t) entries whose patch lies in the block's
//      rows into a dense shared tile W[R][TP]. A prototype's T indices are
//      distinct, so every cell receives at most one entry: no race;
//   2. one warp per row compacts the row's nonzero columns, in ascending
//      order, into a list (ballot + popc);
//   3. each thread owns some of the R*d outputs and adds w * msc and
//      w * ivar over its row's list into accumulators in shared memory.
// The TPU kernel instead builds a dense [HW, TP] w tile and runs two MXU
// products; a whole-sample [HW, d] accumulator pair (400 KB at HW = 784)
// does not fit in 227 KB of shared memory, hence the row chunks, and the
// lists skip the ~90 % of w that is zero (and, in training, the entries the
// mining mask zeroes).
//
// Known slow: every block re-reads its sample's whole g and idx and waits
// on each staging load. On the H100 a sort-by-patch design (one warp per
// patch) and a row-ownership design (each warp owns some rows and scans
// every entry) measured slower; tiles of 32 prototypes staged by cp.async
// one tile ahead were faster on dense g at HW = 196 but slower at 784 and
// in the training step, where the mining mask zeroes ~95 % of g (PERF.md).

#include <cuda_runtime.h>

#include "kernel_common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int R = 32;          // feature rows per block
constexpr int TP = 128;        // prototypes per tile

__global__ void __launch_bounds__(kThreads)
score_pool_bwd_kernel(const float* __restrict__ g,     // [B, P, T]
                      const int* __restrict__ idx,     // [B, P, T]
                      const float* __restrict__ feat,  // [B, HW, D]
                      const float* __restrict__ msc,   // [P, D]
                      const float* __restrict__ ivar,  // [P, D]
                      float* __restrict__ out,         // [B, HW, D]
                      int HW, int P, int D, int T) {
  extern __shared__ float smem[];
  float* s_w = smem;                                  // [R][TP]
  float* s_am = s_w + R * TP;                         // [R][D]
  float* s_as = s_am + R * D;                         // [R][D]
  int* s_list = reinterpret_cast<int*>(s_as + R * D); // [R][TP]
  int* s_cnt = s_list + R * TP;                       // [R]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * R;
  const int rows = min(R, HW - n0);

  for (int o = tid; o < R * D; o += kThreads) s_am[o] = s_as[o] = 0.f;

  const long long gb = (long long)b * P * T;
  for (int p0 = 0; p0 < P; p0 += TP) {
    const int tp = min(TP, P - p0);
    __syncthreads();  // the previous tile's W and lists are consumed
    for (int i = tid; i < R * TP; i += kThreads) s_w[i] = 0.f;
    __syncthreads();
    // 1. scatter (coalesced over the tile's contiguous [tp * T] entries)
    const long long e0 = gb + (long long)p0 * T;
    for (int e = tid; e < tp * T; e += kThreads) {
      const int n = idx[e0 + e] - n0;
      if (n >= 0 && n < rows) s_w[n * TP + e / T] = g[e0 + e];
    }
    __syncthreads();
    // 2. per-row lists of nonzero columns, ascending
    for (int r = warp; r < rows; r += kThreads / 32) {
      int cnt = 0;
      for (int j0 = 0; j0 < tp; j0 += 32) {
        const int j = j0 + lane;
        const bool nz = j < tp && s_w[r * TP + j] != 0.f;
        const unsigned mask = __ballot_sync(0xffffffffu, nz);
        if (nz) s_list[r * TP + cnt + __popc(mask & ((1u << lane) - 1u))] = j;
        cnt += __popc(mask);
      }
      if (lane == 0) s_cnt[r] = cnt;
    }
    __syncthreads();
    // 3. ordered accumulation, one owner thread per output element
    for (int o = tid; o < rows * D; o += kThreads) {
      const int r = o / D, k = o - r * D;
      float am = s_am[o], as = s_as[o];
      const int cnt = s_cnt[r];
      for (int m = 0; m < cnt; ++m) {
        const int j = s_list[r * TP + m];
        const float w = s_w[r * TP + j];
        const long long q = (long long)(p0 + j) * D + k;
        am = fmaf(w, __ldg(msc + q), am);
        as = fmaf(w, __ldg(ivar + q), as);
      }
      s_am[o] = am;
      s_as[o] = as;
    }
  }
  const long long ob = ((long long)b * HW + n0) * D;
  for (int o = tid; o < rows * D; o += kThreads) {
    out[ob + o] = s_am[o] - feat[ob + o] * s_as[o];
  }
}

int smem_bytes(int D) { return (R * TP + 2 * R * D) * 4 + (R * TP + R) * 4; }

kernel_common::SmemOptIn g_smem_opt_in;

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
int score_pool_bwd(const float* g, const int* idx, const float* feat,
                   const float* msc, const float* ivar, float* out, int B,
                   int HW, int P, int D, int T, void* stream) {
  const int smem = smem_bytes(D);
  const cudaError_t e =
      kernel_common::reserve_smem(g_smem_opt_in, score_pool_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((HW + R - 1) / R, B);
  score_pool_bwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      g, idx, feat, msc, ivar, out, HW, P, D, T);
  return (int)cudaGetLastError();
}

}  // extern "C"
