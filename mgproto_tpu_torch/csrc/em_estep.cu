// Fused EM E-step over the memory bank, for sm_90a.
//
// Replaces the TPU kernel mgproto_tpu/ops/em_kernels.py::_estep_kernel
// (pallas_call in _estep_stats_impl). For class a with bank rows x[a, n]
// (N rows of width D) and K mixture components it computes the weighted
// log-densities
//     w[n, k] = c[a, k] + x_n . msc[a, k] - 1/2 (x_n * x_n) . ivar[a, k]
// (c = density constant + log(prior + eps), folded by the caller), the
// responsibilities r = softmax_k(w), and writes only their sufficient
// statistics
//     s[a, k] = sum_n r[n, k],  sx[a, k, :] = sum_n r[n, k] x_n,
//     sxx[a, k, :] = sum_n r[n, k] x_n^2,  ll[a] = mean_n logsumexp_k w[n, :].
// No [N, K] array reaches device memory.
//
// Bound on the H100: bytes. The bank slab is read once (4*A*N*D bytes,
// 16.4 MB at A = 80, N = 800, D = 64) against ~6*A*N*K*D FLOPs, about 4
// FLOPs per byte, below the card's f32 balance point.
//
// Design: one block per class. msc/ivar/c for K <= 32 stay in shared memory;
// the class's rows stream through shared memory CH at a time (the whole
// [800, 64] f32 slab is 205 KB, too much beside the rest), copied with
// cp.async into two buffers so the next chunk is in flight while the
// current one is consumed (a staging loop that waits on each load pays one
// memory latency per iteration). Per chunk:
//   A. one thread per (row, k) pair computes w[n, k] (rows padded to D+1
//      floats in shared memory to spread the banks);
//   B. one thread per row takes the stable softmax over K (max, exp, sum),
//      writes r[n, :] and logsumexp to shared memory;
//   C. one thread per output element of s/sx/sxx adds the chunk's rows in
//      order into its own accumulator; thread 0 adds the logsumexps in order.
// Every sum has one owner and a fixed order: deterministic, atomic-free.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "kernel_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int CH = 64;     // bank rows staged per chunk
constexpr int KMAX = 32;   // components per class the kernel takes

__global__ void __launch_bounds__(kThreads)
em_estep_kernel(const float* __restrict__ x,     // [A, N, D]
                const float* __restrict__ msc,   // [A, K, D]
                const float* __restrict__ ivar,  // [A, K, D]
                const float* __restrict__ cnst,  // [A, K]
                float* __restrict__ ll,          // [A]
                float* __restrict__ s,           // [A, K]
                float* __restrict__ sx,          // [A, K, D]
                float* __restrict__ sxx,         // [A, K, D]
                int N, int D, int K) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* s_msc = smem;                 // [K][DP]
  float* s_ivar = s_msc + K * DP;      // [K][DP]
  float* s_c = s_ivar + K * DP;        // [K]
  float* s_xbuf = s_c + K;             // 2 x [CH][DP]
  float* s_r = s_xbuf + 2 * CH * DP;   // [CH][K]  w, then r
  float* s_ln = s_r + CH * K;          // [CH]     logsumexp per row
  float* s_sx = s_ln + CH;             // [K*D]    accumulators
  float* s_sxx = s_sx + K * D;         // [K*D]

  const int tid = threadIdx.x;
  const int a = blockIdx.x;
  const long long pb = (long long)a * K * D;
  for (int i = tid; i < K * D; i += kThreads) {
    const int k = i / D, j = i - k * D;
    s_msc[k * DP + j] = msc[pb + i];
    s_ivar[k * DP + j] = ivar[pb + i];
    s_sx[i] = s_sxx[i] = 0.f;
  }
  if (tid < K) s_c[tid] = cnst[(long long)a * K + tid];
  float acc_s = 0.f;   // thread k < K: sum_n r[n, k]
  float ll_sum = 0.f;  // thread 0

  const float* xa = x + (long long)a * N * D;
  // queue the cp.async copies of rows [n0, n0 + CH) into buffer `buf`
  auto stage = [&](int n0, int buf) {
    float* dst = s_xbuf + buf * CH * DP;
    const int rows = min(CH, N - n0);
    for (int i = tid; i < rows * D; i += kThreads) {
      const int n = i / D, j = i - n * D;
      __pipeline_memcpy_async(dst + n * DP + j, xa + (long long)n0 * D + i, 4);
    }
    __pipeline_commit();
  };
  stage(0, 0);
  for (int n0 = 0, it = 0; n0 < N; n0 += CH, ++it) {
    const int rows = min(CH, N - n0);
    if (n0 + CH < N) {
      stage(n0 + CH, (it + 1) & 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // this chunk is in shared memory (and constants staged)
    const float* s_x = s_xbuf + (it & 1) * CH * DP;
    // A. weighted log-densities
    for (int q = tid; q < rows * K; q += kThreads) {
      const int n = q / K, k = q - n * K;
      const float* xr = s_x + n * DP;
      const float* mr = s_msc + k * DP;
      const float* vr = s_ivar + k * DP;
      float cross = 0.f, quad = 0.f;
      for (int j = 0; j < D; ++j) {
        const float v = xr[j];
        cross = fmaf(v, mr[j], cross);
        quad = fmaf(v * v, vr[j], quad);
      }
      s_r[n * K + k] = s_c[k] + cross - 0.5f * quad;
    }
    __syncthreads();
    // B. stable softmax over K per row
    for (int n = tid; n < rows; n += kThreads) {
      float* wr = s_r + n * K;
      float m = -CUDART_INF_F;
      for (int k = 0; k < K; ++k) m = fmaxf(m, wr[k]);
      float z = 0.f;
      for (int k = 0; k < K; ++k) {
        const float e = expf(wr[k] - m);
        wr[k] = e;
        z += e;
      }
      const float inv = 1.f / z;
      for (int k = 0; k < K; ++k) wr[k] *= inv;
      s_ln[n] = m + logf(z);
    }
    __syncthreads();
    // C. ordered accumulation
    for (int o = tid; o < K * D; o += kThreads) {
      const int k = o / D, j = o - k * D;
      float a1 = s_sx[o], a2 = s_sxx[o];
      for (int n = 0; n < rows; ++n) {
        const float r = s_r[n * K + k];
        const float v = s_x[n * DP + j];
        a1 = fmaf(r, v, a1);
        a2 = fmaf(r, v * v, a2);
      }
      s_sx[o] = a1;
      s_sxx[o] = a2;
    }
    if (tid < K) {
      for (int n = 0; n < rows; ++n) acc_s += s_r[n * K + tid];
    }
    if (tid == 0) {
      for (int n = 0; n < rows; ++n) ll_sum += s_ln[n];
    }
    __syncthreads();  // the buffer is free for the chunk after next
  }
  for (int i = tid; i < K * D; i += kThreads) {
    sx[pb + i] = s_sx[i];
    sxx[pb + i] = s_sxx[i];
  }
  if (tid < K) s[(long long)a * K + tid] = acc_s;
  if (tid == 0) ll[a] = ll_sum / (float)N;
}

int smem_bytes(int D, int K) {
  const int DP = D + 1;
  return (2 * K * DP + K + 2 * CH * DP + CH * K + CH + 2 * K * D) * 4;
}

kernel_common::SmemOptIn g_smem_opt_in;

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued),
// or cudaErrorInvalidValue for K outside [1, 32].
int em_estep(const float* x, const float* msc, const float* ivar,
             const float* cnst, float* ll, float* s, float* sx, float* sxx,
             int A, int N, int D, int K, void* stream) {
  if (K < 1 || K > KMAX) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(D, K);
  const cudaError_t e =
      kernel_common::reserve_smem(g_smem_opt_in, em_estep_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  em_estep_kernel<<<A, kThreads, smem, (cudaStream_t)stream>>>(
      x, msc, ivar, cnst, ll, s, sx, sxx, N, D, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
