// Fused Gaussian prototype scoring + top-T spatial pool, forward, for sm_90a.
//
// Replaces the TPU kernel mgproto_tpu/ops/fused_scoring.py::_fwd_kernel
// (pallas_call in _score_pool_fwd_impl). For sample b and prototype p it
// computes, at every patch n of the [HW, d] feature map,
//     dens[n, p] = const[p] + x_n . msc[p] - 1/2 (x_n * x_n) . ivar[p]
// (msc = mu / sigma^2, ivar = 1 / sigma^2, both precomputed in f32 by the
// caller) and keeps only the T largest values with their flat indices,
// sorted descending, ties to the LOWEST index (lax.top_k's order). The
// [B*HW, P] density matrix never reaches device memory.
//
// Bound on the H100: operations. 4*B*HW*P*d f32 FLOPs against a few MB of
// inputs and outputs; with IEEE f32 on the CUDA cores (no TF32, no tensor
// cores) the floor is the 67 TFLOP/s non-tensor f32 rate.
//
// Design. The TPU kernel holds a whole [HW, 128] density tile in VMEM and
// masks each maximum out T times; 227 KB of shared memory cannot hold that
// tile at HW = 784. Here one block of TP threads owns TP prototypes (one per
// thread) of one sample. Their msc/ivar columns sit in shared memory for the
// whole run; the feature map streams through shared memory CH rows at a
// time, in increasing row order. Each thread scores NP rows per pass of the
// d loop (each msc/ivar value is read once for NP rows) and keeps a running
// descending top-T list in shared memory. A candidate enters only when it is
// STRICTLY greater than the current T-th value and is placed after every
// equal entry, so equal values keep the lower index. The ragged prototype
// edge is masked, not padded, and the block writes its [TP, T] slab of the
// [B, P, T] outputs as one contiguous, coalesced range.
//
// Known slow: one prototype per thread leaves 2 warps per block, and the d
// loop issues shared loads for every FMA pair. A later change can move the
// two products onto the tensor cores (mma/wgmma with a 3xTF32 split) and
// stage the features with TMA.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "kernel_common.cuh"

namespace {

constexpr int TP = 64;  // prototypes per block, one per thread
constexpr int CH = 32;  // feature rows staged in shared memory per chunk
constexpr int NP = 4;   // rows scored per pass of the d loop (CH % NP == 0)

__global__ void __launch_bounds__(TP)
score_pool_fwd_kernel(const float* __restrict__ feat,   // [B, HW, D]
                      const float* __restrict__ msc,    // [P, D]
                      const float* __restrict__ ivar,   // [P, D]
                      const float* __restrict__ cnst,   // [P]
                      float* __restrict__ vals,         // [B, P, T]
                      int* __restrict__ idx,            // [B, P, T]
                      int HW, int P, int D, int T) {
  extern __shared__ float smem[];
  float* s_msc = smem;                 // [D][TP]
  float* s_ivar = s_msc + D * TP;      // [D][TP]
  float* s_feat = s_ivar + D * TP;     // [CH][D]
  float* s_val = s_feat + CH * D;      // [T][TP]
  int* s_idx = reinterpret_cast<int*>(s_val + T * TP);  // [T][TP]

  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * TP;
  const bool live = p0 + t < P;

  // prototype constants: coalesced global reads, transposed into [D][TP]
  for (int i = t; i < D * TP; i += TP) {
    const int j = i / D, k = i - j * D;
    const bool ok = p0 + j < P;
    const long long g = (long long)p0 * D + i;
    s_msc[k * TP + j] = ok ? msc[g] : 0.f;
    s_ivar[k * TP + j] = ok ? ivar[g] : 0.f;
  }
  const float c = live ? cnst[p0 + t] : -CUDART_INF_F;
  for (int r = 0; r < T; ++r) {
    s_val[r * TP + t] = -CUDART_INF_F;
    s_idx[r * TP + t] = 0;
  }
  float thr = -CUDART_INF_F;  // current T-th value of this thread's list

  const float* fb = feat + (long long)b * HW * D;
  for (int n0 = 0; n0 < HW; n0 += CH) {
    __syncthreads();  // previous chunk fully consumed (and constants staged)
    for (int i = t; i < CH * D; i += TP) {
      const int n = n0 + i / D;
      s_feat[i] = n < HW ? fb[(long long)n0 * D + i] : 0.f;
    }
    __syncthreads();
    const int rows = min(CH, HW - n0);
    for (int r = 0; r < rows; r += NP) {
      float cross[NP], quad[NP];
#pragma unroll
      for (int q = 0; q < NP; ++q) cross[q] = quad[q] = 0.f;
      for (int k = 0; k < D; ++k) {
        const float m = s_msc[k * TP + t];
        const float iv = s_ivar[k * TP + t];
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          const float x = s_feat[(r + q) * D + k];
          cross[q] = fmaf(x, m, cross[q]);
          quad[q] = fmaf(x * x, iv, quad[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const float v = c + cross[q] - 0.5f * quad[q];
        if (r + q < rows && v > thr) {
          // insert after every entry >= v: equal values keep lower indices
          int j = T - 1;
          while (j > 0 && s_val[(j - 1) * TP + t] < v) {
            s_val[j * TP + t] = s_val[(j - 1) * TP + t];
            s_idx[j * TP + t] = s_idx[(j - 1) * TP + t];
            --j;
          }
          s_val[j * TP + t] = v;
          s_idx[j * TP + t] = n0 + r + q;
          thr = s_val[(T - 1) * TP + t];
        }
      }
    }
  }
  __syncthreads();
  // the block's [TP, T] slab of the outputs is one contiguous range
  const long long base = ((long long)b * P + p0) * T;
  for (int i = t; i < TP * T; i += TP) {
    const int j = i / T, r = i - j * T;
    if (p0 + j < P) {
      vals[base + i] = s_val[r * TP + j];
      idx[base + i] = s_idx[r * TP + j];
    }
  }
}

// Dynamic shared memory a launch needs, in bytes.
int smem_bytes(int D, int T) { return (2 * D * TP + CH * D + 2 * T * TP) * 4; }

kernel_common::SmemOptIn g_smem_opt_in;

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
int score_pool_fwd(const float* feat, const float* msc, const float* ivar,
                   const float* cnst, float* vals, int* idx, int B, int HW,
                   int P, int D, int T, void* stream) {
  const int smem = smem_bytes(D, T);
  const cudaError_t e =
      kernel_common::reserve_smem(g_smem_opt_in, score_pool_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((P + TP - 1) / TP, B);
  score_pool_fwd_kernel<<<grid, TP, smem, (cudaStream_t)stream>>>(
      feat, msc, ivar, cnst, vals, idx, HW, P, D, T);
  return (int)cudaGetLastError();
}

}  // extern "C"
