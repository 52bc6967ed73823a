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
// Bound on the H100: bytes and operations nearly alike. The bank slab is
// read once (4*A*N*D bytes, 16.4 MB at A = 80, N = 800, D = 64: 4.9 us at
// 3.35 TB/s) against 8*A*N*K*D f32 operations (328 MFLOP at K = 10: 4.9 us
// at 67 TFLOP/s). So the read has to be spread over every SM and the FMAs
// fed from registers.
//
// Design: two launches.
//  1. em_estep_partial_kernel, grid (splits, A): each block takes R = 64
//     rows of one class (the last split of a class is ragged), so a class
//     is spread over ceil(N / R) blocks and several blocks share an SM. The
//     block's rows arrive by 16-byte cp.async into rows padded to 68 floats
//     (16-byte aligned, and a warp's row-wise float4 loads hit every bank
//     once). K is padded to an even KP, a template parameter; padded slots
//     get msc = ivar = 0 and c = -inf, so their log-density is exactly -inf
//     and their responsibility exactly 0, and the row maximum is always a
//     live slot's (never -inf - (-inf)).
//       A. w = [x | x^2] . [msc | -ivar/2]^T: a thread owns one row and half
//          of the KP components; x^2 is formed in registers, each float4 of
//          x feeds 8 FMAs per component, the constants are warp broadcasts.
//       B. the softmax: both threads of a row take its max and sum over all
//          KP in one order (so they agree bit for bit) and each writes the
//          responsibilities of its half; rows past N get r = 0.
//       C. [sx | sxx] = r^T [x | x^2]: a thread owns 2 components x 4
//          columns of both statistics (16 accumulators) and walks the rows
//          in order; one float4 of x and two responsibilities feed 16 FMAs.
//     The block's logsumexps are added by a fixed warp tree. The block
//     writes its partial (sx, sxx, s, sum of logsumexp) to a scratch slot.
//  2. em_estep_combine_kernel, grid (elements / 256, A): one thread per
//     output element adds the class's partials in split order and divides
//     ll by N. It is a programmatic dependent launch: its blocks are
//     scheduled as the partial grid drains and wait (griddepcontrol.wait)
//     for all of it, which hides most of the gap between the two launches.
// Every sum has one owner and a fixed order: no float atomics, repeats are
// bitwise equal. R depends on nothing but the kernel's constants, so a
// class's statistics are the same bits whichever slab (compact A = 80 or
// dense A = 200) it is computed in.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "kernel_common.cuh"

namespace {

constexpr int kThreads = 128;        // partial kernel: 4 warps
constexpr int kCombineThreads = 256;
constexpr int R = 64;                // bank rows per block (one split)
constexpr int DMAX = 64;             // widest row the kernel takes
constexpr int XS = DMAX + 4;         // shared row stride of x, in floats
constexpr int KMAX = 32;             // components per class the kernel takes

int splits_of(int n) { return (n + R - 1) / R; }

// Floats of one block's partial: sx [K*D] | sxx [K*D] | s [K] | the sum of
// the block's logsumexps, padded to 4 so every slot is 16-byte aligned.
__host__ __device__ inline int partial_floats(int D, int K) {
  return (2 * K * D + K + 1 + 3) / 4 * 4;
}

template <int KP>
struct Smem {
  float x[R][XS];       // the block's rows; zero past N and past D
  float msc[KP][DMAX];  // mu / sigma^2; zero past D and in padded slots
  float ivh[KP][DMAX];  // -1/2 / sigma^2; the same zeros
  float c[KP];          // const + log prior; -inf in padded slots
  float w[R][KP + 1];   // log-densities, then responsibilities (odd stride)
  float lse[R];         // logsumexp per row; 0 past N
};

template <int KP>
__global__ void __launch_bounds__(kThreads, 8)  // 8 blocks an SM: <= 64 registers
em_estep_partial_kernel(const float* __restrict__ x,     // [A, N, D]
                        const float* __restrict__ msc,   // [A, K, D]
                        const float* __restrict__ ivar,  // [A, K, D]
                        const float* __restrict__ cnst,  // [A, K]
                        float* __restrict__ part,        // [A, splits, P]
                        int N, int D, int K) {
  constexpr int KH = KP / 2;
  __shared__ __align__(16) Smem<KP> sm;
  const int tid = threadIdx.x;
  const int split = blockIdx.x, a = blockIdx.y;
  const int n0 = split * R;
  const int rows = min(R, N - n0);
  const int d4 = D / 4;
  // let the combine launch be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;");

  // stage the rows, 16 bytes a copy; a class's rows are contiguous
  const float* xa = x + ((long long)a * N + n0) * D;
  for (int i = tid; i < R * (DMAX / 4); i += kThreads) {
    const int n = i / (DMAX / 4), q = i % (DMAX / 4);
    float* dst = &sm.x[n][4 * q];
    if (n < rows && q < d4) {
      __pipeline_memcpy_async(dst, xa + (long long)n * D + 4 * q, 16);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __pipeline_commit();
  const long long pb = (long long)a * K * D;
  for (int i = tid; i < KP * DMAX; i += kThreads) {
    const int k = i / DMAX, j = i % DMAX;
    const bool live = k < K && j < D;
    sm.msc[k][j] = live ? msc[pb + k * D + j] : 0.f;
    sm.ivh[k][j] = live ? -0.5f * ivar[pb + k * D + j] : 0.f;
  }
  if (tid < KP) sm.c[tid] = tid < K ? cnst[(long long)a * K + tid] : -CUDART_INF_F;
  __pipeline_wait_prior(0);
  __syncthreads();

  const int n = tid % R, h = tid / R;  // phases A and B: a row, a half of KP
  // A. weighted log-densities of row n, components [h*KH, h*KH + KH)
  {
    float acc[KH];
#pragma unroll
    for (int kk = 0; kk < KH; ++kk) acc[kk] = 0.f;
    const float* xr = sm.x[n];
#pragma unroll 1
    for (int j = 0; j < DMAX; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(xr + j);
      const float4 v2 = make_float4(v.x * v.x, v.y * v.y, v.z * v.z, v.w * v.w);
#pragma unroll
      for (int kk = 0; kk < KH; ++kk) {
        const float4 m = *reinterpret_cast<const float4*>(&sm.msc[h * KH + kk][j]);
        const float4 q = *reinterpret_cast<const float4*>(&sm.ivh[h * KH + kk][j]);
        float t = acc[kk];
        t = fmaf(v.x, m.x, t);
        t = fmaf(v2.x, q.x, t);
        t = fmaf(v.y, m.y, t);
        t = fmaf(v2.y, q.y, t);
        t = fmaf(v.z, m.z, t);
        t = fmaf(v2.z, q.z, t);
        t = fmaf(v.w, m.w, t);
        t = fmaf(v2.w, q.w, t);
        acc[kk] = t;
      }
    }
#pragma unroll
    for (int kk = 0; kk < KH; ++kk) sm.w[n][h * KH + kk] = sm.c[h * KH + kk] + acc[kk];
  }
  __syncthreads();
  // B. stable softmax over KP; both threads of a row take the same max and
  // sum in the same order, and each keeps the exponentials of its own half
  {
    float* wr = sm.w[n];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < KP; ++k) m = fmaxf(m, wr[k]);
    float z = 0.f;
    float e[KH];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int kk = 0; kk < KH; ++kk) {
        const float t = expf(wr[hh * KH + kk] - m);
        z += t;
        if (hh == h) e[kk] = t;
      }
    }
    const float inv = 1.f / z;
    const bool valid = n < rows;
#pragma unroll
    for (int kk = 0; kk < KH; ++kk) e[kk] = valid ? e[kk] * inv : 0.f;
    __syncthreads();  // the row's other half has read it
#pragma unroll
    for (int kk = 0; kk < KH; ++kk) wr[h * KH + kk] = e[kk];
    if (h == 0) sm.lse[n] = valid ? m + logf(z) : 0.f;
  }
  __syncthreads();

  float* pp = part + ((long long)a * gridDim.x + split) * partial_floats(D, K);
  if (tid < 32) {  // the block's sum of logsumexps, by a fixed tree
    float v = sm.lse[tid] + sm.lse[tid + 32];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (tid == 0) pp[2 * K * D + K] = v;
  }
  // C. ordered accumulation: item = (4 columns, 2 components)
  for (int it = tid; it < (DMAX / 4) * KH; it += kThreads) {
    const int q = it % (DMAX / 4), k0 = 2 * (it / (DMAX / 4));
    float4 sx0 = make_float4(0.f, 0.f, 0.f, 0.f), sx1 = sx0, sq0 = sx0, sq1 = sx0;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(&sm.x[r][4 * q]);
      const float r0 = sm.w[r][k0], r1 = sm.w[r][k0 + 1];
      const float4 v2 = make_float4(v.x * v.x, v.y * v.y, v.z * v.z, v.w * v.w);
      sx0.x = fmaf(r0, v.x, sx0.x);
      sx0.y = fmaf(r0, v.y, sx0.y);
      sx0.z = fmaf(r0, v.z, sx0.z);
      sx0.w = fmaf(r0, v.w, sx0.w);
      sq0.x = fmaf(r0, v2.x, sq0.x);
      sq0.y = fmaf(r0, v2.y, sq0.y);
      sq0.z = fmaf(r0, v2.z, sq0.z);
      sq0.w = fmaf(r0, v2.w, sq0.w);
      sx1.x = fmaf(r1, v.x, sx1.x);
      sx1.y = fmaf(r1, v.y, sx1.y);
      sx1.z = fmaf(r1, v.z, sx1.z);
      sx1.w = fmaf(r1, v.w, sx1.w);
      sq1.x = fmaf(r1, v2.x, sq1.x);
      sq1.y = fmaf(r1, v2.y, sq1.y);
      sq1.z = fmaf(r1, v2.z, sq1.z);
      sq1.w = fmaf(r1, v2.w, sq1.w);
      s0 += r0;
      s1 += r1;
    }
    if (q < d4) {
      if (k0 < K) {
        *reinterpret_cast<float4*>(pp + k0 * D + 4 * q) = sx0;
        *reinterpret_cast<float4*>(pp + (K + k0) * D + 4 * q) = sq0;
      }
      if (k0 + 1 < K) {
        *reinterpret_cast<float4*>(pp + (k0 + 1) * D + 4 * q) = sx1;
        *reinterpret_cast<float4*>(pp + (K + k0 + 1) * D + 4 * q) = sq1;
      }
    }
    if (q == 0) {
      if (k0 < K) pp[2 * K * D + k0] = s0;
      if (k0 + 1 < K) pp[2 * K * D + k0 + 1] = s1;
    }
  }
}

__global__ void __launch_bounds__(kCombineThreads)
em_estep_combine_kernel(const float* __restrict__ part,  // [A, splits, P]
                        float* __restrict__ ll,          // [A]
                        float* __restrict__ s,           // [A, K]
                        float* __restrict__ sx,          // [A, K, D]
                        float* __restrict__ sxx,         // [A, K, D]
                        int N, int D, int K, int splits) {
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the partials are written
  const int a = blockIdx.y;
  const int e = blockIdx.x * kCombineThreads + threadIdx.x;
  const int kd = K * D;
  if (e > 2 * kd + K) return;
  const int p = partial_floats(D, K);
  const float* pa = part + (long long)a * splits * p + e;
  float v = 0.f;
#pragma unroll 4
  for (int i = 0; i < splits; ++i) v += pa[(long long)i * p];
  if (e < kd) {
    sx[(long long)a * kd + e] = v;
  } else if (e < 2 * kd) {
    sxx[(long long)a * kd + e - kd] = v;
  } else if (e < 2 * kd + K) {
    s[(long long)a * K + e - 2 * kd] = v;
  } else {
    ll[a] = v / (float)N;
  }
}

template <int KP>
cudaError_t launch_partial(const float* x, const float* msc, const float* ivar,
                           const float* cnst, float* part, int A, int N, int D,
                           int K, cudaStream_t stream) {
  em_estep_partial_kernel<KP><<<dim3(splits_of(N), A), kThreads, 0, stream>>>(
      x, msc, ivar, cnst, part, N, D, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the partial-statistics scratch `em_estep` takes for A classes.
long long em_estep_scratch_bytes(int A, int N, int D, int K) {
  return 4LL * A * splits_of(N) * partial_floats(D, K);
}

// Launch both kernels on `stream`; returns the cudaError_t of the launches
// (0 = queued), or cudaErrorInvalidValue for K outside [1, 32], D not a
// multiple of 4 in [4, 64], or an empty A or N. `scratch` holds
// em_estep_scratch_bytes(A, N, D, K) bytes, 16-byte aligned.
int em_estep(const float* x, const float* msc, const float* ivar,
             const float* cnst, float* ll, float* s, float* sx, float* sxx,
             float* scratch, int A, int N, int D, int K, void* stream) {
  if (K < 1 || K > KMAX || D < 4 || D > DMAX || D % 4 != 0 || A < 1 || N < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaErrorInvalidValue;
  switch ((K + 1) / 2 * 2) {
#define EM_ESTEP_CASE(KP) \
  case KP: e = launch_partial<KP>(x, msc, ivar, cnst, scratch, A, N, D, K, st); break;
    EM_ESTEP_CASE(2) EM_ESTEP_CASE(4) EM_ESTEP_CASE(6) EM_ESTEP_CASE(8)
    EM_ESTEP_CASE(10) EM_ESTEP_CASE(12) EM_ESTEP_CASE(14) EM_ESTEP_CASE(16)
    EM_ESTEP_CASE(18) EM_ESTEP_CASE(20) EM_ESTEP_CASE(22) EM_ESTEP_CASE(24)
    EM_ESTEP_CASE(26) EM_ESTEP_CASE(28) EM_ESTEP_CASE(30) EM_ESTEP_CASE(32)
#undef EM_ESTEP_CASE
  }
  if (e != cudaSuccess) return (int)e;
  const int elems = 2 * K * D + K + 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((elems + kCombineThreads - 1) / kCombineThreads, A);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, em_estep_combine_kernel, (const float*)scratch, ll, s, sx,
                                 sxx, N, D, K, splits_of(N));
}

}  // extern "C"
