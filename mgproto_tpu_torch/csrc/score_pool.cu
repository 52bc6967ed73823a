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
// inputs and outputs: 0.120 ms at the train step's B = 80, HW = 196,
// P = 2000, d = 64 on the 67 TFLOP/s non-tensor f32 rate. IEEE f32 on the
// CUDA cores: TF32 tensor cores round too coarsely for the served scores.
//
// Design. The two products are one: [x | x*x] . [msc | -ivar/2] over a depth
// K = 2d (the -1/2 scale is exact), a register-tiled f32 product, and the
// top-T selection runs in other warps at the same time.
//  * A block owns PT = 128 prototypes. Their [K][PT] slab (k-major,
//    transposed once when the block starts) stays in shared memory while
//    the block walks its samples b = blockIdx.y, + gridDim.y, ...; gridDim.y
//    is chosen so that the grid is about one block per SM (16 x 8 = 128
//    blocks at P = 2000 for B = 80 and for B = 8). The samples' rows are
//    laid end to end and cut into tiles of RT = 64 rows, so a tile may hold
//    the end of one sample and the start of the next: HW = 196 is not a
//    multiple of 64, and a sample's ragged last tile would cost a full one.
//  * Warps 0-3 compute. A tile is copied by cp.async into a row-major
//    staging buffer one tile ahead, then transposed into a k-major [K][RT]
//    tile with x*x computed once there. Each thread scores an 8 x 8
//    micro-tile (rows 8g..8g+7; prototypes 4h..4h+3 and 64+4h..64+4h+3) in
//    registers: per step of k, four 16-byte shared loads feed 64 FMAs (a
//    4 x 8 micro-tile needs 1.5x the shared-memory bandwidth of the FMAs it
//    feeds). The 64 x 128 products go to one of two shared buffers.
//  * Warps 4-11 select, one thread per prototype in each of two groups:
//    group 0 keeps the lists of the block's even samples, group 1 of its
//    odd ones. A list is descending and held in registers (TM >= T slots by
//    template); a row enters when it is STRICTLY greater than an entry and
//    after every equal one (rows arrive in ascending order, so equal values
//    keep the lower index). Only rows above a bound on the T-th value
//    (refreshed once per tile) are candidates, and an insertion is a fixed
//    chain of selects over the slots, so the lanes of a warp never diverge.
//    At a sample's last patch the thread writes the prototype's T outputs.
//  * Named barriers hand the product buffers between the two sides (full:
//    compute -> select; empty: select -> compute), so the selection of
//    tile i overlaps the product of tile i + 1.
// What bounds it is not settled: the product (2*B*HW*P*d FMAs) and the
// selection (a chain of TM selects per candidate pass, a pass for nearly
// every row of a sample's first tile and fewer later) share the SM's four
// schedulers, and two product buffers give one tile of slack between
// them; more product throughput and fewer passes each measured no faster,
// a second selecting group faster. The first redesign kept the lists in
// shared memory and shifted them with a loop: nearly every row then cost a
// whole warp a deep dependent shift, 1.53 ms at B = 80 (chip_smoke.py on an
// NVIDIA H100 80GB HBM3, 700 W), slower than the kernel it replaced.
// Shared memory: 64 KB of prototypes, 17 KB staging, 32 KB of [x | x*x] and
// 2 x 32 KB of products: 178 KB at d = 64, one block per SM. T > 32 and
// d > 64 are refused (cudaErrorInvalidValue).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "kernel_common.cuh"

namespace {

constexpr int kCompute = 128;             // warps 0-3: staging and products
constexpr int kSelect = 256;              // warps 4-11: two groups, a thread per prototype
constexpr int kThreads = kCompute + kSelect;
constexpr int PT = 128;                   // prototypes per block
constexpr int RT = 64;                    // feature rows per tile
constexpr int HALF = PT / 2;
constexpr int kMaxT = 32;                 // the widest list kept in registers
constexpr int kMaxD = 64;                 // features per row (shared memory)
// named barriers (0 is __syncthreads)
constexpr int kBarFull = 1;               // + buffer: products ready
constexpr int kBarEmpty = 3;              // + buffer: products consumed
constexpr int kBarCompute = 5;            // among the compute warps

__host__ __device__ inline int staging_stride(int D) { return ((D + 3) & ~3) + 4; }

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Insert (v, n) into a descending list of TM entries held in registers,
// after every entry >= v, the last entry dropping out. Branch-free: every
// slot is a select, so the lanes of a warp never diverge. A v not above the
// last entry is a no-op.
template <int TM>
__device__ __forceinline__ void list_insert(float (&lv)[TM], int (&li)[TM], float v, int n) {
  bool above[TM];  // v > slot j's value
#pragma unroll
  for (int j = 0; j < TM; ++j) above[j] = v > lv[j];
#pragma unroll
  for (int j = TM - 1; j > 0; --j) {
    lv[j] = above[j - 1] ? lv[j - 1] : (above[j] ? v : lv[j]);
    li[j] = above[j - 1] ? li[j - 1] : (above[j] ? n : li[j]);
  }
  lv[0] = above[0] ? v : lv[0];
  li[0] = above[0] ? n : li[0];
}

template <int TM>
__device__ __forceinline__ void list_reset(float (&lv)[TM], int (&li)[TM]) {
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    lv[j] = -CUDART_INF_F;
    li[j] = 0;
  }
}

// The T-th value of a list: the least of its first T (a min, not lv[T - 1],
// which would index the list at run time and move it to local memory).
template <int TM>
__device__ __forceinline__ float list_tth(const float (&lv)[TM], int T) {
  float t = lv[0];
#pragma unroll
  for (int j = 1; j < TM; ++j)
    if (j < T) t = fminf(t, lv[j]);
  return t;
}

template <int TM>  // list slots in registers, TM >= T
__global__ void __launch_bounds__(kThreads, 1)
score_pool_fwd_kernel(const float* __restrict__ feat,   // [B, HW, D]
                      const float* __restrict__ msc,    // [P, D]
                      const float* __restrict__ ivar,   // [P, D]
                      const float* __restrict__ cnst,   // [P]
                      float* __restrict__ vals,         // [B, P, T]
                      int* __restrict__ idx,            // [B, P, T]
                      int B, int HW, int P, int D, int T) {
  extern __shared__ __align__(16) float smem[];
  const int K = 2 * D;
  const int SD = staging_stride(D);
  float* s_p = smem;                    // [K][PT]  [msc | -ivar/2], k-major
  float* s_x = s_p + K * PT;            // [K][RT]  [x | x*x], k-major
  float* s_d = s_x + K * RT;            // 2 x [RT][PT] products
  float* s_stage = s_d + 2 * RT * PT;   // [RT][SD] row-major staging

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PT;
  const int G = gridDim.y;
  // the block's samples b = blockIdx.y + s * G, their rows laid end to end
  // (row f is patch f % HW of sample f / HW), cut into tiles of RT rows
  const int nsamp = (B - (int)blockIdx.y + G - 1) / G;
  const int nrows = nsamp * HW;
  const int tiles = (nrows + RT - 1) / RT;

  // the prototype slab: lane-consecutive prototypes, so the transposed
  // shared stores are conflict-free; the global reads hit L1 across k
  for (int i = tid; i < PT * D; i += kThreads) {
    const int j = i % PT, k = i / PT;
    const bool ok = p0 + j < P;
    const long long g = (long long)(p0 + j) * D + k;
    s_p[k * PT + j] = ok ? msc[g] : 0.f;
    s_p[(D + k) * PT + j] = ok ? -0.5f * ivar[g] : 0.f;
  }
  __syncthreads();

  if (tid < kCompute) {
    // ---------------------------------------------------------- products
    const int warp = tid >> 5;
    const int rg = tid >> 4;  // rows 8rg..8rg+7 of a tile (a warp: 16 rows)
    const int pg = tid & 15;  // prototypes 4pg..4pg+3 and HALF+4pg..HALF+4pg+3
    const bool vec = (D & 3) == 0;
    // queue the copies of tile `it` into the staging buffer; rows past the
    // block's last are zero-filled
    auto stage = [&](int it) {
      const int w = vec ? D / 4 : D;  // copies per row
      for (int i = tid; i < RT * w; i += kCompute) {
        const int r = i / w, q = i - r * w;
        const int f = it * RT + r;
        const bool ok = f < nrows;
        const float* src = feat;
        if (ok) {
          const int s = f / HW;
          src += ((long long)(blockIdx.y + s * G) * HW + (f - s * HW)) * D;
        }
        if (vec)
          __pipeline_memcpy_async(s_stage + r * SD + 4 * q, src + 4 * q, 16, ok ? 0 : 16);
        else
          __pipeline_memcpy_async(s_stage + r * SD + q, src + q, 4, ok ? 0 : 4);
      }
      __pipeline_commit();
    };

    if (tiles > 0) stage(0);
    for (int it = 0; it < tiles; ++it) {
      const int rows = min(RT, nrows - it * RT);
      const int buf = it & 1;
      __pipeline_wait_prior(0);
      bar_sync(kBarCompute, kCompute);  // staging landed; s_x is free
      const int d4 = (D + 3) / 4;
      for (int i = tid; i < RT * d4; i += kCompute) {
        const int r = i % RT, k4 = i / RT;
        const float4 v = lds4(s_stage + r * SD + 4 * k4);
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = 4 * k4 + q;
          if (k < D) {
            s_x[k * RT + r] = e[q];
            s_x[(D + k) * RT + r] = e[q] * e[q];
          }
        }
      }
      bar_sync(kBarCompute, kCompute);  // s_x ready, staging free
      if (it + 1 < tiles) stage(it + 1);
      if (it >= 2) bar_sync(kBarEmpty + buf, kThreads);  // tile it - 2 selected

      if (warp * 16 < rows) {
        // four 16-byte shared loads for 64 FMAs, the next step's operands
        // loaded while this step's FMAs issue
        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
        const float* xp = s_x + rg * 8;
        const float* pp = s_p + pg * 4;
        float4 xa = lds4(xp), xb = lds4(xp + 4), pa = lds4(pp), pb = lds4(pp + HALF);
#pragma unroll 2
        for (int k = 0; k < K; ++k) {
          const int kn = min(k + 1, K - 1);
          const float4 nxa = lds4(xp + kn * RT), nxb = lds4(xp + kn * RT + 4);
          const float4 npa = lds4(pp + kn * PT), npb = lds4(pp + kn * PT + HALF);
          const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
          const float pv[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], pv[j], acc[i][j]);
          xa = nxa;
          xb = nxb;
          pa = npa;
          pb = npb;
        }
        float* d = s_d + buf * RT * PT;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float* row = d + (rg * 8 + i) * PT + pg * 4;
          *reinterpret_cast<float4*>(row) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          *reinterpret_cast<float4*>(row + HALF) =
              make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
      }
      __threadfence_block();
      bar_arrive(kBarFull + buf, kThreads);
    }
    return;
  }

  // ------------------------------------------------------------ selection
  // group 0 keeps the lists of the block's even samples, group 1 of its odd
  // ones, so two warps on each scheduler select at once
  const int j = (tid - kCompute) % PT;  // the prototype
  const int group = (tid - kCompute) / PT;
  const bool live = p0 + j < P;
  const float c = live ? cnst[p0 + j] : -CUDART_INF_F;
  float lv[TM];
  int li[TM];
  list_reset(lv, li);
  // a lower bound of the list's T-th value, refreshed once per run of
  // rows: rows at or below it cannot enter the first T slots
  float thr = -CUDART_INF_F;

  for (int it = 0; it < tiles; ++it) {
    const int f0 = it * RT;
    const int rows = min(RT, nrows - f0);
    const int buf = it & 1;
    const float* d = s_d + buf * RT * PT;
    bar_sync(kBarFull + buf, kThreads);  // the tile's products are in d
    // one run of rows per sample the tile holds
    for (int r0 = 0; r0 < rows;) {
      const int s = (f0 + r0) / HW;
      const int nb = s * HW - f0;  // the tile row of the sample's patch 0
      const int r1 = min(rows, nb + HW);
      if ((s & 1) != group) {
        r0 = r1;
        continue;
      }
      // the run's rows above the bound, as a bit mask, then inserted in
      // ascending order; a warp runs until its lanes are done
      static_assert(RT == 64, "the candidate mask is two words");
      unsigned m0 = 0, m1 = 0;
      for (int r = r0; r < r1; ++r) {
        const unsigned bit = (c + d[r * PT + j] > thr) ? 1u << (r & 31) : 0u;
        if (r < 32) m0 |= bit; else m1 |= bit;
      }
      auto pop = [&]() {
        if (m0) {
          const int r = __ffs(m0) - 1;
          m0 &= m0 - 1;
          return r;
        }
        if (m1) {
          const int r = 32 + __ffs(m1) - 1;
          m1 &= m1 - 1;
          return r;
        }
        return -1;
      };
      int r = pop();
      float v = r >= 0 ? c + d[r * PT + j] : -CUDART_INF_F;
      while (__any_sync(0xffffffffu, r >= 0)) {
        const int rn = pop();  // the next candidate's load overlaps this insertion
        const float vn = rn >= 0 ? c + d[rn * PT + j] : -CUDART_INF_F;
        list_insert(lv, li, v, r - nb);
        r = rn;
        v = vn;
      }
      thr = list_tth(lv, T);
      if (r1 == nb + HW) {
        // the sample's last patch: the list is final
        if (live) {
          const long long o = ((long long)(blockIdx.y + s * G) * P + p0 + j) * T;
#pragma unroll
          for (int q = 0; q < TM; ++q) {
            if (q < T) {
              vals[o + q] = lv[q];
              idx[o + q] = li[q];
            }
          }
        }
        list_reset(lv, li);
        thr = -CUDART_INF_F;
      }
      r0 = r1;
    }
    if (it + 2 < tiles) {
      __threadfence_block();
      bar_arrive(kBarEmpty + buf, kThreads);
    }
  }
}

// Dynamic shared memory a launch needs, in bytes.
int smem_bytes(int D) {
  return (2 * D * PT + 2 * D * RT + 2 * RT * PT + RT * staging_stride(D)) * 4;
}

kernel_common::SmemOptIn g_opt_in[5];  // one per list width (20: the flagship T)

template <int TM>
int launch(kernel_common::SmemOptIn& opt_in, const float* feat, const float* msc,
           const float* ivar, const float* cnst, float* vals, int* idx, int B, int HW,
           int P, int D, int T, void* stream) {
  const int smem = smem_bytes(D);
  cudaError_t e = kernel_common::reserve_smem(opt_in, score_pool_fwd_kernel<TM>, smem);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  e = kernel_common::sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  // about one block per SM: the prototype tiles times enough sample groups
  const int ptiles = (P + PT - 1) / PT;
  const int groups = max(1, min(B, sms / ptiles));
  dim3 grid(ptiles, groups);
  score_pool_fwd_kernel<TM><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      feat, msc, ivar, cnst, vals, idx, B, HW, P, D, T);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
int score_pool_fwd(const float* feat, const float* msc, const float* ivar,
                   const float* cnst, float* vals, int* idx, int B, int HW,
                   int P, int D, int T, void* stream) {
  if (T < 1 || T > kMaxT || D > kMaxD) return (int)cudaErrorInvalidValue;
  if (T <= 4) return launch<4>(g_opt_in[0], feat, msc, ivar, cnst, vals, idx, B, HW, P, D, T, stream);
  if (T <= 8) return launch<8>(g_opt_in[1], feat, msc, ivar, cnst, vals, idx, B, HW, P, D, T, stream);
  if (T <= 16) return launch<16>(g_opt_in[2], feat, msc, ivar, cnst, vals, idx, B, HW, P, D, T, stream);
  if (T <= 20) return launch<20>(g_opt_in[3], feat, msc, ivar, cnst, vals, idx, B, HW, P, D, T, stream);
  return launch<32>(g_opt_in[4], feat, msc, ivar, cnst, vals, idx, B, HW, P, D, T, stream);
}

}  // extern "C"
