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
// Bound on the H100: the larger of reading g and idx once (8*B*P*T bytes,
// 25.6 MB at B = 80, P = 2000, T = 20: 0.0077 ms of HBM, 0.0103 ms with
// the features, the constants and the output) and 4*d FLOPs for each live
// (nonzero-g) entry. In training the mining mask leaves 5.5 % of g live.
//
// Design: gather only the live entries, in two launches.
//  1. Compaction, one block per sample. Each warp owns a contiguous range
//     of the sample's [P*T] entries and reads its g and idx coalesced, 8
//     loads a lane in flight. It counts its live entries per patch into a
//     histogram row of its own (shared integer atomics: a count does not
//     depend on their order). Ordered exclusive scans over (patch, warp)
//     give every warp a cursor per patch, and a second walk writes each
//     live entry (p, g) to its patch's list in entry order, after the lanes
//     before it with the same patch: a stable counting sort, so prototypes
//     ascend within a patch. It also writes the work units: each patch is
//     cut into segments of at most S = 64 entries (one unit for an empty
//     patch), so a hub patch (in every prototype's top-T: up to P entries)
//     spreads over many warps.
//  2. Accumulation, about four blocks per SM walking every unit of the
//     batch. A warp owns a unit; its lanes run over d, so each 256-byte
//     constant row is read coalesced (from L2: the constants are 1 MB). It
//     sums its entries in ascending order, loading four rows ahead and the
//     next unit's descriptor while it sums. A patch of one unit is written
//     once, as am - x * as. The segments of a hub patch write partial sums
//     to scratch; the warp that finishes last (an integer counter) adds
//     them in segment order and writes the patch.
// Every sum has a fixed order and no float atomics are used, so two
// launches on the same inputs give bitwise-equal output. The scratch
// (entries, units, counters, partial sums: score_pool_bwd_scratch_bytes) is
// the caller's. What bounds it now: the compaction runs on B SMs only (80
// of 132 at the train step) and walks every entry twice; the accumulation
// waits on L2 for the constant rows (on dense g it reads 512 bytes of them
// per entry, 1.6 GB at B = 80).

#include <cuda_runtime.h>

#include "kernel_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int S = 64;            // entries per unit (segment of a patch)
constexpr int kLoads = 8;        // loads per lane in flight while compacting
constexpr int kMaxWarps1 = 32;   // warps of a compaction block
constexpr int kHistBytes = 200 * 1024;
constexpr int kThreads2 = 256;   // accumulation block
constexpr int kAhead = 4;        // constant rows loaded ahead per lane

// In-place exclusive scan of a[0, n) in shared memory by the whole block,
// in index order; returns the total. `red` holds 32 ints.
__device__ int block_exclusive_scan(int* a, int n, int* red) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5, nw = nt >> 5;
  const int per = (n + nt - 1) / nt;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int x = s;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[w] = x;
  __syncthreads();
  if (w == 0) {
    int v = lane < nw ? red[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += y;
    }
    red[lane] = v;
  }
  __syncthreads();
  int run = x - s + (w > 0 ? red[w - 1] : 0);
  const int total = red[nw - 1];
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kMaxWarps1 * 32)
score_pool_bwd_compact_kernel(const float* __restrict__ g,   // [B, P*T]
                              const int* __restrict__ idx,   // [B, P*T]
                              int2* __restrict__ ent,        // [B, P*T] (p, g bits), per patch
                              int4* __restrict__ units,      // [B, UCAP] (patch, from, to, seg << 16 | segs)
                              int* __restrict__ nunits,      // [B]
                              int* __restrict__ cnt,         // [B, HW] zeroed here
                              int HW, int T, int PTn, int UCAP) {
  extern __shared__ int sm[];
  const int nw = blockDim.x >> 5;
  int* hist = sm;             // [nw][HW]: counts, then cursors
  int* start = hist + nw * HW;  // [HW]
  int* ubase = start + HW;      // [HW]
  int* red = ubase + HW;        // [32]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int b = blockIdx.x;
  const long long base = (long long)b * PTn;
  const int e_lo = (int)((long long)w * PTn / nw);
  const int e_hi = (int)((long long)(w + 1) * PTn / nw);
  for (int i = tid; i < nw * HW; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  // the warp's walk over its entries, 8 loads a lane in flight; every lane
  // calls `visit(e, n, gv, live)`, lanes in entry order
  auto walk = [&](auto visit) {
    for (int e0 = e_lo; e0 < e_hi; e0 += 32 * kLoads) {
      int n[kLoads];
      float gv[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * 32 + lane;
        n[u] = e < e_hi ? __ldg(idx + base + e) : -1;
        gv[u] = e < e_hi ? __ldg(g + base + e) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const bool live = gv[u] != 0.f && n[u] >= 0 && n[u] < HW;
        visit(e0 + u * 32 + lane, n[u], gv[u], live);
      }
    }
  };
  // counts: integer shared atomics, whose sums do not depend on their order
  walk([&](int, int n, float, bool live) {
    if (live) atomicAdd(hist + w * HW + n, 1);
  });
  __syncthreads();
  // per patch: warps' exclusive offsets within the patch, the patch's
  // count and its number of units
  for (int n = tid; n < HW; n += blockDim.x) {
    int s = 0;
    for (int v = 0; v < nw; ++v) {
      const int h = hist[v * HW + n];
      hist[v * HW + n] = s;
      s += h;
    }
    start[n] = s;
    ubase[n] = max(1, (s + S - 1) / S);
  }
  __syncthreads();
  const int live_total = block_exclusive_scan(start, HW, red);
  const int unit_total = block_exclusive_scan(ubase, HW, red);
  for (int n = tid; n < HW; n += blockDim.x) {
    const int lo = start[n], hi = n + 1 < HW ? start[n + 1] : live_total;
    cnt[(long long)b * HW + n] = 0;
    const int segs = max(1, (hi - lo + S - 1) / S);
    for (int s = 0; s < segs; ++s)
      units[(long long)b * UCAP + ubase[n] + s] =
          make_int4(n, lo + s * S, min(hi, lo + (s + 1) * S), (s << 16) | segs);
  }
  if (tid == 0) nunits[b] = unit_total;
  // second walk: scatter in entry order, each entry after the lanes before
  // it in its warp that hold the same patch
  const int Tn = T;
  walk([&](int e, int n, float gv, bool live) {
    const unsigned peers = __match_any_sync(kFull, live ? n : -1);
    if (live) {
      int* cur = hist + w * HW + n;
      const int pos = start[n] + *cur + __popc(peers & ((1u << lane) - 1u));
      ent[base + pos] = make_int2(e / Tn, __float_as_int(gv));
    }
    __syncwarp();
    if (live && lane == __ffs(peers) - 1) hist[w * HW + n] += __popc(peers);
    __syncwarp();
  });
}

template <int DPL>  // feature elements per lane: D <= 32 * DPL (DPL <= 2: D <= 64)
__global__ void __launch_bounds__(kThreads2)
score_pool_bwd_accumulate_kernel(const int2* __restrict__ ent,
                                 const int4* __restrict__ units, const int* __restrict__ nunits,
                                 int* __restrict__ cnt, float* __restrict__ part,
                                 const float* __restrict__ feat,  // [B, HW, D]
                                 const float* __restrict__ msc,   // [P, D]
                                 const float* __restrict__ ivar,  // [P, D]
                                 float* __restrict__ out,         // [B, HW, D]
                                 int B, int HW, int D, int PTn, int UCAP) {
  extern __shared__ int s_first[];  // [B + 1] first unit of each sample, then 32
  int* red = s_first + B + 1;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < B; i += blockDim.x) s_first[i] = nunits[i];
  __syncthreads();
  const int total = block_exclusive_scan(s_first, B, red);
  const int wpb = blockDim.x >> 5;
  // the sample of unit u: s_first[b] <= u < s_first[b + 1]
  auto sample_of = [&](int u) {
    int lo = 0, hi = B;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (s_first[mid] <= u) lo = mid; else hi = mid;
    }
    return lo;
  };
  auto desc = [&](int u, int b) {
    return u < total ? units[(long long)b * UCAP + u - s_first[b]] : make_int4(0, 0, 0, 1);
  };
  const int stride = gridDim.x * wpb;
  int u = blockIdx.x * wpb + (tid >> 5);
  int b = sample_of(u);
  int4 unit = desc(u, b);
  for (; u < total; u += stride) {
    // the next unit's descriptor is loaded while this one is summed
    const int b_next = sample_of(u + stride);
    const int4 next = desc(u + stride, b_next);
    const int lu = u - s_first[b];
    const int n = unit.x, e_start = unit.y, e_end = unit.z;
    const int seg = unit.w >> 16, segs = unit.w & 0xffff;
    const int2* eb = ent + (long long)b * PTn;

    float am[DPL], as[DPL];
#pragma unroll
    for (int t = 0; t < DPL; ++t) am[t] = as[t] = 0.f;
    for (int e0 = e_start; e0 < e_end; e0 += 32) {
      const int m = min(32, e_end - e0);
      const int2 mine = lane < m ? eb[e0 + lane] : make_int2(0, 0);
      for (int j = 0; j < m; j += kAhead) {
        float wq[kAhead], mv[kAhead][DPL], iv[kAhead][DPL];
#pragma unroll
        for (int q = 0; q < kAhead; ++q) {
          const int p = __shfl_sync(kFull, mine.x, (j + q) & 31);
          wq[q] = __int_as_float(__shfl_sync(kFull, mine.y, (j + q) & 31));
#pragma unroll
          for (int t = 0; t < DPL; ++t) {
            const int k = lane + 32 * t;
            const bool ok = j + q < m && k < D;
            mv[q][t] = ok ? __ldg(msc + (long long)p * D + k) : 0.f;
            iv[q][t] = ok ? __ldg(ivar + (long long)p * D + k) : 0.f;
          }
        }
#pragma unroll
        for (int q = 0; q < kAhead; ++q) {
          if (j + q < m) {
#pragma unroll
            for (int t = 0; t < DPL; ++t) {
              am[t] = fmaf(wq[q], mv[q][t], am[t]);
              as[t] = fmaf(wq[q], iv[q][t], as[t]);
            }
          }
        }
      }
    }

    const long long ob = ((long long)b * HW + n) * D;
    if (segs > 1) {
      // a hub patch: publish this segment's sums; the last segment to
      // finish adds all of them in segment order
      float* pp = part + ((long long)b * UCAP + lu) * 2 * D;
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int k = lane + 32 * t;
        if (k < D) {
          pp[k] = am[t];
          pp[D + k] = as[t];
        }
      }
      __threadfence();
      __syncwarp();
      int done = 0;
      if (lane == 0) done = atomicAdd(cnt + (long long)b * HW + n, 1);
      done = __shfl_sync(kFull, done, 0);
      if (done != segs - 1) {
        b = b_next;
        unit = next;
        continue;
      }
      __threadfence();
      const float* p0 = part + ((long long)b * UCAP + lu - seg) * 2 * D;
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int k = lane + 32 * t;
        if (k < D) {
          am[t] = __ldcg(p0 + k);
          as[t] = __ldcg(p0 + D + k);
          for (int s = 1; s < segs; ++s) {
            am[t] += __ldcg(p0 + (long long)s * 2 * D + k);
            as[t] += __ldcg(p0 + (long long)s * 2 * D + D + k);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int k = lane + 32 * t;
      if (k < D) out[ob + k] = am[t] - feat[ob + k] * as[t];
    }
    b = b_next;
    unit = next;
  }
}

// The scratch a launch uses, carved from one buffer: entries, units, unit
// counts, hub counters, partial sums (16-byte aligned each).
struct Scratch {
  int2* ent;
  int4* units;
  int* nunits;
  int* cnt;
  float* part;
  long long bytes;
};

Scratch carve(char* base, int B, int HW, int P, int D, int T) {
  const long long PTn = (long long)P * T;
  const long long ucap = HW + (PTn + S - 1) / S;
  long long at = 0;
  auto take = [&](long long nbytes) {
    char* p = base + at;
    at += (nbytes + 15) & ~15LL;
    return p;
  };
  Scratch s;
  s.ent = reinterpret_cast<int2*>(take(8 * B * PTn));
  s.units = reinterpret_cast<int4*>(take(16 * B * ucap));
  s.nunits = reinterpret_cast<int*>(take(4LL * B));
  s.cnt = reinterpret_cast<int*>(take(4LL * B * HW));
  s.part = reinterpret_cast<float*>(take(4 * B * ucap * 2 * D));
  s.bytes = at;
  return s;
}

kernel_common::SmemOptIn g_opt_in_compact, g_opt_in_acc1, g_opt_in_acc2;

template <int DPL>
cudaError_t launch_accumulate(kernel_common::SmemOptIn& opt_in, const Scratch& s,
                              const float* feat, const float* msc, const float* ivar,
                              float* out, int B, int HW, int D, int PTn, int ucap,
                              cudaStream_t stream) {
  const int smem = (B + 1 + 32) * 4;
  cudaError_t e = kernel_common::reserve_smem(opt_in, score_pool_bwd_accumulate_kernel<DPL>, smem);
  if (e != cudaSuccess) return e;
  int sms = 0;
  e = kernel_common::sm_count(&sms);
  if (e != cudaSuccess) return e;
  score_pool_bwd_accumulate_kernel<DPL><<<4 * sms, kThreads2, smem, stream>>>(
      s.ent, s.units, s.nunits, s.cnt, s.part, feat, msc, ivar, out, B, HW, D, PTn, ucap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch score_pool_bwd needs for these shapes.
long long score_pool_bwd_scratch_bytes(int B, int HW, int P, int D, int T) {
  return carve(nullptr, B, HW, P, D, T).bytes;
}

// Launch on `stream` (two kernels); returns the cudaError_t (0 = queued).
int score_pool_bwd(const float* g, const int* idx, const float* feat,
                   const float* msc, const float* ivar, float* out, void* scratch,
                   int B, int HW, int P, int D, int T, void* stream) {
  if (D > 64 || B < 1) return (int)cudaErrorInvalidValue;
  const Scratch s = carve(static_cast<char*>(scratch), B, HW, P, D, T);
  const int PTn = P * T;
  const int ucap = HW + (PTn + S - 1) / S;
  cudaStream_t st = (cudaStream_t)stream;
  // as many warps as the histogram rows fit in shared memory, up to 32
  const int nw = min(kMaxWarps1, (kHistBytes / 4 - 2 * HW - 32) / HW);
  if (nw < 1) return (int)cudaErrorInvalidValue;
  const int smem1 = (nw * HW + 2 * HW + 32) * 4;
  cudaError_t e = kernel_common::reserve_smem(g_opt_in_compact, score_pool_bwd_compact_kernel, smem1);
  if (e != cudaSuccess) return (int)e;
  score_pool_bwd_compact_kernel<<<B, nw * 32, smem1, st>>>(g, idx, s.ent, s.units, s.nunits, s.cnt,
                                            HW, T, PTn, ucap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (D <= 32)
    e = launch_accumulate<1>(g_opt_in_acc1, s, feat, msc, ivar, out, B, HW, D, PTn, ucap, st);
  else
    e = launch_accumulate<2>(g_opt_in_acc2, s, feat, msc, ivar, out, B, HW, D, PTn, ucap, st);
  return (int)e;
}

}  // extern "C"
