#!/usr/bin/env python3
"""Time the designs tried for the E-step kernel side by side on one NVIDIA GPU.

    git show 1b49b64:mgproto_tpu_torch/csrc/em_estep.cu > build/em_estep_per_class.cu
    python3 scripts/em_estep_designs.py --per-class build/em_estep_per_class.cu --timeline

Each design is the kept kernel (mgproto_tpu_torch/csrc/em_estep.cu) with the
text patches below applied, built with the package's nvcc flags into
build/em_estep_designs/. `--per-class` adds the earlier design, one block
per class (its own C interface), from a copy of its source. Every
design but the ablations is held to the plain version (ll atol 1e-4; s, sx
and sxx within 1e-5 of the plain output's largest magnitude) and to
bitwise-equal repeats; then all are timed at A = 80 and 200 classes of
N = 800 rows, K = 10, d = 64 (chip_smoke.py's device_ms, slabs rotated
through 4x the L2), in the order given and again reversed, all in one
process. `--timeline` also runs a copy of the kept kernel that stamps the
%globaltimer at each phase boundary of every block and reports the medians.
`--dry` only writes the patched sources (no GPU needed). One JSON line a
record; the last is the summary, also written to `--out`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from mgproto_tpu_torch.ops import _build  # noqa: E402

OUT_DIR = os.path.join(ROOT, "build", "em_estep_designs")

# ------------------------------------------------------------------ patches
# (old, new) pairs; each `old` must occur in the kept source.
NO_PDL = [
    ('  // let the combine launch be scheduled now; it waits for this grid\'s end\n'
     '  asm volatile("griddepcontrol.launch_dependents;");\n', ''),
    ('  asm volatile("griddepcontrol.wait;" ::: "memory");  // the partials are written\n', ''),
    ('''  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((elems + kCombineThreads - 1) / kCombineThreads, A);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, em_estep_combine_kernel, (const float*)scratch, ll, s, sx,
                                 sxx, N, D, K, splits_of(N));''',
     '''  em_estep_combine_kernel<<<dim3((elems + kCombineThreads - 1) / kCombineThreads, A),
                            kCombineThreads, 0, st>>>(scratch, ll, s, sx, sxx, N, D, K,
                                                      splits_of(N));
  return (int)cudaGetLastError();'''),
]


def unroll_a(n):
    return [("#pragma unroll 1\n    for (int j = 0; j < DMAX; j += 4) {",
             f"#pragma unroll {n}\n    for (int j = 0; j < DMAX; j += 4) {{")]


def unroll_c(n):
    return [("#pragma unroll 4\n    for (int r = 0; r < R; ++r) {",
             f"#pragma unroll {n}\n    for (int r = 0; r < R; ++r) {{")]


NO_EXP_REUSE = [(
    '''    float z = 0.f;
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
    for (int kk = 0; kk < KH; ++kk) e[kk] = valid ? e[kk] * inv : 0.f;''',
    '''    float z = 0.f;
#pragma unroll
    for (int k = 0; k < KP; ++k) z += expf(wr[k] - m);
    const float inv = 1.f / z;
    const bool valid = n < rows;
    float e[KH];
#pragma unroll
    for (int kk = 0; kk < KH; ++kk) e[kk] = valid ? expf(wr[h * KH + kk] - m) * inv : 0.f;''')]

SIX_BLOCKS = [("__launch_bounds__(kThreads, 8)", "__launch_bounds__(kThreads, 6)")]

# the last block of a class to finish (an int counter, zeroed by a memset
# in the scratch's tail) adds the class's partials; no second launch
LAST_BLOCK = [
    ('''                        float* __restrict__ part,        // [A, splits, P]
                        int N, int D, int K) {''',
     '''                        float* __restrict__ part,        // [A, splits, P]
                        unsigned* __restrict__ count,    // [A], zero
                        float* __restrict__ ll, float* __restrict__ s,
                        float* __restrict__ sx, float* __restrict__ sxx,
                        int N, int D, int K) {'''),
    ('''      if (k0 + 1 < K) pp[2 * K * D + k0 + 1] = s1;
    }
  }
}
''', '''      if (k0 + 1 < K) pp[2 * K * D + k0 + 1] = s1;
    }
  }
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&count[a], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  const int kd = K * D, p = partial_floats(D, K), splits = gridDim.x;
  const float* pa = part + (long long)a * splits * p;
  for (int e = tid; e <= 2 * kd + K; e += kThreads) {
    float v = 0.f;
#pragma unroll 4
    for (int i = 0; i < splits; ++i) v += __ldcg(pa + (long long)i * p + e);
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
}
'''),
    ('''                           const float* cnst, float* part, int A, int N, int D,
                           int K, cudaStream_t stream) {''',
     '''                           const float* cnst, float* part, int A, int N, int D,
                           int K, cudaStream_t stream, float* ll, float* s, float* sx,
                           float* sxx) {'''),
    ('''  em_estep_partial_kernel<KP><<<dim3(splits_of(N), A), kThreads, 0, stream>>>(
      x, msc, ivar, cnst, part, N, D, K);''',
     '''  unsigned* count = (unsigned*)(part + (long long)A * splits_of(N) * partial_floats(D, K));
  const cudaError_t m = cudaMemsetAsync(count, 0, 4 * A, stream);
  if (m != cudaSuccess) return m;
  em_estep_partial_kernel<KP><<<dim3(splits_of(N), A), kThreads, 0, stream>>>(
      x, msc, ivar, cnst, part, count, ll, s, sx, sxx, N, D, K);'''),
    ("  return 4LL * A * splits_of(N) * partial_floats(D, K);",
     "  return 4LL * A * splits_of(N) * partial_floats(D, K) + 4LL * A;"),
    ("launch_partial<KP>(x, msc, ivar, cnst, scratch, A, N, D, K, st); break;",
     "launch_partial<KP>(x, msc, ivar, cnst, scratch, A, N, D, K, st, ll, s, sx, sxx); break;"),
    ("  const int elems = 2 * K * D + K + 1;\n",
     "  return 0;  // the partial kernel combined\n  const int elems = 2 * K * D + K + 1;\n"),
]

# the combine reads and adds float4s
FLOAT4_COMBINE = [
    ('''  const int e = blockIdx.x * kCombineThreads + threadIdx.x;
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
  }''', '''  const int e = 4 * (blockIdx.x * kCombineThreads + threadIdx.x);
  const int kd = K * D;
  if (e > 2 * kd + K) return;
  const int p = partial_floats(D, K);
  const float* pa = part + (long long)a * splits * p + e;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int i = 0; i < splits; ++i) {
    const float4 t = *reinterpret_cast<const float4*>(pa + (long long)i * p);
    v.x += t.x;
    v.y += t.y;
    v.z += t.z;
    v.w += t.w;
  }
  if (e < kd) {
    *reinterpret_cast<float4*>(sx + (long long)a * kd + e) = v;
  } else if (e < 2 * kd) {
    *reinterpret_cast<float4*>(sxx + (long long)a * kd + e - kd) = v;
  } else {
    const float vs[4] = {v.x, v.y, v.z, v.w};
    for (int i = 0; i < 4; ++i) {
      const int f = e + i - 2 * kd;
      if (f < K) s[(long long)a * K + f] = vs[i];
      else if (f == K) ll[a] = vs[i] / (float)N;
    }
  }'''),
    ("  const int elems = 2 * K * D + K + 1;\n",
     "  const int elems = partial_floats(D, K) / 4;  // float4 groups\n"),
]

_STAGE_ONE = '''  for (int i = tid; i < R * (DMAX / 4); i += kThreads) {
    const int n = i / (DMAX / 4), q = i % (DMAX / 4);
    float* dst = &sm.x[n][4 * q];
    if (n < rows && q < d4) {
      __pipeline_memcpy_async(dst, xa + (long long)n * D + 4 * q, 16);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __pipeline_commit();'''
_STAGE_HALF = '''  auto stage_half = [&](int half) {
    for (int i = tid; i < (R / 2) * (DMAX / 4); i += kThreads) {
      const int n = half * (R / 2) + i / (DMAX / 4), q = i % (DMAX / 4);
      float* dst = &sm.x[n][4 * q];
      if (n < rows && q < d4) {
        __pipeline_memcpy_async(dst, xa + (long long)n * D + 4 * q, 16);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    __pipeline_commit();
  };
  stage_half(0);'''
_PHASE_A_ONE = '''  __pipeline_wait_prior(0);
  __syncthreads();

  const int n = tid % R, h = tid / R;  // phases A and B: a row, a half of KP
  // A. weighted log-densities of row n, components [h*KH, h*KH + KH)
  {
    float acc[KH];
#pragma unroll
    for (int kk = 0; kk < KH; ++kk) acc[kk] = 0.f;
    const float* xr = sm.x[n];
#pragma unroll 1
    for (int j = 0; j < DMAX; j += 4) {'''
_PHASE_A_TAIL = '''#pragma unroll
    for (int kk = 0; kk < KH; ++kk) sm.w[n][h * KH + kk] = sm.c[h * KH + kk] + acc[kk];
  }
  __syncthreads();
'''


def _halves(eager):
    """Rows 0-31 and 32-63 staged as two groups; the log-densities of each
    half start as soon as it lands, a warp taking 16 rows and half of KP, a
    lane pair splitting a row's columns (even and odd float4s, one shuffle
    to add). `eager` issues both groups at once; otherwise the second is
    issued once the first has landed."""
    second = "" if eager else "        stage_half(1);\n"
    return [
        ("constexpr int XS = DMAX + 4;", "constexpr int XS = DMAX + 8;"),
        (_STAGE_ONE, _STAGE_HALF + ("\n  stage_half(1);" if eager else "")),
        (_PHASE_A_ONE, '''  {
    const int warp = tid / 32, lane = tid % 32;
    const int h = warp >> 1, jh = lane & 1;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      if (half == 0) {
        __pipeline_wait_prior(WAIT_GROUPS);
        __syncthreads();
SECOND_GROUP      } else {
        __pipeline_wait_prior(0);
        __syncthreads();
      }
      const int n = half * (R / 2) + (warp & 1) * 16 + (lane >> 1);
      float acc[KH];
#pragma unroll
      for (int kk = 0; kk < KH; ++kk) acc[kk] = 0.f;
      const float* xr = sm.x[n];
#pragma unroll 1
      for (int j = 4 * jh; j < DMAX; j += 8) {'''.replace("WAIT_GROUPS", "1" if eager else "0")
         .replace("SECOND_GROUP", second)),
        (_PHASE_A_TAIL, '''#pragma unroll
      for (int kk = 0; kk < KH; ++kk) {
        const float t = acc[kk] + __shfl_xor_sync(0xffffffffu, acc[kk], 1);
        if ((kk & 1) == jh) sm.w[n][h * KH + kk] = sm.c[h * KH + kk] + t;
      }
    }
  }
  __syncthreads();
  const int n = tid % R, h = tid / R;  // phase B: a row, a half of KP
'''),
    ]


# the log-densities by 64 threads, each one half of KP for two rows (n and
# n + 32): a broadcast load of the constants feeds two rows' FMAs
_PHASE_A_BODY = """  // A. weighted log-densities of row n, components [h*KH, h*KH + KH)
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
"""
TWO_ROWS = [(_PHASE_A_BODY, """  if (tid < 64) {
    const int r0 = tid % 32, ha = tid / 32;
    float acc0[KH], acc1[KH];
#pragma unroll
    for (int kk = 0; kk < KH; ++kk) acc0[kk] = acc1[kk] = 0.f;
#pragma unroll 1
    for (int j = 0; j < DMAX; j += 4) {
      const float4 u = *reinterpret_cast<const float4*>(&sm.x[r0][j]);
      const float4 v = *reinterpret_cast<const float4*>(&sm.x[r0 + 32][j]);
      const float4 u2 = make_float4(u.x * u.x, u.y * u.y, u.z * u.z, u.w * u.w);
      const float4 v2 = make_float4(v.x * v.x, v.y * v.y, v.z * v.z, v.w * v.w);
#pragma unroll
      for (int kk = 0; kk < KH; ++kk) {
        const float4 m = *reinterpret_cast<const float4*>(&sm.msc[ha * KH + kk][j]);
        const float4 q = *reinterpret_cast<const float4*>(&sm.ivh[ha * KH + kk][j]);
        float t = acc0[kk], w = acc1[kk];
        t = fmaf(u.x, m.x, t);
        w = fmaf(v.x, m.x, w);
        t = fmaf(u2.x, q.x, t);
        w = fmaf(v2.x, q.x, w);
        t = fmaf(u.y, m.y, t);
        w = fmaf(v.y, m.y, w);
        t = fmaf(u2.y, q.y, t);
        w = fmaf(v2.y, q.y, w);
        t = fmaf(u.z, m.z, t);
        w = fmaf(v.z, m.z, w);
        t = fmaf(u2.z, q.z, t);
        w = fmaf(v2.z, q.z, w);
        t = fmaf(u.w, m.w, t);
        w = fmaf(v.w, m.w, w);
        t = fmaf(u2.w, q.w, t);
        w = fmaf(v2.w, q.w, w);
        acc0[kk] = t;
        acc1[kk] = w;
      }
    }
#pragma unroll
    for (int kk = 0; kk < KH; ++kk) {
      sm.w[r0][ha * KH + kk] = sm.c[ha * KH + kk] + acc0[kk];
      sm.w[r0 + 32][ha * KH + kk] = sm.c[ha * KH + kk] + acc1[kk];
    }
  }
""")]

# ablations: timing only, the outputs are wrong
NO_A = [("    for (int j = 0; j < DMAX; j += 4) {", "    for (int j = 0; j < (N < 0 ? DMAX : 0); j += 4) {")]
NO_C = [("    for (int r = 0; r < R; ++r) {", "    for (int r = 0; r < (N < 0 ? R : 0); ++r) {")]
NO_COMBINE = [('''  const int elems = 2 * K * D + K + 1;
  cudaLaunchConfig_t cfg = {};''', '''  return 0;
  const int elems = 2 * K * D + K + 1;
  cudaLaunchConfig_t cfg = {};''')]

DESIGN1 = NO_PDL + unroll_a(4) + NO_EXP_REUSE
DESIGN2 = NO_PDL + unroll_a(2) + unroll_c(2)
# name -> (patches, checked against plain)
DESIGNS = {
    "kept": ([], True),
    "design1": (DESIGN1, True),
    "design1_6_blocks_an_sm": (DESIGN1 + SIX_BLOCKS, True),
    "design2": (DESIGN2, True),
    "design2_last_block_combines": (DESIGN2 + LAST_BLOCK, True),
    "design2_float4_combine": (DESIGN2 + FLOAT4_COMBINE, True),
    "kept_halves_eager": (_halves(True), True),
    "kept_halves_delayed": (_halves(False), True),
    "kept_phase_a_two_rows": (TWO_ROWS, True),
    "ablation_no_phase_a": (NO_A, False),
    "ablation_no_phase_c": (NO_C, False),
    "ablation_no_phase_a_c": (NO_A + NO_C, False),
    "ablation_no_combine": (NO_COMBINE, False),
}

# %globaltimer at each phase boundary of every block of the kept kernel
TIMELINE = [
    ('namespace {\n\nconstexpr int kThreads', '''__device__ unsigned long long g_ts[8192 * 5];
__device__ unsigned long long g_cts[8192 * 2];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

namespace {

constexpr int kThreads'''),
    ('''  const int d4 = D / 4;
''', '''  const int d4 = D / 4;
  unsigned long long* ts = g_ts + 5 * ((blockIdx.y * gridDim.x + blockIdx.x) & 8191);
  if (tid == 0) ts[0] = gtime();
'''),
    ('''  __pipeline_wait_prior(0);
  __syncthreads();
''', '''  __pipeline_wait_prior(0);
  __syncthreads();
  if (tid == 0) ts[1] = gtime();
'''),
    ('''  __syncthreads();
  // B. stable softmax''', '''  __syncthreads();
  if (tid == 0) ts[2] = gtime();
  // B. stable softmax'''),
    ('''  float* pp = part +''', '''  if (tid == 0) ts[3] = gtime();
  float* pp = part +'''),
    ('''      if (k0 + 1 < K) pp[2 * K * D + k0 + 1] = s1;
    }
  }
}''', '''      if (k0 + 1 < K) pp[2 * K * D + k0 + 1] = s1;
    }
  }
  __syncthreads();
  if (tid == 0) ts[4] = gtime();
}'''),
    ('''  const int a = blockIdx.y;
  const int e = blockIdx.x * kCombineThreads + threadIdx.x;''', '''  const int a = blockIdx.y;
  const int cb = (blockIdx.y * gridDim.x + blockIdx.x) & 8191;
  if (threadIdx.x == 0) g_cts[2 * cb] = gtime();
  const int e = blockIdx.x * kCombineThreads + threadIdx.x;'''),
    ('''  } else {
    ll[a] = v / (float)N;
  }
}''', '''  } else {
    ll[a] = v / (float)N;
  }
  if (threadIdx.x == 0) g_cts[2 * cb + 1] = gtime();
}'''),
    ('extern "C" {\n', '''extern "C" {

int em_estep_timeline(unsigned long long* blocks, unsigned long long* combine) {
  const cudaError_t e = cudaMemcpyFromSymbol(blocks, g_ts, sizeof(g_ts));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(combine, g_cts, sizeof(g_cts));
}
'''),
]


def patched(src, patches, name):
    for old, new in patches:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: a patch does not apply once to the kept source:\n{old[:200]}")
        src = src.replace(old, new)
    return src


def build_all(sources):
    """Compile every source, one nvcc each, all at once. Returns name ->
    (library path, compiler log)."""
    procs = {}
    for name, src in sources.items():
        path = os.path.join(OUT_DIR, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(OUT_DIR, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        out[name] = (lib, log)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--per-class", help="a copy of the one-block-per-class csrc/em_estep.cu")
    ap.add_argument("--designs", default=",".join(DESIGNS), help="comma-separated names")
    ap.add_argument("--timeline", action="store_true")
    ap.add_argument("--dry", action="store_true", help="write the patched sources only")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "summary.json"))
    args = ap.parse_args()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(_build.CSRC, "em_estep.cu")) as f:
        kept = f.read()
    names = [n for n in args.designs.split(",") if n]
    sources = {n: patched(kept, DESIGNS[n][0], n) for n in names}
    if args.timeline:
        sources["timeline"] = patched(kept, TIMELINE, "timeline")
    if args.dry:
        for n, src in sources.items():
            with open(os.path.join(OUT_DIR, f"{n}.cu"), "w") as f:
                f.write(src)
        print(json.dumps({"dry": sorted(sources)}))
        return 0

    import numpy as np
    import torch

    import chip_smoke as cs
    from mgproto_tpu_torch.numerics import apply_numerics_policy
    from mgproto_tpu_torch.ops.em_kernels import _prepare, em_estep_stats_plain

    if not torch.cuda.is_available():
        print("em_estep_designs: no CUDA device", file=sys.stderr)
        return 2
    apply_numerics_policy()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    f32 = dict(dtype=torch.float32, device="cuda")

    def new_api(lib):
        lib.em_estep.argtypes = [ptr] * 9 + [i32] * 4 + [ptr]
        lib.em_estep_scratch_bytes.argtypes = [i32] * 4
        lib.em_estep_scratch_bytes.restype = ctypes.c_longlong

        def run(x, msc, ivar, const):
            a, n, d = x.shape
            k = msc.shape[1]
            out = [torch.empty(a, **f32), torch.empty(a, k, **f32),
                   torch.empty(a, k, d, **f32), torch.empty(a, k, d, **f32)]
            scratch = torch.empty(lib.em_estep_scratch_bytes(a, n, d, k) // 4, **f32)
            code = lib.em_estep(*(t.data_ptr() for t in (x, msc, ivar, const, *out, scratch)),
                                a, n, d, k, stream())
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")
            return out
        return run

    def per_class_api(lib):
        lib.em_estep.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]

        def run(x, msc, ivar, const):
            a, n, d = x.shape
            k = msc.shape[1]
            out = [torch.empty(a, **f32), torch.empty(a, k, **f32),
                   torch.empty(a, k, d, **f32), torch.empty(a, k, d, **f32)]
            code = lib.em_estep(*(t.data_ptr() for t in (x, msc, ivar, const, *out)),
                                a, n, d, k, stream())
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")
            return out
        return run

    if args.per_class:
        with open(args.per_class) as f:
            sources["per_class"] = f.read()
    built = build_all(sources)
    impls, checked, registers = {}, {}, {}
    for n in names:
        lib, log = built[n]
        impls[n], checked[n] = new_api(ctypes.CDLL(lib)), DESIGNS[n][1]
        lines = log.splitlines()
        at = [i for i, ln in enumerate(lines) if "partial_kernelILi10E" in ln]
        registers[n] = [ln.strip() for ln in lines[at[0] + 1:at[0] + 3]] if at else []
    if args.per_class:
        impls["per_class"], checked["per_class"] = (
            per_class_api(ctypes.CDLL(built["per_class"][0])), True)

    def inputs(a, seed):
        g = torch.Generator().manual_seed(seed)
        x = torch.nn.functional.normalize(torch.randn(a, 800, 64, generator=g), dim=-1).cuda()
        means = torch.nn.functional.normalize(torch.rand(a, 10, 64, generator=g), dim=-1).cuda()
        sigmas = (0.3 + 0.2 * torch.rand(a, 10, 64, generator=g)).cuda()
        priors = torch.softmax(torch.randn(a, 10, generator=g), -1).cuda()
        consts = [t.contiguous() for t in _prepare(means, sigmas, priors, 1e-10)]
        return x, (means, sigmas, priors), consts

    ok = True
    for a in (80, 200):
        x, params, consts = inputs(a, a)
        want = em_estep_stats_plain(x, *params)
        for n, run in impls.items():
            if not checked[n]:
                continue
            got, again = run(x, *consts), run(x, *consts)
            torch.cuda.synchronize()
            ll_err = (got[0] - want[0]).abs().max().item()
            rel = [((o - r).abs().max() / r.abs().max()).item() for o, r in zip(got[1:], want[1:])]
            good = (ll_err <= 1e-4 and max(rel) <= 1e-5
                    and all(torch.equal(p, q) for p, q in zip(got, again)))
            ok &= good
            print(json.dumps({"design": n, "A": a, "ll_err": ll_err, "rel_err_s_sx_sxx": rel,
                              "ok": good}), flush=True)

    times = {}
    for a in (80, 200):
        x, _, consts = inputs(a, a + 1)
        ring, copies = cs.ring_of((x,), 4.0 * x.numel())
        order = list(impls) + list(reversed(impls))
        for n in order:
            run = impls[n]
            ms = cs.device_ms(lambda: run(next(ring)[0], *consts))
            times.setdefault(n, {}).setdefault(f"A={a}", []).append(ms)

    timeline = None
    if args.timeline:
        tl = ctypes.CDLL(built["timeline"][0])
        run = new_api(tl)
        tl.em_estep_timeline.argtypes = [ptr, ptr]
        timeline = {}
        for a in (80, 200):
            x, _, consts = inputs(a, a + 2)
            ring, _ = cs.ring_of((x,), 4.0 * x.numel())
            for _ in range(6):
                run(next(ring)[0], *consts)
            torch.cuda.synchronize()
            blocks = (ctypes.c_ulonglong * (8192 * 5))()
            comb = (ctypes.c_ulonglong * (8192 * 2))()
            if tl.em_estep_timeline(blocks, comb):
                raise RuntimeError("timeline read failed")
            nb = 13 * a
            t = np.frombuffer(blocks, dtype=np.uint64).reshape(-1, 5)[:nb].astype(np.int64)
            c = np.frombuffer(comb, dtype=np.uint64).reshape(-1, 2)[:6 * a].astype(np.int64)
            t0 = t[:, 0].min()
            us = lambda v: float(v) / 1e3  # noqa: E731
            timeline[f"A={a}"] = {
                "phase_us_median": {p: us(np.median(t[:, i + 1] - t[:, i])) for i, p in
                                    enumerate(("stage", "A", "B", "C_and_write"))},
                "block_us_median": us(np.median(t[:, 4] - t[:, 0])),
                "block_start_us_pcts_0_50_100": [us(np.percentile(t[:, 0] - t0, p)) for p in (0, 50, 100)],
                "block_end_us_pcts_0_50_100": [us(np.percentile(t[:, 4] - t0, p)) for p in (0, 50, 100)],
                "combine_start_end_us": [us(c[:, 0].min() - t0), us(c[:, 1].max() - t0)],
            }
    summary = {"card": card, "ok": ok, "ms": times, "timeline": timeline, "ptxas_k10": registers}
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
