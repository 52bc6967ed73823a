// ResNet block epilogue: BatchNorm apply + residual add + ReLU, for sm_90a.
//
// Replaces the TPU kernel mgproto_tpu/ops/fused_epilogue.py::_epilogue_kernel
// (pallas_call in _epilogue_call). On [M, C] rows of channels-last
// activations it computes
//     out = max(x * a[c] + b[c] + r, 0)
// with the per-channel constants a = scale * rsqrt(var + eps) and
// b = bias - mean * a folded by the caller in f32. The arithmetic runs in
// f32 whatever the activation type; the result is rounded once, to the
// activation type (f32 or bf16).
//
// Bound on the H100: bytes. Two reads and one write of the activation per
// element, about one FLOP per byte, far below the card's balance point; the
// floor is (2 + 1) * M * C * sizeof(T) over 3.35 TB/s.
//
// Design. One pass, nothing kept: each thread moves 4 consecutive elements
// of a row with one 16-byte (f32) or 8-byte (bf16) load per operand, so a
// warp reads whole 128-byte lines; `a` and `b` (at most 2 * 512 floats) are
// read through the L1 cache. The grid strides over the tensor, so any M
// works without padding. C must be a multiple of 4 and the tensors 16-byte
// aligned (the wrapper checks both).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_common.cuh"

namespace {

struct F32x4 {
  using vec = float4;
  __device__ static void unpack(const vec& v, float* f) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ static vec pack(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

struct Bf16x4 {
  using vec = uint2;  // four bf16
  __device__ static void unpack(const vec& v, float* f) {
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  }
  __device__ static vec pack(const float* f) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
    vec v;
    v.x = *reinterpret_cast<const uint32_t*>(&lo);
    v.y = *reinterpret_cast<const uint32_t*>(&hi);
    return v;
  }
};

template <typename V>
__global__ void bn_epilogue_kernel(const typename V::vec* __restrict__ x,
                                   const typename V::vec* __restrict__ r,
                                   const float* __restrict__ a,
                                   const float* __restrict__ b,
                                   typename V::vec* __restrict__ out,
                                   long long n4, int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const int c0 = (int)((i * 4) % C);
    float xf[4], rf[4], y[4];
    V::unpack(x[i], xf);
    V::unpack(r[i], rf);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      y[j] = fmaxf(fmaf(xf[j], __ldg(a + c0 + j), __ldg(b + c0 + j)) + rf[j],
                   0.f);
    }
    out[i] = V::pack(y);
  }
}

constexpr int kThreads = 256;

template <typename V>
int launch(const void* x, const void* r, const float* a, const float* b,
           void* out, long long n, int C, void* stream) {
  const long long n4 = n / 4;
  long long blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  bn_epilogue_kernel<V><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const typename V::vec*>(x),
      static_cast<const typename V::vec*>(r), a, b,
      static_cast<typename V::vec*>(out), n4, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, r, out: [M, C] activations (n = M * C elements); a, b: [C] f32.
// Returns the cudaError_t of the launch (0 = queued on `stream`).
int bn_epilogue_f32(const float* x, const float* r, const float* a,
                    const float* b, float* out, long long n, int C,
                    void* stream) {
  return launch<F32x4>(x, r, a, b, out, n, C, stream);
}

int bn_epilogue_bf16(const void* x, const void* r, const float* a,
                     const float* b, void* out, long long n, int C,
                     void* stream) {
  return launch<Bf16x4>(x, r, a, b, out, n, C, stream);
}

}  // extern "C"
