// What every kernel library of the port shares: the dynamic shared-memory
// opt-in and the error string the Python side reads (ops/_build.py).
//
// Each source under csrc/ is compiled into a library of its own, so each
// includes this header exactly once and gets its own copy of what is here.

#pragma once

#include <cuda_runtime.h>

namespace kernel_common {

constexpr int kMaxDevices = 64;

// The devices on which a kernel's dynamic shared-memory limit has been
// raised, and to how many bytes. One table per kernel.
struct SmemOptIn {
  int bytes[kMaxDevices] = {};
};

// The opt-in limit of dynamic shared memory is a per-device attribute of a
// kernel: it is raised once per device, and again only for a larger request.
// A request beyond what the card allows fails there, with the error returned.
template <typename Kernel>
cudaError_t reserve_smem(SmemOptIn& opt_in, Kernel kernel, int smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && smem <= opt_in.bytes[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && dev < kMaxDevices) opt_in.bytes[dev] = smem;
  return e;
}

// The number of SMs of the current device, for grids sized to the card.
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace kernel_common

// The message of a cudaError_t a launcher returned.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
