// Index helpers shared by the kernels' headers (update_matrices.cuh,
// polyexp.cuh, window_solve.cuh), and the device guard of every extern "C"
// entry.

#pragma once

#include <cuda_runtime.h>

namespace oft {

// Makes `device` the calling thread's current CUDA device for the scope of
// an entry and gives the caller's back on every return path, so that a
// launch on one card leaves torch.cuda.current_device() (and device="cuda")
// where the caller had it.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      restore_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (restore_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool restore_ = false;
  cudaError_t err_;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Single reflection (REFLECT_101); callers guarantee n >= 2.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

}  // namespace oft
