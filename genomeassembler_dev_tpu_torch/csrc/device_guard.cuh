// The device a kernel's entry point launches on, for the entry point's scope.
//
// PyTorch reads its current device from the CUDA runtime (the driver's
// current context of the thread, which every runtime in the process shares),
// so an entry point that only set `device` would move the caller's later
// allocations there. The guard makes `device` current and gives the caller
// its own device back on every return.
#pragma once

#include <cuda_runtime.h>

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    status_ = cudaGetDevice(&prev_);
    if (status_ == cudaSuccess && prev_ != device) {
      status_ = cudaSetDevice(device);
      restore_ = status_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (restore_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  // cudaSuccess, or the error that kept `device` from becoming current
  cudaError_t status() const { return status_; }

 private:
  int prev_ = 0;
  bool restore_ = false;
  cudaError_t status_ = cudaSuccess;
};
