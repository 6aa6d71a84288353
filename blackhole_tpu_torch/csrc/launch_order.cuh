// Launch order of the kernels that read their scene scalars from a
// __constant__ bank (trace_kernel.cu, trace_fwdgrad.cu).
//
// A library's bank is one per device for the whole process.  Each launch
// copies its scalars into the bank on its own stream right before its
// kernel, so a launch on another stream could overwrite them while an
// earlier kernel still reads them.  The launches of one library therefore
// take turns: each waits on the event that the library's previous launch
// on the device recorded after its kernel (on one stream that wait costs
// nothing: stream order already holds it), and host threads take their
// turns under a mutex.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace bh {

class LaunchOrder {
 public:
  // Runs copy_and_launch(), which enqueues the bank's copies and the
  // kernel on st and returns their first error, after the library's
  // previous launch on the current device, and records its end.  Returns
  // the first CUDA error (cudaSuccess on success).
  template <class F>
  cudaError_t run(cudaStream_t st, F copy_and_launch) {
    std::lock_guard<std::mutex> lock(mu_);
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess) return rc;
    if (dev >= kDevices) return cudaErrorInvalidDevice;
    cudaEvent_t& done = done_[dev];
    if (!done) {
      rc = cudaEventCreateWithFlags(&done, cudaEventDisableTiming);
      if (rc != cudaSuccess) return rc;
    }
    rc = cudaStreamWaitEvent(st, done, 0);
    if (rc == cudaSuccess) rc = copy_and_launch();
    if (rc == cudaSuccess) rc = cudaEventRecord(done, st);
    return rc;
  }

 private:
  static constexpr int kDevices = 64;
  std::mutex mu_;
  cudaEvent_t done_[kDevices] = {};  // created on a device's first launch
};

}  // namespace bh
