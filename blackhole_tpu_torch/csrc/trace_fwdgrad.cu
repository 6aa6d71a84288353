// Multi-tangent (forward-mode) geodesic kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _make_kernel_jvp_multi of
// blackhole_tpu/render/pallas_kernel.py (launched by _get_multi_core), and
// with one tangent _make_kernel_jvp (launched by _get_core._call_jvp),
// each with its `track` variant (TRACK: the 7 crossing-opacity slots and
// their tangents, disk on only, under the same guard):
// every ray is integrated once, as in the forward kernel, and N tangent
// directions ride beside the primal through the same steps.  The step is
// geodesic_step.cuh's template on Dual<N> (dual.cuh), so each tangent
// follows jax.jvp's rules for the step (the derivative of the RK4 schedule
// and of the RKF45 controller included), its trig tangents are slaved to
// d(theta), d(phi) after the renormalisation, and the per-step tangent
// guard rescales or zeroes each direction.  A retired ray's primal and
// tangents are frozen (the TPU kernel kept stepping retired lanes until
// its tile retired; the guard is the identity below its limit, so this
// changes nothing beyond an ulp).
//
// Instantiated for N = 1 (the single-tangent kernel, K3) and N = 2 (the
// bench's d/d(mass, spin)).  More tangents take several launches of at
// most 2 (render/trace_kernel.py), each recomputing the same primal.
//
// What bounds it on the card: FP32 issue and registers, not bytes.  A ray
// reads 16 (1 + N) floats and writes 15 (1 + N) against hundreds of steps
// of Dual arithmetic (a Dual<N> product is 1 + 3N flops), so device memory
// is idle.  The design: one thread per ray looping to its own retirement,
// (planes, n) structure of arrays so each plane's loads and stores
// coalesce, no padding; and for the instructions and registers that bound
// it:
// - a Dual quotient takes its tangents from one reciprocal of the divisor
//   (dual.cuh): without fast math an IEEE division is about eight
//   instructions (reciprocal estimate, refinement, range check, a branch
//   to the slow path), so jax.jvp's literal rule, 2 + N divisions per
//   quotient, made divisions the largest cost after the FMAs;
// - the per-step tangent guard does no work where it is the identity;
// - the scene scalars and their tangents are in the constant bank, read
//   as operands rather than held in registers through the loop;
// - blocks of 64 threads without a register cap: of 32, 64, 96 and 128
//   threads and of caps at 168 and 128 registers (which spill), the least
//   time summed over each path's RK4 and RKF45 passes at the bench shapes,
//   though RKF45 alone is faster in blocks of 128 (PERF.md).  With
//   21 (1 + N) state slots and the stage derivatives live, N = 2 sits at
//   229-255 registers and its RKF45 track variant spills a little to
//   local memory (L1-cached).
// Per-ray arithmetic does not depend on the thread's position, so a
// depth-sorted batch gives bitwise the same per-ray results.
//
// Built by blackhole_tpu_torch/cuda_lib.py with nvcc into a shared library
// with the plain C interface below, loaded through ctypes.
#include <cuda_runtime.h>

#include "dual.cuh"
#include "launch_order.cuh"

namespace {

constexpr int kBlock = 64;

// The launch's 12 scene scalars and their tangents (N, 12), the same for
// every thread: read from the constant bank where the step uses them
// rather than held in registers through the loop.  bh_trace_planes_fwdgrad
// copies them here from the device, on the launch's stream, right before
// the launch (each pass of more tangents copies its own); `order` makes
// the launches take turns on the bank, whatever their streams.
__constant__ float c_scal[bh::N_SCAL];
__constant__ float c_dscal[2 * bh::N_SCAL];
bh::LaunchOrder order;

template <int N, bool DISK_ON, bool ADAPTIVE, bool TRACK>
__global__ void __launch_bounds__(kBlock)
    fwdgrad_kernel(const float* __restrict__ inp,
                   const float* __restrict__ dinp, float* __restrict__ out,
                   long long n, int max_steps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bh::trace_ray_fwdgrad<N, DISK_ON, ADAPTIVE, TRACK>(c_scal, c_dscal, inp,
                                                     dinp, out, n, i,
                                                     max_steps);
}

// The variant's kernel.
using Kernel = void (*)(const float*, const float*, float*, long long, int);
template <int N>
Kernel kernel_of(int disk_on, int adaptive, int track) {
  if (track) {
    if (adaptive) return fwdgrad_kernel<N, true, true, true>;
    return fwdgrad_kernel<N, true, false, true>;
  }
  if (disk_on) {
    if (adaptive) return fwdgrad_kernel<N, true, true, false>;
    return fwdgrad_kernel<N, true, false, false>;
  }
  if (adaptive) return fwdgrad_kernel<N, false, true, false>;
  return fwdgrad_kernel<N, false, false, false>;
}

}  // namespace

extern "C" {

// scal (12,), dscal (n_tan, 12), inp (16, n), dinp (n_tan, 16, n) and out
// ((1 + n_tan) * P, n), P = 15 (22 with track), are float32 device
// pointers; n_tan is 1 or 2, and track needs disk_on.  scal and dscal are
// copied to the constant bank on `stream` before the launch, after the
// previous launch of this library on the device.  Returns the first CUDA
// error of the ordering, the copies and the launch (0 on success).
int bh_trace_planes_fwdgrad(const float* scal, const float* dscal,
                            const float* inp, const float* dinp, float* out,
                            long long n, int n_tan, int max_steps,
                            int disk_on, int adaptive, int track,
                            void* stream) {
  if ((n_tan != 1 && n_tan != 2) || (track && !disk_on))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((n + kBlock - 1) / kBlock);
  const Kernel kernel = n_tan == 1 ? kernel_of<1>(disk_on, adaptive, track)
                                   : kernel_of<2>(disk_on, adaptive, track);
  return static_cast<int>(order.run(st, [&] {
    cudaError_t rc = cudaMemcpyToSymbolAsync(
        c_scal, scal, sizeof(c_scal), 0, cudaMemcpyDeviceToDevice, st);
    if (rc == cudaSuccess)
      rc = cudaMemcpyToSymbolAsync(c_dscal, dscal,
                                   n_tan * bh::N_SCAL * sizeof(float), 0,
                                   cudaMemcpyDeviceToDevice, st);
    if (rc != cudaSuccess) return rc;
    kernel<<<grid, kBlock, 0, st>>>(inp, dinp, out, n, max_steps);
    return cudaGetLastError();
  }));
}

// The variant's block size, resident blocks per SM, registers per thread
// and local memory per thread in bytes, into out[4].  Returns the CUDA
// error code (0 on success).
int bh_fwdgrad_attributes(int n_tan, int disk_on, int adaptive, int track,
                          int* out) {
  if ((n_tan != 1 && n_tan != 2) || (track && !disk_on))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = (const void*)(n_tan == 1
                                     ? kernel_of<1>(disk_on, adaptive, track)
                                     : kernel_of<2>(disk_on, adaptive, track));
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, fn);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kBlock, 0);
  out[0] = kBlock;
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(rc);
}

const char* bh_fwdgrad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
