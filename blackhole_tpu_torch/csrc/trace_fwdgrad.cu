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
// is idle.  With 21 (1 + N) state slots and the stage derivatives live,
// the per-thread state exceeds the 255-register budget and spills to
// local memory (L1-cached); the design accepts that for a first, simple
// kernel: one thread per ray looping to its own retirement, (planes, n)
// structure of arrays so each plane's loads and stores coalesce, no
// padding.  Per-ray arithmetic does not depend on the thread's position,
// so a depth-sorted batch gives bitwise the same per-ray results.
//
// Built by blackhole_tpu_torch/cuda_lib.py with nvcc into a shared library
// with the plain C interface below, loaded through ctypes.
#include <cuda_runtime.h>

#include "dual.cuh"

namespace {

constexpr int kBlock = 128;

template <int N, bool DISK_ON, bool ADAPTIVE, bool TRACK>
__global__ void __launch_bounds__(kBlock)
    fwdgrad_kernel(const float* __restrict__ scal,
                   const float* __restrict__ dscal,
                   const float* __restrict__ inp,
                   const float* __restrict__ dinp, float* __restrict__ out,
                   long long n, int max_steps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bh::trace_ray_fwdgrad<N, DISK_ON, ADAPTIVE, TRACK>(scal, dscal, inp, dinp,
                                                     out, n, i, max_steps);
}

template <int N>
void launch(const float* scal, const float* dscal, const float* inp,
            const float* dinp, float* out, long long n, int max_steps,
            int disk_on, int adaptive, int track, cudaStream_t stream) {
  const unsigned grid = (unsigned)((n + kBlock - 1) / kBlock);
#define BH_LAUNCH(D, A, T)                                 \
  fwdgrad_kernel<N, D, A, T><<<grid, kBlock, 0, stream>>>( \
      scal, dscal, inp, dinp, out, n, max_steps)
  if (track) {
    if (adaptive)
      BH_LAUNCH(true, true, true);
    else
      BH_LAUNCH(true, false, true);
  } else if (disk_on) {
    if (adaptive)
      BH_LAUNCH(true, true, false);
    else
      BH_LAUNCH(true, false, false);
  } else {
    if (adaptive)
      BH_LAUNCH(false, true, false);
    else
      BH_LAUNCH(false, false, false);
  }
#undef BH_LAUNCH
}

}  // namespace

extern "C" {

// scal (12,), dscal (n_tan, 12), inp (16, n), dinp (n_tan, 16, n) and out
// ((1 + n_tan) * P, n), P = 15 (22 with track), are float32 device
// pointers; n_tan is 1 or 2, and track needs disk_on.  Returns
// cudaGetLastError() after the launch (0 on success).
int bh_trace_planes_fwdgrad(const float* scal, const float* dscal,
                            const float* inp, const float* dinp, float* out,
                            long long n, int n_tan, int max_steps,
                            int disk_on, int adaptive, int track,
                            void* stream) {
  if ((n_tan != 1 && n_tan != 2) || (track && !disk_on))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_tan == 1)
    launch<1>(scal, dscal, inp, dinp, out, n, max_steps, disk_on, adaptive,
              track, st);
  else
    launch<2>(scal, dscal, inp, dinp, out, n, max_steps, disk_on, adaptive,
              track, st);
  return static_cast<int>(cudaGetLastError());
}

const char* bh_fwdgrad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
