// Forward geodesic kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _make_kernel of
// blackhole_tpu/render/pallas_kernel.py (launched by _get_core._call_plain),
// with its static variants disk on/off x RK4/RKF45 x track (track: the
// crossing-opacity planes of the soft boundary, disk on only): every ray
// is integrated from its null initial state to retirement (disk hit,
// capture, path budget, escape) or max_steps, RK4 on the radius schedule
// or RKF45 with a per-ray step and accept/reject, and its hit record is
// written once (15 planes, 22 under track).
//
// What bounds it on the card: FP32 issue and register pressure, not bytes.
// A ray reads 16 floats and writes 15 against hundreds of steps of ~650
// flops (RK4) to ~1000 (RKF45) each, so device memory is idle.  The design:
// one thread per ray with its 21-slot state in registers and the 12 scene
// scalars loaded once per thread; inputs and outputs are (planes, n)
// structure-of-arrays so each plane's loads and stores coalesce; each
// thread loops to its own retirement (per-ray early exit, where the TPU
// tile ran to its slowest ray), so a warp's cost is its slowest ray; no
// padding, the grid is ceil(n / block) with a bounds guard.  Per-ray
// arithmetic does not depend on the thread's position, so any ray order
// gives bitwise the same per-ray results.
//
// Built by blackhole_tpu_torch/cuda_lib.py with nvcc into a shared library
// with the plain C interface below, loaded through ctypes.
#include <cuda_runtime.h>

#include "geodesic_step.cuh"

namespace {

constexpr int kBlock = 128;

template <bool DISK_ON, bool ADAPTIVE, bool TRACK>
__global__ void __launch_bounds__(kBlock)
    trace_kernel(const float* __restrict__ scal, const float* __restrict__ inp,
                 float* __restrict__ out, long long n, int max_steps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bh::Scal s = bh::load_scal(scal);
  bh::trace_ray<DISK_ON, ADAPTIVE, TRACK>(inp, out, n, i, s, max_steps);
}

template <bool DISK_ON, bool ADAPTIVE, bool TRACK = false>
void launch(const float* scal, const float* inp, float* out, long long n,
            int max_steps, cudaStream_t stream) {
  const long long grid = (n + kBlock - 1) / kBlock;
  trace_kernel<DISK_ON, ADAPTIVE, TRACK>
      <<<(unsigned)grid, kBlock, 0, stream>>>(scal, inp, out, n, max_steps);
}

}  // namespace

extern "C" {

// scal (12,), inp (16, n) and out (15, n; 22 with track) are float32
// device pointers; track needs disk_on.  Returns cudaGetLastError() after
// the launch (0 on success).
int bh_trace_planes(const float* scal, const float* inp, float* out,
                    long long n, int max_steps, int disk_on, int adaptive,
                    int track, void* stream) {
  if (track && !disk_on) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (track) {
    if (adaptive)
      launch<true, true, true>(scal, inp, out, n, max_steps, st);
    else
      launch<true, false, true>(scal, inp, out, n, max_steps, st);
  } else if (disk_on) {
    if (adaptive)
      launch<true, true>(scal, inp, out, n, max_steps, st);
    else
      launch<true, false>(scal, inp, out, n, max_steps, st);
  } else {
    if (adaptive)
      launch<false, true>(scal, inp, out, n, max_steps, st);
    else
      launch<false, false>(scal, inp, out, n, max_steps, st);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* bh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
