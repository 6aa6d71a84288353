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
// What bounds it on the card: instruction issue and the step's latency,
// not bytes.  A ray reads 16 floats and writes 15 against hundreds of
// steps of ~730 flops (RK4) to ~1430 (RKF45) each, 33 to 53 of them IEEE
// divisions, so device memory is idle.  A 1024x1024 launch runs at ~95%
// of its static issue ceiling (the step loop's SASS instructions for
// every warp's slowest ray, one per scheduler and cycle); the prepasses
// and the 512x512 RKF45 render take 0.9-1.0 of the time their slowest
// warp takes alone, a dependency chain of up to 1,000 steps (PERF.md,
// the `regime:` lines).  The design: one thread per ray with its
// 21-slot state in registers (K1's state also carries its point's
// cartesian position, which the step would otherwise recompute); a step
// that computes the disk crossing point only on a crossing step; the 12
// scene scalars in the constant bank, where the step reads them as
// operands instead of holding them in registers through the loop; inputs
// and outputs are (planes, n) structure-of-arrays so each plane's loads
// and stores coalesce; each thread loops to its own retirement (per-ray
// early exit, where the TPU tile ran to its slowest ray), so a warp's
// cost is its slowest ray; blocks of 32 threads, so a block's registers
// free as soon as its one warp retires (the fastest of 32, 64, 96 and
// 128 at the bench shapes, PERF.md), and a register floor per
// integrator (below); no padding, the grid is ceil(n / block) with a
// bounds guard.  Per-ray arithmetic does not depend on the thread's
// position, so any ray order gives bitwise the same per-ray results.
//
// Built by blackhole_tpu_torch/cuda_lib.py with nvcc into a shared library
// with the plain C interface below, loaded through ctypes.
#include <cuda_runtime.h>

#include "geodesic_step.cuh"
#include "launch_order.cuh"

namespace {

constexpr int kBlock = 32;
// Least resident blocks per SM for __launch_bounds__, by integrator (one
// warp each): RK4 at 24 holds the step to 80 registers and 24 warps per
// SM (without it 93 registers and 20 warps, 98 and 16 with track), with
// 16 bytes of spill (48 with track);
// RKF45 takes no floor (1), at 112-120 registers and 16 warps, since a
// floor of 20 or 24 spills and loses there (PERF.md, the cap sweep).
constexpr int kMinBlocksRk4 = 24;
constexpr int kMinBlocksRkf45 = 1;

// The launch's 12 scene scalars, the same for every thread: read from the
// constant bank where the step uses them rather than held in registers
// through the loop.  bh_trace_planes copies them here from the device,
// on the launch's stream, right before the launch; `order` makes the
// launches take turns on the bank, whatever their streams.
__constant__ float c_scal[bh::N_SCAL];
bh::LaunchOrder order;

template <bool DISK_ON, bool ADAPTIVE, bool TRACK>
__global__ void __launch_bounds__(kBlock,
                                  ADAPTIVE ? kMinBlocksRkf45 : kMinBlocksRk4)
    trace_kernel(const float* __restrict__ inp, float* __restrict__ out,
                 long long n, int max_steps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bh::Scal s = bh::load_scal(c_scal);
  bh::trace_ray<DISK_ON, ADAPTIVE, TRACK>(inp, out, n, i, s, max_steps);
}

// The variant's kernel.
using Kernel = void (*)(const float*, float*, long long, int);
Kernel kernel_of(int disk_on, int adaptive, int track) {
  if (track) {
    if (adaptive) return trace_kernel<true, true, true>;
    return trace_kernel<true, false, true>;
  }
  if (disk_on) {
    if (adaptive) return trace_kernel<true, true, false>;
    return trace_kernel<true, false, false>;
  }
  if (adaptive) return trace_kernel<false, true, false>;
  return trace_kernel<false, false, false>;
}

}  // namespace

extern "C" {

// scal (12,), inp (16, n) and out (15, n; 22 with track) are float32
// device pointers; track needs disk_on.  scal is copied to the constant
// bank on `stream` before the launch, after the previous launch of this
// library on the device.  Returns the first CUDA error of the ordering,
// the copy and the launch (0 on success).
int bh_trace_planes(const float* scal, const float* inp, float* out,
                    long long n, int max_steps, int disk_on, int adaptive,
                    int track, void* stream) {
  if (track && !disk_on) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((n + kBlock - 1) / kBlock);
  return static_cast<int>(order.run(st, [&] {
    const cudaError_t rc = cudaMemcpyToSymbolAsync(
        c_scal, scal, sizeof(c_scal), 0, cudaMemcpyDeviceToDevice, st);
    if (rc != cudaSuccess) return rc;
    kernel_of(disk_on, adaptive, track)<<<grid, kBlock, 0, st>>>(
        inp, out, n, max_steps);
    return cudaGetLastError();
  }));
}

// The variant's block size, resident blocks per SM, registers per thread
// and local memory per thread in bytes, into out[4].  Returns the CUDA
// error code (0 on success).
int bh_trace_attributes(int disk_on, int adaptive, int track, int* out) {
  if (track && !disk_on) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = (const void*)kernel_of(disk_on, adaptive, track);
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

const char* bh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
