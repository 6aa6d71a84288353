"""Build and load the CUDA geodesic kernels (csrc/) on first use.

nvcc compiles each kernel source into a shared library with a plain C
interface under build/blackhole_tpu_torch/ at the root of the checkout,
named by a hash of all the sources and the flags, so an unchanged tree
builds once.  build() starts one nvcc per library, all at once.  The
libraries are loaded with ctypes; every pointer and the stream pass as
c_void_p.  Only render.trace_kernel's wrappers import this module, and
only for a CUDA tensor, so the CPU path never needs nvcc.

  trace:   csrc/trace_kernel.cu  (K1, bh_trace_planes)
  fwdgrad: csrc/trace_fwdgrad.cu (K2, bh_trace_planes_fwdgrad)
Each library holds every static variant of its kernel, the tracking ones
(track: the soft boundary's crossing-opacity planes) included, and
reports each variant's block size, resident blocks per SM, registers and
local memory (bh_trace_attributes, bh_fwdgrad_attributes).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARIES = {"trace": CSRC / "trace_kernel.cu",
             "fwdgrad": CSRC / "trace_fwdgrad.cu"}
SOURCES = (*LIBRARIES.values(), CSRC / "geodesic_step.cuh",
           CSRC / "dual.cuh", CSRC / "launch_order.cuh")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "blackhole_tpu_torch"
# No --use_fast_math: sqrtf, division, logf and expf stay IEEE-accurate.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """nvcc from PATH, else from the CUDA toolkit's usual home."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library `name` of this checkout's sources lives."""
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libbh_{name}_{digest.hexdigest()[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every kernel library whose hash-named file is missing,
    one nvcc each, all started together.

    Returns {name: path}; each compiler's output (ptxas register and
    spill report included) is kept beside its library as <name>.log."""
    paths = {name: library_path(name) for name in LIBRARIES}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    for name, lib in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(LIBRARIES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {name} ({proc.returncode}):\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)  # atomic: a concurrent process never sees half
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library `name` of this checkout, built on first call,
    with its C interface declared."""
    lib = ctypes.CDLL(str(build()[name]))
    if name == "trace":
        lib.bh_trace_planes.argtypes = [_P, _P, _P, _LL, _I, _I, _I, _I, _P]
        lib.bh_trace_planes.restype = _I
        lib.bh_trace_attributes.argtypes = [_I, _I, _I, _P]
        lib.bh_trace_attributes.restype = _I
        lib.bh_error_string.argtypes = [_I]
        lib.bh_error_string.restype = ctypes.c_char_p
    else:
        lib.bh_trace_planes_fwdgrad.argtypes = [
            _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P,
        ]
        lib.bh_trace_planes_fwdgrad.restype = _I
        lib.bh_fwdgrad_attributes.argtypes = [_I, _I, _I, _I, _P]
        lib.bh_fwdgrad_attributes.restype = _I
        lib.bh_fwdgrad_error_string.argtypes = [_I]
        lib.bh_fwdgrad_error_string.restype = ctypes.c_char_p
    return lib


def attributes(n_tan: int, disk_on: bool, adaptive: bool,
               track: bool) -> dict:
    """A variant's launch shape on the current device: its block size,
    resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
    and warps per SM, registers per thread and local memory per thread in
    bytes (cudaFuncGetAttributes).  n_tan 0 is K1, else K2."""
    vals = (ctypes.c_int * 4)()
    if n_tan == 0:
        rc = load("trace").bh_trace_attributes(
            int(disk_on), int(adaptive), int(track), ctypes.addressof(vals))
    else:
        rc = load("fwdgrad").bh_fwdgrad_attributes(
            n_tan, int(disk_on), int(adaptive), int(track),
            ctypes.addressof(vals))
    if rc != 0:
        raise RuntimeError(f"kernel attributes failed ({rc})")
    block, blocks, regs, local = vals
    return {"block": block, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * block // 32, "registers": regs,
            "local_bytes": local}


def trace_planes(scal, inp, out, n: int, max_steps: int, disk_on: bool,
                 adaptive: bool, track: bool, stream: int) -> None:
    """Launch K1 (its tracking variant under track) on `stream` (checked
    tensors, see render.trace_kernel.trace_planes); raise if the launch
    fails."""
    lib = load("trace")
    rc = lib.bh_trace_planes(
        scal.data_ptr(), inp.data_ptr(), out.data_ptr(), n, int(max_steps),
        int(disk_on), int(adaptive), int(track), stream,
    )
    if rc != 0:
        msg = lib.bh_error_string(rc).decode()
        raise RuntimeError(f"geodesic kernel launch failed: {msg} ({rc})")


def trace_planes_fwdgrad(scal, dscal, inp, dinp, out, n: int, n_tan: int,
                         max_steps: int, disk_on: bool, adaptive: bool,
                         track: bool, stream: int) -> None:
    """Launch K2 with n_tan (1 or 2) tangents (its tracking variant under
    track) on `stream` (checked contiguous tensors, see
    render.trace_kernel.trace_planes_fwdgrad); raise if the launch
    fails."""
    lib = load("fwdgrad")
    rc = lib.bh_trace_planes_fwdgrad(
        scal.data_ptr(), dscal.data_ptr(), inp.data_ptr(), dinp.data_ptr(),
        out.data_ptr(), n, int(n_tan), int(max_steps), int(disk_on),
        int(adaptive), int(track), stream,
    )
    if rc != 0:
        msg = lib.bh_fwdgrad_error_string(rc).decode()
        raise RuntimeError(f"multi-tangent kernel launch failed: {msg} ({rc})")
