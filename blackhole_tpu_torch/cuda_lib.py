"""Build and load the CUDA geodesic kernel (csrc/) on first use.

nvcc compiles csrc/trace_kernel.cu into a shared library with a plain C
interface under build/blackhole_tpu_torch/ at the root of the checkout,
named by a hash of the sources and flags, so an unchanged tree builds
once.  The library is loaded with ctypes; every pointer and the stream
pass as c_void_p.  Only render.trace_kernel.trace_planes imports this
module, and only for a CUDA tensor, so the CPU path never needs nvcc.
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
SOURCES = (CSRC / "trace_kernel.cu", CSRC / "geodesic_step.cuh")
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
    raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")


def build() -> Path:
    """Compile the kernel library if its hash-named file is missing.

    Returns its path; the compiler's output (ptxas register and spill
    report included) is kept beside it as <name>.log."""
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libbh_trace_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCES[0])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    lib.with_suffix(".log").write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent process never sees half a file
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library of this checkout, built on first call, with
    its C interface declared."""
    lib = ctypes.CDLL(str(build()))
    lib.bh_trace_planes.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.bh_trace_planes.restype = ctypes.c_int
    lib.bh_error_string.argtypes = [ctypes.c_int]
    lib.bh_error_string.restype = ctypes.c_char_p
    return lib


def trace_planes(scal, inp, out, n: int, max_steps: int, disk_on: bool,
                 adaptive: bool, stream: int) -> None:
    """Launch the kernel on `stream` (checked tensors, see
    render.trace_kernel.trace_planes); raise if the launch fails."""
    lib = load()
    rc = lib.bh_trace_planes(
        scal.data_ptr(), inp.data_ptr(), out.data_ptr(), n, int(max_steps),
        int(disk_on), int(adaptive), stream,
    )
    if rc != 0:
        msg = lib.bh_error_string(rc).decode()
        raise RuntimeError(f"geodesic kernel launch failed: {msg} ({rc})")
