"""ctypes binding of the native async frame writer (native/frameio.cpp).

The caller renders the next frame while the native thread encodes and
writes the previous one, behind a bounded queue that blocks when full.
PyTorch counterpart of blackhole_tpu.viz.native_io, with its own
binding of the same C++ source.  This is host I/O: frames come in as
host arrays (call .cpu() on a tensor first).  Without the shared
library (no compiler or no zlib headers on the host) the writer falls
back to the pure-Python encoder (viz.io), as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
_NATIVE_DIR = os.path.join(_ROOT, "native")
_BUILD_DIR = os.path.join(_ROOT, "build")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libframeio.so")
_lib = None


def _build() -> None:
    """Build native/libframeio.so with native/Makefile.  make runs in a
    private directory under build/ and the library moves into place with one rename,
    so a process that loads it meanwhile never sees half a file."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="frameio-", dir=_BUILD_DIR)
    try:
        subprocess.run(
            ["make", "-s", "-C", work,
             "-f", os.path.join(_NATIVE_DIR, "Makefile"),
             f"VPATH={_NATIVE_DIR}"],
            check=True, capture_output=True,
        )
        os.replace(os.path.join(work, "libframeio.so"), _LIB_PATH)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _load(build: bool = True):
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and build:
        try:
            _build()
        except (OSError, subprocess.CalledProcessError):
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.fio_create.restype = ctypes.c_void_p
    lib.fio_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fio_submit.restype = ctypes.c_int
    lib.fio_submit.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_char_p,
    ]
    lib.fio_pending.restype = ctypes.c_int
    lib.fio_pending.argtypes = [ctypes.c_void_p]
    lib.fio_flush.restype = None
    lib.fio_flush.argtypes = [ctypes.c_void_p]
    lib.fio_frames_written.restype = ctypes.c_int
    lib.fio_frames_written.argtypes = [ctypes.c_void_p]
    lib.fio_errors.restype = ctypes.c_int
    lib.fio_errors.argtypes = [ctypes.c_void_p]
    lib.fio_destroy.restype = None
    lib.fio_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    """True when the native library is built (or builds now)."""
    return _load() is not None


class AsyncFrameWriter:
    """Bounded-queue background frame writer.

    with AsyncFrameWriter(w, h) as fw:
        for frame in frames:          # float [0,1] (H, W, 3) host array
            fw.submit(frame, path)    # returns once queued (bounded)

    Without the library each frame is written by viz.io on the caller's
    thread."""

    def __init__(self, width: int, height: int, capacity: int = 3):
        self.width = width
        self.height = height
        self._lib = _load()
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.fio_create(width, height, capacity)
        self._fallback_written = 0

    def submit(self, img, path: str) -> None:
        arr = np.ascontiguousarray(
            np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255), np.uint8
        )
        if arr.shape != (self.height, self.width, 3):
            raise ValueError(
                f"frame shape {arr.shape} != "
                f"({self.height}, {self.width}, 3)"
            )
        if self._handle:
            # fio_submit copies the frame before it returns.
            ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
            rc = self._lib.fio_submit(self._handle, ptr, path.encode())
            if rc != 0:
                raise RuntimeError(f"fio_submit failed: {rc}")
        else:  # pure-Python writer
            from blackhole_tpu_torch.viz import io as viz_io

            viz_io.write_image(path, np.asarray(img))
            self._fallback_written += 1

    def flush(self) -> None:
        if self._handle:
            self._lib.fio_flush(self._handle)

    @property
    def frames_written(self) -> int:
        if self._handle:
            return self._lib.fio_frames_written(self._handle)
        return self._fallback_written

    @property
    def errors(self) -> int:
        if self._handle:
            return self._lib.fio_errors(self._handle)
        return 0

    def close(self) -> None:
        if self._handle:
            self.flush()
            self._lib.fio_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
