"""ctypes bindings to the native host runtime, native/libsmallpt_host.so
(PyTorch port of smallpt_tpu/utils/native.py; the port keeps its own copy,
since importing the JAX package imports JAX).

The library covers host work off the device path: threaded tone mapping
and PPM encoding of large frames, a threaded vertical flip, and an async
frame writer whose C++ consumer thread encodes frame N while the caller
renders N+1 (the reference's render/display producer-consumer split,
smallpt.cpp:895-988, without a window).

It is built from native/smallpt_host.cpp with ``make`` on first use where a
toolchain is present; without it every caller falls back to the numpy
writers of utils/image.py, and SMALLPT_TPU_NO_NATIVE=1 forces that
fallback. Both are host code: neither stands in for a device kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from smallpt_tpu_torch.utils import image as img_io
from smallpt_tpu_torch.utils.metrics import log_json

_LIB = None
_TRIED = False

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_LIB_PATHS = [
    os.path.join(_NATIVE_DIR, "libsmallpt_host.so"),
    os.path.join(os.path.dirname(__file__), "libsmallpt_host.so"),
]


def _try_build() -> None:
    """Build the shared library in the tree if the source and make are
    there; the attempt and its outcome are logged as JSON lines."""
    src = os.path.join(_NATIVE_DIR, "smallpt_host.cpp")
    if not os.path.exists(src):
        return
    log_json("native_build", {"dir": _NATIVE_DIR, "status": "start"})
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, "libsmallpt_host.so"],
                       check=True, capture_output=True, timeout=120)
        log_json("native_build", {"dir": _NATIVE_DIR, "status": "ok"})
    except (OSError, subprocess.SubprocessError) as e:
        log_json("native_build", {"dir": _NATIVE_DIR, "status": "failed",
                                  "error": str(e)[:200]})


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_float_p = ctypes.POINTER(ctypes.c_float)
    c_u8_p = ctypes.POINTER(ctypes.c_uint8)
    lib.spt_version.argtypes = []
    lib.spt_version.restype = ctypes.c_int
    lib.spt_default_threads.argtypes = []
    lib.spt_default_threads.restype = ctypes.c_int
    lib.spt_tonemap.argtypes = [c_float_p, c_u8_p, ctypes.c_longlong,
                                ctypes.c_int]
    lib.spt_tonemap.restype = None
    lib.spt_flip_y.argtypes = [c_float_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int]
    lib.spt_flip_y.restype = None
    lib.spt_write_ppm.argtypes = [ctypes.c_char_p, c_float_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int]
    lib.spt_write_ppm.restype = ctypes.c_int
    lib.spt_frame_writer_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.spt_frame_writer_create.restype = ctypes.c_void_p
    lib.spt_frame_writer_push.argtypes = [ctypes.c_void_p, c_float_p,
                                          ctypes.c_int]
    lib.spt_frame_writer_push.restype = ctypes.c_int
    lib.spt_frame_writer_pending.argtypes = [ctypes.c_void_p]
    lib.spt_frame_writer_pending.restype = ctypes.c_int
    lib.spt_frame_writer_errors.argtypes = [ctypes.c_void_p]
    lib.spt_frame_writer_errors.restype = ctypes.c_int
    lib.spt_frame_writer_destroy.argtypes = [ctypes.c_void_p]
    lib.spt_frame_writer_destroy.restype = None
    return lib


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("SMALLPT_TPU_NO_NATIVE"):
        return None
    if not any(os.path.exists(p) for p in _LIB_PATHS):
        _try_build()
    for p in _LIB_PATHS:
        if os.path.exists(p):
            try:
                _LIB = _bind(ctypes.CDLL(p))
                break
            except (OSError, AttributeError):
                continue
    return _LIB


def available() -> bool:
    return _load() is not None


def _as_float_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _frame(img) -> np.ndarray:
    data = np.ascontiguousarray(img, dtype=np.float32)
    if data.ndim != 3 or data.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {data.shape}")
    return data


def write_ppm(path: str, img: np.ndarray, binary: bool = False) -> None:
    """Threaded tone map and PPM write (ASCII P3 by default, like the
    reference's writeImage). img: (H, W, 3) float32, already flipped by the
    caller."""
    lib = _load()
    data = _frame(img)
    h, w = data.shape[:2]
    rc = lib.spt_write_ppm(path.encode(), _as_float_ptr(data), w, h,
                           int(binary))
    if rc != 0:
        raise IOError(f"spt_write_ppm failed with {rc}")


def tonemap(img: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """Gamma-2.2 8-bit tone map through the threaded native path."""
    lib = _load()
    data = np.ascontiguousarray(img, dtype=np.float32)
    out = np.empty(data.shape, dtype=np.uint8)
    lib.spt_tonemap(_as_float_ptr(data),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    ctypes.c_longlong(data.size), n_threads)
    return out


def flip_y(img: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """Threaded vertical flip of a copy (or of img itself when it is a
    contiguous float32 array); returns the flipped array."""
    lib = _load()
    data = _frame(img)
    h, w = data.shape[:2]
    lib.spt_flip_y(_as_float_ptr(data), w, h, n_threads)
    return data


class FrameWriter:
    """Async frame sink: a native consumer thread encodes and writes frames
    while the caller keeps rendering. push blocks while max_queue frames
    wait (backpressure); close drains the queue and joins the thread."""

    def __init__(self, pattern: str, width: int, height: int,
                 binary: bool = True, max_queue: int = 4):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._shape = (height, width, 3)
        self._handle = lib.spt_frame_writer_create(
            pattern.encode(), width, height, int(binary), max_queue)
        if not self._handle:
            raise RuntimeError("spt_frame_writer_create failed")

    def push(self, img: np.ndarray, frame_idx: int) -> None:
        """Queue a frame (already flipped) for the file pattern % idx."""
        data = np.ascontiguousarray(img, dtype=np.float32)
        if data.shape != self._shape:
            # the native side reads exactly 3 * w * h floats
            raise ValueError(f"frame shape {data.shape} != {self._shape}")
        rc = self._lib.spt_frame_writer_push(self._handle,
                                             _as_float_ptr(data), frame_idx)
        if rc != 0:
            raise IOError(f"spt_frame_writer_push failed with {rc}")

    @property
    def pending(self) -> int:
        return self._lib.spt_frame_writer_pending(self._handle)

    @property
    def errors(self) -> int:
        return self._lib.spt_frame_writer_errors(self._handle)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.spt_frame_writer_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


class FrameSink:
    """Progressive frames to a printf-style pattern (frames/f_%04d.ppm),
    the frame sink of ProgressiveRenderer.run, the CLI's --frames and the
    interactive session: the native async FrameWriter when the library is
    there (binary P6 for a .ppm pattern, P3 otherwise), else a synchronous
    ASCII P3 write through utils/image.py. push takes the image as the
    renderer shows it; the flip to file order happens here."""

    def __init__(self, pattern: str, width: int, height: int):
        os.makedirs(os.path.dirname(pattern) or ".", exist_ok=True)
        self.pattern = pattern
        self._writer = (FrameWriter(pattern, width, height,
                                    binary=pattern.endswith(".ppm"))
                        if available() else None)

    @property
    def native(self) -> bool:
        return self._writer is not None

    @property
    def errors(self) -> int:
        return self._writer.errors if self._writer is not None else 0

    def push(self, img: np.ndarray, frame_idx: int) -> None:
        if self._writer is not None:
            self._writer.push(np.asarray(img)[::-1], frame_idx)
        else:
            img_io.write_ppm(self.pattern % frame_idx, img)

    def close(self) -> None:
        """Drain the queued frames; logs the native writer's failures."""
        if self._writer is not None:
            if self._writer.errors:
                log_json("frame_writer_errors",
                         {"count": self._writer.errors})
            self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
