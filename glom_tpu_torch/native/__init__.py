"""ctypes bindings for the native batch-assembly core (``batcher.cpp``), the
port's copy of ``glom_tpu/native/``.

``batcher.cpp`` is ``glom_tpu``'s source as it is: a multithreaded gather,
dtype conversion and nearest-neighbour resize of a resident dataset into an
NCHW float32 batch, and (when built against libjpeg) a multithreaded JPEG
decoder.  It is a host-side helper, not a GPU kernel.

It is built on first use with ``g++ -O3 -shared`` into ``build/`` beside
this file (ignored by git; rebuilt when the source is newer), first with
``-DGLOM_WITH_JPEG -ljpeg``, then without.  Each build writes a temporary
file of its own and renames it into place, so that processes building at
once (test workers) cannot tear the library.  Every entry point degrades:
:func:`load` gives None where no compiler is available, and the callers in
``glom_tpu_torch.training.data`` then take the NumPy path, which gives the
same bits.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "batcher.cpp")
_LIB = os.path.join(_DIR, "build", "_batcher.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build() -> bool:
    # compile to a per-process temp path and move it into place: a killed g++
    # cannot leave a truncated library, and concurrent builds cannot
    # interleave.  With libjpeg first (the native decode path), then without;
    # glom_has_jpeg() says which one loaded.
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.build.{os.getpid()}"
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", _SRC, "-o", tmp]
    for cmd in (base[:-2] + ["-DGLOM_WITH_JPEG"] + base[-2:] + ["-ljpeg"], base):
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, _LIB)
            return True
        except (OSError, subprocess.SubprocessError):
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
    return False


def load() -> Optional[ctypes.CDLL]:
    """Compile (if stale or missing) and dlopen the native core; None on any
    failure (no compiler, a read-only checkout, ...)."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed:
            return None
        stale = not os.path.exists(_LIB) or (
            os.path.exists(_SRC) and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
        )
        if stale and not _build():
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            # a bad artifact must not survive to poison later loads
            try:
                os.remove(_LIB)
            except OSError:
                pass
            _load_failed = True
            return None
        lp = ctypes.POINTER(ctypes.c_int64)
        fp = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.glom_batch_f32.argtypes = [fp] + [ctypes.c_int64] * 4 + [lp, ctypes.c_int64, ctypes.c_int64, fp]
        lib.glom_batch_f32.restype = None
        lib.glom_batch_u8_nhwc.argtypes = [u8p] + [ctypes.c_int64] * 4 + [lp, ctypes.c_int64, ctypes.c_int64, fp]
        lib.glom_batch_u8_nhwc.restype = None
        lib.glom_has_jpeg.argtypes = []
        lib.glom_has_jpeg.restype = ctypes.c_int
        lib.glom_decode_jpeg_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, fp, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.glom_decode_jpeg_batch.restype = ctypes.c_int64
        _lib = lib
        return _lib


def has_jpeg() -> bool:
    """True when the loaded native core was linked against libjpeg."""
    lib = load()
    return bool(lib is not None and lib.glom_has_jpeg())


def decode_jpeg_batch(paths, size: int, workers: int = 0) -> Optional[np.ndarray]:
    """Multithreaded native JPEG decode of ``paths`` into a float32
    ``(len(paths), 3, size, size)`` NCHW batch in [-1, 1] (shorter-side
    resize and center crop, ``image_stream._decode``'s geometry, with
    bilinear interpolation).  ``workers`` caps the decode threads (0 = every
    core).  None when the native core or its libjpeg link is unavailable
    (the caller falls back to the Python decoders); ValueError on an
    undecodable file."""
    lib = load()
    if lib is None or not lib.glom_has_jpeg():
        return None
    arr = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
    out = np.empty((len(paths), 3, size, size), np.float32)
    err = ctypes.create_string_buffer(512)
    rc = lib.glom_decode_jpeg_batch(
        arr, len(paths), size, workers,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), err, len(err),
    )
    if rc != 0:
        raise ValueError(
            f"native jpeg decode failed for {paths[rc - 1]}: "
            f"{err.value.decode(errors='replace')}"
        )
    return out


def assemble_batch(data: np.ndarray, idx: np.ndarray, size: int) -> Optional[np.ndarray]:
    """Native gather, convert and resize.  ``data`` is float32 NCHW or uint8
    NHWC; returns a float32 ``(len(idx), c, size, size)`` batch, or None when
    the native core is unavailable or the layout is another (the caller
    falls back to NumPy)."""
    lib = load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if len(idx) and (idx.min() < 0 or idx.max() >= data.shape[0]):
        raise IndexError(
            f"batch indices out of range [0, {data.shape[0]}): "
            f"min {idx.min()}, max {idx.max()}"
        )
    idx_p = idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    bs = len(idx)

    # channels-last data would be misread by the NCHW f32 kernel
    is_nhwc = data.ndim == 4 and data.shape[-1] in (1, 3) and data.shape[1] not in (1, 3)

    if data.dtype == np.float32 and data.ndim == 4 and not is_nhwc:
        n, c, h, w = data.shape
        out = np.empty((bs, c, size, size), np.float32)
        lib.glom_batch_f32(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, c, h, w, idx_p, bs, size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out
    if data.dtype == np.uint8 and data.ndim == 4 and is_nhwc:
        n, h, w, c = data.shape
        out = np.empty((bs, c, size, size), np.float32)
        lib.glom_batch_u8_nhwc(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n, h, w, c, idx_p, bs, size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out
    return None
