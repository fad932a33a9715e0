"""Build the port's CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so csrc/<name>.cu

into ``glom_tpu_torch/kernels/build/`` (listed in ``.gitignore``).  The
library's name carries a hash of the sources and flags, so an edited source
builds anew and an unchanged one is reused.  The first call to
:func:`library` builds every source at once, one ``nvcc`` process each, and
waits for all of them.  A failed build raises with nvcc's stderr; ptxas's
report (registers, shared memory, spills) is kept beside each library as
``<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, str]:
    """``{name: path}`` of every kernel source in ``csrc/``."""
    return {
        f[:-3]: os.path.join(CSRC, f)
        for f in sorted(os.listdir(CSRC)) if f.endswith(".cu")
    }


def _digest(path: str) -> str:
    """Hash of one source, every shared header and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for p in [path] + [os.path.join(CSRC, f) for f in headers]:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def build_all() -> Dict[str, float]:
    """Build every source whose library is missing, all in parallel, and
    return ``{name: seconds}`` for the ones built.  Raises ``RuntimeError``
    with nvcc's stderr if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = {}
    for name, src in sources().items():
        so = os.path.join(BUILD_DIR, f"{name}-{_digest(src)}.so")
        if not os.path.exists(so):
            todo[name] = (src, so)
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name, (src, so) in todo.items():
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        procs[name] = (proc, t0, tmp, so)
    seconds, errors = {}, []
    for name, (proc, t0, tmp, so) in procs.items():
        out, err = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{err}{out}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        with open(so[:-3] + ".log", "w") as f:
            f.write(err + out)
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src = sources()[name]
            build_all()
            lib = ctypes.CDLL(os.path.join(BUILD_DIR, f"{name}-{_digest(src)}.so"))
            lib.glom_cuda_error_string.argtypes = [ctypes.c_int]
            lib.glom_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The C function ``symbol`` of ``csrc/<name>.cu`` with its ctypes
    signature (by default an ``int`` result: a ``cudaError_t``), built on
    first use.  The library hands out one function object per symbol, so
    setting the same signature again is harmless."""
    fn = getattr(library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


_plans: Dict[tuple, int] = {}


def plan(name: str, symbol: str, device_index: int, *args: int) -> int:
    """The value of the C planning function ``symbol(*args)`` of
    ``csrc/<name>.cu`` (all ``int``s: how many blocks share a tile's work),
    called on the current device, whose index keys the cache beside the
    arguments.  Raises if it returns less than 1: bad arguments or a CUDA
    error."""
    key = (name, symbol, device_index, args)
    value = _plans.get(key)
    if value is None:
        value = function(name, symbol, [ctypes.c_int] * len(args))(*args)
        if value < 1:
            raise RuntimeError(f"{symbol}{args} found no plan (returned {value})")
        _plans[key] = value
    return value


def check(name: str, code: int) -> None:
    """Raise if a launch of ``csrc/<name>.cu``'s kernel returned a CUDA error."""
    if code != 0:
        msg = library(name).glom_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel failed to launch: CUDA error {code} ({msg})")
