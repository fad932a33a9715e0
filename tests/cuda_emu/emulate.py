"""Run a kernel source of ``glom_tpu_torch/kernels/csrc/`` on the CPU, for
tests at small shapes.

A CUDA kernel has no interpret mode, and this machine has no ``nvcc``; but
the port's kernels use few CUDA features, and ``include/`` emulates them in C++:
one block at a time, one ``std::thread`` per CUDA thread, ``__syncthreads``
and the warp collectives (``mma.sync``, ``ldmatrix``, shuffles) through
barriers, ``cp.async`` as a plain copy.  :func:`library` rewrites a source
for it (``common.cuh``'s inline asm replaced by ``include/device_instructions.inc``,
each ``<<<...>>>`` launch by ``emu::launch``, the dynamic shared memory by
the emulator's buffer), compiles it with ``g++`` into
``glom_tpu_torch/kernels/build/emu/<name>-<hash>.so`` and loads it with ``ctypes``: the same C entry
points as the card's library, on host pointers.

It checks what a kernel computes -- index arithmetic, fragment layouts,
ragged tiles, the order of a ring's stages -- and nothing about its speed.
The tensor cores' products are emulated on operands cut to tf32 as the
hardware cuts them, summed in double and rounded toward zero as the card
rounds its f32 accumulation (so a long sum kept inside the mma drifts here
as it does there), and results differ from the card's in the last bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict

from glom_tpu_torch.kernels._build import BUILD_DIR, CSRC

EMU = os.path.join(os.path.dirname(os.path.abspath(__file__)), "include")
CXX_FLAGS = ("-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def compiler() -> str:
    """The host C++ compiler, or '' where there is none."""
    return shutil.which("g++") or ""


def _rewrite(name: str, text: str) -> str:
    if name == "common.cuh":
        with open(os.path.join(EMU, "device_instructions.inc")) as f:
            impl = f.read()
        for fn in re.findall(r"void (\w+)\(", impl):
            head = r"(?:template <[^>]*>\n)?__device__ __forceinline__ void %s\(" % fn
            m = (re.search(head + r"[^\n]*\}\n", text)
                 or re.search(head + r".*?\n}\n", text, re.S))
            if m is None:
                raise RuntimeError(f"emulate: common.cuh has no function {fn} to replace")
            text = text[:m.start()] + text[m.end():]
        anchor = "}  // namespace glom"
        text = text.replace(anchor, impl + "\n" + anchor, 1)
    text = re.sub(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\(", r"emu::launch(\2, \1, ", text)
    return text.replace("extern __shared__ float4 smem4[];", "float4* smem4 = emu::smem();")


def library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` compiled against the emulator and loaded; built
    once per content."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        files = {f: open(os.path.join(CSRC, f)).read()
                 for f in sorted(os.listdir(CSRC)) if f.endswith(".cuh") or f == f"{name}.cu"}
        files = {f: _rewrite(f, t) for f, t in files.items()}
        digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
        for f in sorted(files):
            digest.update(f.encode() + files[f].encode())
        for f in sorted(os.listdir(EMU)):
            with open(os.path.join(EMU, f), "rb") as fh:
                digest.update(fh.read())
        key = f"{name}-{digest.hexdigest()[:16]}"
        out = os.path.join(BUILD_DIR, "emu")
        so = os.path.join(out, key + ".so")
        if not os.path.exists(so):
            cxx = compiler()
            if not cxx:
                raise RuntimeError("emulate: no g++ on this machine")
            src = os.path.join(out, key)
            os.makedirs(src, exist_ok=True)
            for f, t in files.items():
                with open(os.path.join(src, f), "w") as fh:
                    fh.write(t)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, "-I", EMU, "-I", src, "-x", "c++", os.path.join(src, f"{name}.cu"),
                 "-o", tmp], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"emulate: g++ failed for {name}.cu:\n{proc.stderr[-4000:]}")
            os.replace(tmp, so)
        lib = _libs[name] = ctypes.CDLL(so)
        return lib


def function(name: str, symbol: str, argtypes):
    """The emulated C function ``symbol`` of ``csrc/<name>.cu``."""
    fn = getattr(library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
