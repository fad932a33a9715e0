"""The backward kernels past d=512 on the CPU through
``tests/cuda_emu/emulate.py``: K6 as ``csrc/consensus_bwd_wide.cuh``'s design
with K7 on the dS' it stores, and K2 as ``csrc/grouped_ff_bwd.cu``'s
composition on the tiled product with K3 on the hidden it hands over, each
against the wrappers' plain versions on the same inputs; the workspaces'
sizes, the refusals of bad arguments and K2's split planner.

Limits as tests/test_torch_kernel_emulation.py holds the narrow kernels:
||got - want|| <= rtol ||want|| and |got - want| <= rtol (min(1, max|want|)
+ |want|), rtol 1e-4 for float32 and 1e-2 for bfloat16 (one rounding); and
for float32 outputs, normwise within 1e-5 of the plain version.

This module holds the fixtures and helpers the
``tests/test_torch_wide_emulation_*.py`` files share; it is no test file.
"""

import ctypes

import numpy as np
import pytest
import torch

from glom_tpu_torch.kernels import consensus as consensus_kernel
from glom_tpu_torch.kernels import ff as ff_kernel
from glom_tpu_torch.kernels._common import DTYPE_CODES
from glom_tpu_torch.ops import consensus as plain_cons
from glom_tpu_torch.ops import feedforward as plain_ff
from glom_tpu_torch.ops.masks import local_consensus_mask
from tests.cuda_emu import emulate

torch.set_num_threads(1)

RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
F32_NORM_RTOL = 1e-5


def _emulator():
    if not emulate.compiler():
        pytest.skip("needs g++ to compile the kernel source against the emulator")


def _assert_close(got, want, dtype):
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    rtol = RTOL[dtype]
    assert torch.isfinite(g).all()
    err = torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(w)
    assert err <= (F32_NORM_RTOL if dtype == torch.float32 else rtol), err.item()
    bad = diff > rtol * (min(1.0, w.abs().max().item()) + w.abs())
    assert not bad.any(), (diff.max().item(), int(bad.sum()))


# -- K6 and K7 ----------------------------------------------------------------

@pytest.fixture(scope="module")
def k67():
    """K6's and K7's emulated C entries and K6's workspace size."""
    _emulator()
    return (emulate.function("consensus_bwd", "glom_consensus_bwd_dkv",
                             consensus_kernel._DKV_ARGTYPES),
            emulate.function("consensus_bwd", "glom_consensus_bwd_dq",
                             consensus_kernel._DQ_ARGTYPES),
            emulate.function("consensus_bwd", "glom_consensus_bwd_workspace",
                             [ctypes.c_int] * 5, ctypes.c_longlong))


def _k67_inputs(n, L, d, dtype, seed, strided=False, non_local_mask=None, attend_self=False):
    """``(levels, dO, lse, delta)`` for b=1: levels a strided view of a (1,
    n, L+1, d) buffer or contiguous, lse and delta from the plain forward."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    levels = t(1, n, L + 1, d)[..., 1:, :] if strided else t(1, n, L, d)
    g = t(1, n, L, d)
    out, lse = plain_cons.consensus_attention(levels.float(), attend_self=attend_self,
                                              non_local_mask=non_local_mask)
    delta = (g.float() * out).sum(-1).permute(0, 2, 1)[..., None].contiguous()
    return levels, g, lse, delta


def _emulated_k67(k67, levels, g, lse, delta, mask=None, attend_self=False, keep_ds=True):
    """K6's dKV and dS' and K7's dQ on that dS', in buffers (and a
    workspace) that start as NaN, so that an element the kernels skip
    shows."""
    dkv_fn, dq_fn, ws_floats = k67
    b, n, L, d = levels.shape
    code = DTYPE_CODES[levels.dtype]
    ws = torch.full((ws_floats(b, n, L, d, code),), float("nan"))
    dkv = torch.full(levels.shape, float("nan"), dtype=levels.dtype)
    ds = torch.full(consensus_kernel.ds_shape(levels), float("nan"))
    strides = levels.stride()[:3]
    assert dkv_fn(levels.data_ptr(), *strides, g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  None if mask is None else mask.data_ptr(), dkv.data_ptr(),
                  ds.data_ptr() if keep_ds else None, ws.data_ptr(), b, n, L, d, d,
                  int(attend_self), code, None) == 0
    if not keep_ds:
        return dkv
    dq = torch.full(levels.shape, float("nan"), dtype=levels.dtype)
    assert dq_fn(levels.data_ptr(), *strides, ds.data_ptr(), dq.data_ptr(), b, n, L, d, code,
                 None) == 0
    return dkv, ds, dq


# -- K2 and K3 ----------------------------------------------------------------

@pytest.fixture(scope="module")
def k23():
    """K2's and K3's emulated C entries and K2's workspace size."""
    _emulator()
    return (emulate.function("grouped_ff_bwd", "glom_grouped_ff_bwd_dx", ff_kernel._DX_ARGTYPES),
            emulate.function("grouped_ff_bwd", "glom_grouped_ff_bwd_dw", ff_kernel._DW_ARGTYPES),
            emulate.function("grouped_ff_bwd", "glom_grouped_ff_bwd_dx_workspace",
                             [ctypes.c_int] * 7, ctypes.c_longlong))


def _ff_inputs(rows, g, d, h, dtype, strided, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)

    params = {"w1": t(g, d, h, scale=d ** -0.5), "b1": t(g, h, scale=0.1),
              "w2": t(g, h, d, scale=h ** -0.5), "b2": t(g, d, scale=0.1)}
    lwi = t(1, rows, g + 1, d)
    x = lwi[..., :-1, :] if strided else lwi[..., 1:, :].contiguous()
    return params, x, t(1, rows, g, d)


def _emulated_k2(k23, params, x, dout, splits=1, keep_hidden=True):
    """K2's ``(dx, (hid, dh))`` in buffers (and a workspace) that start as
    NaN, so that an element it skips shows; without ``keep_hidden`` only dx,
    the hidden then in the workspace."""
    dx_fn, _, ws_floats = k23
    b, n, g, d = x.shape
    h = params["w1"].shape[-1]
    floats = ws_floats(b * n, g, d, h, splits, DTYPE_CODES[x.dtype], int(keep_hidden))
    ws = torch.full((floats,), float("nan"))
    dx = torch.full(x.shape, float("nan"), dtype=x.dtype)
    hidden = (tuple(torch.full((g, b * n, h), float("nan")) for _ in range(2))
              if keep_hidden else (None, None))
    assert dx_fn(x.data_ptr(), ff_kernel._row_stride(x), x.stride(2), params["w1"].data_ptr(),
                 params["b1"].data_ptr(), params["w2"].data_ptr(), dout.data_ptr(),
                 dx.data_ptr(), ws.data_ptr(), *(None if t is None else t.data_ptr()
                                                 for t in hidden),
                 b * n, g, d, h, splits, DTYPE_CODES[x.dtype], None) == 0
    return (dx, hidden) if keep_hidden else dx


def _emulated_k3(k23, params, x, dout, hidden, splits=1):
    _, dw_fn, _ = k23
    b, n, g, d = x.shape
    h = params["w1"].shape[-1]
    out = [torch.full(params[k].shape, float("nan"), dtype=x.dtype) for k in ("w1", "b1", "w2")]
    ws = torch.full((splits, g * (2 * d * h + h)), float("nan")) if splits > 1 else None
    assert dw_fn(x.data_ptr(), ff_kernel._row_stride(x), x.stride(2), dout.data_ptr(),
                 hidden[0].data_ptr(), hidden[1].data_ptr(), *(t.data_ptr() for t in out),
                 None if ws is None else ws.data_ptr(), b * n, g, d, h, splits,
                 DTYPE_CODES[x.dtype], None) == 0
    return out
