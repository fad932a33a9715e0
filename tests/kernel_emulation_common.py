"""The CUDA sources of K1 (``csrc/grouped_ff.cu``, the grouped-FF forward),
of K2 and K3 (``csrc/grouped_ff_bwd.cu``'s dX and dW kernels), of K6 and K7
(``csrc/consensus_bwd.cu``, the consensus backward, K6 handing K7 its dS')
and of K8 (``csrc/fused_update.cu``, the fused level update, with K4's
consensus kernel inside) run on the CPU through ``tests/cuda_emu/emulate.py``,
against the wrappers' plain versions on the same inputs; and K1, K4, K6 + K7
and K8 on the inputs of a model 16 wide zero-padded to 128 as the wrappers
pad them, called with the true width, against ``glom_tpu``'s kernels in
interpret mode at d=16.

The emulator compiles the kernels' own source with ``g++`` and runs every
CUDA thread of a block as a host thread, the tensor cores' products on
operands cut to tf32 as the card cuts them.  So these tests reach the
kernels' index arithmetic, fragment layouts, ragged row tiles and slabs,
short hidden chunks and ragged output tiles, K1's hidden and the hidden K2
hands K3, K6's partial logits, its dS' and K7's product of it, K8's gather
of both nets' inputs and its epilogue, the splits and
their ordered reductions, and the rings, which the CPU path of the wrappers
(the plain versions) never does.  Limits as on the card (tests/test_torch_kernels.py):
||got - want|| <= rtol ||want|| and |got - want| <= rtol (min(1, max|want|)
+ |want|), rtol 1e-4 for float32 and 1e-2 for bfloat16 (one rounding).

This module holds the emulated kernels' fixtures and the helpers the
``tests/test_torch_emulation_*.py`` files share; it is no test file.
"""

import ctypes

import numpy as np
import pytest
import torch

from glom_tpu_torch.kernels import consensus as consensus_kernel
from glom_tpu_torch.kernels import ff as ff_kernel
from glom_tpu_torch.kernels import fused_update
from glom_tpu_torch.kernels._common import (DTYPE_CODES, pad_ff_params, pad_last,
                                            padded_hidden, padded_width, unpad)
from glom_tpu_torch.ops import consensus as plain_cons
from glom_tpu_torch.ops import feedforward as plain_ff
from glom_tpu_torch.ops.masks import local_consensus_mask
from tests.cuda_emu import emulate

torch.set_num_threads(1)

RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture(scope="module")
def dx_fn():
    if not emulate.compiler():
        pytest.skip("needs g++ to compile the kernel source against the emulator")
    return emulate.function("grouped_ff_bwd", "glom_grouped_ff_bwd_dx", ff_kernel._DX_ARGTYPES)


@pytest.fixture(scope="module")
def dw_fn():
    if not emulate.compiler():
        pytest.skip("needs g++ to compile the kernel source against the emulator")
    return emulate.function("grouped_ff_bwd", "glom_grouped_ff_bwd_dw", ff_kernel._DW_ARGTYPES)


def _inputs(rows, g, d, h, dtype, strided, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)

    params = {"w1": t(g, d, h, scale=d ** -0.5), "b1": t(g, h, scale=0.1),
              "w2": t(g, h, d, scale=h ** -0.5), "b2": t(g, d, scale=0.1)}
    lwi = t(1, rows, g + 1, d)
    x = lwi[..., :-1, :] if strided else lwi[..., 1:, :].contiguous()
    return params, x, t(1, rows, g, d)


def _emulated_dx(fn, params, x, dout, splits=1, keep_hidden=False):
    """K2's dx, or with keep_hidden (dx, (hid, dh)): the hidden it stores,
    in buffers that start as NaN so that an element it skips shows."""
    b, n, g, d = x.shape
    h = params["w1"].shape[-1]
    dx = torch.empty((b, n, g, d), dtype=x.dtype)
    ws = torch.full((splits, b * n * g * d), float("nan")) if splits > 1 else None
    hidden = tuple(torch.full((g, b * n, h), float("nan")) for _ in range(2)) if keep_hidden else None
    code = fn(x.data_ptr(), ff_kernel._row_stride(x), x.stride(2), params["w1"].data_ptr(),
              params["b1"].data_ptr(), params["w2"].data_ptr(), dout.data_ptr(), dx.data_ptr(),
              None if ws is None else ws.data_ptr(),
              *((None, None) if hidden is None else (hidden[0].data_ptr(), hidden[1].data_ptr())),
              b * n, g, d, h, splits, DTYPE_CODES[x.dtype], None)
    assert code == 0, code
    return (dx, hidden) if keep_hidden else dx


def _emulated_dw(fn, params, x, dout, hidden, splits=1):
    b, n, g, d = x.shape
    h = params["w1"].shape[-1]
    out = [torch.empty_like(params[k]) for k in ("w1", "b1", "w2")]
    ws = torch.full((splits, g * (2 * d * h + h)), float("nan")) if splits > 1 else None
    code = fn(x.data_ptr(), ff_kernel._row_stride(x), x.stride(2), dout.data_ptr(),
              hidden[0].data_ptr(), hidden[1].data_ptr(), *(t.data_ptr() for t in out),
              None if ws is None else ws.data_ptr(), b * n, g, d, h, splits,
              DTYPE_CODES[x.dtype], None)
    assert code == 0, code
    return out


def _assert_close(got, want, dtype):
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    rtol = RTOL[dtype]
    assert torch.isfinite(g).all()
    assert torch.linalg.vector_norm(diff) <= rtol * torch.linalg.vector_norm(w)
    bad = diff > rtol * (min(1.0, w.abs().max().item()) + w.abs())
    assert not bad.any(), (diff.max().item(), int(bad.sum()))


def _check_case(dx_fn, rows, g, d, h, dtype, strided, splits=1):
    params, x, dout = _inputs(rows, g, d, h, dtype, strided, seed=rows + d + h)
    got = _emulated_dx(dx_fn, params, x, dout, splits)
    want = plain_ff.grouped_ff_dx({k: v.float() for k, v in params.items()}, x.float(),
                                  dout.float())
    assert got.dtype == dtype
    _assert_close(got, want, dtype)
    assert torch.equal(got, _emulated_dx(dx_fn, params, x, dout, splits))


def _f64_hidden(params, x, dout):
    """H and dH of one group in float64, (rows, h) each."""
    w1, b1, w2 = (params[k][0].double() for k in ("w1", "b1", "w2"))
    pre = x[0, :, 0].double() @ w1 + b1
    cdf = 0.5 * (1.0 + torch.erf(pre * 2.0 ** -0.5))
    pdf = torch.exp(-0.5 * pre * pre) / (2.0 * torch.pi) ** 0.5
    return pre * cdf, (dout[0, :, 0].double() @ w2.T) * (cdf + pre * pdf)


# -- K1: the forward, two tiled products through the hidden ------------------

@pytest.fixture(scope="module")
def k1_fn():
    if not emulate.compiler():
        pytest.skip("needs g++ to compile the kernel source against the emulator")
    return emulate.function("grouped_ff", "glom_grouped_ff", ff_kernel._ARGTYPES)


def _emulated_k1(fn, params, x, splits=1):
    """K1's output and the hidden K1a hands K1b, in buffers (and, with
    splits, a workspace) that start as NaN so that an element it skips
    shows."""
    b, n, g, d = x.shape
    h = params["w1"].shape[-1]
    out = torch.full((b, n, g, d), float("nan"), dtype=x.dtype)
    ws = torch.full((splits, b * n * g * d), float("nan")) if splits > 1 else None
    hid = torch.full((g, b * n, h), float("nan"))
    code = fn(x.data_ptr(), ff_kernel._row_stride(x), x.stride(2), params["w1"].data_ptr(),
              params["b1"].data_ptr(), params["w2"].data_ptr(), params["b2"].data_ptr(),
              out.data_ptr(), None if ws is None else ws.data_ptr(), hid.data_ptr(),
              b * n, g, d, h, splits, DTYPE_CODES[x.dtype], None)
    assert code == 0, code
    return out, hid


def _plain_hidden(params, x):
    """gelu(x W1 + b1) in float32, (g, rows, h): the hidden K1a stores."""
    p32 = {k: v.float() for k, v in params.items()}
    b, n, g, d = x.shape
    pre = torch.einsum("rgd,gdh->grh", x.float().reshape(b * n, g, d), p32["w1"]) + p32["b1"][:, None]
    return torch.nn.functional.gelu(pre)


# -- K8: the fused level update, K1's tiled products and K4's consensus --------

@pytest.fixture(scope="module")
def k8():
    """K8's emulated C entry and its workspace size."""
    if not emulate.compiler():
        pytest.skip("needs g++ to compile the kernel source against the emulator")
    return (emulate.function("fused_update", "glom_fused_update", fused_update._ARGTYPES),
            emulate.function("fused_update", "glom_fused_update_workspace",
                             fused_update._WS_ARGTYPES, ctypes.c_longlong))


def _k8_inputs(b, n, L, d, h, dtype, seed):
    """``(bu, td, levels, bottom, pos)``: levels and the tokens as strided
    views of one (b, n, L+1, d) buffer, as the model's loop holds them."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)

    def net(g):
        return {"w1": t(g, d, h, scale=d ** -0.5), "b1": t(g, h, scale=0.1),
                "w2": t(g, h, d, scale=h ** -0.5), "b2": t(g, d, scale=0.1)}

    bu, td = net(L), net(L - 1)
    lwi = t(b, n, L + 1, d)
    return bu, td, lwi[..., 1:, :], lwi[..., :1, :], t(n, d)[None, :, None, :]


def _emulated_k8(k8, args, mask=None, attend_self=False, splits=1, key_splits=1, width=None):
    """K8's output in a buffer, and with a workspace, that start as NaN, so
    that an element it skips shows; ``width``: the model's (default d)."""
    fn, ws_floats = k8
    bu, td, levels, bottom, pos = args
    b, n, L, d = levels.shape
    h = bu["w1"].shape[-1]
    out = torch.full((b, n, L, d), float("nan"), dtype=levels.dtype)
    floats = ws_floats(b, n, L, d, h, splits, key_splits)
    ws = torch.full((max(floats, 4),), float("nan"))
    names = ("w1", "b1", "w2", "b2")
    code = fn(levels.data_ptr(), levels.stride(0), levels.stride(1), levels.stride(2),
              bottom.data_ptr(), bottom.stride(0), bottom.stride(1), pos.data_ptr(), pos.stride(1),
              *(bu[k].data_ptr() for k in names), *(td[k].data_ptr() for k in names),
              None if mask is None else mask.data_ptr(), out.data_ptr(), ws.data_ptr(), floats,
              b, n, L, d, d if width is None else width, h, int(attend_self), splits, key_splits,
              DTYPE_CODES[levels.dtype], None)
    assert code == 0, code
    return out


def _f64_update(bu, td, levels, bottom, pos):
    """``(the update, its two nets' terms)`` in float64, divided as the
    update divides them: the exact values K8 and its plain version are held
    against."""
    def ff(p, x):
        p = {k: v.double() for k, v in p.items()}
        pre = torch.einsum("bngd,gdh->bngh", x, p["w1"]) + p["b1"]
        return torch.einsum("bngh,ghd->bngd", 0.5 * pre * (1.0 + torch.erf(pre * 2.0 ** -0.5)),
                            p["w2"]) + p["b2"]

    lv = levels.double()
    b, n, L, d = lv.shape
    lwi = torch.cat([bottom.double(), lv], dim=-2)
    terms = ff(bu, lwi[..., :-1, :]) + torch.nn.functional.pad(
        ff(td, lwi[..., 2:, :] + pos.double()), (0, 0, 0, 1))
    keys = lv / lv.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    sim = torch.einsum("bild,bjld->blij", lv, keys) * d ** -0.5
    sim = sim.masked_fill(torch.eye(n, dtype=torch.bool), -5e-4)
    cons = torch.einsum("blij,bjld->bild", torch.softmax(sim, -1), lv)
    div = torch.tensor([4.0] * (L - 1) + [3.0], dtype=torch.float64)[:, None]
    return (lv + terms + cons) / div, terms / div


# -- K4 past d=512: csrc/consensus_wide.cuh ----------------------------------

@pytest.fixture(scope="module")
def k4():
    """K4's emulated C entry, its workspace size and its split planner."""
    if not emulate.compiler():
        pytest.skip("needs g++ to compile the kernel source against the emulator")
    return (emulate.function("consensus", "glom_consensus", consensus_kernel._ARGTYPES),
            emulate.function("consensus", "glom_consensus_workspace", [ctypes.c_int] * 6,
                             ctypes.c_longlong),
            emulate.function("consensus", "glom_consensus_splits", [ctypes.c_int] * 5))


def _emulated_k4(k4, levels, mask=None, attend_self=False, splits=1, width=None):
    """K4's ``(out, lse)`` in buffers, and with a workspace, that start as
    NaN, so that an element it skips shows; ``width``: the model's (default
    d)."""
    fn, ws_floats, _ = k4
    b, n, L, d = levels.shape
    floats = ws_floats(b, n, L, d, splits, DTYPE_CODES[levels.dtype])
    ws = torch.full((max(floats, 4),), float("nan"))
    out = torch.full((b, n, L, d), float("nan"), dtype=levels.dtype)
    lse = torch.full((b, L, n, 1), float("nan"))
    assert fn(levels.data_ptr(), *levels.stride()[:3], None if mask is None else mask.data_ptr(),
              out.data_ptr(), lse.data_ptr(), ws.data_ptr(), b, n, L, d,
              d if width is None else width, int(attend_self), splits,
              DTYPE_CODES[levels.dtype], None) == 0
    return out, lse


# -- K6 and K7: the consensus backward, K6 handing K7 its dS' -----------------

@pytest.fixture(scope="module")
def k67():
    """K6's and K7's emulated C entries."""
    if not emulate.compiler():
        pytest.skip("needs g++ to compile the kernel source against the emulator")
    return (emulate.function("consensus_bwd", "glom_consensus_bwd_dkv",
                             consensus_kernel._DKV_ARGTYPES),
            emulate.function("consensus_bwd", "glom_consensus_bwd_dq",
                             consensus_kernel._DQ_ARGTYPES))


def _k67_inputs(b, n, L, d, dtype, seed, strided=False, non_local_mask=None, attend_self=False):
    """``(levels, dO, lse, delta)``: levels a strided view of a (b, n, L+1,
    d) buffer or contiguous, lse and delta from the plain forward."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    levels = t(b, n, L + 1, d)[..., 1:, :] if strided else t(b, n, L, d)
    g = t(b, n, L, d)
    out, lse = plain_cons.consensus_attention(levels.float(), attend_self=attend_self,
                                              non_local_mask=non_local_mask)
    delta = (g.float() * out).sum(-1).permute(0, 2, 1)[..., None].contiguous()
    return levels, g, lse, delta


def _emulated_k67(k67, levels, g, lse, delta, mask=None, attend_self=False, keep_ds=True,
                  width=None):
    """K6's dKV and dS' and K7's dQ on that dS', in buffers that start as NaN
    so that an element the kernels skip shows; ``width``: the model's
    (default d)."""
    dkv_fn, dq_fn = k67
    b, n, L, d = levels.shape
    code = DTYPE_CODES[levels.dtype]
    dkv = torch.full(levels.shape, float("nan"), dtype=levels.dtype)
    ds = torch.full(consensus_kernel.ds_shape(levels), float("nan"))
    strides = levels.stride()[:3]
    assert dkv_fn(levels.data_ptr(), *strides, g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  None if mask is None else mask.data_ptr(), dkv.data_ptr(),
                  ds.data_ptr() if keep_ds else None, None, b, n, L, d,
                  d if width is None else width, int(attend_self), code, None) == 0
    if not keep_ds:
        return dkv
    dq = torch.full(levels.shape, float("nan"), dtype=levels.dtype)
    assert dq_fn(levels.data_ptr(), *strides, ds.data_ptr(), dq.data_ptr(), b, n, L, d, code,
                 None) == 0
    return dkv, ds, dq


# -- a model 16 wide: the kernels on inputs zero-padded to 128 ----------------

NARROW = 16


def _jnp(t):
    import jax.numpy as jnp

    return jnp.asarray(t.numpy())


def _narrow_ff(rng, g, h):
    return {"w1": _t32(rng, g, NARROW, h, scale=NARROW ** -0.5), "b1": _t32(rng, g, h, scale=0.1),
            "w2": _t32(rng, g, h, NARROW, scale=h ** -0.5), "b2": _t32(rng, g, NARROW, scale=0.1)}


def _t32(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _narrow_consensus(seed, attend_self, radius):
    """``(levels, g, mask, mask_i8, out, lse)`` of a model 16 wide: glom_tpu's
    interpret-mode forward (K4) on them, its out and lse as jax arrays."""
    import jax.numpy as jnp

    from glom_tpu.kernels import consensus_pallas

    rng = np.random.default_rng(seed)
    side = 5
    levels, g = _t32(rng, 1, side * side, 2, NARROW), _t32(rng, 1, side * side, 2, NARROW)
    mask = torch.from_numpy(local_consensus_mask(side, radius)) if radius else None
    mask_i8 = None if mask is None else jnp.asarray(mask.numpy().astype(np.int8))
    out, lse = consensus_pallas._dispatch(_jnp(levels), mask_i8, attend_self, True, None)
    return levels, g, mask, mask_i8, out, lse
