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


@pytest.mark.parametrize("n,L,d,dtype,extra", [
    (40, 2, 640, torch.float32, {}),              # a ragged query tile and key slab
    (40, 1, 640, torch.bfloat16, {"attend_self": True, "strided": True}),
    (36, 1, 1024, torch.float32, {"side": 6, "strided": True}),   # the locality mask, radius 1.5
    (70, 1, 640, torch.float32, {"attend_self": True}),   # two query and key tiles, 3 x 3 dS tiles
    (25, 1, 1024, torch.bfloat16, {}),
])
def test_emulated_wide_k6_hands_k7_its_ds(k67, n, L, d, dtype, extra):
    """The wide K6 (dKV, its key term also on its own, and the dS' it
    stores: every element, zero past n) and K7 on that dS' against their
    plain versions (K7 also against its plain twin on the same dS');
    without a dS' K6 gives the same dKV; two runs give the same bits."""
    extra = dict(extra)
    side, strided = extra.pop("side", None), extra.pop("strided", False)
    mask = torch.from_numpy(local_consensus_mask(side, 1.5)) if side else None
    kw = dict(non_local_mask=mask, **extra)
    levels, g, lse, delta = _k67_inputs(n, L, d, dtype, n + L + d, strided, **kw)
    dkv, ds, dq = _emulated_k67(k67, levels, g, lse, delta, mask, **extra)
    lf, gf = levels.float(), g.float()
    key_term, _ = plain_cons.consensus_dkv_terms(lf, gf, lse, delta, **kw)
    want = plain_cons.consensus_dkv(lf, gf, lse, delta, **kw)
    assert dkv.dtype == dtype and dq.dtype == dtype
    _assert_close(dkv, want, dtype)
    err = torch.linalg.vector_norm(dkv.float() - want)
    assert err <= RTOL[dtype] * torch.linalg.vector_norm(key_term) + (
        torch.finfo(dtype).eps / 2 * torch.linalg.vector_norm(want))
    assert not ds[..., n:].any()
    _assert_close(ds, plain_cons.consensus_ds(lf, gf, lse, delta, **kw), torch.float32)
    _assert_close(dq, plain_cons.consensus_dq(lf, gf, lse, delta, **kw), dtype)
    _assert_close(dq, plain_cons.consensus_dq_from_ds(levels, ds).float(), dtype)
    assert torch.equal(dkv, _emulated_k67(k67, levels, g, lse, delta, mask, keep_ds=False,
                                          **extra))
    again = _emulated_k67(k67, levels, g, lse, delta, mask, **extra)
    assert all(torch.equal(u, v) for u, v in zip((dkv, ds, dq), again))


def test_emulated_wide_k6_workspace_and_refusals(k67):
    """glom_consensus_bwd_workspace: none up to d=512, the wide design's
    parts above; bad arguments refused; the wide K6 refuses a call without
    its workspace or with one off a 16-byte boundary."""
    dkv_fn, dq_fn, ws_floats = k67
    assert ws_floats(2, 8, 3, 512, 0) == 0
    # S and dP (b, L, n, 32-padded n), P^T and (dS scale)^T (b, L, np, np),
    # key scales, V^T in f32 or bf16, dV and dK (b, L, n, d)
    pairs, n, np_, d = 6, 8, 32, 640
    f32 = 2 * pairs * n * np_ + 2 * pairs * np_ * np_ + pairs * np_ + pairs * d * np_ + (
        2 * pairs * n * d)
    assert ws_floats(2, 8, 3, 640, 0) == f32
    assert ws_floats(2, 8, 3, 640, 1) == f32 - pairs * d * np_ // 2
    for bad in ((2, 8, 3, 96, 0), (2, 8, 3, 640, 2), (0, 8, 3, 640, 0), (2, 0, 3, 640, 0)):
        assert ws_floats(*bad) < 0, bad
    levels, g, lse, delta = _k67_inputs(8, 1, 640, torch.float32, 0)
    out, ds = torch.empty(levels.shape), torch.zeros(consensus_kernel.ds_shape(levels))
    ws = torch.zeros(ws_floats(1, 8, 1, 640, 0) + 4)

    def k6(ws_ptr=ws.data_ptr(), d=640, width=640):
        return dkv_fn(levels.data_ptr(), *levels.stride()[:3], g.data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), None, out.data_ptr(), ds.data_ptr(), ws_ptr, 1, 8, 1, d,
                      width, 0, 0, None)

    assert k6() == 0
    assert k6(ws_ptr=None) != 0                       # the wide design's workspace
    assert k6(ws_ptr=ws.data_ptr() + 4) != 0          # off a 16-byte boundary
    assert k6(d=96, width=96) != 0
    # a model 600 wide, zero-padded to 640, scales its logits by its own width
    assert k6(width=600) == 0 and k6(width=0) != 0 and k6(width=641) != 0
    assert dq_fn(levels.data_ptr(), *levels.stride()[:3], ds.data_ptr(), out.data_ptr(), 1, 8, 1,
                 640, 0, None) == 0                   # K7 takes the width as it is


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


@pytest.mark.parametrize("rows,g,d,h,dtype,strided,dx_splits,dw_splits", [
    (17, 2, 640, 64, torch.float32, True, 1, 1),      # a ragged row tile; h one 64-wide tile
    (9, 1, 1024, 128, torch.bfloat16, False, 2, 1),   # dX's hidden over two blocks
    (70, 1, 640, 160, torch.bfloat16, True, 1, 3),    # two row tiles; K3's rows over three
    (33, 1, 1024, 64, torch.float32, False, 2, 2),
])
def test_emulated_wide_k2_hands_k3_the_hidden(k23, rows, g, d, h, dtype, strided, dx_splits,
                                              dw_splits):
    """The wide K2 (dX, and the hidden it stores: every element once)
    against the plain dX and hidden, then K3 on that hidden against the
    reference plain.grouped_ff_dw, with splits of dX's hidden and of K3's
    rows; two runs give the same bits, and so does dX alone, its hidden in
    the workspace."""
    params, x, dout = _ff_inputs(rows, g, d, h, dtype, strided, seed=rows + d + h)
    dx, hidden = _emulated_k2(k23, params, x, dout, dx_splits)
    p32 = {k: v.float() for k, v in params.items()}
    for got, want in zip(hidden, plain_ff.grouped_ff_hidden(p32, x.float(), dout.float())):
        _assert_close(got, want, torch.float32)
    assert dx.dtype == dtype
    _assert_close(dx, plain_ff.grouped_ff_dx(p32, x.float(), dout.float()), dtype)
    got = _emulated_k3(k23, params, x, dout, hidden, dw_splits)
    for name, g_, w_ in zip(("w1", "b1", "w2"), got,
                            plain_ff.grouped_ff_dw(p32, x.float(), dout.float())):
        assert g_.dtype == dtype and g_.shape == params[name].shape
        _assert_close(g_, w_, dtype)
    dx2, hidden2 = _emulated_k2(k23, params, x, dout, dx_splits)
    assert torch.equal(dx, dx2) and all(torch.equal(u, v) for u, v in zip(hidden, hidden2))
    assert torch.equal(dx, _emulated_k2(k23, params, x, dout, dx_splits, keep_hidden=False))
    assert all(torch.equal(u, v)
               for u, v in zip(got, _emulated_k3(k23, params, x, dout, hidden2, dw_splits)))


def test_emulated_wide_k2_workspace_and_refusals(k23):
    """glom_grouped_ff_bwd_dx_workspace: the narrow kernel's split sums as
    before (with or without the hidden), the transposed weights, the split
    sums and, where the call passes no hidden, H and dH above 512; bad
    arguments refused; the wide K2 refuses a call without its workspace,
    with one half of the hidden, or with x's rows off a 16-byte boundary."""
    dx_fn, _, ws_floats = k23
    for has_hidden in (0, 1):
        assert ws_floats(8, 2, 512, 64, 1, 0, has_hidden) == 0
        assert ws_floats(8, 2, 512, 64, 3, 0, has_hidden) == 3 * 8 * 2 * 512
    weight = 2 * 640 * 64   # W1^T or W2^T, f32
    assert ws_floats(8, 2, 640, 64, 1, 0, 1) == 2 * weight
    assert ws_floats(8, 2, 640, 64, 1, 1, 1) == weight
    assert ws_floats(8, 2, 640, 64, 2, 0, 1) == 2 * weight + 2 * 8 * 2 * 640
    assert ws_floats(8, 2, 640, 64, 2, 0, 0) == 2 * weight + 2 * 8 * 2 * 640 + 2 * 2 * 8 * 64
    for bad in ((8, 2, 96, 64, 1, 0, 1), (8, 2, 640, 48, 1, 0, 1), (8, 2, 640, 64, 0, 0, 1),
                (8, 2, 640, 64, 1, 2, 1), (0, 2, 640, 64, 1, 0, 1)):
        assert ws_floats(*bad) < 0, bad
    params, x, dout = _ff_inputs(8, 2, 640, 64, torch.float32, False, seed=0)
    dx = torch.empty(x.shape)
    ws = torch.zeros(2 * weight + 4)
    hid, dh = torch.zeros((2, 8, 64)), torch.zeros((2, 8, 64))
    off = torch.zeros(x.numel() + 1)[1:].view(x.shape)

    def call(x_ptr=x.data_ptr(), ws_ptr=ws.data_ptr(), hid_ptr=hid.data_ptr(),
             dh_ptr=dh.data_ptr()):
        return dx_fn(x_ptr, x.stride(1), x.stride(2), params["w1"].data_ptr(),
                     params["b1"].data_ptr(), params["w2"].data_ptr(), dout.data_ptr(),
                     dx.data_ptr(), ws_ptr, hid_ptr, dh_ptr, 8, 2, 640, 64, 1, 0, None)

    assert call() == 0
    assert call(ws_ptr=None) != 0                     # the transposed weights' workspace
    assert call(hid_ptr=None) != 0                    # one half of the hidden
    assert call(x_ptr=off.data_ptr()) != 0            # x off a 16-byte boundary


@pytest.mark.parametrize("rows,g,d,h,want", [
    (2304, 8, 1024, 4096, 1),   # the large preset's bottom-up, b=4: 2,304 dX tiles
    (576, 7, 1024, 4096, 1),    # top-down, b=1: 504 tiles, over a wave of 132
    (64, 1, 640, 256, 8),       # 5 tiles of 8 slabs: one slab a block
    (64, 1, 640, 64, 2),        # 2 slabs: each its own block
])
def test_emulated_wide_k2_plans_splits_for_132_sms(k23, rows, g, d, h, want):
    """glom_grouped_ff_bwd_dx_splits above d=512 on a card of 132 SMs, one
    block an SM (the emulator's device): tile_gemm.cuh's rule over dX's
    tiles."""
    plan = emulate.function("grouped_ff_bwd", "glom_grouped_ff_bwd_dx_splits", [ctypes.c_int] * 5)
    assert plan(rows, g, d, h, 0) == want
