"""The CUDA sources of K1 (``csrc/grouped_ff.cu``, the grouped-FF forward),
of K2 and K3 (``csrc/grouped_ff_bwd.cu``'s dX and dW kernels), of K6 and K7
(``csrc/consensus_bwd.cu``, the consensus backward, K6 handing K7 its dS')
and of K8 (``csrc/fused_update.cu``, the fused level update, with K4's
consensus kernel inside) run on the CPU through ``tests/cuda_emu/emulate.py``,
against the wrappers' plain versions on the same inputs.

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
"""

import ctypes

import numpy as np
import pytest
import torch

from glom_tpu_torch.kernels import consensus as consensus_kernel
from glom_tpu_torch.kernels import ff as ff_kernel
from glom_tpu_torch.kernels import fused_update
from glom_tpu_torch.kernels._common import DTYPE_CODES
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


@pytest.mark.parametrize("rows,g,d,h,dtype,strided", [
    (49, 2, 128, 256, torch.float32, True),      # one full chunk; two row tiles, the last ragged
    (33, 1, 128, 96, torch.float32, False),      # one short chunk (96 of 256 hidden units)
    (1, 2, 128, 288, torch.float32, True),       # a full chunk, then a short one; one row
    (40, 1, 256, 64, torch.float32, True),       # d=256: four of phase 2's n-tiles a warp
    (17, 2, 128, 160, torch.bfloat16, True),
    (32, 1, 384, 64, torch.bfloat16, False),
])
def test_emulated_k2_matches_plain(dx_fn, rows, g, d, h, dtype, strided):
    _check_case(dx_fn, rows, g, d, h, dtype, strided)


@pytest.mark.parametrize("splits,h,dtype", [(2, 512, torch.float32), (3, 544, torch.bfloat16)])
def test_emulated_k2_split_hidden_matches_plain(dx_fn, splits, h, dtype):
    """The hidden split over several blocks (partial sums through the f32
    workspace, added in order by the second kernel); with 3, the last split
    holds one short chunk."""
    _check_case(dx_fn, 9, 1, 128, h, dtype, True, splits=splits)


@pytest.mark.parametrize("rows,g,h,want", [
    (2048, 6, 2048, 1),     # flagship bottom-up, b=8: 384 tiles, 3 full waves either way
    (2048, 5, 2048, 2),     # top-down: 320 tiles are 2.4 waves; split, 4.8 of half the work
    (256, 6, 2048, 8),      # b=1: 48 tiles; 8 splits fill 384 of 396 slots in 3 waves of 1 chunk
    (64, 1, 256, 1),        # one chunk: nothing to split
])
def test_emulated_k2_plans_splits_for_132_sms(rows, g, h, want):
    """glom_grouped_ff_bwd_dx_splits on a card of 132 SMs, one block an SM
    (the emulator's device)."""
    if not emulate.compiler():
        pytest.skip("needs g++ to compile the kernel source against the emulator")
    plan = emulate.function("grouped_ff_bwd", "glom_grouped_ff_bwd_dx_splits", [ctypes.c_int] * 5)
    assert plan(rows, g, 512, h, 0) == want


def _check_case(dx_fn, rows, g, d, h, dtype, strided, splits=1):
    params, x, dout = _inputs(rows, g, d, h, dtype, strided, seed=rows + d + h)
    got = _emulated_dx(dx_fn, params, x, dout, splits)
    want = plain_ff.grouped_ff_dx({k: v.float() for k, v in params.items()}, x.float(),
                                  dout.float())
    assert got.dtype == dtype
    _assert_close(got, want, dtype)
    assert torch.equal(got, _emulated_dx(dx_fn, params, x, dout, splits))


def test_emulated_k2_refuses_what_the_kernel_does_not_take(dx_fn):
    params, x, dout = _inputs(8, 1, 128, 64, torch.float32, False, seed=0)
    dx = torch.empty_like(x)
    args = [x.data_ptr(), x.stride(1), x.stride(2), params["w1"].data_ptr(),
            params["b1"].data_ptr(), params["w2"].data_ptr(), dout.data_ptr(), dx.data_ptr(), None,
            None, None]
    assert dx_fn(*args, 8, 1, 96, 64, 1, 0, None) != 0        # d not a multiple of 128
    assert dx_fn(*args, 8, 1, 128, 48, 1, 0, None) != 0       # h not a multiple of 32
    assert dx_fn(*args, 8, 1, 128, 64, 0, 0, None) != 0       # no split
    assert dx_fn(*args, 8, 1, 128, 64, 2, 0, None) != 0       # splits without a workspace
    hid = torch.zeros((1, 8, 64))
    args[9] = hid.data_ptr()                                  # hid without dh
    assert dx_fn(*args, 8, 1, 128, 64, 1, 0, None) != 0
    args[9] = None
    off = torch.zeros(params["w1"].numel() + 1)[1:]           # w1 off a 16-byte boundary
    args[3] = off.data_ptr()
    assert dx_fn(*args, 8, 1, 128, 64, 1, 0, None) != 0


@pytest.mark.parametrize("rows,g,d,h,dtype,strided,splits", [
    # ragged: two row slabs of 32, the last of 17 rows; h 160: a dW1 tile of
    # 128 columns and one of 32, dW2 tiles of 64, 64 and 32 hidden rows
    (49, 1, 128, 160, torch.float32, True, 1),
    (49, 1, 128, 64, torch.float32, False, 2),     # the two slabs split over two blocks
    (49, 2, 128, 96, torch.bfloat16, True, 2),
    (70, 1, 256, 32, torch.float32, True, 3),      # three slabs, three splits; h one warp wide
    (33, 1, 256, 128, torch.bfloat16, False, 1),
])
def test_emulated_k2_hands_k3_the_hidden(dx_fn, dw_fn, rows, g, d, h, dtype, strided, splits):
    """K2 with its hidden stored (every element once: the buffers start as
    NaN) against the plain hidden, then K3 on that hidden against the
    reference plain.grouped_ff_dw, with one split of the rows and several;
    two runs give the same bits."""
    params, x, dout = _inputs(rows, g, d, h, dtype, strided, seed=rows + d + h)
    dx, hidden = _emulated_dx(dx_fn, params, x, dout, keep_hidden=True)
    p32 = {k: v.float() for k, v in params.items()}
    for got, want in zip(hidden, plain_ff.grouped_ff_hidden(p32, x.float(), dout.float())):
        _assert_close(got, want, torch.float32)
    _assert_close(dx, plain_ff.grouped_ff_dx(p32, x.float(), dout.float()), dtype)
    got = _emulated_dw(dw_fn, params, x, dout, hidden, splits)
    for name, g_, w_ in zip(("w1", "b1", "w2"), got,
                            plain_ff.grouped_ff_dw(p32, x.float(), dout.float())):
        assert g_.dtype == dtype and g_.shape == params[name].shape
        _assert_close(g_, w_, dtype)
    for a, b in zip(got, _emulated_dw(dw_fn, params, x, dout, hidden, splits)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rows,g,d,h,want", [
    (2048, 6, 512, 2048, 1),   # flagship b=8: 1,536 output tiles, many waves: no split
    (256, 6, 512, 2048, 1),    # b=1: the same tiles, each over 8 slabs
    (49, 1, 128, 64, 2),       # 3 tiles: each of the two slabs its own block
    (256, 1, 128, 256, 8),     # 8 tiles, 8 slabs: one slab a block
])
def test_emulated_k3_plans_splits_for_132_sms(rows, g, d, h, want):
    """glom_grouped_ff_bwd_dw_splits on a card of 132 SMs, one block an SM
    (the emulator's device): rows split only where the tiles leave SMs idle."""
    if not emulate.compiler():
        pytest.skip("needs g++ to compile the kernel source against the emulator")
    plan = emulate.function("grouped_ff_bwd", "glom_grouped_ff_bwd_dw_splits", [ctypes.c_int] * 5)
    assert plan(rows, g, d, h, 0) == want


def test_emulated_k3_refuses_what_the_kernel_does_not_take(dw_fn):
    params, x, dout = _inputs(8, 1, 128, 64, torch.float32, False, seed=0)
    hid, dh = torch.zeros((1, 8, 64)), torch.zeros((1, 8, 64))
    out = [torch.empty_like(params[k]) for k in ("w1", "b1", "w2")]

    def call(x_ptr=x.data_ptr(), row_stride=x.stride(1), hid_ptr=hid.data_ptr(), d=128, h=64,
             splits=1, ws=None):
        return dw_fn(x_ptr, row_stride, x.stride(2), dout.data_ptr(), hid_ptr, dh.data_ptr(),
                     *(t.data_ptr() for t in out), ws, 8, 1, d, h, splits, 0, None)

    assert call() == 0
    assert call(hid_ptr=None) != 0                       # no hidden: nothing to reduce
    assert call(d=96) != 0 and call(h=48) != 0           # widths the kernel does not take
    assert call(splits=0) != 0 and call(splits=2) != 0   # no split; splits without a workspace
    assert call(x_ptr=x.data_ptr() + 4) != 0             # x off a 16-byte boundary
    assert call(row_stride=x.stride(1) + 1) != 0         # rows off it


def _f64_hidden(params, x, dout):
    """H and dH of one group in float64, (rows, h) each."""
    w1, b1, w2 = (params[k][0].double() for k in ("w1", "b1", "w2"))
    pre = x[0, :, 0].double() @ w1 + b1
    cdf = 0.5 * (1.0 + torch.erf(pre * 2.0 ** -0.5))
    pdf = torch.exp(-0.5 * pre * pre) / (2.0 * torch.pi) ** 0.5
    return pre * cdf, (dout[0, :, 0].double() @ w2.T) * (cdf + pre * pdf)


def test_emulated_k2_hidden_does_not_drift(dx_fn):
    """The hidden K2 hands K3 at d=512, against float64: the tensor cores
    round their accumulation toward zero (as the emulator does), so a sum
    over d kept inside the mma shrinks H and dH by about 4e-6 of their size,
    which K3's sums over thousands of rows turn into errors of 1e-4 on small
    weight-gradient entries.  Each slab's product is added with an f32 add,
    which keeps them to 3e-7."""
    params, x, dout = _inputs(32, 1, 512, 64, torch.float32, False, seed=5)
    _, hidden = _emulated_dx(dx_fn, params, x, dout, keep_hidden=True)
    for got, want in zip(hidden, _f64_hidden(params, x, dout)):
        got = got[0].double()
        assert torch.linalg.vector_norm(got - want) <= 1e-6 * torch.linalg.vector_norm(want)
        # no bias toward zero beyond a few units of the last place
        assert -((got - want) * want.sign()).sum() <= 1e-6 * want.abs().sum()


def test_emulated_k3_sum_over_many_rows_does_not_drift(dw_fn):
    """K3 over 1,024 rows (32 slabs) of an exact float32 hidden, against
    float64: each slab's product is formed in a zeroed fragment and added
    with an f32 add, so the sum does not drift toward zero."""
    params, x, dout = _inputs(1024, 1, 128, 64, torch.float32, False, seed=6)
    h, dh = (t.float()[None].contiguous() for t in _f64_hidden(params, x, dout))
    dw1, db1, dw2 = _emulated_dw(dw_fn, params, x, dout, (h, dh))
    xd, gd, hd, dhd = x[0, :, 0].double(), dout[0, :, 0].double(), h[0].double(), dh[0].double()
    for got, want in ((dw1[0], xd.T @ dhd), (db1[0], dhd.sum(0)), (dw2[0], hd.T @ gd)):
        err = got.double() - want
        # kept inside the mma, the sum reads 9.5e-6 normwise, shrunk by
        # 8.2e-6, and 4e-4 off on an entry
        assert torch.linalg.vector_norm(err) <= 1e-6 * torch.linalg.vector_norm(want)
        assert -(err * want.sign()).sum() <= 1e-6 * want.abs().sum()
        assert (err.abs() <= 1e-4 * (1.0 + want.abs())).all()


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


@pytest.mark.parametrize("rows,g,d,h,dtype,strided,splits", [
    # 49 rows: one row tile, the last 15 of its rows past the end; h 192: a
    # full hidden tile of 128 and one of 64 (its upper warps idle)
    (49, 2, 128, 192, torch.float32, True, 1),
    (33, 1, 256, 64, torch.float32, False, 1),     # one hidden tile of 64
    (1, 1, 384, 320, torch.float32, True, 1),      # one row; hidden tiles 128, 128, 64
    (33, 2, 128, 320, torch.bfloat16, True, 1),
    (49, 1, 256, 192, torch.bfloat16, False, 1),
    # K1b's hidden split over three blocks (10 slabs: 4, 4, 2) through the
    # workspace, added in order with b2 by the third kernel
    (49, 1, 128, 320, torch.float32, True, 3),
    (33, 2, 128, 192, torch.bfloat16, False, 2),
])
def test_emulated_k1_matches_plain(k1_fn, rows, g, d, h, dtype, strided, splits):
    """K1's output against grouped_ff_apply in float32 on the same inputs,
    the hidden K1a stores (every element once) against the plain hidden;
    two runs give the same bits."""
    params, x, _ = _inputs(rows, g, d, h, dtype, strided, seed=rows + d + h)
    got, hid = _emulated_k1(k1_fn, params, x, splits)
    assert got.dtype == dtype and got.shape == x.shape
    _assert_close(hid, _plain_hidden(params, x), torch.float32)
    want = plain_ff.grouped_ff_apply({k: v.float() for k, v in params.items()}, x.float())
    _assert_close(got, want, dtype)
    assert torch.equal(got, _emulated_k1(k1_fn, params, x, splits)[0])


@pytest.mark.parametrize("rows,g,d,h,want", [
    (2048, 6, 512, 2048, 1),   # flagship bottom-up, b=8: 768 output tiles, many waves
    (2048, 11, 512, 2048, 1),  # fuse_ff: 1,408 tiles
    (256, 6, 512, 2048, 1),    # b=1: 96 tiles, under a wave of 132: a split would not fit one
    (49, 6, 512, 2048, 5),     # 24 tiles: 5 splits of 13 slabs fill 120 of 132 slots
    (256, 1, 128, 2048, 32),   # 4 tiles: 32 splits of 2 slabs
])
def test_emulated_k1_plans_splits_for_132_sms(rows, g, d, h, want):
    """glom_grouped_ff_splits on a card of 132 SMs, one block an SM (the
    emulator's device): K1b's hidden splits only where its tiles leave SMs
    idle and the split blocks fit one wave."""
    if not emulate.compiler():
        pytest.skip("needs g++ to compile the kernel source against the emulator")
    plan = emulate.function("grouped_ff", "glom_grouped_ff_splits", [ctypes.c_int] * 5)
    assert plan(rows, g, d, h, 0) == want


def test_emulated_k1_refuses_what_the_kernel_does_not_take(k1_fn):
    params, x, _ = _inputs(8, 1, 128, 64, torch.float32, False, seed=0)
    out, hid = torch.empty_like(x), torch.zeros((1, 8, 64))
    ws = torch.zeros((2, x.numel()))

    def call(x_ptr=x.data_ptr(), row_stride=x.stride(1), w1=params["w1"].data_ptr(),
             hid_ptr=hid.data_ptr(), d=128, h=64, splits=1, ws_ptr=None):
        return k1_fn(x_ptr, row_stride, x.stride(2), w1, params["b1"].data_ptr(),
                     params["w2"].data_ptr(), params["b2"].data_ptr(), out.data_ptr(), ws_ptr,
                     hid_ptr, 8, 1, d, h, splits, 0, None)

    assert call() == 0 and call(splits=2, ws_ptr=ws.data_ptr()) == 0
    assert call(d=64) != 0                               # d not a multiple of 128
    assert call(h=96) != 0                               # h not a multiple of 64
    off = torch.zeros(params["w1"].numel() + 1)[1:]      # w1 off a 16-byte boundary
    assert call(w1=off.data_ptr()) != 0
    assert call(x_ptr=x.data_ptr() + 4) != 0             # x off a 16-byte boundary
    assert call(row_stride=x.stride(1) + 1) != 0         # rows off it
    assert call(hid_ptr=None) != 0                       # no hidden to hand K1b
    assert call(splits=0) != 0 and call(splits=2) != 0   # no split; splits without a workspace


def test_emulated_k1_sum_over_the_hidden_does_not_drift(k1_fn):
    """K1 at d=128, h=2048 over 64 rows, one block a tile (K1b sums 64
    hidden slabs), against float64: each slab's product is formed in a
    zeroed fragment and added with an f32 add, so the sum over the hidden
    does not drift toward zero as it does kept inside the mma (whose f32
    accumulation rounds toward zero, as the emulator's does)."""
    params, x, _ = _inputs(64, 1, 128, 2048, torch.float32, False, seed=7)
    got, _ = _emulated_k1(k1_fn, params, x, splits=1)
    w1, b1, w2, b2 = (params[k][0].double() for k in ("w1", "b1", "w2", "b2"))
    pre = x[0, :, 0].double() @ w1 + b1
    want = (0.5 * pre * (1.0 + torch.erf(pre * 2.0 ** -0.5))) @ w2 + b2
    err = got[0, :, 0].double() - want
    assert torch.linalg.vector_norm(err) <= 1e-4 * torch.linalg.vector_norm(want)
    assert (err.abs() <= 1e-4 * (min(1.0, want.abs().max().item()) + want.abs())).all()
    # no bias toward zero beyond a few units of the last place
    assert -(err * want.sign()).sum() <= 1e-6 * want.abs().sum()


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


def _emulated_k8(k8, args, mask=None, attend_self=False, splits=1, key_splits=1):
    """K8's output in a buffer, and with a workspace, that start as NaN, so
    that an element it skips shows."""
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
              b, n, L, d, h, int(attend_self), splits, key_splits, DTYPE_CODES[levels.dtype], None)
    assert code == 0, code
    return out


@pytest.mark.parametrize("b,side,L,d,h,dtype,extra", [
    # n=25: one 64-row tile, 39 of its rows past the end; h 192: a hidden
    # tile of 128 and one of 64; a short key block
    (1, 5, 3, 128, 192, torch.float32, {}),
    (1, 5, 3, 128, 192, torch.bfloat16, {}),
    # L=2: level 0 reads the tokens and level 1 is the top; h one 64 tile;
    # the views' contiguous copies give the same bits
    (2, 3, 2, 128, 64, torch.float32, {"contiguous": True}),
    (2, 3, 2, 128, 64, torch.bfloat16, {"contiguous": True}),
    (1, 4, 3, 256, 64, torch.float32, {"attend_self": True}),
    (1, 6, 2, 128, 192, torch.float32, {"radius": 1.5}),
    (1, 6, 3, 128, 64, torch.bfloat16, {"radius": 1.5, "key_splits": 2}),
    # K8b's hidden over 2 and 3 blocks (6 slabs: 3 + 3, 2 + 2 + 2) through the
    # workspace, added in order and the update formed by the second kernel
    (1, 5, 3, 128, 192, torch.float32, {"splits": 2}),
    (2, 3, 2, 128, 192, torch.bfloat16, {"splits": 3, "key_splits": 1}),
])
def test_emulated_k8_matches_plain(k8, b, side, L, d, h, dtype, extra):
    """K8 on strided views of one (b, n, L+1, d) buffer against plain_update
    (the unfused composition in float32, rounded once); with splits, two
    calls give the same bits."""
    extra = dict(extra)
    radius, contiguous = extra.pop("radius", 0), extra.pop("contiguous", False)
    mask = torch.from_numpy(local_consensus_mask(side, radius)) if radius else None
    args = _k8_inputs(b, side * side, L, d, h, dtype, seed=side + L + h)
    got = _emulated_k8(k8, args, mask, **extra)
    want = fused_update.plain_update(*args, mask, attend_self=extra.get("attend_self", False))
    assert got.dtype == dtype and got.shape == args[2].shape
    _assert_close(got, want, dtype)
    if extra.get("splits", 1) > 1 or extra.get("key_splits", 1) > 1:
        assert torch.equal(got, _emulated_k8(k8, args, mask, **extra))
    if contiguous:
        flat = args[:2] + tuple(t.contiguous() for t in args[2:])
        assert torch.equal(got, _emulated_k8(k8, flat, mask, **extra))


@pytest.mark.parametrize("b,n,L,d,h,want", [
    (1, 256, 6, 512, 2048, 1),    # flagship b=1: 96 tiles; a split would not fit one wave of 132
    (2, 256, 6, 512, 2048, 1),    # 192 tiles
    (4, 256, 6, 512, 2048, 1),
    (8, 256, 6, 512, 2048, 1),    # 768 tiles, many waves
    (32, 256, 6, 512, 2048, 1),
    (1, 1024, 6, 512, 2048, 1),   # the largest n the fused path takes: 384 tiles
    (1, 64, 6, 512, 2048, 5),     # 24 tiles: 5 splits of 13 slabs fill 120 of 132 slots
    (1, 25, 2, 512, 256, 8),      # 8 tiles, 8 slabs: one slab a block
    (1, 16, 2, 128, 2048, 8),     # 2 tiles: at most 8 splits
    (1, 16, 2, 128, 64, 2),       # 2 slabs: nothing more to split
])
def test_emulated_k8_plans_splits_for_132_sms(b, n, L, d, h, want):
    """glom_fused_update_splits on a card of 132 SMs, one block an SM (the
    emulator's device): K8b's hidden splits only where its tiles leave SMs
    idle and the split blocks fit one wave, at most 8."""
    if not emulate.compiler():
        pytest.skip("needs g++ to compile the kernel source against the emulator")
    plan = emulate.function("fused_update", "glom_fused_update_splits", [ctypes.c_int] * 6)
    assert plan(b, n, L, d, h, 0) == want


def test_emulated_k8_refuses_what_the_kernel_does_not_take(k8):
    fn, ws_floats = k8
    bu, td, levels, bottom, pos = _k8_inputs(2, 4, 3, 128, 64, torch.float32, seed=0)
    assert ws_floats(2, 4, 3, 128, 64, 1, 1) > 0
    for bad in ((2, 4, 3, 96, 64, 1, 1), (2, 4, 3, 128, 96, 1, 1), (2, 4, 1, 128, 64, 1, 1),
                (2, 4, 3, 128, 64, 0, 1), (2, 4, 3, 128, 64, 9, 1), (2, 4, 3, 128, 64, 1, 9)):
        assert ws_floats(*bad) < 0, bad                   # d, h, L, splits, key splits
    out = torch.empty(levels.shape)
    ws = torch.zeros(ws_floats(2, 4, 3, 128, 64, 1, 1))
    names = ("w1", "b1", "w2", "b2")

    def call(lv=levels, sb=levels.stride(0), bot=bottom, w1=bu["w1"], ws_ptr=ws.data_ptr(),
             floats=ws.numel(), d=128, h=64, L=3, splits=1, dtype=0):
        return fn(lv.data_ptr(), sb, lv.stride(1), lv.stride(2), bot.data_ptr(), bot.stride(0),
                  bot.stride(1), pos.data_ptr(), pos.stride(1), w1.data_ptr(),
                  *(bu[k].data_ptr() for k in names[1:]), *(td[k].data_ptr() for k in names),
                  None, out.data_ptr(), ws_ptr, floats, 2, 4, L, d, h, 0, splits, 1, dtype, None)

    assert call() == 0
    assert call(d=96) != 0 and call(h=96) != 0 and call(L=1) != 0   # widths, levels
    assert call(splits=0) != 0 and call(splits=9) != 0
    assert call(ws_ptr=None) != 0 and call(floats=ws.numel() - 1) != 0   # no or short workspace
    assert call(dtype=2) != 0
    shifted = torch.zeros(levels.numel() + 4)[1:levels.numel() + 1].view(levels.shape)
    assert call(lv=shifted) != 0                          # levels off a 16-byte boundary
    assert call(sb=levels.stride(0) + 4) != 0             # (b, n) axes that do not flatten
    assert call(bot=torch.zeros(2, 4, 1, 130)[..., 1:129]) != 0   # bottom's rows off it
    off = torch.zeros(bu["w1"].numel() + 1)[1:].view(bu["w1"].shape)
    assert call(w1=off) != 0                              # w1 off a 16-byte boundary


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


def test_emulated_k8_sum_over_the_hidden_does_not_drift(k8):
    """K8 at K1's drift case (d=128, h=2048, 64 rows: n=64, b=1, L=2, one
    block a tile, so K8b sums 64 hidden slabs of each net) against float64,
    with K1's three bounds; the bias toward zero is measured along the two
    nets' terms, which a sum kept inside the mma (whose f32 accumulation
    rounds toward zero, as the emulator's does) would shrink."""
    args = _k8_inputs(1, 64, 2, 128, 2048, torch.float32, seed=7)
    got = _emulated_k8(k8, args)
    want, terms = _f64_update(*args)
    err = got.double() - want
    assert torch.linalg.vector_norm(err) <= 1e-4 * torch.linalg.vector_norm(want)
    assert (err.abs() <= 1e-4 * (min(1.0, want.abs().max().item()) + want.abs())).all()
    # no bias toward zero beyond a few units of the last place
    assert -(err * terms.sign()).sum() <= 1e-6 * terms.abs().sum()


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


def _emulated_k67(k67, levels, g, lse, delta, mask=None, attend_self=False, keep_ds=True):
    """K6's dKV and dS' and K7's dQ on that dS', in buffers that start as NaN
    so that an element the kernels skip shows."""
    dkv_fn, dq_fn = k67
    b, n, L, d = levels.shape
    code = DTYPE_CODES[levels.dtype]
    dkv = torch.full(levels.shape, float("nan"), dtype=levels.dtype)
    ds = torch.full(consensus_kernel.ds_shape(levels), float("nan"))
    strides = levels.stride()[:3]
    assert dkv_fn(levels.data_ptr(), *strides, g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  None if mask is None else mask.data_ptr(), dkv.data_ptr(),
                  ds.data_ptr() if keep_ds else None, b, n, L, d, int(attend_self), code,
                  None) == 0
    if not keep_ds:
        return dkv
    dq = torch.full(levels.shape, float("nan"), dtype=levels.dtype)
    assert dq_fn(levels.data_ptr(), *strides, ds.data_ptr(), dq.data_ptr(), b, n, L, d, code,
                 None) == 0
    return dkv, ds, dq


@pytest.mark.parametrize("n,L,d,dtype,extra", [
    (40, 2, 128, torch.float32, {}),             # two key blocks, the last of 8; 3 query steps
    (40, 2, 128, torch.bfloat16, {}),
    (72, 1, 128, torch.float32, {"attend_self": True}),
    (72, 1, 128, torch.bfloat16, {"attend_self": True, "strided": True}),
    (36, 2, 128, torch.float32, {"side": 6}),    # the locality mask, radius 1.5
    (36, 1, 128, torch.bfloat16, {"side": 6, "strided": True}),
    (40, 2, 128, torch.float32, {"strided": True}),
    (25, 1, 384, torch.float32, {}),             # a warp owns one m-tile and three quads
    (33, 1, 512, torch.bfloat16, {"attend_self": True}),   # both m-tiles, two quads
])
def test_emulated_k6_hands_k7_its_ds(k67, n, L, d, dtype, extra):
    """K6 (dKV, its key term also on its own, and the dS' it stores: every
    element, zero past n) and K7 on that dS' against their plain versions
    (K7 also against its plain twin on the same dS'); without a dS' K6 gives
    the same dKV; two runs give the same bits."""
    extra = dict(extra)
    side, strided = extra.pop("side", None), extra.pop("strided", False)
    mask = torch.from_numpy(local_consensus_mask(side, 1.5)) if side else None
    kw = dict(non_local_mask=mask, **extra)
    levels, g, lse, delta = _k67_inputs(1, n, L, d, dtype, n + L + d, strided, **kw)
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


def test_emulated_k6_refuses_what_the_kernel_does_not_take(k67):
    dkv_fn, dq_fn = k67
    levels, g, lse, delta = _k67_inputs(1, 8, 2, 128, torch.float32, 0)
    out, ds = torch.empty(levels.shape), torch.zeros(consensus_kernel.ds_shape(levels))

    def k6(lv=levels.data_ptr(), sn=levels.stride(1), d=128, dtype=0):
        return dkv_fn(lv, levels.stride(0), sn, levels.stride(2), g.data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), None, out.data_ptr(), ds.data_ptr(), 1, 8, 2, d, 0,
                      dtype, None)

    def k7(lv=levels.data_ptr(), ds_ptr=ds.data_ptr(), d=128):
        return dq_fn(lv, *levels.stride()[:3], ds_ptr, out.data_ptr(), 1, 8, 2, d, 0, None)

    assert k6() == 0 and k7() == 0
    assert k6(d=96) != 0 and k6(d=640) != 0 and k6(dtype=2) != 0 and k7(d=96) != 0
    assert k6(lv=levels.data_ptr() + 4) != 0 and k7(lv=levels.data_ptr() + 4) != 0
    assert k6(sn=levels.stride(1) + 1) != 0               # rows off a 16-byte boundary
    assert k7(ds_ptr=None) != 0                           # K7 reads K6's dS'


def test_emulated_k7_on_k6s_ds_stays_near_float64(k67):
    """K7's dQ on K6's dS' against float64, normwise, within 1.75x the
    float32 plain version's error.  dQ = sum_j dS'_ij V_j cancels, and so
    does dS = P (dP - delta), so the bit a truncated tf32 split of S's and
    dP's operands loses shows in dQ: with K6 splitting them so, dQ read 2.2x
    the plain version's error here, with the rounded split 1.4x."""
    levels, g, lse, delta = _k67_inputs(1, 128, 1, 128, torch.float32, 1)
    _, _, dq = _emulated_k67(k67, levels, g, lse, delta)
    x, gd = levels.double(), g.double()
    n, d = x.shape[1], x.shape[-1]
    eye = torch.eye(n, dtype=torch.bool)
    keys = x / x.norm(dim=-1, keepdim=True)
    p = torch.softmax((torch.einsum("bild,bjld->blij", x, keys) * d ** -0.5).masked_fill(eye, -5e-4), -1)
    dl = (gd * torch.einsum("blij,bjld->bild", p, x)).sum(-1).permute(0, 2, 1)[..., None]
    ds = (p * (torch.einsum("bild,bjld->blij", gd, x) - dl)).masked_fill(eye, 0.0)
    want = torch.einsum("blij,bjld->bild", ds, keys) * d ** -0.5
    plain = plain_cons.consensus_dq(levels, g, lse, delta).double()
    err = torch.linalg.vector_norm(dq.double() - want)
    assert err <= 1.75 * torch.linalg.vector_norm(plain - want)


def test_emulated_k6_sum_over_many_queries_does_not_drift(k67):
    """K6's dKV over 384 queries (24 steps) against float64: each step's
    dV and dK products are formed in a zeroed fragment and added with an f32
    add, so the sums over the queries do not drift toward zero (kept inside
    the mma, whose f32 accumulation rounds toward zero as the emulator's
    does, they read 4.5e-6 normwise and 4.1e-6 of bias over 512 queries)."""
    levels, g, lse, delta = _k67_inputs(1, 384, 1, 128, torch.float32, 9)
    got = _emulated_k67(k67, levels, g, lse, delta, keep_ds=False).double()
    x, gd = levels.double(), g.double()
    n, d = x.shape[1], x.shape[-1]
    eye = torch.eye(n, dtype=torch.bool)
    sim = torch.einsum("bild,bjld->blij", x, x / x.norm(dim=-1, keepdim=True)) * d ** -0.5
    p = torch.softmax(sim.masked_fill(eye, -5e-4), -1)
    dl = (gd * torch.einsum("blij,bjld->bild", p, x)).sum(-1).permute(0, 2, 1)[..., None]
    ds = (p * (torch.einsum("bild,bjld->blij", gd, x) - dl)).masked_fill(eye, 0.0)
    want = plain_cons.l2_normalize_vjp(x, torch.einsum("blij,bild->bjld", ds, x) * d ** -0.5)
    want = want + torch.einsum("blij,bild->bjld", p, gd)
    err = got - want
    assert torch.linalg.vector_norm(err) <= 1e-6 * torch.linalg.vector_norm(want)
    assert -(err * want.sign()).sum() <= 1e-6 * want.abs().sum()
    assert (err.abs() <= 1e-4 * (1.0 + want.abs())).all()
