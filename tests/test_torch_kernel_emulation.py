"""The CUDA source of K2 and K3 (``csrc/grouped_ff_bwd.cu``'s dX and dW
kernels) run on the CPU through ``tests/cuda_emu/emulate.py``, against the
wrappers' plain versions on the same inputs.

The emulator compiles the kernels' own source with ``g++`` and runs every
CUDA thread of a block as a host thread, the tensor cores' products on
operands cut to tf32 as the card cuts them.  So these tests reach the
kernels' index arithmetic, fragment layouts, ragged row tiles and slabs,
short hidden chunks and ragged output tiles, the hidden K2 hands K3, the
row split and its ordered reduction, and the rings, which the CPU path of
the wrappers (the plain versions) never does.  Limits as on the card (tests/test_torch_kernels.py):
||got - want|| <= rtol ||want|| and |got - want| <= rtol (min(1, max|want|)
+ |want|), rtol 1e-4 for float32 and 1e-2 for bfloat16 (one rounding).
"""

import ctypes

import numpy as np
import pytest
import torch

from glom_tpu_torch.kernels import ff as ff_kernel
from glom_tpu_torch.kernels._common import DTYPE_CODES
from glom_tpu_torch.ops import feedforward as plain_ff
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
