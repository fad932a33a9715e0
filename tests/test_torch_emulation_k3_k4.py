"""K2 handing K3 its hidden and K3 on it (``csrc/grouped_ff_bwd.cu``: one
split and several, its planner, the refusals, the sum over many rows
against float64), and K4 past d=512 (``csrc/consensus_wide.cuh``: its
workspace, planner and refusals) and on levels of a model 16 wide against
``glom_tpu``'s kernel in interpret mode, run on the CPU through
``tests/cuda_emu/emulate.py``.

Limits as on the card (tests/test_torch_kernels.py):
||got - want|| <= rtol ||want|| and |got - want| <= rtol (min(1, max|want|)
+ |want|), rtol 1e-4 for float32 and 1e-2 for bfloat16 (one rounding).
The emulator, the fixtures and the helpers are in
``tests/kernel_emulation_common.py``; the kernel families are split over
five files so that pytest-xdist's ``--dist loadfile`` spreads them over its
workers.
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
from tests.kernel_emulation_common import (  # noqa: F401 (fixtures)
    NARROW, _assert_close, _emulated_dw, _emulated_dx, _emulated_k4, _f64_hidden, _inputs,
    _narrow_consensus, dw_fn, dx_fn, k4)

torch.set_num_threads(1)


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
    # widths the C entry does not take; a model of either width reaches it
    # zero-padded to 128 and 64 by the wrapper, at which it is taken
    assert call(d=96) != 0 and call(h=48) != 0
    padded = pad_last(x[..., :96], 128)
    assert call(x_ptr=padded.data_ptr(), row_stride=padded.stride(1)) == 0
    assert call(splits=0) != 0 and call(splits=2) != 0   # no split; splits without a workspace
    assert call(x_ptr=x.data_ptr() + 4) != 0             # x off a 16-byte boundary
    assert call(row_stride=x.stride(1) + 1) != 0         # rows off it


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


@pytest.mark.parametrize("n,L,d,dtype,extra", [
    (40, 2, 640, torch.float32, {}),           # a ragged key slab and query tile
    (40, 2, 640, torch.bfloat16, {"attend_self": True, "strided": True}),
    (36, 1, 1024, torch.float32, {"side": 6, "splits": 2}),   # the locality mask, radius 1.5
    (36, 1, 1024, torch.bfloat16, {"side": 6, "strided": True}),
    (64, 1, 640, torch.float32, {"attend_self": True, "splits": 2}),   # P V's keys over 2 blocks
    (25, 2, 1024, torch.bfloat16, {"splits": 2}),
])
def test_emulated_wide_k4_matches_plain(k4, n, L, d, dtype, extra):
    """The wide design (key scales and V^T, the logits through the
    workspace, the softmax, P V, with splits their ordered sum) against the
    plain consensus in float32 on the same inputs, out and lse; two runs give
    the same bits."""
    extra = dict(extra)
    side, strided = extra.pop("side", None), extra.pop("strided", False)
    mask = torch.from_numpy(local_consensus_mask(side, 1.5)) if side else None
    rng = np.random.default_rng(n + L + d)
    x = torch.from_numpy(rng.standard_normal((1, n, L + 1, d)).astype(np.float32)).to(dtype)
    levels = x[..., 1:, :] if strided else x[..., 1:, :].contiguous()
    out, lse = _emulated_k4(k4, levels, mask, **extra)
    want, want_lse = plain_cons.consensus_attention(
        levels.float(), attend_self=extra.get("attend_self", False), non_local_mask=mask)
    assert out.dtype == dtype
    _assert_close(out, want, dtype)
    _assert_close(lse, want_lse, torch.float32)
    again = _emulated_k4(k4, levels, mask, **extra)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.parametrize("b,n,L,d,want", [
    (4, 576, 8, 1024, 1),     # the large preset: 2,304 P V tiles, many waves
    (1, 2304, 8, 1024, 1),    # n=2304 (the K5 route)
    (1, 40, 2, 640, 2),       # 10 tiles of 2 slabs: one slab a block
    (1, 576, 1, 2048, 1),     # 144 tiles, over a wave of 132: no split fits one wave
])
def test_emulated_wide_k4_plans_splits_for_132_sms(k4, b, n, L, d, want):
    """glom_consensus_splits above d=512 on a card of 132 SMs, one block an
    SM (the emulator's device): tile_gemm.cuh's rule over P V's tiles."""
    assert k4[2](b, n, L, d, 0) == want


def test_emulated_k4_workspace_and_refusals(k4):
    """glom_consensus_workspace: the narrow kernel's split sums as before,
    the wide design's parts above 512; bad arguments refused; the wide
    design refuses a call without its workspace."""
    fn, ws_floats, plan = k4
    assert ws_floats(2, 8, 3, 512, 1, 0) == 0
    assert ws_floats(2, 8, 3, 512, 3, 0) == 3 * 2 * 8 * 3 * (512 + 2)
    # logits (b, L, n, 32-padded n), key scales, V^T in f32 or bf16, split sums
    f32 = 6 * 8 * 32 + 6 * 32 + 6 * 640 * 32
    assert ws_floats(2, 8, 3, 640, 1, 0) == f32
    assert ws_floats(2, 8, 3, 640, 1, 1) == f32 - 6 * 640 * 16
    assert ws_floats(2, 8, 3, 640, 2, 0) == f32 + 2 * 2 * 8 * 3 * 640
    for bad in ((2, 8, 3, 96, 1, 0), (2, 8, 3, 640, 0, 0), (2, 8, 3, 640, 1, 2), (0, 8, 3, 640, 1, 0)):
        assert ws_floats(*bad) < 0, bad
    assert plan(2, 8, 3, 96, 0) < 0 and plan(2, 8, 3, 640, 2) < 0
    levels = torch.zeros((2, 8, 3, 640))
    out, lse = torch.empty(levels.shape), torch.empty((2, 3, 8))
    assert fn(levels.data_ptr(), *levels.stride()[:3], None, out.data_ptr(), lse.data_ptr(),
              None, 2, 8, 3, 640, 640, 0, 1, 0, None) != 0
    ws = torch.zeros(ws_floats(2, 8, 3, 640, 1, 0))
    for width, ok in ((640, True), (600, True), (1, True), (0, False), (641, False)):
        code = fn(levels.data_ptr(), *levels.stride()[:3], None, out.data_ptr(), lse.data_ptr(),
                  ws.data_ptr(), 2, 8, 3, 640, width, 0, 1, 0, None)
        assert (code == 0) is ok, width


@pytest.mark.parametrize("attend_self,radius", [(False, 0), (True, 0), (False, 1.5)])
def test_emulated_k4_on_padded_levels_matches_glom_tpu(k4, attend_self, radius):
    """K4 on levels of a model 16 wide padded to 128, called with the true
    width (whose d^-1/2 scales the logits), sliced back, against glom_tpu's
    consensus kernel in interpret mode at d=16: out and lse."""
    levels, _, mask, _, want, want_lse = _narrow_consensus(22, attend_self, radius)
    out, lse = _emulated_k4(k4, pad_last(levels, padded_width(NARROW)), mask,
                            attend_self=attend_self, width=NARROW)
    assert not out[..., NARROW:].any()
    _assert_close(unpad(out, levels.shape), torch.from_numpy(np.array(want)), torch.float32)
    _assert_close(lse, torch.from_numpy(np.array(want_lse)).reshape(lse.shape), torch.float32)
