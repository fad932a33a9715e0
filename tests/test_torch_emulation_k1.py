"""K1 (``csrc/grouped_ff.cu``, the grouped-FF forward: its hidden and its
output; ragged rows and hidden tiles, K1b's split and its planner, the
refusals, the sum over the hidden against float64) run on the CPU through
``tests/cuda_emu/emulate.py`` against the wrapper's plain version, and on
the inputs of a model 16 wide zero-padded as the wrapper pads them against
``glom_tpu``'s kernel in interpret mode.

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
    NARROW, _assert_close, _emulated_k1, _inputs, _jnp, _narrow_ff, _plain_hidden, _t32, k1_fn)

torch.set_num_threads(1)


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
    # past the narrow widths: d=640, five output tiles a row tile, K1a's
    # depth 20 slabs
    (17, 2, 640, 64, torch.float32, True, 1),
    (9, 1, 640, 128, torch.bfloat16, False, 2),
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
    # d not a multiple of 128, h not of 64: the C entry refuses them, and a
    # model 64 wide (or with h 32) reaches it zero-padded by the wrapper, at
    # widths it takes
    assert call(d=64) != 0
    assert call(h=96) != 0
    padded = pad_last(x[..., :64], 128)
    assert call(x_ptr=padded.data_ptr(), row_stride=padded.stride(1)) == 0
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


def test_emulated_k1_on_padded_inputs_matches_glom_tpu(k1_fn):
    """K1 on x and the parameters of a model 16 wide with h 32, padded to
    128 and 64 as the wrapper pads them, sliced back, against glom_tpu's
    grouped-FF kernel in interpret mode at the true widths."""
    from glom_tpu.kernels.ff_pallas import grouped_ff_pallas

    rng = np.random.default_rng(21)
    params, x = _narrow_ff(rng, 2, 32), _t32(rng, 2, 9, 2, NARROW)
    padded = pad_ff_params(params, padded_width(NARROW), padded_hidden(32))
    got, hid = _emulated_k1(k1_fn, padded, pad_last(x, padded_width(NARROW)))
    assert not hid[..., 32:].any() and not got[..., NARROW:].any()
    want = grouped_ff_pallas({k: _jnp(v) for k, v in params.items()}, _jnp(x), interpret=True)
    _assert_close(unpad(got, x.shape), torch.from_numpy(np.array(want)), torch.float32)
