"""K2 (``csrc/grouped_ff_bwd.cu``'s dX kernel: ragged rows, strided views,
split hidden, its planner, the refusals, the hidden it stores against
float64) run on the CPU through ``tests/cuda_emu/emulate.py`` against the
wrapper's plain version.

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
    _check_case, _emulated_dx, _f64_hidden, _inputs, dx_fn)

torch.set_num_threads(1)


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


def test_emulated_k2_refuses_what_the_kernel_does_not_take(dx_fn):
    params, x, dout = _inputs(8, 1, 128, 64, torch.float32, False, seed=0)
    dx = torch.empty_like(x)
    args = [x.data_ptr(), x.stride(1), x.stride(2), params["w1"].data_ptr(),
            params["b1"].data_ptr(), params["w2"].data_ptr(), dout.data_ptr(), dx.data_ptr(), None,
            None, None]
    # the C entry takes d a multiple of 128 and h of 32 (a model of any other
    # width reaches it zero-padded by the wrapper: test_torch_any_width.py)
    assert dx_fn(*args, 8, 1, 96, 64, 1, 0, None) != 0        # d not a multiple of 128
    assert dx_fn(*args, 8, 1, 128, 48, 1, 0, None) != 0       # h not a multiple of 32
    # ... and takes a model 96 wide with h 48, zero-padded to 128 and 64
    narrow = {"w1": params["w1"][:, :96, :48], "b1": params["b1"][:, :48],
              "w2": params["w2"][:, :48, :96], "b2": params["b2"][:, :96]}
    pp = pad_ff_params(narrow, 128, 64)
    px, pg = pad_last(x[..., :96], 128), pad_last(dout[..., :96], 128)
    assert dx_fn(px.data_ptr(), px.stride(1), px.stride(2), pp["w1"].data_ptr(),
                 pp["b1"].data_ptr(), pp["w2"].data_ptr(), pg.data_ptr(), dx.data_ptr(), None,
                 None, None, 8, 1, 128, 64, 1, 0, None) == 0
    assert dx_fn(*args, 8, 1, 128, 64, 0, 0, None) != 0       # no split
    assert dx_fn(*args, 8, 1, 128, 64, 2, 0, None) != 0       # splits without a workspace
    hid = torch.zeros((1, 8, 64))
    args[9] = hid.data_ptr()                                  # hid without dh
    assert dx_fn(*args, 8, 1, 128, 64, 1, 0, None) != 0
    args[9] = None
    off = torch.zeros(params["w1"].numel() + 1)[1:]           # w1 off a 16-byte boundary
    args[3] = off.data_ptr()
    assert dx_fn(*args, 8, 1, 128, 64, 1, 0, None) != 0


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
