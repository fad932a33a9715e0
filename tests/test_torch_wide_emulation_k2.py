"""K2 past d=512 on the CPU through ``tests/cuda_emu/emulate.py``:
``csrc/grouped_ff_bwd.cu``'s composition on the tiled product, with K3 on
the hidden it hands over, against the wrappers' plain versions on the same
inputs; its workspace, the refusals of bad arguments and K2's split
planner.

Limits as tests/test_torch_emulation_k2.py holds the narrow kernels:
||got - want|| <= rtol ||want|| and |got - want| <= rtol (min(1, max|want|)
+ |want|), rtol 1e-4 for float32 and 1e-2 for bfloat16 (one rounding); and
for float32 outputs, normwise within 1e-5 of the plain version.  The
fixtures and helpers are in ``tests/wide_emulation_common.py``.
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
from tests.wide_emulation_common import (  # noqa: F401 (fixtures)
    _assert_close, _emulated_k2, _emulated_k3, _ff_inputs, k23)

torch.set_num_threads(1)


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
