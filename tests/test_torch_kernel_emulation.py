"""The CUDA source of K2 (``csrc/grouped_ff_bwd.cu``'s dX kernel) run on the
CPU through ``tests/cuda_emu/emulate.py``, against the wrapper's plain
version on the same inputs.

The emulator compiles the kernel's own source with ``g++`` and runs every
CUDA thread of a block as a host thread, the tensor cores' products on
operands cut to tf32 as the card cuts them.  So these tests reach the
kernel's index arithmetic, fragment layouts, ragged row tiles, short hidden
chunks and its weight ring, which the CPU path of the wrapper (the plain
version) never does.  Limits as on the card (tests/test_torch_kernels.py):
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


def _inputs(rows, g, d, h, dtype, strided, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)

    params = {"w1": t(g, d, h, scale=d ** -0.5), "b1": t(g, h, scale=0.1),
              "w2": t(g, h, d, scale=h ** -0.5), "b2": t(g, d, scale=0.1)}
    lwi = t(1, rows, g + 1, d)
    x = lwi[..., :-1, :] if strided else lwi[..., 1:, :].contiguous()
    return params, x, t(1, rows, g, d)


def _emulated_dx(fn, params, x, dout, splits=1):
    b, n, g, d = x.shape
    h = params["w1"].shape[-1]
    dx = torch.empty((b, n, g, d), dtype=x.dtype)
    ws = torch.full((splits, b * n * g * d), float("nan")) if splits > 1 else None
    code = fn(x.data_ptr(), ff_kernel._row_stride(x), x.stride(2), params["w1"].data_ptr(),
              params["b1"].data_ptr(), params["w2"].data_ptr(), dout.data_ptr(), dx.data_ptr(),
              None if ws is None else ws.data_ptr(), b * n, g, d, h, splits,
              DTYPE_CODES[x.dtype], None)
    assert code == 0, code
    return dx


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
            params["b1"].data_ptr(), params["w2"].data_ptr(), dout.data_ptr(), dx.data_ptr(), None]
    assert dx_fn(*args, 8, 1, 96, 64, 1, 0, None) != 0        # d not a multiple of 128
    assert dx_fn(*args, 8, 1, 128, 48, 1, 0, None) != 0       # h not a multiple of 32
    assert dx_fn(*args, 8, 1, 128, 64, 0, 0, None) != 0       # no split
    assert dx_fn(*args, 8, 1, 128, 64, 2, 0, None) != 0       # splits without a workspace
    off = torch.zeros(params["w1"].numel() + 1)[1:]           # w1 off a 16-byte boundary
    args[3] = off.data_ptr()
    assert dx_fn(*args, 8, 1, 128, 64, 1, 0, None) != 0
