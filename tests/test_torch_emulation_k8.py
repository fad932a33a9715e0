"""K8 (``csrc/fused_update.cu``, the fused level update with K4's consensus
kernel inside: both nets' inputs, the epilogue, both split counts, the
planner, the refusals, the sum over the hidden against float64, and on the
inputs of a model 16 wide against ``glom_tpu``'s fused kernel in interpret
mode) run on the CPU through ``tests/cuda_emu/emulate.py`` against
``plain_update``.

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
    NARROW, _assert_close, _emulated_k8, _f64_update, _jnp, _k8_inputs, _narrow_ff, _t32, k8)

torch.set_num_threads(1)


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
    # d=640: the consensus stage is the wide design (csrc/consensus_wide.cuh)
    (1, 4, 2, 640, 64, torch.float32, {}),
    (1, 4, 2, 640, 64, torch.bfloat16, {"radius": 1.5, "key_splits": 2}),
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
             floats=ws.numel(), d=128, width=128, h=64, L=3, splits=1, dtype=0):
        return fn(lv.data_ptr(), sb, lv.stride(1), lv.stride(2), bot.data_ptr(), bot.stride(0),
                  bot.stride(1), pos.data_ptr(), pos.stride(1), w1.data_ptr(),
                  *(bu[k].data_ptr() for k in names[1:]), *(td[k].data_ptr() for k in names),
                  None, out.data_ptr(), ws_ptr, floats, 2, 4, L, d, width, h, 0, splits, 1, dtype,
                  None)

    assert call() == 0
    # the C entry takes d a multiple of 128 and h of 64; a model of any
    # other width reaches it zero-padded, its own width scaling the logits
    assert call(d=96, width=96) != 0 and call(h=96) != 0 and call(L=1) != 0   # widths, levels
    assert call(width=96) == 0 and call(width=16) == 0 and call(width=1) == 0
    assert call(width=0) != 0 and call(width=129) != 0    # the model's width: 1 to d
    assert call(splits=0) != 0 and call(splits=9) != 0
    assert call(ws_ptr=None) != 0 and call(floats=ws.numel() - 1) != 0   # no or short workspace
    assert call(dtype=2) != 0
    shifted = torch.zeros(levels.numel() + 4)[1:levels.numel() + 1].view(levels.shape)
    assert call(lv=shifted) != 0                          # levels off a 16-byte boundary
    assert call(sb=levels.stride(0) + 4) != 0             # (b, n) axes that do not flatten
    assert call(bot=torch.zeros(2, 4, 1, 130)[..., 1:129]) != 0   # bottom's rows off it
    off = torch.zeros(bu["w1"].numel() + 1)[1:].view(bu["w1"].shape)
    assert call(w1=off) != 0                              # w1 off a 16-byte boundary


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


@pytest.mark.parametrize("radius", [0, 1.5])
def test_emulated_k8_on_padded_inputs_matches_glom_tpu(k8, radius):
    """K8 on levels, bottom, pos and both nets of a model 16 wide (h 64)
    padded to 128, called with the true width, sliced back, against
    glom_tpu's fused level-update kernel in interpret mode at d=16."""
    from glom_tpu.kernels import fused_update_pallas

    rng = np.random.default_rng(24)
    b, side, L, h = 1, 4, 3, 4 * NARROW
    n = side * side
    bu, td = _narrow_ff(rng, L, h), _narrow_ff(rng, L - 1, h)
    lwi = _t32(rng, b, n, L + 1, NARROW)
    args = (bu, td, lwi[..., 1:, :], lwi[..., :1, :], _t32(rng, n, NARROW)[None, :, None, :])
    mask = torch.from_numpy(local_consensus_mask(side, radius)) if radius else None
    dp, hp = padded_width(NARROW), padded_hidden(h)
    padded = (pad_ff_params(bu, dp, hp), pad_ff_params(td, dp, hp),
              *(pad_last(t, dp) for t in args[2:]))
    got = _emulated_k8(k8, padded, mask, width=NARROW)
    assert not got[..., NARROW:].any()
    want = fused_update_pallas.fused_level_update(
        *({k: _jnp(v) for k, v in net.items()} for net in (bu, td)),
        *(_jnp(t.contiguous()) for t in args[2:]),
        non_local_mask=None if mask is None else _jnp(mask), interpret=True)
    _assert_close(unpad(got, args[2].shape), torch.from_numpy(np.array(want)), torch.float32)
