"""K6 and K7 (``csrc/consensus_bwd.cu``, the consensus backward, K6 handing K7
its dS': f32/bf16, attend_self, the mask, n off the tiles, strided levels,
d 128/384/512; the refusals; the drift over many queries and K7's dQ
against float64; and on levels of a model 16 wide against ``glom_tpu``'s
kernels in interpret mode) run on the CPU through
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
    NARROW, RTOL, _assert_close, _emulated_k67, _jnp, _k67_inputs, _narrow_consensus, k67)

torch.set_num_threads(1)


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

    def k6(lv=levels.data_ptr(), sn=levels.stride(1), d=128, width=None, dtype=0):
        return dkv_fn(lv, levels.stride(0), sn, levels.stride(2), g.data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), None, out.data_ptr(), ds.data_ptr(), None, 1, 8, 2, d,
                      d if width is None else width, 0, dtype, None)

    def k7(lv=levels.data_ptr(), ds_ptr=ds.data_ptr(), d=128):
        return dq_fn(lv, *levels.stride()[:3], ds_ptr, out.data_ptr(), 1, 8, 2, d, 0, None)

    assert k6() == 0 and k7() == 0
    # d=640 is the wide design's, which needs its workspace (the wide file's tests)
    assert k6(d=96) != 0 and k6(d=640) != 0 and k6(dtype=2) != 0 and k7(d=96) != 0
    # a model 96 or 16 wide reaches K6 zero-padded to 128, its own width
    # scaling the logits (K7's dS' carries the scale); the width is 1 to d
    assert k6(width=96) == 0 and k6(width=16) == 0
    assert k6(width=0) != 0 and k6(width=129) != 0
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


@pytest.mark.parametrize("attend_self,radius", [(False, 0), (True, 0), (False, 1.5)])
def test_emulated_k6_k7_on_padded_levels_match_glom_tpu(k67, attend_self, radius):
    """K6 (with the true width) and K7 on its dS', on levels and dO of a
    model 16 wide padded to 128, their sum sliced back, against glom_tpu's
    flash backward kernels in interpret mode at d=16."""
    from glom_tpu.kernels import consensus_pallas

    levels, g, mask, mask_i8, out, lse = _narrow_consensus(23, attend_self, radius)
    want = consensus_pallas._backward_flash(_jnp(levels), mask_i8, out, lse, _jnp(g),
                                            attend_self=attend_self, interpret=True)
    out_t = torch.from_numpy(np.array(out))
    lse_t = torch.from_numpy(np.array(lse)).reshape(1, 2, 25, 1).contiguous()
    delta = (g * out_t).sum(-1).permute(0, 2, 1)[..., None].contiguous()
    dp = padded_width(NARROW)
    dkv, ds, dq = _emulated_k67(k67, pad_last(levels, dp), pad_last(g, dp), lse_t, delta, mask,
                                attend_self=attend_self, width=NARROW)
    assert not dkv[..., NARROW:].any() and not dq[..., NARROW:].any()
    _assert_close(unpad(dkv + dq, levels.shape), torch.from_numpy(np.array(want)),
                  torch.float32)
