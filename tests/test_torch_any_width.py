"""Every kernel takes any width: the zero padding of ``kernels/_common.py``.

The CUDA kernels run d a multiple of 128 and h a multiple of 64; their
wrappers run a model of any other width on copies zero-padded to those and
slice the results back, passing the model's width for the consensus logits'
``d^-1/2``.  Here the same pad helpers are applied to host arrays and the
kernels' plain versions run on them: on the padded inputs, sliced back, each
must give what it gives at the true width, gradients included (relative
1e-6: the padding adds only zero terms).  The emulated kernels on padded
inputs are held against ``glom_tpu``'s interpret-mode kernels in
``tests/test_torch_kernel_emulation.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from glom_tpu_torch.kernels import _common
from glom_tpu_torch.kernels import fused_update
from glom_tpu_torch.ops import consensus as plain_cons
from glom_tpu_torch.ops import feedforward as plain_ff
from glom_tpu_torch.ops.masks import local_consensus_mask

torch.set_num_threads(1)

RTOL = 1e-6
WIDTHS = [8, 16, 64, 96]
HIDDENS = [32, 96]


def _rel(got, want):
    got, want = got.detach().double(), want.detach().double()
    assert got.shape == want.shape
    assert torch.linalg.vector_norm(got - want) <= RTOL * torch.linalg.vector_norm(want) + 1e-30


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _ff(rng, g, d, h):
    return {"w1": _t(rng, g, d, h, scale=d ** -0.5), "b1": _t(rng, g, h, scale=0.1),
            "w2": _t(rng, g, h, d, scale=h ** -0.5), "b2": _t(rng, g, d, scale=0.1)}


def test_padded_widths():
    assert [_common.padded_width(d) for d in (1, 8, 64, 127, 128, 129, 600, 640)] == [
        128, 128, 128, 128, 128, 256, 640, 640]
    assert [_common.padded_hidden(h) for h in (1, 32, 64, 96, 2048)] == [64, 64, 64, 128, 2048]
    assert all(_common.kernels_take(d) for d in (1, 8, 16, 64, 96, 600, 1024))
    assert not _common.kernels_take(0)
    with pytest.raises(ValueError, match="positive width"):
        _common.check_width("K1", 0)


def test_pad_helpers_copy_only_off_the_multiples():
    """Zero-padded fresh contiguous copies off the multiples, the tensor
    itself on them; unpad is the leading corner, contiguous."""
    x = torch.arange(2 * 3 * 16, dtype=torch.float32).view(2, 3, 16)[:, 1:]
    p = _common.pad_last(x, 128)
    assert p.shape == (2, 2, 128) and p.is_contiguous() and p.data_ptr() % 16 == 0
    assert torch.equal(p[..., :16], x) and not p[..., 16:].any()
    assert _common.pad_last(p, 128) is p
    assert torch.equal(_common.unpad(p, x.shape), x) and _common.unpad(p, p.shape) is p
    params = _ff(np.random.default_rng(0), 2, 16, 32)
    padded = _common.pad_ff_params(params, 128, 64)
    assert {k: tuple(v.shape) for k, v in padded.items()} == {
        "w1": (2, 128, 64), "b1": (2, 64), "w2": (2, 64, 128), "b2": (2, 128)}
    for k, v in params.items():
        assert torch.equal(_common.unpad(padded[k], v.shape), v)
        assert padded[k].count_nonzero() == v.count_nonzero()
    same = _common.pad_ff_params(padded, 128, 64)
    assert all(same[k] is padded[k] for k in padded)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("h", HIDDENS)
def test_grouped_ff_plain_on_padded_inputs(d, h):
    """K1's plain version on x and the parameters padded to (128, 64),
    sliced back, against it at the true widths; its VJP (what K2 and K3
    compute) through the padding against the VJP at the true widths; and
    the plain K2 and K3 on the padded inputs, sliced back."""
    rng = np.random.default_rng(d + h)
    g = 3
    params = {k: v.requires_grad_(True) for k, v in _ff(rng, g, d, h).items()}
    x = _t(rng, 2, 5, g, d).requires_grad_(True)
    dout = _t(rng, 2, 5, g, d)
    dp, hp = _common.padded_width(d), _common.padded_hidden(h)
    want = plain_ff.grouped_ff_apply(params, x)
    got = _common.unpad(plain_ff.grouped_ff_apply(_common.pad_ff_params(params, dp, hp),
                                                  _common.pad_last(x, dp)), want.shape)
    _rel(got, want)
    leaves = [x] + [params[k] for k in ("w1", "b1", "w2", "b2")]
    for a, b in zip(torch.autograd.grad(got, leaves, dout), torch.autograd.grad(want, leaves, dout)):
        _rel(a, b)
    with torch.no_grad():
        pp, px, pg = (_common.pad_ff_params(params, dp, hp), _common.pad_last(x, dp),
                      _common.pad_last(dout, dp))
        _rel(_common.unpad(plain_ff.grouped_ff_dx(pp, px, pg), x.shape),
             plain_ff.grouped_ff_dx(params, x, dout))
        hid, dh = plain_ff.grouped_ff_hidden(pp, px, pg)
        assert not hid[..., h:].any() and not dh[..., h:].any()
        got_dw = plain_ff.grouped_ff_dw_from_hidden(px, pg, hid, dh, torch.float32)
        want_dw = plain_ff.grouped_ff_dw_from_hidden(
            x, dout, *plain_ff.grouped_ff_hidden(params, x, dout), torch.float32)
        for a, b, k in zip(got_dw, want_dw, ("w1", "b1", "w2")):
            _rel(_common.unpad(a, params[k].shape), b)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("attend_self,radius", [(False, 0), (True, 0), (False, 1.5)])
def test_consensus_plain_on_padded_levels(d, attend_self, radius):
    """K4's plain version on levels padded to 128 with the model's width,
    sliced back, against it at the true width (out and lse); the gradient
    through the padding; K6's and K7's plain versions and the dS' K6 hands
    K7 likewise."""
    rng = np.random.default_rng(d)
    side = 4
    mask = torch.from_numpy(local_consensus_mask(side, radius)) if radius else None
    kw = dict(attend_self=attend_self, non_local_mask=mask)
    levels = _t(rng, 2, side * side, 3, d).requires_grad_(True)
    dout = _t(rng, *levels.shape)
    dp = _common.padded_width(d)
    want, want_lse = plain_cons.consensus_attention(levels, **kw)
    got, lse = plain_cons.consensus_attention(_common.pad_last(levels, dp), width=d, **kw)
    _rel(_common.unpad(got, levels.shape), want)
    _rel(lse, want_lse)
    (g_got,) = torch.autograd.grad(_common.unpad(got, levels.shape), levels, dout)
    (g_want,) = torch.autograd.grad(want, levels, dout)
    _rel(g_got, g_want)
    with torch.no_grad():
        lv, delta = levels.detach(), (dout * want).sum(-1).permute(0, 2, 1)[..., None]
        plv, pdo = _common.pad_last(lv, dp), _common.pad_last(dout, dp)
        _rel(_common.unpad(plain_cons.consensus_dkv(plv, pdo, want_lse, delta, width=d, **kw),
                           lv.shape), plain_cons.consensus_dkv(lv, dout, want_lse, delta, **kw))
        _rel(_common.unpad(plain_cons.consensus_dq(plv, pdo, want_lse, delta, width=d, **kw),
                           lv.shape), plain_cons.consensus_dq(lv, dout, want_lse, delta, **kw))
        ds = plain_cons.consensus_ds(plv, pdo, want_lse, delta, width=d, **kw)
        _rel(ds, plain_cons.consensus_ds(lv, dout, want_lse, delta, **kw))
        _rel(_common.unpad(plain_cons.consensus_dq_from_ds(plv, ds), lv.shape),
             plain_cons.consensus_dq_from_ds(lv, ds))
        # without the model's width the padded levels scale the logits by
        # the padded one: the trap the width argument closes
        wrong, _ = plain_cons.consensus_attention(plv, **kw)
        assert not torch.allclose(_common.unpad(wrong, lv.shape), want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("h", HIDDENS)
def test_fused_update_plain_on_padded_inputs(d, h):
    """K8's computation (the unfused composition in float32) on levels,
    bottom, pos and both nets padded to (128, 64), the consensus scaled by
    the model's width, sliced back, against plain_update at the true widths;
    and the gradient through the padding."""
    rng = np.random.default_rng(3 * d + h)
    b, side, L = 2, 3, 3
    n = side * side
    mask = torch.from_numpy(local_consensus_mask(side, 1.5))
    bu, td = _ff(rng, L, d, h), _ff(rng, L - 1, d, h)
    lwi = _t(rng, b, n, L + 1, d)
    levels, bottom = lwi[..., 1:, :].requires_grad_(False), lwi[..., :1, :]
    pos = _t(rng, n, d)[None, :, None, :]
    dp, hp = _common.padded_width(d), _common.padded_hidden(h)
    want = fused_update.plain_update(bu, td, levels, bottom, pos, mask)
    cons = functools.partial(plain_cons.consensus_attention, width=d)

    def padded_update(bu, td, levels, bottom, pos):
        return fused_update.reference_update(
            _common.pad_ff_params(bu, dp, hp), _common.pad_ff_params(td, dp, hp),
            *(_common.pad_last(t, dp) for t in (levels, bottom, pos)), mask, consensus_fn=cons)

    got = padded_update(bu, td, levels, bottom, pos)
    assert not got[..., d:].any()
    _rel(_common.unpad(got, levels.shape), want)
    leaves = [levels.clone().requires_grad_(True), bottom.clone().requires_grad_(True),
              pos.clone().requires_grad_(True)]
    bu_l = {k: v.clone().requires_grad_(True) for k, v in bu.items()}
    dout = _t(rng, *levels.shape)
    got = _common.unpad(padded_update(bu_l, td, *leaves), levels.shape)
    want = fused_update.reference_update(bu_l, td, *leaves, mask)
    wrt = leaves + list(bu_l.values())
    for a, c in zip(torch.autograd.grad(got, wrt, dout), torch.autograd.grad(want, wrt, dout)):
        _rel(a, c)


def test_demo_config_is_glom_tpus():
    """The demo model make_demo_checkpoint writes is glom_tpu's, 16 wide, in
    both packages: every field both configs have agrees (a dtype by its
    name)."""
    from glom_tpu.serving.engine import DEMO_CONFIG as JAX_DEMO

    from glom_tpu_torch.serving.engine import DEMO_CONFIG

    def plain(v):
        return getattr(v, "__name__", None) or str(v).replace("torch.", "")

    assert DEMO_CONFIG.dim == 16
    ref, port = dataclasses.asdict(JAX_DEMO), dataclasses.asdict(DEMO_CONFIG)
    shared = [k for k in ref if k in port]
    assert {"dim", "levels", "image_size", "patch_size", "param_dtype"} <= set(shared)
    assert {k: plain(port[k]) for k in shared} == {k: plain(ref[k]) for k in shared}
