"""The port's fused level update (``ff_impl="fused"``) and the step's other
knobs (``fuse_ff``, ``remat``, ``attention_impl="auto"``) against glom_tpu on
the CPU.

The same seeded numpy weights, states, images and noise go through both
packages.  glom_tpu runs its fused Pallas kernel in interpret mode, as its own
tests/test_fused_update.py does; the port runs ``plain_update``, the
kernel's plain version, which CPU tensors take.  Float32 unless a test says
otherwise.  Tolerances: 1e-5 absolute for one update (summation order only),
1e-4 absolute over a forward of 2*L iterations, 1e-4 relative per leaf for
gradients; over a few optimizer steps the losses 1e-5 relative and the
parameters 1e-4 absolute, as tests/test_torch_training.py holds the unfused
step; one bfloat16 rounding for one update in bfloat16.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glom_tpu import config as jax_config
from glom_tpu.kernels import fused_update_pallas as jax_fused
from glom_tpu.models import glom as jax_glom
from glom_tpu.training import denoise as jax_denoise
from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch import convert
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.kernels import consensus as consensus_kernel
from glom_tpu_torch.kernels import ff as ff_kernel
from glom_tpu_torch.kernels import fused_update
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.ops.feedforward import grouped_ff_apply
from glom_tpu_torch.ops.masks import local_consensus_mask
from glom_tpu_torch.serving.engine import ServingEngine, demo_params, make_demo_checkpoint
from glom_tpu_torch.training import denoise, optim, train

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

OP_ATOL = 1e-5
FWD_ATOL = 1e-4
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _img(b=2, seed=1):
    return np.random.default_rng(seed).standard_normal((b, 3, 16, 16)).astype(np.float32)


def _tree(config, seed=0):
    return demo_params(config, TrainConfig(), seed)


def _flat(tree):
    return ckpt_lib.flatten({"p": jax.tree_util.tree_map(np.asarray, tree)})


def _assert_tree_rel(got, want, rtol):
    """Per leaf: |got - want| / |want| <= rtol (Frobenius norms)."""
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for k in w:
        err = np.linalg.norm(g[k] - w[k]) / max(np.linalg.norm(w[k]), 1e-30)
        assert err <= rtol, (k, err)


def _update_case(attend_self=False, use_mask=False, seed=0, b=2):
    """One update's inputs as numpy: the two nets' weights, levels, the
    tokens, the positional embeddings and the locality mask."""
    c = GlomConfig(**TINY, consensus_self=attend_self,
                   local_consensus_radius=1 if use_mask else 0)
    tree = _tree(c, seed)["glom"]
    rng = np.random.default_rng(seed + 10)
    levels = rng.standard_normal((b, c.num_patches, c.levels, c.dim)).astype(np.float32)
    bottom = rng.standard_normal((b, c.num_patches, 1, c.dim)).astype(np.float32)
    pos = tree["pos_emb"][None, :, None, :]
    mask = local_consensus_mask(c.num_patches_side, 1) if use_mask else None
    return c, tree["bottom_up"], tree["top_down"], levels, bottom, pos, mask


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return None if tree is None else torch.from_numpy(np.ascontiguousarray(tree))


def _port_apply(config, tree, img, **kw):
    params = convert.params_from_numpy(tree, config, "cpu")
    with torch.inference_mode():
        out = glom_model.apply(params, torch.from_numpy(img), config=config, **kw)
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


# -- one update ---------------------------------------------------------------

@pytest.mark.parametrize("attend_self,use_mask", [
    (False, False), (True, False), (False, True), (True, True),
])
def test_fused_level_update_matches_pallas(attend_self, use_mask):
    _, bu, td, levels, bottom, pos, mask = _update_case(attend_self, use_mask)
    want = jax_fused.fused_level_update(
        _jnp(bu), _jnp(td), jnp.asarray(levels), jnp.asarray(bottom), jnp.asarray(pos),
        attend_self=attend_self, non_local_mask=None if mask is None else jnp.asarray(mask))
    before = fused_update.fused_level_update.launches
    with torch.inference_mode():
        got = fused_update.fused_level_update(
            _t(bu), _t(td), _t(levels), _t(bottom), _t(pos), attend_self=attend_self,
            non_local_mask=_t(mask))
    assert got.shape == levels.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_ATOL)
    # only a launch on the card counts
    assert fused_update.fused_level_update.launches == before


@pytest.mark.parametrize("use_mask,ff_fused_bwd", [(False, False), (False, True), (True, True)])
def test_fused_level_update_grads_match_jax_vjp(use_mask, ff_fused_bwd):
    """The gradients of all five inputs against jax.vjp of glom_tpu's custom
    VJP, for a random cotangent."""
    _, bu, td, levels, bottom, pos, mask = _update_case(False, use_mask, seed=3)
    g = np.random.default_rng(7).standard_normal(levels.shape).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(
        lambda *a: jax_fused.fused_level_update(*a, non_local_mask=jmask, ff_fused_bwd=ff_fused_bwd),
        _jnp(bu), _jnp(td), jnp.asarray(levels), jnp.asarray(bottom), jnp.asarray(pos))
    want = dict(zip(("bu", "td", "levels", "bottom", "pos"), vjp(jnp.asarray(g))))

    leaves = {"bu": _t(bu), "td": _t(td), "levels": _t(levels), "bottom": _t(bottom),
              "pos": _t(pos)}
    leaves = glom_model.tree_map(lambda t: t.requires_grad_(True), leaves)
    out = fused_update.fused_level_update(
        leaves["bu"], leaves["td"], leaves["levels"], leaves["bottom"], leaves["pos"],
        non_local_mask=_t(mask), ff_fused_bwd=ff_fused_bwd)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    _assert_tree_rel(glom_model.tree_map(lambda t: t.grad.numpy(), leaves), want, GRAD_RTOL)


def test_fused_level_update_is_reference_update_on_the_cpu():
    """CPU tensors take the plain version, with and without autograd: in
    float32 reference_update bit for bit; in bfloat16 the composition on
    float32 copies rounded once, as glom_tpu's kernel computes.  The
    Function's gradient is still the composition's own."""
    _, bu, td, levels, bottom, pos, mask = _update_case(False, True, seed=5)
    args = (_t(bu), _t(td), _t(levels), _t(bottom), _t(pos))
    want = fused_update.reference_update(*args, _t(mask))
    with torch.no_grad():
        got = fused_update.fused_level_update(*args, non_local_mask=_t(mask))
        torch.testing.assert_close(got, want, atol=0, rtol=0)
        bf = [glom_model.tree_map(lambda t: t.to(torch.bfloat16), a) for a in args]
        got_bf = fused_update.fused_level_update(*bf, non_local_mask=_t(mask))
        f32 = [glom_model.tree_map(lambda t: t.float(), a) for a in bf]
        want_bf = fused_update.reference_update(*f32, _t(mask)).to(torch.bfloat16)
    assert got_bf.dtype == torch.bfloat16
    torch.testing.assert_close(got_bf, want_bf, atol=0, rtol=0)
    assert not torch.equal(got_bf, fused_update.reference_update(*bf, _t(mask)))
    lv = args[2].clone().requires_grad_(True)
    ref = args[2].clone().requires_grad_(True)
    fused_update.fused_level_update(args[0], args[1], lv, args[3], args[4],
                                    non_local_mask=_t(mask)).sum().backward()
    fused_update.reference_update(args[0], args[1], ref, args[3], args[4], _t(mask)).sum().backward()
    torch.testing.assert_close(lv.grad, ref.grad, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("use_mask", [False, True])
def test_fused_level_update_bf16_matches_glom_tpu(use_mask):
    """bfloat16: the port's fused update on the CPU against glom_tpu's fused
    kernel in interpret mode on the same inputs.  Both widen every input to
    float32, sum in float32 and round once, so they agree to within one
    bfloat16 rounding of each value, 2**-8 |want|."""
    _, bu, td, levels, bottom, pos, mask = _update_case(False, use_mask, seed=21)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = jax_fused.fused_level_update(
        jax.tree_util.tree_map(bf, bu), jax.tree_util.tree_map(bf, td), bf(levels), bf(bottom),
        bf(pos), non_local_mask=None if mask is None else jnp.asarray(mask))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    tb = lambda a: glom_model.tree_map(lambda t: t.to(torch.bfloat16), _t(a))
    with torch.inference_mode():
        got = fused_update.fused_level_update(tb(bu), tb(td), tb(levels), tb(bottom), tb(pos),
                                              non_local_mask=_t(mask))
    assert got.dtype == torch.bfloat16 and got.shape == levels.shape
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= 2.0 ** -8 * np.abs(want)).all(), (diff.max(), int((diff > 0).sum()))


def test_fused_level_update_only_differentiates_what_asks():
    """A gradient is returned for the inputs that require one and None for
    the rest (frozen weights, a carried state without a graph)."""
    _, bu, td, levels, bottom, pos, _ = _update_case(seed=6)
    tbu, ttd = _t(bu), _t(td)
    ttd["w1"].requires_grad_(True)
    out = fused_update.fused_level_update(tbu, ttd, _t(levels), _t(bottom), _t(pos))
    out.sum().backward()
    assert ttd["w1"].grad is not None and torch.isfinite(ttd["w1"].grad).all()
    assert all(t.grad is None for t in tbu.values()) and ttd["b2"].grad is None


# -- the kernel wrapper's checks (what a CUDA tensor must satisfy) -------------

def _good_update(d=128, L=3, n=8, h=256, dtype=torch.float32):
    def ff(g):
        return {"w1": torch.zeros((g, d, h), dtype=dtype), "b1": torch.zeros((g, h), dtype=dtype),
                "w2": torch.zeros((g, h, d), dtype=dtype), "b2": torch.zeros((g, d), dtype=dtype)}

    lwi = torch.zeros((2, n, L + 1, d), dtype=dtype)
    return {"bu": ff(L), "td": ff(L - 1), "levels": lwi[..., 1:, :], "bottom": lwi[..., :1, :],
            "pos": torch.zeros((n, d), dtype=dtype)[None, :, None, :], "mask": None}


def test_fused_check_accepts_the_main_path_views():
    """Strided views of one (b, n, L+1, d) buffer and the (1, n, 1, d) view of
    pos_emb pass: the kernel reads them through their strides."""
    fused_update._check(**_good_update())
    fused_update._check(**_good_update(d=512, L=6, h=2048, dtype=torch.bfloat16))


@pytest.mark.parametrize("case", [
    "dtype", "param_dtype", "dim", "dim_large", "hidden", "levels", "rank", "bottom_shape",
    "pos_shape", "param_shape", "td_groups", "last_stride", "misaligned", "misaligned_weight",
    "mask_shape", "mask_dtype",
])
def test_fused_check_refuses(case):
    a = _good_update()
    err = ValueError
    if case == "dtype":
        a, err = _good_update(dtype=torch.float16), TypeError
    elif case == "param_dtype":
        a["bu"]["w2"], err = a["bu"]["w2"].bfloat16(), TypeError
    elif case == "dim":
        # any positive width: off a multiple of 128 the wrapper pads every
        # input (whose layout is then not the caller's concern)
        for d in (8, 16, 64, 96):
            fused_update._check(**_good_update(d=d, h=4 * d))
        views = _good_update(d=96)
        views["levels"] = torch.zeros((2, 8, 96, 3)).transpose(2, 3)
        fused_update._check(**views)
        a = _good_update(d=0, h=128)
    elif case == "dim_large":
        # K8's forward takes every width past 512 too (its consensus stage
        # the wide design), a multiple of 128 or padded to one
        for d in (600, 640, 1000, 1024):
            fused_update._check(**_good_update(d=d, h=128))
        a = _good_update(d=0, h=128)
    elif case == "hidden":
        for h in (32, 96, 200):
            fused_update._check(**_good_update(h=h))
        a = _good_update(h=0)
    elif case == "levels":
        a = _good_update(L=1)
    elif case == "rank":
        a["levels"] = a["levels"][0]
    elif case == "bottom_shape":
        a["bottom"] = torch.zeros((2, 8, 2, 128))
    elif case == "pos_shape":
        a["pos"] = torch.zeros((2, 8, 1, 128))
    elif case == "param_shape":
        a["bu"]["b1"] = a["bu"]["b1"][:, :-1]
    elif case == "td_groups":
        a["td"] = a["bu"]
    elif case == "last_stride":
        a["levels"] = torch.zeros((2, 8, 128, 3)).transpose(2, 3)
    elif case == "misaligned":
        # not refused: rows off the kernels' 16-byte boundary, or (b, n) axes
        # that do not flatten, are copied into fresh storage, as glom_tpu's
        # kernel takes any layout
        for offset in (1, 2, 3):
            flat = torch.arange(2 * 8 * 4 * 128 + offset, dtype=torch.float32)
            views = {"levels": flat[offset:].view(2, 8, 4, 128)[..., 1:, :],
                     "bottom": flat[offset:].view(2, 8, 4, 128)[..., :1, :],
                     "pos": flat[offset:offset + 8 * 128].view(1, 8, 1, 128)}
            views["levels"] = views["levels"][:, :, :3]
            fused_update._check(**{**a, **views})
            for name, t in views.items():
                assert not fused_update._rows_aligned(t), name
                copy = fused_update._kernel_input(t)
                assert torch.equal(copy, t) and copy.data_ptr() != t.data_ptr()
                assert fused_update._rows_aligned(copy) and copy.data_ptr() % 16 == 0
        unflat = torch.zeros(2, 9, 3, 128)[:, :8]        # aligned, but b does not step over n
        assert not fused_update._rows_aligned(unflat)
        assert fused_update._rows_aligned(fused_update._kernel_input(unflat))
        # the main path's views of an aligned state are read as they lie
        state = torch.zeros(2, 8, 4, 128)
        for t in (state[..., 1:, :], state[..., :1, :], torch.zeros(8, 128)[None, :, None, :]):
            assert fused_update._kernel_input(t) is t
        return
    elif case == "misaligned_weight":
        w = a["td"]["w1"]
        a["td"]["w1"] = torch.zeros(w.numel() + 1)[1:].view(w.shape)
    elif case == "mask_shape":
        a["mask"] = torch.zeros((8, 7), dtype=torch.bool)
    else:
        a["mask"], err = torch.zeros((8, 8), dtype=torch.float32), TypeError
    with pytest.raises(err):
        fused_update._check(**a)


def test_fused_wrapper_refuses_other_devices():
    """Neither a CUDA nor a CPU tensor: no plain-version fallback either."""
    a = _good_update()
    meta = {k: glom_model.tree_map(lambda t: t.to("meta"), v) for k, v in a.items() if k != "mask"}
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_update.fused_level_update(meta["bu"], meta["td"], meta["levels"], meta["bottom"],
                                        meta["pos"])


# -- the dispatch ---------------------------------------------------------------

def test_supports_config_predicates():
    c = GlomConfig(**TINY, ff_impl="fused")
    ref = jax_config.GlomConfig(**TINY, ff_impl="fused")
    # on the CPU only the bound on n applies, as in glom_tpu's interpret mode
    assert fused_update.supports_config(c) and jax_fused.supports_config(ref, interpret=True)
    assert glom_model.fused_update_supported(c) and jax_glom.fused_update_supported(ref)
    big = dict(dim=32, levels=3, image_size=8 * 40, patch_size=8, ff_impl="fused")   # n = 1600
    assert not fused_update.supports_config(GlomConfig(**big))
    assert not jax_fused.supports_config(jax_config.GlomConfig(**big), interpret=True)
    assert not glom_model.fused_update_supported(GlomConfig(**big), "cuda")
    # fuse_ff is a competing fusion, and another ff_impl never takes the fused step
    assert not glom_model.fused_update_supported(dataclasses.replace(c, fuse_ff=True))
    assert not glom_model.fused_update_supported(dataclasses.replace(c, ff_impl="pallas"))
    # on a CUDA device any width: the wrapper pads one off the kernels'
    # multiples (glom_tpu's predicate, in interpret mode, takes any too)
    assert fused_update.supports_config(c, "cuda")
    for dim, ok in ((128, True), (384, True), (512, True), (640, True), (1024, True), (96, True),
                    (600, True), (16, True), (8, True)):
        wide = GlomConfig(dim=dim, levels=3, image_size=64, patch_size=8, ff_impl="fused")
        assert fused_update.supports_config(wide, "cuda") is ok
        assert glom_model.fused_update_supported(wide, torch.device("cuda")) is ok


def test_fallback_resolves_attention_by_the_auto_policy(monkeypatch):
    """When ff_impl='fused' falls back (fuse_ff defeats the predicate), the
    default attention_impl='dense' resolves by 'auto'; an explicit choice is
    honoured; glom_tpu does the same."""
    c = GlomConfig(**TINY, ff_impl="fused", fuse_ff=True)
    assert not glom_model.fused_update_supported(c)
    seen = []
    real = glom_model.make_consensus_fn
    monkeypatch.setattr(glom_model, "make_consensus_fn",
                        lambda cfg, device=None: seen.append(cfg.attention_impl) or real(cfg, device))
    tree = _tree(c)["glom"]
    img = _img()
    out = _port_apply(c, tree, img, iters=1)
    assert seen == ["auto"]
    # 'auto' is dense on the CPU: bitwise the explicitly unfused composition
    want = _port_apply(dataclasses.replace(c, ff_impl="pallas"), tree, img, iters=1)
    np.testing.assert_array_equal(out, want)
    seen.clear()
    _port_apply(dataclasses.replace(c, attention_impl="pallas"), tree, img, iters=1)
    assert seen == ["pallas"]
    seen.clear()
    # the fused step itself resolves no consensus at all
    _port_apply(dataclasses.replace(c, fuse_ff=False), tree, img, iters=1)
    assert seen == []


def test_injected_override_wins_over_fused():
    calls = []

    def spy_ff(params, x):
        calls.append(tuple(x.shape))
        return grouped_ff_apply(params, x)

    c = GlomConfig(**TINY, ff_impl="fused")
    tree = _tree(c)["glom"]
    got = _port_apply(c, tree, _img(), iters=2, ff_fn=spy_ff)
    assert len(calls) == 4, "the injected ff_fn was not called: the fused dispatch ate it"
    np.testing.assert_array_equal(got, _port_apply(c, tree, _img(), iters=2))
    # an injected fused_fn is the step
    seen = []

    def spy_fused(bu, td, levels, bottom, pos):
        seen.append(tuple(levels.shape))
        return fused_update.fused_level_update(bu, td, levels, bottom, pos)

    plain = GlomConfig(**TINY)
    np.testing.assert_array_equal(_port_apply(plain, tree, _img(), iters=2, fused_fn=spy_fused), got)
    assert len(seen) == 2


@pytest.mark.parametrize("n_side", [4, 40])
def test_auto_attention_is_dense_on_the_cpu(n_side):
    """Below and above every measured crossover: off the card always dense."""
    c = GlomConfig(dim=32, levels=3, image_size=4 * n_side, patch_size=4, attention_impl="auto")
    assert glom_model.resolve_auto_attention(c) == "dense"
    assert glom_model.resolve_auto_attention(c, torch.device("cpu")) == "dense"
    if n_side == 4:
        tree = _tree(c)["glom"]
        img = _img()
        got = _port_apply(c, tree, img, iters=3)
        want = _port_apply(dataclasses.replace(c, attention_impl="dense"), tree, img, iters=3)
        np.testing.assert_array_equal(got, want)


def test_auto_attention_on_a_cuda_device_follows_the_measured_row(monkeypatch):
    """Above the generation's row the kernels, at any width (no width term,
    as in glom_tpu's rule); an unmeasured generation of the kernels' compute capability
    warns and borrows the H100's row; a card of another capability, which
    cannot load the kernels, gets the plain ops."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (9, 0))
    assert glom_model.gpu_generation("cuda") == "H100"
    row = glom_model.ATTENTION_CROSSOVER_N["H100"]
    side = int(row ** 0.5) + 1
    above = GlomConfig(dim=128, levels=3, image_size=8 * side, patch_size=8, attention_impl="auto")
    assert above.num_patches > row
    assert glom_model.resolve_auto_attention(above, "cuda") == "pallas"
    narrow = dataclasses.replace(above, dim=32)
    assert glom_model.resolve_auto_attention(narrow, "cuda") == "pallas"
    if row >= 4:
        below = GlomConfig(dim=128, levels=3, image_size=16, patch_size=8, attention_impl="auto")
        assert glom_model.resolve_auto_attention(below, "cuda") == "dense"
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H200")
    with pytest.warns(UserWarning, match="crossover"):
        assert glom_model.resolve_auto_attention(above, "cuda") == "pallas"
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA B200")
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (10, 0))
    big = dataclasses.replace(above, image_size=8 * 64)
    assert glom_model.resolve_auto_attention(big, "cuda") == "dense"


# -- the forward ------------------------------------------------------------------

@pytest.mark.parametrize("case", [{}, {"consensus_self": True}, {"local_consensus_radius": 1}])
def test_apply_fused_matches_glom_tpu(case):
    port = GlomConfig(**TINY, ff_impl="fused", **case)
    ref = jax_config.GlomConfig(**TINY, ff_impl="fused", **case)
    tree = _tree(port)["glom"]
    img = _img()
    want = jax_glom.apply(_jnp(tree), jnp.asarray(img), config=ref)      # 2 * L iterations
    got = _port_apply(port, tree, img)
    np.testing.assert_allclose(got, np.asarray(want), atol=FWD_ATOL)
    # on the CPU the fused step is the unfused kernels' path bit for bit
    unfused = dataclasses.replace(port, ff_impl="pallas", attention_impl="pallas")
    np.testing.assert_array_equal(got, _port_apply(unfused, tree, img))


def test_apply_fuse_ff_matches_glom_tpu_and_the_two_calls():
    port = GlomConfig(**TINY, ff_impl="pallas", attention_impl="pallas", fuse_ff=True)
    ref = jax_config.GlomConfig(**TINY, fuse_ff=True)
    tree = _tree(port)["glom"]
    img = _img()
    want = jax_glom.apply(_jnp(tree), jnp.asarray(img), config=ref)
    got = _port_apply(port, tree, img)
    np.testing.assert_allclose(got, np.asarray(want), atol=FWD_ATOL)
    two_calls = _port_apply(dataclasses.replace(port, fuse_ff=False), tree, img)
    np.testing.assert_allclose(got, two_calls, atol=1e-6)


def test_fuse_ff_runs_one_grouped_call_of_2L_minus_1_groups():
    shapes = []

    def spy_ff(params, x):
        shapes.append((tuple(params["w1"].shape), tuple(x.shape)))
        return grouped_ff_apply(params, x)

    c = GlomConfig(**TINY, fuse_ff=True)
    _port_apply(c, _tree(c)["glom"], _img(), iters=2, ff_fn=spy_ff)
    assert shapes == [((5, 32, 128), (2, 16, 5, 32))] * 2


def _loss_and_grads(config, tree, img, t, iters):
    params = glom_model.tree_map(lambda p: p.requires_grad_(True),
                                 convert.params_from_numpy(tree, config, "cpu"))
    final, captured = glom_model.apply(params, torch.from_numpy(img), config=config,
                                       iters=iters, capture_timestep=t)
    loss = (captured ** 2).mean() + (final ** 2).mean()
    loss.backward()
    return loss.item(), glom_model.tree_map(lambda p: p.grad.numpy(), params)


@pytest.mark.parametrize("ff_impl,policy", [("fused", "full"), ("fused", "dots"), ("pallas", "dots"),
                                            ("dense", "dots"), ("dense", "full")])
def test_remat_gives_the_unwrapped_steps_loss_and_gradients(policy, ff_impl):
    """remat=True under both policies, with capture_timestep: the loss and
    the gradients of remat=False, and glom_tpu's under the same knobs.  With
    ff_impl='fused' the checkpointed step is the fused update's autograd
    Function, recomputed inside torch.utils.checkpoint; with 'dense' and
    'dots' the backward reads the products' outputs that selective
    checkpointing kept."""
    kw = dict(ff_impl=ff_impl, ff_fused_bwd=True, remat=True, remat_policy=policy)
    if ff_impl == "pallas":
        kw["attention_impl"] = "pallas"
    port = GlomConfig(**TINY, **kw)
    ref = jax_config.GlomConfig(**TINY, **kw)
    tree = _tree(port, seed=2)["glom"]
    img = _img()

    def jax_loss(p):
        final, captured = jax_glom.apply(p, jnp.asarray(img), config=ref, iters=4,
                                         capture_timestep=2)
        return (captured ** 2).mean() + (final ** 2).mean()

    want_loss, want = jax.value_and_grad(jax_loss)(_jnp(tree))
    loss, grads = _loss_and_grads(port, tree, img, 2, 4)
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)
    _assert_tree_rel(grads, want, GRAD_RTOL)
    plain_loss, plain_grads = _loss_and_grads(dataclasses.replace(port, remat=False), tree, img, 2, 4)
    assert loss == plain_loss
    _assert_tree_rel(grads, plain_grads, 1e-6)


def test_remat_is_skipped_without_autograd():
    """The serving forward (inference mode) runs a remat config unwrapped."""
    c = GlomConfig(**TINY, ff_impl="fused", remat=True)
    tree = _tree(c)["glom"]
    np.testing.assert_array_equal(_port_apply(c, tree, _img()),
                                  _port_apply(dataclasses.replace(c, remat=False), tree, _img()))


# -- the train step -----------------------------------------------------------------

@pytest.mark.parametrize("extra", [{"remat": True}])
def test_fused_train_steps_match_glom_tpu(extra):
    """Three steps of glom_tpu's jitted step with ff_impl='fused' (its Pallas
    kernel in interpret mode, fused FF backward) against the port's, on the
    same weights, images and noise."""
    steps = 3
    kw = dict(ff_impl="fused", ff_fused_bwd=True, **extra)
    port_cfg, ref_cfg = GlomConfig(**TINY, **kw), jax_config.GlomConfig(**TINY, **kw)
    port_train = TrainConfig(batch_size=2, steps=steps)
    ref_train = jax_config.TrainConfig(batch_size=2, steps=steps)
    tree = demo_params(port_cfg, port_train, seed=4)

    import optax

    tx = optax.adam(ref_train.learning_rate)
    state = jax_denoise.init_state(jax.random.PRNGKey(0), ref_cfg, tx)
    params = _jnp(tree)
    state = jax_denoise.DenoiseState(params, tx.init(params), state.step, state.rng)
    jax_step = jax.jit(jax_denoise.make_step_fn(ref_cfg, ref_train, tx))

    optimizer = optim.Optimizer.from_config(port_train)
    p = convert.params_from_numpy(tree, port_cfg, "cpu")
    port = denoise.DenoiseState(p, optimizer.init(p), 0, torch.Generator())
    port_step = denoise.make_step_fn(port_cfg, port_train, optimizer)

    imgs = np.random.default_rng(9).standard_normal((steps, 2, 3, 16, 16)).astype(np.float32)
    want_losses, got_losses = [], []
    for i in range(steps):
        _, rng_noise = jax.random.split(state.rng)   # the noise glom_tpu's step will draw
        noise = np.array(jax.random.normal(rng_noise, imgs[i].shape, jnp.float32))
        state, m = jax_step(state, jnp.asarray(imgs[i]))
        port, pm = port_step(port, torch.from_numpy(imgs[i]), noise=torch.from_numpy(noise))
        want_losses.append(float(m["loss"]))
        got_losses.append(pm["loss"].item())
        np.testing.assert_allclose(pm["grad_norm"].item(), float(m["grad_norm"]), rtol=GRAD_RTOL)
    np.testing.assert_allclose(got_losses, want_losses, rtol=LOSS_RTOL)
    g = _flat(glom_model.tree_map(lambda t: t.detach().numpy(), port.params))
    w = _flat(state.params)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=PARAM_ATOL, err_msg=k)


def test_step_fn_threads_an_injected_fused_fn():
    """make_loss_fn / make_step_fn hand consensus_fn, ff_fn and fused_fn to
    apply as they are, as glom_tpu's do."""
    cfg, train_cfg = GlomConfig(**TINY), TrainConfig(batch_size=2)
    seen = []

    def spy_fused(bu, td, levels, bottom, pos):
        seen.append(1)
        return fused_update.fused_level_update(bu, td, levels, bottom, pos)

    optimizer = optim.Optimizer.from_config(train_cfg)
    p = convert.params_from_numpy(demo_params(cfg, train_cfg, 1), cfg, "cpu")
    st = denoise.DenoiseState(p, optimizer.init(p), 0, torch.Generator())
    noise = torch.from_numpy(_img(seed=4))
    _, m = denoise.make_step_fn(cfg, train_cfg, optimizer, fused_fn=spy_fused)(
        st, torch.from_numpy(_img()), noise=noise)
    _, want = denoise.make_step_fn(cfg, train_cfg, optimizer)(st, torch.from_numpy(_img()), noise=noise)
    assert len(seen) == denoise.resolve_loss_timestep(train_cfg, cfg.default_iters)
    np.testing.assert_allclose(m["loss"].item(), want["loss"].item(), rtol=1e-6)


def test_train_cli_runs_fused_remat_and_fuse_ff(tmp_path):
    base = ["--dim", "32", "--levels", "3", "--image-size", "16", "--patch-size", "4",
            "--batch-size", "2", "--steps", "2", "--log-every", "1", "--device", "cpu"]
    fused = train.main(base + ["--ff-impl", "fused", "--fused-ff-bwd", "--remat",
                               "--remat-policy", "full", "--checkpoint-dir", str(tmp_path),
                               "--checkpoint-every", "2"])
    with open(tmp_path / "config.json") as f:
        recorded = json.load(f)["glom"]
    assert (recorded["ff_impl"], recorded["remat"], recorded["remat_policy"]) == ("fused", True, "full")
    unfused = train.main(base + ["--ff-impl", "pallas", "--fused-ff-bwd", "--attention-impl", "auto",
                                 "--fuse-ff"])
    assert np.isfinite(fused["loss"])
    np.testing.assert_allclose(fused["loss"], unfused["loss"], rtol=1e-5)


# -- serving ------------------------------------------------------------------------

def test_engine_serves_fused_as_it_serves_pallas(tmp_path):
    d = str(tmp_path)
    make_demo_checkpoint(d, config=GlomConfig(**TINY),
                         train=TrainConfig(batch_size=2, steps=0, decoder="mlp"), seed=7)
    fused = ServingEngine(d, device="cpu", ff_impl="fused")
    pallas = ServingEngine(d, device="cpu", ff_impl="pallas", attention_impl="pallas")
    assert fused.health()["ff_impl"] == "fused" and pallas.health()["ff_impl"] == "pallas"
    # the fused step applies: nothing else is injected into the forward
    assert fused._fused_fn is not None and fused._consensus_fn is None and fused._ff_fn is None
    assert pallas._fused_fn is None
    imgs = np.random.default_rng(0).standard_normal((3, 3, 16, 16)).astype(np.float32)
    for endpoint in ("embed", "reconstruct"):
        np.testing.assert_array_equal(fused.run(endpoint, imgs), pallas.run(endpoint, imgs))
    # a shape the fused step does not take falls back to the unfused kernels
    big = str(tmp_path / "big")
    make_demo_checkpoint(big, config=GlomConfig(dim=32, levels=2, image_size=132, patch_size=4))
    engine = ServingEngine(big, device="cpu", ff_impl="fused", buckets=(1,))   # n = 1089
    assert engine._fused_fn is None and engine._ff_fn is not None


def test_server_cli_takes_ff_impl_fused(tmp_path):
    """``python -m glom_tpu_torch.serving.server --ff-impl fused --device cpu``
    serves, reports the choice on its ``serving`` line, and drains."""
    import urllib.request

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "glom_tpu_torch.serving.server", "--checkpoint-dir",
         str(tmp_path / "ckpt"), "--demo", "--device", "cpu", "--port", "0", "--ff-impl", "fused"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=str(tmp_path))
    try:
        info = {}
        for line in proc.stdout:
            info = json.loads(line)
            if info["event"] == "serving":
                break
        assert info.get("event") == "serving", proc.stderr.read()
        assert info["ff_impl"] == "fused"
        img = np.random.default_rng(1).standard_normal(
            (2, info["channels"], info["image_size"], info["image_size"])).astype(np.float32)
        req = urllib.request.Request(
            "http://127.0.0.1:%d/embed" % info["port"], data=json.dumps({"images": img.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = np.asarray(json.loads(resp.read())["embeddings"], np.float32)
        proc.terminate()
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    want = ServingEngine(str(tmp_path / "ckpt"), device="cpu", ff_impl="pallas",
                         attention_impl="pallas").run("embed", img)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_counters_do_not_move_on_the_cpu():
    c = GlomConfig(**TINY, ff_impl="fused", ff_fused_bwd=True)
    before = (fused_update.fused_level_update.launches, ff_kernel.grouped_ff.launches,
              ff_kernel.grouped_ff_dx.launches, consensus_kernel.consensus_attention.launches,
              consensus_kernel.consensus_dq.launches)
    _loss_and_grads(c, _tree(c)["glom"], _img(), 1, 2)
    after = (fused_update.fused_level_update.launches, ff_kernel.grouped_ff.launches,
             ff_kernel.grouped_ff_dx.launches, consensus_kernel.consensus_attention.launches,
             consensus_kernel.consensus_dq.launches)
    assert after == before


# -- widths past 512: every kernel takes them, in both directions ---------------

WIDE = dict(dim=640, levels=3, image_size=16, patch_size=4)


@pytest.mark.parametrize("ff_impl", ["pallas", "fused"])
def test_forward_at_d640_matches_glom_tpu(ff_impl):
    """The port's forward at d=640 (ff_impl "pallas" or "fused", attention on
    the kernels; their plain versions on the CPU) against glom_tpu's through
    its Pallas kernels in interpret mode, 2 iterations, the weights carried
    by convert.py."""
    kw = dict(WIDE, ff_impl=ff_impl, attention_impl="pallas")
    port, ref = GlomConfig(**kw), jax_config.GlomConfig(**kw)
    tree = _tree(port, seed=3)["glom"]
    img = _img(seed=5)
    want = jax_glom.apply(_jnp(tree), jnp.asarray(img), config=ref, iters=2)
    got = _port_apply(port, tree, img, iters=2)
    assert got.shape == (2, 16, 3, 640)
    np.testing.assert_allclose(got, np.asarray(want), atol=FWD_ATOL)


@pytest.mark.parametrize("dim", [64, 640, 1024])
def test_auto_attention_past_512_picks_the_kernels_as_glom_tpu(monkeypatch, dim):
    """'auto' at d=64 (the tiny preset's width), 640 and 1024 follows
    glom_tpu's rule, which has no width term: the kernels above the
    generation's crossover (n=576 on a mocked H100 here, on a mocked v5e in
    glom_tpu), the plain ops below it (n=9)."""
    from glom_tpu.kernels import consensus_pallas
    from glom_tpu.parallel import mesh

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (9, 0))
    monkeypatch.setattr(mesh, "default_backend_is_tpu", lambda: True)
    monkeypatch.setattr(mesh, "tpu_generation", lambda d=None: "v5e")
    for side, want in ((24, "pallas"), (3, "dense")):   # n=576, n=9
        kw = dict(dim=dim, levels=3, image_size=8 * side, patch_size=8, attention_impl="auto")
        assert glom_model.resolve_auto_attention(GlomConfig(**kw), "cuda") == want
        ref = jax_glom.make_consensus_fn(jax_config.GlomConfig(**kw))
        assert (ref.func is consensus_pallas.consensus_attention_pallas) == (want == "pallas")


@pytest.mark.parametrize("kw", [
    {"attention_impl": "pallas"},                    # its gradient: K6 and K7
    {"ff_impl": "pallas", "ff_fused_bwd": True},     # K2 and K3
    {"ff_impl": "fused"},                            # K8's: K1-K4 and K6, K7
    {"ff_impl": "fused", "ff_fused_bwd": True},      # and K2, K3
])
def test_train_step_at_d640_matches_glom_tpu(kw):
    """A train step at d=640 whose gradient runs the backward kernels (their
    plain versions on the CPU): the denoising loss and every gradient against
    jax.grad of glom_tpu's loss through its Pallas kernels (interpret mode)
    on the same weights, batch and noise, within LOSS_RTOL and GRAD_RTOL per
    leaf; the step and the Trainer build and take a finite step."""
    port_cfg, ref_cfg = GlomConfig(**WIDE, **kw), jax_config.GlomConfig(**WIDE, **kw)
    train_cfg = TrainConfig(batch_size=2, steps=1, iters=2)
    tree = demo_params(port_cfg, train_cfg, seed=3)
    img = _img(seed=6)
    key = jax.random.PRNGKey(5)
    jax_loss = jax_denoise.make_loss_fn(ref_cfg, jax_config.TrainConfig(batch_size=2, iters=2))
    (want_loss, _), want = jax.value_and_grad(jax_loss, has_aux=True)(
        _jnp(tree), jnp.asarray(img), key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, img.shape, jnp.float32)))
    params = convert.params_from_numpy(tree, port_cfg, "cpu")
    loss, grads = denoise.loss_and_grads(denoise.make_loss_fn(port_cfg, train_cfg), params,
                                         torch.from_numpy(img), noise=noise)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    _assert_tree_rel(glom_model.tree_map(lambda t: t.numpy(), grads), want, GRAD_RTOL)
    from glom_tpu_torch.training.trainer import Trainer

    metrics = Trainer(port_cfg, train_cfg, device="cpu").step(img, noise=noise)
    assert np.isfinite(metrics["loss"].item())


def test_classifier_and_video_steps_at_d640_take_a_step_on_the_kernels():
    """The unfrozen classifier step and the video step at d=640 with
    attention_impl="pallas" and the FF kernels' backward build and take one
    step on the CPU, with the plain path's loss (the wrappers' plain
    versions are the plain ops there)."""
    from glom_tpu_torch.models import classifier
    from glom_tpu_torch.training import video

    small = dict(dim=640, levels=2, image_size=8, patch_size=4)
    kernels = dict(attention_impl="pallas", ff_impl="pallas", ff_fused_bwd=True)
    tc = TrainConfig(batch_size=2, steps=1, iters=2, noise_std=0.3)
    rng = np.random.default_rng(8)
    imgs = torch.from_numpy(rng.standard_normal((2, 3, 8, 8)).astype(np.float32))
    labels = torch.tensor([0, 1])
    clip = torch.from_numpy(rng.standard_normal((2, 2, 3, 8, 8)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((2, 2, 3, 8, 8)).astype(np.float32))
    losses = {"classify": [], "video": []}
    for kw in (kernels, {}):
        c = GlomConfig(**small, **kw)
        optimizer = optim.Optimizer.from_config(tc)
        params = classifier.init(torch.Generator().manual_seed(0), c, 3)
        _, _, m = classifier.make_train_step(c, optimizer, iters=2)(
            params, optimizer.init(params), imgs, labels)
        losses["classify"].append(m["loss"].item())
        p = convert.params_from_numpy(demo_params(c, tc, seed=1), c, "cpu")
        state = denoise.DenoiseState(p, optimizer.init(p), 0, torch.Generator())
        _, m = video.make_video_train_step(c, tc, optimizer)(state, clip, noise=noise)
        losses["video"].append(m["loss"].item())
    for name, (got, plain) in losses.items():
        assert np.isfinite(got) and got == plain, (name, got, plain)


@pytest.mark.parametrize("attention_impl", ["dense", "auto"])
def test_train_step_at_d640_trains_through_k1_and_the_plain_vjp(attention_impl):
    """ff_impl='pallas' with ff_fused_bwd=False (glom_tpu's plain VJP, K1 on
    the card) and dense or 'auto' attention train at d=640: one step of the
    Trainer, finite, and its loss the plain path's."""
    from glom_tpu_torch.training.trainer import Trainer

    small = dict(dim=640, levels=2, image_size=8, patch_size=4)
    tc = TrainConfig(batch_size=2, steps=1, seed=3)
    img = np.random.default_rng(2).standard_normal((2, 3, 8, 8)).astype(np.float32)
    noise = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 3, 8, 8)).astype(np.float32))
    losses = []
    for kw in ({"ff_impl": "pallas", "attention_impl": attention_impl}, {}):
        trainer = Trainer(GlomConfig(**small, **kw), tc, device="cpu")
        losses.append(trainer.step(img, noise=noise)["loss"].item())
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
