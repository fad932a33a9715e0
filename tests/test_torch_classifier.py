"""The port's classifier (glom_tpu_torch.models.classifier) against
glom_tpu's on the CPU.

The same seeded numpy weights, images and labels go through both packages,
float32, at dim=32, levels=3, image_size=16, patch_size=4 and 3 iterations.
Tolerances: logits 1e-5 absolute; the loss 1e-5 and each gradient leaf 1e-4
relative (Frobenius); three optimizer steps against optax: the losses 1e-5
relative, the parameters 1e-5 absolute and Adam's moments 1e-4 relative
per leaf, at a learning rate of 1e-4.  Adam's step is about ``lr`` in
every coordinate whatever the gradient's size, so in a coordinate whose
gradient is near zero (1e-7 against the leaf's 1e-4) float32 rounding
moves the parameter by a share of ``lr``: one weight of 12288 ended
1.2e-5 apart at 1e-3 and one bias of 384 1.7e-5 apart at 1e-2.  With
``"pallas"`` the port takes its kernels' plain versions on CPU tensors and
glom_tpu runs its Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from glom_tpu import config as jax_config
from glom_tpu.models import classifier as jax_classifier
from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch import convert
from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.models import classifier
from glom_tpu_torch.models.glom import tree_leaves, tree_map
from glom_tpu_torch.training.optim import Optimizer

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)
CLASSES, ITERS, LR = 4, 3, 1e-4
OP_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
STEP_ATOL = 1e-5


def _configs(impl="dense"):
    port = GlomConfig(**TINY, ff_impl=impl, attention_impl=impl,
                      ff_fused_bwd=impl == "pallas")
    ref = jax_config.GlomConfig(**TINY, ff_impl=impl, attention_impl=impl,
                                ff_fused_bwd=impl == "pallas")
    return port, ref


def _weights():
    """numpy {glom, head} tree, drawn by glom_tpu's init."""
    _, ref = _configs()
    tree = jax_classifier.init(jax.random.PRNGKey(0), ref, CLASSES)
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(b=4, seed=1):
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((b, 3, 16, 16)).astype(np.float32)
    return imgs, np.arange(b) % CLASSES


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _port(tree, config):
    return convert.params_from_numpy(tree, config, "cpu")


def _flat(tree):
    return ckpt_lib.flatten({"p": jax.tree_util.tree_map(np.asarray, tree)})


def _np(tree):
    return tree_map(lambda t: t.detach().numpy(), tree)


@pytest.mark.parametrize("impl", ["dense", "pallas"])
def test_logits_match_glom_tpu(impl):
    port, ref = _configs(impl)
    tree = _weights()
    imgs, _ = _data()
    want = jax_classifier.apply(_jnp(tree), jnp.asarray(imgs), config=ref, iters=ITERS)
    with torch.inference_mode():
        got = classifier.apply(_port(tree, port), torch.from_numpy(imgs), config=port,
                               iters=ITERS)
    assert got.shape == (4, CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_ATOL)


def test_loss_accuracy_and_grads_match_jax_grad():
    """The port through its kernels' autograd Functions (K1, K4 forward; K2,
    K3, K6, K7 backward, as plain versions on the CPU) against glom_tpu's
    dense path under ``jax.value_and_grad``."""
    port, _ = _configs("pallas")
    _, ref = _configs("dense")
    tree = _weights()
    imgs, labels = _data()

    def jax_loss(params):
        logits = jax_classifier.apply(params, jnp.asarray(imgs), config=ref, iters=ITERS)
        loss = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), jnp.asarray(labels)))
        return loss, jnp.mean((jnp.argmax(logits, -1) == labels).astype(jnp.float32))

    (want_loss, want_acc), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(_jnp(tree))
    loss_fn = classifier.make_loss_fn(port, iters=ITERS)
    live = tree_map(lambda p: p.requires_grad_(True), _port(tree, port))
    loss, acc = loss_fn(live, torch.from_numpy(imgs), torch.from_numpy(labels))
    grads = classifier.grads_of(loss, live)
    assert abs(loss.item() - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    assert acc.item() == float(want_acc)
    g, w = _flat(_np(grads)), _flat(want_grads)
    assert set(g) == set(w) and len(w) == 14
    for k in w:
        err = np.linalg.norm(g[k] - w[k]) / max(np.linalg.norm(w[k]), 1e-30)
        assert err <= GRAD_RTOL, (k, err)


def _run_steps(tx, optimizer, *, freeze=False, steps=3):
    """``steps`` steps of glom_tpu's jitted step and of the port's from the
    same weights; returns ``(jax params, optax state, jax losses, port
    params, port state, port losses)``."""
    port, ref = _configs()
    tree = _weights()
    imgs, labels = _data()
    jstep = jax_classifier.make_train_step(ref, tx, iters=ITERS, freeze_backbone=freeze)
    jp, js = _jnp(tree), tx.init(_jnp(tree))
    pstep = classifier.make_train_step(port, optimizer, iters=ITERS, freeze_backbone=freeze)
    pp = _port(tree, port)
    ps = optimizer.init(pp)
    jl, pl = [], []
    for _ in range(steps):
        jp, js, jm = jstep(jp, js, jnp.asarray(imgs), jnp.asarray(labels))
        pp, ps, pm = pstep(pp, ps, torch.from_numpy(imgs), torch.from_numpy(labels))
        jl.append(float(jm["loss"]))
        pl.append(pm["loss"].item())
        assert pm["accuracy"].item() == float(jm["accuracy"])
    return jp, js, jl, pp, ps, pl


@pytest.mark.parametrize("opt", ["adam", "adamw"])
def test_three_steps_match_optax(opt):
    wd = 0.1 if opt == "adamw" else 0.0
    tx = optax.adamw(LR, weight_decay=wd) if wd else optax.adam(LR)
    jp, js, jl, pp, ps, pl = _run_steps(tx, Optimizer(LR, weight_decay=wd))
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    g, w = _flat(_np(pp)), _flat(jp)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=STEP_ATOL, err_msg=k)
    # the Adam state keeps optax's moments, leaf for leaf
    assert ps["count"] == int(js[0].count) == 3
    for name in ("mu", "nu"):
        g, w = _flat(_np(ps[name])), _flat(getattr(js[0], name))
        for k in w:
            err = np.linalg.norm(g[k] - w[k]) / max(np.linalg.norm(w[k]), 1e-30)
            assert err <= GRAD_RTOL, (name, k, err)


def test_freeze_backbone_under_adamw_keeps_every_glom_leaf():
    """Decoupled weight decay moves every leaf it updates: the frozen glom
    leaves come back bitwise, the head moves as glom_tpu's does."""
    tree = _weights()
    port, _ = _configs()
    before = _port(tree, port)["glom"]
    tx = optax.adamw(LR, weight_decay=0.1)
    jp, js, jl, pp, ps, pl = _run_steps(tx, Optimizer(LR, weight_decay=0.1), freeze=True)
    for a, b in zip(tree_leaves(before), tree_leaves(pp["glom"])):
        assert torch.equal(a, b)
    for k, w in _flat(jp["glom"]).items():
        np.testing.assert_array_equal(_flat(_np(pp["glom"]))[k], w)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    for k in ("w", "b"):
        moved = np.abs(pp["head"][k].numpy() - tree["head"][k]).max()
        assert moved > 10 * STEP_ATOL
        np.testing.assert_allclose(pp["head"][k].numpy(), np.asarray(jp["head"][k]),
                                   atol=STEP_ATOL)
    # the frozen leaves' moments stay zero, as optax's do under stop_gradient
    assert all(not t.any() for t in tree_leaves(ps["mu"]["glom"]))


def test_frozen_step_records_no_backbone_graph():
    """The frozen backbone's forward runs without autograd: its features
    carry no graph, so no backward kernel can run over them."""
    port, _ = _configs("pallas")
    params = _port(_weights(), port)
    imgs, _ = _data()
    with torch.no_grad():
        pooled = classifier.pooled_features(params["glom"], torch.from_numpy(imgs),
                                            config=port, iters=ITERS)
    assert pooled.grad_fn is None and pooled.shape == (4, port.dim)


def test_the_tree_crosses_both_ways_through_convert(tmp_path):
    """glom_tpu's {glom, head} tree -> the port -> numpy gives the same
    arrays, and a tree the port draws runs in glom_tpu to the same logits;
    it also rides a checkpoint file unchanged."""
    port, ref = _configs()
    tree = _weights()
    back = convert.params_to_numpy(convert.params_from_numpy(tree, port, "cpu"))
    assert _flat(back).keys() == _flat(tree).keys()
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(_flat(back)[k], v)
    drawn = classifier.init(torch.Generator().manual_seed(3), port, CLASSES)
    assert drawn["head"]["w"].shape == (port.dim, CLASSES) and not drawn["head"]["b"].any()
    assert drawn["head"]["w"].abs().max() <= port.dim ** -0.5
    imgs, _ = _data()
    want = jax_classifier.apply(_jnp(convert.params_to_numpy(drawn)), jnp.asarray(imgs),
                                config=ref, iters=ITERS)
    with torch.inference_mode():
        got = classifier.apply(drawn, torch.from_numpy(imgs), config=port, iters=ITERS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_ATOL)
    ckpt_lib.save(str(tmp_path), 1, {"params": convert.params_to_numpy(drawn)})
    loaded = ckpt_lib.load_tree(str(tmp_path), 1, "params")
    for k, v in _flat(convert.params_to_numpy(drawn)).items():
        np.testing.assert_array_equal(_flat(loaded)[k], v)
