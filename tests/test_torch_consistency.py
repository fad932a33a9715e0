"""The port's two-view consistency objective against ``glom_tpu``'s.

``training/consistency.py``'s regularizers against ``glom_tpu``'s on the same
states (values within 1e-6, gradients against ``jax.grad`` within 1e-5), and
the two-view train step against ``glom_tpu``'s jitted step on the same
weights, images and noise: the loss within 1e-5 relative and every gradient
leaf within 1e-4 relative to its norm, at one microbatch and at two.  The
gradients come out of both steps through an optimizer that returns them as
its state.  glom_tpu runs dense, or its Pallas kernels in interpret mode;
the port runs its kernel wrappers' plain versions (CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glom_tpu import config as jax_config
from glom_tpu.training import consistency as jax_cons
from glom_tpu.training import denoise as jax_denoise
from glom_tpu_torch import convert
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.serving.engine import demo_params
from glom_tpu_torch.training import consistency, denoise

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)
VALUE_TOL = 1e-6
REG_GRAD_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _states(b=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, 16, 3, 32)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("kind", ["mse", "infonce"])
@pytest.mark.parametrize("level", [-1, 1])
def test_regularizer_matches_glom_tpu(kind, level):
    """The value within 1e-6 and both states' gradients within 1e-5 of
    ``jax.grad``'s (relative to their norm)."""
    s1, s2 = _states()
    kw = dict(level=level, temperature=0.2)

    def ref(a, b):
        return jax_cons.regularizer_from_state(kind, a, b, **kw)

    want, (g1, g2) = jax.value_and_grad(ref, argnums=(0, 1))(jnp.asarray(s1), jnp.asarray(s2))
    t1, t2 = (torch.from_numpy(s).requires_grad_(True) for s in (s1, s2))
    got = consistency.regularizer_from_state(kind, t1, t2, **kw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=VALUE_TOL, atol=VALUE_TOL)
    for t, g in ((t1, g1), (t2, g2)):
        g = np.asarray(g)
        err = np.linalg.norm(t.grad.numpy() - g) / np.linalg.norm(g)
        assert err <= REG_GRAD_RTOL, err


def test_pooled_embeddings_and_losses_match_glom_tpu():
    """``pooled_level_embedding`` / ``regularizer`` over return_all stacks,
    and ``consistency_loss`` / ``infonce_loss`` on pooled embeddings."""
    rng = np.random.default_rng(3)
    stacks = [rng.standard_normal((5, 4, 16, 3, 32)).astype(np.float32) for _ in range(2)]
    for kind in ("mse", "infonce"):
        want = jax_cons.regularizer(kind, *map(jnp.asarray, stacks), timestep=3, level=0)
        got = consistency.regularizer(kind, *map(torch.from_numpy, stacks), timestep=3, level=0)
        np.testing.assert_allclose(got.item(), float(want), rtol=VALUE_TOL, atol=VALUE_TOL)
    z1, z2 = (np.array(jax_cons.pooled_level_embedding(jnp.asarray(s), 2, -1)) for s in stacks)
    p1 = consistency.pooled_level_embedding(torch.from_numpy(stacks[0]), 2, -1)
    np.testing.assert_allclose(p1.numpy(), z1, atol=VALUE_TOL)
    for ref, port in ((jax_cons.consistency_loss, consistency.consistency_loss),
                      (jax_cons.infonce_loss, consistency.infonce_loss)):
        want = float(ref(jnp.asarray(z1), jnp.asarray(z2)))
        got = port(torch.from_numpy(z1), torch.from_numpy(z2)).item()
        np.testing.assert_allclose(got, want, rtol=VALUE_TOL, atol=VALUE_TOL)
    with pytest.raises(ValueError, match="unknown consistency kind"):
        consistency.regularizer_from_state("cosine", *map(torch.from_numpy, _states()))


class _Capture:
    """An optimizer that leaves the parameters alone and returns the step's
    gradients as its new state (the port's ``Optimizer.update`` signature)."""

    def update(self, grads, state, params):
        return glom_model.tree_map(torch.zeros_like, grads), grads


def _jax_capture():
    import optax

    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _flat(tree):
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in node:
                walk(f"{prefix}/{k}", node[k])
        else:
            out[prefix] = np.asarray(node)

    walk("", tree)
    return out


def _two_view_noise(rng, img_shape, accum):
    """The noise glom_tpu's step draws (``denoise.py:159``, ``:165-186``):
    ``(2·mb, ...)`` a microbatch from ``split(rng_noise, accum)``, view 1's
    rows then view 2's; laid out as the port takes it, ``(2, b, ...)``."""
    _, rng_noise = jax.random.split(rng)
    b = img_shape[0]
    mb = b // accum
    keys = [rng_noise] if accum == 1 else list(jax.random.split(rng_noise, accum))
    parts = [np.asarray(jax.random.normal(k, (2 * mb,) + img_shape[1:], jnp.float32))
             .reshape((2, mb) + img_shape[1:]) for k in keys]
    return np.concatenate(parts, axis=1)


@pytest.mark.parametrize("impl,kind,accum", [
    ("dense", "mse", 1), ("dense", "infonce", 1), ("dense", "mse", 2), ("dense", "infonce", 2),
    ("pallas", "infonce", 1), ("pallas", "mse", 2), ("fused", "infonce", 2),
])
def test_two_view_step_matches_glom_tpu(impl, kind, accum):
    """One two-view step of each package on the same weights, images and
    noise: the loss and every gradient leaf.  With two microbatches
    InfoNCE's negatives are each microbatch's in both packages."""
    b = 4
    kw = dict(batch_size=b, grad_accum_steps=accum, consistency=kind, consistency_weight=0.5,
              consistency_temperature=0.2)
    if impl == "dense":
        port_kw, ref_kw = {}, {}
    elif impl == "pallas":
        port_kw = ref_kw = dict(ff_impl="pallas", ff_fused_bwd=True, attention_impl="pallas")
    else:
        port_kw = ref_kw = dict(ff_impl="fused", ff_fused_bwd=True)
    port_cfg, ref_cfg = GlomConfig(**TINY, **port_kw), jax_config.GlomConfig(**TINY, **ref_kw)
    port_train, ref_train = TrainConfig(**kw), jax_config.TrainConfig(**kw)
    tree = demo_params(port_cfg, port_train, seed=7)
    img = np.random.default_rng(8).standard_normal((b, 3, 16, 16)).astype(np.float32)

    tx = _jax_capture()
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = jax.random.PRNGKey(4)
    state = jax_denoise.DenoiseState(params, tx.init(params), jnp.zeros((), jnp.int32), rng)
    state, metrics = jax.jit(jax_denoise.make_step_fn(ref_cfg, ref_train, tx))(
        state, jnp.asarray(img))

    noise = _two_view_noise(rng, img.shape, accum)
    p = convert.params_from_numpy(tree, port_cfg, "cpu")
    port = denoise.DenoiseState(p, {}, 0, torch.Generator())
    port, pm = denoise.make_step_fn(port_cfg, port_train, _Capture())(
        port, torch.from_numpy(img), noise=torch.from_numpy(noise))

    np.testing.assert_allclose(pm["loss"].item(), float(metrics["loss"]), rtol=LOSS_RTOL)
    got = _flat(glom_model.tree_map(lambda t: t.numpy(), port.opt_state))
    want = _flat(state.opt_state)
    assert set(got) == set(want)
    for k in want:
        err = np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-30)
        assert err <= GRAD_RTOL, (k, err)


def test_two_view_noise_has_the_documented_layout():
    """Drawn noise is ``(2, b, ...)``, view 1 then view 2; a microbatch of
    rows takes both views' rows; a noise of another shape is refused."""
    cfg = GlomConfig(**TINY)
    train = TrainConfig(batch_size=2, consistency="mse")
    tree = convert.params_from_numpy(demo_params(cfg, train, seed=1), cfg, "cpu")
    loss_fn = denoise.make_loss_fn(cfg, train)
    img = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 3, 16, 16))
                           .astype(np.float32))
    gen_a, gen_b = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    drawn, _ = loss_fn(tree, img, generator=gen_a)
    given, _ = loss_fn(tree, img, noise=torch.randn((2,) + tuple(img.shape), generator=gen_b))
    assert torch.equal(drawn, given)
    with pytest.raises(ValueError, match="noise of shape"):
        loss_fn(tree, img, noise=torch.zeros(img.shape))
    with pytest.raises(ValueError, match="unknown consistency kind"):
        denoise.make_loss_fn(cfg, TrainConfig(batch_size=2, consistency="byol"))
