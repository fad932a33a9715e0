"""The port's video model and training (glom_tpu_torch.models.video,
glom_tpu_torch.training.video) against glom_tpu's on the CPU.

The same seeded numpy weights, clips and noise go through both packages at
dim=32, levels=3, image_size=16, patch_size=4, clips of 3 frames of 2
images, 2 iterations a frame.  The noise is drawn by glom_tpu's own key
split and handed to the port.  The port runs its kernels' path
(``"pallas"``, ``ff_fused_bwd``), which on CPU tensors takes the kernels'
plain versions through their autograd Functions; glom_tpu runs dense.
Tolerances: states by the kernels' rule, ``|got - want| <= rtol (min(1,
max|want|) + |want|)`` elementwise and ``rtol`` normwise, with rtol 1e-4 in
float32 (3 frames of 2 iterations) and 1e-2 in bfloat16 (a few roundings of
2**-8: the frameworks round at other places); the video loss 1e-5 and each
gradient leaf 1e-4 relative (Frobenius); three Adam steps (lr 1e-3) the
losses 1e-5 relative and the parameters 1e-4 absolute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from glom_tpu import config as jax_config
from glom_tpu.models import video as jax_video
from glom_tpu.training import denoise as jax_denoise
from glom_tpu.training import video as jax_tvideo
from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch import convert
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.models import video
from glom_tpu_torch.models.glom import tree_map
from glom_tpu_torch.serving.engine import demo_params
from glom_tpu_torch.training import denoise
from glom_tpu_torch.training import video as tvideo
from glom_tpu_torch.training.optim import Optimizer

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)
KERNELS = dict(ff_impl="pallas", ff_fused_bwd=True, attention_impl="pallas")
T, B, ITERS = 3, 2, 2
STATE_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-4
LR = 1e-3


def _configs(dtype="float32", **kw):
    bf16 = dtype == "bfloat16"
    port = GlomConfig(**TINY, **KERNELS, compute_dtype="bfloat16" if bf16 else None, **kw)
    ref = jax_config.GlomConfig(**TINY, compute_dtype=jnp.bfloat16 if bf16 else None)
    return port, ref


def _weights(config):
    return demo_params(config, TrainConfig(), 0)


def _clip(seed=1, t=T):
    return np.random.default_rng(seed).standard_normal((t, B, 3, 16, 16)).astype(np.float32)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _port(tree, config):
    return convert.params_from_numpy(tree, config, "cpu")


def _flat(tree):
    return ckpt_lib.flatten({"p": jax.tree_util.tree_map(np.asarray, tree)})


def _np(tree):
    return tree_map(lambda t: t.detach().float().numpy(), tree)


def _assert_close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    assert np.linalg.norm(diff) <= rtol * np.linalg.norm(want)
    limit = rtol * (min(1.0, np.abs(want).max()) + np.abs(want))
    assert (diff <= limit).all(), float((diff - limit).max())


def _assert_tree_rel(got, want, rtol):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for k in w:
        err = np.linalg.norm(g[k] - w[k]) / max(np.linalg.norm(w[k]), 1e-30)
        assert err <= rtol, (k, err)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rollout_matches_glom_tpu(dtype, carried):
    """The final state and every frame's state, from the learned init or
    from a carried state; the carry comes back in the compute dtype."""
    port, ref = _configs(dtype)
    tree = _weights(port)["glom"]
    clip = _clip()
    levels = (np.random.default_rng(2).standard_normal(
        (B, port.num_patches, port.levels, port.dim)).astype(np.float32) if carried else None)
    want_final, want_states = jax_video.rollout(
        _jnp(tree), jnp.asarray(clip), config=ref, iters=ITERS,
        levels=None if levels is None else jnp.asarray(levels), return_states=True)
    with torch.inference_mode():
        final, states = video.rollout(
            _port(tree, port), torch.from_numpy(clip), config=port, iters=ITERS,
            levels=None if levels is None else torch.from_numpy(levels), return_states=True)
    assert final.dtype == port.resolved_compute_dtype == states.dtype
    assert tuple(states.shape) == (T, B, port.num_patches, port.levels, port.dim)
    _assert_close(final.float().numpy(), np.asarray(want_final, np.float32), STATE_RTOL[dtype])
    _assert_close(states.float().numpy(), np.asarray(want_states, np.float32),
                  STATE_RTOL[dtype])
    assert torch.equal(final, states[-1])


def test_rollout_varied_on_the_readme_schedule():
    """The README's 12 / 10 / 6 schedule, halved to the tiny config's depth
    (default 6 iterations: 6 / 5 / 3)."""
    port, ref = _configs()
    tree = _weights(port)["glom"]
    clip = _clip()
    schedule = [it * port.default_iters // 12 for it in (12, 10, 6)]
    assert schedule == [6, 5, 3]
    want = jax_video.rollout_varied(_jnp(tree), jnp.asarray(clip), schedule, config=ref)
    with torch.inference_mode():
        got = video.rollout_varied(_port(tree, port), [torch.from_numpy(f) for f in clip],
                                   schedule, config=port)
    _assert_close(got.numpy(), np.asarray(want), STATE_RTOL["float32"])


def test_rollout_validates_shapes():
    port, _ = _configs()
    params = _port(_weights(port)["glom"], port)
    with pytest.raises(ValueError, match="t, b, c, H, W"):
        video.rollout(params, torch.zeros(2, 3, 16, 16), config=port)
    with pytest.raises(ValueError, match="iteration counts"):
        video.rollout_varied(params, [torch.zeros(1, 3, 16, 16)], [2, 3], config=port)


def test_rollout_varied_accepts_stacked_clip():
    port, _ = _configs()
    params = _port(_weights(port)["glom"], port)
    clip = torch.from_numpy(_clip()[:, :1])
    with torch.inference_mode():
        from_stack = video.rollout_varied(params, clip, [4, 3, 2], config=port)
        from_list = video.rollout_varied(params, list(clip), [4, 3, 2], config=port)
    assert torch.equal(from_stack, from_list)


def test_rollout_varied_rejects_short_schedule_up_front():
    """zip would drop the clip's tail frames: both clip forms fail before
    any compute, naming the counts; a stacked non-5d clip is a shape error."""
    port, _ = _configs()
    params = _port(_weights(port)["glom"], port)
    clip = torch.zeros(3, 1, 3, 16, 16)
    with pytest.raises(ValueError, match="3 frames but 2 iteration counts"):
        video.rollout_varied(params, clip, [4, 3], config=port)
    with pytest.raises(ValueError, match="3 frames but 2 iteration counts"):
        video.rollout_varied(params, list(clip), [4, 3], config=port)
    with pytest.raises(ValueError, match="stacked frames must be"):
        video.rollout_varied(params, torch.zeros(1, 3, 16, 16), [4], config=port)


def test_rollout_varied_materializes_generator_schedule():
    port, _ = _configs()
    params = _port(_weights(port)["glom"], port)
    frames = [torch.from_numpy(f) for f in _clip()[:2, :1]]
    with torch.inference_mode():
        got = video.rollout_varied(params, frames, (it for it in [2, 2]), config=port)
        want = video.rollout_varied(params, frames, [2, 2], config=port)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="2 frames but 1 iteration count"):
        video.rollout_varied(params, frames, (it for it in [2]), config=port)


def test_rollout_varied_rejects_nonpositive_iters():
    port, _ = _configs()
    params = _port(_weights(port)["glom"], port)
    with pytest.raises(ValueError, match=">= 1"):
        video.rollout_varied(params, [torch.zeros(1, 3, 16, 16)], [0], config=port)


def _train_cfg(**kw):
    return TrainConfig(iters=ITERS, noise_std=0.3, learning_rate=LR, **kw)


def _jax_train_cfg():
    return jax_config.TrainConfig(iters=ITERS, noise_std=0.3, learning_rate=LR)


def test_video_loss_and_grads_match_jax_grad():
    """Backprop through time: every frame's state decodes, and the gradient
    reaches the weights through the carried state of earlier frames."""
    port, ref = _configs()
    tree = _weights(port)
    clip = _clip()
    rng = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(rng, clip.shape, jnp.float32))
    (want_loss, want_recon), want_grads = jax.value_and_grad(
        jax_tvideo.make_video_loss_fn(ref, _jax_train_cfg()), has_aux=True)(
        _jnp(tree), jnp.asarray(clip), rng)
    loss_fn = tvideo.make_video_loss_fn(port, _train_cfg())
    loss, grads = denoise.loss_and_grads(loss_fn, _port(tree, port), torch.from_numpy(clip),
                                         noise=torch.from_numpy(noise))
    assert abs(loss.item() - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    _assert_tree_rel(_np(grads), want_grads, GRAD_RTOL)
    with torch.inference_mode():
        _, recon = loss_fn(_port(tree, port), torch.from_numpy(clip),
                           noise=torch.from_numpy(noise))
    assert tuple(recon.shape) == clip.shape
    _assert_close(recon.numpy(), np.asarray(want_recon), STATE_RTOL["float32"])


def test_video_grads_under_remat_equal_the_plain_step():
    """``remat`` wraps each iteration in activation checkpointing; over the
    carried state of a clip its gradients are the unwrapped ones."""
    port, _ = _configs()
    tree = _weights(port)
    clip = torch.from_numpy(_clip())
    noise = torch.from_numpy(_clip(seed=3))
    want = denoise.loss_and_grads(tvideo.make_video_loss_fn(port, _train_cfg()),
                                  _port(tree, port), clip, noise=noise)
    for policy in ("full", "dots"):
        cfg = dataclasses.replace(port, remat=True, remat_policy=policy)
        got = denoise.loss_and_grads(tvideo.make_video_loss_fn(cfg, _train_cfg()),
                                     _port(tree, port), clip, noise=noise)
        assert torch.equal(got[0], want[0])
        _assert_tree_rel(_np(got[1]), _np(want[1]), 1e-6)


def test_three_video_steps_match_optax():
    port, ref = _configs()
    tree = _weights(port)
    clip = _clip()
    tx = optax.adam(LR)
    jstep = jax_tvideo.make_video_train_step(ref, _jax_train_cfg(), tx, donate=False)
    jstate = jax_denoise.DenoiseState(_jnp(tree), tx.init(_jnp(tree)), jnp.asarray(0),
                                      jax.random.PRNGKey(5))
    optimizer = Optimizer(LR)
    pstep = tvideo.make_video_train_step(port, _train_cfg(), optimizer)
    params = _port(tree, port)
    pstate = denoise.DenoiseState(params, optimizer.init(params), 0, torch.Generator())
    jl, pl = [], []
    for _ in range(3):
        # the noise glom_tpu's step draws: its key split, then a normal draw
        _, rng_noise = jax.random.split(jstate.rng)
        noise = np.asarray(jax.random.normal(rng_noise, clip.shape, jnp.float32))
        jstate, jm = jstep(jstate, jnp.asarray(clip))
        pstate, pm = pstep(pstate, torch.from_numpy(clip), noise=torch.from_numpy(noise))
        jl.append(float(jm["loss"]))
        pl.append(pm["loss"].item())
        assert abs(pm["grad_norm"].item() - float(jm["grad_norm"])) <= GRAD_RTOL * float(
            jm["grad_norm"])
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    assert pstate.step == int(jstate.step) == 3
    g, w = _flat(_np(pstate.params)), _flat(jstate.params)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=PARAM_ATOL, err_msg=k)


def test_video_step_draws_its_own_noise_from_the_generator():
    port, _ = _configs()
    tree = _weights(port)
    optimizer = Optimizer(LR)
    step = tvideo.make_video_train_step(port, _train_cfg(), optimizer)
    clip = torch.from_numpy(_clip())

    def run():
        params = _port(tree, port)
        state = denoise.DenoiseState(params, optimizer.init(params), 0,
                                     torch.Generator().manual_seed(4))
        return step(state, clip)[1]["loss"]

    assert torch.equal(run(), run()) and torch.isfinite(run())


@pytest.mark.parametrize("decoder", ["mlp", "linear_all", "mlp_all"])
def test_a_nonlinear_decoder_is_refused(decoder):
    port, _ = _configs()
    with pytest.raises(ValueError, match=decoder):
        tvideo.make_video_loss_fn(port, _train_cfg(decoder=decoder))
