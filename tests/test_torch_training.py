"""The port's training slice (glom_tpu_torch.training, optim, obs, resilience)
against glom_tpu on the CPU.

The same seeded numpy weights, images and noise go through both packages;
the noise is drawn on the JAX side as ``glom_tpu/training/denoise.py`` draws
it and handed to the port.  Float32.  Tolerances: the loss's gradients 1e-4
relative per leaf (a 2*L-iteration forward and its backward); over a few
optimizer steps the losses 1e-5 relative and the parameters 1e-4 absolute;
the optimizer and the schedule on their own 1e-6 (one op).  The port runs
with its kernels selected (``pallas``, ``ff_fused_bwd``), which on CPU
tensors take the kernels' plain versions through the autograd Functions.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from glom_tpu import config as jax_config
from glom_tpu.obs.monitors import numerics_metrics as jax_numerics
from glom_tpu.training import denoise as jax_denoise
from glom_tpu.training.data import synthetic_batches as jax_synthetic
from glom_tpu.training.trainer import make_lr_schedule as jax_lr_schedule
from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch import convert
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.obs.monitors import numerics_metrics
from glom_tpu_torch.serving.engine import ServingEngine, demo_params
from glom_tpu_torch.training import denoise, optim, train
from glom_tpu_torch.training.data import synthetic_batches
from glom_tpu_torch.training.metrics import MetricLogger
from glom_tpu_torch.training.trainer import NonFiniteError, Trainer

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)
KERNELS = dict(ff_impl="pallas", ff_fused_bwd=True, attention_impl="pallas")
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _img(b=2, seed=1):
    return np.random.default_rng(seed).standard_normal((b, 3, 16, 16)).astype(np.float32)


def _flat(tree):
    return ckpt_lib.flatten({"p": jax.tree_util.tree_map(np.asarray, tree)})


def _assert_tree_rel(got, want, rtol):
    """Per leaf: |got - want| / |want| <= rtol (Frobenius norms)."""
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for k in w:
        err = np.linalg.norm(g[k] - w[k]) / max(np.linalg.norm(w[k]), 1e-30)
        assert err <= rtol, (k, err)


def _to_np(tree):
    return glom_model.tree_map(lambda t: t.detach().numpy(), tree)


def _port_params(tree, config):
    return convert.params_from_numpy(tree, config, "cpu")


@pytest.mark.parametrize("jax_impl", ["dense", "pallas"])
def test_loss_grads_match_jax_grad(jax_impl):
    """The port's loss and its gradients against jax.grad of glom_tpu's loss,
    on the same weights and noise; glom_tpu on its XLA path or on its Pallas
    kernels (interpret mode, fused backward)."""
    port_cfg = GlomConfig(**TINY, **KERNELS)
    ref_cfg = jax_config.GlomConfig(**TINY, ff_impl=jax_impl, attention_impl=jax_impl,
                                    ff_fused_bwd=True)
    train_cfg = TrainConfig(batch_size=2)
    tree = demo_params(port_cfg, train_cfg, seed=3)
    img = _img()
    key = jax.random.PRNGKey(5)
    jax_loss = jax_denoise.make_loss_fn(ref_cfg, jax_config.TrainConfig(batch_size=2))
    (want_loss, _), want = jax.value_and_grad(jax_loss, has_aux=True)(_jnp(tree), jnp.asarray(img), key)
    noise = np.array(jax.random.normal(key, img.shape, jnp.float32))   # as denoise.py:92 draws it

    params = glom_model.tree_map(lambda t: t.requires_grad_(True), _port_params(tree, port_cfg))
    loss, _ = denoise.make_loss_fn(port_cfg, train_cfg)(
        params, torch.from_numpy(img), noise=torch.from_numpy(noise))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    _assert_tree_rel(glom_model.tree_map(lambda t: t.grad.numpy(), params), want, GRAD_RTOL)


def test_bf16_loss_matches_glom_tpu():
    """compute_dtype bfloat16: a bf16 state meets the decoder's f32 weights,
    which glom_tpu promotes to f32; the port's loss agrees to bf16's
    precision (the two frameworks round at other places) and backpropagates
    to finite f32 gradients."""
    port_cfg = GlomConfig(**TINY, **KERNELS, compute_dtype="bfloat16")
    ref_cfg = jax_config.GlomConfig(**TINY, compute_dtype="bfloat16")
    train_cfg = TrainConfig(batch_size=2)
    tree = demo_params(port_cfg, train_cfg, seed=3)
    img = _img()
    key = jax.random.PRNGKey(5)
    want, _ = jax_denoise.make_loss_fn(ref_cfg, jax_config.TrainConfig(batch_size=2))(
        _jnp(tree), jnp.asarray(img), key)
    noise = np.array(jax.random.normal(key, img.shape, jnp.float32))
    params = glom_model.tree_map(lambda t: t.requires_grad_(True), _port_params(tree, port_cfg))
    loss, recon = denoise.make_loss_fn(port_cfg, train_cfg)(
        params, torch.from_numpy(img), noise=torch.from_numpy(noise))
    loss.backward()
    assert recon.dtype == loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(want), rtol=2e-2)
    for p in glom_model.tree_leaves(params):
        assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()


def _jax_tx(train_cfg):
    """glom_tpu's Trainer optimizer (trainer.py:99-110)."""
    lr = jax_lr_schedule(train_cfg)
    tx = (optax.adamw(lr, weight_decay=train_cfg.weight_decay) if train_cfg.weight_decay
          else optax.adam(lr))
    if train_cfg.grad_clip_norm:
        tx = optax.chain(optax.clip_by_global_norm(train_cfg.grad_clip_norm), tx)
    return tx


@pytest.mark.parametrize("opt", [
    dict(),
    dict(weight_decay=0.05, grad_clip_norm=0.05, lr_schedule="cosine", warmup_steps=2,
         learning_rate=3e-3),
])
def test_train_steps_match_glom_tpu(opt):
    """Four steps of glom_tpu's jitted step against the port's, on the same
    weights, images and noise: Adam, then AdamW with clipping (it triggers)
    and the cosine schedule with warmup."""
    steps = 4
    kw = dict(batch_size=2, steps=steps, **opt)
    port_cfg = GlomConfig(**TINY, **KERNELS)
    ref_cfg = jax_config.GlomConfig(**TINY)
    port_train, ref_train = TrainConfig(**kw), jax_config.TrainConfig(**kw)
    tree = demo_params(port_cfg, port_train, seed=4)

    tx = _jax_tx(ref_train)
    state = jax_denoise.init_state(jax.random.PRNGKey(0), ref_cfg, tx)
    params = _jnp(tree)
    state = jax_denoise.DenoiseState(params, tx.init(params), state.step, state.rng)
    jax_step = jax.jit(jax_denoise.make_step_fn(ref_cfg, ref_train, tx))

    optimizer = optim.Optimizer.from_config(port_train)
    p = _port_params(tree, port_cfg)
    port = denoise.DenoiseState(p, optimizer.init(p), 0, torch.Generator())
    port_step = denoise.make_step_fn(port_cfg, port_train, optimizer)

    imgs = np.random.default_rng(9).standard_normal((steps, 2, 3, 16, 16)).astype(np.float32)
    want_losses, got_losses, clipped = [], [], []
    for i in range(steps):
        # the noise glom_tpu's step will draw (denoise.py:159, :92)
        _, rng_noise = jax.random.split(state.rng)
        noise = np.array(jax.random.normal(rng_noise, imgs[i].shape, jnp.float32))
        state, m = jax_step(state, jnp.asarray(imgs[i]))
        port, pm = port_step(port, torch.from_numpy(imgs[i]), noise=torch.from_numpy(noise))
        want_losses.append(float(m["loss"]))
        got_losses.append(pm["loss"].item())
        np.testing.assert_allclose(pm["grad_norm"].item(), float(m["grad_norm"]), rtol=GRAD_RTOL)
        assert pm["nonfinite_grads"].item() == 0 and pm["loss_nonfinite"].item() == 0
        clipped.append(float(m["grad_norm"]) > port_train.grad_clip_norm)
    if port_train.grad_clip_norm:
        assert any(clipped)
    np.testing.assert_allclose(got_losses, want_losses, rtol=LOSS_RTOL)
    assert port.opt_state["count"] == steps
    g, w = _flat(_to_np(port.params)), _flat(state.params)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=PARAM_ATOL, err_msg=k)


def test_grad_accum_matches_the_full_batch():
    """Two microbatches with float32 accumulators give the full-batch step."""
    cfg = GlomConfig(**TINY, **KERNELS)
    tree = demo_params(cfg, TrainConfig(), seed=6)
    img = torch.from_numpy(_img(4, seed=2))
    noise = torch.from_numpy(_img(4, seed=3))
    out = []
    for accum in (1, 2):
        train_cfg = TrainConfig(batch_size=4, grad_accum_steps=accum)
        optimizer = optim.Optimizer.from_config(train_cfg)
        p = _port_params(tree, cfg)
        st = denoise.DenoiseState(p, optimizer.init(p), 0, torch.Generator())
        st, m = denoise.make_step_fn(cfg, train_cfg, optimizer)(st, img, noise=noise)
        out.append((m["loss"].item(), m["grad_norm"].item(), _flat(_to_np(st.params))))
    (l1, n1, p1), (l2, n2, p2) = out
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    np.testing.assert_allclose(n2, n1, rtol=1e-5)
    for k in p1:
        np.testing.assert_allclose(p2[k], p1[k], atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(lr_schedule="cosine", warmup_steps=3, steps=10, learning_rate=1e-3),
    dict(lr_schedule="cosine", warmup_steps=0, steps=5, learning_rate=3e-4),
    dict(lr_schedule="cosine", warmup_steps=8, steps=4, learning_rate=2e-3),
    dict(lr_schedule="constant", learning_rate=3e-4),
])
def test_lr_schedule_matches_optax(kw):
    want = jax_lr_schedule(jax_config.TrainConfig(**kw))
    got = optim.make_lr_schedule(TrainConfig(**kw))
    for count in range(14):
        w = float(want(count)) if callable(want) else float(want)
        g = got(count) if callable(got) else got
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12, err_msg=str(count))
    if kw["lr_schedule"] == "cosine":
        assert got(0) == 0.0   # the first update under warmup moves nothing


@pytest.mark.parametrize("kw", [
    dict(),
    dict(weight_decay=0.1),
    dict(grad_clip_norm=0.5),        # the norm below is above 0.5: clips
    dict(grad_clip_norm=100.0),      # below: untouched
    dict(weight_decay=0.01, grad_clip_norm=0.5, lr_schedule="cosine", warmup_steps=1, steps=4),
])
def test_optimizer_matches_optax(kw):
    """Three updates of the port's Optimizer against optax's chain."""
    rng = np.random.default_rng(7)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal((3,)).astype(np.float32)}}
    train_cfg = TrainConfig(**kw)
    tx = _jax_tx(jax_config.TrainConfig(**kw))
    opt = optim.Optimizer.from_config(train_cfg)
    jp, js = _jnp(params), tx.init(_jnp(params))
    tp = glom_model.tree_map(torch.from_numpy, params)
    ts = opt.init(tp)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32), params)
        upd, js = tx.update(_jnp(grads), js, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, ts = opt.update(glom_model.tree_map(torch.from_numpy, grads), ts, tp)
        tp = optim.apply_updates(tp, tupd)
    g, w = _flat(_to_np(tp)), _flat(jp)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_numerics_metrics_match_glom_tpu():
    grads = [np.array([1.0, np.nan, np.inf], np.float32), np.array([[2.0, -np.inf]], np.float32)]
    for loss in (np.float32(1.5), np.float32(np.nan)):
        want = jax_numerics([jnp.asarray(g) for g in grads], jnp.asarray(loss))
        got = numerics_metrics([torch.from_numpy(g) for g in grads], torch.tensor(loss))
        assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}


def test_synthetic_batches_are_glom_tpu_s_stream():
    ours, theirs = synthetic_batches(2, 16, 3, seed=4), jax_synthetic(2, 16, 3, seed=4)
    for _ in range(3):
        np.testing.assert_array_equal(next(ours), next(theirs))


def test_metric_logger_writes_jsonl(tmp_path, capsys):
    path = str(tmp_path / "log.jsonl")
    logger = MetricLogger(path=path, clock=iter([10.0, 12.5]).__next__)
    logger.log(3, loss=torch.tensor(0.123456789), event="resume", count=2)
    logger.close()
    rec = json.loads(capsys.readouterr().out)
    assert rec == {"step": 3, "time": 2.5, "loss": 0.123457, "event": "resume", "count": 2}
    with open(path) as f:
        assert json.loads(f.read()) == rec


# -- the trainer ---------------------------------------------------------------

def _train_cfg(tmp_path=None, **kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("log_every", 0)
    if tmp_path is not None:
        kw.setdefault("checkpoint_dir", str(tmp_path))
    return TrainConfig(**kw)


def _trainer(train_cfg, **kw):
    return Trainer(GlomConfig(**TINY, **KERNELS, **kw), train_cfg, device="cpu",
                   logger=MetricLogger(stream=open(os.devnull, "w")))


def _batches(n, seed=0):
    return iter(list(synthetic_batches(2, 16, 3, seed=seed).__next__() for _ in range(n)))


def test_resume_equals_an_unbroken_run_bitwise(tmp_path):
    """2 steps, a checkpoint, a new trainer that resumes and takes 2 more:
    the same bits as 4 steps in one run (params, optimizer state, and the
    noise generator's state restored)."""
    imgs = list(_batches(4))
    whole = _trainer(_train_cfg(steps=4))
    whole.fit(iter(imgs))
    first = _trainer(_train_cfg(tmp_path, steps=2, checkpoint_every=2))
    first.fit(iter(imgs[:2]))
    second = _trainer(_train_cfg(tmp_path, steps=4, checkpoint_every=2))
    second.fit(iter(imgs[2:]))
    assert second.state.step == 4 and second.state.opt_state["count"] == 4
    a, b = _flat(_to_np(whole.state.params)), _flat(_to_np(second.state.params))
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert torch.equal(whole.state.generator.get_state(), second.state.generator.get_state())


def test_port_checkpoint_loads_in_glom_tpu_and_serves(tmp_path):
    d = str(tmp_path)
    trainer = _trainer(_train_cfg(tmp_path, steps=2, checkpoint_every=2))
    trainer.fit(_batches(2))
    step, cfg, train_cfg, params = jax_denoise.load_checkpoint_state(d)
    assert step == 2 and cfg.dim == 32 and cfg.ff_fused_bwd
    want = _flat(_to_np(trainer.state.params))
    got = _flat(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    engine = ServingEngine(d, device="cpu")
    assert engine.step == 2
    imgs = _img(3)
    with torch.inference_mode():
        ref = glom_model.apply(trainer.state.params["glom"], torch.from_numpy(imgs),
                               config=engine.config).mean(dim=1).numpy()
    np.testing.assert_allclose(engine.run("embed", imgs), ref, atol=1e-6)


def _corrupt(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))


def test_corrupt_newest_step_falls_back(tmp_path):
    d = str(tmp_path)
    trainer = _trainer(_train_cfg(tmp_path, steps=2, checkpoint_every=1))
    trainer.fit(_batches(2))
    _corrupt(ckpt_lib.npz_path(d, 2))
    resumed = _trainer(_train_cfg(tmp_path, steps=2, checkpoint_every=1))
    with pytest.warns(UserWarning, match="quarantined corrupt checkpoint step 2"):
        resumed.fit(_batches(1, seed=5))
    # step 1 restored, one step retaken to reach 2
    assert resumed.state.step == 2
    assert os.path.exists(ckpt_lib.npz_path(d, 2) + ".corrupt")
    assert ckpt_lib.verify_file_integrity(d, 2) is True


def _save_glom_tpu_run(d, ref_cfg, ref_train, tx, steps):
    """``steps`` of glom_tpu's jitted train step from its own init, saved as
    glom_tpu's trainer saves (params, optax state, PRNG key); returns the
    state."""
    from glom_tpu import checkpoint as jax_ckpt

    state = jax_denoise.init_state(jax.random.PRNGKey(0), ref_cfg, tx)
    jax_step = jax.jit(jax_denoise.make_step_fn(ref_cfg, ref_train, tx))
    imgs = np.random.default_rng(11).standard_normal((steps, 2, 3, 16, 16)).astype(np.float32)
    for i in range(steps):
        state, _ = jax_step(state, jnp.asarray(imgs[i]))
    ckpt_lib.write_json(d, "config.json", {"glom": ref_cfg.to_json_dict(),
                                           "train": ref_train.to_json_dict()})
    jax_ckpt.save(d, steps, {"params": state.params, "opt": state.opt_state, "rng": state.rng})
    return state


@pytest.mark.parametrize("opt", [
    dict(),
    dict(weight_decay=0.05),
    dict(grad_clip_norm=0.05),
    dict(weight_decay=0.05, grad_clip_norm=0.05, lr_schedule="cosine", warmup_steps=2,
         learning_rate=3e-3, steps=6),
], ids=["adam", "adamw", "clip_adam", "clip_adamw_cosine"])
def test_glom_tpu_optimizer_state_resumes(tmp_path, opt):
    """A glom_tpu run after 2 steps resumes in the port: its optax state
    (each chain glom_tpu's trainer builds) maps onto the port's
    ``{count, mu, nu}`` bit for bit, and one port update on the same
    gradients gives optax's within 1e-6 relative per leaf.  The JAX PRNG key
    does not carry over: the resume warns."""
    d = str(tmp_path)
    kw = dict(batch_size=2, **opt)
    ref_train = jax_config.TrainConfig(**kw)
    tx = _jax_tx(ref_train)
    state = _save_glom_tpu_run(d, jax_config.GlomConfig(**TINY), ref_train, tx, 2)
    adam = state.opt_state[1][0] if ref_train.grad_clip_norm else state.opt_state[0]

    trainer = _trainer(_train_cfg(**kw))
    with pytest.warns(UserWarning, match="default Adam constants.*noise generator starts fresh"):
        assert trainer.restore(d) == 2
    got = trainer.state.opt_state
    assert got["count"] == int(adam.count) == 2
    for name, want in (("mu", adam.mu), ("nu", adam.nu)):
        g, w = _flat(_to_np(got[name])), _flat(want)
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=f"{name} {k}")

    rng = np.random.default_rng(12)
    grads = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), state.params)
    want, _ = tx.update(_jnp(grads), state.opt_state, state.params)
    port_grads = glom_model.tree_map(torch.from_numpy, grads)
    updates, new = trainer.optimizer.update(port_grads, got, trainer.state.params)
    assert new["count"] == 3
    _assert_tree_rel(_to_np(updates), want, 1e-6)


@pytest.mark.parametrize("case", ["sgd", "chain_not_in_config"])
def test_glom_tpu_optimizer_state_is_refused(tmp_path, case):
    """An optax state outside the chains glom_tpu's trainer builds still
    raises: SGD with momentum, or a custom ``tx`` whose chain (adamw under
    ``clip_by_global_norm`` with a schedule) is not the one the checkpoint's
    config.json names (plain adam at a constant rate)."""
    d = str(tmp_path)
    cfg = jax_config.GlomConfig(**TINY)
    if case == "sgd":
        tx = optax.sgd(1e-3, momentum=0.9)
    else:
        tx = _jax_tx(jax_config.TrainConfig(batch_size=2, weight_decay=0.05, grad_clip_norm=0.05,
                                            lr_schedule="cosine", warmup_steps=2, steps=6))
    st = jax_denoise.init_state(jax.random.PRNGKey(0), cfg, tx)
    ckpt_lib.write_json(d, "config.json", {"glom": cfg.to_json_dict(),
                                           "train": jax_config.TrainConfig().to_json_dict()})
    from glom_tpu import checkpoint as jax_ckpt

    jax_ckpt.save(d, 1, {"params": st.params, "opt": st.opt_state, "rng": st.rng})
    with pytest.raises(ValueError, match="optimizer state is not in the port's layout"):
        _trainer(_train_cfg()).restore(d)


def test_older_port_layout_is_refused_by_name_and_its_params_load(tmp_path):
    """A checkpoint in the port's older layout (opt one ``{count, mu, nu}``
    tree, rng the generator's bytes) does not resume: the error names that
    layout and the params-only loaders, and its params still load."""
    d = str(tmp_path)
    trainer = _trainer(_train_cfg())
    trainer.save(d)
    st = trainer.state
    ckpt_lib.save(d, 1, {"params": _to_np(st.params),
                         "opt": {"count": np.asarray(st.opt_state["count"], np.int32),
                                 "mu": _to_np(st.opt_state["mu"]),
                                 "nu": _to_np(st.opt_state["nu"])},
                         "rng": st.generator.get_state().numpy()})
    with pytest.raises(ValueError, match="older layout.*load_checkpoint_state or Glom.load"):
        _trainer(_train_cfg()).restore(d, step=1)
    step, _, _, params = denoise.load_checkpoint_state(d, step=1, device="cpu")
    assert step == 1
    for a, b in zip(glom_model.tree_leaves(params), glom_model.tree_leaves(st.params)):
        assert torch.equal(a, b)


def test_halt_on_nan_raises_before_a_checkpoint(tmp_path):
    bad = np.full((2, 3, 16, 16), np.nan, np.float32)
    trainer = _trainer(_train_cfg(tmp_path, steps=2, log_every=1, halt_on_nan=True,
                                  checkpoint_every=1))
    with pytest.raises(NonFiniteError, match="nonfinite"):
        trainer.fit(iter([bad, bad]))
    assert ckpt_lib.latest_step(str(tmp_path)) is None


def test_sigterm_stops_after_the_step_and_saves(tmp_path):
    def batches():
        for i, img in enumerate(_batches(5)):
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield img

    before = signal.getsignal(signal.SIGTERM)
    trainer = _trainer(_train_cfg(tmp_path, steps=5))
    trainer.fit(batches())
    assert trainer.state.step == 3
    assert ckpt_lib.latest_step(str(tmp_path)) == 3
    assert signal.getsignal(signal.SIGTERM) is before


def test_fit_logs_every_log_every_steps(tmp_path, capsys):
    trainer = Trainer(GlomConfig(**TINY, **KERNELS), _train_cfg(steps=4, log_every=2),
                      device="cpu")
    last = trainer.fit(_batches(4))
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in recs] == [2, 4]
    assert {"loss", "grad_norm", "imgs_per_sec", "nonfinite_grads"} <= set(recs[-1])
    assert set(last) == {"loss", "grad_norm"} and np.isfinite(last["loss"])


@pytest.mark.parametrize("field,value,item", [
    ("checkpoint_backend", "sharded", None),
    ("param_sharding", "ep", None),
    ("checkpoint_backend", "orbax", "out of the port's scope"),
    ("mesh_shape", (1, 2, 1), "does not cover 1 devices"),
    ("mesh_shape", (2, 1, 1), "does not cover 1 devices"),
])
def test_trainer_refuses_what_it_does_not_implement(field, value, item):
    """The orbax backend is refused (out of the port's scope).  Sharded
    saves and ``param_sharding="ep"`` are taken (on one rank every net is
    whole: the step is the default's; tests/test_torch_sharded_checkpoint.py
    runs the saves), and so is a ``mesh_shape`` above one rank: on a process
    without a group of that many ranks it fails as glom_tpu's mesh does on
    too few devices (tests/test_torch_parallel_train.py runs the meshes)."""
    if item is None:
        img, noise = _img(), torch.from_numpy(_img(seed=2))
        got = _trainer(_train_cfg(**{field: value})).step(img, noise=noise)
        want = _trainer(_train_cfg()).step(img, noise=noise)
        np.testing.assert_allclose(got["loss"].item(), want["loss"].item(), rtol=0)
        return
    if field == "mesh_shape":
        from glom_tpu.parallel.mesh import make_mesh as jax_make_mesh

        with pytest.raises(ValueError, match=item) as ours:
            _trainer(_train_cfg(**{field: value}))
        with pytest.raises(ValueError, match=item) as theirs:
            jax_make_mesh(value, devices=jax.devices()[:1])
        assert str(ours.value) == str(theirs.value)
        return
    with pytest.raises(NotImplementedError, match=item):
        _trainer(_train_cfg(**{field: value}))


@pytest.mark.parametrize("knob,value,item", [
    ("remat", True, None),
    ("fuse_ff", True, None),
    ("ff_impl", "fused", None),
    ("attention_impl", "ring", None),
])
def test_train_step_refuses_unported_knobs(knob, value, item):
    """``remat``, ``fuse_ff``, ``ff_impl="fused"`` and ``attention_impl="ring"``
    (the Trainer's mesh of one rank: the ring of one block) train, and take
    the step of the plain configuration (the same weights, image and noise:
    the same loss and parameters to rounding)."""
    kw = {**KERNELS, knob: value}
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            Trainer(GlomConfig(**TINY, **kw), _train_cfg(), device="cpu")
        return
    img, noise = _img(), torch.from_numpy(_img(seed=2))
    runs = []
    for cfg_kw in (kw, KERNELS):
        trainer = Trainer(GlomConfig(**TINY, **cfg_kw), _train_cfg(), device="cpu")
        metrics = trainer.step(img, noise=noise)
        runs.append((metrics["loss"].item(), _flat(_to_np(trainer.state.params))))
    (loss, params), (want_loss, want_params) = runs
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    for k in want_params:
        np.testing.assert_allclose(params[k], want_params[k], atol=1e-6, err_msg=k)


def test_scan_unroll_changes_nothing():
    imgs = list(_batches(2))
    runs = []
    for unroll in (1, 3):
        trainer = _trainer(_train_cfg(steps=2), scan_unroll=unroll)
        trainer.fit(iter(imgs))
        runs.append(_flat(_to_np(trainer.state.params)))
    for k in runs[0]:
        np.testing.assert_array_equal(runs[1][k], runs[0][k])


def test_cli_trains_on_the_cpu_and_refuses_unported_flags(tmp_path, capsys):
    argv = ["--dim", "32", "--levels", "3", "--image-size", "16", "--patch-size", "4",
            "--batch-size", "2", "--steps", "2", "--log-every", "1", "--device", "cpu",
            "--ff-impl", "pallas", "--fused-ff-bwd", "--attention-impl", "pallas",
            "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"]
    final = train.main(argv)
    assert np.isfinite(final["loss"]) and ckpt_lib.latest_step(str(tmp_path)) == 2
    with open(tmp_path / "config.json") as f:
        recorded = json.load(f)
    assert recorded["glom"]["ff_impl"] == "pallas" and recorded["train"]["steps"] == 2
    with pytest.raises(SystemExit):
        train.parse_args(["--checkpoint-backend", "orbax"])
    assert "orbax backend adapts the JAX ecosystem" in capsys.readouterr().err
    # the elastic flags are taken, with the JAX CLI's names and defaults
    args = train.parse_args(["--checkpoint-backend", "sharded", "--stop-poll-steps", "5"])
    assert (args.checkpoint_backend, args.stop_poll_steps) == ("sharded", 5)
    assert (train.parse_args([]).checkpoint_backend, train.parse_args([]).stop_poll_steps) == (
        "npz", 10)
    # the mesh flags are taken, with the JAX CLI's names and defaults
    args = train.parse_args(["--param-sharding", "ep", "--mesh", "2", "1", "1", "--coordinator",
                             "h:1", "--num-processes", "2", "--process-id", "0"])
    assert (args.param_sharding, args.mesh, args.coordinator, args.num_processes,
            args.process_id) == ("ep", [2, 1, 1], "h:1", 2, 0)
    assert train.parse_args([]).param_sharding == "tp"
    # the step's knobs are flags now, with the JAX CLI's names and defaults
    args = train.parse_args(["--remat", "--remat-policy", "full", "--fuse-ff", "--ff-impl", "fused"])
    assert (args.remat, args.remat_policy, args.fuse_ff, args.ff_impl) == (True, "full", True, "fused")
    args = train.parse_args([])
    assert (args.remat, args.remat_policy, args.fuse_ff) == (False, "dots", False)


def test_checkpoint_loader_pins_and_falls_back(tmp_path):
    """load_checkpoint_state: the newest valid step by default, quarantining
    a corrupt newer one; a pinned corrupt step raises."""
    d = str(tmp_path)
    trainer = _trainer(_train_cfg(tmp_path, steps=2, checkpoint_every=1))
    trainer.fit(_batches(2))
    _corrupt(ckpt_lib.npz_path(d, 2))
    with pytest.raises(ckpt_lib.CorruptCheckpointError):
        denoise.load_checkpoint_state(d, step=2, device="cpu")
    with pytest.warns(UserWarning, match="quarantined"):
        step, _, _, params = denoise.load_checkpoint_state(d, device="cpu")
    assert step == 1 and os.path.exists(ckpt_lib.npz_path(d, 2) + ".corrupt")
    assert set(params) == {"glom", "decoder"}
