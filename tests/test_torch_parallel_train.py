"""The port's Trainer on a mesh of gloo ranks against glom_tpu's sharded step.

Each world is started once by a module fixture (``tests/torch_mesh_worker.py``):
one of 4 ranks runs (2, 2, 1) under ``param_sharding="tp"`` (the FF through
the kernels' wrappers with K2/K3's backward, gradients clipped by the global
norm), (2, 1, 2) with the ring consensus (the locality mask on) and (2, 1, 2)
with Ulysses; one of 2 ranks runs (1, 2, 1) under ``"ep"``, (2, 1, 1) with
``ff_impl="fused"`` (K8 per data shard) and (2, 1, 1) with two accumulated
microbatches, and round-trips a checkpoint, and (1, 1, 2) with the
consensus kernels' wrappers on the columns gathered over seq.  Every rank draws the same
weights from the seed; the test hands every world the same two global
batches and the noise ``glom_tpu``'s step draws from its key.

Two steps of each are held against ``glom_tpu``'s jitted step on the faked
8-device CPU mesh (its Trainer, its FF through its Pallas kernel in interpret
mode under shard_map where its config names it) from the same weights, and
against the port's one-process Trainer: the losses, the logged global grad
norm, and every parameter after the steps, gathered, within 1e-4 (f32).
"""

import io
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401 (glom_tpu's trainer builds its optax chain)
import pytest
import torch

from glom_tpu import config as jax_config
from glom_tpu.parallel.mesh import make_mesh as jax_make_mesh
from glom_tpu.training import denoise as jax_denoise
from glom_tpu.training.trainer import Trainer as JaxTrainer
from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.parallel.mesh import AxisGroup, Mesh
from glom_tpu_torch.training import train as train_cli
from glom_tpu_torch.training.eval import make_psnr_fn
from glom_tpu_torch.training.metrics import MetricLogger
from glom_tpu_torch.training.trainer import Trainer
from tests.torch_mesh_world import REPO, run_world

torch.set_num_threads(1)

STEP_TOL = 1e-4
STEPS, BATCH = 2, 4
TINY = dict(dim=16, levels=3, image_size=16, patch_size=4)
BASE = dict(batch_size=BATCH, iters=2, learning_rate=1e-3)
NOISE_KEY = 7

# (name, mesh, port config, port train, glom_tpu config, glom_tpu train)
CASES = [
    ("tp_221", (2, 2, 1),
     dict(ff_impl="pallas", ff_fused_bwd=True, attention_impl="pallas"),
     dict(param_sharding="tp", grad_clip_norm=0.05),
     dict(ff_impl="pallas", ff_fused_bwd=True), dict(param_sharding="tp", grad_clip_norm=0.05)),
    ("ring_212", (2, 1, 2), dict(attention_impl="ring", local_consensus_radius=1.5),
     dict(param_sharding="replicated"),
     dict(attention_impl="ring", local_consensus_radius=1.5), dict(param_sharding="replicated")),
    ("ulysses_212", (2, 1, 2), dict(attention_impl="ulysses", consensus_self=True),
     dict(param_sharding="tp"), None, None),
    ("ep_121", (1, 2, 1), dict(ff_impl="pallas", ff_fused_bwd=True), dict(param_sharding="ep"),
     dict(ff_impl="pallas", ff_fused_bwd=True), dict(param_sharding="ep")),
    ("fused_211", (2, 1, 1), dict(ff_impl="fused"), dict(param_sharding="replicated"),
     dict(ff_impl="fused"), dict(param_sharding="replicated")),
    ("accum_211", (2, 1, 1), dict(ff_impl="pallas"), dict(grad_accum_steps=2), None, None),
    ("gathered_112", (1, 1, 2), dict(attention_impl="pallas", local_consensus_radius=1.5),
     dict(param_sharding="replicated"),
     dict(attention_impl="dense", local_consensus_radius=1.5), dict(param_sharding="replicated")),
]
JAX_CASES = [c for c in CASES if c[4] is not None]


def _batches():
    """Two global batches and the noise glom_tpu's step draws for them from
    ``PRNGKey(NOISE_KEY)`` (``denoise.py``: ``rng, rng_noise = split(rng)``)."""
    imgs = np.random.default_rng(3).standard_normal((STEPS, BATCH, 3, 16, 16)).astype(np.float32)
    key, noise = jax.random.PRNGKey(NOISE_KEY), []
    for k in range(STEPS):
        key, kn = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(kn, imgs[k].shape, jnp.float32)))
    return imgs, np.stack(noise)


def _unflat(flat: dict, prefix: str) -> dict:
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *path, leaf = key[len(prefix) + 1:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_train")
    imgs, noise = _batches()
    np.savez(root / "batches.npz", imgs=imgs, noise=noise)
    jobs = {2: [], 4: []}
    for name, mesh, cfg, tc, _, _ in CASES:
        job = {"kind": "train", "name": name, "mesh": list(mesh), "config": {**TINY, **cfg},
               "train": {**BASE, **tc}, "inputs": str(root / "batches.npz")}
        if name == "ep_121":
            job["checkpoint"] = str(root / "ckpt_ep")
        jobs[int(np.prod(mesh))].append(job)
    results = {}
    for world, world_jobs in jobs.items():
        results.update(run_world(str(root / f"world{world}"), world, world_jobs))
    return imgs, noise, results, root


def _one_process(cfg: dict, tc: dict, imgs, noise):
    """The port's one-process Trainer on the same seed, batches and noise
    (the ring and Ulysses are the dense consensus on one rank)."""
    cfg = dict(cfg)
    if cfg.get("attention_impl") in ("ring", "ulysses"):
        cfg["attention_impl"] = "dense"
    trainer = Trainer(GlomConfig(**TINY, **cfg), TrainConfig(**BASE, **tc), device="cpu",
                      logger=MetricLogger(stream=io.StringIO()))
    metrics = [trainer.step(imgs[k], noise=torch.from_numpy(noise[k])) for k in range(STEPS)]
    params = ckpt_lib.flatten({"p": _np(trainer.state.params)})
    return ([float(m["loss"]) for m in metrics], [float(m["grad_norm"]) for m in metrics],
            {k[2:]: v for k, v in params.items()})


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _assert_params(rank0: dict, want: dict, what: str):
    for k, v in want.items():
        err = _rel(rank0[f"final/{k}"], v)
        assert err <= STEP_TOL, (what, k, err)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_mesh_step_matches_the_one_process_step(runs, case):
    """Two steps on the mesh against two on one process: the same loss, the
    same global grad norm (the sharded leaves' squares summed over the model
    group), the same parameters, and every rank logs the same numbers."""
    name, _, cfg, tc, _, _ = case
    imgs, noise, results, _ = runs
    parts = results[name]
    loss, norm, want = _one_process(cfg, tc, imgs, noise)
    np.testing.assert_allclose(parts[0]["loss"], loss, rtol=STEP_TOL)
    np.testing.assert_allclose(parts[0]["grad_norm"], norm, rtol=STEP_TOL)
    _assert_params(parts[0], want, name)
    for part in parts[1:]:
        for key in ("loss", "grad_norm", "nonfinite_grads", "psnr"):
            np.testing.assert_array_equal(part[key], parts[0][key])
    assert not parts[0]["nonfinite_grads"].any()


def _jax_run(mesh_shape, jcfg: dict, jtc: dict, rank0: dict, imgs):
    n = int(np.prod(mesh_shape))
    mesh = jax_make_mesh(mesh_shape, devices=jax.devices()[:n])
    config = jax_config.GlomConfig(**TINY, **jcfg)
    train = jax_config.TrainConfig(**BASE, **jtc, donate=False, log_every=0,
                                   monitor_numerics=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trainer = JaxTrainer(config, train, mesh=mesh)
    params = jax.tree_util.tree_map(jnp.asarray, _unflat(rank0, "init"))
    state = jax_denoise.DenoiseState(params, trainer.tx.init(params), jnp.zeros((), jnp.int32),
                                     jax.random.PRNGKey(NOISE_KEY))
    state = jax.device_put(state, trainer._state_sh)
    losses, norms = [], []
    for k in range(STEPS):
        state, metrics = trainer._step(state, jax.device_put(jnp.asarray(imgs[k]),
                                                             trainer._batch_sh))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    flat = ckpt_lib.flatten({"p": jax.tree_util.tree_map(np.asarray, state.params)})
    return losses, norms, {k[2:]: v for k, v in flat.items()}


@pytest.mark.parametrize("case", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_mesh_step_matches_glom_tpus_sharded_step(runs, case):
    """Two steps on the port's mesh of ranks against two of glom_tpu's jitted
    step on the same mesh shape of faked devices, from the same weights and
    noise."""
    name, mesh, _, _, jcfg, jtc = case
    imgs, _, results, _ = runs
    rank0 = results[name][0]
    loss, norm, want = _jax_run(mesh, jcfg, jtc, rank0, imgs)
    np.testing.assert_allclose(rank0["loss"], loss, rtol=STEP_TOL)
    np.testing.assert_allclose(rank0["grad_norm"], norm, rtol=STEP_TOL)
    _assert_params(rank0, want, name)


def test_ep_checkpoint_is_gathered_written_once_and_resliced(runs):
    """Rank 0 writes the gathered state (the whole float32 tree, which
    glom_tpu loads); a fresh trainer on the mesh restores and slices it."""
    _, _, results, root = runs
    parts = results["ep_121"]
    directory = str(root / "ckpt_ep")
    assert ckpt_lib.latest_step(directory) == STEPS
    for part in parts:
        assert int(part["restored_step"]) == STEPS
        for key in [k for k in part if k.startswith("final/")]:
            np.testing.assert_array_equal(part["restored/" + key[6:]], part[key])
    from glom_tpu.training.denoise import load_checkpoint_state

    step, _, _, params = load_checkpoint_state(directory)
    assert step == STEPS
    np.testing.assert_array_equal(np.asarray(params["glom"]["top_down"]["w1"]),
                                  parts[0]["final/glom/top_down/w1"])


@pytest.mark.parametrize("name", ["ring_212", "ulysses_212", "tp_221"])
def test_mesh_psnr_is_the_one_process_psnr(runs, name):
    """The eval's PSNR on a mesh (each rank's rows and columns, the MSE
    averaged over the data and seq groups; every rank the same number) is the
    one-process PSNR of the same weights, batch and noise."""
    imgs, noise, results, _ = runs
    parts = results[name]
    cfg = dict(next(c[2] for c in CASES if c[0] == name))
    if cfg.get("attention_impl") in ("ring", "ulysses"):
        cfg["attention_impl"] = "dense"
    params = glom_model.tree_map(torch.from_numpy, _unflat(parts[0], "final"))
    want = make_psnr_fn(GlomConfig(**TINY, **cfg), iters=BASE["iters"])(
        params, torch.from_numpy(imgs[0]), noise=torch.from_numpy(noise[0]))
    assert len({float(p["psnr"]) for p in parts}) == 1
    np.testing.assert_allclose(float(parts[0]["psnr"]), float(want), rtol=1e-5)


# -- the refusals and the CLI ---------------------------------------------

def _fake_mesh(**shape):
    shape = {"data": 1, "model": 1, "seq": 1, **shape}
    axes = {a: AxisGroup(a, None, tuple(range(s)), 0) for a, s in shape.items()}
    return Mesh(shape, 0, axes, None)


@pytest.mark.parametrize("mesh,tc,cfg,err,match", [
    (dict(data=4), dict(batch_size=2), {}, ValueError, "batch_size 2 not divisible by data-axis "
                                                       "size 4"),
    (dict(data=2), dict(batch_size=4, grad_accum_steps=4), {}, ValueError,
     "microbatch 1 .* not divisible by data-axis size 2"),
    (dict(seq=3), dict(batch_size=2), dict(attention_impl="ring"), ValueError,
     "n=16 patch columns not divisible by seq-axis size 3"),
    (dict(data=2), dict(batch_size=2, diag_every=2), {}, NotImplementedError, "item 6b"),
    (dict(data=2), dict(batch_size=2, consistency="mse"), {}, NotImplementedError, "item 6b"),
    (dict(model=2), dict(batch_size=2, param_sharding="ep"), dict(fuse_ff=True),
     NotImplementedError, "item 6b"),
])
def test_the_trainer_refuses_what_the_mesh_cannot_run(mesh, tc, cfg, err, match):
    with pytest.raises(err, match=match):
        Trainer(GlomConfig(**TINY, **cfg), TrainConfig(**tc), device="cpu",
                mesh=_fake_mesh(**mesh))


def test_auto_under_a_seq_axis_is_the_ring_or_warns():
    with pytest.warns(UserWarning, match="cannot resolve to the ring"):
        with pytest.raises(ValueError, match="not divisible by seq-axis size 3"):
            Trainer(GlomConfig(**TINY, attention_impl="auto"), TrainConfig(batch_size=2),
                    device="cpu", mesh=_fake_mesh(seq=3))


def test_the_cli_trains_with_one_command_a_rank(tmp_path):
    """``python -m glom_tpu_torch.training.train --mesh 2 1 1 --num-processes
    2 --process-id i --coordinator ...`` on the CPU: rank 0 logs and writes
    the checkpoint, which glom_tpu loads; the refused flags cite item 6b."""
    ckpt = tmp_path / "ckpt"
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    argv = ["--dim", "16", "--levels", "3", "--image-size", "16", "--patch-size", "4",
            "--batch-size", "4", "--steps", "2", "--iters", "2", "--log-every", "1",
            "--device", "cpu", "--mesh", "2", "1", "1", "--param-sharding", "replicated",
            "--ff-impl", "pallas", "--checkpoint-dir", str(ckpt), "--checkpoint-every", "2",
            "--coordinator", "file://" + str(tmp_path / "store"), "--num-processes", "2"]
    procs = [subprocess.Popen([sys.executable, "-m", "glom_tpu_torch.training.train", *argv,
                               "--process-id", str(r)], env=env, cwd=str(tmp_path),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    lines0 = outs[0][0].splitlines()
    assert sum('"loss"' in line for line in lines0) == 2 and "{'final'" in lines0[-1]
    assert outs[1][0].strip() == ""      # rank 1 logs nothing
    assert ckpt_lib.latest_step(str(ckpt)) == 2
    from glom_tpu.training.denoise import load_checkpoint_state

    assert load_checkpoint_state(str(ckpt))[0] == 2
    for flag in (["--checkpoint-backend", "sharded"], ["--stop-poll-steps", "5"]):
        with pytest.raises(SystemExit):
            train_cli.parse_args(flag)
