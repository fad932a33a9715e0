"""The port's GPipe pipeline and data-parallel forward against glom_tpu's on the CPU.

Two gloo worlds of CPU processes (``tests/torch_mesh_worker.py``, started once
by a module fixture) run ``glom_tpu_torch.parallel.pipeline.make_pipelined_apply``
and ``parallel.inference.make_data_parallel_forward`` from glom_tpu's weights
(drawn by its ``init_state``, carried across as numpy): two ranks on
``("pipe",) = (2,)`` (M = S and M > S, captures at t=0, on a stage boundary
and mid-chunk, ``return_all``, and remat with ``fuse_ff``) and on
``("data",) = (2,)`` at b=3 (the pad and the slice); four ranks on
``("pipe",) = (4,)`` and on (pipe 2, data 2), (pipe 2, model 2) and (pipe 2,
seq 2).  Every rank returns the whole result, and the ranks agree bitwise.

The forward is held against glom_tpu's ``make_pipelined_apply`` on the faked
8-device mesh and against its sequential ``apply``, within 1e-5 (as
``tests/test_pipeline.py``).  One train step through ``make_step_fn(...,
apply_fn=pp)`` is held against glom_tpu's sequential jitted step (optax's
Adam) from the same weights and noise: the loss within 1e-6, every
parameter within 1e-5 abs / 1e-4 rel, and each of Adam's first moments
(linear in the gradient: Adam's near-sign update hides a gradient off by a
constant factor) within 1e-4 normwise.  glom_tpu's own PP x DP and PP x TP x
SP step tests are ``xfail`` (its pipelined PP x DP lands 1.9e-3 from its
sequential step), so every step here is held against glom_tpu's sequential
step, at the tolerances above.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from glom_tpu import config as jax_config
from glom_tpu.models import glom as jax_glom
from glom_tpu.parallel.inference import make_data_parallel_forward as jax_dp_forward
from glom_tpu.parallel.inference import pad_batch as jax_pad_batch
from glom_tpu.parallel.pipeline import make_pipelined_apply as jax_pipelined_apply
from glom_tpu.training import denoise as jax_denoise
from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.convert import params_from_numpy
from glom_tpu_torch.kernels import fused_update
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.parallel.inference import pad_batch
from glom_tpu_torch.parallel.mesh import AxisGroup, Mesh, make_mesh
from glom_tpu_torch.parallel.pipeline import make_pipelined_apply
from glom_tpu_torch.training import denoise
from glom_tpu_torch.training.optim import Optimizer
from tests.torch_mesh_world import REPO, run_world

torch.set_num_threads(1)

FWD_TOL = 1e-5
LOSS_RTOL = 1e-6
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
MOMENT_RTOL = 1e-4
LR = 1e-3
TINY = dict(dim=16, levels=3, image_size=16, patch_size=4)
REMAT = dict(TINY, remat=True, remat_policy="dots", fuse_ff=True)
STEP = dict(batch_size=4, iters=4, learning_rate=LR)   # loss at t=3: mid-chunk (k=2)

# forward calls at b=4, iters=4 on two stages (k=2): t=0, a boundary (2), mid-chunk (3)
FWD2 = [dict(iters=4), dict(iters=4, capture_timestep=0), dict(iters=4, capture_timestep=2),
        dict(iters=4, capture_timestep=3), dict(iters=4, return_all=True)]
# (name, ranks, mesh, axes, config, pipeline kwargs, batch, forward calls, step?)
PIPE_CASES = [
    ("pipe2", 2, (2,), ("pipe",), TINY, dict(num_microbatches=2), 4, FWD2, True),
    ("pipe2_m4", 2, (2,), ("pipe",), TINY, dict(num_microbatches=4), 4,
     [dict(iters=4), dict(iters=4, capture_timestep=3)], False),
    ("pipe2_remat", 2, (2,), ("pipe",), REMAT, dict(num_microbatches=2), 4,
     [dict(iters=4)], True),
    ("pipe4", 4, (4,), ("pipe",), TINY, dict(num_microbatches=4), 8,
     [dict(iters=8), dict(iters=8, capture_timestep=5), dict(iters=8, return_all=True)], False),
    ("pipe2_data2", 4, (2, 2), ("pipe", "data"), TINY,
     dict(num_microbatches=2, data_axis="data"), 4, [dict(iters=4)], True),
    ("pipe2_model2", 4, (2, 2), ("pipe", "model"), TINY,
     dict(num_microbatches=2, model_axis="model"), 4, [dict(iters=4)], True),
    ("pipe2_seq2", 4, (2, 2), ("pipe", "seq"), TINY, dict(num_microbatches=2, seq_axis="seq"),
     4, [dict(iters=4, capture_timestep=3)], True),
]
DP_CALLS = [dict(iters=4), dict(iters=4, return_all=True)]
FWD_IDS = [(c[0], i) for c in PIPE_CASES for i in range(len(c[7]))]
STEP_IDS = [c[0] for c in PIPE_CASES if c[8]]


def _jax_state(cfg: dict, seed: int = 11):
    """glom_tpu's initial train state (its init, optax's Adam)."""
    config = jax_config.GlomConfig(**cfg)
    tx = optax.adam(LR)
    return config, tx, jax_denoise.init_state(jax.random.PRNGKey(seed), config, tx)


def _imgs(b: int) -> np.ndarray:
    return np.random.default_rng(b).standard_normal((b, 3, 16, 16)).astype(np.float32)


def _noise(state, shape) -> np.ndarray:
    """The noise glom_tpu's step draws (``rng, rng_noise = split(state.rng)``)."""
    _, key = jax.random.split(state.rng)
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _write_inputs(path, state, img, noise=None) -> str:
    flat = ckpt_lib.flatten({"p": jax.tree_util.tree_map(np.asarray, state.params)})
    arrays = {k[2:]: v for k, v in flat.items()}
    np.savez(path, img=img, **({} if noise is None else {"noise": noise}), **arrays)
    return str(path)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    _, _, state = _jax_state(TINY)
    _, _, remat_state = _jax_state(REMAT)
    inputs = {
        4: _write_inputs(root / "b4.npz", state, _imgs(4), _noise(state, (4, 3, 16, 16))),
        8: _write_inputs(root / "b8.npz", state, _imgs(8)),
        3: _write_inputs(root / "b3.npz", state, _imgs(3)),
        "remat": _write_inputs(root / "remat.npz", remat_state, _imgs(4),
                               _noise(remat_state, (4, 3, 16, 16))),
    }
    jobs = {2: [], 4: []}
    for name, ranks, mesh, axes, cfg, kw, b, calls, step in PIPE_CASES:
        job = {"kind": "pipe", "name": name, "mesh": list(mesh), "axes": list(axes),
               "config": cfg, "pipeline": kw, "forward": calls,
               "inputs": inputs["remat" if cfg is REMAT else b]}
        if step:
            job["step"] = STEP
        jobs[ranks].append(job)
    jobs[2].append({"kind": "dp_forward", "name": "dp2", "mesh": [2], "axes": ["data"],
                    "config": TINY, "forward": DP_CALLS, "inputs": inputs[3]})
    # the (pipe 2, model 2) forward again, its FF function recording any view
    jobs[4].append({**next(j for j in jobs[4] if j["name"] == "pipe2_model2"),
                    "name": "pipe2_model2_contiguous", "check_contiguous": True,
                    "forward": [dict(iters=4)]})
    jobs[4][-1].pop("step", None)
    results = {}
    for world, world_jobs in jobs.items():
        results.update(run_world(str(root / f"world{world}"), world, world_jobs))
    return results


def _case(name):
    return next(c for c in PIPE_CASES if c[0] == name)


def _outputs(part: dict, i: int) -> list:
    if f"f{i}/out" in part:
        return [part[f"f{i}/out"]]
    return [part[f"f{i}/final"], part[f"f{i}/captured"]]


def _as_list(out) -> list:
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


def _jax_mesh(shape, axes) -> JaxMesh:
    n = int(np.prod(shape))
    return JaxMesh(np.array(jax.devices()[:n]).reshape(shape), axes)


@pytest.mark.parametrize("name,i", FWD_IDS, ids=[f"{n}-{i}" for n, i in FWD_IDS])
def test_pipelined_forward_matches_glom_tpu(worlds, name, i):
    """Every rank's whole result against glom_tpu's pipelined forward on the
    faked mesh of the same shape and against its sequential forward."""
    _, _, mesh, axes, cfg, kw, b, calls, _ = _case(name)
    config, _, state = _jax_state(cfg)
    img = jnp.asarray(_imgs(b))
    pp = jax_pipelined_apply(_jax_mesh(mesh, axes), config, **kw)
    ref_pp = _as_list(jax.jit(lambda p, x: pp(p, x, **calls[i]))(state.params["glom"], img))
    ref_seq = _as_list(jax_glom.apply(state.params["glom"], img, config=config, **calls[i]))
    parts = worlds[name]
    for part in parts:
        got = _outputs(part, i)
        assert len(got) == len(ref_seq)
        for g, want_pp, want_seq in zip(got, ref_pp, ref_seq):
            np.testing.assert_allclose(g, want_pp, atol=FWD_TOL, rtol=FWD_TOL)
            np.testing.assert_allclose(g, want_seq, atol=FWD_TOL, rtol=FWD_TOL)
        for g, g0 in zip(got, _outputs(parts[0], i)):
            np.testing.assert_array_equal(g, g0)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("name", STEP_IDS)
def test_pipelined_step_matches_glom_tpus_sequential_step(worlds, name):
    """One step of make_step_fn(apply_fn=pp) on every rank against one step of
    glom_tpu's sequential jitted step from the same weights and noise: the
    loss, the logged grad norm, every parameter and every first moment."""
    cfg = _case(name)[4]
    config, tx, state = _jax_state(cfg)
    train = jax_config.TrainConfig(**STEP, log_every=0)
    new, metrics = jax.jit(jax_denoise.make_step_fn(config, train, tx))(
        state, jnp.asarray(_imgs(4)))
    want = {k[2:]: v for k, v in ckpt_lib.flatten(
        {"p": jax.tree_util.tree_map(np.asarray, {"params": new.params,
                                                  "mu": new.opt_state[0].mu})}).items()}
    parts = worlds[name]
    for part in parts:
        np.testing.assert_allclose(part["loss"], float(metrics["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(part["grad_norm"], float(metrics["grad_norm"]), rtol=1e-4)
        for k, v in want.items():
            if k.startswith("params/"):
                np.testing.assert_allclose(part[k], v, atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                           err_msg=k)
            else:
                assert _rel(part[k], v) <= MOMENT_RTOL, (k, _rel(part[k], v))
            np.testing.assert_array_equal(part[k], parts[0][k])


def test_a_model_split_stage_hands_the_ff_contiguous_weights(worlds):
    """The FF kernels take contiguous weights (``kernels/ff.py::_check``) and
    the CPU's plain ops take views, so this pins it here: on (pipe 2, model 2)
    every rank's stage hands its FF function contiguous ``w1``, ``b1`` and
    ``w2`` (``parallel/pipeline.py::_Schedule._tp_slice``), checked by an
    ``ff_fn`` that records each one it gets as a view, and the forward is
    bitwise the one without the check."""
    for part, plain in zip(worlds["pipe2_model2_contiguous"], worlds["pipe2_model2"]):
        assert int(part["ff_calls"]) > 0
        assert part["views"].size == 0, sorted(set(part["views"].tolist()))
        np.testing.assert_array_equal(part["f0/out"], plain["f0/out"])


@pytest.mark.parametrize("i", range(len(DP_CALLS)))
def test_data_parallel_forward_pads_and_matches_glom_tpu(worlds, i):
    """b=3 over two data ranks: padded to 4, sliced back to 3 on every rank,
    equal to glom_tpu's data-parallel forward on the faked mesh."""
    config, _, state = _jax_state(TINY)
    fn = jax_dp_forward(_jax_mesh((2,), ("data",)), config, **DP_CALLS[i])
    want = np.asarray(fn(state.params["glom"], _imgs(3)))
    for part in worlds["dp2"]:
        got = part[f"f{i}/out"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)


# -- the refusals, the dispatch, the padding rule, the step's contract -------

def _fake_mesh(**shape):
    axes = {a: AxisGroup(a, None, tuple(range(s)), 0) for a, s in shape.items()}
    return Mesh(shape, 0, axes, None)


def _message(fn) -> str:
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


# (mesh, make kwargs, batch, call kwargs)
REFUSALS = [
    (dict(pipe=4), {}, 8, dict(iters=6)),                                # iters % S
    (dict(pipe=4), {}, 6, dict(iters=8)),                                # batch % M
    (dict(pipe=2, data=2), dict(data_axis="data"), 2, dict(iters=4)),    # microbatch % data
    (dict(pipe=2, seq=3), dict(seq_axis="seq"), 4, dict(iters=4)),       # n % seq
    (dict(pipe=2), {}, 4, dict(iters=4, capture_timestep=5)),            # capture range
    (dict(pipe=2, model=3), dict(model_axis="model"), 4, dict(iters=4)),  # hidden % model
]


@pytest.mark.parametrize("shape,kw,b,call", REFUSALS)
def test_refusals_carry_glom_tpus_messages(shape, kw, b, call):
    config, _, state = _jax_state(TINY)
    jmesh = _jax_mesh(tuple(shape.values()), tuple(shape))
    want = _message(lambda: jax_pipelined_apply(jmesh, config, **kw)(
        state.params["glom"], jnp.asarray(_imgs(b)), **call))
    params = params_from_numpy(jax.tree_util.tree_map(np.array, state.params["glom"]),
                               GlomConfig(**TINY))
    got = _message(lambda: make_pipelined_apply(_fake_mesh(**shape), GlomConfig(**TINY), **kw)(
        params, torch.from_numpy(_imgs(b)), **call))
    assert got == want


def test_no_stage_builds_the_fused_update(monkeypatch):
    """Under ff_impl="fused" a stage runs the grouped FF and the consensus, as
    glom_tpu's stage step (built without fused_fn); the sequential forward
    runs the fused update.  One stage of two microbatches, in process."""
    calls = []
    real = fused_update.fused_level_update

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(fused_update, "fused_level_update", spy)
    config = GlomConfig(**TINY, ff_impl="fused")
    params = glom_model.init(torch.Generator().manual_seed(0), config)
    img = torch.from_numpy(_imgs(4))
    pp = make_pipelined_apply(make_mesh((1,), ("pipe",)), config, num_microbatches=2)
    got = pp(params, img, iters=4)
    assert calls == []
    want = glom_model.apply(params, img, config=config, iters=4)
    assert len(calls) == 4
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FWD_TOL, rtol=FWD_TOL)


def test_one_stage_pipeline_gradients_match_the_sequential_forward():
    """In process on a mesh of one: the pipeline's own backward (two
    microbatches, a mid-chunk capture and the final both read by the loss)
    gives the sequential forward's gradients."""
    config = GlomConfig(**TINY)
    params = glom_model.init(torch.Generator().manual_seed(1), config)
    img = torch.from_numpy(_imgs(4))
    pp = make_pipelined_apply(make_mesh((1,), ("pipe",)), config, num_microbatches=2)

    def grads(fn):
        live = glom_model.tree_map(lambda t: t.detach().requires_grad_(), params)
        final, cap = fn(live)
        leaves = glom_model.tree_leaves(live)
        return torch.autograd.grad((final ** 2).mean() + (cap ** 2).mean(), leaves)

    got = grads(lambda p: pp(p, img, iters=4, capture_timestep=3))
    want = grads(lambda p: glom_model.apply(p, img, config=config, iters=4, capture_timestep=3))
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5


@pytest.mark.parametrize("b,target", [(3, 4), (4, 4), (1, 8)])
def test_pad_batch_is_glom_tpus_rule(b, target):
    imgs = _imgs(b)
    want = jax_pad_batch(imgs, target)
    np.testing.assert_array_equal(pad_batch(imgs, target), want)
    np.testing.assert_array_equal(pad_batch(torch.from_numpy(imgs), target).numpy(), want)
    with pytest.raises(ValueError, match=f"batch {b} exceeds pad target {b - 1}"):
        pad_batch(imgs, b - 1)


def test_apply_fn_takes_the_whole_batch():
    """The pipelined forward runs the whole batch on every rank: the step
    refuses a shard beside it, the loss refuses columns."""
    config, train = GlomConfig(**TINY), TrainConfig(**STEP)
    pp = make_pipelined_apply(make_mesh((1,), ("pipe",)), config)
    with pytest.raises(ValueError, match="takes no shard"):
        denoise.make_step_fn(config, train, Optimizer(LR), apply_fn=pp, shard=object())
    with pytest.raises(ValueError, match="takes no columns"):
        denoise.make_loss_fn(config, train, apply_fn=pp, columns=slice(0, 8))


@pytest.mark.parametrize("train_kw", [dict(grad_accum_steps=2), dict(consistency="mse")],
                         ids=["accum", "two_views"])
def test_apply_fn_keeps_accumulation_and_two_views(train_kw):
    """Through apply_fn (one stage of two microbatches, in process) the step
    accumulates two microbatches, or runs two views as one forward of 2b
    images, as the sequential step does: the same loss, parameters and
    first moments."""
    config = GlomConfig(**TINY)
    train = TrainConfig(**STEP, **train_kw)
    pp = make_pipelined_apply(make_mesh((1,), ("pipe",)), config, num_microbatches=2)
    img = torch.from_numpy(_imgs(4))
    noise = torch.randn((2,) * ("consistency" in train_kw) + (4, 3, 16, 16),
                        generator=torch.Generator().manual_seed(3))
    results = []
    for apply_fn in (pp, None):
        state = denoise.init_state(torch.Generator().manual_seed(2), config, Optimizer(LR))
        step = denoise.make_step_fn(config, train, Optimizer(LR), apply_fn=apply_fn)
        new, metrics = step(state, img, noise=noise)
        results.append((float(metrics["loss"]), glom_model.tree_leaves(new.params),
                        glom_model.tree_leaves(new.opt_state["mu"])))
    (loss, params, mu), (want_loss, want_params, want_mu) = results
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    for got, want in zip(params, want_params):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=PARAM_ATOL, rtol=PARAM_RTOL)
    for got, want in zip(mu, want_mu):
        assert _rel(got, want) <= MOMENT_RTOL


def test_the_example_runs_its_ranks_on_the_cpu(tmp_path):
    """``python -m glom_tpu_torch.examples.pipeline_parallel --device cpu``
    starts its ranks over gloo and prints glom_tpu's lines."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "glom_tpu_torch.examples.pipeline_parallel",
                          "--device", "cpu"], env=env, cwd=str(tmp_path), capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert lines[0] == "pipelined (4 stages): (8, 16, 4, 64)"
    err = float(lines[1].rsplit("=", 1)[1])
    assert err < 1e-4
    assert lines[2] == "grad leaves: 12"
