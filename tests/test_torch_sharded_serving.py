"""The port's sharded serving engine (glom_tpu_torch/serving/sharded.py) against
glom_tpu's on the CPU.

Gloo worlds of CPU processes (``tests/torch_mesh_worker.py``'s ``serve`` job,
started once by a module fixture) each build a ``ServingEngine`` with
``mesh_shape`` from one checkpoint written by glom_tpu's
``make_demo_checkpoint``: rank 0 leads and serves ``/embed``,
``/reconstruct`` and ``/parse`` (with the ``quality`` post-pass after each
batch) and the index forward, the other ranks follow.  Two ranks run (1,2,1)
TP (with a hot reload), (2,1,1) DP on ``"pallas"`` and on ``"fused"``,
(1,2,1) EP at ``levels=4`` (bottom-up's 4 groups split, top-down's 3
replicated), (1,1,2) seq, and a follower lost mid-flight; four ranks run
(2,2,1) int8 TP.

glom_tpu's sharded engine runs in this process on the faked 8-device CPU
mesh of the same shape and sharding, on its plain ops, and each case's
answers are held against it: f32 within 1e-4 relative (normwise over the
batch), int8 (bf16 compute) within 1e-2 as ``tests/test_torch_quant.py``
holds it.  A DP rank's rows are bitwise the port's one-rank engine at the
bucket a data rank computes, and every rank holds the local shape glom_tpu's
placement gives that leaf.
"""

import json
import os
import shutil
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from glom_tpu.config import GlomConfig as JaxGlomConfig
from glom_tpu.serving.engine import DEMO_CONFIG as JAX_DEMO_CONFIG
from glom_tpu.serving.engine import ServingEngine as JaxServingEngine
from glom_tpu.serving.engine import make_demo_checkpoint as jax_make_demo_checkpoint
from glom_tpu_torch.serving.engine import ServingEngine
from tests.torch_mesh_world import REPO, run_world

torch.set_num_threads(1)

FWD_RTOL = 1e-4         # f32, over the forward
BF16_RTOL = 1e-2        # int8: bf16 weights and compute
ITEM_1B = "ROADMAP queue 1, item 6b-rest 1b"
IMGS = 3                # padded to bucket 4
FAIL_TIMEOUT_S = 5.0    # the lost-follower case's group timeout

# (name, ranks, mesh, the port's engine arguments, checkpoint, glom_tpu's arguments)
CASES = [
    ("tp", 2, (1, 2, 1), dict(param_sharding="tp", ff_impl="pallas", attention_impl="pallas",
                              buckets=(2, 4)), "demo", dict(param_sharding="tp")),
    ("dp_pallas", 2, (2, 1, 1), dict(ff_impl="pallas", attention_impl="pallas", buckets=(4,)),
     "demo", {}),
    ("dp_fused", 2, (2, 1, 1), dict(ff_impl="fused", buckets=(4,)), "demo", {}),
    ("ep", 2, (1, 2, 1), dict(param_sharding="ep", ff_impl="pallas", buckets=(2, 4)),
     "levels4", dict(param_sharding="ep")),
    ("seq", 2, (1, 1, 2), dict(ff_impl="pallas", attention_impl="pallas", buckets=(2, 4)),
     "demo", {}),
    ("int8_tp", 4, (2, 2, 1), dict(param_sharding="tp", quant="int8", ff_impl="pallas",
                                   buckets=(2, 4)), "demo", dict(param_sharding="tp",
                                                                 quant="int8")),
]
NAMES = [c[0] for c in CASES]
DP = ["dp_pallas", "dp_fused"]
RELOAD = (4, 5)          # the tp case writes step 4 (step 0 plus seeded noise) and reloads it


def _case(name):
    return next(c for c in CASES if c[0] == name)


def _imgs() -> np.ndarray:
    return np.random.default_rng(7).standard_normal((IMGS, 3, 16, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_ckpts")
    demo, levels4 = str(root / "demo"), str(root / "levels4")
    jax_make_demo_checkpoint(demo)
    jax_make_demo_checkpoint(levels4, config=JaxGlomConfig(
        dim=JAX_DEMO_CONFIG.dim, levels=4, image_size=JAX_DEMO_CONFIG.image_size,
        patch_size=JAX_DEMO_CONFIG.patch_size))
    return {"demo": demo, "levels4": levels4}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, checkpoints):
    root = tmp_path_factory.mktemp("sharded_serving")
    inputs = str(root / "imgs.npz")
    np.savez(inputs, imgs=_imgs())
    jobs = {2: [], 4: []}
    dirs = {}
    for name, ranks, mesh, kw, ckpt, _ in CASES:
        # a copy a case: the tp case writes its reload step there
        dirs[name] = str(root / f"ckpt_{name}")
        shutil.copytree(checkpoints[ckpt], dirs[name])
        job = {"kind": "serve", "name": name, "ckpt": dirs[name], "inputs": inputs,
               "engine": {**kw, "mesh_shape": list(mesh)},
               "endpoints": ["embed", "reconstruct", "parse"]}
        if name == "tp":
            job["reload"] = list(RELOAD)
        if name in DP:
            job["one_rank"] = True
        if name == "dp_pallas":
            job["refuse"] = [{"buckets": [1, 2]}, {"warm_iters": 2},
                             {"extra_models": {"alt": dirs[name]}},
                             {"bulk_dir": str(root / "bulk")}, {"index_dir": str(root / "index")},
                             {"mesh_shape": [1, 4, 1]}]
        jobs[ranks].append(job)
    # last in its world: a follower that leaves without following
    dirs["die"] = str(root / "ckpt_die")
    shutil.copytree(checkpoints["demo"], dirs["die"])
    jobs[2].append({"kind": "serve", "name": "die", "ckpt": dirs["die"], "inputs": inputs,
                    "engine": {"mesh_shape": [2, 1, 1], "buckets": [4]}, "die": True,
                    "timeout_s": FAIL_TIMEOUT_S})
    results = {}
    for world, world_jobs in jobs.items():
        results.update(run_world(str(root / f"world{world}"), world, world_jobs))
    return results, dirs


_THEIRS = {}


def _theirs(checkpoints, name, ckpt_dir=None):
    """glom_tpu's sharded engine for a case, on the faked mesh (one per
    case and checkpoint directory, built on first use)."""
    _, _, mesh, kw, ckpt, jkw = _case(name)
    key = (name, ckpt_dir)
    if key not in _THEIRS:
        _THEIRS[key] = JaxServingEngine(ckpt_dir or checkpoints[ckpt], buckets=kw["buckets"],
                                        warmup=False, reload_poll_s=0, quality_sample=0,
                                        mesh_shape=mesh, **jkw)
    return _THEIRS[key]


@pytest.fixture(scope="module", autouse=True)
def _close_theirs():
    yield
    for engine in _THEIRS.values():
        engine.shutdown(drain=False)
    _THEIRS.clear()


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _leader(worlds, name) -> dict:
    return worlds[0][name][0]


def _their_answer(engine, endpoint) -> np.ndarray:
    """glom_tpu's answer on the images padded to bucket 4, as its request
    path pads them (its data-sharded jit takes whole buckets only)."""
    x = np.concatenate([_imgs(), np.zeros((4 - IMGS, 3, 16, 16), np.float32)])
    return np.asarray(engine.caches[endpoint](engine.params, x), np.float32)[:IMGS]


@pytest.mark.parametrize("endpoint", ["embed", "reconstruct"])
@pytest.mark.parametrize("name", NAMES)
def test_sharded_engine_matches_glom_tpus(worlds, checkpoints, name, endpoint):
    """The leader's answer against glom_tpu's engine on the same mesh and
    sharding, from the same checkpoint and images."""
    theirs = _theirs(checkpoints, name)
    want = _their_answer(theirs, endpoint)
    tol = BF16_RTOL if "int8" in name else FWD_RTOL
    assert _rel(_leader(worlds, name)[endpoint], want) <= tol


@pytest.mark.parametrize("name", NAMES)
def test_index_and_parse_run_on_every_rank(worlds, checkpoints, name):
    """/parse's inner index forward within 1e-4 of the port's one-rank engine
    (1e-2 under int8), and /parse answered with one packed row an image;
    every follower ran the same number of calls (the quality post-pass after
    each batch among them)."""
    _, _, _, kw, ckpt, _ = _case(name)
    parts = worlds[0][name]
    one = ServingEngine(checkpoints[ckpt], device="cpu", reload_poll_s=0, warmup=False,
                        **{k: v for k, v in kw.items() if k != "param_sharding"})
    try:
        want = one.run("index", _imgs())
    finally:
        one.shutdown(drain=False)
    assert _rel(parts[0]["index"], want) <= (BF16_RTOL if "int8" in name else FWD_RTOL)
    assert parts[0]["parse"].shape[0] == IMGS and np.isfinite(parts[0]["parse"]).all()
    calls = {int(p["calls"]) for p in parts[1:]}
    assert len(calls) == 1 and calls.pop() >= 7


def test_a_follower_serves_no_request(worlds):
    """A call of a follower's own would break the ranks' order: it raises
    before any collective, and the follower then follows as its peers do."""
    results, _ = worlds
    for name in NAMES:
        for part in results[name][1:]:
            assert str(part["own_call"]).startswith("rank ")
            assert "serves no request" in str(part["own_call"])


@pytest.mark.parametrize("endpoint", ["embed", "reconstruct", "parse"])
@pytest.mark.parametrize("name", DP)
def test_data_parallel_rows_are_bitwise_the_one_rank_engine(worlds, name, endpoint):
    """Each data rank's rows of a bucket-4 batch (3 images and a pad row) are
    bit for bit the port's one-rank engine at bucket 2 on the same rows."""
    part = _leader(worlds, name)
    np.testing.assert_array_equal(part[endpoint], part[f"one_rank_{endpoint}"])


def _their_local_shapes(engine) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(engine.params)[0]
    return {"params/" + "/".join(str(k.key) for k in path):
            tuple(leaf.sharding.shard_shape(leaf.shape)) for path, leaf in flat}


@pytest.mark.parametrize("name", NAMES)
def test_every_rank_holds_the_shard_glom_tpu_places(worlds, checkpoints, name):
    """Each rank's leaf shapes are the shard shapes of glom_tpu's placement
    (TP: the FF hidden halved; int8: ``int8_q`` split on h with its scale
    where it divides, the ``(g, 1, d)`` w2 scale replicated; EP: bottom-up's
    groups halved, top-down's replicated), and every leaf is contiguous (the
    kernels take no views)."""
    want = _their_local_shapes(_theirs(checkpoints, name))
    for part in worlds[0][name]:
        got = {k: tuple(int(s) for s in v) for k, v in part.items() if k.startswith("params/")}
        assert got == want
        assert bool(part["params_contiguous"])
    local = got
    if name == "int8_tp":
        assert local["params/glom/bottom_up/w1/int8_q"] == (3, 16, 32)
        assert local["params/glom/top_down/w2/int8_scale"] == (2, 1, 16)
    if name == "ep":
        assert local["params/glom/bottom_up/w1"][0] == 2
        assert local["params/glom/top_down/w1"][0] == 3


@pytest.mark.parametrize("name", NAMES)
def test_health_and_snapshots_report_the_mesh(worlds, name):
    """``/healthz`` carries glom_tpu's ``mesh`` and ``param_sharding``; every
    snapshot carries ``mesh``; a forward with collectives inside says it runs
    eagerly and why; nothing captured on the request path."""
    _, _, mesh, kw, _, _ = _case(name)
    part = _leader(worlds, name)
    health = json.loads(str(part["health"]))
    assert health["status"] == "ok"
    assert health["mesh"] == dict(zip(("data", "model", "seq"), mesh))
    assert health["param_sharding"] == kw.get("param_sharding", "replicated")
    eager = name in ("tp", "ep", "seq", "int8_tp")
    assert health["mesh_dispatch"]["graphs"] is not eager
    assert (ITEM_1B in (health["mesh_dispatch"]["eager_reason"] or "")) is eager
    snaps = json.loads(str(part["snapshots"]))
    assert snaps and all(s["mesh"] == health["mesh"] for s in snaps)
    assert all(("eager_reason" in s) is eager for s in snaps)
    assert int(part["captures"]) == 0


def test_hot_reload_lands_sharded_with_zero_captures(worlds, checkpoints):
    """A reload on the TP mesh restores the new step on every rank, placed as
    at start-up, serves it (against glom_tpu's TP engine on that step),
    captures nothing on the request path, and the followers free the set the
    swap displaced."""
    results, dirs = worlds
    part = results["tp"][0]
    assert bool(part["reloaded"]) and int(part["step_after"]) == RELOAD[0]
    assert tuple(part["reloaded/glom/bottom_up/w1"]) == (3, 16, 32)
    assert bool(part["reloaded_contiguous"])
    assert [int(p["step"]) for p in results["tp"][1:]] == [RELOAD[0]]
    # the follower dropped the set the leader freed at the swap
    assert [p["sets"].tolist() for p in results["tp"][1:]] == [[1]]
    theirs = _theirs(checkpoints, "tp", dirs["tp"])
    assert theirs.step == RELOAD[0]
    want = _their_answer(theirs, "embed")
    assert _rel(part["embed_after"], want) <= FWD_RTOL
    assert _rel(part["embed_after"], part["embed"]) > 1e-3   # another step's answer


def test_refusals_carry_glom_tpus_errors_or_their_queue_item(worlds, checkpoints):
    """Buckets off the data axis raise glom_tpu's error; a mesh larger than
    the world names its ranks; sessions, extra models, the bulk tier, the
    index and deploys on a mesh name ROADMAP item 6b-rest 1b, on every rank."""
    results, _ = worlds
    with pytest.raises(ValueError) as theirs:
        JaxServingEngine(checkpoints["demo"], buckets=(1, 2), warmup=False, reload_poll_s=0,
                         mesh_shape=(2, 1, 1))
    for part in results["dp_pallas"]:
        refused = json.loads(str(part["refusals"]))
        errors = {next(k for k in r if k != "error"): r.get("error", "") for r in refused}
        assert errors["buckets"] == f"ValueError: {theirs.value}"
        assert errors["mesh_shape"].startswith("ValueError: mesh_shape (1, 4, 1) needs 4 ranks")
        for name in ("warm_iters", "extra_models", "bulk_dir", "index_dir"):
            assert errors[name].startswith(f"NotImplementedError: {name} ")
            assert ITEM_1B in errors[name]
    assert ITEM_1B in str(results["dp_pallas"][0]["deploy_refused"])


def test_param_sharding_without_a_mesh_raises_glom_tpus_error(checkpoints):
    errors = []
    for engine in (ServingEngine, JaxServingEngine):
        kw = {"device": "cpu"} if engine is ServingEngine else {}
        with pytest.raises(ValueError) as info:
            engine(checkpoints["demo"], warmup=False, reload_poll_s=0, param_sharding="tp", **kw)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_a_lost_follower_fails_the_request_within_the_group_timeout(worlds):
    """A follower that leaves without following: the leader's request fails
    (never hangs) within the group's timeout, ``/healthz`` is no longer ok,
    and a later call fails at once."""
    part = _leader(worlds, "die")
    assert str(part["error"]), "the request did not fail"
    assert float(part["fail_s"]) < 2 * FAIL_TIMEOUT_S
    assert str(part["status"]) == "mesh_failed"
    assert str(part["after"]).startswith("MeshFailed: the mesh failed")


def _first_line(proc, timeout_s: float = 120.0) -> dict:
    """The first line ``proc`` prints, as JSON, waited for at most
    ``timeout_s`` (a rank that hangs fails the test, never the run)."""
    import queue
    import threading

    lines = queue.Queue()
    threading.Thread(target=lambda: lines.put(proc.stdout.readline()), daemon=True).start()
    try:
        return json.loads(lines.get(timeout=timeout_s))
    except queue.Empty:
        raise AssertionError(f"no line from the rank in {timeout_s} s") from None


def test_the_server_cli_serves_a_mesh_one_command_a_rank(tmp_path, checkpoints):
    """``python -m glom_tpu_torch.serving.server --mesh-shape 2,1,1`` on two
    gloo ranks of the CPU: rank 0 binds the port and serves ``/embed``
    (against the port's one-rank engine), rank 1 binds none, and rank 0's
    drain stops rank 1."""
    import urllib.request

    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    store = "file://" + str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "glom_tpu_torch.serving.server", "--checkpoint-dir",
         checkpoints["demo"], "--device", "cpu", "--port", "0", "--buckets", "2,4",
         "--reload-poll-s", "0", "--quality-sample", "0", "--mesh-shape", "2,1,1",
         "--coordinator", store, "--num-processes", "2", "--process-id", str(r)],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        line = _first_line(procs[0])
        assert line["event"] == "serving" and line["mesh"] == {"data": 2, "model": 1, "seq": 1}
        body = json.dumps({"images": _imgs().tolist()}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{line['port']}/embed", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = np.asarray(json.loads(r.read())["embeddings"], np.float32)
        assert _first_line(procs[1])["event"] == "following"
        procs[0].send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert codes == [0, 0], [p.stderr.read()[-2000:] for p in procs]
    one = ServingEngine(checkpoints["demo"], device="cpu", reload_poll_s=0, buckets=(2, 4),
                        warmup=False)
    try:
        np.testing.assert_allclose(got, one.run("embed", _imgs()), rtol=1e-5, atol=1e-6)
    finally:
        one.shutdown(drain=False)
