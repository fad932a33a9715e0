"""The port's elastic training (``glom_tpu_torch/resilience/elastic.py``, the
elastic meshes of ``parallel/mesh.py``, the exactly-once streams of
``training/data.py``, the stop-poll cadence) held against ``glom_tpu``.

  (a) ``elastic_mesh_shape`` is ``glom_tpu``'s over a grid of host counts,
      devices per host, model, seq and axis names, raises included (the
      same message);
  (b) ``host_block``, ``ElasticBatches`` and ``HostShardedBatches`` give
      ``glom_tpu``'s batches bitwise at host counts 1-4, and the cursor
      round-trips and re-partitions as ``glom_tpu``'s does;
  (c) under each spec of ``glom_tpu``'s ``TestElasticMachinery``, with a stub
      attempt (no trainer), the supervisors' plans, domains, counters, MTTR
      and metrics are equal;
  (d) on one rank with the mesh pinned, a shrink-restarted run's losses are
      bitwise its unfailed run's, a kill at every step boundary replays and
      skips no slot, and the losses are within LOSS_RTOL of ``glom_tpu``'s
      same run from the same (converted) weights;
  (e) on a gloo world of 2 CPU ranks, the real re-plan (2, 1, 1) -> (1, 1, 1)
      resumes from the sharded save, every rank's supervisor state is equal
      (and ``glom_tpu``'s), every rank consumes every slot once, and the
      losses are within LOSS_RTOL of ``glom_tpu``'s run on the faked mesh;
  (g) a stop requested on one rank of a 2-rank mesh lands, on every rank, on
      the step ``glom_tpu``'s cadence gives;
  (h) on a gloo world of 4 CPU ranks, a grow (3, 1, 1) -> (4, 1, 1) resumes
      the rank no saving mesh held from rank 0's cursor, and a torn shard
      file at the resume step falls back to the step before on every rank,
      the ranks the plan leaves out included.

The runs against ``glom_tpu`` train with ``noise_std=0``: the two packages'
noise comes from different generators (torch's and JAX's keys), and the
comparison is of the resume (weights, optimizer, slots), not of the noise;
the port's own bitwise leg (d) keeps the noise on.  Both start from
``glom_tpu``'s step-0 checkpoint.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from glom_tpu.config import GlomConfig as JaxGlomConfig
from glom_tpu.config import TrainConfig as JaxTrainConfig
from glom_tpu.obs.registry import MetricRegistry as JaxRegistry
from glom_tpu.parallel import mesh as jax_mesh
from glom_tpu.resilience import elastic as jax_elastic
from glom_tpu.resilience import faultinject as jax_faults
from glom_tpu.resilience import supervisor as jax_supervisor
from glom_tpu.training import data as jax_data
from glom_tpu.training.trainer import Trainer as JaxTrainer
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.obs.registry import MetricRegistry
from glom_tpu_torch.parallel import mesh as port_mesh
from glom_tpu_torch.resilience import elastic as port_elastic
from glom_tpu_torch.resilience import faultinject as port_faults
from glom_tpu_torch.resilience import supervisor as port_supervisor
from glom_tpu_torch.tools.chaos import elastic_run, supervisor_state
from glom_tpu_torch.training import data as port_data
from tests.torch_mesh_world import run_world
from tests.torch_mesh_worker import LossCapture

torch.set_num_threads(1)

TINY = dict(dim=8, levels=2, image_size=8, patch_size=4)
LOSS_RTOL = 1e-4
SHRINK = "host_preempt:kill@3; shrink_restart:shrink"


def _pin(host_count, devices_per_host):
    """glom_tpu's pinned mesh: hosts move only the data-plane partition."""
    return (1, 1, 1)


# -- (a) the re-plan arithmetic ----------------------------------------------

def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("axis_names", [("data", "model", "seq"), ("data", "model"),
                                        ("data", "model", "seq", "expert")])
def test_elastic_mesh_shape_is_glom_tpus(axis_names):
    cases = 0
    for hosts in range(0, 5):
        for per in range(0, 3):
            for model in (1, 2, 3):
                for seq in (1, 2):
                    kw = dict(model=model, seq=seq, axis_names=axis_names)
                    ours = _outcome(port_mesh.elastic_mesh_shape, hosts, per, **kw)
                    theirs = _outcome(jax_mesh.elastic_mesh_shape, hosts, per, **kw)
                    assert ours == theirs, (hosts, per, kw)
                    cases += ours[0] == "ok"
    assert cases > 10


# -- (b) the exactly-once streams --------------------------------------------

def test_host_block_is_glom_tpus():
    for b in (0, 1, 4, 6, 8):
        for h in (0, 1, 2, 3, 4):
            for i in (-1, 0, 1, 3, 4):
                assert (_outcome(port_data.host_block, b, i, h)
                        == _outcome(jax_data.host_block, b, i, h)), (b, i, h)


def _dataset():
    return np.random.default_rng(0).standard_normal((10, 3, 4, 4)).astype(np.float32)


@pytest.mark.parametrize("host_count", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", ["synthetic", "dataset"])
def test_streams_are_glom_tpus_bitwise(host_count, mode):
    """Each host's block and the assembled global batch across epoch
    boundaries (N=10 packs an epoch's tail with the next head)."""
    batch = 12
    kw = dict(seed=5, dataset=_dataset()) if mode == "dataset" else dict(seed=5)
    size = 4 if mode == "dataset" else 8
    for i in range(host_count):
        ours = port_data.ElasticBatches(batch, size, 3, host_index=i, host_count=host_count, **kw)
        theirs = jax_data.ElasticBatches(batch, size, 3, host_index=i, host_count=host_count,
                                         **kw)
        for _ in range(3):
            a, b = next(ours), next(theirs)
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert ours.state_dict() == theirs.state_dict()
        assert ours.epochs_started == theirs.epochs_started
    ours = port_data.HostShardedBatches(batch, size, 3, host_count=host_count, **kw)
    theirs = jax_data.HostShardedBatches(batch, size, 3, host_count=host_count, **kw)
    for _ in range(3):
        assert np.array_equal(next(ours), next(theirs))
    assert ours.state_dict() == theirs.state_dict() and ours.consumed == theirs.consumed


def test_cursor_round_trips_and_repartitions_as_glom_tpus():
    h4 = port_data.HostShardedBatches(8, 4, 3, seed=5, host_count=4)
    for _ in range(3):
        next(h4)
    h2 = port_data.HostShardedBatches(8, 4, 3, seed=5, host_count=2)
    h2.load_state_dict(h4.state_dict())
    assert h2._streams[0].repartitioned
    ref = jax_data.ElasticBatches(8, 4, 3, seed=5)
    ref.load_state_dict({"consumed": 24})
    assert np.array_equal(next(h2), next(ref))
    # a cursor of another stream is refused, with glom_tpu's message
    bad = {"consumed": 8, "seed": 6, "global_batch": 8, "epoch_size": 0}
    with pytest.raises(ValueError, match="different stream") as ours:
        port_data.ElasticBatches(8, 4, 3, seed=5).load_state_dict(bad)
    with pytest.raises(ValueError) as theirs:
        jax_data.ElasticBatches(8, 4, 3, seed=5).load_state_dict(bad)
    assert str(ours.value) == str(theirs.value)
    # the consumer's cursor, not the producer's, with batches in flight
    sp = port_data.StatefulPrefetcher(port_data.HostShardedBatches(4, 8, 3, host_count=2), 3)
    try:
        next(sp)
        assert sp.state_dict()["consumed"] == 4
    finally:
        sp.close()


def test_make_batches_elastic_is_glom_tpus():
    ours = port_data.make_batches("elastic", 8, 8, 3, seed=0, host_count=2, prefetch=2)
    theirs = jax_data.make_batches("elastic", 8, 8, 3, seed=0, host_count=2, prefetch=2)
    try:
        assert isinstance(ours, port_data.StatefulPrefetcher)
        assert np.array_equal(next(ours), next(theirs))
    finally:
        ours.close()
        theirs.close()
    one = port_data.make_batches("elastic", 8, 8, 3, seed=0, host_index=1, host_count=2,
                                 prefetch=0)
    assert isinstance(one, port_data.ElasticBatches)
    assert np.array_equal(next(one), next(jax_data.make_batches(
        "elastic", 8, 8, 3, seed=0, host_index=1, host_count=2, prefetch=0)))


# -- (c) the supervisor with a stub attempt ----------------------------------

PKGS = {
    "port": (port_elastic, port_faults, port_supervisor, MetricRegistry),
    "glom_tpu": (jax_elastic, jax_faults, jax_supervisor, JaxRegistry),
}

# glom_tpu's TestElasticMachinery: (spec, total steps, supervisor knobs, the
# attempt's first-call failure or None)
MACHINERY = {
    "heartbeat_delay": ("heartbeat_delay:delay@3*2", 8, {}, None),
    "silent_coordinator": ("coordinator_loss:lost@2", 10, {}, None),
    "crash_looping_domain": ("host_preempt:kill@3*3", 15, {}, None),
    "mttr_first_tick": ("host_preempt:kill@3*2", 8, {}, None),
    "grow": ("host_preempt:kill@3; shrink_restart:grow", 8, {}, None),
    "min_hosts_giveup": (SHRINK, 8, dict(hosts=2, min_hosts=2), None),
    "unattributed_preemption": (None, 1, dict(hosts=2), "preemption"),
    "job_replan_keeps_shrink": (SHRINK, 8, dict(job=True), "crash"),
    "job_crash_loop": (None, 8, dict(hosts=2, job=True, job_max=2), "always"),
}


def _stub_run(pkg: str, spec, total, knobs, failure) -> dict:
    elastic, faults, supervisor, registry_cls = PKGS[pkg]
    sim = elastic.SimClock()
    done, plans, calls = [], [], []

    def attempt(plan, ctx):
        plans.append(plan.to_json_dict())
        calls.append(1)
        if failure == "always":
            ctx.tick()
            raise RuntimeError("code bug: restarting cannot help")
        if failure == "preemption" and len(calls) == 1:
            ctx.tick()
            raise supervisor.PreemptionError("SIGTERM: no host attribution")
        if failure == "crash" and len(calls) == 1:
            raise RuntimeError("transient job bug")
        for _ in range(len(done), total):
            ctx.tick()
            done.append(plan.generation)
        return plan.generation

    knobs = dict(knobs)
    policy = supervisor.RestartPolicy(max_failures=3, window_s=1000.0, backoff_base_s=0.0,
                                      jitter=0.0)
    kw = dict(hosts=knobs.pop("hosts", 3), policy=policy, heartbeat_timeout_s=2.5,
              step_dt=1.0, clock=sim, sleep=sim.sleep, advance=sim.advance,
              registry=registry_cls())
    if knobs.pop("job", False):
        kw["job_policy"] = supervisor.RestartPolicy(
            max_failures=knobs.pop("job_max", 3), window_s=1000.0, backoff_base_s=0.0,
            jitter=0.0)
    kw.update(knobs)
    sup = elastic.ElasticSupervisor(attempt, **kw)
    try:
        if spec:
            with faults.injected(spec):
                result = sup.run()
        else:
            result = sup.run()
        outcome = ("ok", result)
    except supervisor.GiveUp as e:
        outcome = ("GiveUp", str(e).split(" (last:")[0])
    snap = kw["registry"].snapshot()
    return {"outcome": outcome, "done": done, "clock": sim.t,
            "metrics": {k: v for k, v in snap.items() if k.startswith("elastic_")},
            **supervisor_state(sup, plans)}


@pytest.mark.parametrize("case", list(MACHINERY))
def test_supervisor_decisions_are_glom_tpus(case):
    ours = _stub_run("port", *MACHINERY[case])
    theirs = _stub_run("glom_tpu", *MACHINERY[case])
    assert ours == theirs
    assert ours["plans"], ours


def test_a_sticky_cuda_error_gives_up_at_once():
    """The port's one difference: a job-level sticky CUDA error is not
    restarted (no restart inside the process can succeed)."""
    def attempt(plan, ctx):
        ctx.tick()
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    sim = port_elastic.SimClock()
    sup = port_elastic.ElasticSupervisor(attempt, hosts=2, step_dt=1.0, clock=sim,
                                         sleep=sim.sleep, advance=sim.advance)
    with pytest.raises(port_supervisor.GiveUp, match="sticky CUDA error"):
        sup.run()
    assert sup.restarts == 1


# -- (d) one rank, the mesh pinned --------------------------------------------

def _port_train(ckpt, steps, batch, **kw):
    return TrainConfig(batch_size=batch, steps=steps, log_every=1, checkpoint_every=1,
                       checkpoint_dir=ckpt, checkpoint_backend="sharded", **kw)


def _port_run(ckpt, *, hosts, steps, batch, spec, pinned=True, noise_std=1.0):
    capture, slots, plans = LossCapture(), [], []
    sup = elastic_run(hosts=hosts, steps=steps, batch=batch, spec=spec, ckpt_dir=ckpt,
                      device="cpu", slots=slots, glom=GlomConfig(**TINY),
                      train=_port_train(ckpt, steps, batch, noise_std=noise_std),
                      logger=lambda: capture, mesh_shape_fn=_pin if pinned else None,
                      plans=plans)
    return sup, capture.losses, slots, plans


def _jax_step0(directory: str) -> None:
    """glom_tpu's initial training state saved as step 0 (the converted
    weights both packages start from)."""
    JaxTrainer(JaxGlomConfig(**TINY), JaxTrainConfig(batch_size=8, noise_std=0.0)).save(directory)


def _jax_run(ckpt, *, hosts, steps, batch, spec, pinned):
    """glom_tpu's elastic run (its tests' driver) with noise_std=0 and the
    sharded backend: its losses at full precision, its supervisor state."""
    sim = jax_elastic.SimClock()
    capture, plans = LossCapture(), []

    def attempt(plan, ctx):
        plans.append(plan.to_json_dict())
        glom = JaxGlomConfig(**TINY)
        train = JaxTrainConfig(batch_size=batch, steps=steps, log_every=1, checkpoint_every=1,
                               checkpoint_dir=ckpt, checkpoint_backend="sharded",
                               noise_std=0.0)
        mesh = jax_mesh.make_elastic_mesh(1 if pinned else plan.host_count,
                                          1 if pinned else plan.devices_per_host)
        trainer = JaxTrainer(glom, train, mesh=mesh, logger=capture)
        inner = jax_data.HostShardedBatches(batch, glom.image_size, glom.channels, seed=0,
                                            host_count=plan.host_count)
        batches = ctx.wrap(jax_data.StatefulPrefetcher(inner, 2))
        try:
            trainer.fit(batches)
        finally:
            batches.close()
        return int(jax.device_get(trainer.state.step))

    sup = jax_elastic.ElasticSupervisor(
        attempt, hosts=hosts,
        policy=jax_supervisor.RestartPolicy(max_failures=3, window_s=1000.0,
                                            backoff_base_s=0.01, backoff_max_s=0.05),
        heartbeat_timeout_s=2.5, rejoin_grace_s=1.0, step_dt=1.0, checkpoint_dir=ckpt,
        mesh_shape_fn=_pin if pinned else None, clock=sim, sleep=sim.sleep,
        advance=sim.advance, seed=0)
    with jax_faults.injected(spec, seed=0):
        assert sup.run() == steps
    return sup, capture.losses, plans


def _assert_losses_close(ours: dict, theirs: dict):
    assert sorted(ours) == sorted(theirs)
    for step in ours:
        np.testing.assert_allclose(ours[step], theirs[step], rtol=LOSS_RTOL, err_msg=str(step))


@pytest.mark.filterwarnings("ignore")
def test_pinned_shrink_restart_is_bitwise_its_unfailed_run(tmp_path):
    """glom_tpu's c2 leg: exactly-once makes the restart invisible to the
    numerics (the noise generator resumes from the sharded save too)."""
    _, ref, ref_slots, _ = _port_run(str(tmp_path / "ref"), hosts=1, steps=6, batch=8,
                                     spec=None)
    sup, got, slots, _ = _port_run(str(tmp_path / "el"), hosts=2, steps=6, batch=8,
                                   spec=SHRINK)
    assert sup.replans == 1 and sup.plan.host_count == 1 and sup.plan.resume_step == 2
    assert got == ref          # float for float
    assert sorted(slots) == sorted(ref_slots) == list(range(48))


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("spec", ["host_preempt:kill@1", "host_preempt:kill@2",
                                  "host_preempt:kill@3", "host_preempt:kill@4",
                                  "host_preempt:kill@2; shrink_restart:shrink"])
def test_kill_at_every_step_boundary_replays_and_skips_nothing(tmp_path, spec):
    sup, _, slots, _ = _port_run(str(tmp_path / "ckpt"), hosts=2, steps=4, batch=4,
                                 spec=spec)
    assert sup.restarts == 1
    assert sup.plan.host_count == (1 if "shrink" in spec else 2)
    assert sorted(slots) == list(range(16)), spec


@pytest.mark.filterwarnings("ignore")
def test_pinned_shrink_restart_losses_are_glom_tpus(tmp_path):
    for name in ("ours", "theirs"):
        _jax_step0(str(tmp_path / name))
    sup, ours, _, plans = _port_run(str(tmp_path / "ours"), hosts=2, steps=6, batch=8,
                                    spec=SHRINK, noise_std=0.0)
    jsup, theirs, jplans = _jax_run(str(tmp_path / "theirs"), hosts=2, steps=6, batch=8,
                                    spec=SHRINK, pinned=True)
    assert supervisor_state(sup, plans) == supervisor_state(jsup, jplans)
    _assert_losses_close(ours, theirs)


# -- (e) and (g): a gloo world of two CPU ranks -------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic_world")
    _jax_step0(str(root / "ckpt"))
    shutil.copytree(root / "ckpt", root / "jax_ckpt")
    train = dict(batch_size=8, steps=6, log_every=1, checkpoint_every=1,
                 checkpoint_dir=str(root / "ckpt"), checkpoint_backend="sharded",
                 noise_std=0.0)
    jobs = [{"kind": "elastic", "name": "shrink", "hosts": 2, "spec": SHRINK,
             "config": TINY, "train": train}]
    for name, (tc, at) in STOPS.items():
        jobs.append({"kind": "stop", "name": name, "mesh": [2, 1, 1], "config": TINY,
                     "train": dict(batch_size=2, steps=12, **tc), "requester": 1,
                     "request_at": at})
    return root, run_world(str(root / "world"), 2, jobs)


@pytest.mark.filterwarnings("ignore")
def test_the_real_replan_resumes_from_the_sharded_save_as_glom_tpu(world):
    root, results = world
    ranks = results["shrink"]
    states = [json.loads(str(r["state"])) for r in ranks]
    assert states[0] == states[1]              # every rank decided alike
    plans = states[0]["plans"]
    assert [p["mesh_shape"] for p in plans] == [[2, 1, 1], [1, 1, 1]]
    assert [p["resume_step"] for p in plans] == [0, 2]
    for r in ranks:
        assert r["slots"].tolist() == list(range(48))
    # the run ends on sharded saves of the one-rank mesh, nothing of two left
    files = sorted(p.name for p in (root / "ckpt").iterdir() if p.name.startswith("ckpt_"))
    assert "ckpt_6.shard0of1.npz" in files and not [f for f in files if "of2" in f]
    jsup, theirs, jplans = _jax_run(str(root / "jax_ckpt"), hosts=2, steps=6, batch=8,
                                    spec=SHRINK, pinned=False)
    assert states[0] == json.loads(json.dumps(supervisor_state(jsup, jplans), sort_keys=True))
    ours = dict(zip(ranks[0]["steps"].tolist(), ranks[0]["losses"].tolist()))
    _assert_losses_close(ours, theirs)


# -- a gloo world of four CPU ranks: a grow, and a torn shard at the resume --

GROW = "host_preempt:kill@3; shrink_restart:grow"
REPLANS = [2, 3, 2, 3, 2]     # host counts of successive re-plans


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic_world4")

    def train(name, steps, batch):
        return dict(batch_size=batch, steps=steps, log_every=1, checkpoint_every=1,
                    checkpoint_dir=str(root / name), checkpoint_backend="sharded")

    jobs = [{"kind": "elastic", "name": "grow", "hosts": 3, "spec": GROW, "config": TINY,
             "train": train("grow", 5, 12)},
            {"kind": "elastic", "name": "torn", "hosts": 2, "spec": None, "tear": 3,
             "config": TINY, "train": train("torn", 6, 8)},
            {"kind": "replan", "name": "replan", "hosts": REPLANS}]
    return root, run_world(str(root / "world"), 4, jobs)


def test_a_replan_to_a_shape_already_run_on_reuses_its_mesh_and_groups(world4):
    """A job that restarts many times holds one set of process groups a
    shape: ``make_elastic_mesh`` returns the mesh it made for that shape."""
    _, results = world4
    for rank, r in enumerate(results["replan"]):
        assert r["reused"].tolist() == [False, False, True, True, True], rank
        assert r["member"].tolist() == [rank < h for h in REPLANS], rank


def _states(ranks) -> list:
    return [json.loads(str(r["state"])) for r in ranks]


@pytest.mark.filterwarnings("ignore")
def test_a_grow_resumes_the_rank_the_saving_mesh_lacked_from_the_shared_cursor(world4, tmp_path):
    """(3, 1, 1) -> (4, 1, 1): the saves of three ranks hold no ``data@p3``,
    so rank 3 takes rank 0's cursor (every rank saves the same one);
    every rank still consumes each slot once, all decide alike, and the
    losses are the unfailed one-process run's within LOSS_RTOL."""
    _, results = world4
    ranks = results["grow"]
    states = _states(ranks)
    assert all(st == states[0] for st in states[1:])
    assert [p["mesh_shape"] for p in states[0]["plans"]] == [[3, 1, 1], [4, 1, 1]]
    assert [p["resume_step"] for p in states[0]["plans"]] == [None, 2]
    for r in ranks:
        assert r["slots"].tolist() == list(range(60))
    _, ref, _, _ = _port_run(str(tmp_path / "ref"), hosts=1, steps=5, batch=12, spec=None)
    got = dict(zip(ranks[3]["steps"].tolist(), ranks[3]["losses"].tolist()))
    assert sorted(got) == [3, 4, 5]           # rank 3 trained only on the grown mesh
    _assert_losses_close(dict(zip(ranks[0]["steps"].tolist(), ranks[0]["losses"].tolist())),
                         ref)
    _assert_losses_close(got, {k: ref[k] for k in got})


@pytest.mark.filterwarnings("ignore")
def test_a_torn_shard_at_the_resume_step_falls_back_on_every_rank_of_the_world(world4,
                                                                               tmp_path):
    """Step 3's second shard file torn in half: the mesh leader quarantines
    step 3 and the trainers resume from step 2; the two ranks the plan
    leaves out tick from the same step and cursor (rank 0 announces them),
    so every rank consumes slots 16-47 once and all decide alike."""
    root, results = world4
    ranks = results["torn"]
    states = _states(ranks)
    assert all(st == states[0] for st in states[1:])
    for r in ranks:
        assert r["slots"].tolist() == list(range(16, 48))
    assert ranks[0]["steps"].tolist() == [3, 4, 5, 6]
    names = {p.name for p in (root / "torn").iterdir()}
    assert {"ckpt_3.shard0of2.npz.corrupt", "ckpt_3.shard1of2.npz.corrupt",
            "ckpt_6.shard0of2.npz", "ckpt_6.shard1of2.npz"} <= names
    _, ref, _, _ = _port_run(str(tmp_path / "ref"), hosts=1, steps=6, batch=8, spec=None)
    _assert_losses_close(dict(zip(ranks[0]["steps"].tolist(), ranks[0]["losses"].tolist())),
                         {k: ref[k] for k in (3, 4, 5, 6)})


# name -> (train knobs, the batch at which rank 1 asks for a stop)
STOPS = {
    "stop_log": (dict(log_every=3, checkpoint_every=0, stop_poll_steps=2), 3),
    "stop_poll": (dict(log_every=0, checkpoint_every=5, stop_poll_steps=10), 1),
}


def _glom_tpu_cadence(tc: dict, at: int) -> int:
    """The step glom_tpu's _fit_loop stops a multi-process run at: the first
    poll step (a multiple of min(log_every, checkpoint_every,
    stop_poll_steps), the non-zero ones) at or after the request."""
    cfg = JaxTrainConfig(batch_size=2, **tc)
    poll = min(x for x in (cfg.log_every, cfg.checkpoint_every, cfg.stop_poll_steps) if x)
    return -(-at // poll) * poll


@pytest.mark.parametrize("name", list(STOPS))
def test_a_stop_lands_on_glom_tpus_cadence(world, name):
    _, results = world
    want = _glom_tpu_cadence(*STOPS[name])
    assert [int(r["stopped_at"]) for r in results[name]] == [want, want]
    assert want > STOPS[name][1]       # deferred to the poll, never the local flag
