"""The port's bulk tier (glom_tpu_torch/bulk/jobs.py, serving/bulk.py, the
engine's scavenge and idle paths, /admin/jobs/*, tools/bulk_run.py) against
glom_tpu's on the CPU.

Mirrors tests/test_bulk.py where it applies: the partition math, the slot
addressing (byte-equal to glom_tpu's SlotDataset and to the trainer's
ElasticBatches sample), the idempotent sink, the exactly-once cursor, the
scavenger's priority contract and the kill/resume smoke.  Across the two
packages: a store and a sink written by either are adopted and assembled by
the other, an ``index`` job writes glom_tpu's file names with states within
1e-4 of glom_tpu's engine on the same checkpoint, and the jobs routes answer
as glom_tpu's do (their 404 body when the tier is off).

The bucket-and-offset bit check pins what holds on the CPU (one torch
thread): a slot's answer is bitwise the same at every row offset of buckets
2, 4 and 8, and at bucket 1 differs from them by at most ``BUCKET1_ATOL``
(the plain matmuls sum a one-image batch in another order).  So a job whose
chunks all run at one bucket (idle fills cut from the cursor: the smoke) is
bitwise across a kill, and one that mixes scavenged and idle fills is bitwise
except for slots that ran at bucket 1 in one run and not in the other
(``ROADMAP.md`` queue 3).
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from glom_tpu import config as jax_config
from glom_tpu.bulk import jobs as jax_jobs
from glom_tpu.serving.engine import ServingEngine as JaxServingEngine
from glom_tpu.serving.engine import make_demo_checkpoint as jax_make_demo_checkpoint
from glom_tpu.training.data import ElasticBatches
from glom_tpu_torch.bulk import jobs
from glom_tpu_torch.bulk.jobs import BulkJobSpec, ChunkSink, JobStore, SlotDataset, partition_range
from glom_tpu_torch.hierarchy.index import assemble_level, level_parts
from glom_tpu_torch.serving import bulk as bulk_mod
from glom_tpu_torch.serving.engine import DEMO_CONFIG, ServingEngine, make_demo_checkpoint
from glom_tpu_torch.serving.server import make_server
from glom_tpu_torch.tools import bulk_run

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

# a slot at bucket 1 against the same slot at a larger bucket (max-abs,
# float32 outputs of the 128-wide demo model)
BUCKET1_ATOL = 1e-6
# the port's index states against glom_tpu's engine on one checkpoint
INDEX_ATOL = 1e-4
TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)
BULK_OFF = {"error": "bulk tier disabled on this engine (start with --bulk-dir)"}


def _spec(tmp_path, name="job", total=20, seed=5, mod=jobs, **kw):
    kw.setdefault("image_size", 8)
    kw.setdefault("channels", 3)
    return mod.BulkJobSpec(name=name, dataset=f"synthetic:{total}", transform="embed",
                           sink=str(tmp_path / f"{name}_out"), seed=seed, **kw)


# ---------------------------------------------------------------------------
# partition math and slot addressing, against glom_tpu's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lo,hi,k,want", [(0, 10, 3, [(0, 4), (4, 7), (7, 10)]),
                                          (0, 2, 5, [(0, 1), (1, 2)]),
                                          (3, 9, 1, [(3, 9)]), (4, 4, 2, []),
                                          (28, 40, 2, [(28, 34), (34, 40)])])
def test_partition_range_is_glom_tpus(lo, hi, k, want):
    assert partition_range(lo, hi, k) == jax_jobs.partition_range(lo, hi, k) == want


@pytest.mark.parametrize("lo,hi,k", [(5, 4, 2), (0, 4, 0)])
def test_partition_range_refuses_what_glom_tpus_refuses(lo, hi, k):
    with pytest.raises(ValueError):
        jax_jobs.partition_range(lo, hi, k)
    with pytest.raises(ValueError):
        partition_range(lo, hi, k)


@pytest.mark.parametrize("seed", [0, 11])
def test_synthetic_slots_are_glom_tpus_and_the_trainers(tmp_path, seed):
    """THE addressing pin: slot s is SeedSequence([seed, s]) -> standard
    normal, byte for byte glom_tpu's SlotDataset and ElasticBatches._sample,
    so the global-slot cursor means the same thing in every exactly-once
    plane."""
    ours = SlotDataset(_spec(tmp_path, total=16, seed=seed))
    theirs = jax_jobs.SlotDataset(_spec(tmp_path, total=16, seed=seed, mod=jax_jobs))
    stream = ElasticBatches(4, image_size=8, channels=3, seed=seed)
    block = ours.read(0, 16)
    assert block.tobytes() == theirs.read(0, 16).tobytes()
    for slot in (0, 3, 7, 15):
        assert block[slot].tobytes() == stream._sample(slot).tobytes()


def test_file_slots_are_glom_tpus(tmp_path):
    rng = np.random.default_rng(3)
    for i in range(5):
        np.save(tmp_path / f"img_{i:02d}.npy", rng.standard_normal((3, 8, 8)).astype(np.float32))
    glob = str(tmp_path / "img_*.npy")
    kw = dict(name="files", dataset=glob, sink=str(tmp_path / "o"), image_size=8)
    ours, theirs = SlotDataset(BulkJobSpec(**kw)), jax_jobs.SlotDataset(jax_jobs.BulkJobSpec(**kw))
    assert len(ours) == len(theirs) == 5
    assert ours.read(1, 4).tobytes() == theirs.read(1, 4).tobytes()
    with pytest.raises(ValueError, match="want"):
        SlotDataset(BulkJobSpec(**dict(kw, image_size=4))).read(0, 1)
    with pytest.raises(ValueError, match="matched no files"):
        SlotDataset(BulkJobSpec(**dict(kw, dataset=str(tmp_path / "none_*.npy"))))


def test_read_stacks_range_and_refuses_outside(tmp_path):
    ds = SlotDataset(_spec(tmp_path, total=10))
    got = ds.read(2, 6)
    assert got.shape == (4, 3, 8, 8) and got.dtype == np.float32
    np.testing.assert_array_equal(got[1], ds.read(3, 4)[0])
    assert len(SlotDataset(_spec(tmp_path, total=37))) == 37
    with pytest.raises(ValueError, match="outside"):
        ds.read(4, 11)


@pytest.mark.parametrize("field,value,match", [("name", "bad name", "bad job name"),
                                               ("transform", "parse", "unknown transform"),
                                               ("sink", "", "sink")])
def test_spec_validation_is_glom_tpus(field, value, match):
    kw = {"name": "ok", "dataset": "synthetic:4", "sink": "/s", field: value}
    for mod in (jobs, jax_jobs):
        with pytest.raises(ValueError, match=match):
            mod.BulkJobSpec(**kw)


# ---------------------------------------------------------------------------
# the idempotent sink
# ---------------------------------------------------------------------------
def test_sink_rewrite_is_idempotent(tmp_path):
    sink = ChunkSink(str(tmp_path / "out"))
    data = np.arange(12, dtype=np.float32).reshape(4, 3)
    sink.write(0, 4, data)
    sink.write(0, 4, data)  # the resume re-execution shape
    assert [(lo, hi) for lo, hi, _ in sink.parts()] == [(0, 4)]
    np.testing.assert_array_equal(sink.assemble(4), data)


def test_sink_drops_orphan_overlaps(tmp_path):
    sink = ChunkSink(str(tmp_path / "out"))
    sink.write(4, 12, np.zeros((8, 3), np.float32))  # a dead owner's orphan
    a, b = np.ones((4, 3), np.float32), np.full((4, 3), 2.0, np.float32)
    sink.write(4, 8, a)
    sink.write(8, 12, b)
    assert [(lo, hi) for lo, hi, _ in sink.parts()] == [(4, 8), (8, 12)]
    np.testing.assert_array_equal(np.concatenate([np.load(p) for _, _, p in sink.parts()]),
                                  np.concatenate([a, b]))


@pytest.mark.parametrize("case", ["gap", "short", "rows"])
def test_sink_refuses_what_glom_tpus_refuses(tmp_path, case):
    for mod in (jobs, jax_jobs):
        sink = mod.ChunkSink(str(tmp_path / mod.__name__))
        if case == "rows":
            with pytest.raises(ValueError, match="rows"):
                sink.write(0, 4, np.zeros((3, 3), np.float32))
            continue
        sink.write(0, 4, np.zeros((4, 3), np.float32))
        if case == "gap":
            sink.write(6, 8, np.zeros((2, 3), np.float32))
            with pytest.raises(ValueError, match="tile"):
                sink.assemble(8)
        else:
            with pytest.raises(ValueError, match="total"):
                sink.assemble(8)


# ---------------------------------------------------------------------------
# the exactly-once cursor
# ---------------------------------------------------------------------------
def test_cursor_durable_across_kill_and_reload(tmp_path):
    root = str(tmp_path / "store")
    store = JobStore(root)
    store.submit(_spec(tmp_path), total=20)
    store.advance("job", 0, 8)
    del store  # the "kill": only the durable file survives
    resumed = JobStore(root)
    st = resumed.status("job")
    assert st["done"] == 8 and st["status"] == "running"
    resumed.advance("job", 0, 20)
    assert resumed.status("job")["status"] == "done"


def test_advance_is_monotone_and_bounded(tmp_path):
    store = JobStore(str(tmp_path / "store"))
    store.submit(_spec(tmp_path), total=20)
    store.advance("job", 0, 8)
    for bad in (4, 21):
        with pytest.raises(ValueError, match="monotone"):
            store.advance("job", 0, bad)
    assert store.status("job")["done"] == 8


def test_resubmits_identity_overlap_and_done(tmp_path):
    store = JobStore(str(tmp_path / "store"))
    spec = _spec(tmp_path)
    store.submit(spec, total=20, shards=[(0, 10)], owner="r0")
    store.advance("job", 0, 8)
    assert store.submit(spec, total=20, shards=[(0, 10)], owner="r0")["shards"][0]["cursor"] == 8
    with pytest.raises(ValueError, match="identity"):
        store.submit(_spec(tmp_path, seed=6), total=20)
    with pytest.raises(ValueError, match="overlap"):
        store.submit(spec, total=20, shards=[(5, 15)], owner="r1")
    store.submit(spec, total=20, shards=[(10, 20)], owner="r1")
    store.advance("job", 0, 10)
    store.advance("job", 10, 20)
    with pytest.raises(RuntimeError, match="done"):
        store.submit(spec, total=20)
    with pytest.raises(RuntimeError, match="already done"):
        store.set_status("job", "paused")


def test_repartition_moves_only_the_undone_tail(tmp_path):
    """The same re-cut as glom_tpu's store, from the same documents."""
    docs = []
    for mod in (jobs, jax_jobs):
        store = mod.JobStore(str(tmp_path / mod.__name__))
        spec = _spec(tmp_path, total=40, mod=mod)
        store.submit(spec, total=40, shards=[(0, 20)], owner="r0")
        store.submit(spec, total=40, shards=[(20, 40)], owner="r1")
        store.submit(spec, total=40, shards=[(0, 20)], owner="r0")
        store.advance("job", 20, 28)  # r1 died at durable cursor 28
        new = store.repartition("job", "r1", ["r0", "r2"])
        docs.append((new, store.status("job"), store.summary()["backlog"]))
    assert docs[0] == docs[1]
    new, status, backlog = docs[0]
    assert [(s["lo"], s["hi"], s["owner"]) for s in new] == [(28, 34, "r0"), (34, 40, "r2")]
    assert [(s["lo"], s["hi"], s["owner"], s["cursor"]) for s in status["shards"]] == [
        (0, 20, "r0", 0), (20, 28, "r1", 28), (28, 34, "r0", 28), (34, 40, "r2", 34)]
    assert backlog == 32


@pytest.mark.parametrize("writer", ["glom_tpu", "port"])
def test_a_store_and_sink_cross_between_the_packages(tmp_path, writer):
    """A job store and a sink one package wrote are adopted by the other: it
    reads the same status, advances the same cursor and assembles the parts
    the writer left."""
    w, r = (jax_jobs, jobs) if writer == "glom_tpu" else (jobs, jax_jobs)
    root, sink_dir = str(tmp_path / "store"), str(tmp_path / "job_out")
    spec = _spec(tmp_path, total=12, mod=w)
    store = w.JobStore(root)
    store.submit(spec, total=12, shards=[(0, 6)], owner="a")
    store.submit(spec, total=12, shards=[(6, 12)], owner="b")
    data = w.SlotDataset(spec).read(0, 12).reshape(12, -1)
    w.ChunkSink(sink_dir).write(0, 4, data[:4])
    store.advance("job", 0, 4)
    adopted = r.JobStore(root)
    want = w.JobStore(root).status("job")
    assert adopted.status("job") == want and want["done"] == 4
    assert adopted.summary()["backlog"] == 8
    # the other package finishes the job into the same sink
    sink = r.ChunkSink(sink_dir)
    for lo, hi in ((4, 6), (6, 12)):
        sink.write(lo, hi, data[lo:hi])
        adopted.advance("job", 0 if lo < 6 else 6, hi)
    assert w.JobStore(root).status("job")["status"] == "done"
    assert w.ChunkSink(sink_dir).assemble(12).tobytes() == data.tobytes()
    assert r.ChunkSink(sink_dir).assemble(12).tobytes() == data.tobytes()


# ---------------------------------------------------------------------------
# the in-engine scavenger
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bulk_ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bulk_ckpt"))
    make_demo_checkpoint(d)
    return d


def _imgs(n, seed=0):
    c = DEMO_CONFIG
    return np.random.default_rng(seed).standard_normal(
        (n, c.channels, c.image_size, c.image_size)).astype(np.float32)


def _engine(ckpt, tmp_path, bulk=True, **kw):
    """A CPU engine; with the tier, its idle buckets need no grace after
    online work, so a test can run one right after a batch."""
    kw.setdefault("buckets", (1, 4))
    eng = ServingEngine(ckpt, device="cpu", max_wait_ms=0.0, reload_poll_s=0,
                        bulk_dir=str(tmp_path / "bulk_store") if bulk else None, **kw)
    if bulk:
        eng.bulk.idle_grace_s = 0.0
    return eng


def _payload(tmp_path, total, name="job", seed=5, **kw):
    return {"name": name, "dataset": f"synthetic:{total}", "transform": "embed", "seed": seed,
            "sink": str(tmp_path / f"{name}_out"), **kw}


def _drain(engine, name="job", limit=100):
    for _ in range(limit):
        if engine.bulk.status(name)["status"] == "done":
            return
        engine.bulk.run_idle_once()
    raise AssertionError(engine.bulk.status(name))


def _idle_control(ckpt, tmp_path, total, **kw):
    """The same job run by idle buckets alone on a fresh engine."""
    control = tmp_path / "control"
    control.mkdir()
    eng = _engine(ckpt, control, **kw)
    try:
        eng.bulk.submit(_payload(control, total))
        _drain(eng)
    finally:
        eng.shutdown(drain=False)
    return ChunkSink(str(control / "job_out")).assemble(total)


def test_residual_fill_leaves_online_outputs_bitwise_identical(bulk_ckpt, tmp_path):
    """Three online images in a 4-bucket leave one residual slot: the
    scavenger fills it and the online callers get bytes identical to an
    engine without the tier; the slot is durably committed."""
    imgs = _imgs(3)
    ctrl = _engine(bulk_ckpt, tmp_path, bulk=False)
    try:
        futs = [ctrl.submit("embed", imgs[i:i + 1]) for i in range(3)]
        ctrl.process_once("embed", block=True)
        ref = [f.result(timeout=10) for f in futs]
    finally:
        ctrl.shutdown(drain=False)
    eng = _engine(bulk_ckpt, tmp_path)
    try:
        eng.bulk.submit(_payload(tmp_path, total=11))
        futs = [eng.submit("embed", imgs[i:i + 1]) for i in range(3)]
        assert eng.process_once("embed", block=True) == 3
        got = [f.result(timeout=10) for f in futs]
        assert [g.tobytes() for g in got] == [r.tobytes() for r in ref]
        snap = eng.registry.snapshot()
        assert snap["bulk_scavenged_slots_total"] == 1
        assert snap["serving_requests_total"] == 3      # bulk is not online traffic
        assert "serving_graph_captures" not in snap
        assert eng.bulk.status("job")["done"] == 1
        # the scavenged slot's answer is the one an idle bucket gives it
        part = ChunkSink(str(tmp_path / "job_out")).parts()[0]
        assert part[:2] == (0, 1)
        want = eng.run("embed", np.concatenate([imgs, SlotDataset(BulkJobSpec(
            **_payload(tmp_path, 11), image_size=16)).read(0, 1)]))[3:]
        assert np.load(part[2]).tobytes() == want.tobytes()
    finally:
        eng.shutdown(drain=False)


@pytest.mark.parametrize("queued", ["embed", "reconstruct"])
def test_idle_bucket_preempted_by_any_queued_image(bulk_ckpt, tmp_path, queued):
    """run_idle_once starts ZERO bulk slots while an online image waits in
    any batcher (the card is shared by every endpoint; glom_tpu gates an
    embed job on the embed queue alone), and runs again once it drained."""
    eng = _engine(bulk_ckpt, tmp_path)
    try:
        eng.bulk.submit(_payload(tmp_path, total=9))
        fut = eng.submit(queued, _imgs(1))
        assert eng.batchers[queued].depth > 0
        assert eng.bulk.run_idle_once() == 0
        eng.process_once(queued, block=True)
        fut.result(timeout=10)
        assert eng.bulk.run_idle_once() == 4
    finally:
        eng.shutdown(drain=False)


def test_idle_bucket_waits_out_the_grace_after_online_work(bulk_ckpt, tmp_path):
    """An idle bucket starts only once no online batch ran for idle_grace_s
    (the default: two b=8 replays at flagship on the card), so the next
    request of a closed loop meets no idle replay."""
    eng = _engine(bulk_ckpt, tmp_path)
    try:
        assert eng.bulk.idle_grace_s == 0.0
        eng.bulk.idle_grace_s = bulk_mod.DEFAULT_IDLE_GRACE_S
        eng.bulk.submit(_payload(tmp_path, total=9))
        assert eng.bulk.run_idle_once() == 4               # no online work yet
        fut = eng.submit("embed", _imgs(1))
        eng.process_once("embed", block=True)
        fut.result(timeout=10)
        assert eng.bulk.run_idle_once() == 0
        eng.bulk.idle_grace_s = 60.0
        eng.online_at = eng._clock() - 59.0
        assert eng.bulk.run_idle_once() == 0
        eng.online_at -= 1.0
        assert eng.bulk.run_idle_once() == 4
    finally:
        eng.shutdown(drain=False)


def test_idle_buckets_drain_the_job(bulk_ckpt, tmp_path):
    eng = _engine(bulk_ckpt, tmp_path)
    total = 11
    try:
        eng.bulk.submit(_payload(tmp_path, total=total))
        assert eng.bulk.backlog() == total
        _drain(eng)
        st = eng.bulk.status("job")
        assert st["status"] == "done" and st["done"] == total
        out = ChunkSink(str(tmp_path / "job_out")).assemble(total)
        assert out.shape == (total, DEMO_CONFIG.levels, DEMO_CONFIG.dim)
        snap = eng.registry.snapshot()
        assert snap["bulk_idle_slots_total"] == total and snap["bulk_parts_written_total"] == 3
        assert snap["bulk_backlog_slots"] == 0 and "serving_requests_total" not in snap
        assert "serving_graph_captures" not in snap
        # a done job leaves the active set; health carries the summary
        health = eng.health()["bulk"]
        assert health["backlog"] == 0 and health["jobs"]["job"]["status"] == "done"
        assert health["slots_done_session"] == total
    finally:
        eng.shutdown(drain=False)


def test_geometry_and_total_rejected_at_submit(bulk_ckpt, tmp_path):
    eng = _engine(bulk_ckpt, tmp_path)
    try:
        with pytest.raises(ValueError, match="geometry"):
            eng.bulk.submit(_payload(tmp_path, total=4, image_size=8))
        with pytest.raises(ValueError, match="exceeds"):
            eng.bulk.submit(dict(_payload(tmp_path, total=4), total=5))
        assert JobStore(str(tmp_path / "bulk_store")).names() == []
    finally:
        eng.shutdown(drain=False)


def test_failed_group_rewinds_its_chunk(bulk_ckpt, tmp_path):
    """A primary group whose replay raises fails its own futures and rewinds
    the bulk chunk it carried: nothing is committed, the slots run again,
    and the finished job equals an idle-only control."""
    eng = _engine(bulk_ckpt, tmp_path)
    cache = eng.caches["embed"]
    try:
        eng.bulk.submit(_payload(tmp_path, total=6))
        def broken(*a, **kw):
            raise RuntimeError("injected replay failure")

        cache._run_eager = broken
        fut = eng.submit("embed", _imgs(2))
        eng.process_once("embed", block=True)
        with pytest.raises(RuntimeError, match="injected"):
            fut.result(timeout=10)
        st = eng.bulk.status("job")
        assert st["done"] == 0 and eng.bulk.backlog() == 6
        # the idle path rewinds too, counts the error, and re-raises
        with pytest.raises(RuntimeError, match="injected"):
            eng.bulk.run_idle_once()
        assert eng.registry.snapshot()["bulk_batch_errors_total"] == 1
        del cache._run_eager
        _drain(eng)
        got = ChunkSink(str(tmp_path / "job_out")).assemble(6)
    finally:
        eng.shutdown(drain=False)
    assert got.tobytes() == _idle_control(bulk_ckpt, tmp_path, 6).tobytes()


def test_a_failed_commit_rewinds_and_never_fails_the_worker(bulk_ckpt, tmp_path):
    eng = _engine(bulk_ckpt, tmp_path)
    try:
        eng.bulk.submit(_payload(tmp_path, total=5))
        real = eng.bulk.store.advance

        def broken(*a, **kw):
            raise OSError("injected store failure")

        eng.bulk.store.advance = broken
        fut = eng.submit("embed", _imgs(3))
        with pytest.warns(UserWarning, match="run again"):
            assert eng.process_once("embed", block=True) == 3
        assert fut.result(timeout=10).shape == (3, DEMO_CONFIG.levels, DEMO_CONFIG.dim)
        assert eng.bulk.status("job")["done"] == 0
        assert eng.registry.snapshot()["bulk_batch_errors_total"] == 1
        eng.bulk.store.advance = real
        _drain(eng)
        got = ChunkSink(str(tmp_path / "job_out")).assemble(5)
    finally:
        eng.shutdown(drain=False)
    assert got.tobytes() == _idle_control(bulk_ckpt, tmp_path, 5).tobytes()


def test_scavenged_and_idle_fills_cover_the_job_exactly_once(bulk_ckpt, tmp_path):
    """Online batches of 1-3 images scavenge their padding between idle
    buckets; the finished job has every slot once and equals the idle-only
    control bitwise on each slot that ran at a bucket above 1 in both runs,
    and within BUCKET1_ATOL on the others (the CPU bit check)."""
    total = 13
    eng = _engine(bulk_ckpt, tmp_path, buckets=(1, 2, 4))
    commits = []
    real_complete = eng.bulk.complete

    def complete(token, out):
        commits.append((token.lo, token.hi, token.source))
        real_complete(token, out)

    eng.bulk.complete = complete
    try:
        eng.bulk.submit(_payload(tmp_path, total=total))
        rng = np.random.default_rng(1)
        while eng.bulk.status("job")["status"] != "done":
            fut = eng.submit("embed", _imgs(int(rng.integers(1, 4)), seed=int(rng.integers(99))))
            eng.process_once("embed", block=True)
            fut.result(timeout=10)
            eng.bulk.run_idle_once()
        snap = eng.registry.snapshot()
        got = ChunkSink(str(tmp_path / "job_out")).assemble(total)
    finally:
        eng.shutdown(drain=False)
    assert snap["bulk_scavenged_slots_total"] > 0 and snap["bulk_idle_slots_total"] > 0
    assert snap["bulk_slots_total"] == total
    want = _idle_control(bulk_ckpt, tmp_path, total, buckets=(1, 2, 4))
    # a scavenged chunk rides a bucket above 1 (it fills padding); an idle
    # one runs at the bucket of its own size
    ran_at_1 = np.zeros(total, bool)
    for lo, hi, source in commits:
        ran_at_1[lo:hi] = source == "idle" and hi - lo == 1
    assert sorted((lo, hi) for lo, hi, _ in commits) == [
        (lo, hi) for lo, hi, _ in ChunkSink(str(tmp_path / "job_out")).parts()]
    control_at_1 = np.zeros(total, bool)
    control_at_1[12] = True                      # the control's tail chunk [12, 13)
    same = ~(ran_at_1 | control_at_1)
    assert got[same].tobytes() == want[same].tobytes()
    assert np.abs(got - want).max() <= BUCKET1_ATOL


def test_a_fill_stacks_the_slots_drawn_ahead(bulk_ckpt, tmp_path, monkeypatch):
    """draw_ahead() draws the next chunk of the largest bucket; a scavenged
    fill then reads no slot itself, its rows are the bytes read() gives, and
    the window follows the stage (a rewind draws the rewound slots again, a
    paused job draws nothing)."""
    eng = _engine(bulk_ckpt, tmp_path)
    spec = BulkJobSpec(**_payload(tmp_path, 11), image_size=16)
    want = SlotDataset(spec).read(0, 11)
    try:
        eng.bulk.submit(_payload(tmp_path, total=11))
        assert eng.bulk.draw_ahead() == 4 and eng.bulk.draw_ahead() == 0
        imgs = _imgs(3)
        with monkeypatch.context() as m:
            def no_read(self, lo, hi):
                raise AssertionError(f"a fill read slots [{lo}, {hi}) drawn ahead")

            m.setattr(SlotDataset, "read", no_read)
            fut = eng.submit("embed", imgs)
            assert eng.process_once("embed", block=True) == 3
            fut.result(timeout=10)
            token = eng.bulk.fill("embed", 3)
        assert token.imgs.tobytes() == want[1:4].tobytes()
        assert eng.bulk.draw_ahead() == 4                 # slots 4-7
        eng.bulk.abandon(token)
        assert eng.bulk.draw_ahead() == 3                 # slots 1-3 again
        part = ChunkSink(str(tmp_path / "job_out")).parts()[0]
        assert part[:2] == (0, 1)
        assert np.load(part[2]).tobytes() == eng.run(
            "embed", np.concatenate([imgs, want[:1]]))[3:].tobytes()
        eng.bulk.pause("job")
        eng.bulk.resume("job")
        assert eng.bulk.draw_ahead() == 4
        eng.bulk.pause("job")
        assert eng.bulk.draw_ahead() == 0 and eng.bulk.fill("embed", 3) is None
    finally:
        eng.shutdown(drain=False)


def test_a_slot_whose_draw_raises_is_read_by_its_fill(bulk_ckpt, tmp_path):
    """A file slot that cannot be drawn ahead (a wrong shape) leaves the
    drawing to the fill that stages it, which meets the error itself."""
    c = DEMO_CONFIG
    files = tmp_path / "files"
    files.mkdir()
    np.save(files / "a.npy", np.ones((c.channels, c.image_size, c.image_size), np.float32))
    np.save(files / "b.npy", np.ones((2, 2), np.float32))
    eng = _engine(bulk_ckpt, tmp_path)
    try:
        eng.bulk.submit({"name": "job", "dataset": str(files / "*.npy"), "transform": "embed",
                         "sink": str(tmp_path / "job_out")})
        assert eng.bulk.draw_ahead() == 2 and eng.bulk.draw_ahead() == 0
        token = eng.bulk.fill("embed", 1)
        assert token.imgs.tobytes() == np.ones(
            (1, c.channels, c.image_size, c.image_size), np.float32).tobytes()
        eng.bulk.complete(token, np.zeros((1, c.levels, c.dim), np.float32))
        with pytest.raises(ValueError, match="want"):
            eng.bulk.fill("embed", 1)
    finally:
        eng.shutdown(drain=False)


def test_a_running_runner_commits_scavenged_chunks_on_its_host_thread(bulk_ckpt, tmp_path):
    """With the runner's threads running, a scavenged chunk is committed on
    the host thread (not on the online worker) and an idle one on the idle
    thread; pause(wait=True) returns once every staged chunk settled, and
    the store holds exactly the slots committed."""
    eng = _engine(bulk_ckpt, tmp_path)
    commits = []
    real_complete = eng.bulk.complete

    def complete(token, out):
        commits.append((token.source, threading.current_thread().name, token.hi - token.lo))
        real_complete(token, out)

    eng.bulk.complete = complete
    try:
        eng.bulk.submit(_payload(tmp_path, total=400, shard=[0, 200]))
        eng.bulk.submit(_payload(tmp_path, total=400, shard=[200, 400]))
        eng.bulk.start()
        for i in range(200):
            fut = eng.submit("embed", _imgs(3, seed=i))
            eng.process_once("embed", block=True)
            fut.result(timeout=10)
            if any(source == "scavenged" for source, _, _ in commits):
                break
        eng.bulk.pause("job", wait=True)
        status = eng.bulk.status("job")
    finally:
        eng.shutdown(drain=False)
    threads = {source: {name for s, name, _ in commits if s == source}
               for source in ("scavenged", "idle")}
    assert threads["scavenged"] == {"glom-torch-bulk-host"}
    assert threads["idle"] <= {"glom-torch-bulk-idle"}
    assert status["done"] == sum(n for _, _, n in commits)
    assert JobStore(str(tmp_path / "bulk_store")).status("job")["done"] == status["done"]


# ---------------------------------------------------------------------------
# pinned jobs
# ---------------------------------------------------------------------------
@pytest.fixture
def two_step_ckpt(tmp_path):
    d = str(tmp_path / "ckpt")
    make_demo_checkpoint(d)
    return d


def test_a_pinned_job_parks_until_its_version_is_resident(two_step_ckpt, tmp_path):
    """A store job pinned to a step that is not resident is parked at
    adoption (warned and counted; the engine starts); once a deploy makes
    the step resident, resume runs it on that version's own graphs, and a
    scavenged fill never takes it."""
    store = JobStore(str(tmp_path / "bulk_store"))
    spec = BulkJobSpec(**_payload(tmp_path, total=5), version=1, image_size=16)
    store.submit(spec, total=5)
    with pytest.warns(UserWarning, match="parked"):
        eng = _engine(two_step_ckpt, tmp_path)
    try:
        assert eng.registry.snapshot()["bulk_jobs_parked_total"] == 1
        assert eng.bulk.run_idle_once() == 0 and eng.bulk.backlog() == 0
        with pytest.raises(ValueError, match="not resident"):
            eng.bulk.resume("job")
        make_demo_checkpoint(two_step_ckpt, seed=1, step=1)
        assert eng.deploy.begin_canary(step=1, fraction=0.5) == 1
        eng.bulk.resume("job")
        assert eng.bulk.fill("embed", 3) is None           # pinned: never scavenged
        _drain(eng)
        cand = eng.models.get("default", 1).caches
        want = cand.caches["embed"](cand.params, SlotDataset(spec).read(0, 4))
        got = ChunkSink(spec.sink).assemble(5)
        assert got[:4].tobytes() == want.tobytes()
        assert not np.array_equal(got[:4], eng.run("embed", SlotDataset(spec).read(0, 4)))
        assert any(e["event"] == "bulk_resume" for e in eng.timeline.events())
    finally:
        eng.shutdown(drain=False)


def test_a_pin_retired_while_its_job_is_active(two_step_ckpt, tmp_path):
    """A rollback between two buckets parks the job (its slots wait, nothing
    is lost); one that lands after the bucket resolved its set cannot free
    the graphs under the replay: the bucket finishes on the held set."""
    eng = _engine(two_step_ckpt, tmp_path)
    make_demo_checkpoint(two_step_ckpt, seed=1, step=1)   # after start-up: a candidate
    try:
        assert eng.deploy.begin_canary(step=1, fraction=0.5) == 1
        eng.bulk.submit(_payload(tmp_path, total=10, version=1))
        real_fill = eng.bulk.fill

        def fill_then_rollback(*a, **kw):
            # the set is resolved; the rollback retires it before the replay
            token = real_fill(*a, **kw)
            eng.deploy.rollback(reason="test")
            return token

        eng.bulk.fill = fill_then_rollback
        assert eng.bulk.run_idle_once() == 4
        eng.bulk.fill = real_fill
        assert eng.models.get("default", 1) is None
        assert eng.bulk.status("job")["done"] == 4
        assert eng.bulk.run_idle_once() == 0               # parked: the pin is gone
        assert eng.bulk.backlog() == 6 and eng.bulk.status("job")["status"] == "running"
        # the same step deployed again: the job resumes where it stopped
        assert eng.deploy.begin_canary(step=1, fraction=0.5) == 1
        _drain(eng)
        assert eng.bulk.status("job")["done"] == 10
    finally:
        eng.shutdown(drain=False)


# ---------------------------------------------------------------------------
# the index build
# ---------------------------------------------------------------------------
def test_an_index_job_is_glom_tpus_and_feeds_similar(tmp_path):
    """An ``index`` job over 6 slots on a checkpoint glom_tpu wrote: per-level
    part files under glom_tpu's names, states within INDEX_ATOL of the same
    job run by glom_tpu's engine, and /similar over the sink finds each
    indexed image first at level 0."""
    ckpt = str(tmp_path / "ckpt")
    jax_make_demo_checkpoint(ckpt, config=jax_config.GlomConfig(**TINY))
    sinks = {}
    payload = dict(dataset="synthetic:6", transform="index", seed=2)
    for side in ("ours", "theirs"):
        sinks[side] = str(tmp_path / f"{side}_index")
        kw = dict(buckets=(1, 4), reload_poll_s=0, bulk_dir=str(tmp_path / f"{side}_store"))
        eng = (ServingEngine(ckpt, device="cpu", **kw) if side == "ours"
               else JaxServingEngine(ckpt, warmup=False, quality_sample=0, **kw))
        try:
            eng.bulk.submit({"name": "idx", "sink": sinks[side], **payload})
            for _ in range(10):
                eng.bulk.run_idle_once()
            assert eng.bulk.status("idx")["status"] == "done"
        finally:
            eng.shutdown(drain=False)
    names = {side: sorted(os.listdir(sinks[side])) for side in sinks}
    assert names["ours"] == names["theirs"] and len(names["ours"]) == 2 * TINY["levels"]
    for level in range(TINY["levels"]):
        got = assemble_level(sinks["ours"], level, total=6)
        want = assemble_level(sinks["theirs"], level, total=6)
        assert got.shape == want.shape and np.abs(got - want).max() <= INDEX_ATOL
    assert [(lo, hi) for lo, hi, _ in level_parts(sinks["ours"], 0)] == [(0, 4), (4, 6)]
    # /similar over the built index: each image is its own top hit at level 0
    eng = ServingEngine(ckpt, device="cpu", buckets=(1, 4), reload_poll_s=0,
                        index_dir=sinks["ours"])
    try:
        imgs = SlotDataset(BulkJobSpec(name="q", dataset="synthetic:6", sink="/q", seed=2,
                                       image_size=16)).read(0, 4)
        results, info = eng.similar(imgs, level=0, k=1)
        assert [r[0]["slot"] for r in results] == [0, 1, 2, 3]
        assert info["index"]["slots"] == {str(lv): 6 for lv in range(TINY["levels"])}
    finally:
        eng.shutdown(drain=False)


# ---------------------------------------------------------------------------
# the bucket-and-offset bit check
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ff_impl", ["dense", "pallas", "fused"])
@pytest.mark.parametrize("family", ["embed", "reconstruct", "index"])
def test_slot_bits_across_buckets_and_offsets_on_the_cpu(bulk_ckpt, ff_impl, family):
    """One slot at every row offset of buckets 1, 2, 4 and 8 beside other
    slots: bitwise the bucket-8 answer at buckets 2-8, within BUCKET1_ATOL
    of it at bucket 1 (what holds on the CPU; the card's answer is
    chip_smoke.py's bulk phase)."""
    eng = ServingEngine(bulk_ckpt, device="cpu", buckets=(1, 2, 4, 8), reload_poll_s=0,
                        ff_impl=ff_impl, attention_impl="dense" if ff_impl == "dense" else "pallas",
                        quality_sample=0)
    ds = SlotDataset(BulkJobSpec(name="x", dataset="synthetic:24", sink="/x", seed=3,
                                 image_size=16))
    try:
        ref = eng.run(family, ds.read(0, 8))[0]
        worst = {}
        for bucket in (1, 2, 4, 8):
            for off in range(bucket):
                imgs = ds.read(8 + off, 8 + off + bucket).copy()
                imgs[off] = ds.read(0, 1)[0]
                got = eng.run(family, imgs)[off]
                worst[(bucket, off)] = float(np.abs(got - ref).max())
    finally:
        eng.shutdown(drain=False)
    assert all(v == 0.0 for (b, _), v in worst.items() if b > 1), worst
    assert worst[(1, 0)] <= BUCKET1_ATOL


# ---------------------------------------------------------------------------
# the jobs routes and the CLI
# ---------------------------------------------------------------------------
class _Served:
    def __init__(self, engine):
        self.engine = engine
        self.server = make_server(engine)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.url = "http://127.0.0.1:%d" % self.server.server_address[1]

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.engine.shutdown(drain=False)


def _request(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("route", ["submit", "status", "pause", "resume", "cancel",
                                   "GET status"])
def test_jobs_routes_are_404_without_the_tier(bulk_ckpt, route):
    served = _Served(ServingEngine(bulk_ckpt, device="cpu", buckets=(1,), reload_poll_s=0))
    try:
        if route == "GET status":
            got = _request(served.url + "/admin/jobs/status")
        else:
            got = _request(served.url + "/admin/jobs/" + route, {"name": "x"})
    finally:
        served.close()
    assert got == (404, BULK_OFF)


def test_jobs_verbs_over_http(bulk_ckpt, tmp_path):
    served = _Served(_engine(bulk_ckpt, tmp_path))
    base = served.url + "/admin/jobs/"
    try:
        code, doc = _request(base + "submit", _payload(tmp_path, total=6))
        assert code == 200 and (doc["name"], doc["total"], doc["status"]) == ("job", 6, "pending")
        assert _request(base + "pause", {"name": "job"})[1]["status"] == "paused"
        assert served.engine.bulk.run_idle_once() == 0
        assert _request(base + "resume", {"name": "job"})[1]["status"] == "running"
        assert served.engine.bulk.run_idle_once() == 4
        assert _request(base + "status", {"name": "job"})[1]["done"] == 4
        code, summary = _request(served.url + "/admin/jobs/status")
        assert code == 200 and summary["backlog"] == 2 and "job" in summary["jobs"]
        assert _request(served.url + "/admin/jobs/status?name=job")[1]["done"] == 4
        assert _request(served.url + "/admin/jobs/status?name=nope")[0] == 404
        assert _request(base + "pause", {"name": "nope"})[0] == 404
        code, err = _request(base + "submit", _payload(tmp_path, total=6, seed=9))
        assert code == 409 and "identity" in err["error"]
        assert _request(base + "explode", {"name": "job"})[0] == 404
        assert _request(base + "cancel", {"name": "job"})[1]["status"] == "cancelled"
        assert served.engine.bulk.run_idle_once() == 0
        assert _request(served.url + "/healthz")[1]["bulk"]["jobs"]["job"]["status"] == "cancelled"
    finally:
        served.close()


def test_bulk_run_cli_submit_status_watch_cancel(bulk_ckpt, tmp_path, capsys):
    served = _Served(_engine(bulk_ckpt, tmp_path))
    served.engine.start()              # the idle thread runs the job
    try:
        url = ["--url", served.url]
        assert bulk_run.main(["submit", *url, "--name", "cli", "--dataset", "synthetic:9",
                              "--sink", str(tmp_path / "cli_out"), "--seed", "4"]) == 0
        assert bulk_run.main(["watch", *url, "--name", "cli", "--interval", "0.05",
                              "--watch-timeout", "60"]) == 0
        assert bulk_run.main(["status", *url, "--format", "json"]) == 0
        out = capsys.readouterr().out
        assert "cli: done   9/9 slots" in out and '"backlog": 0' in out
        assert bulk_run.main(["cancel", *url, "--name", "cli"]) == 0
        assert "cancelled" in capsys.readouterr().out
        with pytest.raises(SystemExit, match="HTTP 404"):
            bulk_run.main(["cancel", *url, "--name", "nope"])
    finally:
        served.close()
    assert ChunkSink(str(tmp_path / "cli_out")).assemble(9).shape[0] == 9


def test_bulk_run_smoke_on_the_cpu(capsys):
    """python -m glom_tpu_torch.tools.bulk_run --smoke --device cpu: killed
    mid-job, resumed from the store, bitwise the uninterrupted control, no
    capture on the request path."""
    assert bulk_run.main(["--smoke", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["smoke"] == "ok" and all(report["checks"].values())
    assert 0 < report["durable_done_at_kill"] < report["total_slots"] == bulk_run.SMOKE_TOTAL
    assert report["graph_captures"] == [0, 0, 0]


def test_engine_adopts_a_store_glom_tpu_wrote_and_finishes_it(bulk_ckpt, tmp_path):
    """Resume across the packages: a job glom_tpu's store holds half done is
    adopted by the port engine at construction and finished from the cursor,
    its parts keeping the prefix another process wrote."""
    store = jax_jobs.JobStore(str(tmp_path / "bulk_store"))
    spec = jax_jobs.BulkJobSpec(**_payload(tmp_path, total=7), image_size=16)
    store.submit(spec, total=7)
    prefix = np.full((4, DEMO_CONFIG.levels, DEMO_CONFIG.dim), 7.0, np.float32)
    jax_jobs.ChunkSink(spec.sink).write(0, 4, prefix)
    store.advance("job", 0, 4)
    eng = _engine(bulk_ckpt, tmp_path)
    try:
        assert eng.bulk.backlog() == 3
        assert "bulk_jobs_parked_total" not in eng.registry.snapshot()
        _drain(eng)
        got = jax_jobs.ChunkSink(spec.sink).assemble(7)
        assert got[:4].tobytes() == prefix.tobytes()
        assert got[4:].tobytes() == eng.run("embed", SlotDataset(BulkJobSpec(
            **_payload(tmp_path, total=7), image_size=16)).read(4, 7)).tobytes()
        assert jax_jobs.JobStore(str(tmp_path / "bulk_store")).status("job")["status"] == "done"
    finally:
        eng.shutdown(drain=False)
