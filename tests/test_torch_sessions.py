"""The port's stateful session serving (glom_tpu_torch/serving/sessions.py, the
engine's session path, the /session/* routes) against glom_tpu's on the CPU.

The store's TTL, LRU-by-bytes and lock cases mirror glom_tpu's
tests/test_sessions.py under a fake clock, with tensor states.  The engine's
chained frames equal the port's ``video.rollout_varied`` bit for bit and
glom_tpu's ``session_embed`` on the same checkpoint within 1e-5 (float32);
a float32 spill written by either package restores in the other.
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
from glom_tpu.serving.engine import ServingEngine as JaxServingEngine
from glom_tpu.serving.engine import make_demo_checkpoint as jax_make_demo_checkpoint
from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.models import video
from glom_tpu_torch.obs.registry import MetricRegistry
from glom_tpu_torch.serving.batcher import Closed
from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
from glom_tpu_torch.serving.server import make_server
from glom_tpu_torch.serving.sessions import SessionStore, valid_session_id

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)
F32_RTOL = 1e-5


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, seconds):
        self.t += seconds


def _levels(b=2, seed=0, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, 16, 3, 32)).astype(np.float32)).to(dtype)


def _imgs(k, seed=0):
    return np.random.default_rng(seed).standard_normal((k, 3, 16, 16)).astype(np.float32)


def _store(**kw):
    clock = FakeClock()
    kw.setdefault("max_bytes", 1 << 30)
    kw.setdefault("ttl_s", 10.0)
    return SessionStore(clock=clock, **kw), clock


# -- the store ---------------------------------------------------------------

def test_session_id_contract():
    assert valid_session_id("cam-1.front:a_b")
    for bad in ("", "has space", "a/b", "x" * 129, None):
        assert not valid_session_id(bad)
    store, _ = _store()
    with pytest.raises(ValueError, match="invalid session id"):
        store.put("a/b", _levels(), batch=2, bucket=2, step=0, frames=1)


def test_put_get_roundtrip_counts_bytes_from_the_tensor():
    store, _ = _store()
    lv = _levels(dtype=torch.bfloat16)
    store.put("s1", lv, batch=1, bucket=2, step=7, frames=3)
    entry = store.get("s1")
    assert (entry.batch, entry.bucket, entry.step, entry.frames) == (1, 2, 7, 3)
    assert entry.levels is lv and entry.nbytes == lv.numel() * 2


def test_ttl_expiry_is_a_miss_and_counts():
    store, clock = _store(ttl_s=10.0)
    store.put("s1", _levels(), batch=2, bucket=2, step=0, frames=1)
    clock.advance(9.9)
    assert store.get("s1") is not None
    clock.advance(9.9)
    assert store.get("s1") is not None
    clock.advance(10.1)
    assert store.get("s1") is None
    assert store.stats.evicted_ttl == 1 and len(store) == 0


def test_sweep_evicts_only_expired_and_honours_its_interval():
    store, clock = _store(ttl_s=10.0)
    store.put("old", _levels(seed=1), batch=2, bucket=2, step=0, frames=1)
    clock.advance(8.0)
    store.put("new", _levels(seed=2), batch=2, bucket=2, step=0, frames=1)
    clock.advance(5.0)                                # old idle 13 s, new 5 s
    assert store.sweep(min_interval=100.0) == 0       # inside the interval: a no-op
    assert store.sweep() == 1
    assert store.get("old") is None and store.get("new") is not None


def test_lru_byte_bound_evicts_the_least_recent_first():
    entry_bytes = _levels().numel() * 4
    store, _ = _store(max_bytes=2 * entry_bytes)
    store.put("a", _levels(), batch=2, bucket=2, step=0, frames=1)
    store.put("b", _levels(), batch=2, bucket=2, step=0, frames=1)
    store.get("a")                                    # a is now the most recent
    store.put("c", _levels(), batch=2, bucket=2, step=0, frames=1)
    assert store.get("b") is None and store.get("a") is not None
    assert store.stats.evicted_lru == 1 and store.nbytes <= 2 * entry_bytes


def test_the_newest_entry_always_stays():
    lv = _levels()
    store, _ = _store(max_bytes=lv.numel())
    store.put("big", lv, batch=2, bucket=2, step=0, frames=1)
    assert store.get("big") is not None


def test_reset():
    store, _ = _store()
    store.put("s1", _levels(), batch=2, bucket=2, step=0, frames=1)
    assert store.reset("s1") is True and store.reset("s1") is False
    assert store.get("s1") is None and store.stats.resets == 1


def test_lock_cleanup_cannot_split_a_session():
    store, _ = _store()
    store.put("s", _levels(), batch=2, bucket=2, step=0, frames=1)
    stale = store.lock("s")
    store.reset("s")
    assert store.lock("s") is not stale
    with store.locked("s"):
        held = store._locks["s"]
        store.put("s", _levels(), batch=2, bucket=2, step=0, frames=1)
        store.reset("s")
        assert store._locks["s"] is held and held.locked()


def test_registry_gauges_track_the_store():
    reg, clock = MetricRegistry(), FakeClock()
    store = SessionStore(max_bytes=1 << 30, ttl_s=10.0, registry=reg, clock=clock)
    store.put("s1", _levels(), batch=2, bucket=2, step=0, frames=1)
    snap = reg.snapshot()
    assert snap["serving_session_count"] == 1.0
    assert snap["serving_session_bytes"] == float(_levels().numel() * 4)
    clock.advance(11.0)
    store.sweep()
    snap = reg.snapshot()
    assert snap["serving_session_count"] == 0.0 and snap["serving_session_evictions_ttl"] == 1.0


def test_spill_writes_float32_and_restores_at_the_serving_dtype(tmp_path):
    store, _ = _store()
    lv = _levels(seed=3, dtype=torch.bfloat16)
    store.put("s1", lv, batch=1, bucket=2, step=5, frames=4)
    assert store.spill(str(tmp_path)) == 1
    with np.load(tmp_path / "sessions.npz") as data:
        assert data["levels/s1"].dtype == np.float32
    fresh, _ = _store()
    assert fresh.restore(str(tmp_path),
                         place=lambda a: torch.from_numpy(a).to(torch.bfloat16)) == 1
    entry = fresh.get("s1")
    assert (entry.batch, entry.bucket, entry.step, entry.frames) == (1, 2, 5, 4)
    assert entry.levels.dtype == torch.bfloat16 and torch.equal(entry.levels, lv)


def test_restore_validates_the_shape_and_a_torn_spill_is_a_cold_boot(tmp_path):
    store, _ = _store()
    store.put("ok", _levels(), batch=2, bucket=2, step=0, frames=1)
    store.put("stale", torch.zeros(2, 3, 3, 8), batch=2, bucket=2, step=0, frames=1)
    store.spill(str(tmp_path))
    fresh, _ = _store()
    assert fresh.restore(str(tmp_path),
                         validate=lambda shape, dtype: tuple(shape[1:]) == (16, 3, 32)) == 1
    assert fresh.get("ok") is not None and fresh.get("stale") is None
    empty, _ = _store()
    assert empty.restore(str(tmp_path / "nowhere")) == 0
    # a torn npz (a crash mid-write outside the atomic rename) restores nothing
    with open(tmp_path / "sessions.npz", "r+b") as f:
        f.truncate(40)
    torn, _ = _store()
    assert torn.restore(str(tmp_path)) == 0 and len(torn) == 0


# -- the engine ----------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sessions_ckpt"))
    jax_make_demo_checkpoint(d, config=jax_config.GlomConfig(**TINY))
    return d


@pytest.fixture(scope="module")
def engine(ckpt):
    """Buckets (1, 2, 4): a 3-image session pads to 4; cold 6 iterations,
    warm 3 ("auto")."""
    eng = ServingEngine(ckpt, device="cpu", buckets=(1, 2, 4), reload_poll_s=0,
                        warm_iters="auto")
    yield eng
    eng.shutdown(drain=False)


@pytest.mark.parametrize("b", [1, 3])
def test_frames_equal_the_rollout_bitwise(engine, b):
    frames = [_imgs(b, seed=10 + t) for t in range(4)]
    sid = f"roll-{b}"
    got = [engine.session_embed(sid, f) for f in frames]
    assert [info["cold"] for _, info in got] == [True, False, False, False]
    assert [info["iters"] for _, info in got] == [6, 3, 3, 3]
    assert [info["frames"] for _, info in got] == [1, 2, 3, 4]
    params, cfg = engine.params["glom"], engine.serve_config
    bucket = 4 if b == 3 else b
    padded = [np.concatenate([f, np.zeros((bucket - b,) + f.shape[1:], np.float32)])
              for f in frames]
    with torch.no_grad():
        for t in range(1, 5):
            state = video.rollout_varied(params, [torch.from_numpy(f) for f in padded[:t]],
                                         [6] + [3] * (t - 1), config=cfg)
            want = state.mean(dim=1)[:b].numpy()
            assert np.array_equal(got[t - 1][0], want), t
    entry = engine.sessions.get(sid)
    assert tuple(entry.levels.shape) == (bucket, 16, 3, 32)


def test_frames_agree_with_glom_tpus_session_embed(ckpt, engine):
    theirs = JaxServingEngine(ckpt, buckets=(1, 2, 4), warmup=False, reload_poll_s=0,
                              warm_iters="auto", quality_sample=0)
    try:
        for t in range(4):
            x = _imgs(2, seed=20 + t)
            got, info = engine.session_embed("vs-jax", x)
            want, their_info = theirs.session_embed("vs-jax", x)
            want = np.asarray(want, np.float32)
            assert info == their_info
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err <= F32_RTOL, (t, err)
    finally:
        theirs.shutdown(drain=False)


def test_interleaved_sessions_give_what_each_gives_alone(engine):
    a = [_imgs(2, seed=30 + t) for t in range(3)]
    b = [_imgs(2, seed=40 + t) for t in range(3)]
    mixed = {"a": [], "b": []}
    for fa, fb in zip(a, b):
        mixed["a"].append(engine.session_embed("mix-a", fa)[0])
        mixed["b"].append(engine.session_embed("mix-b", fb)[0])
    alone = [engine.session_embed("solo-a", f)[0] for f in a]
    assert all(np.array_equal(x, y) for x, y in zip(mixed["a"], alone))


def test_a_batch_change_restarts_cold(engine):
    engine.session_embed("bc", _imgs(2))
    out, info = engine.session_embed("bc", _imgs(1))
    assert info["cold"] and info["restart"] == "batch_changed" and out.shape == (1, 3, 32)
    assert engine.registry.snapshot()["serving_session_cold_restarts"] >= 1.0


def test_bad_frames_are_refused(engine):
    with pytest.raises(ValueError, match="invalid session id"):
        engine.session_embed("a/b", _imgs(1))
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        engine.session_embed("big", _imgs(5))
    assert engine.session_reset("never-seen") is False


def test_sessions_disabled_engine_raises(ckpt):
    eng = ServingEngine(ckpt, device="cpu", buckets=(1,), reload_poll_s=0, warmup=False)
    assert not eng.sessions_enabled and eng.health()["sessions"] is None
    with pytest.raises(RuntimeError, match="sessions disabled"):
        eng.session_embed("s", _imgs(1))


def test_health_reports_sessions_as_glom_tpu_does(engine):
    sessions = engine.health()["sessions"]
    assert sessions["warm_iters"] == 3 and sessions["cold_iters"] == 6
    assert {"count", "bytes", "max_bytes", "ttl_s", "hits", "misses", "resets",
            "evicted_ttl", "evicted_lru"} <= set(sessions)
    assert engine.registry.snapshot().get("serving_graph_captures", 0) == 0


def test_a_spill_from_either_package_restores_in_the_other(ckpt, tmp_path):
    x0, x1 = _imgs(2, seed=50), _imgs(2, seed=51)
    # the port spills; glom_tpu restores and serves the next frame warm
    ours = ServingEngine(ckpt, device="cpu", buckets=(2,), reload_poll_s=0, warm_iters=2,
                         session_spill_dir=str(tmp_path / "a"))
    ours.session_embed("cam", x0)
    ours.shutdown()
    theirs = JaxServingEngine(ckpt, buckets=(2,), warmup=False, reload_poll_s=0, warm_iters=2,
                              quality_sample=0, session_spill_dir=str(tmp_path / "a"))
    want, info = theirs.session_embed("cam", x1)
    assert not info["cold"] and info["frames"] == 2
    # glom_tpu spills; the port restores
    theirs.shutdown()
    back = ServingEngine(ckpt, device="cpu", buckets=(2,), reload_poll_s=0, warm_iters=2,
                         session_spill_dir=str(tmp_path / "a"))
    assert back.registry.snapshot()["serving_session_restores"] == 1.0
    got, info = back.session_embed("cam", _imgs(2, seed=52))
    assert not info["cold"] and info["frames"] == 3
    ref = ServingEngine(ckpt, device="cpu", buckets=(2,), reload_poll_s=0, warm_iters=2)
    for x in (x0, x1):
        ref.session_embed("cam", x)
    want_next = ref.session_embed("cam", _imgs(2, seed=52))[0]
    assert np.linalg.norm(got - want_next) <= F32_RTOL * np.linalg.norm(want_next)


def test_the_port_restores_its_own_spill_bitwise(ckpt, tmp_path):
    spill = str(tmp_path)
    live = ServingEngine(ckpt, device="cpu", buckets=(2,), reload_poll_s=0, warm_iters=2,
                         session_spill_dir=spill)
    for t in range(2):
        live.session_embed("s", _imgs(2, seed=60 + t))
    live.shutdown()
    assert os.path.exists(os.path.join(spill, "sessions.json"))
    nxt = _imgs(2, seed=62)
    booted = ServingEngine(ckpt, device="cpu", buckets=(2,), reload_poll_s=0, warm_iters=2,
                           session_spill_dir=spill)
    got, info = booted.session_embed("s", nxt)
    ref = ServingEngine(ckpt, device="cpu", buckets=(2,), reload_poll_s=0, warm_iters=2)
    for t in range(2):
        ref.session_embed("s", _imgs(2, seed=60 + t))
    assert info["frames"] == 3 and np.array_equal(got, ref.session_embed("s", nxt)[0])
    with pytest.raises(Closed):
        live.session_embed("s", nxt)


def test_a_reload_keeps_sessions_warm(tmp_path):
    d = str(tmp_path)
    make_demo_checkpoint(d, config=GlomConfig(**TINY), seed=0)
    eng = ServingEngine(d, device="cpu", buckets=(1,), reload_poll_s=0, warm_iters=2)
    eng.session_embed("r", _imgs(1))
    make_demo_checkpoint(d, config=GlomConfig(**TINY), seed=1, step=1)
    assert eng.check_reload()
    out, info = eng.session_embed("r", _imgs(1, seed=1))
    assert not info["cold"] and info["step"] == 1 and info["frames"] == 2
    assert eng.registry.snapshot().get("serving_graph_captures", 0) == 0


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve(eng):
    eng.start()
    srv = make_server(eng, port=0)
    threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    return srv, "http://127.0.0.1:%d" % srv.server_address[1]


def test_session_routes_and_their_codes(ckpt):
    eng = ServingEngine(ckpt, device="cpu", buckets=(1, 2), reload_poll_s=0, warm_iters=2)
    srv, url = _serve(eng)
    body = {"session": "cam-1", "images": _imgs(1).tolist()}
    try:
        first = _post(url + "/session/embed", body)
        second = _post(url + "/session/embed", {**body, "level": 2})
        bad_level = _post(url + "/session/embed", {**body, "level": 7})
        bad_id = _post(url + "/session/embed", {**body, "session": "a b"})
        reset = _post(url + "/session/reset", {"session": "cam-1"})
        reset_bad = _post(url + "/session/reset", {"session": ""})
        third = _post(url + "/session/embed", body)
        latency = eng.registry.snapshot().get("serving_latency_seconds_session_count")
        eng.shutdown(drain=True)
        closed = _post(url + "/session/embed", body)
    finally:
        srv.shutdown()
        srv.server_close()
    assert first[0] == 200 and first[1]["cold"] and np.shape(first[1]["embeddings"]) == (1, 3, 32)
    assert second[0] == 200 and not second[1]["cold"] and second[1]["frames"] == 2
    assert np.shape(second[1]["embeddings"]) == (1, 32) and second[1]["session"] == "cam-1"
    assert bad_level[0] == 400 and bad_id[0] == 400 and reset_bad[0] == 400
    assert reset == (200, {"session": "cam-1", "reset": True})
    assert third[1]["cold"] and third[1]["iters"] == 6
    assert closed == (503, {"error": "shutting_down",
                            "detail": "server is draining; retry elsewhere"})
    assert latency is None or latency >= 3


def test_session_routes_are_404_without_sessions(ckpt):
    eng = ServingEngine(ckpt, device="cpu", buckets=(1,), reload_poll_s=0)
    srv, url = _serve(eng)
    try:
        codes = [_post(url + path, {"session": "s", "images": _imgs(1).tolist()})[0]
                 for path in ("/session/embed", "/session/parse", "/session/reset")]
    finally:
        srv.shutdown()
        srv.server_close()
        eng.shutdown(drain=False)
    assert codes == [404, 404, 404]
