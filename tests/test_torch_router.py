"""The port's fleet router (``glom_tpu_torch/serving/router.py``) against
``glom_tpu``'s on the CPU.

Both routers are driven through their injected ``clock``, ``sleep`` and
``http`` with the same scripted fake fleet, and must agree event for event:
the consistent-hash ring's picks, the least-loaded tie rotation, the health
timeline (ejections, backoff, re-admissions, catch-up calls), the rollout's
calls and states, the relabeled metrics text and ``health()``, the
``/similar`` merge and the bulk job's shards.  Then the port's router in
front of two port engines on the CPU: an ``/embed`` through it is bitwise the
serving replica's direct answer, a coordinated rollout under load leaves no
new -> old response ordered by dispatch, and fail-over loses no request.

Tests marked ``gpu`` run the same fleet on the card (an ``/embed`` through
the router bitwise the replica's, and each replica's graphs its own); this
file imports JAX only inside the parity tests, so on the GPU machine

    python -m pytest --noconftest -q -m gpu tests/test_torch_router.py
"""

import copy
import json
import random
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.serving import router as ours
from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
from glom_tpu_torch.serving.server import make_server

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = GlomConfig(dim=32, levels=3, image_size=16, patch_size=4)


@pytest.fixture(scope="module")
def theirs():
    from glom_tpu.serving import router

    return router


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, seconds):
        self.t += seconds


class FakeReplica:
    """The engine surface a router talks to, as a dict machine
    (``tests/test_router.py``'s, with ``/similar`` and ``/admin/jobs/*``):
    ``available`` is the newest step on disk."""

    def __init__(self, name, step=0):
        self.name = name
        self.step = step
        self.available = step
        self.staged = None
        self.prev = None
        self.up = True
        self.fail_prepare = False
        self.malformed_prepare = False
        self.fail_commit = False
        self.similar = None          # the /similar reply, or None for 404
        self.jobs = {}               # name -> [{"lo", "hi", "cursor"}]
        self.calls = []              # every (method, path, body) received
        self.on_commit = None

    def handle(self, method, path, body, headers):
        if not self.up:
            raise urllib.error.URLError("connection refused (fake)")
        payload = json.loads(body) if body else {}
        self.calls.append((method, path, payload))
        if path == "/healthz":
            health = {"status": "ok", "step": self.step, "image_size": 16, "channels": 3,
                      "levels": 3, "dim": 32, "buckets": [1, 2]}
            if self.jobs:
                health["bulk"] = {"jobs": {n: {"status": "running", "shards": shards}
                                           for n, shards in self.jobs.items()}}
            return 200, health
        if path == "/metrics":
            return 200, ("# HELP glom_serving_requests_total images\n"
                         "# TYPE glom_serving_requests_total counter\n"
                         f"glom_serving_requests_total {len(self.calls)}\n"
                         '# TYPE glom_serving_latency_ms histogram\n'
                         f'glom_serving_latency_ms_bucket{{le="+Inf"}} {self.step}\n'
                         "# EOF\n")
        if path in ("/embed", "/reconstruct", "/parse"):
            return 200, {"step": self.step, "embeddings": []}
        if path == "/similar":
            return (404, {"error": "no index"}) if self.similar is None else (200, self.similar)
        if path == "/admin/jobs/submit":
            lo, hi = payload["shard"]
            self.jobs.setdefault(payload["name"], []).append({"lo": lo, "hi": hi, "cursor": lo})
            return 200, {"name": payload["name"]}
        if path.startswith("/admin/jobs/"):
            return (200, {"ok": True}) if payload.get("name") in self.jobs else (404, {})
        if path == "/admin/reload/prepare":
            if self.fail_prepare:
                return 500, {"error": "injected prepare failure"}
            step = payload.get("step")
            if step is None:
                step = self.available if self.available > self.step else None
            if step is None or step == self.step:
                self.staged = None
                return 200, {"staged_step": None, "serving_step": self.step}
            self.staged = int(step)
            if self.malformed_prepare:
                return 200, {"staged_step": "garbage", "serving_step": self.step}
            return 200, {"staged_step": self.staged, "serving_step": self.step}
        if path == "/admin/reload/commit":
            if self.on_commit is not None:
                self.on_commit()
            if self.fail_commit:
                return 500, {"error": "injected commit failure"}
            if self.staged is not None:
                self.prev, self.step, self.staged = self.step, self.staged, None
            return 200, {"step": self.step}
        if path == "/admin/reload/abort":
            had, self.staged = self.staged is not None, None
            return 200, {"aborted": had}
        if path == "/admin/reload/rollback":
            if self.prev is None:
                return 409, {"error": "nothing to roll back to"}
            self.step, self.prev = self.prev, None
            return 200, {"step": self.step}
        if path == "/admin/reload/finalize":
            had, self.prev = self.prev is not None, None
            return 200, {"finalized": had}
        return 404, {"error": path}


class FakeFleet:
    """url -> FakeReplica, exposed as a router's injectable ``http``."""

    def __init__(self, n=3, step=0):
        self.replicas = {f"http://fake-{i}": FakeReplica(f"r{i}", step) for i in range(n)}

    @property
    def urls(self):
        return list(self.replicas)

    def __getitem__(self, i):
        return self.replicas[f"http://fake-{i}"]

    def __call__(self, method, url, body, headers, timeout):
        for known, replica in self.replicas.items():
            if url.startswith(known):
                status, payload = replica.handle(method, url[len(known):], body, headers)
                raw = payload if isinstance(payload, str) else json.dumps(payload)
                return status, {}, raw.encode()
        raise urllib.error.URLError(f"unknown fake url {url}")


def _pair(theirs, n=3, step=0, **kw):
    """(ours, theirs): each router over its own copy of one fake fleet."""
    out = []
    for mod in (ours, theirs):
        fleet, clock = FakeFleet(n, step), FakeClock()
        kw.setdefault("health_interval_s", 1.0)
        kw.setdefault("eject_after", 2)
        r = mod.FleetRouter(fleet.urls, clock=clock, sleep=lambda s: None, http=fleet, **kw)
        out.append((r, fleet, clock))
    return out


def _events(router):
    return [{k: v for k, v in e.items() if k != "t"} for e in router.timeline()]


def _state(router, fleet):
    return {"replicas": [r.to_dict() for r in router.replicas],
            "probes": [r.next_probe_at for r in router.replicas],
            "fleet_step": router.fleet_step, "phase": router.rollout_phase,
            "gate_open": router._dispatch_open.is_set(), "events": _events(router),
            "calls": {r.name: list(r.calls) for r in fleet.replicas.values()},
            "steps": {r.name: (r.step, r.staged, r.prev) for r in fleet.replicas.values()}}


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_ring_picks_equal_glom_tpus_for_1000_keys(theirs, n):
    (a, fa, _), (b, fb, _) = _pair(theirs, n)
    keys = [f"session-{i}" for i in range(1000)]
    picks = []
    for router in (a, b):
        got = []
        for k in keys:
            rep = router.pick(k)
            got.append(rep.name)
            rep.inflight -= 1
        # eject one replica: only its keys move
        with router._lock:
            router.replicas[n // 2].healthy = False
        for k in keys:
            rep = router.pick(k)
            got.append(rep.name)
            rep.inflight -= 1
        picks.append(got)
    assert picks[0] == picks[1]
    assert len(set(picks[0][:1000])) == n
    moved = [i for i in range(1000) if picks[0][i] != picks[0][1000 + i]]
    assert moved and all(picks[0][i] == f"r{n // 2}" for i in moved)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_least_loaded_tie_rotation_equals_glom_tpus(theirs, seed):
    """A scripted sequence of picks and releases (in-flight counts rising
    and falling): the same replica every step."""
    (a, _, _), (b, _, _) = _pair(theirs, 4)
    rng = random.Random(seed)
    script = [rng.random() for _ in range(300)]
    names = []
    for router in (a, b):
        held, got = [], []
        for u in script:
            if held and u < 0.45:
                held.pop(int(u * 1000) % len(held)).inflight -= 1
            else:
                rep = router.pick(exclude=held[-1:] if u > 0.95 else ())
                held.append(rep)
                got.append(rep.name)
        names.append((got, router._rr))
    assert names[0] == names[1]


def test_dispatch_fail_over_and_served_replica_equal_glom_tpus(theirs):
    (a, fa, _), (b, fb, _) = _pair(theirs, 3)
    out = []
    for router, fleet in ((a, fa), (b, fb)):
        fleet[0].up = False
        got = []
        for i in range(6):
            status, _, body, rep = router.dispatch("embed", b"{}", {"X-Request-Id": f"q{i}"})
            got.append((status, json.loads(body), rep.name))
        fleet[1].up = fleet[2].up = False
        with pytest.raises(RuntimeError, match="replicas"):   # NoHealthyReplica
            router.dispatch("embed", b"{}", {})
        out.append((got, _state(router, fleet)))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# health
# ---------------------------------------------------------------------------
def test_health_timeline_equals_glom_tpus_event_for_event(theirs):
    """Failures, ejections with backed-off probes, re-admissions, and a
    catch-up of a replica that missed a rollout, in the same order."""
    pair = _pair(theirs, 3, probe_backoff_max=4)
    states = []
    for router, fleet, clock in pair:
        trace = []
        router.check_health_once(force=True)
        # r1 dies: two failed probes eject it, then probes back off
        fleet[1].up = False
        for _ in range(8):
            clock.advance(1.0)
            router.check_health_once()
            trace.append(_state(router, fleet))
        # the fleet rolls forward while r1 is gone
        for i in (0, 2):
            fleet[i].available = 3
        report = router.coordinated_reload()
        trace.append(report)
        # r1 returns at the old step: re-admission after its catch-up
        fleet[1].up = True
        fleet[1].available = 3
        for _ in range(10):
            clock.advance(1.0)
            router.check_health_once()
        trace.append(_state(router, fleet))
        # r2 flaps: one failure is no ejection
        fleet[2].up = False
        clock.advance(1.0)
        router.check_health_once(force=True)
        fleet[2].up = True
        clock.advance(1.0)
        router.check_health_once(force=True)
        trace.append(_state(router, fleet))
        states.append(trace)
    assert states[0] == states[1]
    final = states[0][-1]
    assert [e["event"] for e in final["events"]
            if e["event"] != "capacity_recommendation"] == [
        "ejection", "rollout_committed", "readmission"]
    assert final["steps"]["r1"][0] == 3
    r1_admin = [p for _, p, _ in final["calls"]["r1"] if p.startswith("/admin/reload/")]
    assert r1_admin == ["/admin/reload/prepare", "/admin/reload/commit",
                        "/admin/reload/finalize"]


# ---------------------------------------------------------------------------
# the coordinated rollout
# ---------------------------------------------------------------------------
ROLLOUTS = ["committed", "noop", "pinned", "mixed", "prepare_fails", "malformed",
            "commit_fails"]


def _arrange(case, fleet):
    for r in fleet.replicas.values():
        r.available = 5
    if case == "noop":
        for r in fleet.replicas.values():
            r.available = r.step
    elif case == "mixed":
        fleet[0].step = fleet[0].available = 5
        fleet[1].available = fleet[1].step
    elif case == "prepare_fails":
        fleet[1].fail_prepare = True
    elif case == "malformed":
        fleet[2].malformed_prepare = True
    elif case == "commit_fails":
        fleet[2].fail_commit = True


@pytest.mark.parametrize("case", ROLLOUTS)
def test_rollout_calls_and_states_equal_glom_tpus(theirs, case):
    """Prepare failure -> abort; commit failure -> rollback; success -> the
    gate closes for the commit and reopens; a malformed reply aborts every
    staged replica.  The report, the calls each fake replica received, the
    steps and the router's state are the same."""
    out = []
    for router, fleet, _ in _pair(theirs, 3):
        router.check_health_once(force=True)
        _arrange(case, fleet)
        gates = []
        for r in fleet.replicas.values():
            r.on_commit = lambda router=router: gates.append(router._dispatch_open.is_set())
        try:
            report = router.coordinated_reload(step=5 if case == "pinned" else None)
        except (TypeError, ValueError) as e:
            report = {"raised": type(e).__name__}
        out.append((report, gates, _state(router, fleet)))
    assert out[0] == out[1]
    report, gates, state = out[0]
    want = {"committed": "committed", "pinned": "committed", "mixed": "committed",
            "noop": "noop", "prepare_fails": "aborted", "commit_fails": "rolled_back"}
    if case == "malformed":
        assert report == {"raised": "ValueError"}
        assert all(s[1] is None for s in state["steps"].values())
    else:
        assert report["status"] == want[case]
    assert state["gate_open"] and state["phase"] == "idle"
    assert gates == [False] * len(gates)
    if want.get(case) == "committed":
        assert {s[0] for s in state["steps"].values()} == {5}
    elif case != "noop":
        assert {s[0] for s in state["steps"].values()} == {0}


# ---------------------------------------------------------------------------
# aggregate views
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("openmetrics", [False, True])
def test_metrics_text_and_health_byte_equal_glom_tpus(theirs, openmetrics):
    out = []
    for router, fleet, clock in _pair(theirs, 3):
        router.check_health_once(force=True)
        fleet[2].up = False
        for _ in range(2):
            clock.advance(1.0)
            router.check_health_once(force=True)
        router.dispatch("embed", b"{}", {})
        out.append((router.metrics_text(openmetrics=openmetrics),
                    json.dumps(router.health(), sort_keys=True)))
    assert out[0] == out[1]
    text, health = out[0]
    assert 'glom_serving_requests_total{replica="r0"}' in text
    assert ("# replica r2 unreachable" in text) != openmetrics  # regrouping drops comments
    assert json.loads(health)["status"] == "degraded"
    assert text.endswith("# EOF\n") == openmetrics


def test_similar_merge_equals_glom_tpus(theirs):
    """Per image, candidates from every replica are deduped by slot (best
    score kept), ranked by (-score, slot) and cut to k; a replica without
    an index (404) contributes nothing."""
    rng = random.Random(3)

    def reply(slots):
        return {"level": 0, "k": 4, "index": {"parts": len(slots)},
                "results": [[{"slot": s, "score": round(rng.uniform(0, 1), 3)}
                             for s in slots] for _ in range(3)]}

    replies = [reply([0, 1, 2, 3]), reply([2, 3, 8, 9]), None]
    out = []
    for router, fleet, _ in _pair(theirs, 3):
        for i, r in enumerate(replies):
            fleet[i].similar = copy.deepcopy(r)
        out.append(router.similar_fanout(b"{}", {}))
    assert out[0] == out[1]
    status, payload, served = out[0]
    assert status == 200 and served == "r0,r1" and payload["replicas"] == ["r0", "r1"]
    for hits in payload["results"]:
        assert len(hits) == 4 and len({h["slot"] for h in hits}) == 4
        assert [h["score"] for h in hits] == sorted((h["score"] for h in hits), reverse=True)


def test_job_shards_and_repartition_equal_glom_tpus(theirs):
    """A fleet submit cuts [0, total) across the healthy replicas; a dead
    owner's unfinished range is re-cut onto the survivors from its last
    witnessed cursor, and it is revoked when it returns."""
    out = []
    for router, fleet, clock in _pair(theirs, 3):
        router.check_health_once(force=True)
        status = router.submit_job({"name": "j", "dataset": "synthetic:100",
                                    "transform": "embed", "sink": "/x"})
        for shard in fleet[1].jobs["j"]:
            shard["cursor"] = shard["lo"] + 10   # r1 finished 10 slots
        clock.advance(1.0)
        router.check_health_once(force=True)
        fleet[1].up = False
        for _ in range(2):
            clock.advance(1.0)
            router.check_health_once(force=True)
        fleet[1].up = True
        clock.advance(1.0)
        router.check_health_once(force=True)
        out.append((status, router.job_status("j"), router.job_status(), _events(router),
                    {r.name: r.jobs for r in fleet.replicas.values()},
                    {r.name: [c for c in r.calls if c[1].startswith("/admin/jobs/")]
                     for r in fleet.replicas.values()}))
    assert out[0] == out[1]
    first, _, _, events, _, _ = out[0]
    assert first["owners"] == {"r0": [[0, 34]], "r1": [[34, 67]], "r2": [[67, 100]]}
    moved = next(e for e in events if e["event"] == "bulk_repartition")
    assert moved["dead"] == "r1" and moved["moved"] == [[44, 56], [56, 67]]
    assert any(e["event"] == "bulk_revoke" and e["replica"] == "r1" for e in events)


# ---------------------------------------------------------------------------
# the port's router in front of the port's engines on the CPU
# ---------------------------------------------------------------------------
def _post(url, path, payload, headers=None, timeout=60):
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, dict(r.headers.items()), json.loads(r.read())


class Fleet:
    """Two port replicas (engine + HTTP server) behind the port's router."""

    def __init__(self, ckpt, device="cpu", n=2, health=True, **kw):
        self.members = []
        for _ in range(n):
            eng = ServingEngine(ckpt, buckets=(1, 2, 4), max_wait_ms=1.0, reload_poll_s=0,
                                device=device, **kw)
            eng.start(watch=False)
            srv = make_server(eng)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            self.members.append((eng, srv))
        self.urls = ["http://{}:{}".format(*srv.server_address[:2]) for _, srv in self.members]
        self.router = ours.FleetRouter(self.urls, health_interval_s=0.2)
        self.router.start(health=health)
        self.front = ours.make_router_server(self.router)
        threading.Thread(target=self.front.serve_forever, daemon=True).start()
        self.url = "http://{}:{}".format(*self.front.server_address[:2])

    def close(self):
        self.router.shutdown()
        self.front.shutdown()
        self.front.server_close()
        for eng, srv in self.members:
            srv.shutdown()
            srv.server_close()
            eng.shutdown(drain=False)


def _imgs(n, seed=0):
    return np.random.RandomState(seed).randn(n, 3, 16, 16).astype(np.float32)


@pytest.fixture
def tiny_ckpt(tmp_path):
    make_demo_checkpoint(str(tmp_path), config=TINY, seed=4)
    return str(tmp_path)


def test_embed_through_the_router_is_the_replicas_answer_bitwise(tiny_ckpt):
    fleet = Fleet(tiny_ckpt)
    try:
        served = set()
        for i, b in enumerate((1, 3, 2, 4)):
            body = {"images": _imgs(b, seed=i).tolist()}
            _, headers, via = _post(fleet.url, "/embed", body, {"X-Request-Id": f"r-{i}"})
            name = headers["X-Served-By"]
            served.add(name)
            _, _, direct = _post(fleet.urls[int(name[1:])], "/embed", body)
            assert via["embeddings"] == direct["embeddings"] and via["step"] == direct["step"]
            assert headers["X-Request-Id"] == f"r-{i}"
        assert served == {"r0", "r1"}
        # the proxy span parents the replica's request span in one trace
        proxy = next(s for s in fleet.router.tracer.sink.trace("r-0") if s.name == "proxy")
        spans = [s for eng, _ in fleet.members for s in eng.tracer.sink.trace("r-0")]
        assert next(s for s in spans if s.name == "request").parent_id == proxy.span_id
    finally:
        fleet.close()


def test_rollout_under_load_never_goes_new_to_old_by_dispatch(tiny_ckpt):
    """Ordered by dispatch: no request sent after a new-step answer arrived
    gets the old step."""
    fleet = Fleet(tiny_ckpt)
    try:
        # widen the commit window so the load straddles it
        eng1 = fleet.members[1][0]
        orig = eng1.commit_staged

        def slow_commit():
            time.sleep(0.15)
            return orig()

        eng1.commit_staged = slow_commit
        stop, seen, errors = threading.Event(), [], []
        body = json.dumps({"images": _imgs(1).tolist()}).encode()

        def client():
            while not stop.is_set():
                sent = time.monotonic()
                try:
                    _, _, resp = _post(fleet.url, "/embed", body)
                    seen.append((sent, time.monotonic(), resp["step"]))
                except Exception as e:  # noqa: BLE001 - recorded, asserted below
                    errors.append(repr(e))

        workers = [threading.Thread(target=client, daemon=True) for _ in range(3)]
        for w in workers:
            w.start()
        time.sleep(0.3)
        make_demo_checkpoint(tiny_ckpt, config=TINY, seed=5, step=7)
        report = fleet.router.coordinated_reload()
        time.sleep(0.5)
        stop.set()
        for w in workers:
            w.join(timeout=30)
        assert report["status"] == "committed" and report["step"] == 7
        assert not errors, errors[:3]
        # no request sent after a new-step answer arrived is answered from
        # the old step (a client never reads step 7 and then step 0)
        newest_before = [max([st for _, r, st in seen if r < sent], default=0)
                         for sent, _, _ in seen]
        assert all(st >= nb for (_, _, st), nb in zip(seen, newest_before))
        steps = [st for _, _, st in sorted(seen)]
        assert steps[0] == 0 and steps[-1] == 7 and 0 in steps and 7 in steps
        assert {eng.step for eng, _ in fleet.members} == {7}
    finally:
        fleet.close()


def test_fail_over_loses_no_request(tiny_ckpt):
    fleet = Fleet(tiny_ckpt)
    try:
        body = json.dumps({"images": _imgs(1).tolist()}).encode()
        served = []
        for i in range(16):
            if i == 6:
                _, srv = fleet.members[1]
                srv.shutdown()
                srv.server_close()
            status, headers, _ = _post(fleet.url, "/embed", body)
            assert status == 200
            served.append(headers["X-Served-By"])
        assert set(served[:6]) == {"r0", "r1"} and set(served[8:]) == {"r0"}

        def ejected():
            return any(e["event"] == "ejection" and e["replica"] == "r1"
                       for e in fleet.router.timeline())

        deadline = time.monotonic() + 10
        while not ejected() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert ejected()
        assert fleet.router.health()["healthy_replicas"] == 1
    finally:
        fleet.close()


def test_router_cli_spawns_cpu_replicas_and_refuses_platform(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        ours.main(["--spawn", "1", "--checkpoint-dir", str(tmp_path), "--platform", "cpu"])
    assert e.value.code == 2 and "--device" in capsys.readouterr().err
    ns = type("Args", (), {"checkpoint_dir": str(tmp_path), "demo": True, "buckets": "1,2",
                           "max_wait_ms": 1.0, "quant": "f32", "warm_iters": None,
                           "device": "cpu", "host": "127.0.0.1"})()
    urls, members = ours._spawn_fleet(2, ns)
    try:
        assert len(urls) == 2 and all(eng.device.type == "cpu" for eng, _ in members)
        router = ours.FleetRouter(urls, health_interval_s=0.2)
        router.check_health_once(force=True)
        health = router.health()
        # the --demo checkpoint is the 16-wide DEMO_CONFIG, glom_tpu's
        assert health["healthy_replicas"] == 2 and health["dim"] == 16
    finally:
        for eng, srv in members:
            srv.shutdown()
            srv.server_close()
            eng.shutdown(drain=False)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
CARD = GlomConfig(dim=128, levels=3, image_size=16, patch_size=8, ff_impl="pallas",
                  attention_impl="pallas")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the replicas' graphs of the kernels")
    return torch.device("cuda")


@pytest.mark.gpu
def test_embed_through_the_router_is_bitwise_the_replicas_on_the_card(cuda, tmp_path):
    make_demo_checkpoint(str(tmp_path), config=CARD, seed=2)
    fleet = Fleet(str(tmp_path), device=cuda)
    try:
        for i, b in enumerate((1, 2, 3, 4)):
            body = {"images": _imgs(b, seed=i).tolist()}
            _, headers, via = _post(fleet.url, "/embed", body)
            _, _, direct = _post(fleet.urls[int(headers["X-Served-By"][1:])], "/embed", body)
            assert via["embeddings"] == direct["embeddings"]
    finally:
        fleet.close()


@pytest.mark.gpu
def test_each_replicas_graphs_are_its_own_on_the_card(cuda, tmp_path):
    """Two replicas in one process: their graph sets hold different
    parameter copies, and a request served by one replays only its graphs
    (its set's launch count per replay, and nothing captured)."""
    from glom_tpu_torch.serving.engine import kernel_launches

    make_demo_checkpoint(str(tmp_path), config=CARD, seed=2)
    # no quality post-pass: a sampled batch would add its launches
    fleet = Fleet(str(tmp_path), device=cuda, health=False, quality_sample=0.0)
    try:
        (e0, _), (e1, _) = fleet.members
        assert e0.caches["embed"] is not e1.caches["embed"]
        from glom_tpu_torch.models.glom import tree_leaves

        p0, p1 = tree_leaves(e0.params), tree_leaves(e1.params)
        assert len(p0) == len(p1) > 0
        assert not {t.data_ptr() for t in p0} & {t.data_ptr() for t in p1}
        per = e0.caches["embed"].launches_per_replay()[1]
        assert per == e1.caches["embed"].launches_per_replay()[1]
        body = {"images": _imgs(1).tolist()}
        before = kernel_launches()
        _, headers, _ = _post(fleet.url, "/embed", body)
        after = kernel_launches()
        assert {k: after[k] - before[k] for k in after} == {
            k: per.get(k, 0) for k in after}
        assert e0.registry.snapshot().get("serving_graph_captures") is None
        assert e1.registry.snapshot().get("serving_graph_captures") is None
    finally:
        fleet.close()
