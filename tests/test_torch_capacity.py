"""The port's capacity plane against glom_tpu's on the CPU.

``glom_tpu_torch/obs/{timeseries,capacity}.py`` are copies of glom_tpu's
stdlib-only modules: one fake-clock script of registry updates, fed into both
packages' series store, accountant, advisor and plane, gives equal payloads
(history, forecasts, ``pressure_fired``, series), exactly.  The one
deliberate difference is the ceiling: the port's ``read_bench_ceiling()``
never reads the checkout's ``BENCH_*.json`` (a TPU's rate).  Then the port's
engine and server: ``/capacity`` and ``/debug/series`` are served, glom_tpu's
fleet plane ingests the port engine's ``/healthz`` summary as it ingests its
own, ``--buckets-file`` takes ``trace_report --suggest-buckets``'s payload,
the port's ``trace_report`` equals glom_tpu's on the same feeds, and
``python -m glom_tpu_torch.tools.capacity --smoke`` passes on the CPU.
glom_tpu's fleet router also shards a bulk job across two port replicas
through their ``/admin/jobs/*`` and ``/healthz["bulk"]``.
"""

import copy
import importlib.util
import json
import math
import os
import random
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from glom_tpu.obs import capacity as jax_capacity
from glom_tpu.obs import registry as jax_registry
from glom_tpu.obs import timeseries as jax_timeseries
from glom_tpu.obs import triggers as jax_triggers
from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.obs import capacity, registry, timeseries, triggers
from glom_tpu_torch.serving import server
from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
from glom_tpu_torch.tools import capacity as capacity_tool
from glom_tpu_torch.tools import trace_report

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = GlomConfig(dim=32, levels=3, image_size=16, patch_size=4)
SMOKE_SECONDS = 60.0


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# window math and the policy grammar
# ---------------------------------------------------------------------------

def _point_lists(seed):
    rng = random.Random(seed)
    out = [[], [(0.0, 1.0)], [(0.0, 1.0), (0.0, 2.0)]]
    for n in (3, 5, 12, 40):
        t, v, pts = 0.0, rng.uniform(-2, 2), []
        for i in range(n):
            t += rng.choice((0.5, 1.0, 1.0, 2.0))
            # a trend that turns over half way, with noise
            v += (1 if i < n // 2 else -1) * rng.uniform(0, 1) + rng.gauss(0, 0.2)
            pts.append((t, v))
        out.append(pts)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_math_is_glom_tpus(seed):
    for pts in _point_lists(seed):
        for name in ("delta", "rate", "linear_trend"):
            assert getattr(timeseries, name)(pts) == getattr(jax_timeseries, name)(pts), name
        for q in (0, 50, 95, 100):
            assert timeseries.percentile_over(pts, q) == jax_timeseries.percentile_over(pts, q)
        for eps in (0.0, 0.1):
            assert timeseries.trend_flip(pts, eps) == jax_timeseries.trend_flip(pts, eps)
        for thr in (-1.0, 0.0, 3.0):
            assert (timeseries.eta_to_threshold(pts, thr)
                    == jax_timeseries.eta_to_threshold(pts, thr))
    for slope in (None, 0.0, 1e-12, 2.0, -0.5):
        assert timeseries.trend_arrow(slope) == jax_timeseries.trend_arrow(slope)


@pytest.mark.parametrize("spec", ["p95_ms<250,duty<0.8,shed<0.01", "util>0.2, queue<4",
                                  "bulk_backlog<10", "duty<0.000001", "", "duty<=0.8",
                                  "latency<3", "duty<0.8,,", "p95_ms<-1"])
def test_policy_grammar_and_its_errors_are_glom_tpus(spec):
    def outcome(mod):
        try:
            return [(r.name, r.signal, r.op, r.bound) for r in mod.parse_capacity_policy(spec)]
        except ValueError as e:
            return ("error", str(e))

    assert outcome(capacity) == outcome(jax_capacity)


def test_series_store_payload_and_tiers_are_glom_tpus():
    stores = []
    for mod in (timeseries, jax_timeseries):
        clock = FakeClock(500.0)
        st = mod.SeriesStore(tiers=((1.0, 5), (10.0, 4)), clock=clock, max_series=2)
        for i in range(30):
            clock.t = 500.0 + 0.7 * i
            st.record("a", i * 1.5)
            st.record("b", -i, labels={"replica": "r1"})
            st.record("c", "not a number")
            st.record_snapshot({"d": i, "e": float("nan")})
        stores.append(st)
    ours, theirs = stores
    assert ours.dropped_series == theirs.dropped_series > 0
    for qs in ("", "name=a", "name=b&since=-3", "prefix=d&step=10", "name=a&since=505",
               "since=x", "name=zzz"):
        assert ours.payload(qs) == theirs.payload(qs), qs


# ---------------------------------------------------------------------------
# the plane, under one fake-clock traffic script
# ---------------------------------------------------------------------------

SCRIPTS = {
    # (seconds, requests/s, execute ms/s, sheds/s, queue depth) phases
    "burst_then_quiet": [(6, 8, 120.0, 0, 2), (12, 0, 0.0, 0, 0)],
    "steady": [(20, 4, 30.0, 0, 1)],
    "shed_storm": [(4, 2, 10.0, 0, 0), (8, 10, 900.0, 3, 60), (6, 1, 5.0, 0, 0)],
    "tenants_and_buckets": [(10, 6, 200.0, 1, 5), (6, 2, 20.0, 0, 0)],
}


def _drive(mods, script, policy, ceiling, tenants):
    """One plane of ``mods`` (the port's or glom_tpu's) through ``script``:
    each second the serving metrics move as the script says, then the
    plane ticks.  Returns what the plane shows at the end."""
    reg_mod, cap_mod, trig_mod = mods
    clock = FakeClock(1000.0)
    reg = reg_mod.MetricRegistry()
    trig = trig_mod.TriggerEngine(debounce_steps=5, max_captures=3, registry=reg)
    notes = []
    state = {"tokens": 4.0}
    plane = cap_mod.CapacityPlane(
        reg, policy=policy, ceiling_imgs_per_sec=ceiling, interval_s=1.0, window_s=6.0,
        persist_windows=2, clock=clock, triggers=trig,
        tenants_fn=(lambda: {"a": {"tokens": state["tokens"], "burst": 8.0},
                             "b": {"tokens": 0.0, "burst": 0}}) if tenants else None,
        on_recommend=lambda rec: notes.append(rec["action"]))
    rng = random.Random(7)
    recs = []
    for seconds, rps, exec_ms, sheds, queue in script:
        for _ in range(seconds):
            clock.t += 1.0
            reg.counter("serving_requests_total").inc(rps)
            reg.counter("serving_shed_total").inc(sheds)
            reg.gauge("serving_queue_depth").set(queue)
            for _ in range(max(1, rps // 4) if exec_ms else 0):
                reg.histogram("serving_execute_ms", unit="ms").observe(exec_ms / max(1, rps // 4))
            for _ in range(rps):
                reg.histogram("serving_request_ms", unit="ms").observe(rng.uniform(5, 400))
                bucket = rng.choice((1, 2, 4))
                occ = rng.choice((1, bucket)) / bucket
                reg.histogram("serving_batch_occupancy").observe(occ)
                reg.histogram(reg.labeled("serving_batch_occupancy_b", bucket)).observe(occ)
            state["tokens"] = max(0.0, state["tokens"] - 0.5)
            recs.append(plane.tick())
            plane.tick()  # a second tick inside the interval samples nothing
    return {"recs": recs, "payload": plane.payload(), "summary": plane.summary(),
            "series": plane.series_payload("prefix=capacity_&since=-30"),
            "names": plane.series_payload(""), "pressure_fired": plane.pressure_fired,
            "notes": notes, "snapshot": reg.snapshot()}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_plane_under_one_script_is_glom_tpus_exactly(script):
    tenants = script == "tenants_and_buckets"
    ceiling = 40.0 if script == "steady" else None
    policy = ("p95_ms<250,duty<0.1,shed<0.01" if script != "steady"
              else "util<0.05,queue<8,duty<0.9")
    ours = _drive((registry, capacity, triggers), SCRIPTS[script], policy, ceiling, tenants)
    theirs = _drive((jax_registry, jax_capacity, jax_triggers), SCRIPTS[script], policy,
                    ceiling, tenants)
    assert ours == theirs
    actions = {r["action"] for r in ours["recs"] if r}
    assert actions, "the script evaluated no window"
    if script in ("burst_then_quiet", "shed_storm"):
        assert ours["pressure_fired"] >= 1 and "scale_up" in actions


def test_fleet_plane_is_glom_tpus():
    plane = {}
    for name, mod in (("ours", capacity), ("theirs", jax_capacity)):
        clock = FakeClock(50.0)
        fleet = mod.FleetCapacityPlane(policy="duty<0.5,p95_ms<100", clock=clock,
                                       registry=(registry if name == "ours"
                                                 else jax_registry).MetricRegistry())
        recs = []
        for i in range(8):
            clock.t += 1.0
            fleet.ingest("r0", {"signals": {"duty": 0.1 * i, "p95_ms": 20.0 + i, "util": None}})
            fleet.ingest("r1", {"signals": {"duty": 0.05, "imgs_per_sec": 3.0 + i}})
            fleet.ingest("bad", None)
            recs.append(fleet.evaluate())
        plane[name] = (recs, fleet.payload(), fleet.series_payload("prefix=capacity_"))
    assert plane["ours"] == plane["theirs"]


# ---------------------------------------------------------------------------
# the ceiling: a path only
# ---------------------------------------------------------------------------

def test_no_ceiling_without_a_path_though_the_checkout_holds_bench_files():
    assert [f for f in os.listdir(REPO) if f.startswith("BENCH_") and f.endswith(".json")]
    assert capacity.read_bench_ceiling() is None
    # glom_tpu's falls back to those files: a TPU's rate
    assert jax_capacity.read_bench_ceiling() is not None
    # a path given is read as glom_tpu reads it
    path = os.path.join(REPO, "BENCH_r05.json")
    assert capacity.read_bench_ceiling(path) == jax_capacity.read_bench_ceiling(path)


# ---------------------------------------------------------------------------
# the engine and the server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("capacity_ckpt"))
    make_demo_checkpoint(d, config=TINY, seed=3)
    return d


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def served(ckpt, tmp_path_factory):
    log = str(tmp_path_factory.mktemp("trace") / "trace.jsonl")
    engine = ServingEngine(ckpt, device="cpu", buckets=(1, 2, 4), max_wait_ms=20.0,
                           reload_poll_s=0, trace_log=log, quality_sample=0,
                           capacity_policy="duty<0.5", capacity_window_s=5.0,
                           tenant_quotas={"t": "100:50"})
    engine.start(watch=False)
    srv = server.make_server(engine)
    threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    url = "http://127.0.0.1:%d" % srv.server_address[1]
    rng = np.random.default_rng(0)
    # one priming request: the first window needs a point before the burst
    _post(url + "/embed", {"images": rng.standard_normal((1, 3, 16, 16)).tolist()})
    engine.capacity.tick(2000.0)
    for k in (1, 3, 2, 1, 4, 1, 2, 3):
        _post(url + "/embed", {"images": rng.standard_normal((k, 3, 16, 16)).tolist()})
    engine.capacity.tick(2001.0)
    yield url, engine, log
    srv.shutdown()
    srv.server_close()
    engine.shutdown(drain=False)


def test_capacity_and_series_routes_are_served(served):
    url, engine, _ = served
    cap = _get(url + "/capacity")
    assert cap["role"] == "replica" and cap["policy"] == "duty<0.5"
    assert cap["recommendation"]["action"] in ("scale_up", "hold", "scale_down")
    assert cap["recommendation"]["signals"]["imgs_per_sec"] == pytest.approx(17.0)
    assert "capacity_duty_cycle" in cap["series_names"]
    listing = _get(url + "/debug/series")
    assert listing["tiers"] == [[1.0, 600], [10.0, 360], [60.0, 720]]
    assert "serving_execute_ms_sum" in listing["names"]
    assert "capacity_tenant_headroom_t" in listing["names"]
    duty = _get(url + "/debug/series?name=capacity_duty_cycle")
    assert [p[0] for p in duty["series"]["capacity_duty_cycle"]] == [2000.0, 2001.0]
    # no ceiling: no utilization
    assert "capacity_utilization" not in listing["names"]
    assert cap["recommendation"]["signals"]["util"] is None
    # the capacity summary rides /healthz
    assert _get(url + "/healthz")["capacity"] == engine.capacity.summary()


def test_glom_tpus_fleet_plane_ingests_the_port_engines_health(served):
    _, engine, _ = served
    summary = engine.health()["capacity"]
    fleets = []
    for mod in (capacity, jax_capacity):
        fleet = mod.FleetCapacityPlane(clock=FakeClock(9.0))
        fleet.ingest("torch-r0", copy.deepcopy(summary))
        fleet.ingest("other", {"signals": {"duty": 0.25, "imgs_per_sec": 5.0}})
        fleets.append((fleet.evaluate(), fleet.payload()))
    assert fleets[0] == fleets[1]
    rec, payload = fleets[1]
    assert payload["replicas"]["torch-r0"] == summary["signals"]
    assert rec["signals"]["imgs_per_sec"] == pytest.approx(summary["signals"]["imgs_per_sec"]
                                                           + 5.0)


# a slot at bucket 1 against the same slot at a larger bucket on the CPU
# (tests/test_torch_bulk.py's bit check): the plain matmuls sum a one-image
# batch in another order
BUCKET1_ATOL = 1e-6


def test_glom_tpus_router_shards_a_job_across_two_port_replicas(ckpt, tmp_path):
    """glom_tpu's FleetRouter in front of two port engines: a synthetic job
    is cut across both, each replica's idle buckets run its shard into the
    shared sink, the router reads every cursor from their ``/healthz["bulk"]``
    and calls the job done.  The assembled output equals a single engine's:
    bitwise on every slot that ran at a bucket above 1 in both runs, within
    BUCKET1_ATOL on a slot that ran at bucket 1 in one of them (the
    control's tail chunk [12, 13); the second shard's tail [11, 13) runs at
    bucket 4)."""
    from glom_tpu.bulk.jobs import ChunkSink as JaxChunkSink
    from glom_tpu.serving.router import FleetRouter

    total, sink = 13, str(tmp_path / "out")
    payload = {"name": "fleet", "dataset": f"synthetic:{total}", "transform": "embed",
               "sink": sink, "seed": 4}
    replicas = []
    for name in ("r0", "r1"):
        engine = ServingEngine(ckpt, device="cpu", buckets=(1, 4), reload_poll_s=0,
                               quality_sample=0, bulk_dir=str(tmp_path / f"store_{name}"))
        engine.start(workers=False, watch=False)
        srv = server.make_server(engine)
        threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                         daemon=True).start()
        replicas.append((engine, srv, "http://127.0.0.1:%d" % srv.server_address[1]))
    router = FleetRouter([url for _, _, url in replicas], names=["r0", "r1"])
    try:
        router.check_health_once(force=True)
        status = router.submit_job(dict(payload))
        assert status["owners"] == {"r0": [[0, 7]], "r1": [[7, 13]]}
        for engine, _, _ in replicas:
            while engine.bulk.run_idle_once():
                pass
        router.check_health_once(force=True)
        done = router.job_status("fleet")
        bulks = [_get(url + "/healthz")["bulk"] for _, _, url in replicas]
    finally:
        for engine, srv, _ in replicas:
            srv.shutdown()
            srv.server_close()
            engine.shutdown(drain=False)
    assert done["status"] == "done" and done["done"] == total
    assert [b["jobs"]["fleet"]["shards"][0]["cursor"] for b in bulks] == [7, 13]
    got = JaxChunkSink(sink).assemble(total)
    control = ServingEngine(ckpt, device="cpu", buckets=(1, 4), reload_poll_s=0,
                            quality_sample=0, bulk_dir=str(tmp_path / "store_control"))
    try:
        control.bulk.submit(dict(payload, sink=str(tmp_path / "control")))
        while control.bulk.run_idle_once():
            pass
    finally:
        control.shutdown(drain=False)
    want = JaxChunkSink(str(tmp_path / "control")).assemble(total)
    assert got[:12].tobytes() == want[:12].tobytes()
    assert np.abs(got[12] - want[12]).max() <= BUCKET1_ATOL


def test_trace_report_is_glom_tpus_on_a_served_feed_and_the_golden_one(served):
    _, _, log = served
    theirs = _tool("trace_report")
    golden = os.path.join(REPO, "tests", "data", "golden_trace.jsonl")
    for feed in (log, golden):
        ours_t, their_t = trace_report.read_many([feed]), theirs.read_many([feed])
        assert ours_t == their_t and ours_t
        assert trace_report.summarize(ours_t, slowest=3) == theirs.summarize(their_t, slowest=3)
        for k in (None, 1, 2, 3):
            assert (trace_report.suggest_buckets(ours_t, ladder_size=k)
                    == theirs.suggest_buckets(their_t, ladder_size=k))
    sizes = trace_report.observed_batch_sizes(trace_report.read_many([log]))
    assert sorted(sizes) == [1, 1, 1, 1, 2, 2, 3, 3, 4]
    rng = random.Random(5)
    for _ in range(20):
        xs = [rng.randint(1, 9) for _ in range(rng.randint(1, 30))]
        for k in (1, 2, 3, 5):
            assert trace_report.suggest_ladder(xs, k) == theirs.suggest_ladder(xs, k)


def test_trace_report_cli_feeds_buckets_file_and_refuses_several_feeds(served, tmp_path, capsys):
    url, _, log = served
    assert trace_report.main([log, "--suggest-buckets", "--ladder-size", "2"]) == 0
    payload = json.loads(capsys.readouterr().out)
    ladder_file = tmp_path / "ladder.json"
    ladder_file.write_text(json.dumps(payload))
    assert server.read_buckets_file(str(ladder_file)) == tuple(payload["suggested_buckets"])
    assert len(payload["suggested_buckets"]) == 2 and payload["suggested_buckets"][-1] == 4
    # several feeds are joined by trace id through the fleet observatory's
    # stitch, as glom_tpu's tool joins them
    theirs = _tool("trace_report")
    joined = trace_report.read_many([log, log])
    assert joined == theirs.read_many([log, log]) and joined
    assert trace_report.main([log, log, "--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(
        theirs.summarize(theirs.read_many([log, log]))))


def test_capacity_cli_report_and_query(served, capsys):
    url, _, _ = served
    assert capacity_tool.main(["report", "--url", url]) == 0
    out = capsys.readouterr().out
    assert "role=replica" in out and "duty<0.5" in out
    assert capacity_tool.main(["query", "--url", url, "--name", "capacity_duty_cycle"]) == 0
    assert capsys.readouterr().out.startswith("# capacity_duty_cycle (2 points)")
    # the fleet leg: the port's router in front of a port replica ingests
    # its capacity summary and logs its recommendation
    assert capacity_tool.main(["--smoke", "--fleet", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["smoke"] == "ok" and report["checks"]["fleet_ingested"]
    assert report["checks"]["fleet_replica_series"]
    assert report["fleet_recommendation"]["event"] == "capacity_recommendation"


def test_capacity_smoke_passes_on_the_cpu(capsys):
    t0 = time.monotonic()
    assert capacity_tool.main(["--smoke", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert time.monotonic() - t0 < SMOKE_SECONDS
    assert report["smoke"] == "ok" and all(report["checks"].values())
    assert report["pressure_fired"] == 1 and report["scale_up_window"] <= 3
    assert report["quiescence_actions"][-1] == "scale_down"
    assert math.isfinite(report["burst_signals"]["duty"]) and report["burst_signals"]["duty"] > 0
