"""The port's serving observability against glom_tpu's on the CPU.

The port keeps its own copies of glom_tpu's stdlib-only obs modules
(``glom_tpu_torch/obs/{registry,exporters,tracing,triggers,events,slo}.py``)
and of the load generator's report (``glom_tpu_torch/tools/loadgen.py``).
Here the same operations go into both packages and must give the same
results: the ``/metrics`` text (0.0.4, and OpenMetrics with exemplars and
timestamps), header parsing and trace records under a fake clock, SLO burn
rates and firing times, the saturation monitor's fires, and the loadgen
report.  Then both servers run on one checkpoint (written by the port) and
take the same requests: their answers agree within 1e-4, ``/metrics`` names
the same ``serving_*`` families (``serving_graph_captures`` for
``serving_xla_compiles``, both absent after warm-up), request identity is
echoed alike, each trace holds the same span names, and shed and drain are
the same structured 503s.  The capacity and quality arguments and flags
reach the engine's planes as glom_tpu's do; the arguments and flags the port
does not take yet are refused by name.
"""

import importlib.util
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from glom_tpu.obs import exporters as jax_exporters
from glom_tpu.obs import registry as jax_registry
from glom_tpu.obs import slo as jax_slo
from glom_tpu.obs import tracing as jax_tracing
from glom_tpu.obs import triggers as jax_triggers
from glom_tpu.obs.quality import QUALITY_SLO_METRICS as JAX_QUALITY_SLO_METRICS
from glom_tpu.serving import server as jax_server
from glom_tpu.serving.engine import ServingEngine as JaxServingEngine
from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.obs import exporters, registry, slo, tracing, triggers
from glom_tpu_torch.serving import server
from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
from glom_tpu_torch.tools import loadgen
from tests.polling import poll_until

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

FWD_ATOL = 1e-4
TINY = GlomConfig(dim=32, levels=3, image_size=16, patch_size=4)
BUCKETS = (1, 4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ---------------------------------------------------------------------------
# registry and exporters
# ---------------------------------------------------------------------------

def _fill(reg_mod):
    """One sequence of counter, gauge, histogram, labeled and exemplar
    operations into a fresh registry of ``reg_mod``."""
    reg = reg_mod.MetricRegistry()
    reg.counter("serving_requests_total", help="images served").inc(3)
    reg.counter("serving_requests_total").inc()
    reg.counter("serving_errors_5xx", help="5xx").inc()
    reg.gauge("serving_queue_depth", help="queued images").set(7)
    reg.gauge("serving_checkpoint_step").set(12)
    h = reg.histogram("serving_request_ms", unit="ms", help="request span")
    for i, v in enumerate([0.4, 3.0, 7.5, 40.0, 400.0, 9000.0, 2.5]):
        h.observe(v, exemplar=f"{i:032x}")
    reg.histogram(reg.labeled("serving_execute_ms_b", 4), unit="ms").observe(12.0, exemplar="ab")
    reg.histogram("serving_batch_occupancy").observe(0.75)
    ticks = iter([10.0, 10.25])
    with reg.timer("phase_seconds", clock=lambda: next(ticks)):
        pass
    return reg


@pytest.mark.parametrize("om,stamp", [(False, False), (True, False), (True, True)])
def test_prometheus_text_matches_glom_tpu(om, stamp):
    ours = exporters.prometheus_lines(_fill(registry), exemplars=om, timestamps=stamp,
                                      now=1700000000.5)
    theirs = jax_exporters.prometheus_lines(_fill(jax_registry), exemplars=om, timestamps=stamp,
                                            now=1700000000.5)
    assert ours == theirs
    assert ("# {" in ours) == om and "glom_serving_requests_total 4" in ours


def test_registry_snapshot_and_content_negotiation_match_glom_tpu():
    assert _fill(registry).snapshot() == _fill(jax_registry).snapshot()
    for accept in (None, "", "text/plain", "application/openmetrics-text; version=1.0.0",
                   "application/openmetrics-text;q=0.9,text/plain;q=0.1"):
        assert exporters.wants_openmetrics(accept) == jax_exporters.wants_openmetrics(accept)
    assert exporters.OPENMETRICS_CONTENT_TYPE == jax_exporters.OPENMETRICS_CONTENT_TYPE
    assert exporters.PROM_TEXT_CONTENT_TYPE == jax_exporters.PROM_TEXT_CONTENT_TYPE


def test_jsonl_exporter_matches_glom_tpu(tmp_path):
    recs = [{"step": 1, "loss": 0.5, "event": "resume"},
            {"step": 2, "loss": float("nan"), "x": 3}]
    for mod, name in ((exporters, "ours.jsonl"), (jax_exporters, "theirs.jsonl")):
        exp = mod.JsonlExporter(path=str(tmp_path / name))
        for r in recs:
            exp.emit(dict(r))
        exp.close()
    assert (tmp_path / "ours.jsonl").read_text() == (tmp_path / "theirs.jsonl").read_text()


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

TRACEPARENTS = [
    None, "", "garbage",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-01",
    "00-00000000000000000000000000000000-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-0000000000000000-01",
    "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331",
    "00-xyz7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
]
REQUEST_IDS = [None, "", "lg-1-2", "a" * 200, "with space", "abc\n", "ÿ", "0123abcd"]


@pytest.mark.parametrize("header", TRACEPARENTS)
def test_traceparent_parse_matches_glom_tpu(header):
    assert tracing.parse_traceparent(header) == jax_tracing.parse_traceparent(header)


@pytest.mark.parametrize("rid", REQUEST_IDS)
def test_request_id_matches_glom_tpu(rid):
    assert tracing.request_trace_id(rid) == jax_tracing.request_trace_id(rid)


def test_span_names_and_formatting_match_glom_tpu():
    names = [n for n in dir(jax_tracing) if n.startswith("SPAN_")]
    assert names and all(getattr(tracing, n) == getattr(jax_tracing, n) for n in names)
    assert tracing.SPAN_METRICS == jax_tracing.SPAN_METRICS
    assert (tracing.format_traceparent("0af7651916cd43dd8448eb211c80319c", "b7ad6b7169203331")
            == jax_tracing.format_traceparent("0af7651916cd43dd8448eb211c80319c",
                                              "b7ad6b7169203331"))


def _trace_run(mod, reg_mod, monkeypatch):
    """One request's spans through ``mod``'s Tracer under a fake clock and
    deterministic ids; returns the completed records, the pull payload and
    the registry snapshot."""
    counter = iter(range(10 ** 6))
    monkeypatch.setattr(mod, "new_id", lambda: f"{next(counter):016x}")
    clock = FakeClock()
    reg = reg_mod.MetricRegistry()
    tracer = mod.Tracer(clock=clock, sink=mod.TraceSink(max_traces=4), registry=reg,
                        completed_max=8)
    for i in range(3):
        root = tracer.start_trace(mod.SPAN_REQUEST, trace_id=f"req-{i}",
                                  attrs={"endpoint": "embed"})
        clock.advance(0.002)
        tracer.record(mod.SPAN_PARSE, root, root.start, clock())
        q = tracer.start_span(mod.SPAN_QUEUE_WAIT, root, attrs={"images": 2})
        clock.advance(0.005)
        tracer.end(q, attrs={"flush_reason": "deadline"})
        t0 = clock()
        clock.advance(0.010)
        tracer.record(mod.SPAN_EXECUTE, root, t0, clock(), attrs={"bucket": 4, "images": 2})
        with tracer.span(mod.SPAN_RESPOND, root):
            clock.advance(0.001)
        tracer.end(root, attrs={"status": 200})
    _, records = tracer.completed_since(0)
    status, payload = mod.debug_traces_payload(tracer, "since=1", role="engine", step=3)
    bad = mod.debug_traces_payload(tracer, "since=x")
    return records, (status, payload), bad, reg.snapshot()


def test_trace_records_match_glom_tpu(monkeypatch):
    ours = _trace_run(tracing, registry, monkeypatch)
    theirs = _trace_run(jax_tracing, jax_registry, monkeypatch)
    assert ours == theirs
    records = ours[0]
    assert [r["trace_id"] for r in records] == ["req-0", "req-1", "req-2"]
    assert [s["name"] for s in records[0]["spans"]] == ["request", "parse", "queue_wait",
                                                        "execute", "respond"]
    assert tracing.span_coverage(records[0]["spans"]) == jax_tracing.span_coverage(
        records[0]["spans"])


# ---------------------------------------------------------------------------
# SLOs and triggers
# ---------------------------------------------------------------------------

SLO_SPECS = ["embed:p95<250ms", "errors<1%", "reconstruct:p99<40ms", "embed:p50<10ms",
             "agreement>0.8"]
# windows short enough for the 200 s stream below to burn them
SLO_WINDOWS = {"short_window_s": 10.0, "long_window_s": 60.0}


def test_quality_slo_metrics_is_glom_tpus():
    assert slo.QUALITY_SLO_METRICS == JAX_QUALITY_SLO_METRICS


@pytest.mark.parametrize("spec", SLO_SPECS + ["nonsense", "embed:p95<", "errors<200%"])
def test_parse_slo_matches_glom_tpu(spec):
    try:
        want = jax_slo.parse_slo(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            slo.parse_slo(spec)
        assert str(got.value) == str(e)
        return
    got = slo.parse_slo(spec)
    assert vars(got) == vars(want)


def _slo_run(slo_mod, reg_mod, trig_mod):
    """One outcome stream into ``slo_mod``'s SloManager under a fake clock:
    burn rates after each event, and when and what fired."""
    clock = FakeClock()
    reg = reg_mod.MetricRegistry()
    trig = trig_mod.TriggerEngine(debounce_steps=5, max_captures=10, registry=reg)
    mgr = slo_mod.SloManager([slo_mod.parse_slo(s, **SLO_WINDOWS) for s in SLO_SPECS], clock=clock,
                             registry=reg, triggers=trig)
    rng = np.random.default_rng(0)
    rates, fired = [], []
    for i in range(400):
        clock.advance(0.5)
        slow = 150 <= i < 260
        endpoint = "embed" if i % 3 else "reconstruct"
        latency = float(rng.uniform(300, 600) if slow else rng.uniform(1, 50))
        error = bool(slow and i % 4 == 0)
        out = mgr.observe(endpoint, None if error else latency, error,
                          trace_id=f"t{i}", step=i)
        fired += [(i, clock(), d) for d in out]
        rates.append([ev.burn_rates() for ev in mgr.evaluators])
    return rates, fired, list(mgr.fired), reg.snapshot()


def test_slo_burn_rates_and_firing_times_match_glom_tpu():
    ours = _slo_run(slo, registry, triggers)
    theirs = _slo_run(jax_slo, jax_registry, jax_triggers)
    assert ours == theirs
    assert ours[1], "the stream must burn at least one SLO"


def test_queue_saturation_monitor_matches_glom_tpu():
    seq = [(10, 64, 0), (60, 64, 0), (62, 64, 0), (63, 64, 0), (64, 64, 2), (5, 64, 0),
           (58, 64, 0), (59, 64, 1), (60, 64, 0), (61, 64, 0), (0, 64, 0)] * 3
    for threshold, sustained in ((0.9, 3), (0.5, 1), (1.0, 1)):
        ours = triggers.QueueSaturationMonitor(threshold=threshold, sustained=sustained)
        theirs = jax_triggers.QueueSaturationMonitor(threshold=threshold, sustained=sustained)
        got = [ours.update(*s) for s in seq]
        assert got == [theirs.update(*s) for s in seq] and any(got)
    names = [n for n in dir(jax_triggers) if n.startswith("TRIGGER_")]
    assert all(getattr(triggers, n) == getattr(jax_triggers, n) for n in names)


# ---------------------------------------------------------------------------
# the load generator's report
# ---------------------------------------------------------------------------

def _jax_loadgen():
    spec = importlib.util.spec_from_file_location("jax_loadgen",
                                                  os.path.join(REPO, "tools", "loadgen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_loadgen_percentile_and_report_match_tools_loadgen():
    lg = _jax_loadgen()
    rng = np.random.default_rng(1)
    for n in (0, 1, 2, 7, 100):
        xs = list(rng.uniform(0, 100, n))
        for q in (0, 1, 50, 95, 99, 100):
            assert loadgen.percentile(xs, q) == lg.percentile(xs, q)
    events = []
    for i in range(60):
        kind = rng.choice(["ok", "ok", "ok", "shed", "error", "mismatch"])
        events.append(dict(
            latency_ms=float(rng.uniform(1, 900)) if kind in ("ok", "mismatch") else None,
            images=int(rng.integers(1, 9)) if kind in ("ok", "mismatch") else 0,
            shed=kind == "shed", error=kind == "error", request_id=f"lg-1-{i}",
            id_mismatch=kind == "mismatch",
            replica=["http://a", "http://b"][i % 2] if i >= 30 else None,
            endpoint=["embed", "reconstruct"][i % 3 == 0]))
    for subset in (events[:1], events[:30], events):
        ours, theirs = loadgen.Results(), lg._Results()
        for e in subset:
            ours.record(**e)
            theirs.record(**e)
        for wall, mode, slow_n in ((2.5, "closed(c=8)", 0), (10.0, "open(5.0/s)", 3), (0, "x", 0)):
            assert loadgen.report(ours, wall, mode, slow_n) == lg.report(theirs, wall, mode,
                                                                         slow_n)


@pytest.mark.parametrize("n_ok", [1, 99, 100])
def test_loadgen_reports_no_tail_below_min_tail(n_ok):
    """A p95 or p99 of fewer than ``min_tail`` answers is null, and the
    report says how many there were; from ``min_tail`` on it is
    ``tools/loadgen.py``'s."""
    lg = _jax_loadgen()
    rng = np.random.default_rng(n_ok)
    ours, theirs = loadgen.Results(), lg._Results()
    for i in range(n_ok):
        e = dict(latency_ms=float(rng.uniform(1, 900)), images=2, request_id=f"lg-1-{i}")
        ours.record(**e)
        theirs.record(**e)
    got = loadgen.report(ours, 4.0, "open(2.0/s)", min_tail=loadgen.MIN_TAIL_SAMPLES)
    want = lg.report(theirs, 4.0, "open(2.0/s)")
    if n_ok < 100:
        assert got.pop("latency_samples") == n_ok
        assert got["latency_ms"]["p95"] is None and got["latency_ms"]["p99"] is None
        assert want["latency_ms"]["p95"] is not None
        got["latency_ms"].update(p95=want["latency_ms"]["p95"], p99=want["latency_ms"]["p99"])
    assert got == want


# ---------------------------------------------------------------------------
# both servers on one checkpoint
# ---------------------------------------------------------------------------

def _request(url, payload=None, headers=None, raw=False):
    """``(status, body, response headers)`` of a GET (no payload) or POST."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = resp.read()
            return resp.status, (body.decode() if raw else json.loads(body)), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


class _Served:
    def __init__(self, engine, make, *, workers=True):
        self.engine = engine
        engine.start(workers=workers, watch=False)
        self.server = make(engine, port=0)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       kwargs={"poll_interval": 0.05}, daemon=True)
        self.thread.start()
        self.url = "http://127.0.0.1:%d" % self.server.server_address[1]

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        self.engine.shutdown(drain=False)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("shared_ckpt"))
    make_demo_checkpoint(d, config=TINY, seed=11)
    return d


@pytest.fixture(scope="module")
def both(ckpt):
    """The port's and glom_tpu's servers, warmed, on the same checkpoint."""
    ours = _Served(ServingEngine(ckpt, device="cpu", buckets=BUCKETS, max_wait_ms=1.0,
                                 reload_poll_s=0), server.make_server)
    theirs = _Served(JaxServingEngine(ckpt, buckets=BUCKETS, max_wait_ms=1.0, reload_poll_s=0,
                                      quality_sample=0.0), jax_server.make_server)
    yield ours, theirs
    ours.close()
    theirs.close()


def _imgs(k, seed):
    return np.random.default_rng(seed).standard_normal((k, 3, 16, 16)).astype(np.float32)


REQUESTS = [  # (endpoint, images, seed, headers, extra body)
    ("embed", 1, 0, {"X-Request-Id": "same-req-1"}, {}),
    ("embed", 3, 1, {"traceparent": "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"},
     {}),
    ("reconstruct", 2, 2, {"X-Request-Id": "0123456789abcdef0123456789abcdef"}, {}),
    ("embed", 4, 3, {}, {"level": -1}),
    ("embed", 2, 4, {"X-Request-Id": "bad-level"}, {"level": 7}),
]


def _families(text):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE glom_serving_")}


def test_servers_answer_and_report_alike(both):
    ours, theirs = both
    replies = {}
    for side, served in (("ours", ours), ("theirs", theirs)):
        replies[side] = [
            _request(f"{served.url}/{ep}", {"images": _imgs(k, seed).tolist(), **extra}, headers)
            for ep, k, seed, headers, extra in REQUESTS]
    for (ep, *_), a, b in zip(REQUESTS, replies["ours"], replies["theirs"]):
        assert a[0] == b[0], (ep, a[1], b[1])
        if a[0] != 200:
            assert a[1] == b[1]
            continue
        key = "embeddings" if ep == "embed" else "images"
        np.testing.assert_allclose(np.asarray(a[1][key], np.float32),
                                   np.asarray(b[1][key], np.float32), atol=FWD_ATOL)
        assert a[1]["step"] == b[1]["step"] == 0
    # request identity: X-Request-Id echoed as sent, a traceparent joined
    for a, b in zip(replies["ours"], replies["theirs"]):
        assert (a[2].get("X-Request-Id") is None) == (b[2].get("X-Request-Id") is None)
        assert a[1].get("request_id", a[2].get("X-Request-Id")) is not None
        ta, tb = a[2].get("traceparent"), b[2].get("traceparent")
        assert (ta is None) == (tb is None)
        if ta:
            assert tracing.parse_traceparent(ta) and jax_tracing.parse_traceparent(tb)
    for i in (0, 2, 4):
        rid = REQUESTS[i][3]["X-Request-Id"]
        assert replies["ours"][i][2]["X-Request-Id"] == rid == replies["theirs"][i][2][
            "X-Request-Id"]
    joined = "0af7651916cd43dd8448eb211c80319c"
    assert replies["ours"][1][1]["request_id"] == joined == replies["theirs"][1][1]["request_id"]
    assert (replies["ours"][1][2]["traceparent"].split("-")[1]
            == replies["theirs"][1][2]["traceparent"].split("-")[1] == joined)

    # the span names of each request's trace
    def traces(served):
        def probe():
            _, payload, _ = _request(served.url + "/debug/traces?since=0")
            got = {r["trace_id"]: sorted(s["name"] for s in r["spans"])
                   for r in payload["traces"] if r["root"] == "request"}
            return got if len(got) >= len(REQUESTS) else None
        return poll_until(probe) or {}

    ours_traces, theirs_traces = traces(ours), traces(theirs)
    assert ours_traces and sorted(ours_traces.values()) == sorted(theirs_traces.values())
    sent = {h["X-Request-Id"] for _, _, _, h, _ in REQUESTS if "X-Request-Id" in h}
    assert all(ours_traces[rid] == theirs_traces[rid] for rid in sent)
    assert {"request", "parse", "queue_wait", "batch_assembly", "bucket_select", "pad", "execute",
            "respond"} <= set(ours_traces["same-req-1"])

    # the serving_* families of /metrics, graph captures for XLA compiles
    def families(served):
        _, text, headers = _request(served.url + "/metrics", raw=True)
        assert headers["Content-Type"] == exporters.PROM_TEXT_CONTENT_TYPE
        return _families(text)

    ours_f, theirs_f = families(ours), families(theirs)
    assert ours_f == theirs_f
    assert "glom_serving_warmup_seconds" in ours_f and "glom_serving_errors_4xx_total" in ours_f
    assert not {"glom_serving_graph_captures_total", "glom_serving_xla_compiles_total"} & ours_f
    assert ours.engine.registry.snapshot().get("serving_graph_captures") is None
    assert theirs.engine.registry.snapshot().get("serving_xla_compiles") is None

    # OpenMetrics: exemplars and the terminator, as glom_tpu serves them
    om = {"Accept": "application/openmetrics-text; version=1.0.0"}
    for served in (ours, theirs):
        _, text, headers = _request(served.url + "/metrics", headers=om, raw=True)
        assert headers["Content-Type"] == exporters.OPENMETRICS_CONTENT_TYPE
        assert text.endswith("# EOF\n") and '# {trace_id="' in text

    # the rest of the GET routes
    for path in ("/debug/timeline", "/debug/traces?since=nope", "/nothing"):
        a, b = _request(ours.url + path), _request(theirs.url + path)
        assert a[0] == b[0] and set(a[1]) == set(b[1]), path


@pytest.mark.parametrize("mode", [["--requests", "6", "--concurrency", "2"],
                                  ["--rate", "20", "--duration", "0.3"]])
def test_loadgen_cli_drives_the_ports_server_from_its_own_process(ckpt, mode):
    """``python -m glom_tpu_torch.tools.loadgen``, in a process of its own,
    against the port's server: every request answered with its id echoed,
    and a tail of a handful of answers reported as null."""
    import subprocess
    import sys

    served = _Served(ServingEngine(ckpt, device="cpu", buckets=BUCKETS, max_wait_ms=1.0,
                                   reload_poll_s=0), server.make_server)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "glom_tpu_torch.tools.loadgen", "--url", served.url,
             "--batch-sizes", "1,3", *mode], capture_output=True, text=True, timeout=120,
            cwd=REPO,
            env={**os.environ, "PYTHONPATH": os.pathsep.join(
                p for p in (REPO, os.environ.get("PYTHONPATH")) if p)})
    finally:
        served.close()
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    assert got["requests_ok"] == 6 and got["images_ok"] == 12
    assert got["requests_error"] == got["requests_shed"] == got["request_id_mismatches"] == 0
    assert got["latency_samples"] == 6 and got["latency_ms"]["p50"] > 0
    assert got["latency_ms"]["p95"] is None and got["latency_ms"]["p99"] is None


def test_shed_and_drain_are_the_same_structured_503s(ckpt):
    bodies = {}
    for side, engine_cls, make, kw in (
            ("ours", ServingEngine, server.make_server, {"device": "cpu"}),
            ("theirs", JaxServingEngine, jax_server.make_server,
             {"warmup": False, "quality_sample": 0.0})):
        engine = engine_cls(ckpt, buckets=(1, 2), max_queue=2, reload_poll_s=0, **kw)
        served = _Served(engine, make, workers=False)   # nothing drains the queue
        try:
            engine.submit("embed", _imgs(2, 0))
            shed = _request(served.url + "/embed", {"images": _imgs(1, 1).tolist()},
                            {"X-Request-Id": "shed-1"})
            for batcher in engine.batchers.values():
                batcher.close(drain=True)
            drain = _request(served.url + "/embed", {"images": _imgs(1, 2).tolist()})
            snap = engine.registry.snapshot()
        finally:
            served.close()
        assert shed[2]["X-Request-Id"] == "shed-1"
        bodies[side] = (shed[0], shed[1], drain[0], drain[1], snap.get("serving_shed_total"),
                        snap.get("serving_errors_5xx"))
    assert bodies["ours"] == bodies["theirs"]
    assert bodies["ours"][:4] == (503, {"error": "overloaded",
                                        "detail": "queue at capacity; retry with backoff"},
                                  503, {"error": "shutting_down",
                                        "detail": "server is draining; retry elsewhere"})


@pytest.mark.parametrize("name,value", [("donate_inputs", True),
                                        ("mesh_axis_names", ("data", "model")),
                                        ("mesh_shape", (1, 4, 1)),
                                        ("param_sharding", "tp")])
def test_unported_engine_arguments_are_refused_by_name(ckpt, name, value):
    """``donate_inputs`` is not ported and is refused by name.  The mesh
    arguments are ported (``serving/sharded.py``): a value this one process
    cannot serve is refused by name as glom_tpu refuses it, a mesh larger than
    the world, ``param_sharding`` without a mesh, axis names that do not name
    the mesh's axes (tests/test_torch_sharded_serving.py serves meshes)."""
    if name == "donate_inputs":
        with pytest.raises(NotImplementedError, match=name):
            ServingEngine(ckpt, device="cpu", reload_poll_s=0, **{name: value})
    else:
        kw = {name: value}
        if name == "mesh_axis_names":
            kw["mesh_shape"] = (1, 1, 1)
        with pytest.raises(ValueError, match=name):
            ServingEngine(ckpt, device="cpu", reload_poll_s=0, **kw)
    # glom_tpu's engine takes the argument: it is a real one, not a typo
    import inspect

    assert name in inspect.signature(JaxServingEngine.__init__).parameters


def _planes(engine, has_quality_family):
    """What the capacity and quality arguments set, read the same way off
    either package's engine: the capacity plane's window, ceiling, sampling
    interval, persistence and policy, the quality sampler's fraction and its
    next 32 decisions (a copy: the engine's sampler is not advanced), and
    whether the quality post-pass exists."""
    import copy

    cap, sampler = engine.capacity, copy.deepcopy(engine.quality.sampler)
    return {"window_s": cap.accountant.window_s, "ceiling": cap.accountant.ceiling,
            "interval_s": cap.sampler.interval_s, "persist": cap.persist_windows,
            "policy": cap.advisor.policy, "fraction": sampler.fraction,
            "decisions": [sampler.decide() for _ in range(32)],
            "quality_family": has_quality_family}


@pytest.mark.parametrize("name,value", [("capacity_window_s", 5.0), ("capacity_ceiling", 100.0),
                                        ("quality_seed", 3), ("capacity_persist_windows", 2),
                                        ("capacity_interval_s", 0.5), ("quality_sample", 0.5),
                                        ("capacity_policy", "p95_ms<250")])
def test_ported_engine_arguments_have_glom_tpus_effect(ckpt, name, value):
    """Each capacity and quality argument is taken and sets the planes as
    glom_tpu's engine does (with ``quality_sample=0.5`` the quality family
    is still built, and a seed changes the sampler's decisions alike)."""
    kw = {name: value}
    if name == "quality_seed":
        kw["quality_sample"] = 0.4
    ours = ServingEngine(ckpt, device="cpu", reload_poll_s=0, warmup=False, **kw)
    theirs = JaxServingEngine(ckpt, reload_poll_s=0, warmup=False, **kw)
    try:
        got = _planes(ours, "quality" in ours.caches)
        want = _planes(theirs, theirs.quality_cache is not None)
    finally:
        ours.shutdown(drain=False)
        theirs.shutdown(drain=False)
    assert got == want
    default = _planes(ServingEngine(ckpt, device="cpu", reload_poll_s=0, warmup=False), True)
    assert got != default  # the argument is not a no-op


def test_unset_unported_arguments_and_unknown_ones(ckpt):
    engine = ServingEngine(ckpt, device="cpu", reload_poll_s=0, quant="f32", mesh_shape=None,
                           quality_sample=1.0, warmup=False)
    assert engine.step == 0
    with pytest.raises(TypeError, match="no_such_argument"):
        ServingEngine(ckpt, device="cpu", no_such_argument=1)


@pytest.mark.parametrize("flag", [["--mesh-shape", "1,4,1"],
                                  ["--param-sharding", "tp"], ["--mesh-shape", "2,1,1"],
                                  ["--no-donate"], ["--platform", "cpu"]])
def test_unported_cli_flags_are_refused_by_name(ckpt, flag, capsys):
    with pytest.raises(SystemExit) as e:
        server.main(["--checkpoint-dir", ckpt, "--device", "cpu"] + flag)
    assert e.value.code == 2 and flag[0] in capsys.readouterr().err


@pytest.mark.parametrize("how", ["argument", "flag"])
def test_bulk_dir_reaches_the_engine_and_serves_jobs(ckpt, how, tmp_path):
    """``bulk_dir`` (and ``--bulk-dir`` through ``engine_from_args``) builds
    the bulk tier over that store, as glom_tpu's engine takes it: the
    ``/admin/jobs/*`` routes answer, and ``/healthz`` carries its summary."""
    store = str(tmp_path / "jobs")
    if how == "argument":
        engine = ServingEngine(ckpt, device="cpu", reload_poll_s=0, warmup=False, bulk_dir=store)
    else:
        engine = server.engine_from_args(server.parse_args([
            "--checkpoint-dir", ckpt, "--device", "cpu", "--reload-poll-s", "0", "--no-warmup",
            "--bulk-dir", store]))
    served = _Served(engine, server.make_server, workers=False)
    try:
        payload = {"name": "j", "dataset": "synthetic:3", "transform": "embed",
                   "sink": str(tmp_path / "out")}
        code, body, _ = _request(served.url + "/admin/jobs/submit", payload)
        assert code == 200 and (body["name"], body["total"], body["status"]) == ("j", 3, "pending")
        code, body, _ = _request(served.url + "/admin/jobs/status?name=j")
        assert code == 200 and body["remaining"] == 3
        health = _request(served.url + "/healthz")[1]
        assert health["bulk"]["backlog"] == 3 and engine.bulk.store.root == store
    finally:
        served.close()
    import inspect

    assert "bulk_dir" in inspect.signature(JaxServingEngine.__init__).parameters


@pytest.mark.parametrize("flag", ["--capacity-window-s", "--capacity-policy", "--quality-sample",
                                  "--buckets-file"])
def test_ported_cli_flags_reach_the_engine(ckpt, flag, tmp_path):
    """Each flag is taken and reaches the engine as glom_tpu's server passes
    it (the value itself; ``--buckets-file`` the ladder of a
    ``--suggest-buckets`` payload, or of a plain list)."""
    ladder_file = tmp_path / "ladder.json"
    ladder_file.write_text(json.dumps({"suggested_buckets": [1, 3, 6], "observed_batches": 9}))
    value, read = {
        "--capacity-window-s": ("5", lambda e: e.capacity.accountant.window_s == 5.0),
        "--capacity-policy": ("p95_ms<250", lambda e: e.capacity.advisor.policy == "p95_ms<250"),
        "--quality-sample": ("0.5", lambda e: e.quality.sampler.fraction == 0.5
                             and "quality" in e.caches),
        "--buckets-file": (str(ladder_file), lambda e: e.buckets == (1, 3, 6)),
    }[flag]
    args = server.parse_args(["--checkpoint-dir", ckpt, "--device", "cpu", "--reload-poll-s",
                              "0", "--no-warmup", flag, value])
    engine = server.engine_from_args(args)
    try:
        assert read(engine)
    finally:
        engine.shutdown(drain=False)
    if flag == "--buckets-file":
        ladder_file.write_text("[2, 4]")
        assert server.read_buckets_file(str(ladder_file)) == (2, 4)
        ladder_file.write_text(json.dumps({"error": "no executed batches"}))
        with pytest.raises(SystemExit, match="no usable ladder"):
            server.read_buckets_file(str(ladder_file))


def test_engine_from_args_translates_every_ported_flag(ckpt, tmp_path):
    """The server's flags reach the engine through one function, the one
    ``main`` calls; an override replaces an argument."""
    args = server.parse_args([
        "--checkpoint-dir", ckpt, "--device", "cpu", "--buckets", "2,1", "--reload-poll-s",
        "0", "--no-warmup", "--quant", "int8", "--warm-iters", "auto", "--session-ttl-s", "30",
        "--session-max-mb", "0.5", "--session-spill-dir", str(tmp_path / "spill"),
        "--tenant-quota", "a=2:4", "--tenant-quota", "b=1", "--parse-thresholds",
        "0.1,0.2,0.3", "--index-dir", str(tmp_path / "index"), "--model", f"alt={ckpt}",
        "--deploy-promote-after", "2", "--deploy-window-s", "1.5", "--deploy-min-events", "4",
        "--deploy-canary-fraction", "0.25", "--deploy-pin-url", "http://127.0.0.1:9/"])
    engine = server.engine_from_args(args, max_queue=7)
    try:
        health = engine.health()
        assert engine.buckets == (1, 2) and not health["warm"]
        assert engine.batchers["embed"].max_queue == 7
        assert health["quant"] == "int8" and health["device"] == "cpu"
        assert health["sessions"]["warm_iters"] == health["sessions"]["cold_iters"] // 2
        assert (engine.sessions.ttl_s, engine.sessions.max_bytes) == (30.0, 2 ** 19)
        assert engine._session_spill_dir == str(tmp_path / "spill")
        assert {t: (q["rate"], q["burst"]) for t, q in health["tenants"].items()} == {
            "a": (2.0, 4.0), "b": (1.0, 1.0)}
        assert health["hierarchy"]["parse_thresholds"] == [0.1, 0.2, 0.3]
        assert engine.index_dir == str(tmp_path / "index")
        assert health["models"]["models"] == ["alt", "default"]
        assert {k: health["deploy"][k] for k in ("promote_after", "window_s", "min_events",
                                                 "pin_url")} == {
            "promote_after": 2, "window_s": 1.5, "min_events": 4,
            "pin_url": "http://127.0.0.1:9"}
        assert engine.deploy.default_fraction == 0.25
    finally:
        engine.shutdown(drain=False)


def test_refused_flags_give_the_engine_arguments_reasons():
    """A flag with an engine argument behind it is refused for the reason
    ``UNPORTED`` gives that argument, and every refused flag is one of
    glom_tpu's CLI."""
    from glom_tpu_torch.serving.engine import UNPORTED

    table = server.refused_flags()
    for flag, (_, name) in server._REFUSED.items():
        assert table[flag][1] == UNPORTED[name][1]
    import inspect

    jax_cli = inspect.getsource(jax_server.main)
    assert all(f'"{flag}"' in jax_cli for flag in table)
