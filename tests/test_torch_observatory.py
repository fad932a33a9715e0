"""The port's fleet observatory (``glom_tpu_torch/obs/observatory.py``,
``obs/forensics.py``, ``tools/observatory.py``) against ``glom_tpu``'s on the
CPU.

``stitch``, ``critical_path``, the coverage over the hop, the tail sampler's
seeded decisions, ``parse_exemplars`` and the registry's cardinality guard
equal the reference's on ``tests/test_observatory.py``'s fixtures; a
collector of each package over one scripted fake fleet writes the same
incident bundles (apart from their paths) and the same console, and the
port's ``report`` renders a bundle as ``tools/observatory.py`` does.  The
port engine's ``/debug/forensics`` has ``glom_tpu``'s payload for an engine
with no forensics directory.  Then the tools as a user runs them, on the
CPU: ``python -m glom_tpu_torch.tools.observatory --smoke`` and ``python -m
glom_tpu_torch.tools.loadgen --smoke --fleet``; these check the stitched
trace's spans and parent links and the exit code, never a share of wall time
(the coverage gate runs on the card, ``chip_smoke.py``'s ``fleet`` phase).
"""

import importlib.util
import json
import os
import random
import subprocess
import sys
import urllib.request
import warnings

import pytest
import torch

from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.obs import observatory as ours
from glom_tpu_torch.obs import registry as our_registry
from glom_tpu_torch.obs import tracing as our_tracing
from glom_tpu_torch.obs.forensics import MANIFEST, is_bundle_dir, write_bundle
from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
from glom_tpu_torch.serving.server import make_server
from glom_tpu_torch.tools import observatory as our_cli
from glom_tpu_torch.tools import trace_report

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = GlomConfig(dim=32, levels=3, image_size=16, patch_size=4)
TOOL_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def theirs():
    from glom_tpu.obs import observatory

    return observatory


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.pop(0)
    return mod


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, seconds):
        self.t += seconds


# ---------------------------------------------------------------------------
# tests/test_observatory.py's segments: router epoch ~1000 s, engine ~5 s
# ---------------------------------------------------------------------------
def _router_segment(tid="t1", start=1000.0, proxies=1):
    spans = [{"name": "router_request", "trace_id": tid, "span_id": "r1", "parent_id": None,
              "start": start, "end": start + 0.100, "duration_ms": 100.0, "root_span": True},
             {"name": "route", "trace_id": tid, "span_id": "r2", "parent_id": "r1",
              "start": start, "end": start + 0.001, "duration_ms": 1.0}]
    for i in range(proxies):
        # a failed first attempt, then the one that answered
        a = start + 0.001 + 0.01 * i
        spans.append({"name": "proxy", "trace_id": tid, "span_id": f"r{3 + i}",
                      "parent_id": "r1", "start": a, "end": start + 0.099 if i == proxies - 1
                      else a + 0.009, "duration_ms": 98.0 - 10 * i,
                      "attrs": {"replica": f"r{i}"} if i == proxies - 1
                      else {"replica": f"r{i}", "error": "refused"}})
    return {"trace_id": tid, "root": "router_request", "duration_ms": 100.0, "spans": spans}


def _engine_segment(tid="t1", start=5.0, parent="r3"):
    return {"trace_id": tid, "root": "request", "duration_ms": 96.0, "spans": [
        {"name": "request", "trace_id": tid, "span_id": "e1", "parent_id": parent,
         "start": start, "end": start + 0.096, "duration_ms": 96.0, "root_span": True},
        {"name": "queue_wait", "trace_id": tid, "span_id": "e3", "parent_id": "e1",
         "start": start + 0.004, "end": start + 0.030, "duration_ms": 26.0},
        {"name": "execute", "trace_id": tid, "span_id": "e4", "parent_id": "e1",
         "start": start + 0.030, "end": start + 0.090, "duration_ms": 60.0,
         "attrs": {"bucket": 4, "images": 3, "padding_waste": 0.25}},
        {"name": "respond", "trace_id": tid, "span_id": "e5", "parent_id": "e1",
         "start": start + 0.090, "end": start + 0.096, "duration_ms": 6.0},
        {"name": "parse", "trace_id": tid, "span_id": "e2", "parent_id": "e1",
         "start": start, "end": start + 0.004, "duration_ms": 4.0}]}


def _no_proxy(seg):
    seg["spans"] = [s for s in seg["spans"] if s["name"] != "proxy"]
    return seg


STITCH_CASES = {
    "join": lambda: [("router", _router_segment()), ("replica0", _engine_segment())],
    "engine_first": lambda: [("replica0", _engine_segment()), ("router", _router_segment())],
    "engine_only": lambda: [("replica0", _engine_segment(parent=None))],
    "unanchored": lambda: [("router", _no_proxy(_router_segment())),
                           ("replica0", _engine_segment())],
    "fail_over": lambda: [("router", _router_segment(proxies=2)),
                          ("replica1", _engine_segment(parent="r4", start=77.0))],
    # a replica segment longer than its proxy span: clamped inside it
    "lopsided": lambda: [("router", _router_segment()), ("replica0", _longer_request())],
}


def _longer_request():
    seg = _engine_segment()
    for s in seg["spans"]:
        if s["name"] == "request":
            s["end"] += 0.5
    return seg


@pytest.mark.parametrize("case", sorted(STITCH_CASES))
def test_stitch_and_critical_path_equal_glom_tpus(theirs, case):
    mine, ref = ours.stitch(STITCH_CASES[case]()), theirs.stitch(STITCH_CASES[case]())
    assert mine == ref and mine is not None
    assert ours.critical_path(mine["spans"]) == theirs.critical_path(ref["spans"])
    from glom_tpu.obs import tracing as their_tracing

    assert (our_tracing.span_coverage(mine["spans"])
            == their_tracing.span_coverage(ref["spans"]) == mine["span_coverage"])
    if case == "join":
        by_name = {s["name"]: s for s in mine["spans"]}
        assert by_name["proxy"]["start"] <= by_name["request"]["start"]
        assert by_name["request"]["end"] <= by_name["proxy"]["end"]
        assert mine["span_coverage"] >= 0.95 and mine["stitched"]
        links = our_cli.hop_links(mine["spans"])
        assert links["root_is_outermost"] and links["proxy_under_root"]
        assert links["request_under_proxy"]
    if case == "unanchored":
        assert mine["clock_offset_ms"]["replica0"] is None and mine["span_coverage"] < 0.05


def _stream(seed, n=400):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        u = rng.random()
        spans = []
        if u < 0.03:
            spans = [{"name": "request", "attrs": {"status": 503}}]
        elif u < 0.05:
            spans = [{"name": "proxy", "attrs": {"error": "refused"}}]
        ms = rng.lognormvariate(2.0, 0.5) * (20 if u > 0.98 else 1)
        out.append({"trace_id": f"x{i}", "duration_ms": ms, "spans": spans})
    return out


@pytest.mark.parametrize("seed,fraction,slo_ms", [(0, 0.1, None), (1, 0.0, 40.0),
                                                  (2, 0.25, 15.0), (7, 1.0, None)])
def test_tail_sampler_decisions_equal_glom_tpus(theirs, seed, fraction, slo_ms):
    a = ours.TailSampler(fraction, seed=seed, slo_ms=slo_ms, clock=FakeClock())
    b = theirs.TailSampler(fraction, seed=seed, slo_ms=slo_ms, clock=FakeClock())
    stream = _stream(seed)
    assert [a.decide(t) for t in stream] == [b.decide(t) for t in stream]
    assert a.stats() == b.stats()
    with pytest.raises(ValueError):
        ours.TailSampler(1.5)


def test_parse_exemplars_and_cardinality_guard_equal_glom_tpus(theirs):
    from glom_tpu.obs import exporters as their_exporters
    from glom_tpu.obs import registry as their_registry

    from glom_tpu_torch.obs import exporters as our_exporters

    texts = []
    for reg_mod, exp_mod in ((our_registry, our_exporters),
                             (their_registry, their_exporters)):
        reg = reg_mod.MetricRegistry(max_label_values=4)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            names = [reg.labeled("fam_", i) for i in range(10)]
        h = reg.histogram("router_request_ms", unit="ms")
        for i, v in enumerate((0.4, 3.0, 30.0, 300.0)):
            h.observe(v, exemplar=f"{i:032x}")
        texts.append((names, reg.snapshot(), len([w for w in caught if "fam_" in str(w.message)]),
                      exp_mod.prometheus_lines(reg, exemplars=True)))
    assert texts[0] == texts[1]
    names, snap, warned, text = texts[0]
    assert names[4:] == ["fam___other__"] * 6 and warned == 1
    assert snap["registry_cardinality_overflows_total"] == 6.0
    assert ours.parse_exemplars(text) == theirs.parse_exemplars(text)
    assert len(ours.parse_exemplars(text)) == 4


# ---------------------------------------------------------------------------
# a collector of each package over one scripted fake fleet
# ---------------------------------------------------------------------------
class FakeFleetHTTP:
    """Canned /healthz + /debug/* sources behind the injected http fn
    (``tests/test_observatory.py``'s)."""

    def __init__(self):
        self.router_health = {
            "status": "ok", "role": "router", "healthy_replicas": 2, "fleet_step": 3,
            "rollout_phase": "idle", "replicas": [
                {"name": "r0", "url": "http://fleet/r0", "healthy": True, "step": 3,
                 "inflight": 0, "requests": 10, "errors": 0},
                {"name": "r1", "url": "http://fleet/r1", "healthy": True, "step": 3,
                 "inflight": 0, "requests": 10, "errors": 0}]}
        self.traces = {"http://fleet/router": [], "http://fleet/r0": [], "http://fleet/r1": []}
        self.timeline = []
        self.bundles = {"r0": [], "r1": []}

    def __call__(self, method, url, body, headers, timeout):
        base, _, rest = url.partition("/debug/")
        if url.endswith("/healthz"):
            return 200, {}, json.dumps(self.router_health).encode()
        if rest.startswith("traces"):
            recs = self.traces.get(base, [])
            return 200, {}, json.dumps({"next": len(recs), "traces": recs}).encode()
        if rest == "timeline":
            return 200, {}, json.dumps({"events": self.timeline}).encode()
        if rest == "forensics":
            name = base.rsplit("/", 1)[-1]
            return 200, {}, json.dumps({
                "role": "engine", "step": 3, "bundles": self.bundles.get(name, []),
                "registry": {"serving_requests_total": 10.0,
                             "slo_burn_rate_embed_p95_250ms": 14.0,
                             "capacity_duty_cycle": 0.25, "quality_drift": 0.1},
                "slo_fired": []}).encode()
        return 404, {}, b"{}"


def _collectors(theirs, tmp_path):
    out = []
    for name, mod in (("ours", ours), ("theirs", theirs)):
        fleet = FakeFleetHTTP()
        obs = mod.FleetObservatory(
            "http://fleet/router", http=fleet, clock=FakeClock(), wall_clock=FakeClock(1.7e9),
            sampler=mod.TailSampler(1.0, seed=0, clock=FakeClock()),
            incident_dir=str(tmp_path / name), linger_polls=1)
        out.append((obs, fleet, str(tmp_path / name)))
    return out


def _bundle_files(root):
    out = {}
    for bundle in sorted(os.listdir(root)):
        path = os.path.join(root, bundle)
        for f in sorted(os.listdir(path)):
            with open(os.path.join(path, f)) as fh:
                out[(bundle, f)] = fh.read().replace(root, "<incidents>")
    return out


def test_collectors_write_the_same_incident_bundles_and_console(theirs, tmp_path):
    """Stitched traces across poll rounds, a slo_burn bundle on both
    replicas (one incident), an ejection on the router's timeline (a
    second): the same bundles, file for file, and the same console."""
    runs = []
    for obs, fleet, root in _collectors(theirs, tmp_path):
        obs.poll_once()                       # attach: absorbs what exists
        fleet.traces["http://fleet/r0"].append(_engine_segment())
        obs.poll_once()
        fleet.traces["http://fleet/router"].append(_router_segment())
        obs.poll_once()
        burn = {"name": "slo_burn-40", "manifest": {
            "trigger": "slo_burn", "step": 40,
            "detail": {"slo": "embed:p95<250ms", "trace_ids": ["t1"]}}}
        fleet.bundles["r0"].append(burn)
        fleet.bundles["r1"].append(dict(burn, name="slo_burn-41"))
        obs.poll_once()
        fleet.timeline.append({"seq": 0, "t": 12.0, "event": "ejection", "replica": "r1",
                               "fail_streak": 2})
        obs.poll_once()
        con = json.loads(json.dumps(obs.console()).replace(root, "<incidents>"))
        runs.append((_bundle_files(root), con, obs.registry.snapshot(),
                     [os.path.relpath(p, root) for p in obs.incidents]))
    assert runs[0] == runs[1]
    files, con, snap, incidents = runs[0]
    assert incidents == ["incident-slo_burn-4", "incident-replica_ejection-5"]
    assert snap["observatory_incidents_total"] == 2.0
    assert snap["observatory_incidents_deduped_total"] == 1.0
    assert con["slowest_traces"][0]["trace_id"] == "t1"
    assert con["padding_waste"]["4"]["batches"] == 1
    assert {f for _, f in files} == {"manifest.json", "timeline.json", "traces.json",
                                     "console.json", "replica_r0.json", "replica_r1.json"}


def test_report_renders_a_bundle_as_tools_observatory_does(theirs, tmp_path, capsys):
    (obs, fleet, root), _ = _collectors(theirs, tmp_path)
    obs.poll_once()
    fleet.timeline.append({"seq": 0, "t": 12.0, "event": "ejection", "replica": "r1",
                           "fail_streak": 2})
    obs.poll_once()
    bundle = obs.incidents[0]
    assert is_bundle_dir(bundle)
    cli = _tool("observatory")
    assert our_cli.render_report(bundle) == cli.render_report(bundle)
    our_cli.print_report(our_cli.render_report(bundle))
    mine = capsys.readouterr().out
    cli.print_report(cli.render_report(bundle))
    assert mine == capsys.readouterr().out and "incident: replica_ejection" in mine
    con = obs.console()
    assert our_cli.render_console(con) == cli.render_console(con)
    assert our_cli.main(["report", bundle, "--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out)["manifest"]["trigger"] == "replica_ejection"


def test_write_bundle_is_atomic_and_read_by_glom_tpu(tmp_path):
    from glom_tpu.obs import forensics as their_forensics

    path = write_bundle(str(tmp_path), "b", {MANIFEST: {"trigger": "x"}, "n.txt": "hi",
                                             "raw.bin": b"\x00\x01"})
    again = write_bundle(str(tmp_path), "b", {MANIFEST: {"trigger": "y"}})
    assert os.path.basename(again) == "b-2"
    assert is_bundle_dir(path) and their_forensics.is_bundle_dir(path)
    with open(os.path.join(path, MANIFEST)) as f:
        assert json.load(f) == {"trigger": "x"}
    os.makedirs(tmp_path / ".tmp-c-1")
    assert not is_bundle_dir(str(tmp_path / ".tmp-c-1"))
    with pytest.raises(TypeError):      # a content neither text, bytes nor JSON
        write_bundle(str(tmp_path), "d", {"x": 3})
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".tmp-d")]


# ---------------------------------------------------------------------------
# /debug/forensics
# ---------------------------------------------------------------------------
def test_debug_forensics_has_glom_tpus_payload_without_a_forensics_dir(tmp_path):
    from glom_tpu.serving.engine import ServingEngine as TheirEngine

    make_demo_checkpoint(str(tmp_path), config=TINY, seed=4)
    mine = ServingEngine(str(tmp_path), device="cpu", buckets=(1,), reload_poll_s=0,
                         slos=["embed:p95<250ms"])
    ref = TheirEngine(str(tmp_path), buckets=(1,), reload_poll_s=0, warmup=False,
                      slos=["embed:p95<250ms"])
    a, b = mine.debug_forensics(), ref.debug_forensics()
    assert sorted(a) == sorted(b) == ["bundles", "registry", "role", "slo_fired", "step"]
    assert (a["role"], a["step"], a["bundles"], a["slo_fired"]) == (
        b["role"], b["step"], b["bundles"], b["slo_fired"]) == ("engine", 0, [], [])
    assert all(isinstance(v, float) for v in a["registry"].values())
    srv = make_server(mine)
    import threading

    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = "http://{}:{}/debug/forensics".format(*srv.server_address[:2])
        with urllib.request.urlopen(url, timeout=30) as r:
            payload = json.loads(r.read())
        assert sorted(payload) == sorted(a) and payload["bundles"] == []
    finally:
        srv.shutdown()
        srv.server_close()
        mine.shutdown(drain=False)
        ref.shutdown(drain=False)


# ---------------------------------------------------------------------------
# trace_report over several feeds
# ---------------------------------------------------------------------------
def test_trace_report_joins_feeds_as_glom_tpus(tmp_path):
    tr = _tool("trace_report")
    router_log, replica_log = tmp_path / "router.jsonl", tmp_path / "replica0.jsonl"
    router_log.write_text(json.dumps(_router_segment()) + "\n")
    solo = _engine_segment(tid="solo", start=9.0, parent=None)
    replica_log.write_text(json.dumps(_engine_segment()) + "\n" + json.dumps(solo) + "\n")
    a, b = tmp_path / "ra.jsonl", tmp_path / "rb.jsonl"
    a.write_text(json.dumps(_engine_segment(tid="a1", parent=None)) + "\n")
    b.write_text(json.dumps(_engine_segment(tid="b1", parent=None)) + "\n")
    for feeds in ([router_log, replica_log], [a, b]):
        feeds = [str(f) for f in feeds]
        mine, ref = trace_report.read_many(feeds), tr.read_many(feeds)
        assert mine == ref
        assert trace_report.summarize(mine) == tr.summarize(ref)
    joined = next(t for t in trace_report.read_many([str(router_log), str(replica_log)])
                  if t["trace_id"] == "t1")
    assert joined["stitched"] and trace_report.coverage(joined["spans"]) >= 0.95
    # two replicas' clocks are independent: the same (bucket, start) in two
    # files are two batches
    assert trace_report.summarize(trace_report.read_many([str(a), str(b)]))[
        "buckets"][0]["batches"] == 2


# ---------------------------------------------------------------------------
# the tools as a user runs them
# ---------------------------------------------------------------------------
def _run(*argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-m", *argv], capture_output=True, text=True,
                          timeout=TOOL_TIMEOUT_S, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout)


def test_observatory_smoke_on_the_cpu():
    out = _run("glom_tpu_torch.tools.observatory", "--smoke", "--device", "cpu",
               "--min-coverage", "0")
    assert out["smoke"] == "ok" and out["device"] == "cpu"
    assert out["hop_links"]["root_is_outermost"] and out["hop_links"]["proxy_under_root"]
    assert out["hop_links"]["request_under_proxy"]
    assert out["incident_trigger"] == "replica_ejection" and len(out["incidents"]) == 1
    assert out["replica_evidence_files"] == ["replica_r0.json"]
    assert [(r["name"], r["healthy"]) for r in out["console_replicas"]] == [
        ("r0", True), ("r1", False)]


def test_loadgen_fleet_smoke_on_the_cpu():
    out = _run("glom_tpu_torch.tools.loadgen", "--smoke", "--fleet", "--device", "cpu",
               "--min-coverage", "0")
    assert out["smoke"] == "ok" and out["smoke_mode"] == "fleet-stitched"
    assert {"router_request", "route", "proxy", "request", "queue_wait", "execute",
            "respond"} <= set(out["trace_span_names"])
    assert out["checks"]["hop_links"] and out["hop_links"]["requests"] == 1
    assert out["requests_ok"] == 1 and out["request_id_mismatches"] == 0
    assert out["parse_router"]["graph_captures"] == 0
