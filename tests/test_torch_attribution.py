"""The port's regression attribution (glom_tpu_torch/obs/attribution.py and
tools/whyslow.py) against glom_tpu's on the CPU.

The module is a copy, so the contract is equality: the same evidence dicts
(built with numpy from a seed: step and drift knees, events of every plane
around them, counter resets, compile snapshots that move or do not) give
byte-identical ``canonical_json`` verdicts in both packages, and so do the
parts (knee, phase deltas, event scores, snapshot diffs, the text render).
The golden fixture of tests/data/attribution reproduces byte for byte, the
report comparison is glom_tpu's, evidence collected from a port engine
attributes alike in both, and ``whyslow --smoke --device cpu`` names the
induced canary with no capture.  A port engine's graph caches record a
snapshot of each bucket at its capture; a deploy candidate's graphs come
from the primary's program (the same quant, buckets and cost), so under a
canary the op-diff plane is None.
"""

import importlib.util
import json
import os
import random

import numpy as np
import pytest
import torch

from glom_tpu.obs import attribution as jax_attribution
from glom_tpu_torch.obs import attribution
from glom_tpu_torch.obs.events import BULK_EVENTS, DEPLOY_EVENTS, FLEET_EVENTS
from glom_tpu_torch.obs.tracing import SPAN_REQUEST
from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
from glom_tpu_torch.tools import whyslow

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(ROOT, "tests", "data", "attribution")
PHASES = ("request", "parse", "queue_wait", "batch_assembly", "pad", "execute", "respond")
EVENTS = sorted(DEPLOY_EVENTS | BULK_EVENTS | FLEET_EVENTS) + [
    "capacity_recommendation", "reload", "queue_saturation"]


def _jax_whyslow():
    """glom_tpu's tools/whyslow.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "_jax_whyslow", os.path.join(ROOT, "tools", "whyslow.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _series(rng, n, knee, kind):
    """Counter series of every phase (and two buckets' execute) whose per
    request means step or drift at ``knee``; one phase in three moves."""
    series = {}
    moved = set(rng.choice(PHASES[1:], size=2, replace=False))
    for phase in PHASES + ("execute_b2", "execute_b8"):
        base = f"serving_{phase}_ms" if not phase.startswith("execute_b") else \
            f"serving_execute_ms_b{phase[9:]}"
        before = float(rng.uniform(0.5, 20.0))
        jump = float(rng.uniform(5.0, 60.0)) if (phase in moved or phase == "request") else 0.0
        tot_s = tot_c = 0.0
        s, c = [], []
        for i in range(n):
            rate = int(rng.integers(5, 15))
            if kind == "step":
                mean = before + (jump if i >= knee else 0.0)
            else:
                mean = before + max(0, i - knee) * jump / n
            tot_c += rate
            tot_s += rate * mean
            s.append([float(i), round(tot_s, 6)])
            c.append([float(i), float(tot_c)])
        series[base + "_sum"], series[base + "_count"] = s, c
    return series


def _evidence(seed):
    """One seeded evidence dict: a step or a drift at a random knee (or a
    flat series), events of random kinds around it, and on some seeds a
    counter reset, a given knee, or compile snapshots."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(12, 40))
    kind = ("step", "drift", "flat")[seed % 3]
    knee = int(rng.integers(4, n - 3))
    series = _series(rng, n, knee, kind)
    if kind == "flat":
        series = {k: [[t, round(v * 0 + (i + 1) * 10.0, 6)] for i, (t, v) in enumerate(pts)]
                  for k, pts in series.items()}
    if seed % 4 == 3:   # a process restart: one phase's counters go backward
        pts = series["serving_execute_ms_sum"]
        series["serving_execute_ms_sum"] = pts[:n // 2] + [[t, v / 10] for t, v in pts[n // 2:]]
    timeline = []
    for i in range(int(rng.integers(0, 6))):
        ev = {"seq": i, "t": round(float(knee + rng.normal(0, 3)), 3),
              "event": str(rng.choice(EVENTS))}
        if rng.random() < 0.6:
            ev["step"] = int(rng.integers(1, 5))
        if rng.random() < 0.3:
            ev["fraction"] = round(float(rng.random()), 2)
        timeline.append(ev)
    evidence = {"series": series, "timeline": timeline}
    if seed % 2:
        evidence["window"] = {"start": 0.0, "end": float(n - 1)}
        if seed % 5 == 1:
            evidence["window"]["knee"] = float(knee)
    if seed % 3 == 1:
        def snaps(quant, flops, buckets, fusions):
            return {str(b): {"quant": quant, "cost_analysis": {
                "flops": flops * b, "bytes accessed": 10.0 * b}, "hlo": "fusion " * fusions}
                for b in buckets}
        evidence["snapshots"] = {
            "before": snaps("f32", 100.0, (1, 2, 8), 3),
            "after": snaps(str(rng.choice(["f32", "bf16"])), float(rng.choice([100.0, 140.0])),
                           (1, 2, 8) if rng.random() < 0.5 else (1, 4, 8),
                           int(rng.integers(3, 5)))}
    return evidence


@pytest.mark.parametrize("seed", range(18))
def test_the_verdict_is_glom_tpus_byte_for_byte(seed):
    evidence = _evidence(seed)
    ours = attribution.canonical_json(attribution.attribute(json.loads(json.dumps(evidence))))
    theirs = jax_attribution.canonical_json(jax_attribution.attribute(evidence))
    assert ours == theirs
    # and the text render
    assert attribution.render_text(json.loads(ours)) == jax_attribution.render_text(
        json.loads(theirs))


def test_the_seeds_reach_every_verdict_kind():
    """The seeded evidence is not all one case: named verdicts of several
    kinds, honest inconclusives, and op diffs all occur."""
    kinds, op_diffs, inconclusive = set(), 0, 0
    for seed in range(18):
        v = attribution.attribute(_evidence(seed))
        kinds |= {c["kind"] for c in v["causes"]}
        op_diffs += v["op_diff"] is not None
        inconclusive += v["verdict"] == "inconclusive"
    assert {"event:deploy", "op_diff"} <= kinds and len(kinds) >= 3
    assert op_diffs >= 3 and inconclusive >= 3


@pytest.mark.parametrize("seed", range(6))
def test_the_parts_are_glom_tpus(seed):
    evidence = _evidence(seed)
    series = evidence["series"]
    for mod in (attribution, jax_attribution):
        assert mod.is_phase_scalar("serving_execute_ms_b4_count")
    lat = attribution.latency_series(series)
    assert lat == jax_attribution.latency_series(series)
    assert attribution.find_knee(lat) == jax_attribution.find_knee(lat)
    t0, t1 = lat[0][0], lat[-1][0]
    tk = (t0 + t1) / 2
    assert attribution.phase_deltas(series, t0, tk, t1) == jax_attribution.phase_deltas(
        series, t0, tk, t1)
    assert attribution.score_events(evidence["timeline"], t0, tk, t1, resolution_s=1.0) == \
        jax_attribution.score_events(evidence["timeline"], t0, tk, t1, resolution_s=1.0)
    snaps = evidence.get("snapshots") or {}
    assert attribution.diff_snapshots(snaps.get("before"), snaps.get("after")) == \
        jax_attribution.diff_snapshots(snaps.get("before"), snaps.get("after"))
    before = {k: v[len(v) // 3][1] for k, v in series.items()}
    after = {k: v[-1][1] for k, v in series.items()}
    assert attribution.snapshot_phase_deltas(before, after) == \
        jax_attribution.snapshot_phase_deltas(before, after)


def test_golden_fixture_byte_stable_and_order_free():
    with open(os.path.join(FIXTURE_DIR, "evidence.json")) as f:
        evidence = json.load(f)
    with open(os.path.join(FIXTURE_DIR, "golden_verdict.json")) as f:
        golden = f.read()
    assert attribution.canonical_json(attribution.attribute(evidence)) == golden
    rnd = random.Random(99)
    for _ in range(3):
        shuffled = json.loads(json.dumps(evidence))
        rnd.shuffle(shuffled["timeline"])
        keys = list(shuffled["series"])
        rnd.shuffle(keys)
        shuffled["series"] = {k: shuffled["series"][k] for k in keys}
        assert attribution.canonical_json(attribution.attribute(shuffled)) == golden


def test_the_cli_renders_recorded_evidence_as_glom_tpus(tmp_path, capsys):
    path = os.path.join(FIXTURE_DIR, "evidence.json")
    outs = []
    for main in (whyslow.main, _jax_whyslow().main):
        out = tmp_path / f"{len(outs)}.json"
        assert main(["--evidence", path, "--out", str(out)]) == 0
        outs.append((capsys.readouterr().out, out.read_text()))
    assert outs[0] == outs[1]
    assert outs[0][0].startswith("verdict: deploy event 'deploy_canary'")


@pytest.mark.parametrize("p95", [(100.0, 160.0), (100.0, 101.0)])
def test_compare_reports_is_glom_tpus(p95):
    before = {"latency_ms": {"p50": 40.0, "p95": p95[0]}, "throughput_req_per_s": 12.0}
    windows = [{"t_s": float(i), "p95_ms": p95[0] if i < 6 else p95[1]} for i in range(12)]
    after = {"latency_ms": {"p50": 55.0, "p95": p95[1]}, "throughput_req_per_s": 9.5,
             "timeline": {"windows": windows}, "regress": {"at_s": 6.0}}
    got = whyslow.compare_reports(before, after)
    assert got == _jax_whyslow().compare_reports(before, after)
    assert (got["verdict"] == "inconclusive") == (p95[1] - p95[0] <= 2.0)


def test_engine_evidence_from_a_port_engine(tmp_path):
    """collect_engine_evidence on a port engine under a canary (requests
    traced as the server traces them, ten times slower after it): the series
    store's serving_ and capacity_ series, the engine timeline (the
    deploy_canary event), the primary's and the candidate's graph snapshots
    (equal: one program, so the op-diff plane is None), and the same verdict
    from glom_tpu's attribute on the same evidence."""
    ckpt = str(tmp_path / "ckpt")
    make_demo_checkpoint(ckpt)
    t = [100.0]
    engine = ServingEngine(ckpt, device="cpu", buckets=(1, 2), reload_poll_s=0,
                           max_wait_ms=0.0, capacity_interval_s=0.25, clock=lambda: t[0])
    try:
        x = np.zeros((1, 3, 16, 16), np.float32)
        for i in range(12):
            root = engine.tracer.start_trace(SPAN_REQUEST, attrs={"endpoint": "embed"})
            fut = engine.submit("embed", x, ctx=root)
            engine.process_once("embed", block=False)
            fut.result(timeout=10)
            t[0] += 0.01 * (1 + 5 * (i > 5))
            engine.tracer.end(root)
            t[0] += 1.0
            engine.capacity.tick()
            if i == 5:
                make_demo_checkpoint(ckpt, seed=1, step=2)
                assert engine.deploy.begin_canary(step=2, fraction=1.0) == 2
        evidence = attribution.collect_engine_evidence(engine, since_s=30.0)
    finally:
        engine.shutdown(drain=False)
    snaps = evidence["snapshots"]
    assert sorted(snaps["before"]) == [1, 2] and snaps["after"] == snaps["before"]
    assert evidence["window"]["end"] - evidence["window"]["start"] == 30.0
    assert any(k.startswith("serving_request_ms") for k in evidence["series"])
    assert any(k.startswith("capacity_") for k in evidence["series"])
    assert all(k.startswith(("serving_", "capacity_")) for k in evidence["series"])
    assert [e["event"] for e in evidence["timeline"]].count("deploy_canary") == 1
    ours = attribution.attribute(json.loads(json.dumps(evidence)))
    assert ours["op_diff"] is None and ours["knee"]["kind"] == "step"
    assert ours["verdict"].startswith("deploy event 'deploy_canary' (step 2)")
    assert attribution.canonical_json(ours) == jax_attribution.canonical_json(
        jax_attribution.attribute(json.loads(json.dumps(evidence))))


def test_whyslow_smoke_on_the_cpu(capsys):
    """python -m glom_tpu_torch.tools.whyslow --smoke --device cpu: one
    cause, the deploy_canary event at its step, queue_wait the majority
    phase, no capture, the op-diff plane None, a byte-stable verdict."""
    assert whyslow.main(["--smoke", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["smoke"] == "ok" and all(report["checks"].values()), report["checks"]
    cause = report["verdict"]["causes"][0]
    assert cause["event"]["event"] == "deploy_canary" and cause["event"]["step"] == 2


def test_whyslow_needs_a_mode(capsys):
    assert whyslow.main([]) == 1
    assert whyslow.main(["--before", "x.json"]) == 1
    err = capsys.readouterr().err
    assert "need one of" in err and "go together" in err
