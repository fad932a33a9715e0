"""The port's forensics (glom_tpu_torch.obs.forensics, the engine's bundles,
the report tools and the device guard) against glom_tpu's, on the CPU.

The same records under the same fake clocks give the same flight-recorder
ring and JSONL; a bundle has the reference's files and manifest, apart
from ``env.json`` (the port names torch, CUDA and the card) and the
snapshot files (``kernels.json`` in place of ``hlo.txt``); the trace
window and the faulthandler behave as the reference's; a failed capture
gives its budget slot back.  Each package's reports read the other's
bundles and JSONL.  A port engine writes its warm-up bundles and the
``slo_burn``, ``deploy_rollback`` and ``ckpt_corrupt`` bundles, lists them
on ``/debug/forensics`` in ``glom_tpu``'s payload, and its graph snapshots
give the attribution plane an op-diff over a quant change.
"""

import faulthandler
import importlib.util
import io
import json
import os
import subprocess
import sys
import threading
import urllib.request

import pytest
import torch

from glom_tpu.obs import forensics as jax_forensics
from glom_tpu.obs.registry import MetricRegistry as JaxRegistry
from glom_tpu_torch import device_guard
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.obs import MetricRegistry, attribution, forensics
from glom_tpu_torch.obs.slo import parse_slo
from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
from glom_tpu_torch.serving.server import make_server
from glom_tpu_torch.tools import forensics_report, obs_report
from glom_tpu_torch.training.data import synthetic_batches
from glom_tpu_torch.training.metrics import MetricLogger
from glom_tpu_torch.training.trainer import Trainer

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = GlomConfig(dim=32, levels=3, image_size=16, patch_size=4)
SNAPSHOT_FILES = {"kernels.json", "hlo.txt", "cost_analysis.json", "memory_analysis.json"}


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, seconds):
        self.t += seconds


def _records():
    return [(2, {"loss": 0.123456789, "event": "resume", "n": 3}),
            (4, {"imgs_per_sec": 12.5, "t_step": 0.25, "window_steps": 2}),
            (6, {"weird": object()})]


def test_flight_recorder_ring_and_jsonl_equal_glom_tpus():
    rings = []
    for mod in (forensics, jax_forensics):
        clock = FakeClock()
        rec = mod.FlightRecorder(capacity=2, clock=clock)
        for step, scalars in _records():
            clock.advance(1.5)
            rec.record(step, scalars)
        snap = rec.snapshot()
        snap[-1]["weird"] = snap[-1]["weird"][:8]   # a repr, address aside
        rings.append((snap, rec.recorded, rec.to_jsonl().count("\n")))
    assert rings[0] == rings[1]
    assert rings[0][1] == 3 and len(rings[0][0]) == 2
    with pytest.raises(ValueError):
        forensics.FlightRecorder(capacity=0)


def _manager(mod, root, clock, registry, **kw):
    rec = mod.FlightRecorder(capacity=8, clock=clock)
    for step, scalars in _records()[:2]:
        rec.record(step, scalars)
    registry.counter("steps_total").inc(4)
    return mod.ForensicsManager(str(root), recorder=rec, config={"glom": {"dim": 32}},
                                registry=registry, clock=clock, **kw)


def _read_bundle(path):
    files = {}
    for name in sorted(os.listdir(path)):
        if os.path.isfile(os.path.join(path, name)):
            with open(os.path.join(path, name)) as f:
                files[name] = f.read()
    return files


def test_a_bundle_has_glom_tpus_files_and_manifest(tmp_path):
    snap = {"cost_analysis": {"flops": 10.0}, "memory_analysis": {"peak_bytes": 5}}
    bundles = {}
    for side, mod, reg, extra in (("ours", forensics, MetricRegistry(), {"kernels": {"k": 1}}),
                                  ("theirs", jax_forensics, JaxRegistry(), {"hlo": "HloModule"})):
        fm = _manager(mod, tmp_path / side, FakeClock(), reg,
                      snapshot_fn=lambda extra=extra: {**snap, **extra})
        path = fm.capture("nan", 7, {"nonfinite_grads": 3.0})
        assert os.path.basename(path) == "nan-7" and fm.bundles == [path]
        bundles[side] = _read_bundle(path)
    ours, theirs = bundles["ours"], bundles["theirs"]
    assert set(ours) - SNAPSHOT_FILES - {"env.json"} == set(theirs) - SNAPSHOT_FILES - {"env.json"}
    assert "kernels.json" in ours and "hlo.txt" in theirs
    for name in set(ours) & set(theirs) - {"env.json", "manifest.json"}:
        assert ours[name] == theirs[name], name
    mo, mt = json.loads(ours["manifest.json"]), json.loads(theirs["manifest.json"])
    for m in (mo, mt):
        m["files"] = [f for f in m["files"] if f not in SNAPSHOT_FILES]
    assert mo == mt
    env = json.loads(ours["env.json"])
    assert {"torch_version", "cuda_version", "backend", "device_kind", "device_capability",
            "driver_version", "git_sha", "python_version"} <= set(env)
    assert env["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")


def test_the_trace_window_and_faulthandler_behave_as_glom_tpus(tmp_path):
    states = {}
    for side, mod, reg in (("ours", forensics, MetricRegistry()),
                           ("theirs", jax_forensics, JaxRegistry())):
        fm = _manager(mod, tmp_path / side, FakeClock(), reg, trace_steps=2)
        path = fm.capture("grad_spike", 10, {})
        seen = [json.load(open(os.path.join(path, "manifest.json"))).get("trace_state")]
        # a second capture while one trace runs does not start another
        other = fm.capture("nan", 11, {})
        seen.append(json.load(open(os.path.join(other, "manifest.json")))["trace"])
        seen += [fm.trace_active, fm.trace_due(11), fm.trace_due(12)]
        fm.stop_trace()
        fm.stop_trace()  # idempotent
        seen += [json.load(open(os.path.join(path, "manifest.json")))["trace_state"],
                 fm.trace_active]
        states[side] = seen
        # faulthandler: armed to <root>/faulthandler.log unless already on
        was = faulthandler.is_enabled()
        faulthandler.disable()
        try:
            armed = fm.arm_faulthandler()
            seen += [armed, faulthandler.is_enabled(),
                     os.path.exists(os.path.join(fm.root, "faulthandler.log"))]
            fm.disarm_faulthandler()
            seen.append(faulthandler.is_enabled())
            faulthandler.enable()
            seen.append(fm.arm_faulthandler())   # someone else's faulthandler
        finally:
            faulthandler.disable()
            if was:
                faulthandler.enable()
    assert states["ours"] == states["theirs"]
    assert states["ours"][:7] == ["recording", None, True, False, True, "complete", False]
    assert os.path.exists(tmp_path / "ours" / "grad_spike-10" / "trace" / forensics.TRACE_FILE)


def test_a_failed_capture_is_refunded(tmp_path):
    """A bundle that cannot be written warns, is not counted, and gives the
    trigger budget's slot back, so the next anomaly is still captured."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    t = Trainer(TINY, TrainConfig(batch_size=2, forensics_dir=str(blocker),
                                  forensics_max_captures=1), device="cpu",
                logger=MetricLogger(stream=io.StringIO()))
    with pytest.warns(UserWarning, match="forensics capture 'nan' at step 3 failed"):
        t._maybe_capture("nan", 3, {})
    assert t._forensics.bundles == []
    t._forensics.root = str(tmp_path / "f")
    t._maybe_capture("grad_spike", 4, {})
    assert [os.path.basename(b) for b in t._forensics.bundles] == ["grad_spike-4"]


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _train_run(tmp_path):
    """A port run's JSONL and its forensics root, with a grad_spike bundle."""
    log = str(tmp_path / "run.jsonl")
    root = str(tmp_path / "f")
    t = Trainer(TINY, TrainConfig(batch_size=2, steps=6, log_every=1, diag_every=3,
                                  forensics_dir=root), device="cpu",
                logger=MetricLogger(path=log, stream=io.StringIO()))

    def scaled():
        for i, b in enumerate(synthetic_batches(2, 16, 3, seed=5), 1):
            yield b * 1e3 if i == 5 else b

    t.fit(scaled())
    return log, root


def _bench(tmp_path):
    bench = tmp_path / "BENCH_r01.json"
    bench.write_text(json.dumps({"parsed": {"last_measured": {"value": 10.0}}}))
    return str(bench)


def test_glom_tpus_reports_read_the_ports_bundle_and_jsonl(tmp_path, capsys):
    log, root = _train_run(tmp_path)
    bench = _bench(tmp_path)
    theirs_f, theirs_o = _load_tool("forensics_report"), _load_tool("obs_report")
    assert theirs_f.main([root, "--format", "json"]) == 0
    s = json.loads(capsys.readouterr().out)
    assert s["trigger"] == "grad_spike" and s["step"] == 5 and s["ring_records"] > 0
    assert s["cost"] and s["phases"] and s["env"]["torch_version"] == torch.__version__
    assert theirs_f.main([root]) == 0 and "trigger: grad_spike" in capsys.readouterr().out
    assert theirs_o.main([log, "--format", "json", "--bench", bench]) == 0
    o = json.loads(capsys.readouterr().out)
    assert o["records"] > 6 and o["grad_spike_windows"] == 1
    assert o["final_island_agreement"] is not None
    # and the port's copies read the same files the same way
    assert forensics_report.main([root, "--format", "json"]) == 0
    mine = json.loads(capsys.readouterr().out)
    assert mine.pop("kernels") == {} and mine == s   # no kernel launches on the CPU
    assert obs_report.main([log, "--format", "json", "--bench", bench]) == 0
    assert json.loads(capsys.readouterr().out) == o
    # with no --bench the port's copy reads no ceiling (the repository's
    # BENCH_*.json hold a TPU's rate)
    assert obs_report.main([log, "--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out)["capacity"]["ceiling_imgs_per_sec"] is None


def test_the_ports_reports_render_glom_tpus_the_same(tmp_path, capsys):
    """A glom_tpu bundle (HLO snapshot, its env) and a glom_tpu-shaped JSONL
    render the same through both packages' tools, text and JSON (the port's
    JSON adds ``kernels``, null for a bundle without ``kernels.json``)."""
    fm = _manager(jax_forensics, tmp_path / "f", FakeClock(), JaxRegistry(),
                  snapshot_fn=lambda: {"hlo": "HloModule m", "cost_analysis": {"flops": 8.0},
                                       "memory_analysis": {"temp_size_in_bytes": 4}})
    fm._env = {"jax_version": "0.4", "jaxlib_version": "0.4", "backend": "tpu",
               "device_count": 8, "device_kind": "TPU v5e", "mesh_shape": {"data": 8},
               "git_sha": "abc"}
    bundle = fm.capture("crash", 3, {"error": "E", "traceback": "Traceback\n  boom"})
    other = fm.capture("nan", 5, {})
    log = tmp_path / "run.jsonl"
    log.write_text("\n".join(json.dumps(r) for r in [
        {"step": 1, "time": 0.1, "event": 1.0},
        {"step": 2, "time": 0.2, "imgs_per_sec": 5.0, "t_step": 0.2, "t_window": 0.3,
         "window_steps": 2, "grad_norm_spike": 1.0},
        {"step": 3, "time": 0.3, "island_agreement": 0.5, "attn_entropy": 1.0}]) + "\n")
    theirs_f, theirs_o = _load_tool("forensics_report"), _load_tool("obs_report")
    for argv in ([bundle], [bundle, "--format", "json"], [other, "--compare", bundle]):
        assert theirs_f.main(argv) == 0
        want = capsys.readouterr().out
        assert forensics_report.main(argv) == 0
        got = capsys.readouterr().out
        if "--format" in argv:
            got = json.loads(got)
            assert got.pop("kernels") is None
            want = json.loads(want)
        assert got == want
    bench = _bench(tmp_path)
    for argv in ([str(log), "--bench", bench], [str(log), "--format", "json", "--bench", bench]):
        assert theirs_o.main(argv) == 0
        want = capsys.readouterr().out
        assert obs_report.main(argv) == 0
        assert capsys.readouterr().out == want


# -- the engine ------------------------------------------------------------------

@pytest.fixture()
def ckpt(tmp_path):
    d = str(tmp_path / "ckpt")
    make_demo_checkpoint(d, config=TINY, seed=4)
    return d


def _burn_slo():
    return [parse_slo("p95<100ms", short_window_s=5.0, long_window_s=10.0, min_events=4,
                      burn_threshold=2.0)]


def test_the_engine_writes_warmup_and_slo_burn_bundles_and_lists_them(ckpt, tmp_path):
    from glom_tpu.serving.engine import ServingEngine as TheirEngine

    clock = FakeClock()
    fdir, wdir = str(tmp_path / "f"), str(tmp_path / "w")
    eng = ServingEngine(ckpt, device="cpu", buckets=(1, 2), reload_poll_s=0, clock=clock,
                        forensics_dir=fdir, warmup_dir=wdir, slos=_burn_slo())
    try:
        families = sorted(eng.caches)
        assert sorted(os.listdir(wdir)) == sorted(f"{f}-b{b}" for f in families for b in (1, 2))
        with open(os.path.join(wdir, "embed-b2", "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest == {"endpoint": "embed", "bucket": 2, "quant": "f32",
                            "cost_analysis": eng.caches["embed"].snapshots[2]["cost_analysis"],
                            "memory_analysis": eng.caches["embed"].snapshots[2][
                                "memory_analysis"]}
        assert manifest["cost_analysis"]["flops"] > 0
        with open(os.path.join(wdir, "embed-b2", "kernels.json")) as f:
            assert json.load(f) == {}   # the CPU launches no kernel
        for i in range(12):
            clock.advance(0.1)
            eng.observe_outcome("embed", 900.0, False, trace_id=f"t{i}")
        names = [b["name"] for b in eng.debug_forensics()["bundles"]]
        (burn,) = [n for n in names if n.startswith("slo_burn-")]
        files = set(os.listdir(os.path.join(fdir, burn)))
        assert {"attribution.json", "kernels.json", "cost_analysis.json", "env.json",
                "metrics.json", "manifest.json"} <= files
        ref = TheirEngine(ckpt, buckets=(1,), reload_poll_s=0, warmup=False)
        mine = eng.debug_forensics()
        assert sorted(mine) == sorted(ref.debug_forensics())
        assert sorted(mine["bundles"][0]) == ["manifest", "name"]
        srv = make_server(eng)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            url = "http://{}:{}/debug/forensics".format(*srv.server_address[:2])
            with urllib.request.urlopen(url, timeout=30) as r:
                payload = json.loads(r.read())
            assert [b["name"] for b in payload["bundles"]] == names
        finally:
            srv.shutdown()
            srv.server_close()
    finally:
        eng.shutdown(drain=False)


def test_a_burn_rollback_writes_a_deploy_rollback_bundle(ckpt, tmp_path):
    clock = FakeClock()
    fdir = str(tmp_path / "f")
    eng = ServingEngine(ckpt, device="cpu", buckets=(1, 2), reload_poll_s=0, clock=clock,
                        forensics_dir=fdir, slos=_burn_slo(), deploy_window_s=5.0,
                        deploy_min_events=4)
    eng.start(workers=False, watch=False)
    try:
        make_demo_checkpoint(ckpt, config=TINY, seed=1, step=2)
        assert eng.deploy.begin_canary(fraction=0.5, step=2) == 2
        for i in range(8):
            clock.advance(0.1)
            eng.deploy.observe_candidate("embed", 900.0, False, trace_id=f"c{i}")
        assert eng.deploy.phase == "idle"
        (name,) = [n for n in os.listdir(fdir) if n.startswith("deploy_rollback-")]
        with open(os.path.join(fdir, name, "manifest.json")) as f:
            detail = json.load(f)["detail"]
        assert detail["reason"] == "burn_rate" and detail["pins"] == {"before": 2, "after": 0}
        assert detail["trace_ids"] and detail["burn_rates"]
    finally:
        eng.shutdown(drain=False)


def test_a_corrupt_checkpoint_at_reload_writes_a_ckpt_corrupt_bundle(ckpt, tmp_path):
    """A newer step whose bytes flipped after the write is quarantined by
    the watcher's poll, counted, and fires the ckpt_corrupt trigger's
    bundle; the engine keeps serving what it serves."""
    from glom_tpu_torch.resilience import faultinject

    fdir = str(tmp_path / "f")
    eng = ServingEngine(ckpt, device="cpu", buckets=(1,), reload_poll_s=0,
                        forensics_dir=fdir, warmup=False)
    try:
        with faultinject.injected("ckpt_write:bitflip@3"):
            make_demo_checkpoint(ckpt, config=TINY, seed=1, step=3)
        with pytest.warns(UserWarning, match="quarantined corrupt checkpoint step 3"):
            assert eng.check_reload() is False
        assert eng.step == 0
        assert os.listdir(fdir) == ["ckpt_corrupt-3"]
        assert eng.registry.snapshot()["ckpt_corrupt_total"] == 1.0
    finally:
        eng.shutdown(drain=False)


def test_a_corrupt_step_at_start_up_is_counted_without_a_bundle_as_in_glom_tpu(ckpt, tmp_path):
    """The start-up load quarantines and counts a corrupt newest step, but
    the forensics manager does not exist yet, so no bundle is written: in
    glom_tpu's engine too (ROADMAP.md queue 3)."""
    from glom_tpu.serving.engine import ServingEngine as TheirEngine
    import shutil

    from glom_tpu_torch.resilience import faultinject

    with faultinject.injected("ckpt_write:bitflip@3"):
        make_demo_checkpoint(ckpt, config=TINY, seed=1, step=3)
    theirs_ckpt = str(tmp_path / "theirs")
    shutil.copytree(ckpt, theirs_ckpt)
    got = []
    for make, d in ((lambda d, f: ServingEngine(d, device="cpu", buckets=(1,), reload_poll_s=0,
                                                 warmup=False, forensics_dir=f), ckpt),
                    (lambda d, f: TheirEngine(d, buckets=(1,), reload_poll_s=0, warmup=False,
                                              forensics_dir=f), theirs_ckpt)):
        fdir = d + "-forensics"
        with pytest.warns(UserWarning, match="quarantined corrupt checkpoint step 3"):
            eng = make(d, fdir)
        got.append((int(eng.step), eng.registry.snapshot()["ckpt_corrupt_total"],
                    os.path.exists(fdir) and os.listdir(fdir)))
        eng.shutdown(drain=False)
    assert got[0] == got[1] == (0, 1.0, False)


def test_diff_snapshots_names_a_quant_change_on_port_engines(ckpt):
    """The graph snapshots carry glom_tpu's quant label and an analytic cost,
    so the op-diff plane names a quant change at every bucket; a deploy
    candidate's snapshots reach the evidence beside the primary's."""
    f32 = ServingEngine(ckpt, device="cpu", buckets=(1, 2), reload_poll_s=0)
    bf16 = ServingEngine(ckpt, device="cpu", buckets=(1, 2), reload_poll_s=0, quant="bf16")
    try:
        diff = attribution.diff_snapshots(f32.caches["embed"].snapshots,
                                          bf16.caches["embed"].snapshots)
        rows = {r["bucket"]: r for r in diff["buckets"]}
        assert sorted(rows) == [1, 2]
        for r in rows.values():
            assert r["quant"] == {"before": "f32", "after": "bf16"}
            assert r["bytes_accessed"]["ratio"] < 1
        assert attribution.diff_snapshots(f32.caches["embed"].snapshots,
                                          f32.caches["embed"].snapshots) is None
        make_demo_checkpoint(ckpt, config=TINY, seed=1, step=2)
        f32.start(workers=False, watch=False)
        assert f32.deploy.begin_shadow(step=2) == 2
        evidence = attribution.collect_engine_evidence(f32)
        assert sorted(evidence["snapshots"]["before"]) == [1, 2]
        assert evidence["snapshots"]["after"] == evidence["snapshots"]["before"]
        f32.deploy.abort()
    finally:
        f32.shutdown(drain=False)
        bf16.shutdown(drain=False)


# -- the device guard ------------------------------------------------------------

def test_a_wedged_device_init_emits_its_error_line_within_its_timeout():
    assert device_guard.guard_device_init(0, print) is None
    timer = device_guard.guard_device_init(30, print)
    timer.cancel()
    device_guard.guarded_cuda_init("cpu", 1, print, touch=lambda d: 1 / 0)  # not guarded
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from glom_tpu_torch import device_guard\n"
        "device_guard.guarded_cuda_init('cuda', 1, lambda m: print('bench: ' + m, "
        "file=sys.stderr, flush=True), touch=lambda d: time.sleep(60))\n"
        "print('unreachable')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=50)
    assert res.returncode == 2 and "unreachable" not in res.stdout
    assert "bench: device init exceeded 1s" in res.stderr
