"""The port's quality plane against glom_tpu's on the CPU.

``glom_tpu_torch/obs/{sketch,quality}.py``: the sketches, the credit sampler
and the plane are glom_tpu's host code, so the same records and signals give
equal sketches (``psi`` and ``ks_distance`` within 1e-12), equal decisions,
equal payloads and drift, and a sketch or ``quality_ref.json`` written by
either package loads and merges in the other.  The post-pass
(``make_quality_fn``, the engine's ``quality`` graph family) is held against
glom_tpu's on one checkpoint: within 1e-4 relative per column group in f32,
1e-2 in bf16.  Then the engine: sampling decides every batch and captures
nothing, the drift SLO fires once with trace ids and the input fingerprints
glom_tpu computes for the same inputs, glom_tpu's fleet plane merges the port
engine's ``/healthz`` sketches exactly, ``/quality`` and
``/admin/quality/ref`` are served, a shadow deploy judges the candidate's
agreement from the candidate's own family as glom_tpu's does, and ``python
-m glom_tpu_torch.tools.quality_report --smoke`` passes on the CPU.
"""

import json
import os
import random
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from glom_tpu.obs import quality as jax_quality
from glom_tpu.obs import sketch as jax_sketch
from glom_tpu.serving.engine import ServingEngine as JaxServingEngine
from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.obs import quality, sketch
from glom_tpu_torch.serving import server
from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
from glom_tpu_torch.tools import quality_report
from tests.polling import poll_until

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = GlomConfig(dim=32, levels=3, image_size=16, patch_size=4)
L = TINY.levels
# the post-pass against glom_tpu's, relative to each column group's largest
# magnitude
SIGNAL_RTOL = {"f32": 1e-4, "bf16": 1e-2}
DISTANCE_ATOL = 1e-12
AGREEMENT_ATOL = 1e-5
SMOKE_SECONDS = 60.0


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _imgs(k, seed=0):
    return np.random.default_rng(seed).standard_normal((k, 3, 16, 16)).astype(np.float32)


def _corrupt(k, seed=0):
    """tools/loadgen.py's --corrupt perturbation of ``_imgs``."""
    x = _imgs(k, seed) + 2.5 * np.random.default_rng(seed + 100).standard_normal(
        (k, 3, 16, 16)).astype(np.float32)
    x[..., :8, :] = 0.0
    return x


# ---------------------------------------------------------------------------
# sketches and the sampler
# ---------------------------------------------------------------------------

def _values(seed, n=300):
    rng = random.Random(seed)
    return [rng.gauss(0.3, 0.6) for _ in range(n)] + [-5.0, 5.0, 0.0, 1.0]


def _sketches(mod, seed):
    clock = FakeClock()
    h = mod.HistogramSketch([i / 8 - 1 for i in range(17)], clock=clock)
    q = mod.QuantileSketch(-1.0, 1.0, resolution=64, clock=clock)
    for v in _values(seed):
        h.record(v)
        q.record(v, weight=2 if v > 0.9 else 1)
    return h, q


@pytest.mark.parametrize("seed", [0, 1])
def test_sketches_are_glom_tpus_and_cross_both_ways(seed):
    oh, oq = _sketches(sketch, seed)
    th, tq = _sketches(jax_sketch, seed)
    assert oh.to_dict() == th.to_dict() and oq.to_dict() == tq.to_dict()
    for q in (0.0, 0.1, 0.5, 0.95, 1.0):
        assert oq.quantile(q) == tq.quantile(q)
    oh2, oq2 = _sketches(sketch, seed + 7)
    th2, tq2 = _sketches(jax_sketch, seed + 7)
    assert abs(sketch.psi(oh, oh2) - jax_sketch.psi(th, th2)) <= DISTANCE_ATOL
    assert abs(sketch.ks_distance(oq, oq2) - jax_sketch.ks_distance(tq, tq2)) <= DISTANCE_ATOL
    # a sketch serialized by one package loads and merges exactly in the other
    for mine, other_mod, other in ((oh2, jax_sketch, th), (oq2, jax_sketch, tq),
                                   (th2, sketch, oh), (tq2, sketch, oq)):
        loaded = other_mod.sketch_from_dict(json.loads(json.dumps(mine.to_dict())))
        assert loaded.to_dict() == mine.to_dict()
        merged = other_mod.sketch_from_dict(other.to_dict()).merge(loaded)
        assert merged.count == other.count + mine.count
        native = type(mine).from_dict(mine.to_dict()).merge(type(mine).from_dict(
            other.to_dict()))
        if hasattr(merged, "counts"):
            assert merged.counts() == native.counts()
        else:
            assert merged._counts == native._counts


@pytest.mark.parametrize("fraction,seed", [(0.5, 0), (0.1, 3), (1.0, 0), (0.0, 1), (0.73, 11)])
def test_credit_sampler_decides_as_glom_tpus(fraction, seed):
    ours, theirs = quality.CreditSampler(fraction, seed=seed), jax_quality.CreditSampler(
        fraction, seed=seed)
    got = [ours.decide() for _ in range(1000)]
    assert got == [theirs.decide() for _ in range(1000)]
    assert ours.kept == theirs.kept and abs(ours.kept - 1000 * fraction) <= 1


def test_constants_and_unpack_are_glom_tpus():
    for name in ("QUALITY_METRICS", "QUALITY_SLO_METRICS", "METRIC_RANGES", "REFERENCE_FILE"):
        assert getattr(quality, name) == getattr(jax_quality, name), name
    row = list(np.linspace(-1, 1, 3 * L + 1))
    assert quality.unpack_signals(row, L) == jax_quality.unpack_signals(row, L)
    for mod in (quality, jax_quality):
        with pytest.raises(ValueError, match="columns"):
            mod.unpack_signals(row[:-1], L)


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------

def _signals(seed, n, shift=0.0):
    rng = random.Random(seed)
    return [{"agreement_levels": [rng.uniform(-0.2, 0.9) + shift for _ in range(L)],
             "entropy_levels": [rng.uniform(0.8, 1.0) for _ in range(L)],
             "norm_levels": [rng.uniform(0.5, 3.0) + 4 * shift for _ in range(L)],
             "residual": rng.uniform(0.5, 1.5) + 2 * shift} for _ in range(n)]


def _plane_run(mod, reg_mod, ref_dir, load_from=None):
    clock = FakeClock()
    reg = reg_mod.MetricRegistry()
    plane = mod.QualityPlane(reg, levels=L, sample=0.5, seed=2, clock=clock, worst_n=4)
    decisions = [plane.should_sample() for _ in range(9)]
    flats = []
    for i, s in enumerate(_signals(0, 20)):
        flats.append(plane.observe(s, trace_id=f"t{i}", tenant="a" if i % 3 else None,
                                   version=4, fingerprint=f"{i:016x}"))
    if load_from is None:
        plane.save_reference(ref_dir, step=4)
    else:
        assert plane.load_reference(load_from)
    for i, s in enumerate(_signals(1, 15, shift=0.4)):
        flats.append(plane.observe(s, trace_id=f"c{i}", version=4, fingerprint=f"c{i:015x}"))
    payload = plane.payload()
    payload["reference"].pop("source")
    return {"decisions": decisions, "flats": flats, "payload": payload,
            "summary": plane.summary(), "drift": plane.drift(),
            "fingerprints": plane.fingerprints(["t3", "c2", "zz"]), "snap": reg.snapshot()}


def test_plane_payload_drift_and_reference_are_glom_tpus_both_ways(tmp_path):
    from glom_tpu.obs import registry as jax_registry
    from glom_tpu_torch.obs import registry

    ours = _plane_run(quality, registry, str(tmp_path / "ours"))
    theirs = _plane_run(jax_quality, jax_registry, str(tmp_path / "theirs"))
    assert ours == theirs
    assert ours["drift"]["max_ks"] > 0.2 and ours["payload"]["reference"]["step"] == 4
    # each package's quality_ref.json is the other's, byte for byte, and
    # loads in the other with the same result
    ref = quality.REFERENCE_FILE
    assert (tmp_path / "ours" / ref).read_bytes() == (tmp_path / "theirs" / ref).read_bytes()
    crossed = _plane_run(quality, registry, None, load_from=str(tmp_path / "theirs"))
    back = _plane_run(jax_quality, jax_registry, None, load_from=str(tmp_path / "ours"))
    assert crossed["drift"] == back["drift"] == ours["drift"]


def test_fleet_planes_are_glom_tpus():
    from glom_tpu.obs import timeseries as jax_timeseries
    from glom_tpu_torch.obs import timeseries

    summaries = []
    for i, seed in enumerate((0, 1)):
        plane = quality.QualityPlane(None, levels=L, clock=FakeClock())
        for s in _signals(seed, 10 + 5 * i):
            plane.observe(s)
        summaries.append(json.loads(json.dumps(plane.summary())))
    got = {}
    for name, mod, ts in (("ours", quality, timeseries), ("theirs", jax_quality,
                                                          jax_timeseries)):
        store = ts.SeriesStore(clock=FakeClock(7.0))
        fleet = mod.FleetQualityPlane(store=store, clock=FakeClock(7.0))
        for r, s in zip(("r0", "r1"), summaries):
            fleet.ingest(r, s)
        fleet.ingest("old", None)
        got[name] = (fleet.payload(), store.payload("prefix=quality_"))
    assert got["ours"] == got["theirs"]
    assert got["ours"][0]["fleet"]["metrics"]["residual"]["count"] == 25


# ---------------------------------------------------------------------------
# the post-pass and the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("quality_ckpt"))
    make_demo_checkpoint(d, config=TINY, seed=5)
    return d


def _groups(mat):
    return {"agreement": mat[:, :L], "entropy": mat[:, L:2 * L], "norm": mat[:, 2 * L:3 * L],
            "residual": mat[:, 3 * L:]}


@pytest.mark.parametrize("quant", ["f32", "bf16"])
def test_post_pass_agrees_with_glom_tpus(ckpt, quant):
    x = _imgs(3, seed=1)
    ours = ServingEngine(ckpt, device="cpu", buckets=(1, 4), reload_poll_s=0, quant=quant)
    theirs = JaxServingEngine(ckpt, buckets=(1, 4), reload_poll_s=0, warmup=False, quant=quant)
    try:
        got = ours.run("quality", x)
        want = np.asarray(theirs.quality_cache(theirs.params, x))
        # the replay is the eager post-pass at the same bucket, padding sliced off
        np.testing.assert_array_equal(got, ours.run_eager("quality", x))
    finally:
        ours.shutdown(drain=False)
        theirs.shutdown(drain=False)
    assert got.dtype == np.float32 and got.shape == want.shape == (3, 3 * L + 1)
    assert np.isfinite(got).all()
    for name, g in _groups(got).items():
        w = _groups(want)[name]
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= SIGNAL_RTOL[quant], (name, err)


def test_make_quality_fn_is_one_forward_and_the_decoder(ckpt):
    """The columns are the final levels' agreement, entropy and norms and the
    residual of the state at the loss timestep, each computed apart."""
    from glom_tpu_torch.models import glom as glom_model
    from glom_tpu_torch.models.heads import decoder_apply
    from glom_tpu_torch.models.islands import neighbor_agreement
    from glom_tpu_torch.training import denoise

    _, config, train_cfg, params = denoise.load_checkpoint_state(ckpt, device="cpu")
    x = torch.from_numpy(_imgs(2, seed=4))
    with torch.inference_mode():
        mat = quality.make_quality_fn(config, train_cfg, None)(params, x)
        t = denoise.resolve_loss_timestep(train_cfg, config.default_iters)
        final, captured = glom_model.apply(params["glom"], x, config=config,
                                           capture_timestep=t)
        agree = neighbor_agreement(final, 4).reshape(2, L, -1)
        recon = decoder_apply(params["decoder"], captured, config, arch=train_cfg.decoder,
                              level=train_cfg.loss_level)
    torch.testing.assert_close(mat[:, :L], agree.mean(-1), rtol=0, atol=1e-6)
    torch.testing.assert_close(mat[:, 2 * L:3 * L], final.norm(dim=-1).mean(1), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(mat[:, -1], ((recon - x) ** 2).mean((1, 2, 3)), rtol=1e-6,
                               atol=1e-7)


def test_sampling_decides_every_batch_and_captures_nothing(ckpt):
    eng = ServingEngine(ckpt, device="cpu", buckets=(1, 2), max_wait_ms=0.0, reload_poll_s=0,
                        quality_sample=0.5)
    eng.start(workers=False, watch=False)
    try:
        for i in range(8):
            fut = eng.submit("embed", _imgs(1 + i % 2, seed=i))
            eng.process_once("embed", block=True, timeout=5)
            fut.result(timeout=30)
        summary = eng.health()["quality"]
        snap = eng.registry.snapshot()
    finally:
        eng.shutdown(drain=False)
    assert summary["decided"] == 8 and 1 <= summary["sampled"] <= 7
    assert summary["observed"] >= summary["sampled"] and summary["sample_fraction"] == 0.5
    assert "serving_graph_captures" not in snap and "quality_post_pass_failures" not in snap
    assert snap["quality_observed_total"] == summary["observed"]
    # quality_sample=0 builds no family and samples nothing
    off = ServingEngine(ckpt, device="cpu", buckets=(1,), reload_poll_s=0, quality_sample=0)
    try:
        assert "quality" not in off.caches and off.quality.summary()["sample_fraction"] == 0.0
    finally:
        off.shutdown(drain=False)


def test_a_failing_post_pass_is_counted_and_answered_by_nothing(ckpt):
    eng = ServingEngine(ckpt, device="cpu", buckets=(1,), max_wait_ms=0.0, reload_poll_s=0)
    eng.start(workers=False, watch=False)

    def broken(*a, **k):
        raise RuntimeError("post-pass down")

    eng.caches["quality"].fn = broken
    try:
        fut = eng.submit("embed", _imgs(1))
        eng.process_once("embed", block=True, timeout=5)
        assert fut.result(timeout=30).shape == (1, L, TINY.dim)
        snap = eng.registry.snapshot()
    finally:
        eng.shutdown(drain=False)
    assert snap["quality_post_pass_failures"] == 1 and eng.quality.observed == 0


def _drift_run(eng, tmp):
    """Clean traffic frozen as the reference, then corrupt traffic, every
    request with its own trace id."""
    def send(x, tid):
        ctx = eng.tracer.start_trace("request", trace_id=tid)
        fut = eng.submit("embed", x, ctx=ctx)
        eng.process_once("embed", block=True, timeout=5)
        fut.result(timeout=60)

    for i in range(8):
        send(_imgs(1, seed=i), f"clean-{i}")
    eng.quality.save_reference(tmp, step=0)
    for i in range(16):
        send(_corrupt(1, seed=i), f"bad-{i}")
    fires = [f for f in eng._slo.fired if f.get("metric") == "drift"]
    ids = [f"clean-{i}" for i in range(8)] + [f"bad-{i}" for i in range(16)]
    return fires, eng.quality.fingerprints(ids), eng.registry.snapshot()


def test_drift_slo_fires_once_with_glom_tpus_fingerprints(ckpt, tmp_path):
    kw = dict(buckets=(1,), max_wait_ms=0.0, reload_poll_s=0, slos=["drift<0.2"])
    ours = ServingEngine(ckpt, device="cpu", **kw)
    theirs = JaxServingEngine(ckpt, warmup=False, **kw)
    ours.start(workers=False, watch=False)
    theirs.start(workers=False, watch=False)
    try:
        fires, prints, snap = _drift_run(ours, str(tmp_path / "ours"))
        jfires, jprints, jsnap = _drift_run(theirs, str(tmp_path / "theirs"))
    finally:
        ours.shutdown(drain=False)
        theirs.shutdown(drain=False)
    assert len(fires) == len(jfires) == 1
    assert snap["quality_drift_events"] == jsnap["quality_drift_events"] == 1
    fire = fires[0]
    assert fire["trace_ids"] and all(t.startswith("bad-") for t in fire["trace_ids"])
    assert fire["fingerprints"] == {t: prints[t] for t in fire["trace_ids"]}
    assert prints == jprints and len(prints) == 24
    assert ours.quality.drift()["max_ks"] > 0.2


def test_glom_tpus_fleet_plane_merges_the_port_engines_health_exactly(ckpt):
    ours = ServingEngine(ckpt, device="cpu", buckets=(1, 2), reload_poll_s=0)
    theirs = JaxServingEngine(ckpt, buckets=(1, 2), reload_poll_s=0, warmup=False)
    summaries = {}
    try:
        for name, eng in (("torch", ours), ("jax", theirs)):
            eng.start(workers=False, watch=False)
            for i in range(3):
                fut = eng.submit("embed", _imgs(2, seed=i))
                eng.process_once("embed", block=True, timeout=5)
                fut.result(timeout=60)
            summaries[name] = json.loads(json.dumps(eng.health()["quality"]))
    finally:
        ours.shutdown(drain=False)
        theirs.shutdown(drain=False)
    fleet = jax_quality.FleetQualityPlane()
    fleet.ingest("torch-r0", summaries["torch"])
    fleet.ingest("jax-r1", summaries["jax"])
    merged = fleet.merged_sketches()
    for metric in jax_quality.QUALITY_METRICS:
        q = merged[metric]["quantile"]
        parts = [jax_sketch.sketch_from_dict(summaries[n]["sketches"][metric]["quantile"])
                 for n in ("torch", "jax")]
        assert q.count == sum(p.count for p in parts) == 6
        want = {}
        for p in parts:
            for k, v in p._counts.items():
                want[k] = want.get(k, 0) + v
        assert q._counts == want
    # the port's own fleet plane merges the same summaries alike
    port_fleet = quality.FleetQualityPlane()
    port_fleet.ingest("torch-r0", summaries["torch"])
    port_fleet.ingest("jax-r1", summaries["jax"])
    assert port_fleet.payload() == fleet.payload()


# ---------------------------------------------------------------------------
# HTTP, the deploy shadow and the tool
# ---------------------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_quality_routes_are_served(tmp_path):
    d = str(tmp_path / "ckpt")
    make_demo_checkpoint(d, config=TINY, seed=5)
    eng = ServingEngine(d, device="cpu", buckets=(1, 2), max_wait_ms=1.0, reload_poll_s=0)
    eng.start(watch=False)
    srv = server.make_server(eng)
    threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    url = "http://127.0.0.1:%d" % srv.server_address[1]
    try:
        for i in range(3):
            _post(url + "/embed", {"images": _imgs(1, seed=i).tolist()})
        # the post-pass runs after the answers are out: wait for the worker
        q = poll_until(lambda: (lambda q: q if q["observed"] == 3 else None)(
            _get(url + "/quality"))) or _get(url + "/quality")
        assert q["observed"] == 3 and q["reference"] is None and q["levels"] == L
        assert sorted(q["metrics"]) == sorted(quality.QUALITY_METRICS)
        assert len(q["worst"]) == 3 and all(len(w["fingerprint"]) == 16 for w in q["worst"])
        written = _post(url + "/admin/quality/ref", {})
        assert written == {"written": os.path.join(d, quality.REFERENCE_FILE), "step": 0}
        assert _get(url + "/quality")["reference"]["step"] == 0
        assert _get(url + "/healthz")["quality"]["reference"] is True
    finally:
        srv.shutdown()
        srv.server_close()
        eng.shutdown(drain=False)
    # the frozen reference loads in glom_tpu's plane, and in the next engine
    plane = jax_quality.QualityPlane(None, levels=L)
    assert plane.load_reference(d) and plane.reference_meta["observed"] == 3
    again = ServingEngine(d, device="cpu", buckets=(1,), reload_poll_s=0)
    try:
        assert again.quality.reference_meta["step"] == 0
    finally:
        again.shutdown(drain=False)


def test_shadow_judges_agreement_from_the_candidates_own_family(tmp_path):
    x = _imgs(2, seed=3)
    got = {}
    for side in ("ours", "theirs"):
        d = str(tmp_path / side)
        make_demo_checkpoint(d, config=TINY, seed=0)
        kw = dict(buckets=(1, 2), max_wait_ms=0.0, reload_poll_s=0)
        eng = (ServingEngine(d, device="cpu", **kw) if side == "ours"
               else JaxServingEngine(d, warmup=False, **kw))
        eng.start(workers=False, watch=False)
        try:
            make_demo_checkpoint(d, config=TINY, seed=1, step=2)
            assert eng.deploy.begin_shadow(step=2) == 2
            eng.deploy._stop.set()
            with eng.deploy._shadow_cv:
                eng.deploy._shadow_cv.notify_all()
            eng.deploy._shadow_thread.join(timeout=5)
            fut = eng.submit("embed", x)
            eng.process_once("embed", block=True, timeout=5)
            fut.result(timeout=60)
            with eng.deploy._shadow_cv:
                item = eng.deploy._shadow_q.popleft()
            assert eng.deploy.process_shadow(*item)
            got[side] = eng.registry.snapshot()["deploy_shadow_agreement"]
            if side == "ours":
                cand = eng.deploy.candidate(2)
                assert cand.caches.caches["quality"] is not eng.caches["quality"]
                own = cand.caches.caches["quality"].eager(cand.params, x)
                primary = eng.run_eager("quality", x)
                assert got[side] == round(float(own[:, :L].mean()), 6)
                assert got[side] != round(float(primary[:, :L].mean()), 6)
                assert "serving_graph_captures" not in eng.registry.snapshot()
        finally:
            eng.shutdown(drain=False)
    assert abs(got["ours"] - got["theirs"]) <= AGREEMENT_ATOL, got


def test_quality_smoke_passes_on_the_cpu(capsys):
    t0 = time.monotonic()
    assert quality_report.main(["--smoke", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert time.monotonic() - t0 < SMOKE_SECONDS
    assert report["smoke"] == "ok" and all(report["checks"].values())
    assert report["drift_after"] > 0.2 > report["drift_before"]
    assert report["quality_drift_fires"] == 1 and report["fire"]["fingerprints"]
    # the fleet leg: the port's router merges the replica's sketches
    assert quality_report.main(["--smoke", "--fleet", "--device", "cpu"]) == 0
    fleet = json.loads(capsys.readouterr().out)
    assert fleet["smoke"] == "ok" and fleet["checks"]["fleet_merged"]
    assert fleet["fleet_drift"] > 0.2
