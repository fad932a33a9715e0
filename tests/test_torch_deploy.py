"""The port's safe deploys (glom_tpu_torch/serving/deploy.py, the engine's
registry, canary and shadow paths, /admin/deploy/*) against glom_tpu's on
the CPU.

Mirrors tests/test_deploy.py's TestShadow, TestCanary, TestAutoActions and
TestHTTPDeployAdmin under one fake clock, on checkpoints the port writes and
both packages load (``dim=32, levels=3, image_size=16, patch_size=4``):
``assign`` bitwise glom_tpu's over 1,000 keys, the shadow divergence within
1e-6 of glom_tpu's engine on the same two checkpoints, promote and rollback
at the same event index, the admin routes' codes and bodies, health's
``deploy`` and ``models`` blocks, extra models and the ``model`` field, and
glom_tpu's FleetRouter committing a promote on a port replica through its
``/rollout`` without a capture.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from glom_tpu.obs.slo import parse_slo as jax_parse_slo
from glom_tpu.serving.engine import ServingEngine as JaxServingEngine
from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.obs.slo import parse_slo
from glom_tpu_torch.resilience import faultinject
from glom_tpu_torch.serving import compile_cache, deploy
from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
from glom_tpu_torch.serving.registry import DEFAULT_MODEL
from glom_tpu_torch.serving.server import make_server

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = GlomConfig(dim=32, levels=3, image_size=16, patch_size=4)
DIVERGENCE_ATOL = 1e-6


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, seconds):
        self.t += seconds


def _imgs(k=1, seed=0):
    return np.random.default_rng(seed).standard_normal((k, 3, 16, 16)).astype(np.float32)


def _ckpt(tmp_path, name="ckpt", seed=0):
    d = str(tmp_path / name)
    make_demo_checkpoint(d, config=TINY, seed=seed)
    return d


def _save_step(d, step, seed):
    """A newer step of the same model with other seeded weights."""
    make_demo_checkpoint(d, config=TINY, seed=seed, step=step)


def _engine(d, **kw):
    kw.setdefault("buckets", (1, 2))
    kw.setdefault("max_wait_ms", 0.0)
    kw.setdefault("reload_poll_s", 0)
    eng = ServingEngine(d, device="cpu", **kw)
    eng.start(workers=False, watch=False)
    return eng


def _jax_engine(d, **kw):
    kw.setdefault("buckets", (1, 2))
    kw.setdefault("max_wait_ms", 0.0)
    kw.setdefault("reload_poll_s", 0)
    kw.setdefault("warmup", False)
    eng = JaxServingEngine(d, **kw)
    eng.start(workers=False, watch=False)
    return eng


def _pump(eng, endpoint="embed"):
    while eng.process_once(endpoint):
        pass


def _stop_shadow_thread(eng):
    """Retire the shadow thread, so a test pumps the shadow queue itself."""
    eng.deploy._stop.set()
    with eng.deploy._shadow_cv:
        eng.deploy._shadow_cv.notify_all()
    eng.deploy._shadow_thread.join(timeout=5)
    assert not eng.deploy._shadow_thread.is_alive()
    eng.deploy._stop.clear()


def _pump_shadow(eng):
    mirrored = 0
    while True:
        with eng.deploy._shadow_cv:
            item = eng.deploy._shadow_q.popleft() if eng.deploy._shadow_q else None
        if item is None:
            return mirrored
        assert eng.deploy.process_shadow(*item)
        mirrored += 1


def _captures(eng):
    return eng.registry.snapshot().get("serving_graph_captures", 0)


# -- shadow ----------------------------------------------------------------------

class TestShadow:
    def test_shadow_loads_candidate_resident_with_sets_of_its_own(self, tmp_path):
        d = _ckpt(tmp_path)
        eng = _engine(d)
        try:
            _save_step(d, 2, seed=1)
            assert eng.deploy.begin_shadow() == 2
            assert eng.deploy.phase == "shadow"
            cand = eng.models.get(DEFAULT_MODEL, 2)
            assert cand is not None and cand.role == "candidate" and cand.aliased
            # the same program, its own graphs and parameters
            primary = eng.models.get(DEFAULT_MODEL)
            assert cand.program is primary.program
            assert cand.caches.caches["embed"] is not primary.caches.caches["embed"]
            assert cand.caches.step == 2 and eng.step == 0
            assert eng.health()["deploy"]["phase"] == "shadow"
        finally:
            eng.shutdown(drain=False)

    def test_shadow_mirrors_and_discards(self, tmp_path):
        """Mirrored batches replay the candidate's set; the outcomes land
        only under the candidate's evaluators; nothing captures on the
        request path."""
        d = _ckpt(tmp_path)
        eng = _engine(d, slos=["p95<10000ms"])
        try:
            _save_step(d, 2, seed=1)
            assert eng.deploy.begin_shadow() == 2
            _stop_shadow_thread(eng)
            fut = eng.submit("embed", _imgs(1))
            _pump(eng)
            fut.result(timeout=10)
            mirrored = _pump_shadow(eng)
            assert mirrored == 1
            assert eng.registry.snapshot()["deploy_shadow_requests"] == mirrored
            fed = {ev.slo.name: len(ev._short) for ev in eng.deploy._evaluators}
            assert fed == {"p95<10000ms": mirrored, "divergence<0.2": mirrored}
            assert all(len(ev._short) == 0 for ev in eng._slo.evaluators)
            assert _captures(eng) == 0
        finally:
            eng.shutdown(drain=False)

    def test_shadow_divergence_matches_glom_tpu(self, tmp_path):
        """The same two checkpoints, the same mirrored batch: the port's
        ``deploy_shadow_divergence`` within 1e-6 of glom_tpu's, and equal to
        the float64 divergence of the two trees' eager answers."""
        x = _imgs(2, seed=3)
        got = {}
        for side, make in (("ours", _engine), ("theirs", _jax_engine)):
            d = _ckpt(tmp_path, f"ckpt-{side}")
            eng = make(d)
            try:
                _save_step(d, 2, seed=1)
                assert eng.deploy.begin_shadow(step=2) == 2
                _stop_shadow_thread(eng)
                fut = eng.submit("embed", x)
                _pump(eng)
                primary = np.asarray(fut.result(timeout=60))
                assert _pump_shadow(eng) == 1
                got[side] = eng.registry.snapshot()["deploy_shadow_divergence"]
                if side == "ours":
                    cand = eng.deploy.candidate(2)
                    eager = cand.caches.caches["embed"].eager(cand.params, x)
                    want, _ = deploy._cosine_divergence(eng.run_eager("embed", x), eager)
                    np.testing.assert_array_equal(primary, eng.run_eager("embed", x))
                    assert got[side] == round(want, 6)
            finally:
                eng.shutdown(drain=False)
        assert got["ours"] > 0.01
        assert abs(got["ours"] - got["theirs"]) <= DIVERGENCE_ATOL, got

    def test_corrupt_candidate_quarantined_and_aborted(self, tmp_path):
        d = _ckpt(tmp_path)
        eng = _engine(d)
        try:
            with faultinject.injected("ckpt_write:bitflip@2"):
                _save_step(d, 2, seed=1)
            before = eng.param_bytes()
            assert eng.deploy.begin_shadow() is None
            assert eng.deploy.phase == "idle"
            assert eng.models.get(DEFAULT_MODEL, 2) is None
            assert [f for f in os.listdir(d) if f.endswith(".corrupt")]
            assert eng.param_bytes() == before and eng.step == 0
        finally:
            eng.shutdown(drain=False)

    def test_a_capture_that_fails_aborts_the_deploy(self, tmp_path, monkeypatch):
        """A candidate whose graphs cannot be captured never serves: counted,
        warned, the primary untouched, nothing resident."""
        d = _ckpt(tmp_path)
        eng = _engine(d)
        try:
            _save_step(d, 2, seed=1)

            def refuse(serving):
                raise RuntimeError("capture refused")

            monkeypatch.setattr(eng, "_warm_set", refuse)
            with pytest.warns(UserWarning, match="deploy aborted"):
                assert eng.deploy.begin_shadow() is None
            assert eng.registry.snapshot()["deploy_candidate_load_failures"] == 1
            assert eng.models.versions(DEFAULT_MODEL)[0].step == 0
            assert len(eng.models.versions(DEFAULT_MODEL)) == 1
        finally:
            eng.shutdown(drain=False)

    def test_candidate_load_bitflip_negates_what_glom_tpu_negates(self, tmp_path):
        """``candidate_load:bitflip`` negates every leaf of the restored and
        placed tree, in both packages."""
        from glom_tpu.resilience import faultinject as jax_faultinject

        got = {}
        for side, make, fi in (("ours", _engine, faultinject),
                               ("theirs", _jax_engine, jax_faultinject)):
            d = _ckpt(tmp_path, f"ckpt-{side}")
            eng = make(d)
            try:
                _save_step(d, 2, seed=1)
                with fi.injected("candidate_load:bitflip"):
                    assert eng.deploy.begin_shadow(step=2) == 2
                glom = eng.deploy.candidate(2).params["glom"]
                got[side] = {k: np.asarray(v["w1"] if isinstance(v, dict) else v, np.float32)
                             for k, v in glom.items() if k in ("bottom_up", "pos_emb")}
            finally:
                eng.shutdown(drain=False)
        trees = ckpt_lib.unflatten(ckpt_lib.load_arrays(d, 2))
        want = trees["params"]["glom"]
        np.testing.assert_array_equal(got["ours"]["pos_emb"], -want["pos_emb"])
        np.testing.assert_array_equal(got["ours"]["bottom_up"], -want["bottom_up"]["w1"])
        for k in got["ours"]:
            np.testing.assert_array_equal(got["ours"][k], got["theirs"][k])

    def test_second_deploy_requires_settling_first(self, tmp_path):
        d = _ckpt(tmp_path)
        eng = _engine(d)
        try:
            _save_step(d, 2, seed=1)
            _save_step(d, 3, seed=2)
            assert eng.deploy.begin_shadow(step=2) == 2
            with pytest.raises(RuntimeError, match="active"):
                eng.deploy.begin_shadow(step=3)
            assert eng.deploy.abort() is True
            assert eng.deploy.begin_shadow(step=3) == 3
            eng.deploy.abort()
            assert [v.step for v in eng.models.versions(DEFAULT_MODEL)] == [eng.step]
        finally:
            eng.shutdown(drain=False)


# -- canary ----------------------------------------------------------------------

class TestCanary:
    @pytest.mark.parametrize("fraction", [0.1, 0.5])
    def test_assign_is_bitwise_glom_tpus_over_1000_keys(self, tmp_path, fraction):
        keys = [f"key-{i}" for i in range(1000)]
        sides = {}
        for side, make in (("ours", _engine), ("theirs", _jax_engine)):
            d = _ckpt(tmp_path, f"ckpt-{side}")
            eng = make(d)
            try:
                _save_step(d, 7, seed=1)
                assert eng.deploy.begin_canary(fraction=fraction, step=7) == 7
                sides[side] = [eng.deploy.assign(k) for k in keys]
                assert eng.deploy.assign(None) is None
            finally:
                eng.shutdown(drain=False)
        assert sides["ours"] == sides["theirs"]
        share = sum(v is not None for v in sides["ours"]) / len(keys)
        assert abs(share - fraction) < 0.1

    def test_canary_group_replays_the_candidates_set(self, tmp_path):
        d = _ckpt(tmp_path)
        eng = _engine(d)
        try:
            _save_step(d, 2, seed=1)
            assert eng.deploy.begin_canary(fraction=0.5, step=2) == 2
            x = _imgs(1)
            f_primary = eng.submit("embed", x)
            f_canary = eng.submit("embed", x, version=eng.deploy.candidate_step)
            _pump(eng)
            out_p, out_c = f_primary.result(timeout=10), f_canary.result(timeout=10)
            assert not np.allclose(out_p, out_c)
            cand = eng.models.get(DEFAULT_MODEL, 2)
            np.testing.assert_array_equal(out_c, cand.caches.caches["embed"].eager(cand.params, x))
            np.testing.assert_array_equal(out_p, eng.run_eager("embed", x))
            assert eng.registry.snapshot()["deploy_canary_requests"] == 1
            assert _captures(eng) == 0
        finally:
            eng.shutdown(drain=False)

    def test_inflight_canary_items_survive_rollback(self, tmp_path):
        d = _ckpt(tmp_path)
        eng = _engine(d)
        try:
            _save_step(d, 2, seed=1)
            assert eng.deploy.begin_canary(fraction=0.5, step=2) == 2
            fut = eng.submit("embed", _imgs(1), version=2)
            assert eng.deploy.abort() is True      # retired before it runs
            _pump(eng)
            np.testing.assert_array_equal(fut.result(timeout=10), eng.run("embed", _imgs(1)))
        finally:
            eng.shutdown(drain=False)

    def test_session_never_straddles_versions(self, tmp_path):
        """A session with state stays on the version that computed it; a
        rollback restarts the candidate's sessions cold (version_retired)."""
        d = _ckpt(tmp_path)
        eng = _engine(d, warm_iters=2)
        try:
            _save_step(d, 2, seed=1)
            x = _imgs(1)
            _, info0 = eng.session_embed("sess-0", x)
            assert info0["step"] == 0
            assert eng.deploy.begin_canary(fraction=1.0, step=2) == 2
            _, info1 = eng.session_embed("sess-0", x)
            assert info1["step"] == 0 and "canary_step" not in info1
            _, info2 = eng.session_embed("sess-1", x)
            assert info2["step"] == 2 and info2["canary_step"] == 2
            _, info3 = eng.session_embed("sess-1", x)
            assert info3["step"] == 2 and not info3["cold"]
            assert _captures(eng) == 0
            eng.deploy.rollback(reason="operator")
            _, info4 = eng.session_embed("sess-1", x)
            assert info4["step"] == 0 and info4["cold"]
            assert info4["restart"] == "version_retired"
            _, info5 = eng.session_embed("sess-0", x)
            assert info5["step"] == 0 and not info5["cold"]
        finally:
            eng.shutdown(drain=False)

    def test_candidate_delay_fault_is_latency_never_an_error(self, tmp_path):
        d = _ckpt(tmp_path)
        slept = []
        eng = _engine(d, sleep=slept.append)
        try:
            _save_step(d, 2, seed=1)
            assert eng.deploy.begin_canary(fraction=1.0, step=2) == 2
            with faultinject.injected("candidate:delay"):
                fut = eng.submit("embed", _imgs(1), version=2)
                _pump(eng)
                assert fut.result(timeout=10).shape == (1, TINY.levels, TINY.dim)
            assert slept == [eng.deploy.fault_delay_s]
        finally:
            eng.shutdown(drain=False)


# -- auto actions ----------------------------------------------------------------

def _burn_slo(parse):
    return [parse("p95<100ms", short_window_s=5.0, long_window_s=10.0, min_events=4,
                  burn_threshold=2.0)]


def _deploy_pair(tmp_path, clock_ours, clock_theirs, slos=True):
    common = dict(deploy_promote_after=2, deploy_window_s=5.0, deploy_min_events=4)
    d, d2 = _ckpt(tmp_path), _ckpt(tmp_path, "ckpt-theirs")
    ours = _engine(d, clock=clock_ours, slos=_burn_slo(parse_slo) if slos else None, **common)
    theirs = _jax_engine(d2, clock=clock_theirs,
                         slos=_burn_slo(jax_parse_slo) if slos else None, **common)
    _save_step(d, 2, seed=1)
    _save_step(d2, 2, seed=1)
    return ours, theirs


class TestAutoActions:
    @pytest.mark.parametrize("outcomes,action,slos", [
        ([(1.1, 5.0, False)] * 12, "promoted", True),
        ([(0.1, 500.0, False)] * 6, "rolled_back", True),
        ([(1.1, 5.0, False)] * 5 + [(0.1, 999.0, False)] * 5, "rolled_back", True),
        # no SLOs: the default errors<2% guardrail retreats from an error storm
        ([(0.01, None, True)] * 12, "rolled_back", False),
    ])
    def test_promote_and_rollback_at_glom_tpus_event_index(self, tmp_path, outcomes, action,
                                                           slos):
        """The same canary outcomes under the same fake clock settle both
        controllers at the same event, the same way."""
        clocks = FakeClock(), FakeClock()
        engines = _deploy_pair(tmp_path, *clocks, slos=slos)
        settled = {}
        try:
            for side, eng, clock in zip(("ours", "theirs"), engines, clocks):
                assert eng.deploy.begin_canary(fraction=0.5, step=2) == 2
                for i, (dt, latency, error) in enumerate(outcomes):
                    clock.advance(dt)
                    eng.deploy.observe_candidate("embed", latency, error, trace_id=f"t-{i}")
                    if eng.deploy.phase == "idle":
                        settled[side] = (i, eng.deploy.last_report["action"], eng.step)
                        break
        finally:
            for eng in engines:
                eng.shutdown(drain=False)
        assert settled["ours"] == settled["theirs"]
        assert settled["ours"][1] == action

    def test_clean_windows_promote_keeps_the_rollback_point(self, tmp_path):
        clock = FakeClock()
        d = _ckpt(tmp_path)
        eng = _engine(d, clock=clock, slos=_burn_slo(parse_slo), deploy_promote_after=2,
                      deploy_window_s=5.0, deploy_min_events=4)
        try:
            _save_step(d, 2, seed=1)
            assert eng.deploy.begin_canary(fraction=0.5, step=2) == 2
            cand_set = eng.deploy.candidate(2).caches
            made = compile_cache.captures_made()
            for _ in range(10):
                clock.advance(1.1)
                eng.deploy.observe_candidate("embed", 5.0, False)
            assert eng.deploy.last_report["action"] == "promoted"
            # the candidate's set now serves: nothing restored, nothing captured
            assert eng.serving is cand_set and eng.step == 2
            assert compile_cache.captures_made() == made
            primary = eng.models.get(DEFAULT_MODEL)
            assert primary.step == 2 and primary.role == "primary"
            assert len(eng.models.versions(DEFAULT_MODEL)) == 1
            assert eng.rollback() == 0
            assert eng.models.get(DEFAULT_MODEL).step == 0
        finally:
            eng.shutdown(drain=False)

    def test_terminal_transition_resets_gauges(self, tmp_path):
        d = _ckpt(tmp_path)
        eng = _engine(d)
        try:
            _save_step(d, 2, seed=1)
            eng.deploy.begin_canary(fraction=0.5, step=2)
            assert eng.registry.snapshot()["deploy_phase"] == 2
            eng.deploy.abort()
            snap = eng.registry.snapshot()
            assert (snap["deploy_phase"], snap["deploy_candidate_step"],
                    snap["deploy_clean_windows"]) == (0, -1, 0)
        finally:
            eng.shutdown(drain=False)

    def test_tenant_scoped_candidate_slo(self, tmp_path):
        clock = FakeClock()
        d = _ckpt(tmp_path)
        eng = _engine(d, clock=clock, slos=[parse_slo(
            "acme/p95<100ms", short_window_s=5.0, long_window_s=10.0, min_events=4,
            burn_threshold=2.0)])
        try:
            _save_step(d, 2, seed=1)
            assert eng.deploy.begin_canary(fraction=0.5, step=2) == 2
            for _ in range(6):
                clock.advance(0.1)
                eng.deploy.observe_candidate("embed", 900.0, False, tenant="beta")
            assert eng.deploy.phase == "canary"
            for _ in range(4):
                clock.advance(0.1)
                eng.deploy.observe_candidate("embed", 900.0, False, tenant="acme")
            assert eng.deploy.phase == "idle"
        finally:
            eng.shutdown(drain=False)

    def test_orphan_canary_outcome_feeds_nobody(self, tmp_path):
        clock = FakeClock()
        d = _ckpt(tmp_path)
        eng = _engine(d, clock=clock, slos=_burn_slo(parse_slo))
        try:
            _save_step(d, 2, seed=1)
            eng.deploy.begin_canary(fraction=0.5, step=2)
            eng.deploy.abort()
            for _ in range(10):
                clock.advance(0.1)
                eng.observe_outcome("embed", 900.0, False, version=2)
            assert all(len(ev._short) == 0 for ev in eng._slo.evaluators)
            eng.observe_outcome("embed", 5.0, False)
            assert sum(len(ev._short) for ev in eng._slo.evaluators) == 1
        finally:
            eng.shutdown(drain=False)


# -- extra models ----------------------------------------------------------------

@pytest.fixture()
def two_models(tmp_path):
    d, d2 = _ckpt(tmp_path), _ckpt(tmp_path, "alt", seed=5)
    eng = ServingEngine(d, device="cpu", buckets=(1, 2), max_wait_ms=1.0, reload_poll_s=0,
                        extra_models={"alt": d2})
    eng.start(watch=False)
    server = make_server(eng)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = "http://{}:{}".format(*server.server_address[:2])
    yield url, eng, d2
    server.shutdown()
    server.server_close()
    eng.shutdown(drain=False)


def _post(url, path, payload, headers=None):
    req = urllib.request.Request(f"{url}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _post_code(url, path, payload, headers=None):
    try:
        return 200, _post(url, path, payload, headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class TestExtraModels:
    def test_model_field_serves_the_extra_model_as_glom_tpu_does(self, two_models):
        url, eng, d2 = two_models
        x = _imgs(2, seed=4)
        resp = _post(url, "/embed", {"images": x.tolist(), "model": "alt"})
        assert resp["model"] == "alt" and resp["step"] == 0
        assert eng.registry.snapshot()["serving_model_requests_alt"] == 2
        alt = eng.models.get("alt")
        np.testing.assert_array_equal(np.asarray(resp["embeddings"], np.float32),
                                      alt.caches.caches["embed"].eager(alt.params, x))
        theirs = _jax_engine(d2)
        try:
            want = np.asarray(theirs.caches["embed"](theirs.params, x))
        finally:
            theirs.shutdown(drain=False)
        np.testing.assert_allclose(resp["embeddings"], want, rtol=1e-5, atol=1e-6)
        primary = _post(url, "/embed", {"images": x.tolist()})
        assert not np.allclose(primary["embeddings"], resp["embeddings"])

    def test_unknown_model_is_400(self, two_models):
        url, _, _ = two_models
        code, body = _post_code(url, "/embed", {"images": _imgs(1).tolist(), "model": "nope"})
        assert code == 400 and "unknown model" in body["error"]

    def test_extra_model_never_canaries_and_health_lists_it(self, two_models):
        url, eng, _ = two_models
        with urllib.request.urlopen(f"{url}/healthz", timeout=10) as r:
            h = json.loads(r.read())
        assert h["models"]["models"] == ["alt", "default"]
        assert h["deploy"]["phase"] == "idle"
        assert [v["role"] for v in h["models"]["resident"]] == ["primary", "primary"]

    def test_extra_model_name_may_not_be_default(self, tmp_path):
        d = _ckpt(tmp_path)
        with pytest.raises(ValueError, match="collides"):
            ServingEngine(d, device="cpu", reload_poll_s=0, warmup=False,
                          extra_models={"default": d})


# -- HTTP deploy admin -----------------------------------------------------------

def _serve(eng):
    eng.start(watch=False)
    from glom_tpu.serving.server import make_server as jax_make_server

    server = (make_server if isinstance(eng, ServingEngine) else jax_make_server)(eng)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, "http://{}:{}".format(*server.server_address[:2])


def _strip(body):
    return {k: v for k, v in body.items() if k not in ("t", "last")} if isinstance(
        body, dict) else body


class TestHTTPDeployAdmin:
    def test_admin_codes_and_bodies_match_glom_tpu(self, tmp_path):
        replies = {}
        for side in ("ours", "theirs"):
            d = _ckpt(tmp_path, f"ckpt-{side}")
            eng = (ServingEngine(d, device="cpu", buckets=(1, 2), max_wait_ms=1.0,
                                 reload_poll_s=0) if side == "ours" else
                   JaxServingEngine(d, buckets=(1, 2), max_wait_ms=1.0, reload_poll_s=0,
                                    warmup=False))
            server, url = _serve(eng)
            _save_step(d, 2, seed=1)
            _save_step(d, 3, seed=2)
            try:
                calls = [("shadow", {"step": 2}), ("shadow", {"step": 3}), ("status", {}),
                         ("canary", {"fraction": 0.25}), ("canary", {"fraction": 2.0}),
                         ("rollback", {"reason": "operator"}), ("rollback", {}),
                         ("promote", {}), ("abort", {}), ("shadow", {"step": 0}),
                         ("shadow", {"step": 3}), ("promote", {}), ("nope", {})]
                replies[side] = [(a,) + tuple(_strip(x) for x in _post_code(
                    url, f"/admin/deploy/{a}", p)) for a, p in calls]
                with urllib.request.urlopen(f"{url}/admin/deploy/status", timeout=10) as r:
                    replies[side].append(_strip(json.loads(r.read())))
                replies[side].append(eng.step)
            finally:
                server.shutdown()
                server.server_close()
                eng.shutdown(drain=False)
        assert replies["ours"] == replies["theirs"]
        assert [r[1] for r in replies["ours"][:13]] == [200, 409, 200, 200, 409, 200, 409, 409,
                                                         200, 200, 200, 200, 404]
        assert replies["ours"][9][2]["candidate_step"] is None   # nothing to deploy
        assert replies["ours"][-1] == 3

    def test_canary_step_names_the_version_that_answered(self, tmp_path):
        d = _ckpt(tmp_path)
        eng = ServingEngine(d, device="cpu", buckets=(1, 2), max_wait_ms=1.0, reload_poll_s=0)
        server, url = _serve(eng)
        try:
            _save_step(d, 2, seed=1)
            _post(url, "/admin/deploy/canary", {"fraction": 0.5, "step": 2})
            x = _imgs(1)
            steps = {}
            for i in range(24):
                key = f"k-{i}"
                body = _post(url, "/embed", {"images": x.tolist()}, {"X-Affinity-Key": key})
                steps[key] = body["step"]
                want = 2 if eng.deploy.assign(key) == 2 else 0
                assert body["step"] == want
            assert set(steps.values()) == {0, 2}
            assert eng.registry.snapshot()["deploy_canary_requests"] == sum(
                s == 2 for s in steps.values())
            _post(url, "/admin/deploy/rollback", {})
            assert _post(url, "/embed", {"images": x.tolist()},
                         {"X-Affinity-Key": "k-0"})["step"] == 0
        finally:
            server.shutdown()
            server.server_close()
            eng.shutdown(drain=False)

    def test_health_deploy_and_models_match_glom_tpu(self, tmp_path):
        health = {}
        for side, make in (("ours", _engine), ("theirs", _jax_engine)):
            d = _ckpt(tmp_path, f"ckpt-{side}")
            eng = make(d, deploy_promote_after=2, deploy_window_s=3.0, deploy_min_events=4,
                       deploy_canary_fraction=0.3)
            try:
                _save_step(d, 2, seed=1)
                eng.deploy.begin_shadow(step=2)
                h = eng.health()
                models = [{k: v for k, v in r.items() if k != "loaded_at"}
                          for r in h["models"]["resident"]]
                health[side] = (h["deploy"], models, h["models"]["models"])
            finally:
                eng.shutdown(drain=False)
        assert health["ours"] == health["theirs"]
        assert health["ours"][0]["phase"] == "shadow"


class TestShadowLatencyInvariant:
    def test_primary_p95_unmoved_by_shadow(self, tmp_path):
        """The CPU form: the same closed-loop drive with and without a
        shadow; the bounded, lossy mirror keeps the primary's p95 in its
        envelope."""
        d = _ckpt(tmp_path)
        eng = ServingEngine(d, device="cpu", buckets=(1, 2), max_wait_ms=1.0, reload_poll_s=0)
        server, url = _serve(eng)
        payload = {"images": _imgs(1).tolist()}

        def drive(n):
            lats = []
            for _ in range(n):
                t0 = time.monotonic()
                _post(url, "/embed", payload)
                lats.append((time.monotonic() - t0) * 1e3)
            return sorted(lats)

        try:
            drive(5)
            base = drive(30)
            _save_step(d, 2, seed=1)
            assert eng.deploy.begin_shadow(step=2) == 2
            shadowed = drive(30)

            def p95(xs):
                return xs[int(0.95 * (len(xs) - 1))]

            assert p95(shadowed) <= max(3.0 * p95(base), p95(base) + 250.0), (
                p95(base), p95(shadowed))
            assert eng.registry.snapshot().get("deploy_shadow_requests", 0) >= 1
            assert _captures(eng) == 0
        finally:
            server.shutdown()
            server.server_close()
            eng.shutdown(drain=False)


def test_a_router_pinned_promote_commits_the_resident_set(tmp_path):
    """glom_tpu's FleetRouter fronts a port replica; a promote with
    ``deploy_pin_url`` commits through the router's ``/rollout``: the
    replica stages the resident candidate set (nothing restored, nothing
    captured) and the registry adopts its record."""
    from glom_tpu.serving.router import FleetRouter, make_router_server

    d = _ckpt(tmp_path)
    eng = ServingEngine(d, device="cpu", buckets=(1, 2), max_wait_ms=1.0, reload_poll_s=0)
    server, url = _serve(eng)
    router = FleetRouter([url], health_interval_s=0.2)
    router.start()
    rsrv = make_router_server(router)
    threading.Thread(target=rsrv.serve_forever, daemon=True).start()
    rurl = "http://{}:{}".format(*rsrv.server_address[:2])
    try:
        eng.deploy.pin_url = rurl
        _save_step(d, 2, seed=1)
        assert eng.deploy.begin_canary(fraction=0.5, step=2) == 2
        cand_set = eng.deploy.candidate(2).caches
        made = compile_cache.captures_made()
        report = eng.deploy.promote()
        assert report["fleet_pin"]["ok"], report
        assert report["fleet_pin"]["status"] == "committed"
        assert eng.step == 2 and eng.serving is cand_set
        assert compile_cache.captures_made() == made
        assert eng.models.get(DEFAULT_MODEL).step == 2
        assert len(eng.models.versions(DEFAULT_MODEL)) == 1
        assert _post(rurl, "/embed", {"images": _imgs(1).tolist()})["step"] == 2
    finally:
        router.shutdown()
        rsrv.shutdown()
        rsrv.server_close()
        server.shutdown()
        server.server_close()
        eng.shutdown(drain=False)
