"""Chaos scenario suite for the port: the port's copy of ``tools/chaos.py``.

Each scenario arms a deterministic
:class:`~glom_tpu_torch.resilience.faultinject.FaultPlan` against a tiny
train or serve loop and asserts that the system heals: training resumes
from the newest checkpoint that verifies, quarantine and telemetry fire, the
serving watcher outlives its faults, the router fails over and re-admits, a
bad deploy rolls back, a bulk job stays invisible to online traffic and
resumes bitwise.  Each reports its outcome and MTTR (wall seconds from the
fault's first observable impact to restored service) as JSON.

    python -m glom_tpu_torch.tools.chaos --smoke          # fast variants
    python -m glom_tpu_torch.tools.chaos                  # soak variants
    python -m glom_tpu_torch.tools.chaos --scenario nan_batch --json out.json
    python -m glom_tpu_torch.tools.chaos --smoke --device cpu

Everything a scenario builds (the trainers, the serving engines behind the
router) runs on ``--device``: ``cuda`` unless the caller names ``cpu`` (then
with one intra-op thread, beside the scenarios' many host threads), and
without a card ``cuda`` exits 1 with no scenario run.  The loops are
``glom_tpu``'s (``GlomConfig(dim=8, levels=2, image_size=8, patch_size=4)``
for training, ``make_demo_checkpoint``'s 16-wide demo model for serving),
both on the plain ops, as ``glom_tpu``'s defaults (``"dense"``) run them.

``glom_tpu``'s three elastic scenarios (``host_preempt``,
``coordinator_loss``, ``shrink_restart``) keep their names in
:data:`SCENARIOS`; they need ``resilience/elastic.py`` and the elastic
meshes of ``parallel/mesh.py``, which the port does not have yet, so naming
one exits 2 and the default run is the other eleven.

The last line of standard output is ``{"mode", "recovered", "total"}``;
the exit code is 0 iff every selected scenario recovered.
"""

from __future__ import annotations

import argparse
import hashlib
import http.client
import json
import os
import random
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
import warnings

import numpy as np

# -- tiny shared shapes (every scenario reuses them) -----------------------


def _configs(steps, *, halt_on_nan=False, forensics_dir=None, checkpoint_dir=None):
    from glom_tpu_torch.config import GlomConfig, TrainConfig

    glom = GlomConfig(dim=8, levels=2, image_size=8, patch_size=4)
    train = TrainConfig(
        batch_size=8, steps=steps, log_every=1, checkpoint_every=1,
        checkpoint_dir=checkpoint_dir, halt_on_nan=halt_on_nan,
        forensics_dir=forensics_dir, forensics_hlo=False,
        forensics_step_time_factor=0.0,
    )
    return glom, train


_DEVNULL = None


def _devnull():
    """The one lazily opened /dev/null sink every quiet logger shares."""
    global _DEVNULL
    if _DEVNULL is None:
        _DEVNULL = open(os.devnull, "w")
    return _DEVNULL


def _quiet_trainer(glom, train, device):
    """A Trainer on ``device`` whose JSONL log goes to /dev/null: the
    harness's stdout is the scenario JSON, not training telemetry."""
    from glom_tpu_torch.training.metrics import MetricLogger
    from glom_tpu_torch.training.trainer import Trainer

    return Trainer(glom, train, device=device, logger=MetricLogger(stream=_devnull()))


def _batches(glom, train):
    from glom_tpu_torch.training.data import make_batches

    return make_batches("synthetic", train.batch_size, glom.image_size, glom.channels, seed=0)


def _fit_once(glom, train, device, steps=None):
    """One fresh Trainer and synthetic stream driven to completion; returns
    ``(trainer, final_step)``."""
    trainer = _quiet_trainer(glom, train, device)
    batches = _batches(glom, train)
    try:
        trainer.fit(batches, steps=steps)
    finally:
        close = getattr(batches, "close", None)
        if callable(close):
            close()
    return trainer, int(trainer.state.step)


def _flip_mid_byte(path):
    """Bit rot: flip one byte in the middle of ``path``."""
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def _resave(ckpt_dir, step, engine):
    """The engine's serving weights saved again as a newer ``step``."""
    from glom_tpu_torch import checkpoint as ckpt_lib

    ckpt_lib.save(ckpt_dir, step,
                  {"params": ckpt_lib.load_tree(ckpt_dir, int(engine.step), "params")})


def _serve(engine):
    """An HTTP server for ``engine`` on a free port, serving on a daemon
    thread; ``(server, url)``."""
    from glom_tpu_torch.serving.server import make_server

    srv = make_server(engine)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, "http://{}:{}".format(*srv.server_address[:2])


def _front(urls, **kw):
    """A started FleetRouter over ``urls`` and its HTTP server:
    ``(router, server, url)``."""
    from glom_tpu_torch.serving.router import FleetRouter, make_router_server

    router = FleetRouter(urls, **kw)
    router.start()
    rsrv = make_router_server(router)
    threading.Thread(target=rsrv.serve_forever, daemon=True).start()
    return router, rsrv, "http://{}:{}".format(*rsrv.server_address[:2])


def _close(srv):
    srv.shutdown()
    srv.server_close()


def _admin(url):
    """``admin(action, payload)``: a POST to ``url``/admin/deploy/<action>."""
    def admin(action, payload=None):
        req = urllib.request.Request(
            f"{url}/admin/deploy/{action}", data=json.dumps(payload or {}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())
    return admin


def _embed_body(rng=None):
    img = (np.zeros((1, 3, 16, 16), np.float32) if rng is None
           else rng.randn(1, 3, 16, 16).astype(np.float32))
    return json.dumps({"images": img.tolist()}).encode()


# -- train and reload scenarios ---------------------------------------------

def scenario_torn_ckpt_write(soak, device):
    """A torn (half-written) checkpoint artifact: the resume after it must
    quarantine the torn step and fall back to the previous verified one."""
    from glom_tpu_torch.resilience import faultinject, integrity

    steps1, steps2 = (2, 5) if not soak else (4, 12)
    with tempfile.TemporaryDirectory() as root:
        ckpt_dir = os.path.join(root, "ckpt")
        fdir = os.path.join(root, "forensics")
        glom, train = _configs(steps1, checkpoint_dir=ckpt_dir, forensics_dir=fdir)
        with faultinject.injected(f"ckpt_write:torn@step{steps1}"):
            _fit_once(glom, train, device)   # the final save of step `steps1` is torn
        assert integrity.latest_valid_step(ckpt_dir, quarantine_corrupt=False) == steps1 - 1
        t0 = time.monotonic()
        glom, train = _configs(steps2, checkpoint_dir=ckpt_dir, forensics_dir=fdir)
        trainer, final = _fit_once(glom, train, device)
        mttr = time.monotonic() - t0
        snap = trainer.registry.snapshot()
        assert final == steps2, f"resumed run stopped at {final}"
        assert snap.get("ckpt_corrupt_total") == 1, snap.get("ckpt_corrupt_total")
        corrupt = [f for f in os.listdir(ckpt_dir) if f.endswith(".corrupt")]
        assert corrupt, "torn artifact was not quarantined"
        bundles = [d for d in os.listdir(fdir) if d.startswith("ckpt_corrupt-")]
        assert len(bundles) == 1, f"expected 1 debounced bundle, got {bundles}"
        return {"mttr_s": mttr, "resumed_from": steps1 - 1, "completed_step": final}


def scenario_corrupt_restore(soak, device):
    """Bytes go bad on disk after a clean save (bit rot, a partial media
    failure): restore quarantines and falls back; the ckpt_corrupt trigger
    fires exactly once."""
    from glom_tpu_torch import checkpoint as ckpt_lib
    from glom_tpu_torch.resilience import integrity

    steps1, steps2 = (2, 5) if not soak else (4, 12)
    with tempfile.TemporaryDirectory() as root:
        ckpt_dir = os.path.join(root, "ckpt")
        fdir = os.path.join(root, "forensics")
        glom, train = _configs(steps1, checkpoint_dir=ckpt_dir, forensics_dir=fdir)
        _fit_once(glom, train, device)
        _flip_mid_byte(ckpt_lib.npz_path(ckpt_dir, steps1))
        t0 = time.monotonic()
        glom, train = _configs(steps2, checkpoint_dir=ckpt_dir, forensics_dir=fdir)
        trainer, final = _fit_once(glom, train, device)
        mttr = time.monotonic() - t0
        snap = trainer.registry.snapshot()
        assert final == steps2, f"resumed run stopped at {final}"
        assert snap.get("ckpt_corrupt_total") == 1
        assert integrity.latest_valid_step(ckpt_dir) == steps2
        bundles = [d for d in os.listdir(fdir) if d.startswith("ckpt_corrupt-")]
        assert len(bundles) == 1, f"expected 1 debounced bundle, got {bundles}"
        return {"mttr_s": mttr, "resumed_from": steps1 - 1, "completed_step": final}


def _supervised(glom, train, device, ckpt_dir, fault_spec, failure):
    """Run a Trainer under the Supervisor with ``fault_spec`` armed; the
    time of the first ``failure`` exception is the fault's impact.
    Returns ``(supervisor, trainers, impact times)``."""
    from glom_tpu_torch.resilience import faultinject
    from glom_tpu_torch.resilience.supervisor import RestartPolicy, Supervisor

    trainers, fail_t = [], []

    def fit_fn():
        trainer = _quiet_trainer(glom, train, device)
        trainers.append(trainer)
        batches = _batches(glom, train)
        try:
            return trainer.fit(batches)
        except failure:
            fail_t.append(time.monotonic())
            raise
        finally:
            batches.close()

    sup = Supervisor(fit_fn, checkpoint_dir=ckpt_dir,
                     policy=RestartPolicy(max_failures=3, window_s=300.0,
                                          backoff_base_s=0.01, backoff_max_s=0.05))
    with faultinject.injected(fault_spec):
        sup.run()
    return sup, trainers, fail_t


def scenario_nan_batch(soak, device):
    """A poisoned (all-NaN) batch: halt_on_nan fails the run before the
    poisoned params reach a checkpoint; the supervisor restarts from the
    last clean step and the one-shot fault does not fire again."""
    from glom_tpu_torch.training.trainer import NonFiniteError

    steps, nan_at = (6, 4) if not soak else (16, 9)
    with tempfile.TemporaryDirectory() as root:
        ckpt_dir = os.path.join(root, "ckpt")
        glom, train = _configs(steps, checkpoint_dir=ckpt_dir, halt_on_nan=True)
        sup, trainers, fail_t = _supervised(glom, train, device, ckpt_dir,
                                            f"data:nan_batch@{nan_at}", NonFiniteError)
        mttr = time.monotonic() - fail_t[0] if fail_t else 0.0
        final = int(trainers[-1].state.step)
        assert sup.restarts == 1, f"expected exactly 1 restart, got {sup.restarts}"
        assert final == steps, f"supervised run stopped at {final}"
        snap = trainers[0].registry.snapshot()
        assert snap.get("nan_windows", 0) >= 1, "NaN was never detected"
        return {"mttr_s": mttr, "restarts": sup.restarts, "completed_step": final}


def scenario_reload_io_error(soak, device):
    """Transient I/O errors on the serving hot-reload poll: bounded
    retry-with-backoff keeps the watcher alive, /healthz never degrades,
    and the swap lands once the filesystem recovers."""
    from glom_tpu_torch.resilience import faultinject
    from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint

    n_faults = 6 if not soak else 24
    with tempfile.TemporaryDirectory() as root:
        make_demo_checkpoint(root)
        engine = ServingEngine(root, buckets=(1,), warmup=False, reload_poll_s=0,
                               sleep=lambda s: None, device=device)
        try:
            t0 = time.monotonic()
            with faultinject.injected(f"reload:io_error*{n_faults}") as plan:
                polls = 0
                while any(f.fired < f.count for f in plan.faults):
                    assert engine.check_reload() is False
                    assert engine.health()["status"] == "ok"
                    polls += 1
                    assert polls <= n_faults + 2, "faults never exhausted"
            failures = engine.registry.counter("serving_reload_failures").value
            assert failures == n_faults, (failures, n_faults)
            # the filesystem recovers: a newer checkpoint lands and swaps in
            _resave(root, 1, engine)
            assert engine.check_reload() is True
            mttr = time.monotonic() - t0
            assert engine.step == 1
            assert engine.health()["status"] == "ok"
        finally:
            engine.shutdown(drain=False)
        return {"mttr_s": mttr, "reload_failures": int(failures),
                "served_step": int(engine.step)}


def scenario_train_crash(soak, device):
    """The data pipeline crashes mid-run: the supervisor restarts with
    backoff, auto-resume continues from the last checkpoint, and the run
    completes."""
    from glom_tpu_torch.resilience import faultinject

    steps, crash_at = (5, 3) if not soak else (14, 7)
    with tempfile.TemporaryDirectory() as root:
        ckpt_dir = os.path.join(root, "ckpt")
        glom, train = _configs(steps, checkpoint_dir=ckpt_dir)
        sup, trainers, fail_t = _supervised(glom, train, device, ckpt_dir,
                                            f"data:crash@{crash_at}", faultinject.FaultError)
        mttr = time.monotonic() - fail_t[0] if fail_t else 0.0
        final = int(trainers[-1].state.step)
        assert sup.restarts == 1, f"expected exactly 1 restart, got {sup.restarts}"
        assert final == steps, f"supervised run stopped at {final}"
        return {"mttr_s": mttr, "restarts": sup.restarts, "completed_step": final}


# -- serving scenarios --------------------------------------------------------

class _Load:
    """Client threads posting ``/embed`` to ``url`` until stopped, counting
    answers (``ok``) and client-visible failures (``error``);
    ``on_answer(counts, reply, worker)`` sees each answer under the lock."""

    def __init__(self, url, body, workers, *, headers=None, on_answer=None):
        self.counts = {"ok": 0, "error": 0}
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self._url, self._body, self._headers = url, body, headers
        self._on_answer = on_answer
        self._threads = [threading.Thread(target=self._run, args=(w,), daemon=True)
                         for w in range(workers)]
        for t in self._threads:
            t.start()

    def _run(self, worker):
        i = 0
        while not self.stop.is_set():
            i += 1
            headers = {"Content-Type": "application/json"}
            if self._headers is not None:
                headers.update(self._headers(worker, i))
            req = urllib.request.Request(f"{self._url}/embed", data=self._body, headers=headers)
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    reply = r.read()
                with self.lock:
                    self.counts["ok"] += 1
                    if self._on_answer is not None:
                        self._on_answer(self.counts, reply, worker)
            except Exception:  # glomlint: disable=conc-broad-except -- the client-visible error count IS the scenario's measurement; per-request causes don't matter to MTTR
                with self.lock:
                    self.counts["error"] += 1

    def wait_ok(self, target, timeout):
        """Wait until ``target`` answers have come, at most ``timeout`` s."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self.lock:
                if self.counts["ok"] >= target:
                    return
            time.sleep(0.02)

    def ok(self):
        with self.lock:
            return self.counts["ok"]

    def finish(self):
        """Stop the clients; a copy of the counts."""
        self.stop.set()
        for t in self._threads:
            t.join(timeout=10)
        with self.lock:
            return dict(self.counts)


def scenario_replica_kill(soak, device):
    """One engine replica dies mid-load: the fleet router must eject it
    within one health interval (eject_after=1: a dead box is dead), the
    error rate must stay bounded (connection failures fail over to the
    surviving replicas), and the restarted replica must be re-admitted; MTTR
    is kill to back in rotation."""
    from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
    from glom_tpu_torch.serving.server import make_server

    n_replicas, n_min_requests = (3, 40) if not soak else (4, 400)
    health_interval = 0.2

    def start_replica(ckpt, port=0):
        eng = ServingEngine(ckpt, buckets=(1, 2), max_wait_ms=1.0, warmup=True,
                            reload_poll_s=0, device=device)
        eng.start(watch=False)
        srv = make_server(eng, port=port)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return eng, srv

    with tempfile.TemporaryDirectory() as root:
        make_demo_checkpoint(root)
        members = [start_replica(root) for _ in range(n_replicas)]
        urls = ["http://{}:{}".format(*srv.server_address[:2]) for _, srv in members]
        router, rsrv, rurl = _front(urls, health_interval_s=health_interval, eject_after=1)
        load = _Load(rurl, _embed_body(), 2)
        try:
            load.wait_ok(n_min_requests // 2, 30)
            # kill one replica hard (no drain: a crash, not a deploy)
            victim_eng, victim_srv = members[1]
            victim_port = victim_srv.server_address[1]
            t_kill = time.monotonic()
            _close(victim_srv)
            victim_eng.shutdown(drain=False)
            deadline = time.monotonic() + 10
            while (router.health()["healthy_replicas"] == n_replicas
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            eject_s = time.monotonic() - t_kill
            assert router.health()["healthy_replicas"] == n_replicas - 1, (
                "router never ejected the dead replica")
            # "within one health interval": a 3x margin for scheduling noise;
            # the contract is the order of magnitude
            assert eject_s <= health_interval * 3 + 1.0, eject_s
            # keep load flowing on the survivors, then resurrect
            load.wait_ok(load.ok() + n_min_requests // 2, 30)
            members[1] = start_replica(root, port=victim_port)
            deadline = time.monotonic() + 20
            while (router.health()["healthy_replicas"] < n_replicas
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            mttr = time.monotonic() - t_kill
            assert router.health()["healthy_replicas"] == n_replicas, (
                "restarted replica never re-admitted")
        finally:
            counts = load.finish()
        total, errors = counts["ok"] + counts["error"], counts["error"]
        try:
            assert counts["ok"] >= n_min_requests, counts
            # bounded error rate: failover turns a dead replica into retries,
            # not client-visible failures; a small transient margin
            assert errors / max(total, 1) <= 0.05, counts
            snap = router.registry.snapshot()
            assert snap.get("router_ejections_total", 0) >= 1
            assert snap.get("router_readmissions_total", 0) >= 1
        finally:
            router.shutdown()
            _close(rsrv)
            for eng, srv in members:
                _close(srv)
                eng.shutdown(drain=False)
        return {"mttr_s": mttr, "eject_s": round(eject_s, 3), "requests_ok": counts["ok"],
                "requests_error": errors, "error_rate": round(errors / max(total, 1), 4)}


def _deploy_rig(root, device, **engine_kw):
    """A demo checkpoint, an engine on it behind its HTTP server, and a
    router fronting that server, the engine's deploys pinning the fleet
    through the router: ``(ckpt, fdir, engine, srv, eng_url, router, rsrv,
    rurl)``."""
    from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint

    ckpt = os.path.join(root, "ckpt")
    fdir = os.path.join(root, "forensics")
    make_demo_checkpoint(ckpt)
    engine = ServingEngine(ckpt, buckets=(1, 2), max_wait_ms=1.0, warmup=True, reload_poll_s=0,
                           forensics_dir=fdir, device=device, **engine_kw)
    engine.start(watch=False)
    srv, eng_url = _serve(engine)
    router, rsrv, rurl = _front([eng_url], health_interval_s=0.2)
    # promotes and rollbacks converge the fleet through the router
    engine.deploy.pin_url = rurl
    return ckpt, fdir, engine, srv, eng_url, router, rsrv, rurl


def _teardown_rig(engine, srv, router, rsrv):
    router.shutdown()
    _close(rsrv)
    _close(srv)
    engine.shutdown(drain=False)


def _wait_bundle(fdir, prefix, timeout=10.0):
    """The forensics bundles named ``prefix``*, waited for: a rollback
    counter ticks before its bundle's write lands."""
    deadline = time.monotonic() + timeout
    bundles = []
    while time.monotonic() < deadline:
        if os.path.isdir(fdir):
            bundles = [d for d in os.listdir(fdir) if d.startswith(prefix)]
            if bundles:
                break
        time.sleep(0.05)
    return bundles


# canary_regression's latency objective, the stall injected into each faulty
# candidate batch (deploy.fault_delay_s) and the objective's short and long
# windows: glom_tpu's on the card.  On the CPU the plain forward runs eagerly
# beside the scenario's own client, server and router threads, and on a
# loaded host their scheduling alone holds a healthy batch past 100 ms (up to
# 163 ms under eight suites at once; past 250 ms beside the whole test
# suite), where one slow batch of the first four burns the objective.  There
# the objective is 1 s and the stall 2 s, and the windows widen so that
# they still hold the four faulty batches a burn needs (the stall
# serializes the candidate's batches).
CANARY_SLO = {"cuda": ("p95<100ms", 0.25, 2.0, 4.0), "cpu": ("p95<1000ms", 2.0, 10.0, 20.0)}


def scenario_canary_regression(soak, device):
    """A deliberately bad deploy candidate, twice over: a corrupt candidate
    checkpoint is quarantined at shadow-load and never becomes resident
    (zero exposure); a latency-injected candidate shadows clean, regresses
    under live canary traffic, and the burn-rate auto-rollback retreats,
    with zero client-visible errors (failover and gate semantics through a
    fronting router), the candidate capped at its canary fraction, a
    ``deploy_rollback`` forensics bundle naming the offending traces and
    the before/after version pins, and the fleet pinned back through the
    router's two-phase rollout."""
    from glom_tpu_torch import checkpoint as ckpt_lib
    from glom_tpu_torch.obs.slo import parse_slo
    from glom_tpu_torch.resilience import faultinject

    n_keys, min_requests = (64, 60) if not soak else (256, 400)
    fraction = 0.5
    objective, stall_s, short_s, long_s = CANARY_SLO["cpu" if device == "cpu" else "cuda"]
    with tempfile.TemporaryDirectory() as root:
        ckpt, fdir, engine, srv, eng_url, router, rsrv, rurl = _deploy_rig(
            root, device, slos=[parse_slo(objective, short_window_s=short_s,
                                          long_window_s=long_s, min_events=4,
                                          burn_threshold=2.0)])
        engine.deploy.fault_delay_s = stall_s
        admin = _admin(eng_url)
        try:
            # phase A: a corrupt candidate must abort at load, before traffic
            _resave(ckpt, 1, engine)
            _flip_mid_byte(ckpt_lib.npz_path(ckpt, 1))
            resp = admin("shadow")   # step=None: anchors on the latest VALID step
            assert resp["candidate_step"] is None, resp
            assert engine.deploy.phase == "idle"
            assert [f for f in os.listdir(ckpt) if f.endswith(".corrupt")], (
                "corrupt candidate was not quarantined")

            # phase B: a valid but regressing candidate
            _resave(ckpt, 2, engine)
            canary_on = threading.Event()
            extra = {"canary": 0, "total_canary_window": 0}

            def on_answer(counts, reply, worker):
                if canary_on.is_set():
                    extra["total_canary_window"] += 1
                    if json.loads(reply).get("step") == 2:
                        extra["canary"] += 1

            load = _Load(rurl, _embed_body(), 6, on_answer=on_answer,
                         headers=lambda w, i: {"X-Affinity-Key": f"key-{(w * 7919 + i) % n_keys}"})
            try:
                resp = admin("shadow", {"step": 2})
                assert resp["candidate_step"] == 2, resp
                # shadow evidence accumulates (mirrored, discarded, measured
                # under the candidate only)
                deadline = time.monotonic() + 20
                while time.monotonic() < deadline:
                    if engine.registry.snapshot().get("deploy_shadow_requests", 0) >= 5:
                        break
                    time.sleep(0.02)
                assert engine.registry.snapshot().get("deploy_shadow_requests", 0) >= 5, (
                    "shadow never mirrored")
                assert engine.deploy.phase == "shadow"
                # advance to canary and let healthy candidate traffic flow
                # first (arming the fault while shadow mirrors still drain
                # would burn the shadow evaluators and roll back before the
                # canary phase measured anything)
                canary_on.set()
                resp = admin("canary", {"fraction": fraction})
                assert resp["candidate_step"] == 2, resp
                deadline = time.monotonic() + 20
                while time.monotonic() < deadline:
                    with load.lock:
                        if extra["canary"] >= 3:
                            break
                    time.sleep(0.02)
                with load.lock:
                    assert extra["canary"] >= 1, extra
                # now the candidate regresses mid-canary: every further
                # candidate execute pays injected latency, the short window
                # burns, and the auto-rollback retreats
                with faultinject.injected("candidate:delay*100000"):
                    t_regress = time.monotonic()
                    deadline = time.monotonic() + 30
                    while time.monotonic() < deadline:
                        if engine.registry.snapshot().get("deploy_rollbacks_total", 0) >= 1:
                            break
                        time.sleep(0.02)
                    mttr = time.monotonic() - t_regress
                canary_on.clear()
                snap = engine.registry.snapshot()
                assert snap.get("deploy_rollbacks_total", 0) == 1, "auto-rollback never fired"
                assert engine.deploy.phase == "idle"
                assert engine.step == 0, "primary pin moved during a canary"
                # keep load flowing a moment: post-rollback traffic is all
                # old (the target also covers the request floor below)
                load.wait_ok(max(load.ok() + min_requests // 3, min_requests), 60)
            finally:
                done = load.finish()
            done.update(extra)
            assert done["ok"] >= min_requests, done
            # zero client-visible errors: the regression was latency, the
            # retreat automatic
            assert done["error"] == 0, done
            # the candidate saw live traffic, never more than its canary
            # fraction (binomial slack over n_keys)
            assert done["canary"] >= 1, done
            window = max(done["total_canary_window"], 1)
            assert done["canary"] / window <= fraction + 0.25, done
            # the rollback bundle: offending traces and the before/after pins
            bundles = _wait_bundle(fdir, "deploy_rollback-")
            assert len(bundles) == 1, bundles
            with open(os.path.join(fdir, bundles[0], "manifest.json")) as f:
                detail = json.load(f)["detail"]
            assert detail["pins"] == {"before": 2, "after": 0}, detail
            assert detail["reason"] == "burn_rate", detail
            assert detail["trace_ids"], "bundle names no offending traces"
            assert detail["fleet_pin"]["ok"], detail
            assert os.path.exists(os.path.join(fdir, bundles[0], "deploy_traces.json")), (
                "offending trace spans missing from the bundle")
            # the fleet never pinned to the candidate
            assert router.fleet_step in (None, 0), router.fleet_step
        finally:
            _teardown_rig(engine, srv, router, rsrv)
        return {"mttr_s": mttr, "requests_ok": done["ok"], "requests_error": done["error"],
                "canary_fraction_observed": round(done["canary"] / window, 4),
                "shadow_requests": int(snap.get("deploy_shadow_requests", 0)),
                "rollback_bundle": bundles[0]}


def scenario_quality_regression(soak, device):
    """A fast but wrong deploy candidate: its weights are corrupted at load
    (``candidate_load:bitflip``, fired after integrity verification, so the
    checkpoint verifies clean and the candidate serves quickly and without
    errors; every latency and error SLO stays green).  Only the shadow
    lane's paired quality comparison (per-level cosine divergence against
    the primary's output on the same mirrored batches) can see it: the
    ``divergence`` guardrail burns and the auto-rollback retreats while the
    candidate is still in shadow, before any canary exposure, with zero
    client-visible errors, and the ``deploy_rollback`` bundle names the
    quality SLO that fired."""
    from glom_tpu_torch.obs.slo import parse_slo
    from glom_tpu_torch.resilience import faultinject

    min_requests = 30 if not soak else 150
    with tempfile.TemporaryDirectory() as root:
        # the latency/error SLOs are deliberately loose: they stay green
        # for the whole scenario; quality alone drives the retreat
        ckpt, fdir, engine, srv, eng_url, router, rsrv, rurl = _deploy_rig(
            root, device, quality_sample=1.0,
            slos=[parse_slo("p95<60000ms", short_window_s=2.0, long_window_s=4.0,
                            min_events=4, burn_threshold=2.0)])
        admin = _admin(eng_url)
        try:
            _resave(ckpt, 2, engine)
            load = _Load(rurl, _embed_body(np.random.RandomState(0)), 4)
            reached_canary = False
            try:
                # the candidate's weights are corrupted at load: the
                # checkpoint verifies clean, so quarantine cannot help
                with faultinject.injected("candidate_load:bitflip"):
                    t_fault = time.monotonic()
                    resp = admin("shadow", {"step": 2})
                    assert resp["candidate_step"] == 2, resp
                    deadline = time.monotonic() + 45
                    while time.monotonic() < deadline:
                        reached_canary |= engine.deploy.phase == "canary"
                        if engine.registry.snapshot().get("deploy_rollbacks_total", 0) >= 1:
                            break
                        time.sleep(0.02)
                    mttr = time.monotonic() - t_fault
                snap = engine.registry.snapshot()
                assert snap.get("deploy_rollbacks_total", 0) == 1, (
                    "quality auto-rollback never fired")
                # the point: caught in shadow, zero canary exposure
                assert not reached_canary, (
                    "corrupt candidate reached canary before quality caught it")
                assert engine.deploy.phase == "idle"
                assert engine.step == 0, "primary pin moved during a shadow"
                # the shadow lane measured real divergence past the guardrail
                assert snap.get("deploy_shadow_compared", 0) >= 4, snap
                assert snap.get("deploy_shadow_divergence", 0.0) > 0.2, snap
                # keep load flowing: post-rollback traffic is all primary
                load.wait_ok(min_requests, 60)
            finally:
                done = load.finish()
            assert done["ok"] >= min_requests, done
            # zero client-visible errors: the candidate never served a client
            assert done["error"] == 0, done
            # the rollback bundle blames the quality guardrail, not latency
            bundles = _wait_bundle(fdir, "deploy_rollback-")
            assert len(bundles) == 1, bundles
            with open(os.path.join(fdir, bundles[0], "manifest.json")) as f:
                detail = json.load(f)["detail"]
            assert detail["reason"] == "burn_rate", detail
            assert "divergence" in detail.get("slo", ""), detail
            assert detail["phase_at_rollback"] == "shadow", detail
            assert detail["pins"] == {"before": 2, "after": 0}, detail
            assert router.fleet_step in (None, 0), router.fleet_step
        finally:
            _teardown_rig(engine, srv, router, rsrv)
        return {"mttr_s": mttr, "requests_ok": done["ok"], "requests_error": done["error"],
                "shadow_compared": int(snap.get("deploy_shadow_compared", 0)),
                "shadow_divergence": round(float(snap.get("deploy_shadow_divergence", 0.0)), 4),
                "rollback_bundle": bundles[0]}


# -- bulk, index and attribution scenarios ------------------------------------

def scenario_bulk_preemption(soak, device):
    """An online burst lands while a scavenger-class bulk job is active:
    the bulk tier must be invisible to the online plane (client p95 and the
    shed count match a no-bulk control burst on the same warmed engine, with
    generous margins: the contract is the order of magnitude), the request
    path must capture no graph, and the job must still complete once the
    burst passes (preemption pauses the scavenger, it does not starve it)."""
    from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint

    n_requests, n_threads, total = (60, 3, 400) if not soak else (240, 4, 1600)
    with tempfile.TemporaryDirectory() as root:
        ckpt = os.path.join(root, "ckpt")
        make_demo_checkpoint(ckpt)
        eng = ServingEngine(ckpt, buckets=(1, 4), max_wait_ms=1.0, warmup=True, reload_poll_s=0,
                            bulk_dir=os.path.join(root, "bulk"), device=device)
        eng.start(watch=False)
        img = np.zeros((1, 3, 16, 16), np.float32)
        lock = threading.Lock()

        def burst(latencies):
            def worker(n):
                for _ in range(n):
                    t0 = time.monotonic()
                    eng.submit("embed", img).result(timeout=30)
                    dt = time.monotonic() - t0
                    with lock:
                        latencies.append(dt)
            threads = [threading.Thread(target=worker, args=(n_requests // n_threads,),
                                        daemon=True) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)

        def p95(latencies):
            return sorted(latencies)[int(0.95 * (len(latencies) - 1))]

        def shed():
            return eng.registry.snapshot().get("serving_shed_total", 0.0)

        try:
            # control: the same burst, no bulk job anywhere
            control = []
            shed0 = shed()
            burst(control)
            shed_control = shed() - shed0
            # the scenario: the same burst with an active bulk job
            eng.bulk.submit({"name": "preempt", "dataset": f"synthetic:{total}",
                             "transform": "embed", "seed": 3,
                             "sink": os.path.join(root, "out")})
            t_fault = time.monotonic()
            under_bulk = []
            shed1 = shed()
            burst(under_bulk)
            shed_bulk = shed() - shed1
            mid = eng.bulk.status("preempt")
            # the burst was not starved out by bulk work
            assert len(under_bulk) == len(control) == n_threads * (n_requests // n_threads)
            assert shed_bulk == shed_control, (shed_control, shed_bulk)
            p95_control, p95_bulk = p95(control), p95(under_bulk)
            # "unchanged": 3x + 50 ms, as scheduling noise dwarfs any real
            # signal below that
            assert p95_bulk <= p95_control * 3 + 0.05, (
                f"bulk job degraded online p95: control {p95_control * 1e3:.1f} ms -> "
                f"{p95_bulk * 1e3:.1f} ms")
            # and the job still completes once the burst passes
            deadline = time.monotonic() + 120
            while (eng.bulk.status("preempt")["status"] != "done"
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            mttr = time.monotonic() - t_fault
            st = eng.bulk.status("preempt")
            assert st["status"] == "done", st
            snap = eng.registry.snapshot()
            assert snap.get("serving_graph_captures", 0.0) == 0, snap
            assert snap.get("bulk_slots_total", 0.0) >= total
        finally:
            eng.shutdown(drain=False)
        return {"mttr_s": round(mttr, 3), "p95_control_ms": round(p95_control * 1e3, 2),
                "p95_under_bulk_ms": round(p95_bulk * 1e3, 2), "shed": [shed_control, shed_bulk],
                "job_done_at_burst_end": mid["done"],
                "bulk_slots": snap.get("bulk_slots_total", 0.0),
                "scavenged_slots": snap.get("bulk_scavenged_slots_total", 0.0)}


def scenario_index_rebuild(soak, device):
    """A replica dies midway through a bulk ``index`` build and a survivor
    adopts the same job store: the resumed build must assemble to a bitwise
    identical index (sha256 over every level family) and ``/similar``
    answers over it must equal the uninterrupted control's exactly, with no
    graph captured on the request path, on the victim or the survivor."""
    from glom_tpu_torch.hierarchy.index import assemble_level, level_parts
    from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint

    total = 24 if not soak else 96
    with tempfile.TemporaryDirectory() as root:
        ckpt = os.path.join(root, "ckpt")
        make_demo_checkpoint(ckpt)
        idx_ref = os.path.join(root, "idx_ref")
        idx_out = os.path.join(root, "idx_out")

        def engine(bulk_dir, index_dir=None):
            return ServingEngine(ckpt, buckets=(1, 4), max_wait_ms=0.0, warmup=True,
                                 reload_poll_s=0, bulk_dir=bulk_dir, index_dir=index_dir,
                                 device=device)

        def payload(sink):
            return {"name": "idx", "dataset": f"synthetic:{total}", "transform": "index",
                    "seed": 7, "sink": sink}

        def drain(eng):
            for _ in range(4 * total):
                if eng.bulk.status("idx")["status"] == "done":
                    return
                if eng.bulk.run_idle_once() == 0:
                    time.sleep(0.005)
            raise AssertionError(f"index job never drained: {eng.bulk.status('idx')}")

        def level_hashes(idx_dir, levels):
            return {level: hashlib.sha256(np.ascontiguousarray(
                assemble_level(idx_dir, level, total=total)).tobytes()).hexdigest()
                for level in range(levels)}

        # control: an uninterrupted build and the reference /similar answers
        ctrl = engine(os.path.join(root, "store_ref"), idx_ref)
        try:
            levels = ctrl.config.levels
            ctrl.bulk.submit(payload(idx_ref))
            drain(ctrl)
            ref_hashes = level_hashes(idx_ref, levels)
            imgs = np.random.RandomState(11).randn(
                2, ctrl.config.channels, ctrl.config.image_size,
                ctrl.config.image_size).astype(np.float32)
            ref_answers = [ctrl.similar(imgs, level=level, k=5)[0] for level in range(levels)]
            assert ctrl.registry.snapshot().get("serving_graph_captures", 0.0) == 0
        finally:
            ctrl.shutdown(drain=False)

        # the fault: kill the owner mid-build
        store = os.path.join(root, "store_shared")
        victim = engine(store)
        try:
            victim.bulk.submit(payload(idx_out))
            # two committed chunks: mid-job, durably past zero
            while victim.bulk.status("idx")["done"] < 8:
                victim.bulk.run_idle_once()
            done_at_kill = victim.bulk.status("idx")["done"]
            assert victim.registry.snapshot().get("serving_graph_captures", 0.0) == 0
        finally:
            victim.shutdown(drain=False)   # the kill: no drain, no goodbye
        t_fault = time.monotonic()
        assert 0 < done_at_kill < total, done_at_kill

        # recovery: a survivor adopts the same store and finishes
        survivor = engine(store, idx_out)
        try:
            drain(survivor)
            mttr = time.monotonic() - t_fault
            got_hashes = level_hashes(idx_out, levels)
            assert got_hashes == ref_hashes, (
                f"resumed index differs from the uninterrupted build: {got_hashes} != "
                f"{ref_hashes}")
            got_answers = [survivor.similar(imgs, level=level, k=5)[0] for level in range(levels)]
            assert got_answers == ref_answers, (
                f"/similar answers moved after resume: {got_answers} != {ref_answers}")
            assert survivor.registry.snapshot().get("serving_graph_captures", 0.0) == 0
            chunk_count = len(level_parts(idx_out, 0))
        finally:
            survivor.shutdown(drain=False)
        return {"mttr_s": round(mttr, 3), "slots": total, "done_at_kill": done_at_kill,
                "level_chunks": chunk_count, "levels_verified": levels}


def scenario_slow_deploy_attribution(soak, device):
    """A deliberately slow deploy candidate at full canary fraction, and the
    attribution plane on the hook for the verdict: after a healthy baseline
    window and a regressed window, ``attribute()`` must name the deploy
    event (``deploy_canary``, the injected step) as the top cause and assign
    most of the latency delta to ``queue_wait`` (the injected stall
    serializes the flush loop, so trailing requests pay it as queue time),
    with no graph captured on the request path (the candidate aliases the
    primary's graphs) and a byte-identical verdict when the same evidence is
    attributed again after a seeded reordering."""
    from glom_tpu_torch.obs import attribution
    from glom_tpu_torch.resilience import faultinject
    from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint

    baseline_s, regress_s, n_workers = (3.5, 4.5, 4) if not soak else (8.0, 10.0, 6)
    with tempfile.TemporaryDirectory() as root:
        ckpt = os.path.join(root, "ckpt")
        make_demo_checkpoint(ckpt)
        engine = ServingEngine(ckpt, buckets=(1, 2), max_wait_ms=1.0, warmup=True,
                               reload_poll_s=0, capacity_interval_s=0.25,
                               forensics_dir=os.path.join(root, "forensics"), device=device)
        engine.deploy.fault_delay_s = 0.15
        engine.start(watch=False)
        srv, _ = _serve(engine)
        host, port = srv.server_address[:2]
        body = _embed_body()
        stop = threading.Event()
        counts = {"ok": 0, "error": 0}
        lock = threading.Lock()

        def load(worker):
            i = 0
            while not stop.is_set():
                i += 1
                try:
                    conn = http.client.HTTPConnection(host, port, timeout=30)
                    conn.request("POST", "/embed", body, {
                        "Content-Type": "application/json",
                        "X-Affinity-Key": f"key-{worker}-{i % 16}"})
                    ok = conn.getresponse().status == 200
                    conn.close()
                    with lock:
                        counts["ok" if ok else "error"] += 1
                except Exception:  # glomlint: disable=conc-broad-except -- the error count IS the scenario's health signal
                    with lock:
                        counts["error"] += 1

        workers = [threading.Thread(target=load, args=(w,), daemon=True)
                   for w in range(n_workers)]
        for w in workers:
            w.start()
        try:
            deadline = time.monotonic() + baseline_s
            while time.monotonic() < deadline:
                engine.capacity.tick()
                time.sleep(0.1)
            _resave(ckpt, 2, engine)
            t_fault = time.monotonic()
            step = engine.deploy.begin_canary(step=2, fraction=1.0)
            assert step == 2, f"canary begin failed: {step!r}"
            with faultinject.injected("candidate:delay*1000000"):
                deadline = time.monotonic() + regress_s
                while time.monotonic() < deadline:
                    engine.capacity.tick()
                    time.sleep(0.1)
                stop.set()
                for w in workers:
                    w.join(timeout=10)
            evidence = attribution.collect_engine_evidence(engine)
            verdict = attribution.attribute(evidence)
            # determinism: a seeded reordering of the same evidence must not
            # move a byte of the verdict
            rnd = random.Random(1234)
            shuffled = json.loads(json.dumps(evidence))
            rnd.shuffle(shuffled["timeline"])
            shuffled["series"] = {k: shuffled["series"][k]
                                  for k in sorted(shuffled["series"], reverse=True)}
            rerun = attribution.attribute(shuffled)
            snap = engine.registry.snapshot()
            mttr = time.monotonic() - t_fault

            assert counts["error"] == 0, counts
            assert counts["ok"] >= 20, counts
            assert verdict["verdict"] != "inconclusive", verdict
            top = verdict["causes"][0]
            assert top["kind"] == "event:deploy", top
            assert top["event"]["event"] == "deploy_canary", top
            assert top["event"]["step"] == 2, top
            phases = [p for p in verdict["phases"] if p.get("share") and "bucket" not in p]
            assert phases and phases[0]["phase"] == "queue_wait", phases
            assert phases[0]["share"] >= 0.5, phases[0]
            assert snap.get("serving_graph_captures", 0.0) == 0, snap
            assert attribution.canonical_json(verdict) == attribution.canonical_json(rerun), (
                "verdict not byte-stable under evidence reordering")
        finally:
            stop.set()
            _close(srv)
            engine.shutdown(drain=False)
        return {"mttr_s": round(mttr, 3), "requests_ok": counts["ok"],
                "verdict": verdict["verdict"], "confidence": verdict["confidence"],
                "queue_wait_share": phases[0]["share"],
                "knee_kind": (verdict["knee"] or {}).get("kind")}


# glom_tpu's registry, in its order; the elastic scenarios (None here) need
# resilience/elastic.py and the elastic meshes, which the port does not have yet
SCENARIOS = {
    "torn_ckpt_write": scenario_torn_ckpt_write,
    "corrupt_restore": scenario_corrupt_restore,
    "nan_batch": scenario_nan_batch,
    "reload_io_error": scenario_reload_io_error,
    "train_crash": scenario_train_crash,
    "replica_kill": scenario_replica_kill,
    "canary_regression": scenario_canary_regression,
    "quality_regression": scenario_quality_regression,
    "host_preempt": None,
    "coordinator_loss": None,
    "shrink_restart": None,
    "bulk_preemption": scenario_bulk_preemption,
    "slow_deploy_attribution": scenario_slow_deploy_attribution,
    "index_rebuild": scenario_index_rebuild,
}
PORTED = tuple(name for name, fn in SCENARIOS.items() if fn is not None)
ELASTIC = tuple(name for name, fn in SCENARIOS.items() if fn is None)


def refusal(name: str) -> str:
    """Why ``name`` (one of :data:`ELASTIC`) does not run in the port."""
    from glom_tpu_torch.training.trainer import REASONS

    return (f"--scenario {name} is not in the port's chaos suite yet: it needs "
            f"resilience/elastic.py and parallel/mesh.py's elastic meshes "
            f"({REASONS['mesh']})")


def run(names, *, soak, device="cuda", quiet=False):
    """Run ``names`` (of :data:`PORTED`) in order on ``device``; one record
    a scenario (printed as a JSON line unless ``quiet``)."""
    from glom_tpu_torch.resilience import faultinject

    results = []
    for name in names:
        t0 = time.monotonic()
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                detail = SCENARIOS[name](soak, device)
            outcome = "recovered"
        except Exception as e:  # glomlint: disable=conc-broad-except -- a failed scenario is a record, and the next one still runs
            detail = {"error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()}
            outcome = "failed"
        finally:
            faultinject.disarm()   # a failed scenario must not poison the next
        rec = {"scenario": name, "outcome": outcome,
               "wall_s": round(time.monotonic() - t0, 3), **detail}
        if "mttr_s" in rec:
            rec["mttr_s"] = round(rec["mttr_s"], 3)
        results.append(rec)
        if not quiet:
            print(json.dumps(rec), flush=True)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="GLOM resilience chaos suite (the port)")
    p.add_argument("--smoke", action="store_true", help="fast variants of every scenario")
    p.add_argument("--scenario", action="append", choices=list(SCENARIOS),
                   help="run only this scenario (repeatable)")
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write the full results array to this file")
    p.add_argument("--device", default="cuda",
                   help="torch device every scenario builds on; 'cpu' runs the plain "
                        "PyTorch versions (default: cuda, which needs a card)")
    args = p.parse_args(argv)
    for name in args.scenario or ():
        if name in ELASTIC:
            p.error(refusal(name))
    from glom_tpu_torch.config import resolve_device

    try:
        device = str(resolve_device(args.device))
    except RuntimeError as e:
        print(f"chaos: {e}", file=sys.stderr)
        return 1
    if device == "cpu":
        # the plain forward's intra-op threads would fight the scenarios'
        # client, server and router threads for the cores (a healthy canary
        # then reads over its 100 ms p95 and rolls back before its fault)
        import torch

        torch.set_num_threads(1)
    names = args.scenario or list(PORTED)
    results = run(names, soak=not args.smoke, device=device)
    summary = {
        "mode": "smoke" if args.smoke else "soak",
        "recovered": sum(r["outcome"] == "recovered" for r in results),
        "total": len(results),
        "results": results,
    }
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps({k: summary[k] for k in ("mode", "recovered", "total")}))
    return 0 if summary["recovered"] == summary["total"] else 1


if __name__ == "__main__":
    sys.exit(main())
