"""Stdlib HTTP front for the serving engine (``glom_tpu/serving/server.py``,
its single-replica routes and JSON contract).

``python -m glom_tpu_torch.serving.server --checkpoint-dir D [--demo]
[--port P] [--device cuda]`` serves:

  * ``POST /embed`` -- ``{"images": [...]}`` (one ``(c, H, W)`` image or a
    ``(k, c, H, W)`` batch as nested lists, optionally ``"level": l``) ->
    ``{"step", "latency_ms", "request_id", "embeddings"}``, ``(k, levels,
    dim)`` or ``(k, dim)`` for one level;
  * ``POST /reconstruct`` -- the same request -> ``{"step", "latency_ms",
    "request_id", "images"}``, ``(k, c, H, W)``;
  * ``POST /parse`` -- the same request -> ``{..., "islands"}``, per image
    and level the island labels, count, sizes and mean embeddings;
  * ``POST /session/embed`` and ``/session/parse`` -- ``{"session": id,
    "images": ...}``, one frame of a stateful stream (the engine needs
    ``--warm-iters``): the embeddings (or islands with their deltas against
    the session's previous parse frame) and ``cold``, ``frames``,
    ``iters``; ``POST /session/reset`` -- ``{"session": id}`` drops the
    state;
  * ``POST /similar`` -- images with optional ``"level"`` and ``"k"`` ->
    ``{"results"}``, each image's nearest index slots (``--index-dir``);
  * ``GET /healthz`` -- liveness, the model's input contract, the graphs
    and the kernel launch counts;
  * ``GET /metrics`` -- the engine's registry in the Prometheus text format
    (0.0.4), or OpenMetrics with trace-id exemplars and ``# EOF`` when the
    ``Accept`` header asks for it (``--metrics-timestamps`` stamps its
    samples);
  * ``GET /debug/traces?since=N`` -- completed request traces after cursor
    ``N``; ``GET /debug/timeline`` -- the engine's event timeline (capacity
    recommendations among its events); ``GET /debug/forensics`` -- the
    registry snapshot, the recent SLO firings and the bundle list of
    ``--forensics-dir`` (empty without one), which the fleet observatory
    polls;
  * ``GET /capacity`` -- the capacity plane: the policy, the advisor's
    recommendation and history, the per-rule forecasts; ``GET
    /debug/series?name=&prefix=&since=&step=`` -- its series store (no
    selector: the list of series);
  * ``GET /quality`` -- the quality plane: live against reference sketch
    statistics, drift, the worst requests; ``POST /admin/quality/ref``
    freezes the live sketches as the drift reference (``quality_ref.json``
    beside the checkpoints);
  * ``POST /admin/reload/{prepare,commit,abort,finalize,rollback}`` -- the
    staged two-phase reload (``prepare`` takes an optional ``{"step": N}``);
  * ``POST /admin/deploy/{shadow,canary,promote,rollback,abort,status}`` and
    ``GET /admin/deploy/status`` -- the deploy lifecycle (``shadow`` and
    ``canary`` take an optional ``{"step": N}``, ``canary`` a
    ``"fraction"``): "nothing to deploy" is a 200 with a null
    ``candidate_step``, a settle verb with no deploy or a second deploy
    while one is active a 409;
  * ``POST /admin/jobs/{submit,status,pause,resume,cancel}`` and ``GET
    /admin/jobs/status[?name=]`` -- the bulk tier (``--bulk-dir``): submit
    takes ``{"name", "dataset", "transform", "sink", ...}`` (optionally a
    fleet ``"shard": [lo, hi]``), the others ``{"name"}``; an unknown job is
    a 404, an identity clash or a done job's resubmit a 409, and every verb
    is a 404 when the tier is off.

A batched request may name an extra model (``--model NAME=DIR``) in its
``model`` field (400 for one not resident); otherwise the deploy's canary
assignment hashes its ``X-Affinity-Key`` (else its request id), and the
reply's ``step`` is the version that answered it.

Every request is traced end to end: an inbound ``X-Request-Id`` or W3C
``traceparent`` joins the client's trace, a fresh id is minted otherwise,
and the identity is echoed on every reply (``X-Request-Id`` and
``traceparent`` headers, ``request_id`` in the body).  A bad request is
answered 400, a shed one 503 ``{"error": "overloaded"}``, a request during
drain 503 ``{"error": "shutting_down"}``; error replies count into
``serving_errors_<class>xx``, and every outcome feeds the engine's SLOs
(``--slo``).  SIGTERM drains queued work (and spills the sessions) before
exit.  A request may carry ``X-Tenant``: its images go through that
tenant's quota (``--tenant-quota``), a tenant past it is answered 503
``{"error": "tenant_overloaded", "tenant": ...}``, and an invalid tenant
label 400.

Several processes serve one mesh of ranks (``serving/sharded.py``), one
command a rank: ``--mesh-shape D,M,S --param-sharding tp|ep|replicated
--coordinator host:port --num-processes N --process-id i`` starts the
process group (NCCL on cards of their own, gloo on the CPU; ``--backend
gloo`` for ranks sharing one card) and places this rank's shard; rank 0
binds the port and serves, every other rank binds none and follows it until
it drains.

``--buckets-file`` takes the bucket ladder from a JSON list or from the
payload of ``python -m glom_tpu_torch.tools.trace_report --suggest-buckets``.
``--capacity-ceiling`` is the only source of the capacity plane's ceiling:
unlike ``glom_tpu``'s server, the port's never falls back to a
``BENCH_*.json`` of the repository (a TPU's rate), so without the flag
``capacity_utilization`` is absent.  Flags of ``glom_tpu``'s CLI whose
modules the port does not have yet are recognised and refused by name
(:func:`refused_flags`).
"""

from __future__ import annotations

import argparse
import json
import re
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlparse

import numpy as np

from glom_tpu_torch.obs.exporters import (
    OPENMETRICS_CONTENT_TYPE,
    PROM_TEXT_CONTENT_TYPE,
    prometheus_lines,
    wants_openmetrics,
)
from glom_tpu_torch.obs.tracing import (
    SPAN_DISPATCH_WAIT,
    SPAN_PARSE,
    SPAN_REQUEST,
    SPAN_RESPOND,
    debug_traces_payload,
    format_traceparent,
    parse_traceparent,
    request_trace_id,
)
from glom_tpu_torch.serving.batcher import Closed, Overloaded, TenantQuotaExceeded
from glom_tpu_torch.serving.engine import UNPORTED, ServingEngine
from glom_tpu_torch.serving.sessions import valid_session_id

_MAX_BODY = 256 * 1024 * 1024  # refuse absurd payloads before parsing them
_RESULT_TIMEOUT_S = 120.0
_HEX_ID = re.compile(r"[0-9a-f]{1,32}")
# X-Tenant's charset: it is minted into metric names (through the
# registry's cardinality-bounded labeled())
_TENANT_RE = re.compile(r"[A-Za-z0-9._-]{1,64}")
_TENANT_OVERLOADED = "tenant admission quota exhausted; back off"
_BAD_SESSION = "want 1-128 chars of [A-Za-z0-9._:-]"
_BULK_OFF = "bulk tier disabled on this engine (start with --bulk-dir)"


class ServingHTTPServer(ThreadingHTTPServer):
    daemon_threads = True   # handler threads must not block process exit
    allow_reuse_address = True
    request_queue_size = 128

    def __init__(self, addr, handler, engine: ServingEngine, *, quiet: bool = True,
                 metrics_timestamps: bool = False):
        super().__init__(addr, handler)
        self.engine = engine
        self.quiet = quiet
        # stamp /metrics samples with unix seconds (OpenMetrics bodies only)
        self.metrics_timestamps = metrics_timestamps


class _Handler(BaseHTTPRequestHandler):
    server_version = "glom-torch-serving"
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):
        if not self.server.quiet:
            super().log_message(fmt, *args)

    def _reply(self, code: int, payload, content_type: str = "application/json") -> None:
        if code >= 400:
            self.server.engine.registry.counter(
                f"serving_errors_{code // 100}xx",
                help=f"requests answered with a {code // 100}xx status",
            ).inc()
        body = (json.dumps(payload) if isinstance(payload, (dict, list)) else payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        # every reply after trace minting echoes the request's identity
        rid = getattr(self, "_request_id", None)
        if rid is not None:
            self.send_header("X-Request-Id", rid)
            tid = self._trace_root.trace_id
            # traceparent needs canonical lowercase hex; any X-Request-Id
            # still echoes above
            if _HEX_ID.fullmatch(tid):
                self.send_header("traceparent", format_traceparent(tid, self._trace_root.span_id))
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self) -> Optional[dict]:
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0 or length > _MAX_BODY:
            self._reply(400, {"error": f"bad Content-Length {length}"})
            return None
        try:
            payload = json.loads(self.rfile.read(length))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            self._reply(400, {"error": f"invalid JSON: {e}"})
            return None
        if not isinstance(payload, dict):
            self._reply(400, {"error": "body must be a JSON object"})
            return None
        return payload

    def _tenant(self) -> Optional[str]:
        """The request's ``X-Tenant``, or None.  An invalid label is answered
        400 here and returned as ``""``, so the caller can tell "absent"
        from "bad"."""
        tenant = self.headers.get("X-Tenant")
        if tenant is None:
            return None
        if not _TENANT_RE.fullmatch(tenant):
            # the body is still unread: consume it, or a keep-alive
            # connection's next request would start inside it
            length = int(self.headers.get("Content-Length") or 0)
            if 0 < length <= _MAX_BODY:
                self.rfile.read(length)
            self._reply(400, {"error": f"bad X-Tenant {tenant!r}: want 1-64 chars of "
                                       f"[A-Za-z0-9._-]"})
            return ""
        return tenant

    def _start_request(self, endpoint: str):
        """Join the client's trace or mint one (``X-Request-Id`` wins, a W3C
        ``traceparent`` supplies the trace and remote parent); the identity
        is echoed on every reply (:meth:`_reply`).  Returns the root span."""
        tracer = self.server.engine.tracer
        rid_header = request_trace_id(self.headers.get("X-Request-Id"))
        remote = parse_traceparent(self.headers.get("traceparent"))
        root = tracer.start_trace(SPAN_REQUEST,
                                  trace_id=rid_header or (remote[0] if remote else None),
                                  parent_id=remote[1] if remote else None,
                                  attrs={"endpoint": endpoint})
        self._trace_root = root
        self._request_id = rid_header or root.trace_id
        return root

    def _bad_tenant(self, root) -> None:
        """Close the trace of a request answered 400 for its X-Tenant."""
        tracer = self.server.engine.tracer
        t = tracer.clock()
        tracer.record(SPAN_PARSE, root, root.start, t)
        tracer.end(root, attrs={"status": 400}, at=t)

    def _parse_images(self, payload: dict, cfg=None) -> Optional[np.ndarray]:
        cfg = self.server.engine.config if cfg is None else cfg
        try:
            imgs = np.asarray(payload["images"], dtype=np.float32)
        except (KeyError, TypeError, ValueError) as e:
            self._reply(400, {"error": f"bad 'images' field: {e}"})
            return None
        if imgs.ndim == 3:
            imgs = imgs[None]
        expected = (cfg.channels, cfg.image_size, cfg.image_size)
        if imgs.ndim != 4 or imgs.shape[1:] != expected or imgs.shape[0] == 0:
            self._reply(400, {"error": (
                f"images must be (k,)+{expected} (or one {expected} image), "
                f"got {tuple(imgs.shape)}"
            )})
            return None
        return imgs

    # -- routes ------------------------------------------------------------
    def do_GET(self):  # noqa: N802 (http.server contract)
        # keep-alive reuses the handler: a GET must not echo the previous
        # request's identity
        self._request_id = None
        engine = self.server.engine
        parsed = urlparse(self.path)
        if parsed.path == "/healthz":
            self._reply(200, engine.health())
        elif parsed.path == "/metrics":
            # exemplars and timestamps only under a negotiated OpenMetrics
            # body, which must end with `# EOF`: a 0.0.4 parser rejects both
            om = wants_openmetrics(self.headers.get("Accept"))
            body = prometheus_lines(engine.registry, exemplars=om,
                                    timestamps=om and self.server.metrics_timestamps)
            if om:
                body += "# EOF\n"
            self._reply(200, body,
                        content_type=OPENMETRICS_CONTENT_TYPE if om else PROM_TEXT_CONTENT_TYPE)
        elif parsed.path == "/debug/traces":
            status, payload = debug_traces_payload(engine.tracer, parsed.query,
                                                   role="engine", step=int(engine.step))
            self._reply(status, payload)
        elif parsed.path == "/debug/series":
            # the capacity plane's series store: ring-bounded history of
            # every registry metric, for trend queries
            self._reply(200, engine.capacity.series_payload(parsed.query))
        elif parsed.path == "/debug/timeline":
            self._reply(200, {"role": "engine", "step": int(engine.step),
                              "events": engine.timeline.events()})
        elif parsed.path == "/debug/forensics":
            self._reply(200, engine.debug_forensics())
        elif parsed.path == "/capacity":
            self._reply(200, engine.capacity.payload())
        elif parsed.path == "/quality":
            self._reply(200, engine.quality.payload())
        elif parsed.path == "/admin/deploy/status":
            self._reply(200, engine.deploy.status())
        elif parsed.path == "/admin/jobs/status":
            # the bulk jobs' progress, the GET mirror of the POST verb:
            # ?name= narrows it to one job
            if engine.bulk is None:
                self._reply(404, {"error": _BULK_OFF})
                return
            from urllib.parse import parse_qs

            name = parse_qs(parsed.query).get("name", [None])[0]
            try:
                self._reply(200, engine.bulk.status(name))
            except KeyError as e:
                self._reply(404, {"error": str(e)})
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def _do_admin(self):
        """The staged two-phase reload: control-plane calls, untraced."""
        engine = self.server.engine
        action = self.path[len("/admin/reload/"):]
        if action == "prepare":
            payload = (self._read_json() if int(self.headers.get("Content-Length") or 0) > 0
                       else {})
            if payload is None:
                return
            step = payload.get("step")
            staged = engine.stage_reload(step=int(step) if step is not None else None)
            self._reply(200, {"staged_step": staged, "serving_step": int(engine.step)})
        elif action == "commit":
            self._reply(200, {"step": engine.commit_staged()})
        elif action == "abort":
            self._reply(200, {"aborted": engine.abort_staged()})
        elif action == "finalize":
            self._reply(200, {"finalized": engine.finalize_reload()})
        elif action == "rollback":
            step = engine.rollback()
            if step is None:
                self._reply(409, {"error": "nothing to roll back to"})
            else:
                self._reply(200, {"step": step})
        else:
            self._reply(404, {"error": f"no admin action {action!r}"})

    def _do_deploy_admin(self):
        """The deploy lifecycle verbs: control-plane calls, untraced."""
        engine = self.server.engine
        deploy = engine.deploy
        action = self.path[len("/admin/deploy/"):]
        payload = (self._read_json() if int(self.headers.get("Content-Length") or 0) > 0
                   else {})
        if payload is None:
            return
        try:
            if action in ("shadow", "canary"):
                step = payload.get("step")
                step = int(step) if step is not None else None
                if action == "shadow":
                    staged = deploy.begin_shadow(step=step)
                else:
                    fraction = payload.get("fraction")
                    staged = deploy.begin_canary(
                        fraction=float(fraction) if fraction is not None else None, step=step)
                # "nothing to deploy" is a clean 200 with a null step
                self._reply(200, {"candidate_step": staged, "phase": deploy.phase,
                                  "serving_step": int(engine.step)})
            elif action == "promote":
                report = deploy.promote()
                self._reply(200 if report is not None else 409,
                            report or {"error": "no active deploy"})
            elif action == "rollback":
                report = deploy.rollback(reason=str(payload.get("reason", "operator")))
                self._reply(200 if report is not None else 409,
                            report or {"error": "no active deploy"})
            elif action == "abort":
                self._reply(200, {"aborted": deploy.abort()})
            elif action == "status":
                self._reply(200, deploy.status())
            else:
                self._reply(404, {"error": f"no deploy action {action!r}"})
        except (RuntimeError, ValueError) as e:
            # a second concurrent deploy, a bad fraction: the caller's error
            self._reply(409, {"error": str(e)})

    def _do_jobs_admin(self):
        """The bulk tier's verbs (``bulk_run``, or a fleet router sharding a
        job): control-plane calls, untraced."""
        engine = self.server.engine
        if engine.bulk is None:
            self._reply(404, {"error": _BULK_OFF})
            return
        action = self.path[len("/admin/jobs/"):]
        payload = (self._read_json() if int(self.headers.get("Content-Length") or 0) > 0
                   else {})
        if payload is None:
            return
        try:
            if action == "submit":
                self._reply(200, engine.bulk.submit(payload))
            elif action == "status":
                self._reply(200, engine.bulk.status(payload.get("name")))
            elif action == "pause":
                self._reply(200, engine.bulk.pause(payload["name"]))
            elif action == "resume":
                self._reply(200, engine.bulk.resume(payload["name"]))
            elif action == "cancel":
                self._reply(200, engine.bulk.cancel(payload["name"]))
            else:
                self._reply(404, {"error": f"no jobs action {action!r}"})
        except KeyError as e:
            self._reply(404, {"error": f"unknown job: {e}"})
        except (RuntimeError, ValueError) as e:
            # an identity clash, an overlapping shard, a done job's resubmit
            self._reply(409, {"error": str(e)})

    def do_POST(self):  # noqa: N802
        self._request_id = None  # reset before routing (keep-alive reuse)
        if self.path.startswith("/admin/reload/"):
            self._do_admin()
            return
        if self.path.startswith("/admin/deploy/"):
            self._do_deploy_admin()
            return
        if self.path.startswith("/admin/jobs/"):
            self._do_jobs_admin()
            return
        if self.path == "/admin/quality/ref":
            # freeze the live quality sketches as the drift reference,
            # written beside the checkpoints and adopted at once
            engine = self.server.engine
            try:
                path = engine.quality.save_reference(engine.checkpoint_dir,
                                                     step=int(engine.step))
            except OSError as e:
                self._reply(500, {"error": f"reference write failed: {e}"})
                return
            self._reply(200, {"written": path, "step": int(engine.step)})
            return
        if self.path in ("/session/embed", "/session/parse", "/session/reset"):
            self._do_session()
            return
        if self.path == "/similar":
            self._do_similar()
            return
        if self.path not in ("/embed", "/reconstruct", "/parse"):
            self._reply(404, {"error": f"no route {self.path}"})
            return
        endpoint = self.path[1:]
        engine = self.server.engine
        tracer = engine.tracer
        root = self._start_request(endpoint)
        tenant = self._tenant()
        if tenant == "":
            self._bad_tenant(root)
            return
        # the canary assignment hashes the stickiest key the request offers
        deploy_key = self.headers.get("X-Affinity-Key") or self._request_id

        def _finish(status: int, latency_ms=None, at=None, version=None):
            tracer.end(root, attrs={"status": status}, at=at)
            engine.observe_outcome(endpoint, latency_ms, status >= 500, trace_id=root.trace_id,
                                   tenant=tenant, version=version)

        # parse / dispatch_wait / respond share their edges, so they tile
        # the request span
        payload = self._read_json()
        model = payload.get("model") if payload is not None else None
        model_cfg = None
        if model is not None:
            record = engine.models.get(model)
            if record is None:
                self._reply(400, {"error": f"unknown model {model!r}; resident: "
                                           f"{engine.models.models()}"})
                _finish(400)
                return
            model_cfg = record.config
            root.attrs["model"] = model
        imgs = self._parse_images(payload, model_cfg) if payload is not None else None
        t_parsed = tracer.clock()
        tracer.record(SPAN_PARSE, root, root.start, t_parsed)
        if imgs is None:
            _finish(400)
            return
        # extra models never canary: deploys guard the default model
        version = engine.deploy.assign(deploy_key) if model is None else None
        # an outcome rejected before it executed never touched the candidate
        # and is not charged to it
        out_version = version
        t0 = time.monotonic()
        try:
            out = engine.submit(endpoint, imgs, ctx=root, tenant=tenant, model=model,
                                version=version).result(timeout=_RESULT_TIMEOUT_S)
        except TenantQuotaExceeded as e:
            error, code, body = e, 503, {"error": "tenant_overloaded", "tenant": e.tenant,
                                         "detail": _TENANT_OVERLOADED}
            out_version = None
        except Overloaded as e:
            error, code, body = e, 503, {"error": "overloaded",
                                         "detail": "queue at capacity; retry with backoff"}
            out_version = None
        except Closed as e:
            error, code, body = e, 503, {"error": "shutting_down",
                                         "detail": "server is draining; retry elsewhere"}
            out_version = None
        except ValueError as e:  # e.g. a request larger than the largest bucket
            error, code, body = e, 400, {"error": str(e)}
            out_version = None
        except Exception as e:  # the request's forward failed; the server lives on
            error, code, body = e, 500, {"error": f"{type(e).__name__}: {e}"}
        else:
            error = None
        t_done = tracer.clock()
        tracer.record(SPAN_DISPATCH_WAIT, root, t_parsed, t_done)
        if error is not None:
            self._reply(code, body)
            _finish(code, version=out_version)
            return
        latency = time.monotonic() - t0
        engine.registry.histogram(
            f"serving_latency_seconds_{endpoint}",
            help="request latency, admission to response", unit="seconds",
        ).observe(latency)
        # the step names the version that answered: a candidate retired in
        # flight fell back to the primary
        served_version = version
        if version is not None and engine.deploy.candidate_step != version:
            served_version = None
        resp = {"step": int(served_version) if served_version is not None else int(engine.step),
                "latency_ms": round(latency * 1e3, 3), "request_id": self._request_id}
        if model is not None:
            resp["model"] = model
        if endpoint == "embed":
            level = payload.get("level")
            if level is not None:
                try:
                    out = out[:, int(level)]
                except (IndexError, TypeError, ValueError):
                    self._reply(400, {"error": (
                        f"level {level!r} outside this model's {engine.config.levels} levels")})
                    t_end = tracer.clock()
                    tracer.record(SPAN_RESPOND, root, t_done, t_end)
                    _finish(400, at=t_end, version=version)
                    return
            resp["embeddings"] = out.tolist()
        elif endpoint == "parse":
            resp["islands"] = self._islands(out, model_cfg)
        else:
            resp["images"] = out.tolist()
        self._reply(200, resp)
        t_end = tracer.clock()
        tracer.record(SPAN_RESPOND, root, t_done, t_end)
        _finish(200, latency_ms=latency * 1e3, at=t_end, version=version)

    def _islands(self, rows: np.ndarray, cfg=None) -> list:
        from glom_tpu_torch.hierarchy.parse import unpack_parse

        cfg = self.server.engine.config if cfg is None else cfg
        side = cfg.image_size // cfg.patch_size
        return [unpack_parse(row, cfg.levels, side, cfg.dim) for row in rows]

    # -- stateful sessions --------------------------------------------------
    def _do_session(self):
        """``/session/embed`` and ``/session/parse`` (one frame of a stream,
        warm from the session's state) and ``/session/reset``; 404 unless the
        engine has sessions (``--warm-iters``)."""
        engine = self.server.engine
        tracer = engine.tracer
        parse = self.path == "/session/parse"
        if not engine.sessions_enabled:
            self._reply(404, {"error": "sessions disabled on this engine "
                                       "(start the server with --warm-iters)"})
            return
        if self.path == "/session/reset":
            # a control-plane call, untraced
            payload = self._read_json()
            if payload is None:
                return
            session_id = payload.get("session")
            if not valid_session_id(session_id):
                self._reply(400, {"error": f"bad 'session' field {session_id!r}: "
                                           f"{_BAD_SESSION}"})
                return
            self._reply(200, {"session": session_id,
                              "reset": engine.session_reset(session_id)})
            return

        # the trace starts before the body is read, as on the batched routes
        root = self._start_request("session")
        tenant = self._tenant()
        if tenant == "":
            self._bad_tenant(root)
            return

        def _finish(status: int, latency_ms=None, at=None, version=None):
            tracer.end(root, attrs={"status": status}, at=at)
            engine.observe_outcome("session", latency_ms, status >= 500,
                                   trace_id=root.trace_id, tenant=tenant, version=version)

        payload = self._read_json()
        session_id = payload.get("session") if payload is not None else None
        if payload is not None:
            if not valid_session_id(session_id):
                self._reply(400, {"error": f"bad 'session' field {session_id!r}: "
                                           f"{_BAD_SESSION}"})
                payload = None
            else:
                root.attrs["session"] = session_id
        imgs = self._parse_images(payload) if payload is not None else None
        t_parsed = tracer.clock()
        tracer.record(SPAN_PARSE, root, root.start, t_parsed)
        if imgs is None:
            _finish(400)
            return
        t0 = time.monotonic()
        run = engine.session_parse if parse else engine.session_embed
        try:
            out, info = run(session_id, imgs, ctx=root, tenant=tenant)
        except TenantQuotaExceeded as e:
            self._reply(503, {"error": "tenant_overloaded", "tenant": e.tenant,
                              "detail": _TENANT_OVERLOADED})
            _finish(503)
            return
        except Closed:
            self._reply(503, {"error": "shutting_down",
                              "detail": "server is draining; retry elsewhere"})
            _finish(503)
            return
        except ValueError as e:  # a frame batch past the largest bucket
            self._reply(400, {"error": str(e)})
            _finish(400)
            return
        except Exception as e:
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            _finish(500)
            return
        latency = time.monotonic() - t0
        # dispatch_wait spans the whole inline execute (the cache's execute
        # span overlaps inside it), so the trace covers the handler
        t_done = tracer.clock()
        tracer.record(SPAN_DISPATCH_WAIT, root, t_parsed, t_done)
        engine.registry.histogram(
            "serving_latency_seconds_session" + ("_parse" if parse else ""),
            help=("session parse-frame latency, admission to response" if parse
                  else "session frame latency, admission to response"),
            unit="seconds").observe(latency)
        # info carries the honest step: the version that computed the frame
        resp = {"latency_ms": round(latency * 1e3, 3), "request_id": self._request_id,
                "session": session_id, **info}
        if parse:
            resp["islands"] = self._islands(out)
        else:
            level = payload.get("level")
            if level is not None:
                try:
                    out = out[:, int(level)]
                except (IndexError, TypeError, ValueError):
                    self._reply(400, {"error": (
                        f"level {level!r} outside this model's {engine.config.levels} levels")})
                    _finish(400)
                    return
            resp["embeddings"] = out.tolist()
        self._reply(200, resp)
        t_end = tracer.clock()
        tracer.record(SPAN_RESPOND, root, t_done, t_end)
        _finish(200, latency_ms=latency * 1e3, at=t_end, version=info.get("canary_step"))

    # -- similarity queries --------------------------------------------------
    def _do_similar(self):
        """``/similar``: images plus optional ``level`` (default: the top)
        and ``k`` (default 5); 404 unless the engine has an index
        (``--index-dir``).  Inline on the handler's thread, like a session
        frame."""
        engine = self.server.engine
        tracer = engine.tracer
        if not engine.similar_enabled:
            self._reply(404, {"error": "similarity index disabled on this engine "
                                       "(start the server with --index-dir)"})
            return
        root = self._start_request("similar")
        tenant = self._tenant()
        if tenant == "":
            self._bad_tenant(root)
            return

        def _finish(status: int, latency_ms=None, at=None):
            tracer.end(root, attrs={"status": status}, at=at)
            engine.observe_outcome("similar", latency_ms, status >= 500,
                                   trace_id=root.trace_id, tenant=tenant)

        payload = self._read_json()
        imgs = self._parse_images(payload) if payload is not None else None
        t_parsed = tracer.clock()
        tracer.record(SPAN_PARSE, root, root.start, t_parsed)
        if imgs is None:
            _finish(400)
            return
        t0 = time.monotonic()
        try:
            level = payload.get("level")
            results, info = engine.similar(imgs, level=None if level is None else int(level),
                                           k=int(payload.get("k", 5)), ctx=root, tenant=tenant)
        except TenantQuotaExceeded as e:
            self._reply(503, {"error": "tenant_overloaded", "tenant": e.tenant,
                              "detail": _TENANT_OVERLOADED})
            _finish(503)
            return
        except (TypeError, ValueError) as e:  # a bad level or k, an oversize batch
            self._reply(400, {"error": str(e)})
            _finish(400)
            return
        except Exception as e:
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            _finish(500)
            return
        latency = time.monotonic() - t0
        t_done = tracer.clock()
        tracer.record(SPAN_DISPATCH_WAIT, root, t_parsed, t_done)
        engine.registry.histogram("serving_latency_seconds_similar",
                                  help="similarity query latency, admission to response",
                                  unit="seconds").observe(latency)
        self._reply(200, {"step": int(engine.step), "latency_ms": round(latency * 1e3, 3),
                          "request_id": self._request_id, "results": results, **info})
        t_end = tracer.clock()
        tracer.record(SPAN_RESPOND, root, t_done, t_end)
        _finish(200, latency_ms=latency * 1e3, at=t_end)


def make_server(engine: ServingEngine, host: str = "127.0.0.1", port: int = 0,
                *, quiet: bool = True, metrics_timestamps: bool = False) -> ServingHTTPServer:
    """Bind (port 0 picks a free port: read ``server.server_address``); the
    caller runs ``serve_forever`` on a thread of its own."""
    return ServingHTTPServer((host, port), _Handler, engine, quiet=quiet,
                             metrics_timestamps=metrics_timestamps)


# flags of glom_tpu's serving CLI the port does not take: flag -> (nargs, the
# engine argument it sets, whose entry in UNPORTED says why)
_REFUSED = {
    "--no-donate": (0, "donate_inputs"),
}
# the one with no engine argument behind it: flag -> (nargs, why)
_REFUSED_CLI = {
    "--platform": (1, "the port picks its device with --device"),
}


def refused_flags() -> dict:
    """Every refused flag -> (nargs, why)."""
    return {**{flag: (nargs, UNPORTED[name][1]) for flag, (nargs, name) in _REFUSED.items()},
            **_REFUSED_CLI}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="GLOM online serving on PyTorch/CUDA: dynamic batching into "
                    "bucketed CUDA graphs of the hand-written kernels, with "
                    "checkpoint hot reload")
    p.add_argument("--checkpoint-dir", required=True,
                   help="Trainer checkpoint dir (reads its config.json)")
    p.add_argument("--demo", action="store_true",
                   help="write a small demo checkpoint into --checkpoint-dir if it has none")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch versions of the kernels")
    p.add_argument("--buckets", default="1,2,4,8",
                   help="comma-separated batch buckets, padded up to")
    p.add_argument("--buckets-file", default=None,
                   help="JSON file holding the bucket ladder: a plain list or the payload of "
                        "python -m glom_tpu_torch.tools.trace_report --suggest-buckets (its "
                        "'suggested_buckets'); overrides --buckets.  Serve with --trace-log, "
                        "fit a ladder with trace_report, restart with its file")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="micro-batch deadline: flush a partial batch after this")
    p.add_argument("--max-queue", type=int, default=64,
                   help="queued-image bound; beyond it requests shed (503)")
    p.add_argument("--iters", type=int, default=None,
                   help="GLOM iterations (default: the model's)")
    p.add_argument("--quant", default="f32", choices=["f32", "bf16", "int8"],
                   help="serving precision: bf16 = bf16 weights and compute; int8 = "
                        "weight-only symmetric int8, dequantized to bf16 inside the graphs, "
                        "bf16 activations.  Check a mode first with python -m "
                        "glom_tpu_torch.tools.quant_check")
    p.add_argument("--warm-iters", default=None, metavar="N|auto",
                   help="enable stateful sessions (/session/embed, /session/parse, "
                        "/session/reset): a warm frame settles from the previous frame's "
                        "state in N iterations ('auto' = half the cold count)")
    p.add_argument("--session-ttl-s", type=float, default=600.0,
                   help="idle sessions older than this are evicted")
    p.add_argument("--session-max-mb", type=float, default=256.0,
                   help="bound on resident session state; the least recently used "
                        "sessions are evicted beyond it")
    p.add_argument("--session-spill-dir", default=None,
                   help="spill the session states here on drain and restore them at "
                        "start-up (float32 npz, the checkpoint layout)")
    p.add_argument("--tenant-quota", action="append", default=None,
                   metavar="NAME=RATE[:BURST]",
                   help="repeatable: a tenant's admission quota in images/s (token "
                        "bucket; the burst defaults to the rate).  Requests carry X-Tenant; "
                        "a tenant past its bucket is answered 503 without touching others")
    p.add_argument("--parse-thresholds", default=None, metavar="T|T0,T1,..",
                   help="agreement threshold(s) for /parse islanding: one float for every "
                        "level, or one a level, comma-separated, each in [-1, 1] "
                        "(default 0.9)")
    p.add_argument("--index-dir", default=None, metavar="DIR",
                   help="enable POST /similar over the level index in DIR (written by "
                        "hierarchy/index.py::write_index_parts); parts that land later "
                        "are seen by later queries")
    p.add_argument("--bulk-dir", default=None, metavar="DIR",
                   help="enable the bulk tier: the job store of scavenger-class offline jobs "
                        "(POST /admin/jobs/*); unfinished jobs in the store resume at start-up "
                        "from their durable cursors")
    p.add_argument("--ff-impl", default=None, choices=["dense", "pallas", "fused"],
                   help="override the checkpoint config's choice (default: keep it). "
                        "dense: plain ops; pallas: the grouped-FF kernel; fused: the "
                        "fused level update (consensus + both FFs in one call of K8's kernels, "
                        "falling back to pallas when the model's shape rules it out)")
    p.add_argument("--mesh-shape", default=None,
                   help="serve mesh-sharded: comma '(data,model,seq)' rank counts, e.g. "
                        "'1,4,1' = 4-way TP; one command a rank (--coordinator, "
                        "--num-processes, --process-id), rank 0 serving.  Buckets must "
                        "divide the data axis.  Default: one rank")
    p.add_argument("--param-sharding", default="replicated", choices=["replicated", "tp", "ep"],
                   help="param placement on the mesh (parallel/sharding.py rules): tp shards "
                        "every level-MLP's hidden dim over the model axis; ep shards whole "
                        "level-nets")
    p.add_argument("--coordinator", default=None,
                   help="host:port of the process group's rendezvous (tcp://host:port)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="the process group's backend: NCCL for ranks on cards of their own "
                        "(the default on cuda), gloo for the CPU and for ranks sharing one card "
                        "(NCCL refuses two ranks on one device), named here")
    p.add_argument("--reload-poll-s", type=float, default=2.0,
                   help="checkpoint hot-reload poll period; 0 disables")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the start-up graph captures (the first request of each "
                        "bucket then captures it, counted in serving_graph_captures)")
    p.add_argument("--warmup-dir", default=None,
                   help="write one bundle a (family, bucket) here at warm-up: the graph's "
                        "kernel launches a replay, its analytic cost and its memory")
    p.add_argument("--forensics-dir", default=None,
                   help="bundle root for the engine's triggered captures (queue_saturation, "
                        "slo_burn, quality_drift, capacity_pressure, deploy_rollback, "
                        "ckpt_corrupt)")
    p.add_argument("--trace-log", default=None,
                   help="JSONL file receiving one record per completed request trace")
    p.add_argument("--slo", action="append", default=None, metavar="SPEC",
                   help="declarative SLO target, repeatable: 'embed:p95<250ms' (latency) "
                        "or 'errors<1%%' (error rate)")
    p.add_argument("--model", action="append", default=None, metavar="NAME=DIR", dest="models",
                   help="repeatable: load an extra named model from its own checkpoint dir, "
                        "resident beside the default (a request names it in a \"model\" field)")
    p.add_argument("--deploy-pin-url", default=None, metavar="URL",
                   help="fleet router base URL: a deploy's promote and rollback converge every "
                        "replica through its two-phase POST /rollout instead of a local swap")
    p.add_argument("--deploy-promote-after", type=int, default=3,
                   help="clean candidate burn windows before auto-promote")
    p.add_argument("--deploy-window-s", type=float, default=None,
                   help="candidate burn-window length (default: the longest SLO short window)")
    p.add_argument("--deploy-min-events", type=int, default=None,
                   help="candidate outcomes a window needs to count as evidence (default: "
                        "the smallest SLO min_events)")
    p.add_argument("--deploy-canary-fraction", type=float, default=0.1,
                   help="default live-traffic fraction for /admin/deploy/canary")
    p.add_argument("--capacity-policy", default=None, metavar="SPEC",
                   help="dry-run autoscale advisor policy, e.g. "
                        "'p95_ms<250,duty<0.8,shed<0.01': evaluated over the capacity series "
                        "every window; violations are recommendations only (GET /capacity)")
    p.add_argument("--capacity-ceiling", type=float, default=None,
                   help="measured images/s ceiling of this card for utilization accounting; "
                        "without it capacity_utilization is absent (no BENCH_*.json is read "
                        "in its place)")
    p.add_argument("--capacity-window-s", type=float, default=30.0,
                   help="capacity signal window (duty/shed/rate deltas are taken over it)")
    p.add_argument("--capacity-persist-windows", type=int, default=5,
                   help="consecutive scale-up windows before the advisor fires the debounced "
                        "capacity_pressure trigger")
    p.add_argument("--quality-sample", type=float, default=1.0,
                   help="fraction of served batches replayed through the quality post-pass "
                        "(island agreement, residual, drift sketches: GET /quality); "
                        "deterministic credit sampling; 0 builds no quality graphs")
    p.add_argument("--metrics-timestamps", action="store_true",
                   help="stamp /metrics samples with unix seconds on OpenMetrics scrapes")
    p.add_argument("--verbose", action="store_true", help="per-request access log")
    refused = p.add_argument_group("refused: not in the port yet")
    refused_table = refused_flags()
    for flag, (nargs, _) in refused_table.items():
        kw = {"action": "store_true"} if nargs == 0 else {}
        refused.add_argument(flag, default=argparse.SUPPRESS, help=argparse.SUPPRESS, **kw)
    args = p.parse_args(argv)
    for flag, (_, why) in refused_table.items():
        if hasattr(args, flag[2:].replace("-", "_")):
            p.error(f"{flag} is not in the port's server yet ({why})")
    if args.mesh_shape is not None:
        try:
            args.mesh_shape = tuple(int(s) for s in args.mesh_shape.split(","))
        except ValueError:
            p.error(f"--mesh-shape takes comma-separated ints, got {args.mesh_shape!r}")
        ranks, world = int(np.prod(args.mesh_shape)), args.num_processes or 1
        if ranks != world:
            p.error(f"--mesh-shape {args.mesh_shape} needs {ranks} ranks, one process each "
                    f"(--num-processes {ranks} with --coordinator and --process-id); got {world}")
    elif args.param_sharding != "replicated":
        p.error(f"--param-sharding {args.param_sharding} needs a mesh_shape (--mesh-shape, e.g. "
                f"1,4,1 for 4-way TP)")
    return args


def read_buckets_file(path: str) -> tuple:
    """The ladder of a ``--buckets-file``: a JSON list of ints, or a
    ``--suggest-buckets`` payload (its ``suggested_buckets``)."""
    with open(path) as f:
        ladder = json.load(f)
    if isinstance(ladder, dict):
        ladder = ladder.get("suggested_buckets")
    if not (isinstance(ladder, list) and ladder
            and all(isinstance(b, int) and b >= 1 for b in ladder)):
        raise SystemExit(f"--buckets-file {path!r} holds no usable ladder (want a list of "
                         f"ints or a --suggest-buckets payload)")
    return tuple(ladder)


def engine_from_args(args, **overrides) -> ServingEngine:
    """The engine the parsed flags describe; ``overrides`` replace or add
    engine arguments (a caller that serves in its own process, for one)."""
    kwargs = dict(
        buckets=(read_buckets_file(args.buckets_file) if args.buckets_file
                 else tuple(int(b) for b in args.buckets.split(","))),
        iters=args.iters, max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
        device=args.device, ff_impl=args.ff_impl, reload_poll_s=args.reload_poll_s,
        warmup=not args.no_warmup, trace_log=args.trace_log, slos=args.slo,
        quant=args.quant, warm_iters=args.warm_iters, session_ttl_s=args.session_ttl_s,
        session_max_bytes=int(args.session_max_mb * 2 ** 20),
        session_spill_dir=args.session_spill_dir,
        tenant_quotas=({name: spec for name, spec in
                        (entry.split("=", 1) for entry in args.tenant_quota)}
                       if args.tenant_quota else None),
        parse_thresholds=args.parse_thresholds, index_dir=args.index_dir,
        extra_models=({name: path for name, path in
                       (entry.split("=", 1) for entry in args.models)}
                      if args.models else None),
        deploy_promote_after=args.deploy_promote_after, deploy_window_s=args.deploy_window_s,
        deploy_min_events=args.deploy_min_events,
        deploy_canary_fraction=args.deploy_canary_fraction, deploy_pin_url=args.deploy_pin_url,
        capacity_policy=args.capacity_policy, capacity_window_s=args.capacity_window_s,
        capacity_persist_windows=args.capacity_persist_windows,
        capacity_ceiling=args.capacity_ceiling, quality_sample=args.quality_sample,
        bulk_dir=args.bulk_dir, warmup_dir=args.warmup_dir,
        forensics_dir=args.forensics_dir, mesh_shape=args.mesh_shape,
        param_sharding=args.param_sharding,
    )
    kwargs.update(overrides)
    return ServingEngine(args.checkpoint_dir, **kwargs)


def main(argv=None) -> int:
    import torch.distributed as dist

    from glom_tpu_torch.parallel.mesh import initialize_distributed

    args = parse_args(argv)
    # one command a rank: the group starts before the engine (NCCL on cards,
    # gloo on the CPU or where --backend names it)
    device = initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                    device=args.device, backend=args.backend)
    if device is not None:
        args.device = str(device)
    try:
        return _main(args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _main(args) -> int:
    import torch.distributed as dist

    from glom_tpu_torch import checkpoint as ckpt_lib
    from glom_tpu_torch.serving.engine import make_demo_checkpoint

    if args.demo and (args.process_id or 0) == 0 \
            and ckpt_lib.latest_step(args.checkpoint_dir) is None:
        make_demo_checkpoint(args.checkpoint_dir)
        print(json.dumps({"event": "demo_checkpoint", "dir": args.checkpoint_dir}))
    if dist.is_initialized():
        dist.barrier()      # every rank reads the checkpoint rank 0 may have written

    engine = engine_from_args(args)
    if not engine.is_leader:
        # a follower binds no port: it runs the leader's calls on its shard
        print(json.dumps({"event": "following", "rank": engine.mesh_rank,
                          "mesh": engine.health()["mesh"]}), flush=True)
        calls = engine.follow()
        print(json.dumps({"event": "stopped", "rank": engine.mesh_rank, "calls": calls}),
              flush=True)
        return 0
    engine.start()
    engine.capacity.start()  # the sampler's thread; tests tick() with a fake clock
    server = make_server(engine, args.host, args.port, quiet=not args.verbose,
                         metrics_timestamps=args.metrics_timestamps)
    stop_once = threading.Event()

    def _graceful(signum, frame):
        if not stop_once.is_set():
            stop_once.set()
            threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    host, port = server.server_address[:2]
    print(json.dumps({"event": "serving", "host": host, "port": port,
                      **engine.health()}), flush=True)
    try:
        server.serve_forever(poll_interval=0.2)
    finally:
        engine.shutdown(drain=True)
        server.server_close()
        print(json.dumps({"event": "drained", "step": int(engine.step)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
