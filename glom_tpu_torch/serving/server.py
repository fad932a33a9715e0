"""Stdlib HTTP front for the serving engine (``glom_tpu/serving/server.py``,
its JSON contract).

``python -m glom_tpu_torch.serving.server --checkpoint-dir D [--demo]
[--port P] [--device cuda]`` serves:

  * ``POST /embed`` — ``{"images": [...]}`` (one ``(c, H, W)`` image or a
    ``(k, c, H, W)`` batch as nested lists, optionally ``"level": l``) ->
    ``{"step", "latency_ms", "embeddings"}``, ``(k, levels, dim)`` or
    ``(k, dim)`` for one level;
  * ``POST /reconstruct`` — the same request -> ``{"step", "latency_ms",
    "images"}``, ``(k, c, H, W)``;
  * ``GET /healthz`` — liveness, the model's input contract and the kernel
    launch counts.

A bad request is answered 400, a shed one 503 ``{"error": "overloaded"}``,
and SIGTERM drains queued work before exit.
"""

from __future__ import annotations

import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from glom_tpu_torch.serving.batcher import Closed, Overloaded
from glom_tpu_torch.serving.engine import ServingEngine

_MAX_BODY = 256 * 1024 * 1024  # refuse absurd payloads before parsing them
_RESULT_TIMEOUT_S = 120.0


class ServingHTTPServer(ThreadingHTTPServer):
    daemon_threads = True   # handler threads must not block process exit
    allow_reuse_address = True
    request_queue_size = 128

    def __init__(self, addr, handler, engine: ServingEngine, *, quiet: bool = True):
        super().__init__(addr, handler)
        self.engine = engine
        self.quiet = quiet


class _Handler(BaseHTTPRequestHandler):
    server_version = "glom-torch-serving"
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):
        if not self.server.quiet:
            super().log_message(fmt, *args)

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
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

    def _parse_images(self, payload: dict) -> Optional[np.ndarray]:
        cfg = self.server.engine.config
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

    def do_GET(self):  # noqa: N802 (http.server contract)
        if self.path == "/healthz":
            self._reply(200, self.server.engine.health())
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802
        if self.path not in ("/embed", "/reconstruct"):
            self._reply(404, {"error": f"no route {self.path}"})
            return
        endpoint = self.path[1:]
        engine = self.server.engine
        payload = self._read_json()
        if payload is None:
            return
        imgs = self._parse_images(payload)
        if imgs is None:
            return
        level = payload.get("level") if endpoint == "embed" else None
        if level is not None:
            try:
                level = int(level)
            except (TypeError, ValueError):
                level = engine.config.levels
            if not -engine.config.levels <= level < engine.config.levels:
                self._reply(400, {"error": (
                    f"level {payload.get('level')!r} outside this model's "
                    f"{engine.config.levels} levels")})
                return
        t0 = time.monotonic()
        try:
            out = engine.submit(endpoint, imgs).result(timeout=_RESULT_TIMEOUT_S)
        except Overloaded:
            self._reply(503, {"error": "overloaded",
                              "detail": "queue at capacity; retry with backoff"})
            return
        except Closed:
            self._reply(503, {"error": "shutting_down",
                              "detail": "server is draining; retry elsewhere"})
            return
        except ValueError as e:  # e.g. a request larger than the largest bucket
            self._reply(400, {"error": str(e)})
            return
        except Exception as e:  # the request's forward failed; the server lives on
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        resp = {"step": int(engine.step),
                "latency_ms": (time.monotonic() - t0) * 1e3}
        if endpoint == "embed":
            resp["embeddings"] = (out if level is None else out[:, level]).tolist()
        else:
            resp["images"] = out.tolist()
        self._reply(200, resp)


def make_server(engine: ServingEngine, host: str = "127.0.0.1", port: int = 0,
                *, quiet: bool = True) -> ServingHTTPServer:
    """Bind (port 0 picks a free port: read ``server.server_address``); the
    caller runs ``serve_forever`` on a thread of its own."""
    return ServingHTTPServer((host, port), _Handler, engine, quiet=quiet)


def main(argv=None) -> int:
    import argparse

    from glom_tpu_torch import checkpoint as ckpt_lib
    from glom_tpu_torch.serving.engine import make_demo_checkpoint

    p = argparse.ArgumentParser(
        description="GLOM online serving on PyTorch/CUDA: dynamic batching "
                    "into bucketed forwards through the hand-written kernels")
    p.add_argument("--checkpoint-dir", required=True,
                   help="Trainer checkpoint dir (reads its config.json)")
    p.add_argument("--demo", action="store_true",
                   help="write a small demo checkpoint into --checkpoint-dir "
                        "if it has none")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch versions "
                        "of the kernels")
    p.add_argument("--buckets", default="1,2,4,8",
                   help="comma-separated batch buckets, padded up to")
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--max-queue", type=int, default=64)
    p.add_argument("--iters", type=int, default=None,
                   help="GLOM iterations (default: the model's)")
    p.add_argument("--ff-impl", default=None, choices=["dense", "pallas", "fused"],
                   help="override the checkpoint config's choice (default: keep it). "
                        "dense: plain ops; pallas: the grouped-FF kernel; fused: the "
                        "fused level update (consensus + both FFs in one call of K8's kernels, "
                        "falling back to pallas when the model's shape rules it out)")
    p.add_argument("--verbose", action="store_true", help="per-request access log")
    args = p.parse_args(argv)

    if args.demo and ckpt_lib.latest_step(args.checkpoint_dir) is None:
        make_demo_checkpoint(args.checkpoint_dir)
        print(json.dumps({"event": "demo_checkpoint", "dir": args.checkpoint_dir}))

    engine = ServingEngine(
        args.checkpoint_dir,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        iters=args.iters, max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
        device=args.device, ff_impl=args.ff_impl,
    )
    engine.start()
    server = make_server(engine, args.host, args.port, quiet=not args.verbose)
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
