"""Serving engine (``glom_tpu/serving/engine.py``, its main path).

request -> :class:`~glom_tpu_torch.serving.batcher.DynamicBatcher` (one per
endpoint) -> worker thread -> the batch padded to the nearest bucket ->
the forward under ``torch.inference_mode()`` -> per-request slices on the
callers' futures.

* ``embed``: ``mean(apply(imgs), over patches)`` -> ``(k, L, d)``, the
  per-level embeddings.
* ``reconstruct``: the state after the training loss timestep
  (``resolve_loss_timestep``) decoded through the trained head ->
  ``(k, c, H, W)``.  The forward stops at that timestep: the iterations
  after it would not change the answer.

The engine loads the newest checkpoint of a directory written by either
package and serves it with the kernel choice the checkpoint recorded
(``ff_impl`` / ``attention_impl``), as ``glom_tpu``'s engine does; an
explicit ``ff_impl`` or ``attention_impl`` overrides it (the weights are the
same either way), and ``"pallas"`` picks the hand-written CUDA kernels.
``ff_impl="fused"`` serves each iteration as one call of the fused
level-update kernels where the model's shape allows it
(``models/glom.py::fused_update_supported``), and falls back to the
grouped-FF and consensus kernels where it does not.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch.config import GlomConfig, TrainConfig, resolve_device
from glom_tpu_torch.kernels import _build, consensus, ff, fused_update
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.models.heads import decoder_apply, decoder_param_shapes
from glom_tpu_torch.serving.batcher import DynamicBatcher
from glom_tpu_torch.training import denoise

ENDPOINTS = ("embed", "reconstruct")

# The smallest config the CUDA kernels take (d a multiple of 128).
DEMO_CONFIG = GlomConfig(dim=128, levels=3, image_size=16, patch_size=8)


def demo_params(config: GlomConfig, train: TrainConfig, seed: int = 0) -> dict:
    """Seeded numpy weights for a trainer checkpoint's ``params`` tree, drawn
    as torch's default inits draw them (uniform ``1/sqrt(fan_in)`` bounds,
    standard normal embeddings)."""
    rng = np.random.default_rng(seed)
    c = config

    def unif(shape, fan_in):
        bound = fan_in ** -0.5
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def linear(fan_in, fan_out):
        return {"w": unif((fan_in, fan_out), fan_in), "b": unif((fan_out,), fan_in)}

    def ff(groups):
        h = c.dim * c.ff_mult
        return {"w1": unif((groups, c.dim, h), c.dim), "b1": unif((groups, h), c.dim),
                "w2": unif((groups, h, c.dim), h), "b2": unif((groups, c.dim), h)}

    glom = {
        "patch_embed": linear(c.patch_dim, c.dim),
        "pos_emb": rng.standard_normal((c.num_patches, c.dim), dtype=np.float32),
        "init_levels": rng.standard_normal((c.levels, c.dim), dtype=np.float32),
        "bottom_up": ff(c.levels),
        "top_down": ff(c.levels - 1),
    }
    shapes = decoder_param_shapes(c, arch=train.decoder, hidden_mult=train.decoder_hidden_mult)
    if "w" in shapes:
        decoder = linear(*shapes["w"])
    else:
        l1, l2 = linear(*shapes["w1"]), linear(*shapes["w2"])
        decoder = {"w1": l1["w"], "b1": l1["b"], "w2": l2["w"], "b2": l2["b"]}
    return {"glom": glom, "decoder": decoder}


def make_demo_checkpoint(directory: str, *, config: Optional[GlomConfig] = None,
                         train: Optional[TrainConfig] = None, seed: int = 0) -> int:
    """Write an untrained, servable checkpoint (step 0) with seeded numpy
    weights, in the Trainer's layout (``config.json`` + npz + integrity
    record + manifest), which ``glom_tpu`` also reads.  Returns the step."""
    config = config if config is not None else DEMO_CONFIG
    train = train if train is not None else TrainConfig(batch_size=2, steps=0)
    ckpt_lib.write_json(directory, "config.json",
                        {"glom": config.to_json_dict(), "train": train.to_json_dict()})
    ckpt_lib.save(directory, 0, {"params": demo_params(config, train, seed)})
    return 0


def kernel_launches() -> Dict[str, int]:
    """Launch counts of the CUDA kernels, process-wide."""
    return {"grouped_ff": ff.grouped_ff.launches,
            "consensus_attention": consensus.consensus_attention.launches,
            "fused_level_update": fused_update.fused_level_update.launches}


class ServingEngine:
    """One loaded model, one batcher and one worker thread per endpoint.

    Runs on ``cuda`` unless ``device`` names another device; without a card
    it raises unless ``device="cpu"``.  ``start(workers=False)`` skips the
    threads, so tests can pump :meth:`process_once` by hand."""

    def __init__(
        self,
        checkpoint_dir: str,
        *,
        buckets: Sequence[int] = (1, 2, 4, 8),
        iters: Optional[int] = None,
        max_wait_ms: float = 5.0,
        max_queue: int = 64,
        device=None,
        ff_impl: Optional[str] = None,
        attention_impl: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        self.checkpoint_dir = checkpoint_dir
        if ckpt_lib.latest_step(checkpoint_dir) is None:
            raise FileNotFoundError(
                f"no finalized checkpoint in {checkpoint_dir!r}; train first, "
                f"or write one with make_demo_checkpoint"
            )
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        step, config, self.train_cfg, params = denoise.load_checkpoint_state(
            checkpoint_dir, device=self.device)
        # None keeps the checkpoint's choice; a value overrides it
        overrides = {k: v for k, v in (("ff_impl", ff_impl), ("attention_impl", attention_impl))
                     if v is not None}
        self.config = dataclasses.replace(config, **overrides)
        self.step = step
        dt = self.config.resolved_compute_dtype
        self.params = glom_model.tree_map(lambda p: p.to(dt), params)
        # resolved once: the step's functions, the locality mask on the device
        self._consensus_fn, self._ff_fn, self._fused_fn = glom_model.resolve_step_fns(
            self.config, self.device)
        self.embed_iters = iters if iters is not None else self.config.default_iters
        recon_iters = iters if iters is not None else (
            self.train_cfg.iters if self.train_cfg.iters is not None
            else self.config.default_iters)
        self.reconstruct_timestep = denoise.resolve_loss_timestep(self.train_cfg, recon_iters)
        if self.device.type == "cuda":
            self._build_kernels()
        self.batchers = {
            ep: DynamicBatcher(max_batch=self.buckets[-1], max_wait_ms=max_wait_ms,
                               max_queue=max_queue)
            for ep in ENDPOINTS
        }
        self._threads = []
        self._started = False

    def _build_kernels(self) -> None:
        """Build the kernels before the first request, so no request waits
        for ``nvcc``, when the config runs any."""
        if (self.config.ff_impl, self.config.attention_impl) != ("dense", "dense"):
            _build.build_all()

    # -- the forward -------------------------------------------------------
    def _forward(self, imgs: torch.Tensor, iters: int) -> torch.Tensor:
        return glom_model.apply(
            self.params["glom"], imgs, config=self.config, iters=iters,
            consensus_fn=self._consensus_fn, ff_fn=self._ff_fn, fused_fn=self._fused_fn,
        )

    def run(self, endpoint: str, imgs: np.ndarray) -> np.ndarray:
        """Run one batch of ``k <= max(buckets)`` images, padded with zeros
        to the nearest bucket; returns the endpoint's output for the ``k``."""
        k = imgs.shape[0]
        bucket = next((b for b in self.buckets if b >= k), None)
        if bucket is None:
            raise ValueError(f"batch of {k} exceeds the largest bucket {self.buckets[-1]}")
        with torch.inference_mode():
            x = torch.zeros((bucket,) + tuple(imgs.shape[1:]), dtype=torch.float32,
                            device=self.device)
            x[:k] = torch.from_numpy(np.ascontiguousarray(imgs, dtype=np.float32)).to(self.device)
            if endpoint == "embed":
                out = self._forward(x, self.embed_iters).mean(dim=1)
            elif endpoint == "reconstruct":
                state = self._forward(x, self.reconstruct_timestep)
                out = decoder_apply(
                    self.params["decoder"], state, self.config,
                    arch=self.train_cfg.decoder, level=self.train_cfg.loss_level,
                )
            else:
                raise ValueError(f"unknown endpoint {endpoint!r}")
            return out[:k].float().cpu().numpy()

    # -- the request path --------------------------------------------------
    def submit(self, endpoint: str, imgs: np.ndarray):
        """Enqueue a ``(k, c, H, W)`` batch; returns the Future of the
        endpoint's output.  Raises the batcher's ``Overloaded`` (shed) or
        ``Closed`` (shutting down)."""
        return self.batchers[endpoint].submit(
            np.ascontiguousarray(imgs, dtype=np.float32), size=imgs.shape[0])

    def process_once(self, endpoint: str, *, block: bool = False,
                     timeout: Optional[float] = None) -> int:
        """Pull one flushed batch and run it; returns the images served."""
        batch = self.batchers[endpoint].next_batch(block=block, timeout=timeout)
        if not batch:
            return 0
        imgs = np.concatenate([item.payload for item in batch])
        try:
            out = self.run(endpoint, imgs)
        except Exception as e:  # the batch's callers get the error; the worker lives on
            for item in batch:
                item.future.set_exception(e)
            return 0
        offset = 0
        for item in batch:
            item.future.set_result(out[offset:offset + item.size])
            offset += item.size
        return offset

    def _worker_loop(self, endpoint: str) -> None:
        batcher = self.batchers[endpoint]
        while True:
            served = self.process_once(endpoint, block=True, timeout=0.25)
            if served == 0 and batcher.closed and batcher.depth == 0:
                return

    def start(self, *, workers: bool = True) -> None:
        if self._started:
            return
        self._started = True
        if workers:
            for ep in ENDPOINTS:
                t = threading.Thread(target=self._worker_loop, args=(ep,),
                                     name=f"glom-torch-serving-{ep}", daemon=True)
                t.start()
                self._threads.append(t)

    def shutdown(self, *, drain: bool = True, timeout: float = 30.0) -> None:
        """Close admission, let queued work flush (``drain=True``) or fail it,
        and join the workers.  Idempotent."""
        for batcher in self.batchers.values():
            batcher.close(drain=drain)
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        self._threads = []

    def health(self) -> dict:
        """The ``/healthz`` payload."""
        c = self.config
        return {
            "status": "ok",
            "step": int(self.step),
            "buckets": list(self.buckets),
            "ff_impl": c.ff_impl,
            "attention_impl": c.attention_impl,
            "image_size": c.image_size,
            "patch_size": c.patch_size,
            "channels": c.channels,
            "levels": c.levels,
            "dim": c.dim,
            "device": str(self.device),
            "queue_depth": {ep: b.depth for ep, b in self.batchers.items()},
            "kernel_launches": kernel_launches(),
        }
