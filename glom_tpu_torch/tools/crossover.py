"""Measure the dense/pallas attention crossover on the card it runs on
(``tools/crossover.py`` of the JAX package).

``attention_impl="auto"`` picks the CUDA consensus kernels above a patch
count measured per GPU generation
(``glom_tpu_torch.models.glom.ATTENTION_CROSSOVER_N``).  This tool times the
REAL train step (``training/denoise.py::make_step_fn``: forward to the loss
timestep, decoder, backward, Adam) at flagship width with the plain
consensus (``dense``) against the kernels (``pallas``: K4 forward, K6 + K7
backward) at several image sizes, and prints the row to add, with the card's
name and power limit beside it.  The FF runs on its kernels in both legs, so
the legs differ in the attention alone.

    python -m glom_tpu_torch.tools.crossover                 # n in {256, 576, 1024}
    python -m glom_tpu_torch.tools.crossover --steps 5 --sizes 112 224
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.models.glom import ATTENTION_CROSSOVER_N, gpu_generation
from glom_tpu_torch.training.trainer import Trainer

# flagship-dim model at growing image sizes: n = (image_size / 14)^2
IMAGE_SIZES = (224, 336, 448)   # n = 256, 576, 1024
PATCH = 14


def time_step(config: GlomConfig, batch: int, steps: int, warmup: int, device) -> float:
    """Images per second of the denoising train step for ``config``, host
    clock around ``steps`` steps that end in a synchronize."""
    train = TrainConfig(batch_size=batch, iters=12, log_every=0)
    trainer = Trainer(config, train, device=device)
    gen = torch.Generator().manual_seed(0)
    img = torch.randn((batch, config.channels, config.image_size, config.image_size),
                      generator=gen).to(device)
    for _ in range(warmup):
        trainer.step(img)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.step(img)
    torch.cuda.synchronize(device)
    return batch * steps / (time.perf_counter() - t0)


def measure(sizes, *, batch: int = 8, steps: int = 10, warmup: int = 2, device="cuda",
            ff_impl: str = "pallas") -> dict:
    """The table and the row it implies for ``device``'s generation."""
    device = torch.device(device)
    rows, crossover = [], None
    for size in sorted(sizes):
        n = (size // PATCH) ** 2
        rates = {}
        for impl in ("dense", "pallas", "pallas", "dense"):   # in turns, on one card
            cfg = GlomConfig(dim=512, levels=6, image_size=size, patch_size=PATCH,
                             ff_impl=ff_impl, ff_fused_bwd=True, attention_impl=impl)
            rates.setdefault(impl, []).append(time_step(cfg, batch, steps, warmup, device))
        mean = {k: sum(v) / len(v) for k, v in rates.items()}
        winner = max(mean, key=mean.get)
        rows.append({"n": n, "image_size": size, "dense": mean["dense"], "pallas": mean["pallas"],
                     "runs": rates, "winner": winner})
        print(f"n={n:5d}: dense {mean['dense']:8.2f} pallas {mean['pallas']:8.2f} imgs/s "
              f"-> {winner}", flush=True)
        if winner == "dense":
            crossover = n   # the largest measured n where dense still wins
    if rows and crossover is None:
        # the kernels won at every measured n: the row sits below the smallest
        crossover = min(r["n"] for r in rows) - 1
    return {"rows": rows, "crossover_n": crossover}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--sizes", type=int, nargs="+", default=list(IMAGE_SIZES))
    p.add_argument("--device-probe-timeout", type=float, default=240,
                   help="seconds the first touch of the card may take before the tool "
                        "emits an error line and exits 2 (glom_tpu_torch.device_guard); "
                        "<= 0 disables the guard")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("refusing: no CUDA device; the crossover is a property of the card")
    from glom_tpu_torch.device_guard import guarded_cuda_init

    guarded_cuda_init("cuda", args.device_probe_timeout,
                      lambda msg: print(f"crossover: {msg}", file=sys.stderr, flush=True))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = gpu_generation("cuda")
    result = measure(args.sizes, batch=args.batch_size, steps=args.steps, warmup=args.warmup)
    print(json.dumps({"metric": "attention_crossover", "generation": gen, "nvidia_smi": smi,
                      "batch": args.batch_size, "steps": args.steps, **result}))
    current, found = ATTENTION_CROSSOVER_N.get(gen), result["crossover_n"]
    tag = "matches the committed row" if current == found else f"committed row is {current}"
    print(f'# ATTENTION_CROSSOVER_N["{gen}"] = {found}  # {smi}; {tag}')
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
