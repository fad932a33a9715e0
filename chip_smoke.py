#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``glom_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it builds everything it needs.  Phases,
each printing one JSON line; any failure raises and exits non-zero:

  device   the card's name and power limit (nvidia-smi);
  build    nvcc builds every kernel in glom_tpu_torch/kernels/csrc/;
  kernels  each kernel against its plain PyTorch version at the flagship
           serving shapes (b=8, n=256, L=6, d=512), in float32 and bfloat16,
           with times (CUDA events; per call, the median of 20 runs of 5
           calls after a warm-up) beside the bound and a PyTorch library
           call where one computes the same function; consensus also with
           attend_self, the locality mask and n=2304 (b=1);
  serve    a flagship demo checkpoint (dim 512, 6 levels, 224/14, random
           seeded weights) served over HTTP in-process: /embed with batches
           of 1, 3 and 8, /reconstruct with 2; shapes, finiteness, one
           answer against the plain path on the card, and the kernels'
           launch counts;
  profile  a torch.profiler trace of three b=8 /embed forwards through the
           kernels: the device's busy share and device time by kernel.

Then the kernels' summary line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Float32 matrix products run in full
float32: TF32 is switched off for matmul and cuDNN.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.kernels import _build
from glom_tpu_torch.kernels import consensus as consensus_kernel
from glom_tpu_torch.kernels import ff as ff_kernel
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.ops.consensus import consensus_attention as plain_consensus
from glom_tpu_torch.ops.consensus import l2_normalize
from glom_tpu_torch.ops.feedforward import grouped_ff_apply as plain_ff
from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
from glom_tpu_torch.serving.server import make_server

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = GlomConfig(dim=512, levels=6, image_size=224, patch_size=14)
BATCH = 8
# H100 SXM data-sheet peaks (dense): f32 on the CUDA cores, bf16 on the
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12
# |kernel - plain| <= ATOL + RTOL * |plain|: float32 differs by summation
# order only; bfloat16 outputs may round to neighbouring values (2**-8).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# embeddings after 12 iterations, kernels vs the plain path, float32
SERVE_ATOL = 1e-3
REPS, INNER = 20, 5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Per-call time of ``fn()``: the median over REPS samples, each a run
    of INNER calls between two CUDA events, after a warm-up.  Queuing INNER
    calls back to back keeps the host's launch gaps out of the device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(INNER):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / INNER)
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def compare(got: torch.Tensor, want: torch.Tensor, dtype, what: str) -> dict:
    atol, rtol = TOL[dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool((diff <= atol + rtol * w.abs()).all())
    err = {"max_abs_err": float(diff.max()),
           "max_rel_err": float(diff.max() / w.abs().max().clamp_min(1e-30)),
           "atol": atol, "rtol": rtol}
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version: {err}")
    return err


def phase_build() -> None:
    t0 = time.perf_counter()
    per_source = _build.build_all()
    ptxas = {}
    for name, src in _build.sources().items():
        log = os.path.join(_build.BUILD_DIR, f"{name}-{_build._digest(src)}.log")
        with open(log) as f:
            text = f.read()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", text)]
        ptxas[name] = {"max_registers": max(regs, default=0),
                       "max_spill_store_bytes": max(spills, default=0)}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": per_source, "ptxas": ptxas,
          "flags": " ".join(_build.NVCC_FLAGS)})


def ff_case(params, x, dtype, label):
    out = ff_kernel.grouped_ff(params, x)
    ref = plain_ff(params, x)
    torch.cuda.synchronize()
    err = compare(out, ref, dtype, f"grouped_ff {label}")
    b, n, g, d = x.shape
    h = params["w1"].shape[-1]
    item = x.element_size()
    flops = 4.0 * b * n * g * d * h
    nbytes = item * (2 * b * n * g * d + g * (2 * d * h + h + d))
    bms, by = bound_ms(flops, nbytes, dtype)
    return {"case": label, "dtype": str(dtype).replace("torch.", ""),
            "shape": list(x.shape), **err,
            "kernel_ms": time_ms(lambda: ff_kernel.grouped_ff(params, x)),
            "plain_ms": time_ms(lambda: plain_ff(params, x)),
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "peak_flops": PEAK_FLOPS[dtype], "gflop": flops / 1e9}


def consensus_case(levels, dtype, label, *, attend_self=False, mask=None):
    out, lse = consensus_kernel.consensus_attention(
        levels, attend_self=attend_self, non_local_mask=mask)
    ref, ref_lse = plain_consensus(levels, attend_self=attend_self, non_local_mask=mask)
    torch.cuda.synchronize()
    err = compare(out, ref, dtype, f"consensus {label}")
    lse_err = compare(lse, ref_lse, torch.float32, f"consensus lse {label}")
    b, n, L, d = levels.shape
    item = levels.element_size()
    flops = 4.0 * b * L * n * n * d
    nbytes = 2 * item * b * n * L * d + 4 * b * L * n + (n * n if mask is not None else 0)
    bms, by = bound_ms(flops, nbytes, dtype)
    row = {"case": label, "dtype": str(dtype).replace("torch.", ""),
           "shape": list(levels.shape), **err, "lse_max_abs_err": lse_err["max_abs_err"],
           "kernel_ms": time_ms(lambda: consensus_kernel.consensus_attention(
               levels, attend_self=attend_self, non_local_mask=mask)),
           "plain_ms": time_ms(lambda: plain_consensus(
               levels, attend_self=attend_self, non_local_mask=mask)),
           "library_ms": None, "bound_ms": bms, "bound_by": by,
           "peak_flops": PEAK_FLOPS[dtype], "gflop": flops / 1e9}
    if attend_self and mask is None:
        # the one variant scaled_dot_product_attention computes exactly
        q = levels.transpose(1, 2)
        k = l2_normalize(levels.float()).to(dtype).transpose(1, 2)
        row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, q))
        row["library"] = "torch.nn.functional.scaled_dot_product_attention"
    return row


def phase_kernels(device) -> dict:
    gen = torch.Generator().manual_seed(0)
    c = FLAGSHIP
    n, L, d = c.num_patches, c.levels, c.dim
    params = glom_model.init(gen, c, device)
    lwi = torch.randn((BATCH, n, L + 1, d), generator=gen).to(device)
    levels = torch.randn((BATCH, n, L, d), generator=gen).to(device)
    big = torch.randn((1, 2304, L, d), generator=gen).to(device)   # 384/8
    mask = glom_model.resolve_locality_mask(
        GlomConfig(dim=d, levels=L, image_size=224, patch_size=14,
                   local_consensus_radius=2), device)
    ff_rows, cons_rows = [], []
    ff_kernel.grouped_ff.launches = 0
    consensus_kernel.consensus_attention.launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        cast = glom_model.tree_map(lambda p: p.to(dtype), params)
        x = lwi.to(dtype)
        ff_rows.append(ff_case(cast["bottom_up"], x[..., :-1, :], dtype,
                               "bottom_up (strided view, g=6)"))
        pos = cast["pos_emb"][None, :, None, :]
        ff_rows.append(ff_case(cast["top_down"], x[..., 2:, :] + pos, dtype, "top_down (g=5)"))
        lv = levels.to(dtype)
        cons_rows.append(consensus_case(lv, dtype, "attend_self=False"))
        cons_rows.append(consensus_case(lv, dtype, "attend_self=True", attend_self=True))
        cons_rows.append(consensus_case(lv, dtype, "local_consensus_radius=2", mask=mask))
        cons_rows.append(consensus_case(big.to(dtype), dtype, "n=2304 (384/8), b=1"))
    # launches of this phase: one checked call and 3 + REPS * INNER timed ones a row
    emit({"phase": "kernels", "kernel": "grouped_ff",
          "launches": ff_kernel.grouped_ff.launches, "rows": ff_rows})
    emit({"phase": "kernels", "kernel": "consensus_attention",
          "launches": consensus_kernel.consensus_attention.launches, "rows": cons_rows})
    # the main path's case, float32; SDPA computes only the attend_self=True
    # variant exactly, so consensus's library time comes from that row (same
    # shapes and work)
    library = {"grouped_ff": None, "consensus_attention": cons_rows[1]["library_ms"]}
    return {"grouped_ff": ff_rows[0], "consensus_attention": cons_rows[0]}, library


def post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def phase_serve(device) -> dict:
    c = FLAGSHIP
    ckpt = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    make_demo_checkpoint(ckpt, config=c, seed=0)
    engine = ServingEngine(ckpt, device=device)
    setup_s = time.perf_counter() - t0
    engine.start()
    server = make_server(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05})
    thread.start()
    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        assert health["ff_impl"] == "pallas" and health["attention_impl"] == "pallas", health
        rng = np.random.default_rng(0)
        shape = (c.channels, c.image_size, c.image_size)
        imgs = {k: rng.standard_normal((k,) + shape).astype(np.float32) for k in (1, 2, 3, 8)}

        ff_kernel.grouped_ff.launches = 0
        consensus_kernel.consensus_attention.launches = 0
        requests = []
        for endpoint, k in (("embed", 1), ("embed", 3), ("embed", 8), ("reconstruct", 2)):
            t = time.perf_counter()
            reply = post(f"{base}/{endpoint}", {"images": imgs[k].tolist()})
            wall_ms = (time.perf_counter() - t) * 1e3
            key = "embeddings" if endpoint == "embed" else "images"
            out = np.asarray(reply[key], dtype=np.float32)
            want = (k, c.levels, c.dim) if endpoint == "embed" else (k,) + shape
            assert out.shape == want, (endpoint, out.shape, want)
            assert np.isfinite(out).all(), f"{endpoint} k={k}: non-finite output"
            requests.append({"endpoint": endpoint, "k": k, "shape": list(out.shape),
                             "server_latency_ms": reply["latency_ms"],
                             "client_wall_ms": wall_ms, "out": out})
        launches = {"grouped_ff": ff_kernel.grouped_ff.launches,
                    "consensus_attention": consensus_kernel.consensus_attention.launches}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        engine.shutdown(drain=True)

    iters, t = engine.embed_iters, engine.reconstruct_timestep
    expected = {"grouped_ff": 3 * 2 * iters + 2 * t,
                "consensus_attention": 3 * iters + t}
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")

    # one /embed answer against the plain path (dense ops) on the card
    plain_cfg = GlomConfig(**{**engine.config.to_json_dict(),
                              "ff_impl": "dense", "attention_impl": "dense"})
    with torch.inference_mode():
        x = torch.from_numpy(imgs[3]).to(device)
        plain = glom_model.apply(engine.params["glom"], x, config=plain_cfg,
                                 iters=iters).mean(dim=1).cpu().numpy()
    served = requests[1]["out"]
    embed_err = float(np.abs(served - plain).max())
    if not embed_err <= SERVE_ATOL:
        raise AssertionError(f"/embed differs from the plain path by {embed_err} > {SERVE_ATOL}")
    for r in requests:
        del r["out"]

    # one b=8 /embed forward (12 iterations), host clock to the result on the
    # host, through the kernels and through the plain ops: median of 5
    x8 = torch.from_numpy(imgs[8]).to(device)

    def forward_ms(cfg):
        times = []
        with torch.inference_mode():
            for _ in range(6):
                t0 = time.perf_counter()
                glom_model.apply(engine.params["glom"], x8, config=cfg,
                                 iters=iters).mean(dim=1).cpu()
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:])

    embed_b8_ms = {"kernels": forward_ms(engine.config), "plain": forward_ms(plain_cfg)}
    emit({"phase": "serve", "config": {"dim": c.dim, "levels": c.levels,
                                       "image_size": c.image_size, "patch_size": c.patch_size,
                                       "iters": iters, "reconstruct_timestep": t},
          "setup_seconds": setup_s, "requests": requests,
          "buckets_run": {"embed": [1, 4, 8], "reconstruct": [2]},
          "launches": launches,
          "launches_per_bucket": {"embed": {"grouped_ff": 2 * iters, "consensus_attention": iters},
                                  "reconstruct": {"grouped_ff": 2 * t, "consensus_attention": t}},
          "embed_vs_plain_max_abs_err": embed_err, "embed_atol": SERVE_ATOL,
          "embed_b8_forward_ms": embed_b8_ms})
    phase_profile(lambda: glom_model.apply(engine.params["glom"], x8, config=engine.config,
                                           iters=iters).mean(dim=1).cpu())
    return launches


def phase_profile(forward, runs: int = 3) -> None:
    """A torch.profiler trace of ``runs`` b=8 /embed forwards through the
    kernels: the device's busy share of the window (the sum of kernel times
    on the one stream over the host-clock window, which the profiler itself
    lengthens) and device time by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        forward()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(runs):
                forward()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # the kernels themselves, not the host-side ops that launched them
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted(kernels, key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in rows) / 1e3
    emit({"phase": "profile", "runs": runs, "window_ms": window_ms, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / window_ms,
          "by_name": [{"name": e.key[:80], "count": e.count, "device_ms": device_us(e) / 1e3}
                      for e in rows[:12]]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": {"matmul": False, "cudnn": False}})
    phase_build()
    main_rows, library = phase_kernels(device)
    launches = phase_serve(device)
    summary = []
    for name, source, replaces in (
        ("grouped_ff", "glom_tpu_torch/kernels/csrc/grouped_ff.cu",
         "glom_tpu/kernels/ff_pallas.py:124"),
        ("consensus_attention", "glom_tpu_torch/kernels/csrc/consensus.cu",
         "glom_tpu/kernels/consensus_pallas.py:217 and :153"),
    ):
        row = main_rows[name]
        summary.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": row["max_abs_err"],
                        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": library[name], "case": row["case"],
                        "dtype": row["dtype"],
                        "library_case": None if library[name] is None else "attend_self=True"})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
