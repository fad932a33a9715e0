#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``glom_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                    # every phase: the smoke test
    python3 chip_smoke.py --only k1,train    # device, build and the named phases

Run from the root of a checkout; it builds everything it needs.  Phases,
each printing one JSON line; any failure raises and exits non-zero.  With
``--only`` the run is partial, exits 3 and prints no ok line.

  device   the card's name and power limit (nvidia-smi);
  build    nvcc builds every kernel in glom_tpu_torch/kernels/csrc/;
  kernels  each kernel against its plain PyTorch version at the flagship
           shapes (b=8, n=256, L=6, d=512), in float32 and bfloat16, with
           times (CUDA events; per call, the median of 20 runs of 5 calls
           after a warm-up) beside the bound and a PyTorch library call
           where one computes the same function: the forward kernels (K1's
           rows as the k1 phase gives them; K4/K5) and the backward ones (K2, K3 of the grouped FF; K6, K7 of
           consensus; K2 hands K3 the hidden and K6 hands K7 its dS', and
           each pair is timed together); K2 also at b=1 and at 49 rows
           (off its 32-row tile); consensus also with attend_self, the
           locality mask, b=1 and n=2304 (b=1, with SDPA's time on those
           inputs; the backward without b=1); and the fused level update
           (K8's rows as the k8 phase gives them);
  k1       (only with --only) K1's rows of the kernels phase alone: the
           bottom-up (g=6, strided view), top-down (g=5) and fuse_ff (g=11)
           calls at b=8, and b=1 and 49 rows (strided views), in float32
           and bfloat16; each with its split count, its bound, the plain
           version's time and a yardstick (two torch.baddbmm calls and an
           exact GELU in full float32 on the same inputs), and at b=8 in
           float32 its error against float64;
  k2       (only with --only) K2's rows of the kernels phase alone;
  k6       (only with --only) K6's rows: at b=8 (in float32 also
           against float64), with attend_self (beside the backward of
           scaled_dot_product_attention), with the locality mask, at n=2304
           (b=1) and at b=1, in float32 and bfloat16: K6 with the dS' it
           hands K7 (held against the plain dS'), K7 on that dS' (its plain
           version the twin on the same dS'), and the pair timed together
           against the TPU kernels' work; each with its bound and a bitwise
           repeat;
  k8       (only with --only) K8's rows of the kernels phase alone: the
           fused level update at b=8 and b=1 (views of one (b, n, L+1, d)
           state), and at b=8 with attend_self and with the locality mask,
           in float32 and bfloat16, against its plain version; each with
           its split counts (K8b's hidden, the consensus keys), its bound,
           a bitwise repeat, and for b=8 and b=1 the plain version's time
           and two yardsticks on the same inputs: the kernels K8 replaces
           (K1 + K1 + K4 and the elementwise tail) and K1 over both nets'
           11 groups in one call + K4 + the tail; at b=8 in float32 its
           error against float64;
  k3       (only with --only) K3's rows: for the bottom-up (g=6, strided
           view) and top-down (g=5) calls at b=8, b=1 and 49 rows, in
           float32 and bfloat16, K2 with the hidden it hands K3, K3 on that
           hidden (its library column: two torch.bmm calls and a column
           sum on the same hidden), and the pair timed together against the
           TPU kernels' work;
  serve    a flagship demo checkpoint (dim 512, 6 levels, 224/14, random
           seeded weights) served over HTTP in-process: /embed with batches
           of 1, 3 and 8, /reconstruct with 2; shapes, finiteness, one
           answer against the plain path on the card, and the kernels'
           launch counts;
  profile  a torch.profiler trace of three b=8 /embed forwards through the
           kernels: the device's busy share and device time by kernel;
  train    the denoising train step at flagship width, b=8, through the
           kernels (Trainer.fit, 10 steps on one resident synthetic batch):
           finite, falling losses; ms per step and images/s against the
           plain ops on the card and, timed only, against ff_fused_bwd=False
           (K1 with the plain float32 VJP of the grouped FF); one step's gradients against the plain
           path; two runs of one step bitwise equal; the launches of all six
           kernels per step; one step's peak device memory, through the
           kernels and through the plain ops; a torch.profiler trace of two
           steps; and the checkpoint the trainer saved, served over HTTP on
           /embed;
  serve_fused  the same checkpoint served with ff_impl="fused" over HTTP:
           /embed with 1 and 8, /reconstruct with 2; the answer against the
           plain path and against the "pallas" engine; K8's launches (and
           none of K1 or K4); the b=8 forward's time on the three paths; a
           traced window;
  train_fused  Trainer.fit at flagship width, b=8, ff_impl="fused" (K8
           forward; K1, K4 again and K2, K3, K6, K7 backward), 5 steps:
           losses, launches per step, gradients against the plain path,
           bitwise repeat, one step's peak device memory, ms per step
           beside the "pallas" step's; then 2
           steps each with remat=True and with fuse_ff=True, held the same
           way.

Then the kernels' summary line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Float32 matrix products run in full
float32: TF32 is switched off for matmul and cuDNN.
"""

from __future__ import annotations

import itertools
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

from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.kernels import _build
from glom_tpu_torch.kernels import consensus as consensus_kernel
from glom_tpu_torch.kernels import ff as ff_kernel
from glom_tpu_torch.kernels import fused_update as fused_kernel
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.ops import consensus as plain_cons
from glom_tpu_torch.ops import feedforward as plain_ffm
from glom_tpu_torch.ops.consensus import consensus_attention as plain_consensus
from glom_tpu_torch.ops.consensus import l2_normalize
from glom_tpu_torch.ops.feedforward import grouped_ff_apply as plain_ff
from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
from glom_tpu_torch.serving.server import make_server
from glom_tpu_torch.training import denoise
from glom_tpu_torch.training.metrics import MetricLogger
from glom_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = GlomConfig(dim=512, levels=6, image_size=224, patch_size=14)
BATCH = 8
# H100 SXM data-sheet peaks (dense): f32 on the CUDA cores, bf16 on the
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12
# Each kernel is held against its plain version computed in float32 on the
# same inputs (a bfloat16 input is exact in float32), with limits scaled to
# the output and RTOL by the kernel's type:
#   normwise     ||got - want|| <= RTOL ||want||           (Frobenius norms)
#   elementwise  |got - want| <= RTOL (min(1, max|want|) + |want|)
# float32 differs by summation order only; a bfloat16 output is rounded once,
# by at most 2**-8 of each value.  K6 adds its key term to a larger value
# term, so the key term is also held on its own:
#   ||got - want|| <= RTOL ||key term|| + u ||want||
# with u the output type's unit roundoff (2**-24, 2**-8).
RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# the tensor cores' dense TF32 rate; the float32 kernels take three TF32
# passes a product (3xTF32), bounding them at 3 * FLOPs over this rate
TF32_FLOPS = 495e12
# embeddings after 12 iterations, kernels vs the plain path, float32
SERVE_ATOL = 1e-3
REPS, INNER = 20, 5
# one train step's gradients, kernels vs the plain path, float32: relative
# (Frobenius) error per parameter leaf
GRAD_RTOL = 1e-4
TRAIN_STEPS = 10
FUSED_TRAIN_STEPS = 5
KNOB_TRAIN_STEPS = 2


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
    calls back to back keeps the host's launch gaps out of the device time;
    one more call queued before the start event keeps the card busy while
    the host prepares the first timed one, whose preparation would otherwise
    count as device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()
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


def bounds(flops: float, nbytes: float, dtype) -> dict:
    """The bound (the function's own: its type's peak rate) and, for a
    float32 kernel, the bound of its method, 3xTF32 on the tensor cores."""
    bms, by = bound_ms(flops, nbytes, dtype)
    tf32 = (max(3 * flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
            if dtype == torch.float32 else None)
    return {"bound_ms": bms, "bound_by": by, "bound_3xtf32_ms": tf32,
            "peak_flops": PEAK_FLOPS[dtype], "gflop": flops / 1e9}


def f32(tree):
    """A tensor or a dict of tensors in float32."""
    return glom_model.tree_map(lambda t: t.float(), tree) if isinstance(tree, dict) else tree.float()


def compare(got: torch.Tensor, want: torch.Tensor, dtype, what: str, part=None) -> dict:
    """``got`` (the kernel's, in ``dtype``) against ``want`` (the plain
    version in float32) under the limits stated at RTOL; ``part``, a term of
    ``want`` held on its own."""
    rtol = RTOL[dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    top = float(w.abs().max())
    err_norm, want_norm = float(torch.linalg.vector_norm(diff)), float(torch.linalg.vector_norm(w))
    err = {"max_abs_err": float(diff.max()), "norm_rel_err": err_norm / max(want_norm, 1e-30),
           "want_rms": want_norm / w.numel() ** 0.5, "want_max": top, "rtol": rtol}
    ok = (bool(torch.isfinite(g).all()) and err_norm <= rtol * want_norm
          and bool((diff <= rtol * (min(1.0, top) + w.abs())).all()))
    if part is not None:
        part_norm = float(torch.linalg.vector_norm(part.float()))
        u = torch.finfo(dtype).eps / 2
        err.update({"part_rms": part_norm / w.numel() ** 0.5,
                    "part_rel_err": err_norm / max(part_norm, 1e-30),
                    "part_limit": rtol + u * want_norm / max(part_norm, 1e-30)})
        ok = ok and err["part_rel_err"] <= err["part_limit"]
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
        # (kernel, template arguments: element type and width) of each
        # function that spills, and the registers of each
        kernel = r"([a-z_]+_kernel)I(\w+?)E"

        def label(m):
            return f"{m[0]}<{m[1].replace('13__nv_bfloat16', 'bf16').replace('Li', ',')}>"

        spilling = [f"{label(m)} {m[2]} B"
                    for m in re.findall(r"Function properties for \S*?" + kernel +
                                        r"\S*\s+\d+ bytes stack frame, (\d+) bytes spill stores",
                                        text) if int(m[2])]
        per_kernel = {}
        for fn, body in re.findall(r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry|\Z)",
                                   text, re.S):
            m = re.search(kernel, fn)
            used = re.search(r"Used (\d+) registers", body)
            if m and used:
                per_kernel[label((m[1], m[2]))] = int(used[1])
        ptxas[name] = {"max_registers": max(regs, default=0), "spills": spilling,
                       "registers": per_kernel}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": per_source, "ptxas": ptxas,
          "flags": " ".join(_build.NVCC_FLAGS)})


def grouped_ff_f64(params, x):
    """The grouped FF's output computed in float64 on the same inputs: the
    exact value against which K1 and its float32 plain version are both
    measured."""
    x64 = x.double()
    w1, b1, w2, b2 = (params[k].double() for k in ("w1", "b1", "w2", "b2"))
    pre = torch.einsum("bngd,gdh->bngh", x64, w1) + b1
    hid = 0.5 * pre * (1.0 + torch.erf(pre * 2.0 ** -0.5))
    return torch.einsum("bngh,ghd->bngd", hid, w2) + b2


def k1_case(params, x, dtype, label, *, exact=False):
    """K1 (the grouped FF forward) against its plain version computed in
    float32 on the same inputs, with its split count, bound, the plain
    version's time and a yardstick: two torch.baddbmm calls and the exact
    GELU in full float32 on the same inputs arranged (groups, rows, d)
    outside the timing (three calls, never called by the port; no single
    PyTorch call computes K1, so library_ms stays null).  ``exact``: also
    the kernel's and the float32 plain version's error against float64,
    the kernel's held within compare()'s limits."""
    rows, gr, d, h, item = ff_dims(params, x)
    got = ff_kernel.grouped_ff(params, x)
    want = plain_ff(f32(params), x.float())
    torch.cuda.synchronize()
    err = compare(got, want, dtype, f"grouped_ff {label}")
    flops = 4.0 * rows * gr * d * h
    nbytes = item * (2 * rows * gr * d + gr * (2 * d * h + h + d))
    row = {"kernel": "grouped_ff", "case": label, "dtype": str(dtype).replace("torch.", ""),
           "shape": list(x.shape), "splits": ff_kernel.planned_splits(x.device, rows, gr, d, h, dtype),
           **err, "bitwise_repeat": torch.equal(got, ff_kernel.grouped_ff(params, x))}
    if not row["bitwise_repeat"]:
        raise AssertionError(f"grouped_ff {label}: two calls differ")
    if exact:
        want64 = grouped_ff_f64(params, x)
        row["vs_f64"] = {"kernel": error_vs([got], [want64], dtype),
                         "plain_f32": error_vs([want], [want64], dtype)}
        vs = row["vs_f64"]["kernel"]
        if not (vs["norm_rel_err"] <= RTOL[dtype] and vs["limit_share"] <= 1.0):
            raise AssertionError(f"grouped_ff {label}: off the float64 values by {vs}")
        del want64
    del got, want
    xg = x.float().reshape(rows, gr, d).transpose(0, 1).contiguous()
    w1, b1, w2, b2 = (params[k].float() for k in ("w1", "b1", "w2", "b2"))
    b1, b2 = b1[:, None, :], b2[:, None, :]
    row.update({
        "kernel_ms": time_ms(lambda: ff_kernel.grouped_ff(params, x)),
        "plain_ms": time_ms(lambda: plain_ff(params, x)),
        "yardstick_ms": time_ms(lambda: torch.baddbmm(
            b2, F.gelu(torch.baddbmm(b1, xg, w1), approximate="none"), w2)),
        "yardstick": "torch.baddbmm, F.gelu(approximate='none'), torch.baddbmm in full float32 "
                     "on the same inputs arranged (groups, rows, d)",
        "library_ms": None, **bounds(flops, nbytes, dtype)})
    return row


def k1_inputs(cast, x):
    """K1's cases: ``(label, params, x)`` for the main path's two calls at
    b=8 (the bottom-up strided view, g=6, and the top-down input, g=5), the
    fuse_ff call (both nets as one call of 11 groups), then b=1 and 49 rows
    (off the 64-row tile) as strided views."""
    pos = cast["pos_emb"][None, :, None, :]
    bu, td = cast["bottom_up"], cast["top_down"]
    td_in = x[..., 2:, :] + pos
    both = {k: torch.cat([bu[k], td[k]]) for k in ("w1", "b1", "w2", "b2")}
    return (("bottom_up (strided view, g=6)", bu, x[..., :-1, :]),
            ("top_down (g=5)", td, td_in),
            ("fuse_ff (g=11)", both, torch.cat([x[..., :-1, :], td_in], dim=-2)),
            ("bottom_up b=1 (strided view, g=6)", bu, x[:1, :, :-1, :]),
            ("bottom_up 49 rows (strided view, g=6)", bu, x[:1, :49, :-1, :]))


def k1_rows(cast, x, dtype):
    """K1's rows in ``dtype``, one a case of k1_inputs; the b=8 cases in
    float32 also against float64."""
    return [k1_case(p, xx, dtype, label, exact=dtype == torch.float32 and xx.shape[0] == BATCH)
            for label, p, xx in k1_inputs(cast, x)]


def consensus_case(levels, dtype, label, *, attend_self=False, mask=None, library=None):
    """K4 against its plain version computed in float32.  ``library``
    (default: attend_self=True without a mask, the one variant
    scaled_dot_product_attention computes exactly) also times SDPA on that
    variant of the same inputs: the same shapes and work."""
    out, lse = consensus_kernel.consensus_attention(
        levels, attend_self=attend_self, non_local_mask=mask)
    ref, ref_lse = plain_consensus(levels.float(), attend_self=attend_self, non_local_mask=mask)
    torch.cuda.synchronize()
    err = compare(out, ref, dtype, f"consensus {label}")
    lse_err = compare(lse, ref_lse, torch.float32, f"consensus lse {label}")
    b, n, L, d = levels.shape
    item = levels.element_size()
    flops = 4.0 * b * L * n * n * d
    nbytes = 2 * item * b * n * L * d + 4 * b * L * n + (n * n if mask is not None else 0)
    row = {"case": label, "dtype": str(dtype).replace("torch.", ""),
           "shape": list(levels.shape), **err, "lse_max_abs_err": lse_err["max_abs_err"],
           "kernel_ms": time_ms(lambda: consensus_kernel.consensus_attention(
               levels, attend_self=attend_self, non_local_mask=mask)),
           "plain_ms": time_ms(lambda: plain_consensus(
               levels, attend_self=attend_self, non_local_mask=mask)),
           "library_ms": None, **bounds(flops, nbytes, dtype)}
    if library is None:
        library = attend_self and mask is None
    if library:
        q = levels.transpose(1, 2)
        k = l2_normalize(levels.float()).to(dtype).transpose(1, 2)
        row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, q))
        row["library"] = "torch.nn.functional.scaled_dot_product_attention"
        row["library_case"] = "attend_self=True"
    return row


def ff_dims(params, x):
    """``(rows, groups, d, h, element bytes)`` of a grouped-FF call."""
    b, n, gr, d = x.shape
    return b * n, gr, d, params["w1"].shape[-1], x.element_size()


def k2_case(params, x, g, dtype, label):
    """K2 (dX) against its plain version, the hidden it stores for K3 against
    the plain hidden: ``(row, hidden)``.  The row times K2 with the stores
    (the main path's call, ``kernel_ms``) and without them; ``hidden`` is
    what K3 then reads."""
    rows, gr, d, h, item = ff_dims(params, x)
    p32, x32, g32 = f32(params), x.float(), g.float()
    got, hidden = ff_kernel.grouped_ff_dx(params, x, g, keep_hidden=True)
    want = plain_ffm.grouped_ff_dx(p32, x32, g32)
    torch.cuda.synchronize()
    err = compare(got, want, dtype, f"grouped_ff_dx {label}")
    row = {"kernel": "grouped_ff_dx", "case": label, "dtype": str(dtype).replace("torch.", ""),
           "shape": list(x.shape), "splits": ff_kernel.planned_dx_splits(x.device, rows, gr, d, h, dtype),
           **err}
    for name, u, v in zip(("hid", "dh"), hidden, plain_ffm.grouped_ff_hidden(p32, x32, g32)):
        row[f"{name}_norm_rel_err"] = compare(u, v, torch.float32,
                                              f"grouped_ff_dx {label} {name}")["norm_rel_err"]
    handoff_bytes = 2 * 4 * gr * rows * h   # hid and dh, f32, written once
    row["kernel_ms"] = time_ms(lambda: ff_kernel.grouped_ff_dx(params, x, g, keep_hidden=True))
    row["kernel_ms_no_handoff"] = time_ms(lambda: ff_kernel.grouped_ff_dx(params, x, g))
    flops = 6.0 * rows * gr * d * h
    nbytes = item * (3 * rows * gr * d + gr * (2 * d * h + h)) + handoff_bytes
    row.update({"handoff_bytes": handoff_bytes,
                "plain_ms": time_ms(lambda: plain_ffm.grouped_ff_dx(params, x, g)),
                "library_ms": None, **bounds(flops, nbytes, dtype)})
    return row, hidden


def grouped_ff_dw_f64(params, x, g):
    """``(dW1, db1, dW2)`` of the grouped FF computed in float64 (the
    formulas of plain.grouped_ff_dw, the cotangent cast to ``x``'s type
    first): the exact sums against which K3 and its float32 plain version
    are both measured."""
    x64, g64 = x.double(), g.to(x.dtype).double()
    w1, b1, w2 = (params[k].double() for k in ("w1", "b1", "w2"))
    pre = torch.einsum("bngd,gdh->bngh", x64, w1) + b1
    cdf = 0.5 * (1.0 + torch.erf(pre * 2.0 ** -0.5))
    pdf = torch.exp(-0.5 * pre * pre) / (2.0 * np.pi) ** 0.5
    dh = torch.einsum("bngd,ghd->bngh", g64, w2) * (cdf + pre * pdf)
    return (torch.einsum("bngd,bngh->gdh", x64, dh), dh.sum(dim=(0, 1)),
            torch.einsum("bngh,bngd->ghd", pre * cdf, g64))


def error_vs(got, exact, dtype) -> dict:
    """The worst over outputs of ``got`` against ``exact`` (float64):
    normwise relative error, and the largest share of compare()'s
    elementwise limit that any element uses."""
    out = {"norm_rel_err": 0.0, "limit_share": 0.0}
    for u, w in zip(got, exact):
        diff = (u.double() - w).abs()
        limit = RTOL[dtype] * (min(1.0, float(w.abs().max())) + w.abs())
        out["norm_rel_err"] = max(out["norm_rel_err"],
                                  float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(w)))
        out["limit_share"] = max(out["limit_share"], float((diff / limit).max()))
    return out


def k3_case(params, x, g, hidden, dtype, label, k2_ms):
    """K3 (dW) against the reference plain.grouped_ff_dw; the worst of its
    three outputs.  K3 reads ``hidden`` (K2's) and does 4 units of
    rows*d*h*groups FLOPs, reading x, dO and the hidden; its plain version
    is the twin on the same hidden, and its library time two torch.bmm
    calls in full float32 and the column sum of dH on the same hidden.
    ``k2_ms``: the time of the K2 it needs, beside it."""
    rows, gr, d, h, item = ff_dims(params, x)
    outputs = gr * (2 * d * h + h)
    hid, dh = hidden
    call = lambda: ff_kernel.grouped_ff_dw(params, x, g, hidden)
    plain = lambda: plain_ffm.grouped_ff_dw_from_hidden(x, g, hid, dh, dtype)
    flops = 4.0 * rows * gr * d * h
    nbytes = item * (2 * rows * gr * d + outputs) + 2 * 4 * gr * rows * h
    got = call()
    want = plain_ffm.grouped_ff_dw(f32(params), x.float(), g.float())
    torch.cuda.synchronize()
    errs = [compare(u, v, dtype, f"grouped_ff_dw {label} {k}")
            for k, u, v in zip(("w1", "b1", "w2"), got, want)]
    # both against the exact sums: over thousands of rows the float32 plain
    # version's own rounding is of the order of the kernel's
    exact = grouped_ff_dw_f64(params, x, g)
    vs_f64 = {"kernel": error_vs(got, exact, dtype), "plain_f32": error_vs(want, exact, dtype)}
    del exact
    row = {"kernel": "grouped_ff_dw", "case": label, "dtype": str(dtype).replace("torch.", ""),
           "shape": list(x.shape), **max(errs, key=lambda e: e["norm_rel_err"]),
           "bitwise_repeat": all(torch.equal(u, v) for u, v in zip(got, call())),
           "vs_f64": vs_f64, "splits": ff_kernel.planned_dw_splits(x.device, rows, gr, d, h, dtype),
           "kernel_ms": time_ms(call), "k2_ms": k2_ms, "plain_ms": time_ms(plain),
           "library_ms": None, **bounds(flops, nbytes, dtype)}
    if not row["bitwise_repeat"]:
        raise AssertionError(f"grouped_ff_dw {label}: two calls differ")
    # the yardstick on the same hidden: dW1 = X^T dH and dW2 = H^T dO as
    # batched products over the groups, in full float32 (x and dO cast
    # outside the timing for bf16), and db1 = dH summed over rows
    xg = x.float().reshape(rows, gr, d).transpose(0, 1)
    gg = g.float().reshape(rows, gr, d).transpose(0, 1)
    row["library_ms"] = time_ms(lambda: (torch.bmm(xg.transpose(1, 2), dh), dh.sum(dim=1),
                                         torch.bmm(hid.transpose(1, 2), gg)))
    row["library"] = ("two torch.bmm calls in full float32 (X^T dH, H^T dO) and dH.sum over "
                      "rows, on the same hidden")
    return row


def pair_case(params, x, g, dtype, label, k2_ms, k3_ms):
    """K2 + K3 as the backward runs them (K2 handing K3 the hidden), timed
    together, against the bound of the work dX and dW need: 10 units of
    rows*d*h*groups FLOPs (x W1, dO W2^T, dH W1^T, X^T dH, H^T dO; the TPU
    kernels do 14, their K3 forming the hidden again), reading x, dO and the
    weights and writing dX and dW once."""
    rows, gr, d, h, item = ff_dims(params, x)
    call = lambda: ff_kernel.grouped_ff_dw(
        params, x, g, ff_kernel.grouped_ff_dx(params, x, g, keep_hidden=True)[1])
    flops = 10.0 * rows * gr * d * h
    nbytes = item * (3 * rows * gr * d + 2 * gr * (2 * d * h + h))
    return {"kernel": "grouped_ff_dx+grouped_ff_dw", "case": label,
            "dtype": str(dtype).replace("torch.", ""), "shape": list(x.shape),
            "kernel_ms": time_ms(call), "k2_ms": k2_ms, "k3_ms": k3_ms,
            "work": "10 units, what dX and dW need (the TPU kernels do 14)",
            **bounds(flops, nbytes, dtype)}


def consensus_bwd_f64(levels, g, attend_self=False, mask=None):
    """``(dKV, dQ)`` of consensus attention in float64, the forward's out,
    lse and delta included: the exact values against which K6, K7 and their
    float32 plain versions are measured."""
    x, gd = levels.double(), g.to(levels.dtype).double()
    n, d = x.shape[1], x.shape[-1]
    k = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    sim = torch.einsum("bild,bjld->blij", x, k) * d ** -0.5
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    if not attend_self:
        sim = sim.masked_fill(eye, -5e-4)
    if mask is not None:
        sim = sim.masked_fill(mask.bool(), -torch.finfo(torch.float32).max)
    p = torch.softmax(sim, dim=-1)
    out = torch.einsum("blij,bjld->bild", p, x)
    delta = (gd * out).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (torch.einsum("bild,bjld->blij", gd, x) - delta)
    if not attend_self:
        ds = ds.masked_fill(eye, 0.0)
    dk = torch.einsum("blij,bild->bjld", ds, x) * d ** -0.5
    dkv = plain_cons.l2_normalize_vjp(x, dk) + torch.einsum("blij,bild->bjld", p, gd)
    return dkv, torch.einsum("blij,bjld->bild", ds, k) * d ** -0.5


def consensus_bwd_case(levels, g, dtype, label, *, attend_self=False, mask=None, exact=False):
    """K6 (dKV, storing the dS' it hands K7), K7 (dQ, a product of that dS'
    and the levels) and the pair as consensus_backward runs them, against
    their plain versions; three rows.  K6's key term, which its output adds
    to the larger value term, is also held on its own, and dS' against the
    plain dS'.  The library time is SDPA's backward (dQ, dK, dV) on the
    attend_self=True case, the one variant SDPA computes exactly: the work
    of the pair.  ``exact``: also K6's and K7's error against float64,
    beside the float32 plain versions'."""
    kw = dict(attend_self=attend_self, non_local_mask=mask)
    with torch.no_grad():
        out, lse = consensus_kernel.consensus_attention(levels, **kw)
    delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1).unsqueeze(-1).contiguous()
    b, n, L, d = levels.shape
    item = levels.element_size()
    unit = 2.0 * b * L * n * n * d                 # one (n, n, d) product a (b, l) pair
    side = 8 * b * L * n + (n * n if mask is not None else 0)   # lse, delta, the mask
    ds_bytes = 4 * b * L * n * (-(-n // 32) * 32)
    library = None
    if attend_self and mask is None:
        q = levels.transpose(1, 2).detach().requires_grad_(True)
        k = l2_normalize(levels.float()).to(dtype).transpose(1, 2).detach().requires_grad_(True)
        v = levels.transpose(1, 2).detach().requires_grad_(True)
        o = F.scaled_dot_product_attention(q, k, v)
        go = g.transpose(1, 2)
        library = time_ms(lambda: torch.autograd.grad(o, (q, k, v), go, retain_graph=True))
    dkv_call = lambda: consensus_kernel.consensus_dkv(levels, g, lse, delta, keep_ds=True, **kw)
    got_dkv, ds = dkv_call()
    dq_call = lambda: consensus_kernel.consensus_dq(levels, g, lse, delta, ds=ds, **kw)
    pair_call = lambda: consensus_kernel.consensus_dq(levels, g, lse, delta, ds=dkv_call()[1],
                                                      **kw)
    got_dq = dq_call()
    key_term, _ = plain_cons.consensus_dkv_terms(levels.float(), g.float(), lse, delta, **kw)
    want_dkv = plain_cons.consensus_dkv(levels.float(), g.float(), lse, delta, **kw)
    want_dq = plain_cons.consensus_dq(levels.float(), g.float(), lse, delta, **kw)
    torch.cuda.synchronize()
    common = {"case": label, "dtype": str(dtype).replace("torch.", ""),
              "shape": list(levels.shape)}
    k6 = {"kernel": "consensus_dkv", **common,
          **compare(got_dkv, want_dkv, dtype, f"consensus_dkv {label}", part=key_term)}
    k7 = {"kernel": "consensus_dq", **common,
          **compare(got_dq, want_dq, dtype, f"consensus_dq {label}")}
    want_ds = plain_cons.consensus_ds(levels.float(), g.float(), lse, delta, **kw)
    k6["ds_norm_rel_err"] = compare(ds, want_ds, torch.float32,
                                    f"consensus_dkv {label} dS'")["norm_rel_err"]
    k6["ds_bytes"] = ds_bytes
    del want_ds
    k6["bitwise_repeat"] = torch.equal(got_dkv, dkv_call()[0])
    k7["bitwise_repeat"] = torch.equal(got_dq, dq_call())
    if not (k6["bitwise_repeat"] and k7["bitwise_repeat"]):
        raise AssertionError(f"consensus backward {label}: two calls differ")
    if exact:
        dkv64, dq64 = consensus_bwd_f64(levels, g, attend_self, mask)
        k6["vs_f64"] = {"kernel": error_vs([got_dkv], [dkv64], dtype),
                        "plain_f32": error_vs([want_dkv], [dkv64], dtype)}
        k7["vs_f64"] = {"kernel": error_vs([got_dq], [dq64], dtype),
                        "plain_f32": error_vs([want_dq], [dq64], dtype)}
        del dkv64, dq64
    del key_term, want_dkv, want_dq
    k6.update({"kernel_ms": time_ms(dkv_call),
               "plain_ms": time_ms(lambda: plain_cons.consensus_dkv(levels, g, lse, delta, **kw)),
               "library_ms": library, "work_units": 4,
               **bounds(4 * unit, 3 * item * b * n * L * d + side + ds_bytes, dtype)})
    k7.update({"kernel_ms": time_ms(dq_call),
               "plain_ms": time_ms(lambda: plain_cons.consensus_dq_from_ds(levels, ds)),
               "library_ms": library, "work_units": 1,
               **bounds(unit, 2 * item * b * n * L * d + ds_bytes, dtype)})
    pair = {"kernel": "consensus_dkv+consensus_dq", **common, "kernel_ms": time_ms(pair_call),
            "k6_ms": k6["kernel_ms"], "k7_ms": k7["kernel_ms"], "library_ms": library,
            "work": "5 units, what dQ, dK and dV need (the TPU kernels do 7)",
            **bounds(5 * unit, 4 * item * b * n * L * d + side, dtype)}
    for row in (k6, k7, pair):
        if library is not None:
            row["library"] = ("backward of torch.nn.functional.scaled_dot_product_attention "
                              "(dQ, dK, dV)")
    return [k6, k7, pair]


def k6_rows(levels, g, big, g_big, mask, dtype, *, b1=True):
    """K6, K7 and the pair (consensus_bwd_case) in ``dtype``: b=8 (in
    float32 also against float64), attend_self (with SDPA's backward),
    the locality mask, n=2304 at b=1, and b=1."""
    rows = consensus_bwd_case(levels, g, dtype, "attend_self=False",
                              exact=dtype == torch.float32)
    rows += consensus_bwd_case(levels, g, dtype, "attend_self=True", attend_self=True)
    rows += consensus_bwd_case(levels, g, dtype, "local_consensus_radius=2", mask=mask)
    rows += consensus_bwd_case(big, g_big, dtype, "n=2304 (384/8), b=1")
    if b1:
        rows += consensus_bwd_case(levels[:1], g[:1].contiguous(), dtype, "b=1")
    return rows


def fused_update_f64(bu, td, levels, bottom, pos, mask=None, attend_self=False):
    """The level update computed in float64 on the same inputs: the exact
    value against which K8 and its float32 plain version are both
    measured."""
    def ff(p, x):
        p = {k: v.double() for k, v in p.items()}
        pre = torch.einsum("bngd,gdh->bngh", x, p["w1"]) + p["b1"]
        hid = 0.5 * pre * (1.0 + torch.erf(pre * 2.0 ** -0.5))
        return torch.einsum("bngh,ghd->bngd", hid, p["w2"]) + p["b2"]

    lv = levels.double()
    b, n, L, d = lv.shape
    lwi = torch.cat([bottom.double(), lv], dim=-2)
    terms = ff(bu, lwi[..., :-1, :]) + F.pad(ff(td, lwi[..., 2:, :] + pos.double()), (0, 0, 0, 1))
    del lwi
    keys = lv / lv.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    sim = torch.einsum("bild,bjld->blij", lv, keys) * d ** -0.5
    if not attend_self:
        sim = sim.masked_fill(torch.eye(n, dtype=torch.bool, device=lv.device), -5e-4)
    if mask is not None:
        sim = sim.masked_fill(mask.bool(), -torch.finfo(torch.float32).max)
    cons = torch.einsum("blij,bjld->bild", torch.softmax(sim, -1), lv)
    return (lv + terms + cons) / fused_kernel.update_divisors(L, torch.float64, lv.device)


def k1_k4_update(both, levels, bottom, pos, mask=None, attend_self=False):
    """The update through K1 over both nets' 2L-1 groups in one call (the
    fuse_ff call, ``both``: the two nets' weights concatenated outside the
    timing), K4, and the elementwise tail (cat, pos add, pad, sum, divide):
    the yardstick of K8's design on the same inputs."""
    L = levels.shape[2]
    lwi = torch.cat([bottom, levels], dim=-2)
    y = ff_kernel.grouped_ff(both, torch.cat([lwi[..., :-1, :], lwi[..., 2:, :] + pos], dim=-2))
    cons, _ = consensus_kernel.consensus_attention(levels, attend_self=attend_self,
                                                   non_local_mask=mask)
    td = F.pad(y[..., L:, :], (0, 0, 0, 1))
    return (levels + y[..., :L, :] + td + cons) / fused_kernel.update_divisors(
        L, levels.dtype, levels.device)


def fused_case(params, levels, bottom, dtype, label, *, attend_self=False, mask=None,
               timings=True, exact=False):
    """K8 against its plain version (plain_update: the unfused composition in
    float32 on the same inputs, rounded once to their type); with
    ``timings`` also the plain version's time and two yardsticks on the same
    inputs: the kernels K8 replaces, the unfused composition through K1
    (bottom-up), K1 (top-down), K4 and the elementwise tail
    (``unfused_kernels_ms``), and K1 over both nets' 11 groups in one call,
    K4 and the tail (``k1_g11_k4_ms``).  No single PyTorch call computes a
    whole level update, so library_ms is null.  ``exact``: also the error of
    K8 and of its float32 plain version against float64, K8's held within
    compare()'s limits."""
    bu, td = params["bottom_up"], params["top_down"]
    pos = params["pos_emb"][None, :, None, :]
    kw = dict(attend_self=attend_self, non_local_mask=mask)
    out = fused_kernel.fused_level_update(bu, td, levels, bottom, pos, **kw)
    ref = fused_kernel.plain_update(bu, td, levels, bottom, pos, mask, attend_self=attend_self)
    torch.cuda.synchronize()
    err = compare(out, ref, dtype, f"fused_level_update {label}")
    b, n, L, d = levels.shape
    h = bu["w1"].shape[-1]
    item = levels.element_size()
    flops = 4.0 * b * n * d * h * (2 * L - 1) + 4.0 * b * L * n * n * d
    weights = (2 * L - 1) * (2 * d * h + h + d)
    nbytes = item * (2 * b * n * L * d + b * n * d + n * d + weights) + (
        n * n if mask is not None else 0)
    row = {"case": label, "dtype": str(dtype).replace("torch.", ""), "shape": list(levels.shape),
           "splits": fused_kernel.planned_splits(levels.device, b, n, L, d, h, dtype),
           "key_splits": consensus_kernel.planned_splits(levels.device, b, n, L, d, dtype),
           **err, "bitwise_repeat": torch.equal(
               out, fused_kernel.fused_level_update(bu, td, levels, bottom, pos, **kw)),
           "kernel_ms": time_ms(
               lambda: fused_kernel.fused_level_update(bu, td, levels, bottom, pos, **kw)),
           "plain_ms": None, "unfused_kernels_ms": None, "k1_g11_k4_ms": None, "library_ms": None,
           **bounds(flops, nbytes, dtype)}
    if not row["bitwise_repeat"]:
        raise AssertionError(f"fused_level_update {label}: two calls differ")
    if exact:
        want64 = fused_update_f64(bu, td, levels, bottom, pos, mask, attend_self)
        row["vs_f64"] = {"kernel": error_vs([out], [want64], dtype),
                         "plain_f32": error_vs([ref], [want64], dtype)}
        vs = row["vs_f64"]["kernel"]
        if not (vs["norm_rel_err"] <= RTOL[dtype] and vs["limit_share"] <= 1.0):
            raise AssertionError(f"fused_level_update {label}: off the float64 values by {vs}")
        del want64
    del out, ref
    if timings:
        both = {k: torch.cat([bu[k], td[k]]) for k in ("w1", "b1", "w2", "b2")}
        row["plain_ms"] = time_ms(lambda: fused_kernel.plain_update(
            bu, td, levels, bottom, pos, mask, attend_self=attend_self))
        row["unfused_kernels_ms"] = time_ms(lambda: fused_kernel.reference_update(
            bu, td, levels, bottom, pos, mask, attend_self=attend_self,
            ff_fn=ff_kernel.grouped_ff, consensus_fn=consensus_kernel.consensus_attention))
        row["k1_g11_k4_ms"] = time_ms(lambda: k1_k4_update(both, levels, bottom, pos, mask,
                                                           attend_self))
    return row


def k8_rows(cast, x, mask, dtype):
    """K8's rows in ``dtype`` on views of the (b, n, L+1, d) state ``x``: b=8
    (in float32 also against float64), b=1, then b=8 with attend_self and
    with the locality mask (checked, and timed without the yardsticks)."""
    with torch.inference_mode():
        return [fused_case(cast, x[..., 1:, :], x[..., :1, :], dtype, "b=8",
                           exact=dtype == torch.float32),
                fused_case(cast, x[:1, :, 1:, :], x[:1, :, :1, :], dtype, "b=1"),
                fused_case(cast, x[..., 1:, :], x[..., :1, :], dtype, "b=8, attend_self=True",
                           attend_self=True, timings=False),
                fused_case(cast, x[..., 1:, :], x[..., :1, :], dtype,
                           "b=8, local_consensus_radius=2", mask=mask, timings=False)]


K8_NOTE = ("no single PyTorch call computes a whole level update; unfused_kernels_ms is K1 + "
           "K1 + K4 and the elementwise tail on the same inputs, k1_g11_k4_ms K1 over both "
           "nets' 11 groups in one call, K4 and the tail")
# K8's stages, all launched by its C entry glom_fused_update
K8_STAGES = ("td_input_kernel (levels[l+1] + pos in f32)",
             "hidden_kernel (K8a: both nets' hidden, 2L-1 groups)",
             "consensus_kernel<T, D, float> (K4's kernel, f32 output)",
             "update_kernel (K8b: both nets' second layer and the update)",
             "update_reduce_kernel (K8b's splits, where it splits)")


def flagship_inputs(device):
    """The kernels phase's seeded weights and inputs at the flagship shapes:
    ``(params, lwi (b, n, L+1, d), levels, big (1, 2304, L, d), mask, g_ff,
    g_lv, g_big)``."""
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
    g_ff = torch.randn((BATCH, n, L, d), generator=gen).to(device)
    g_lv = torch.randn((BATCH, n, L, d), generator=gen).to(device)
    g_big = torch.randn((1, 2304, L, d), generator=gen).to(device)
    return params, lwi, levels, big, mask, g_ff, g_lv, g_big


def ff_bwd_inputs(cast, x, g):
    """The grouped-FF backward's cases: ``(label, params, x, dO)`` for the
    main path's two calls (the bottom-up strided view, g=6, and the top-down
    input, g=5), then b=1 (256 rows) and 49 rows (off a 32-row tile), both
    as strided views."""
    pos = cast["pos_emb"][None, :, None, :]
    bu, td = cast["bottom_up"], cast["top_down"]
    return (("bottom_up (strided view, g=6)", bu, x[..., :-1, :], g),
            ("top_down (g=5)", td, (x[..., 2:, :] + pos).contiguous(), g[..., 1:, :].contiguous()),
            ("bottom_up b=1 (strided view, g=6)", bu, x[:1, :, :-1, :], g[:1]),
            ("bottom_up 49 rows (strided view, g=6)", bu, x[:1, :49, :-1, :],
             g[:1, :49].contiguous()))


def k2_rows(cast, x, g, dtype):
    """K2's rows in ``dtype``, one a case of ff_bwd_inputs."""
    return [k2_case(p, xx, gg, dtype, label)[0] for label, p, xx, gg in ff_bwd_inputs(cast, x, g)]


def k3_rows(cast, x, g, dtype, cases=4):
    """The first ``cases`` of ff_bwd_inputs in ``dtype``: for each, K2 (the
    hidden it hands K3), K3 and the pair; three rows a case."""
    rows = []
    for label, p, xx, gg in ff_bwd_inputs(cast, x, g)[:cases]:
        k2, hidden = k2_case(p, xx, gg, dtype, label)
        k3 = k3_case(p, xx, gg, hidden, dtype, label, k2["kernel_ms"])
        del hidden
        rows += [k2, k3, pair_case(p, xx, gg, dtype, label, k2["kernel_ms"], k3["kernel_ms"])]
    return rows


def phase_only(device, name: str) -> None:
    """``--only k1`` (K1's rows), ``--only k2`` (K2's), ``--only k3`` (K3's:
    K2, K3 and the pair a case), ``--only k6`` (K6's: K6, K7 and the pair a
    case) or ``--only k8`` (K8's) in float32 and
    bfloat16, for timing a kernel or a variant of it without the rest of the
    kernels phase."""
    params, lwi, levels, big, mask, g_ff, g_lv, g_big = flagship_inputs(device)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        cast = glom_model.tree_map(lambda p: p.to(dtype), params)
        if name == "k6":
            rows += k6_rows(levels.to(dtype), g_lv.to(dtype), big.to(dtype), g_big.to(dtype),
                            mask, dtype)
        elif name == "k1":
            rows += k1_rows(cast, lwi.to(dtype), dtype)
        elif name == "k8":
            rows += k8_rows(cast, lwi.to(dtype), mask, dtype)
        else:
            fn = k2_rows if name == "k2" else k3_rows
            rows += fn(cast, lwi.to(dtype), g_ff.to(dtype), dtype)
    kernel = {"k1": "grouped_ff", "k2": "grouped_ff_dx", "k3": "grouped_ff_dw",
              "k6": "consensus_dkv+consensus_dq", "k8": "fused_level_update"}[name]
    extra = {"stages": K8_STAGES, "library_note": K8_NOTE} if name == "k8" else {}
    emit({"phase": name, "kernel": kernel, **extra, "rows": rows})


def phase_kernels(device) -> dict:
    params, lwi, levels, big, mask, g_ff, g_lv, g_big = flagship_inputs(device)
    ff_rows, cons_rows, bwd_rows, fused_rows = [], [], [], []
    ff_kernel.grouped_ff.launches = 0
    consensus_kernel.consensus_attention.launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        cast = glom_model.tree_map(lambda p: p.to(dtype), params)
        x = lwi.to(dtype)
        ff_rows += k1_rows(cast, x, dtype)
        lv = levels.to(dtype)
        cons_rows.append(consensus_case(lv, dtype, "attend_self=False"))
        cons_rows.append(consensus_case(lv, dtype, "attend_self=True", attend_self=True))
        cons_rows.append(consensus_case(lv, dtype, "local_consensus_radius=2", mask=mask))
        cons_rows.append(consensus_case(big.to(dtype), dtype, "n=2304 (384/8), b=1", library=True))
        cons_rows.append(consensus_case(lv[:1], dtype, "b=1"))
        g = g_ff.to(dtype)
        # K2, K3 and the pair on the main path's two calls, then K2 at b=1 and 49 rows
        bwd_rows += k3_rows(cast, x, g, dtype, cases=2)
        bwd_rows += [k2_case(p, xx, gg, dtype, label)[0]
                     for label, p, xx, gg in ff_bwd_inputs(cast, x, g)[2:]]
        bwd_rows += k6_rows(lv, g_lv.to(dtype), big.to(dtype), g_big.to(dtype), mask, dtype,
                            b1=False)
        # K8 reads levels and the tokens as views of one (b, n, L+1, d) state
        fused_rows += k8_rows(cast, x, mask, dtype)
    # launches of this phase: one checked call and 3 + REPS * INNER timed ones a row
    emit({"phase": "kernels", "kernel": "grouped_ff",
          "launches": ff_kernel.grouped_ff.launches, "rows": ff_rows})
    emit({"phase": "kernels", "kernel": "consensus_attention",
          "launches": consensus_kernel.consensus_attention.launches, "rows": cons_rows})
    for name in BACKWARD + PAIRS:
        emit({"phase": "kernels", "kernel": name, "rows": [
            {k: v for k, v in r.items() if k != "kernel"} for r in bwd_rows if r["kernel"] == name]})
    emit({"phase": "kernels", "kernel": "fused_level_update", "stages": K8_STAGES,
          "rows": fused_rows, "library_note": K8_NOTE})
    # the main path's case, float32; SDPA computes only the attend_self=True
    # variant exactly, so consensus's library times come from that row (same
    # shapes and work)
    main = {"grouped_ff": ff_rows[0], "consensus_attention": cons_rows[0],
            "fused_level_update": fused_rows[0], "consensus_blocked": cons_rows[3]}
    library = {"grouped_ff": None, "consensus_attention": cons_rows[1]["library_ms"],
               "fused_level_update": None}
    for name in BACKWARD + PAIRS:
        rows = [r for r in bwd_rows if r["kernel"] == name]
        main[name] = rows[0]
        library[name] = next((r.get("library_ms") for r in rows
                              if r.get("library_ms") is not None), None)
    return main, library


BACKWARD = ("grouped_ff_dx", "grouped_ff_dw", "consensus_dkv", "consensus_dq")
# the backward pairs as the step runs them: K2 handing K3 the hidden, K6
# handing K7 its dS'
PAIRS = ("grouped_ff_dx+grouped_ff_dw", "consensus_dkv+consensus_dq")


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
    engine = ServingEngine(ckpt, device=device, ff_impl="pallas", attention_impl="pallas")
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    shape = (c.channels, c.image_size, c.image_size)
    imgs = {k: rng.standard_normal((k,) + shape).astype(np.float32) for k in (1, 2, 3, 8)}
    plan = (("embed", 1), ("embed", 3), ("embed", 8), ("reconstruct", 2))
    ff_kernel.grouped_ff.launches = 0
    consensus_kernel.consensus_attention.launches = 0
    health, requests, outs = serve_requests(engine, plan, imgs)
    launches = {"grouped_ff": ff_kernel.grouped_ff.launches,
                "consensus_attention": consensus_kernel.consensus_attention.launches}
    assert health["ff_impl"] == "pallas" and health["attention_impl"] == "pallas", health

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
    embed_err = float(np.abs(outs[("embed", 3)] - plain).max())
    if not embed_err <= SERVE_ATOL:
        raise AssertionError(f"/embed differs from the plain path by {embed_err} > {SERVE_ATOL}")

    x8 = torch.from_numpy(imgs[8]).to(device)
    embed_b8_ms = {"kernels": embed_forward_ms(engine, x8, engine.config),
                   "plain": embed_forward_ms(engine, x8, plain_cfg)}
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


def phase_profile(forward, runs: int = 3, *, phase: str = "profile", grad: bool = False) -> None:
    """A torch.profiler trace of ``runs`` calls of ``forward`` (b=8 /embed
    forwards, or with ``grad`` train steps) through the kernels: the
    device's busy share of the window (the sum of kernel times on the one
    stream over the host-clock window, which the profiler itself lengthens)
    and device time by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(not grad):
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
    emit({"phase": phase, "runs": runs, "window_ms": window_ms, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / window_ms,
          "by_name": [{"name": e.key[:80], "count": e.count, "device_ms": device_us(e) / 1e3}
                      for e in rows[:16]]})


def serve_requests(engine, plan, imgs):
    """Run ``engine`` behind the HTTP server on a free port, read /healthz,
    and post ``imgs[k]`` to each ``(endpoint, k)`` of ``plan``.  Every answer
    must have the endpoint's shape and be finite.  Returns ``(health, one
    record a request, {(endpoint, k): answer})`` and leaves nothing running."""
    c = engine.config
    engine.start()
    server = make_server(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05})
    thread.start()
    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        requests, outs = [], {}
        for endpoint, k in plan:
            t = time.perf_counter()
            reply = post(f"{base}/{endpoint}", {"images": imgs[k].tolist()})
            wall_ms = (time.perf_counter() - t) * 1e3
            out = np.asarray(reply["embeddings" if endpoint == "embed" else "images"], np.float32)
            want = ((k, c.levels, c.dim) if endpoint == "embed"
                    else (k, c.channels, c.image_size, c.image_size))
            assert out.shape == want, (endpoint, out.shape, want)
            assert np.isfinite(out).all(), f"{endpoint} k={k}: non-finite output"
            outs[(endpoint, k)] = out
            requests.append({"endpoint": endpoint, "k": k, "shape": list(out.shape),
                             "step": reply["step"], "server_latency_ms": reply["latency_ms"],
                             "client_wall_ms": wall_ms})
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        engine.shutdown(drain=True)
    return health, requests, outs


def embed_forward_ms(engine, x8, cfg) -> float:
    """One b=8 /embed forward of ``engine``'s weights under ``cfg`` (12
    iterations), host clock to the result on the host: the median of 5 after
    a warm-up."""
    times = []
    with torch.inference_mode():
        for _ in range(6):
            t0 = time.perf_counter()
            glom_model.apply(engine.params["glom"], x8, config=cfg,
                             iters=engine.embed_iters).mean(dim=1).cpu()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def phase_serve_fused(device) -> dict:
    """The flagship demo checkpoint served with ff_impl="fused": every
    iteration one launch of K8, none of K1 or K4 (the main path of this
    phase: counts set to 0 just before the requests, read just after)."""
    c = FLAGSHIP
    ckpt = os.path.join(ROOT, "build", "chip_smoke_ckpt")   # phase_serve wrote it
    if ckpt_lib.latest_step(ckpt) is None:   # run alone (--only serve_fused)
        make_demo_checkpoint(ckpt, config=c, seed=0)
    engine = ServingEngine(ckpt, device=device, ff_impl="fused", attention_impl="pallas")
    rng = np.random.default_rng(2)
    shape = (c.channels, c.image_size, c.image_size)
    imgs = {k: rng.standard_normal((k,) + shape).astype(np.float32) for k in (1, 2, 8)}
    plan = (("embed", 1), ("embed", 8), ("reconstruct", 2))
    for fn in counters().values():
        fn.launches = 0
    health, requests, outs = serve_requests(engine, plan, imgs)
    launches = {k: fn.launches for k, fn in counters().items()}
    iters, t = engine.embed_iters, engine.reconstruct_timestep
    want = {k: 0 for k in launches}
    want["fused_level_update"] = 2 * iters + t
    if launches != want:
        raise AssertionError(f"fused serving launches {launches}, expected {want}")
    assert health["ff_impl"] == "fused", health

    # the k=8 /embed answer against the plain path and the "pallas" engine's
    plain_cfg = GlomConfig(**{**engine.config.to_json_dict(),
                              "ff_impl": "dense", "attention_impl": "dense"})
    pallas_engine = ServingEngine(ckpt, device=device, ff_impl="pallas", attention_impl="pallas")
    x8 = torch.from_numpy(imgs[8]).to(device)
    with torch.inference_mode():
        plain = glom_model.apply(engine.params["glom"], x8, config=plain_cfg,
                                 iters=iters).mean(dim=1).cpu().numpy()
    err_plain = float(np.abs(outs[("embed", 8)] - plain).max())
    err_pallas = float(np.abs(outs[("embed", 8)] - pallas_engine.run("embed", imgs[8])).max())
    recon_err = float(np.abs(outs[("reconstruct", 2)]
                             - pallas_engine.run("reconstruct", imgs[2])).max())
    if not max(err_plain, err_pallas, recon_err) <= SERVE_ATOL:
        raise AssertionError(f"fused serving differs: plain {err_plain}, pallas engine "
                             f"{err_pallas}, reconstruct {recon_err} > {SERVE_ATOL}")

    emit({"phase": "serve_fused", "config": {"dim": c.dim, "levels": c.levels,
                                             "image_size": c.image_size,
                                             "patch_size": c.patch_size, "iters": iters,
                                             "reconstruct_timestep": t, "ff_impl": "fused"},
          "requests": requests, "launches": launches,
          "launches_per_forward": {"embed": {"fused_level_update": iters, "grouped_ff": 0,
                                             "consensus_attention": 0},
                                   "reconstruct": {"fused_level_update": t}},
          "embed_vs_plain_max_abs_err": err_plain, "embed_vs_pallas_engine_max_abs_err": err_pallas,
          "reconstruct_vs_pallas_engine_max_abs_err": recon_err, "atol": SERVE_ATOL,
          "embed_b8_forward_ms": {"fused": embed_forward_ms(engine, x8, engine.config),
                                  "pallas_kernels": embed_forward_ms(engine, x8, pallas_engine.config),
                                  "plain": embed_forward_ms(engine, x8, plain_cfg)}})
    phase_profile(lambda: glom_model.apply(engine.params["glom"], x8, config=engine.config,
                                           iters=iters).mean(dim=1).cpu(),
                  phase="serve_fused_profile")
    return launches


def counters() -> dict:
    """The seven kernel wrappers, whose ``launches`` count their kernels."""
    return {"fused_level_update": fused_kernel.fused_level_update,
            "grouped_ff": ff_kernel.grouped_ff, "grouped_ff_dx": ff_kernel.grouped_ff_dx,
            "grouped_ff_dw": ff_kernel.grouped_ff_dw,
            "consensus_attention": consensus_kernel.consensus_attention,
            "consensus_dkv": consensus_kernel.consensus_dkv,
            "consensus_dq": consensus_kernel.consensus_dq}


def fit_run(config, device, img, ckpt=None, steps=TRAIN_STEPS):
    """``Trainer.fit`` for ``steps`` steps on one resident batch, logging
    every step; returns ``(trainer, records)``."""
    import io

    stream = io.StringIO()
    tc = TrainConfig(batch_size=BATCH, steps=steps, log_every=1, seed=0,
                     checkpoint_dir=ckpt, checkpoint_every=steps if ckpt else 0)
    trainer = Trainer(config, tc, device=device, logger=MetricLogger(stream=stream))
    trainer.fit(itertools.repeat(img))
    return trainer, [json.loads(line) for line in stream.getvalue().splitlines()]


def phase_train(device) -> dict:
    """The denoising train step at flagship width, b=8: the kernels' path
    (the main path: counts set to 0 just before Trainer.fit, read just
    after) against the plain path on the card."""
    c = GlomConfig(**{**FLAGSHIP.to_json_dict(), "ff_impl": "pallas", "ff_fused_bwd": True,
                      "attention_impl": "pallas"})
    plain_cfg = GlomConfig(**{**c.to_json_dict(), "ff_impl": "dense", "attention_impl": "dense"})
    gen = torch.Generator().manual_seed(1)
    shape = (BATCH, c.channels, c.image_size, c.image_size)
    img = torch.randn(shape, generator=gen).to(device)
    ckpt = os.path.join(ROOT, "build", "chip_smoke_train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)

    for fn in counters().values():
        fn.launches = 0
    kern, kern_log = fit_run(c, device, img, ckpt)
    launches = {k: fn.launches for k, fn in counters().items()}
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    t = denoise.resolve_loss_timestep(kern.train_cfg, c.default_iters)
    want = {"fused_level_update": 0, "grouped_ff": 2 * t, "grouped_ff_dx": 2 * t,
            "grouped_ff_dw": 2 * t, "consensus_attention": t, "consensus_dkv": t,
            "consensus_dq": t}
    if per_step != want:
        raise AssertionError(f"train-step launches per step {per_step}, expected {want}")
    _, plain_log = fit_run(plain_cfg, device, img)
    # the yardstick, timed and not asserted: K1 forward with the plain
    # (cuBLAS, full float32) VJP behind it instead of K2 + K3
    vjp_cfg = GlomConfig(**{**c.to_json_dict(), "ff_fused_bwd": False})
    _, vjp_log = fit_run(vjp_cfg, device, img)

    losses = [r["loss"] for r in kern_log if "loss" in r]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite and falling: {losses}")

    ms = {"kernels": log_step_ms(kern_log), "plain": log_step_ms(plain_log),
          "kernels_plain_ff_vjp": log_step_ms(vjp_log)}

    # one step's gradients, kernels against the plain path, same params and noise
    params = kern.state.params
    noise = torch.randn(shape, generator=gen).to(device)

    grad = grads_vs_plain(c, kern.train_cfg, params, img, noise)

    # two runs of one step from the same state and noise: the same bits
    step = denoise.make_step_fn(c, kern.train_cfg, kern.optimizer)
    (s1, m1), (s2, m2) = step(kern.state, img, noise=noise), step(kern.state, img, noise=noise)
    bitwise = all(torch.equal(a, b) for a, b in zip(glom_model.tree_leaves(s1.params),
                                                    glom_model.tree_leaves(s2.params)))
    bitwise = bitwise and torch.equal(m1["loss"], m2["loss"])
    if not bitwise:
        raise AssertionError("two runs of one train step differ")
    del s1, s2, m1, m2
    memory = {"kernels": step_memory(step, kern.state, img, noise),
              "plain": step_memory(denoise.make_step_fn(plain_cfg, kern.train_cfg, kern.optimizer),
                                   kern.state, img, noise)}

    emit({"phase": "train", "config": {**{k: c.to_json_dict()[k] for k in (
              "dim", "levels", "image_size", "patch_size", "ff_impl", "ff_fused_bwd",
              "attention_impl")}, "batch": BATCH, "iters": c.default_iters, "loss_timestep": t,
              "optimizer": "adam", "lr": kern.train_cfg.learning_rate},
          "steps": TRAIN_STEPS, "losses": losses,
          "plain_losses": [r["loss"] for r in plain_log if "loss" in r],
          "step_ms": ms, "images_per_s": {k: 1e3 * BATCH / v for k, v in ms.items()},
          "step_ms_note": "median over steps 2..10 of one-step host-clock windows; "
                          "kernels_plain_ff_vjp: ff_fused_bwd=False (K1 forward, the plain "
                          "float32 VJP of the grouped FF), timed only",
          "launches": launches, "launches_per_step": per_step,
          "grad_vs_plain": grad,
          "bitwise_repeat": bitwise, "step_memory": memory,
          "step_memory_note": "torch.cuda.max_memory_allocated over one step (forward, backward, "
                              "Adam) from the trained state; resident: allocated before it"})
    phase_profile(lambda: step(kern.state, img, noise=noise)[1]["loss"].item(), runs=2,
                  phase="train_profile", grad=True)
    serve_trained(ckpt, device, kern)
    return launches, ms


def step_memory(step, state, img, noise) -> dict:
    """One call of ``step`` from ``state``: the peak of device memory
    allocated during it (torch.cuda.max_memory_allocated), what was
    allocated before it, and the difference, in bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    out = step(state, img, noise=noise)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    return {"peak_bytes": peak, "resident_bytes": resident, "step_bytes": peak - resident}


def grads_vs_plain(config, train_cfg, params, img, noise):
    """One step's loss and gradients through ``config``'s path against the
    plain path's, same params and noise: the worst leaf's relative error."""
    plain_cfg = GlomConfig(**{**config.to_json_dict(), "ff_impl": "dense",
                              "attention_impl": "dense", "remat": False, "fuse_ff": False})

    def grads(cfg):
        loss, tree = denoise.loss_and_grads(denoise.make_loss_fn(cfg, train_cfg), params, img,
                                            noise=noise)
        return loss.item(), ckpt_lib.flatten({"": glom_model.tree_map(lambda t: t.cpu(), tree)})

    loss_k, gk = grads(config)
    loss_p, gp = grads(plain_cfg)
    rel = {n[1:]: float(np.linalg.norm(gk[n] - gp[n]) / max(np.linalg.norm(gp[n]), 1e-30))
           for n in gp}
    worst = max(rel, key=rel.get)
    if not rel[worst] <= GRAD_RTOL:
        raise AssertionError(f"gradient {worst} differs from the plain path by {rel[worst]}")
    return {"loss_kernels": loss_k, "loss_plain": loss_p, "worst_leaf": worst,
            "worst_rel_err": rel[worst], "rtol": GRAD_RTOL}


def log_step_ms(log):
    """Host clock a step from the one-step logging windows; the first warms up."""
    return statistics.median(1e3 * BATCH / r["imgs_per_sec"] for r in log[1:] if "imgs_per_sec" in r)


def phase_train_fused(device, pallas_step_ms) -> dict:
    """The train step with ff_impl="fused" at flagship width, b=8: K8 in the
    forward; in the backward K1 and K4 again, then K2, K3, K6, K7 (the main
    path of this phase: counts set to 0 just before Trainer.fit, read just
    after).  Then remat=True and fuse_ff=True, two steps each."""
    base = {**FLAGSHIP.to_json_dict(), "ff_fused_bwd": True}
    c = GlomConfig(**{**base, "ff_impl": "fused"})
    gen = torch.Generator().manual_seed(1)
    shape = (BATCH, c.channels, c.image_size, c.image_size)
    img = torch.randn(shape, generator=gen).to(device)
    noise = torch.randn(shape, generator=gen).to(device)

    def counted_fit(cfg, steps):
        for fn in counters().values():
            fn.launches = 0
        trainer, log = fit_run(cfg, device, img, steps=steps)
        launches = {k: fn.launches for k, fn in counters().items()}
        return trainer, log, launches, {k: v / steps for k, v in launches.items()}

    kern, log, launches, per_step = counted_fit(c, FUSED_TRAIN_STEPS)
    t = denoise.resolve_loss_timestep(kern.train_cfg, c.default_iters)
    want = {"fused_level_update": t, "grouped_ff": 2 * t, "grouped_ff_dx": 2 * t,
            "grouped_ff_dw": 2 * t, "consensus_attention": t, "consensus_dkv": t,
            "consensus_dq": t}
    if per_step != want:
        raise AssertionError(f"fused train-step launches per step {per_step}, expected {want}")
    losses = [r["loss"] for r in log if "loss" in r]
    if len(losses) != FUSED_TRAIN_STEPS or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"fused train losses not finite and falling: {losses}")
    grad = grads_vs_plain(c, kern.train_cfg, kern.state.params, img, noise)
    step = denoise.make_step_fn(c, kern.train_cfg, kern.optimizer)
    (s1, m1), (s2, m2) = step(kern.state, img, noise=noise), step(kern.state, img, noise=noise)
    bitwise = all(torch.equal(a, b) for a, b in zip(glom_model.tree_leaves(s1.params),
                                                    glom_model.tree_leaves(s2.params)))
    if not (bitwise and torch.equal(m1["loss"], m2["loss"])):
        raise AssertionError("two runs of one fused train step differ")
    del s1, s2, m1, m2
    memory = step_memory(step, kern.state, img, noise)

    # the step's other knobs through the kernels: remat on top of the fused
    # step (each K8 runs again in the backward), and fuse_ff, which defeats
    # the fused step and runs both nets as one K1 / K2 / K3 call of 11 groups
    knobs = {}
    for name, cfg, want_k in (
        ("remat", GlomConfig(**{**base, "ff_impl": "fused", "remat": True}),
         {**want, "fused_level_update": 2 * t}),
        ("fuse_ff", GlomConfig(**{**base, "ff_impl": "pallas", "attention_impl": "pallas",
                                  "fuse_ff": True}),
         {"fused_level_update": 0, "grouped_ff": t, "grouped_ff_dx": t, "grouped_ff_dw": t,
          "consensus_attention": t, "consensus_dkv": t, "consensus_dq": t}),
    ):
        tr, klog, _, kper = counted_fit(cfg, KNOB_TRAIN_STEPS)
        if kper != want_k:
            raise AssertionError(f"{name} launches per step {kper}, expected {want_k}")
        klosses = [r["loss"] for r in klog if "loss" in r]
        if not all(np.isfinite(klosses)):
            raise AssertionError(f"{name} losses not finite: {klosses}")
        knobs[name] = {"launches_per_step": kper, "losses": klosses,
                       "step_ms": log_step_ms(klog),
                       "grad_vs_plain": grads_vs_plain(cfg, tr.train_cfg, kern.state.params, img,
                                                       noise)}

    ms = log_step_ms(log)
    emit({"phase": "train_fused", "config": {**{k: c.to_json_dict()[k] for k in (
              "dim", "levels", "image_size", "patch_size", "ff_impl", "ff_fused_bwd",
              "attention_impl")}, "batch": BATCH, "iters": c.default_iters, "loss_timestep": t},
          "steps": FUSED_TRAIN_STEPS, "losses": losses,
          "step_ms": {"fused": ms, **({} if pallas_step_ms is None else {
              "pallas_kernels": pallas_step_ms["kernels"], "plain": pallas_step_ms["plain"]})},
          "images_per_s": 1e3 * BATCH / ms,
          "step_ms_note": "median over the steps after the first of one-step host-clock windows",
          "launches": launches, "launches_per_step": per_step, "grad_vs_plain": grad,
          "bitwise_repeat": True, "step_memory": memory, "knobs": knobs})
    phase_profile(lambda: step(kern.state, img, noise=noise)[1]["loss"].item(), runs=2,
                  phase="train_fused_profile", grad=True)
    return launches


def serve_trained(ckpt, device, trainer) -> None:
    """The checkpoint the trainer saved, served over HTTP on /embed."""
    engine = ServingEngine(ckpt, device=device, ff_impl="pallas", attention_impl="pallas")
    c = engine.config
    imgs = np.random.default_rng(1).standard_normal(
        (2, c.channels, c.image_size, c.image_size)).astype(np.float32)
    _, (reply,), outs = serve_requests(engine, (("embed", 2),), {2: imgs})
    out = outs[("embed", 2)]
    with torch.inference_mode():
        want = glom_model.apply(trainer.state.params["glom"], torch.from_numpy(imgs).to(device),
                                config=engine.config).mean(dim=1).cpu().numpy()
    err = float(np.abs(out - want).max())
    if reply["step"] != trainer.state.step or out.shape != want.shape or not err <= SERVE_ATOL:
        raise AssertionError(f"served trained checkpoint: step {reply['step']}, shape "
                             f"{out.shape}, error {err}")
    emit({"phase": "serve_trained", "checkpoint_step": reply["step"], "shape": list(out.shape),
          "max_abs_err_vs_trained_params": err, "atol": SERVE_ATOL,
          "server_latency_ms": reply["server_latency_ms"]})


PHASES = ("kernels", "k1", "k2", "k3", "k6", "k8", "serve", "train", "serve_fused", "train_fused")


def parse_args(argv):
    import argparse

    p = argparse.ArgumentParser(description="Drive glom_tpu_torch on one NVIDIA GPU.")
    p.add_argument("--only", default=None,
                   help="comma-separated phases to run after device and build, for "
                        f"iterating on one part: {', '.join(PHASES)} (k1: K1's rows alone; "
                        "k2: K2's; k3: K3's, each with the K2 it needs and the pair; k6: K6's, "
                        "each with the K7 on its dS' and the pair; k8: K8's). "
                        "A partial run exits 3 and prints no ok line")
    args = p.parse_args(argv)
    if args.only is not None:
        args.only = [name for name in args.only.split(",") if name]
        unknown = sorted(set(args.only) - set(PHASES))
        if unknown or not args.only:
            p.error(f"--only takes phases among {PHASES}, got {args.only}")
    return args


def run_only(device, names) -> int:
    """Device, build and the named phases only; never the ok line."""
    pallas_step_ms = None
    for name in names:
        if name == "kernels":
            phase_kernels(device)
        elif name in ("k1", "k2", "k3", "k6", "k8"):
            phase_only(device, name)
        elif name == "serve":
            phase_serve(device)
        elif name == "train":
            _, pallas_step_ms = phase_train(device)
        elif name == "serve_fused":
            phase_serve_fused(device)
        elif name == "train_fused":
            phase_train_fused(device, pallas_step_ms)
    print(nvidia_smi(), flush=True)
    emit({"partial_run": names, "note": "--only: a partial run, not the smoke test; exit 3"})
    return 3


def main(argv=()) -> int:
    args = parse_args(list(argv))
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
    if args.only is not None:
        return run_only(device, args.only)
    main_rows, library = phase_kernels(device)
    launches = phase_serve(device)
    train_launches, pallas_step_ms = phase_train(device)
    fused_serve_launches = phase_serve_fused(device)
    fused_train_launches = phase_train_fused(device, pallas_step_ms)
    # launches: the serving path's count for the forward kernels (K8: the
    # fused serving path's), the train path's for the backward ones;
    # launches_train: the train path's for all (K8: the fused train path's);
    # launches_train_fused: the fused train path's for all
    launches.update({k: train_launches[k] for k in BACKWARD})
    launches["fused_level_update"] = fused_serve_launches["fused_level_update"]
    train_launches["fused_level_update"] = fused_train_launches["fused_level_update"]
    summary = []
    for name, source, replaces in (
        ("fused_level_update", "glom_tpu_torch/kernels/csrc/fused_update.cu",
         "glom_tpu/kernels/fused_update_pallas.py:231 (_kernel :64)"),
        ("grouped_ff", "glom_tpu_torch/kernels/csrc/grouped_ff.cu",
         "glom_tpu/kernels/ff_pallas.py:124"),
        ("consensus_attention", "glom_tpu_torch/kernels/csrc/consensus.cu",
         "glom_tpu/kernels/consensus_pallas.py:217 and :153"),
        ("grouped_ff_dx", "glom_tpu_torch/kernels/csrc/grouped_ff_bwd.cu",
         "glom_tpu/kernels/ff_pallas.py:274 (_bwd_dx_kernel :190)"),
        ("grouped_ff_dw", "glom_tpu_torch/kernels/csrc/grouped_ff_bwd.cu",
         "glom_tpu/kernels/ff_pallas.py:295 (_bwd_dw_kernel :212)"),
        ("consensus_dkv", "glom_tpu_torch/kernels/csrc/consensus_bwd.cu",
         "glom_tpu/kernels/consensus_pallas.py:414 (_bwd_dkv_kernel :285)"),
        ("consensus_dq", "glom_tpu_torch/kernels/csrc/consensus_bwd.cu",
         "glom_tpu/kernels/consensus_pallas.py:434 (_bwd_dq_kernel :334)"),
    ):
        row = main_rows[name]
        summary.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "launches_train": train_launches[name],
                        "launches_train_fused": fused_train_launches[name],
                        "unfused_kernels_ms": row.get("unfused_kernels_ms"),
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "bound_3xtf32_ms": row["bound_3xtf32_ms"],
                        "library_ms": library[name], "case": row["case"],
                        "dtype": row["dtype"],
                        "library_case": None if library[name] is None else (
                            "attend_self=True" if name == "consensus_attention" else
                            "attend_self=True; SDPA's backward (dQ, dK, dV) against K6 + K7")})
        if name == "grouped_ff":
            summary[-1].update({k: row[k] for k in ("splits", "yardstick_ms", "yardstick",
                                                    "vs_f64")})
        if name == "fused_level_update":
            summary[-1].update({"stages": K8_STAGES, "note": K8_NOTE,
                                **{k: row[k] for k in ("splits", "key_splits", "k1_g11_k4_ms",
                                                       "vs_f64")}})
        if name in ("consensus_dkv", "consensus_dq"):
            summary[-1].update({k: row[k] for k in ("vs_f64", "work_units") if k in row})
        if name == "consensus_dq":
            pair = main_rows["consensus_dkv+consensus_dq"]
            summary[-1]["k6_plus_k7"] = {k: pair[k] for k in (
                "case", "dtype", "work", "kernel_ms", "k6_ms", "k7_ms", "bound_ms", "bound_by",
                "bound_3xtf32_ms")}
        if name == "grouped_ff_dw":
            pair = main_rows["grouped_ff_dx+grouped_ff_dw"]
            summary[-1]["library_case"] = main_rows[name].get("library")
            summary[-1]["k2_plus_k3"] = {k: pair[k] for k in (
                "case", "dtype", "work", "kernel_ms", "k2_ms", "k3_ms", "bound_ms", "bound_by",
                "bound_3xtf32_ms")}
        if name == "consensus_attention":
            # the same kernel in glom_tpu's blocked regime (K5, n > 1024)
            k5 = main_rows["consensus_blocked"]
            summary[-1]["k5"] = {
                "replaces": "glom_tpu/kernels/consensus_pallas.py:198 (_forward_blocked :153)",
                "case": k5["case"], "dtype": k5["dtype"], "max_abs_err": k5["max_abs_err"],
                "ms": k5["kernel_ms"], "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
                "bound_by": k5["bound_by"], "bound_3xtf32_ms": k5["bound_3xtf32_ms"],
                "library_ms": k5["library_ms"], "library_case": "attend_self=True, same inputs"}
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
