"""Iso-quality check of stateful session serving's warm start: the port's
counterpart of ``tools/session_check.py``.

    python -m glom_tpu_torch.tools.session_check                 # demo model
    python -m glom_tpu_torch.tools.session_check --checkpoint-dir CKPT \\
        --warm-iters 2,3,4,6 --frames 16 --batch 2
    python -m glom_tpu_torch.tools.session_check --smoke         # exit-code gate

A warm session frame (``/session/embed``) settles from the previous frame's
state in ``warm_iters`` iterations instead of the cold count.  That saves
time only if the warm equilibrium stays close to the full-iteration one.  On
an AR(1) frame stream (consecutive frames barely move, as a video's do):

  * the **reference trajectory** carries the state with the full cold count
    every frame;
  * a **warm trajectory** per swept ``warm_iters`` carries it with fewer;
  * the **equilibrium distance** of a frame is ``|levels_warm -
    levels_full|_F / |levels_full|_F``; a sweep value passes when its
    maximum over the frames after ``--burn-in`` stays within
    ``--threshold`` (the cold start's transient decays; its maximum is
    reported as ``rel_distance_transient_max``);
  * the **latency** of a frame is the host's wall clock around one call of
    the family's graph cache (the answer on the host), p50/p95 over the
    frames after the first, warm against full.

Both trajectories run through the serving engine's session graph families
(``serving/engine.py::make_session_fns`` in a
:class:`~glom_tpu_torch.serving.compile_cache.BucketedGraphCache` that
carries and takes the state), so on a card every frame replays a CUDA graph
of the kernels the checkpoint's config names, as a served frame does; on
the CPU the same caches run eagerly.  The frames and the report's keys are
``glom_tpu``'s.  ``--smoke`` runs the demo model and exits nonzero unless a
sweep value at or below half the cold count passes at a warm/full latency
ratio below 1; ``--require-half`` exits nonzero unless one passes.  Without
``--device`` it runs on ``cuda``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time


def percentile(xs, q):
    """Nearest-rank percentile (the obs registry's rule)."""
    if not xs:
        return None
    ordered = sorted(xs)
    rank = min(len(ordered) - 1, max(0, math.ceil(q / 100.0 * len(ordered)) - 1))
    return ordered[rank]


def make_frames(rng, t, b, channels, size, drift):
    """AR(1) frames with unit stationary variance, ``glom_tpu``'s stream:
    ``x_{t+1} = rho x_t + sqrt(1 - rho^2) n`` with ``rho = 1 - drift`` (0:
    a static scene; 1: independent frames)."""
    import numpy as np

    rho = 1.0 - drift
    mix = math.sqrt(max(0.0, 1.0 - rho * rho))
    frames = np.empty((t, b, channels, size, size), dtype=np.float32)
    frames[0] = rng.randn(b, channels, size, size)
    for i in range(1, t):
        frames[i] = rho * frames[i - 1] + mix * rng.randn(b, channels, size, size)
    return frames


def _session_cache(fn, frames, device, name, *, state=None):
    """One bucket (the frame batch) of a session family, captured."""
    from glom_tpu_torch.serving.compile_cache import BucketedGraphCache

    kw = {}
    if state is not None:
        kw = dict(takes_state=True, state_shape=tuple(state.shape[1:]), state_dtype=state.dtype)
    return BucketedGraphCache(fn, (frames.shape[1],), input_shape=frames.shape[2:],
                              device=device, name=name, carries_state=True, **kw)


def run_sweep(params, config, *, cold_iters, warm_candidates, frames, threshold, burn_in=3,
              device="cpu"):
    """One reference trajectory and one warm trajectory per candidate; the
    report rows (``glom_tpu``'s keys).  ``params`` is the checkpoint's tree
    on ``device`` in the compute dtype."""
    import numpy as np

    from glom_tpu_torch.models import glom as glom_model
    from glom_tpu_torch.serving.engine import make_session_fns

    t = frames.shape[0]
    step_fns = glom_model.resolve_step_fns(config, device)
    cold_fn, full_fn = make_session_fns(config, cold_iters, cold_iters, step_fns)
    cold = _session_cache(cold_fn, frames, device, "session_cold")
    cold.warmup(params)
    _, state0 = cold(params, frames[0])
    full = _session_cache(full_fn, frames, device, "session_full", state=state0)
    full.warmup(params)

    ref_states, full_ms, state = [state0], [], state0
    for i in range(1, t):
        t0 = time.perf_counter()
        _, state = full(params, frames[i], state=state)
        full_ms.append((time.perf_counter() - t0) * 1e3)
        ref_states.append(state)
    ref_host = [s.float().cpu().numpy() for s in ref_states]
    ref_norms = [float(np.linalg.norm(r)) or 1.0 for r in ref_host]

    rows = []
    for w in warm_candidates:
        _, warm_fn = make_session_fns(config, cold_iters, int(w), step_fns)
        warm = _session_cache(warm_fn, frames, device, f"session_warm{w}", state=state0)
        warm.warmup(params)
        state, warm_ms, dists = state0, [], []   # frame 0 is cold on both paths
        for i in range(1, t):
            t0 = time.perf_counter()
            _, state = warm(params, frames[i], state=state)
            warm_ms.append((time.perf_counter() - t0) * 1e3)
            d = float(np.linalg.norm(state.float().cpu().numpy() - ref_host[i]))
            dists.append(d / ref_norms[i])
        # each trajectory's first timed frame pays one-off costs: out of
        # the percentile pool
        pool_w = warm_ms[1:] or warm_ms
        pool_f = full_ms[1:] or full_ms
        p95_w, p95_f = percentile(pool_w, 95), percentile(pool_f, 95)
        steady = dists[burn_in:] or dists        # dists[i] is frame i + 1
        rows.append({
            "warm_iters": int(w),
            "iters_frac": round(int(w) / cold_iters, 4),
            "rel_distance_mean": round(sum(steady) / len(steady), 6),
            "rel_distance_max": round(max(steady), 6),
            "rel_distance_transient_max": round(max(dists), 6),
            "pass": max(steady) <= threshold,
            "warm_p50_ms": round(percentile(pool_w, 50), 3),
            "warm_p95_ms": round(p95_w, 3),
            "full_p50_ms": round(percentile(pool_f, 50), 3),
            "full_p95_ms": round(p95_f, 3),
            "latency_ratio": round(p95_w / p95_f, 4) if p95_f else None,
        })
    return rows


def build_model(checkpoint_dir, iters, device):
    """``(params, config, cold_iters)`` of a checkpoint; the parameters in
    the compute dtype on ``device``, as the serving engine places them."""
    from glom_tpu_torch.models import glom as glom_model
    from glom_tpu_torch.training import denoise

    _, config, _, params = denoise.load_checkpoint_state(checkpoint_dir, device=device)
    dt = config.resolved_compute_dtype
    params = glom_model.tree_map(lambda p: p.to(dt), params)
    cold_iters = int(iters if iters is not None else config.default_iters)
    return params, config, cold_iters


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint-dir", default=None,
                   help="trainer checkpoint to measure (default: the demo model, a "
                        "calibration of the tool, not of a deployment)")
    p.add_argument("--iters", type=int, default=None,
                   help="cold iteration count (default: the model's default_iters)")
    p.add_argument("--warm-iters", default=None, metavar="K1,K2,...",
                   help="sweep values (default: 1..cold_iters-1)")
    p.add_argument("--frames", type=int, default=16, help="stream length (frame 0 is cold)")
    p.add_argument("--batch", type=int, default=2, help="images per frame")
    p.add_argument("--drift", type=float, default=0.1,
                   help="AR(1) per-frame content drift (0 = a static scene, 1 = i.i.d.)")
    p.add_argument("--threshold", type=float, default=0.05,
                   help="iso-quality bound on the relative equilibrium distance per "
                        "steady-state frame")
    p.add_argument("--burn-in", type=int, default=3,
                   help="frames left out of the pass criterion (the cold start's transient)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--report", default=None, metavar="FILE",
                   help="also write the JSON report here")
    p.add_argument("--require-half", action="store_true",
                   help="exit nonzero unless some warm_iters <= cold_iters/2 passes "
                        "(implied by --smoke)")
    p.add_argument("--smoke", action="store_true", help="the demo model, a quick exit-code gate")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch versions of the kernels")
    p.add_argument("--platform", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.platform is not None:
        p.error("--platform is glom_tpu's; the port picks its device with --device")

    import tempfile

    import numpy as np

    from glom_tpu_torch.config import resolve_device

    device = resolve_device(args.device)
    if args.smoke:
        args.checkpoint_dir = None
        args.frames = min(args.frames, 8)
        args.require_half = True
    with tempfile.TemporaryDirectory(prefix="glom_session_check_") as demo_dir:
        checkpoint_dir = args.checkpoint_dir
        if checkpoint_dir is None:
            from glom_tpu_torch.serving.engine import make_demo_checkpoint

            make_demo_checkpoint(demo_dir)
            checkpoint_dir = demo_dir
        params, config, cold_iters = build_model(checkpoint_dir, args.iters, device)
    if args.warm_iters:
        candidates = sorted({int(k) for k in args.warm_iters.split(",")})
        bad = [k for k in candidates if not 1 <= k <= cold_iters]
        if bad:
            print(f"error: warm_iters {bad} outside [1, {cold_iters}]", file=sys.stderr)
            return 2
    else:
        candidates = list(range(1, cold_iters))
    frames = make_frames(np.random.RandomState(args.seed), args.frames, args.batch,
                         config.channels, config.image_size, args.drift)
    rows = run_sweep(params, config, cold_iters=cold_iters, warm_candidates=candidates,
                     frames=frames, threshold=args.threshold, burn_in=args.burn_in,
                     device=device)

    passing = [r for r in rows if r["pass"]]
    # fewest iterations wins, but a measured latency win breaks ties first
    best = (min(passing, key=lambda r: ((r["latency_ratio"] or 1.0) >= 1.0, r["warm_iters"]))
            if passing else None)
    half = cold_iters // 2
    report = {
        "cold_iters": cold_iters,
        "frames": int(args.frames),
        "batch": int(args.batch),
        "drift": args.drift,
        "threshold": args.threshold,
        "burn_in": args.burn_in,
        "device": str(device),
        "sweep": rows,
        "best_warm_iters": best["warm_iters"] if best else None,
        "half_target_iters": half,
        "half_target_met": bool(best and best["warm_iters"] <= half),
        "steady_state_p95_ms": best["warm_p95_ms"] if best else None,
        "full_iter_p95_ms": best["full_p95_ms"] if best else None,
        "latency_ratio": best["latency_ratio"] if best else None,
    }
    if args.smoke:
        ok = (report["half_target_met"] and report["latency_ratio"] is not None
              and report["latency_ratio"] < 1.0)
        report = {"smoke": "ok" if ok else "FAILED", **report}
    out = json.dumps(report, indent=2)
    print(out)
    if args.report:
        with open(args.report, "w") as f:
            f.write(out + "\n")
    if args.require_half and not report["half_target_met"]:
        print(f"session_check: FAIL — no warm_iters <= {half} reaches within "
              f"{args.threshold} of the full-iteration equilibrium", file=sys.stderr)
        return 1
    if args.smoke and report.get("smoke") != "ok":
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
