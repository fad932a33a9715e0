"""Per-component time breakdown of the flagship train step (``tools/breakdown.py``).

Times each sub-block of the denoising-SSL step on its own (the median of
``--repeats`` calls after two warm-up calls; on a card between two CUDA
events around each call, on the CPU on the host clock) and reports its share
of the full step's time: the "name the top time sinks" companion to
``tools/mfu.py`` and the profiler trace (``tools/bench.py --profile-dir``).
The pieces run apart from the step, so their sum can differ from it; the
ranking, not the sum, is the signal.

Rows, with ``glom_tpu``'s names: ``train_step_total`` (forward, backward and
Adam; the bench quantity), ``forward_capture`` (the forward to the loss
timestep, what the loss reads, without autograd), ``consensus_x_executed``
and ``grouped_ff_x_executed`` (one call at the step's shapes, times the
executed iterations; the FF scaled from the bottom-up call's L groups to the
2L-1 of both nets), ``patch_embed`` and ``adam_update``; and
``residual_backward_ms``, the step less the forward.

    python -m glom_tpu_torch.tools.breakdown                  # flagship, b=32, on the card
    python -m glom_tpu_torch.tools.breakdown --ff-impl pallas
    python -m glom_tpu_torch.tools.breakdown --config tiny --device cpu --repeats 1
"""

from __future__ import annotations

import argparse
import json
import statistics
import time


def timed(fn, *args, device, repeats=5, warmup=2) -> float:
    """Median seconds a call of ``fn(*args)``, the result's work finished."""
    import torch

    cuda = device.type == "cuda"
    for _ in range(warmup):
        fn(*args)
    if cuda:
        torch.cuda.synchronize(device)
    ts = []
    for _ in range(repeats):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="flagship", choices=["flagship", "large", "tiny"])
    p.add_argument("--batch-size", type=int, default=0, help="0 = auto (32 on the card)")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--ff-impl", default="dense", choices=["dense", "pallas"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (refused without a card) or cpu")
    args = p.parse_args(argv)

    import torch

    from glom_tpu_torch.config import GlomConfig, TrainConfig, bench_preset, resolve_device
    from glom_tpu_torch.models import glom as glom_model
    from glom_tpu_torch.training import denoise
    from glom_tpu_torch.training.optim import Optimizer

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"breakdown: {e}")
    kw, iters, card_b, cpu_b = bench_preset(args.config)
    batch = args.batch_size or (card_b if device.type == "cuda" else cpu_b)
    config = GlomConfig(compute_dtype=torch.float32 if args.fp32 else torch.bfloat16,
                        remat=True, ff_impl=args.ff_impl, **kw)
    tcfg = TrainConfig(batch_size=batch, iters=iters, log_every=0)
    executed = denoise.resolve_loss_timestep(tcfg, iters)
    optimizer = Optimizer.from_config(tcfg)
    state = denoise.init_state(torch.Generator().manual_seed(0), config, optimizer,
                               device=device)
    gen = torch.Generator().manual_seed(1)
    img = torch.randn((batch, 3, config.image_size, config.image_size), generator=gen).to(device)
    n, L, d = config.num_patches, config.levels, config.dim
    cdt = config.resolved_compute_dtype
    levels_state = torch.randn((batch, n, L, d), generator=gen).to(device, cdt)
    gparams = glom_model.tree_map(lambda a: a.to(cdt), state.params["glom"])

    rows = []

    def record(name, seconds):
        rows.append({"component": name, "ms": 1e3 * seconds})

    def run(name, fn, *a, scale=1.0):
        record(name, scale * timed(fn, *a, device=device, repeats=args.repeats))

    # the full train step (forward, backward, Adam), the bench quantity; the
    # same state is reused for every call
    step = denoise.make_step_fn(config, tcfg, optimizer)
    run("train_step_total", lambda s, im: step(s, im), state, img)
    t_step = rows[-1]["ms"]

    # forward only, to the loss timestep (what the loss reads)
    with torch.no_grad():
        run("forward_capture", lambda prm, im: glom_model.apply(
            prm, im, config=config, iters=executed), gparams, img)
        t_fwd = rows[-1]["ms"]

        # consensus, one call x executed iterations at step shapes
        cons = glom_model.make_consensus_fn(config, device)
        run("consensus_x_executed", cons, levels_state, scale=executed)

        # grouped FF (bottom-up shaped, L groups) x 1, scaled to bottom-up
        # (L groups) + top-down (L-1 groups) a iteration
        ff = glom_model.make_ff_fn(config)
        run("grouped_ff_x_executed", ff, gparams["bottom_up"], levels_state,
            scale=executed * (2 * L - 1) / L)

        # patch embed (once a step)
        run("patch_embed", lambda prm, im: glom_model.embed_inputs(prm, im.to(cdt), config)[0],
            gparams, img)

        # the optimizer update alone (Adam over the parameter tree)
        grads = glom_model.tree_map(torch.ones_like, state.params)
        run("adam_update", lambda g: optimizer.update(g, state.opt_state, state.params), grads)

    for r in rows:
        r["pct_of_step"] = 100.0 * r["ms"] / t_step
    out = {
        "config": args.config, "batch": batch, "executed_iters": executed,
        "device": device.type,
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "dtype": "float32" if args.fp32 else "bfloat16", "ff_impl": args.ff_impl,
        "rows": rows,
        # residual = backward + loss/noise plumbing + Adam (backward dominates)
        "residual_backward_ms": t_step - t_fwd if t_fwd < t_step else None,
    }
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
