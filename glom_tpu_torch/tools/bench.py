"""The benchmark entry point (``bench.py``): sustained denoising-SSL train
throughput on one card, printed as ONE JSON line.

    python -m glom_tpu_torch.tools.bench                       # the record configuration
    python -m glom_tpu_torch.tools.bench --ff-impl pallas --attention-impl pallas --fused-ff-bwd
    python -m glom_tpu_torch.tools.bench --config tiny --device cpu   # plumbing check

It measures what ``bench.py`` measures, under its metric name
(``denoise_ssl_train_imgs_per_sec_per_chip``, ``_<config>`` off flagship),
with its flags where they apply and its defaults: the flagship model, 12
iterations, bf16 compute, remat with policy "dots", batch 32 (4 on the CPU),
20 timed steps after 3 of warm-up (2 after 1 on the CPU), ``--ff-impl
auto`` (the grouped-FF kernels on a card, the plain ops on the CPU), dense
consensus, the plain FF backward, one resident synthetic batch.  ``--data
images --data-dir DIR`` streams a fresh batch of a JPEG/PNG folder tree
through :class:`~glom_tpu_torch.training.image_stream.ImageFolderStream`
every step instead (decode threads, the native libjpeg batch decoder where
it builds, and the transfer to the card inside the window), under the
metric name with ``_realdata``.
``--scan-unroll`` is accepted and changes nothing (the port's loop is
eager).  ``--device`` takes the place of ``--platform``;
``--device-probe-timeout`` watches the first touch of the card
(:mod:`glom_tpu_torch.device_guard`).  Without a card and
without ``--device cpu`` it exits non-zero, printing no record: it never
falls back to the CPU.

The record carries the resolved configuration, ``mfu`` (the analytic model
FLOPs of ``tools/mfu.py`` over the card's data-sheet peak for the compute
type; null on the CPU or a card ``tools/mfu.PEAK_TFLOPS`` lacks),
``peak_memory_bytes`` (``torch.cuda.max_memory_allocated`` over the timed
window), the kernels' launches a step in the window, and
``builds_in_window``, the kernel sources compiled and libraries loaded
inside the window (``kernels/_build.py``; ``Trainer`` builds every kernel its
config can run and the warm-up loads them, so it reads 0; a rate whose
window paid for a build is kept, not zeroed, with the count beside it).  An
``mfu`` above 1 is a timing fault: the window is measured once more, and a
second one gives ``status: "error"``.  It has no ``vs_baseline`` and no
``last_measured``: both are TPU figures.

The window is timed on the host's monotonic clock between two
``torch.cuda.synchronize()`` calls and reads no value of a step inside it.
``--profile-dir`` traces three steps after the warm-up, outside the window,
with the trainer's phase names (``profiling.trace``, ``annotate``); a
failure to trace is printed and does not cost the record.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

METRIC = "denoise_ssl_train_imgs_per_sec_per_chip"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GLOM denoising-SSL train throughput on one card")
    p.add_argument("--config", default="flagship", choices=["flagship", "large", "tiny"],
                   help="flagship = 512/6/224/14, iters 12; large = 1024/8/384/16, iters 16 "
                        "(wider than the kernels take); tiny = 64/3/64/8 smoke config, never "
                        "a number of record")
    p.add_argument("--batch-size", type=int, default=0, help="0 = auto (32 on a card, 4 on "
                                                               "the CPU, for flagship)")
    p.add_argument("--steps", type=int, default=0, help="0 = auto (20 on a card, 2 on the CPU)")
    p.add_argument("--warmup", type=int, default=-1, help="-1 = auto (3 on a card, 1 on the CPU)")
    p.add_argument("--fp32", action="store_true", help="disable bf16 compute")
    p.add_argument("--no-remat", action="store_true", help="disable the step's remat")
    p.add_argument("--remat-policy", default="dots", choices=["full", "dots"])
    p.add_argument("--fuse-ff", action="store_true",
                   help="run bottom_up+top_down as one 2L-1-group call")
    p.add_argument("--scan-unroll", type=int, default=1,
                   help="accepted for bench.py's sake; no effect in the port")
    p.add_argument("--attention-impl", default="dense",
                   choices=["auto", "dense", "pallas", "ring", "ulysses"])
    p.add_argument("--ff-impl", default="auto", choices=["auto", "dense", "pallas", "fused"],
                   help="auto = pallas (the grouped-FF kernel) on a card, dense on the CPU")
    p.add_argument("--fused-ff-bwd", action="store_true",
                   help="with --ff-impl pallas or fused: the backward kernels K2 + K3 instead "
                        "of the plain VJP")
    p.add_argument("--data", default="synthetic", choices=["synthetic", "images"],
                   help="synthetic = one resident batch reused every step; images = a fresh "
                        "batch from --data-dir through ImageFolderStream every step")
    p.add_argument("--data-dir", default=None,
                   help="ImageFolder root for --data images")
    p.add_argument("--data-workers", type=int, default=8,
                   help="decode threads for --data images")
    p.add_argument("--decode", default="auto", choices=["auto", "python"],
                   help="--data images decode path: auto = the native libjpeg batch decoder "
                        "where it is available, python = the per-file cv2/PIL thread pool")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of 3 steps after the warm-up here "
                        "(outside the timed window)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (refused without a card) or cpu")
    p.add_argument("--device-probe-timeout", type=float, default=240,
                   help="seconds the first touch of the card may take before the tool "
                        "emits an error line and exits 2 (glom_tpu_torch.device_guard); "
                        "<= 0 disables the guard")
    args = p.parse_args(argv)
    if args.data == "images" and not args.data_dir:
        p.error("--data images needs --data-dir")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from glom_tpu_torch.config import GlomConfig, TrainConfig, bench_preset, resolve_device
    from glom_tpu_torch.device_guard import guarded_cuda_init
    from glom_tpu_torch.kernels import _build, wrappers
    from glom_tpu_torch.tools import mfu as mfu_tool
    from glom_tpu_torch.training.data import synthetic_batches
    from glom_tpu_torch.training.denoise import resolve_loss_timestep
    from glom_tpu_torch.training.trainer import Trainer

    metric = METRIC + ("" if args.config == "flagship" else f"_{args.config}")
    if args.data == "images":
        metric += "_realdata"
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"bench: {e}")
    guarded_cuda_init(device, args.device_probe_timeout,
                      lambda msg: print(f"bench: {msg}", file=sys.stderr, flush=True))
    on_card = device.type == "cuda"
    if args.ff_impl == "auto":
        args.ff_impl = "pallas" if on_card else "dense"
    steps = args.steps or (20 if on_card else 2)
    warmup = args.warmup if args.warmup >= 0 else (3 if on_card else 1)
    model_kwargs, iters, card_b, cpu_b = bench_preset(args.config)
    batch = args.batch_size or (card_b if on_card else cpu_b)
    dtype = torch.float32 if args.fp32 else torch.bfloat16

    config = GlomConfig(
        compute_dtype=dtype, remat=not args.no_remat, remat_policy=args.remat_policy,
        fuse_ff=args.fuse_ff, scan_unroll=args.scan_unroll, attention_impl=args.attention_impl,
        ff_impl=args.ff_impl, ff_fused_bwd=args.fused_ff_bwd, **model_kwargs)
    train = TrainConfig(batch_size=batch, iters=iters, log_every=0)
    trainer = Trainer(config, train, device=device)
    with contextlib.ExitStack() as stack:
        if args.data == "images":
            from glom_tpu_torch.training.image_stream import ImageFolderStream

            # the whole input path, a fresh batch every step: the stream's own
            # read-ahead overlaps decoding with the card's work
            stream = stack.enter_context(ImageFolderStream(
                args.data_dir, batch, config.image_size, channels=config.channels,
                workers=args.data_workers,
                native_decode=None if args.decode == "auto" else False))

            def next_img():
                return trainer.put(next(stream))
        else:
            resident = trainer.put(next(synthetic_batches(batch, config.image_size,
                                                          config.channels)))

            def next_img():
                return resident

        def sync():
            if on_card:
                torch.cuda.synchronize(device)

        for _ in range(warmup):
            trainer.step(next_img())
        sync()

        if args.profile_dir:
            # the trainer's trace plumbing and phase names, so a bench trace and
            # a trainer trace read alike
            from glom_tpu_torch.profiling import annotate, trace

            try:
                with trace(args.profile_dir):
                    for _ in range(3):
                        with annotate("data_wait"):
                            x = next_img()
                        with annotate("step"):
                            trainer.step(x)
                print(f"# trace written to {args.profile_dir}", flush=True)
            except Exception as e:  # tracing must never cost the number of record
                print(f"# trace failed ({type(e).__name__}: {e})", flush=True)

        counters = wrappers()
        executed = resolve_loss_timestep(train, iters)
        train_flops = mfu_tool.train_flops_per_image(config, executed)
        kind = torch.cuda.get_device_name(device) if on_card else "cpu"
        peak, peak_source = (mfu_tool.peak_tflops(kind, dtype) if on_card
                             else (None, "the CPU has no data-sheet peak here"))

        def measure():
            for fn in counters.values():
                fn.launches = 0
            builds = _build.events()
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
            # the card drained at both ends, no step's values read in between
            sync()
            t0 = time.monotonic()
            for _ in range(steps):
                trainer.step(next_img())
            sync()
            dt = time.monotonic() - t0
            after = _build.events()
            rate = batch * steps / dt
            return {"seconds": dt, "rate": rate,
                    "mfu": None if peak is None else rate * train_flops / (peak * 1e12),
                    "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if on_card else None,
                    "launches": {k: fn.launches / steps for k, fn in counters.items()},
                    "builds": sum(after[k] - builds[k] for k in after)}

        m = measure()
        remeasured = False
        if m["mfu"] is not None and m["mfu"] > 1.0:
            # above the card's peak: a timing fault, not a measurement
            m, remeasured = measure(), True
        result = {
            "metric": metric, "value": m["rate"], "unit": "imgs/sec/chip", "status": "ok",
            "backend": "gpu" if on_card else "cpu", "device_kind": kind,
            "config": args.config, "dtype": "float32" if args.fp32 else "bfloat16",
            "remat": config.remat, "remat_policy": config.remat_policy,
            "ff_impl": config.ff_impl, "attention_impl": config.attention_impl,
            "fused_ff_bwd": config.ff_fused_bwd, "fuse_ff": config.fuse_ff,
            "data": args.data, "batch": batch, "steps": steps, "warmup": warmup, "iters": iters,
            "executed_iters": executed, "seconds": m["seconds"],
            "model_flops_per_img": train_flops, "mfu": m["mfu"], "peak_tflops": peak,
            "peak_source": peak_source, "peak_memory_bytes": m["peak_memory_bytes"],
            "launches_per_step": {k: v for k, v in m["launches"].items() if v},
            # annotate, don't zero: a build or library load inside the window is
            # real wall-clock in the rate; the reader must know why it is low
            "builds_in_window": m["builds"],
        }
        if remeasured:
            result["remeasured"] = True
        if m["mfu"] is not None and m["mfu"] > 1.0:
            result.update(value=0.0, status="error",
                          error=f"implausible rate {m['rate']:.1f} imgs/s: mfu {m['mfu']:.3f} above "
                                f"the card's peak after a re-measure — timing fault")
        print(json.dumps(result), flush=True)
        return result


if __name__ == "__main__":
    main()
