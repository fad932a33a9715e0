"""CLI training entry point: ``python -m glom_tpu_torch.training.train``.

The flags this trainer honours keep ``glom_tpu.training.train``'s names and
defaults.  The run is on ``cuda`` unless ``--device cpu`` is given; without a
card it refuses rather than move to the CPU.  Every other flag of the JAX
CLI is recognised and refused, with the reason from the trainer's one table
(``training/trainer.py::REASONS``).  Data is the synthetic stream, a folder
of ``.npy``/``.npz`` arrays or a JPEG/PNG folder tree (``--data images``,
resumable: its cursor rides in the checkpoint).  With ``--data images`` and
``--eval-every`` a held-out split is carved off before the stream exists
and scored by an ``EvalSuite`` (PSNR and the linear probes); otherwise
``--eval-every`` logs the incoming batch's PSNR.

The observability and robustness flags are ``glom_tpu``'s: exporters
(``--metrics-csv``, ``--prom-textfile``), the phase trace (``--trace-dir``),
diagnostics (``--diag-every``), the numerics monitor
(``--no-monitor-numerics``, ``--grad-spike-factor``), forensics bundles
(``--forensics-*``), async saves (``--async-checkpoint``) and the
supervisor (``--supervise``, ``--max-restart-failures``,
``--restart-window-s``), which runs a fresh ``Trainer`` and data stream for
each attempt: what recovers flows only through the checkpoint directory.

Several processes train on one mesh of ranks (``glom_tpu_torch.parallel``),
one command a rank: ``--coordinator host:port --num-processes N
--process-id i`` starts the process group (NCCL on cards, gloo with
``--device cpu``), ``--mesh`` shapes it over (data, model, seq) and
``--param-sharding`` places the params; every rank draws the same synthetic
batches and takes its slice, and rank 0 logs and writes the checkpoints.

    python -m glom_tpu_torch.training.train --steps 5 --batch-size 8 \\
        --ff-impl pallas --fused-ff-bwd --attention-impl pallas --log-every 1
    python -m glom_tpu_torch.training.train --data folder --data-dir DIR --augment flip \\
        --consistency infonce --eval-every 50
    python -m glom_tpu_torch.training.train --supervise --checkpoint-dir CKPT \\
        --checkpoint-every 10 --forensics-dir FORENSICS --steps 100
    python -m glom_tpu_torch.training.train --device cpu --mesh 2 1 1 \\
        --coordinator localhost:29500 --num-processes 2 --process-id 0   # and id 1
"""

from __future__ import annotations

import argparse

import numpy as np
import torch.distributed as dist

from glom_tpu_torch.config import GlomConfig, TrainConfig, resolve_device
from glom_tpu_torch.parallel.mesh import initialize_distributed
from glom_tpu_torch.training.data import AUGMENT_KINDS, _StatefulAugmented, make_batches
from glom_tpu_torch.training.metrics import MetricLogger
from glom_tpu_torch.training.trainer import REASONS, Trainer

# flags of the JAX CLI the port does not take yet: flag -> (nargs, REASONS key)
_REFUSED = {
    "--checkpoint-backend": (1, "mesh"),
    "--stop-poll-steps": (1, "mesh"),
    "--platform": (1, "device"),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GLOM denoising-SSL training (PyTorch/CUDA port)")
    # model
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--levels", type=int, default=6)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--patch-size", type=int, default=14)
    p.add_argument("--consensus-self", action="store_true")
    p.add_argument("--local-consensus-radius", type=int, default=0)
    p.add_argument("--bf16", action="store_true", help="bf16 compute (params stay fp32)")
    p.add_argument("--attention-impl", default="dense",
                   choices=["auto", "dense", "pallas", "ring", "ulysses"],
                   help="pallas = the port's CUDA consensus kernels (forward, K6, K7); "
                        "auto = pallas on a CUDA device above the measured crossover, else "
                        "dense (the ring under a seq axis above one); ring and ulysses = "
                        "the sequence-parallel consensus over the mesh's seq axis")
    p.add_argument("--ff-impl", default="dense", choices=["dense", "pallas", "fused"],
                   help="pallas = the port's CUDA grouped-FF kernel (K1); fused = the whole "
                        "level update in one call of its kernels (K8), falling back to pallas "
                        "when the shape or --fuse-ff rules it out")
    p.add_argument("--fused-ff-bwd", action="store_true",
                   help="with --ff-impl pallas or fused: gradients through the backward "
                        "kernels K2 and K3 instead of the plain VJP")
    p.add_argument("--fuse-ff", action="store_true",
                   help="bottom-up and top-down as one grouped call of 2L-1 groups")
    p.add_argument("--remat", action="store_true",
                   help="activation checkpointing around each iteration")
    p.add_argument("--remat-policy", default="dots", choices=["full", "dots"],
                   help="dots keeps the plain path's matrix products and recomputes the "
                        "rest; full recomputes the whole step")
    p.add_argument("--scan-unroll", type=int, default=1,
                   help="accepted for the JAX CLI's sake; the port's loop is eager, so "
                        "it changes nothing")
    # training
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--grad-accum-steps", type=int, default=1)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--lr-schedule", default="constant", choices=["constant", "cosine"])
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--grad-clip-norm", type=float, default=0.0,
                   help="clip gradients by global norm before the optimizer (0 = off); "
                        "the logged grad_norm stays pre-clip")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--loss-timestep", type=int, default=None,
                   help="which state feeds the denoising loss; default iters//2+1, "
                        "where the forward stops")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise-std", type=float, default=1.0)
    p.add_argument("--eval-every", type=int, default=0,
                   help="evaluate every N steps (0 = off): the EvalSuite on the held-out "
                        "split with --data images, else the incoming batch's PSNR")
    p.add_argument("--consistency", default="none", choices=["none", "mse", "infonce"],
                   help="two-view consistency regularization of top-ish levels")
    p.add_argument("--consistency-weight", type=float, default=0.1)
    p.add_argument("--consistency-temperature", type=float, default=0.1)
    p.add_argument("--consistency-level", type=int, default=-1)
    p.add_argument("--decoder", default="linear",
                   choices=["linear", "mlp", "linear_all", "mlp_all"])
    p.add_argument("--decoder-hidden-mult", type=int, default=2)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of steps 2-4 of the run here "
                        "(glom_tpu_torch.profiling.trace)")
    p.add_argument("--halt-on-nan", action="store_true",
                   help="fail fast when a logging window shows nonfinite grads/loss")
    p.add_argument("--log-file", default=None)
    p.add_argument("--data", default="synthetic", choices=["synthetic", "folder", "images"],
                   help="synthetic randn stream, .npy/.npz folder, or a JPEG/PNG folder tree "
                        "(a resumable stream)")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--augment", default="none", choices=list(AUGMENT_KINDS))
    p.add_argument("--eval-holdout", type=float, default=0.02,
                   help="(images + --eval-every) fraction of files held out of training for "
                        "the eval suite")
    p.add_argument("--probe-examples", type=int, default=256,
                   help="held-out labeled examples for the linear probe (0 disables it)")
    p.add_argument("--probe-l2-grid", type=float, nargs="+", default=None,
                   help="candidate ridge strengths for the probe, chosen on a held-out tail "
                        "of the probe-train half (default: fixed l2=1e-3)")
    p.add_argument("--eval-max-images", type=int, default=1024,
                   help="cap on held-out images decoded into host RAM and scored per eval "
                        "point")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (refused without a card); with several "
                        "processes, cuda is cuda:<process id mod the cards on the host>")
    # parallelism (glom_tpu_torch.parallel): one process a device
    p.add_argument("--mesh", type=int, nargs="+", default=None,
                   help="mesh shape over (data, model, seq) ranks; default: all-data")
    p.add_argument("--param-sharding", default="tp", choices=["tp", "ep", "replicated"],
                   help="how params use the model axis")
    p.add_argument("--coordinator", default=None,
                   help="host:port of the process group's rendezvous (tcp://host:port); "
                        "one command a rank")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    # checkpointing and observability (glom_tpu_torch.obs)
    p.add_argument("--async-checkpoint", action="store_true",
                   help="write checkpoints on a background thread (the host copy stays "
                        "synchronous; fit returns once the last one is durable)")
    p.add_argument("--trace-dir", default=None,
                   help="write the step loop's phase spans as a Perfetto-loadable "
                        "train_trace.json here at the end of fit")
    p.add_argument("--metrics-csv", default=None,
                   help="also mirror every log record to this CSV file")
    p.add_argument("--prom-textfile", default=None,
                   help="write a Prometheus textfile-collector snapshot here at every log "
                        "boundary (atomic rename)")
    p.add_argument("--diag-every", type=int, default=0,
                   help="GLOM diagnostics cadence (island agreement, attention entropy, "
                        "contribution shares): one extra forward every N steps; 0 = off")
    p.add_argument("--no-monitor-numerics", action="store_true",
                   help="disable the NaN/Inf and grad-spike monitor (on by default; a few "
                        "reductions a step)")
    p.add_argument("--grad-spike-factor", type=float, default=10.0,
                   help="flag a window when grad_norm exceeds this factor times its running "
                        "EMA")
    # resilience (glom_tpu_torch.resilience)
    p.add_argument("--supervise", action="store_true",
                   help="run fit() under the self-healing supervisor: a crash restarts with "
                        "exponential backoff from the newest checkpoint that passes its "
                        "integrity check; a crash loop, or a sticky CUDA error, gives up")
    p.add_argument("--max-restart-failures", type=int, default=5,
                   help="(--supervise) failures within the crash-loop window before giving up")
    p.add_argument("--restart-window-s", type=float, default=600.0,
                   help="(--supervise) sliding crash-loop window, seconds")
    # forensics (glom_tpu_torch.obs.forensics): anomaly-triggered evidence
    p.add_argument("--forensics-dir", default=None,
                   help="write post-mortem bundles (flight-recorder ring, env fingerprint, "
                        "the step's kernel launches and cost) here when a monitor fires, the "
                        "run crashes or a stop ends it")
    p.add_argument("--forensics-ring", type=int, default=256,
                   help="flight-recorder capacity in log records (0 = off)")
    p.add_argument("--forensics-max-captures", type=int, default=3,
                   help="budget of triggered captures a run")
    p.add_argument("--forensics-debounce-steps", type=int, default=200,
                   help="per-trigger re-fire spacing: a NaN storm inside this many steps is "
                        "one bundle")
    p.add_argument("--forensics-trace-steps", type=int, default=0,
                   help="also record a torch.profiler trace of N steps after each capture "
                        "(0 = off; ignored while --profile-dir is set)")
    p.add_argument("--no-forensics-hlo", action="store_true",
                   help="leave the step snapshot (kernel launches, cost, memory) out of "
                        "bundles (glom_tpu's name: there it is the HLO snapshot)")
    p.add_argument("--forensics-step-time-factor", type=float, default=2.0,
                   help="fire the step-time regression trigger when recent windows' p95 "
                        "step time exceeds this factor times the baseline p95 (0 = off)")
    refused = p.add_argument_group("refused: not in the port yet")
    for flag, (nargs, _) in _REFUSED.items():
        kw = {"action": "store_true"} if nargs == 0 else {"nargs": None if nargs == 1 else nargs}
        refused.add_argument(flag, default=argparse.SUPPRESS, help=argparse.SUPPRESS, **kw)
    args = p.parse_args(argv)
    for flag, (_, why) in _REFUSED.items():
        if hasattr(args, flag[2:].replace("-", "_")):
            p.error(f"{flag} is not in the port's trainer yet ({REASONS[why]})")
    if args.data != "synthetic" and not args.data_dir:
        p.error(f"--data {args.data} needs --data-dir")
    return args


def holdout_eval_data(args):
    """``(train_files, eval_images, probe_kwargs)`` for ``--data images``
    with ``--eval-every``: the held-out files are carved off before the
    training stream exists (``glom_tpu``'s split, permutation and caps), and
    the probe's labels are the files' parent directories."""
    from glom_tpu_torch.training.eval import holdout_split
    from glom_tpu_torch.training.image_stream import (
        labels_from_paths, list_image_files, load_images)

    train_files, eval_files = holdout_split(list_image_files(args.data_dir), args.eval_holdout,
                                            seed=args.seed)
    # eval files arrive grouped by class (sorted paths): permute before the
    # caps so that the decoded subset spans classes
    perm = np.random.default_rng(args.seed).permutation(len(eval_files))
    eval_files = [eval_files[i] for i in perm[:args.eval_max_images]]
    eval_imgs = load_images(eval_files, args.image_size)
    probe_kwargs = {}
    if args.probe_examples:
        labels, names = labels_from_paths(eval_files[:args.probe_examples])
        if len(names) > 1:
            probe_kwargs = dict(probe_images=eval_imgs[:args.probe_examples],
                                probe_labels=labels, num_classes=len(names),
                                probe_l2_grid=args.probe_l2_grid)
    return train_files, eval_imgs, probe_kwargs


def main(argv=None):
    args = parse_args(argv)
    # the device is settled before any attempt: without a card this refuses
    # at once, and a supervisor never retries it
    device = initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                    device=args.device) or resolve_device(args.device)
    try:
        return _main(args, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _main(args, device):
    config = GlomConfig(
        dim=args.dim, levels=args.levels, image_size=args.image_size,
        patch_size=args.patch_size, consensus_self=args.consensus_self,
        local_consensus_radius=args.local_consensus_radius,
        compute_dtype="bfloat16" if args.bf16 else None,
        attention_impl=args.attention_impl, ff_impl=args.ff_impl,
        ff_fused_bwd=args.fused_ff_bwd, fuse_ff=args.fuse_ff, remat=args.remat,
        remat_policy=args.remat_policy, scan_unroll=args.scan_unroll,
    )
    train_cfg = TrainConfig(
        batch_size=args.batch_size, grad_accum_steps=args.grad_accum_steps,
        learning_rate=args.lr, lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
        weight_decay=args.weight_decay, grad_clip_norm=args.grad_clip_norm, iters=args.iters,
        loss_timestep=args.loss_timestep, noise_std=args.noise_std,
        consistency=args.consistency, consistency_weight=args.consistency_weight,
        consistency_temperature=args.consistency_temperature,
        consistency_level=args.consistency_level, eval_every=args.eval_every, decoder=args.decoder,
        decoder_hidden_mult=args.decoder_hidden_mult, steps=args.steps,
        log_every=args.log_every, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir, halt_on_nan=args.halt_on_nan, seed=args.seed,
        profile_dir=args.profile_dir, async_checkpoint=args.async_checkpoint,
        trace_dir=args.trace_dir, monitor_numerics=not args.no_monitor_numerics,
        grad_spike_factor=args.grad_spike_factor, diag_every=args.diag_every,
        forensics_dir=args.forensics_dir, forensics_ring=args.forensics_ring,
        forensics_max_captures=args.forensics_max_captures,
        forensics_debounce_steps=args.forensics_debounce_steps,
        forensics_trace_steps=args.forensics_trace_steps,
        forensics_hlo=not args.no_forensics_hlo,
        forensics_step_time_factor=args.forensics_step_time_factor,
        metrics_csv=args.metrics_csv, prom_textfile=args.prom_textfile,
        mesh_shape=tuple(args.mesh) if args.mesh else None, param_sharding=args.param_sharding,
    )
    eval_data = holdout_eval_data(args) if args.data == "images" and args.eval_every else None

    def make_stream():
        if eval_data is not None:
            from glom_tpu_torch.training.image_stream import ImageFolderStream

            stream = ImageFolderStream(args.data_dir, args.batch_size, args.image_size,
                                       channels=config.channels, seed=args.seed,
                                       files=eval_data[0])
            if args.augment != "none":
                stream = _StatefulAugmented(stream, args.augment, args.seed)
            return stream
        return make_batches(args.data, args.batch_size, args.image_size, config.channels,
                            args.seed, args.data_dir, augment=args.augment)

    def run_once():
        # built fresh for each (supervised) attempt: a crashed attempt's
        # trainer, state and stream may be poisoned; recovery flows only
        # through the checkpoint directory
        trainer = Trainer(config, train_cfg, device=device,
                          logger=MetricLogger(path=args.log_file))
        if eval_data is not None:
            from glom_tpu_torch.training.eval import EvalSuite

            _, eval_imgs, probe_kwargs = eval_data
            trainer.set_eval_suite(EvalSuite(
                config, eval_imgs, noise_std=args.noise_std, iters=args.iters,
                timestep=args.loss_timestep, chunk=min(args.batch_size, len(eval_imgs)),
                decoder=args.decoder, **probe_kwargs))
        batches = make_stream()
        try:
            return trainer.fit(batches)
        finally:
            close = getattr(batches, "close", None)
            if callable(close):
                close()

    if args.supervise:
        from glom_tpu_torch.obs import MetricRegistry
        from glom_tpu_torch.resilience.supervisor import RestartPolicy, Supervisor

        # the supervisor outlives every attempt's Trainer (each builds its own
        # registry and forensics), so it has its own: the restart counters
        # land in each crash_restart bundle's metrics.json
        sup_registry = MetricRegistry()
        sup_forensics = None
        if args.forensics_dir:
            from glom_tpu_torch.obs.forensics import ForensicsManager

            sup_forensics = ForensicsManager(
                args.forensics_dir, registry=sup_registry,
                config={"glom": config.to_json_dict(), "train": train_cfg.to_json_dict()})
        final = Supervisor(
            run_once,
            policy=RestartPolicy(max_failures=args.max_restart_failures,
                                 window_s=args.restart_window_s),
            checkpoint_dir=args.checkpoint_dir, registry=sup_registry,
            forensics=sup_forensics, seed=args.seed,
        ).run()
    else:
        final = run_once()
    if not dist.is_initialized() or dist.get_rank() == 0:
        print({"final": final})
    return final


if __name__ == "__main__":
    main()
