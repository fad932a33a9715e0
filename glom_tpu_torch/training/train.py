"""CLI training entry point: ``python -m glom_tpu_torch.training.train``.

The flags this trainer honours keep ``glom_tpu.training.train``'s names.
The run is on ``cuda`` unless ``--device cpu`` is given; without a card it
refuses rather than move to the CPU.  Every other flag of the JAX CLI is
recognised and refused, with the ROADMAP item that will port it.  Data is
the synthetic stream (``--data synthetic``, the JAX CLI's default).

    python -m glom_tpu_torch.training.train --steps 5 --batch-size 8 \\
        --ff-impl pallas --fused-ff-bwd --attention-impl pallas --log-every 1
    python -m glom_tpu_torch.training.train --steps 5 --ff-impl fused --fused-ff-bwd
"""

from __future__ import annotations

import argparse

from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.training.data import synthetic_batches
from glom_tpu_torch.training.metrics import MetricLogger
from glom_tpu_torch.training.trainer import Trainer

# flags of the JAX CLI the port does not take yet: (flag, nargs, why)
_REFUSED = (
    ("--consistency", 1, "ROADMAP queue 1, item 3"),
    ("--consistency-weight", 1, "ROADMAP queue 1, item 3"),
    ("--consistency-temperature", 1, "ROADMAP queue 1, item 3"),
    ("--consistency-level", 1, "ROADMAP queue 1, item 3"),
    ("--eval-every", 1, "ROADMAP queue 1, item 3"),
    ("--data-dir", 1, "ROADMAP queue 1, item 3"),
    ("--augment", 1, "ROADMAP queue 1, item 3"),
    ("--eval-holdout", 1, "ROADMAP queue 1, item 3"),
    ("--probe-examples", 1, "ROADMAP queue 1, item 3"),
    ("--probe-l2-grid", "+", "ROADMAP queue 1, item 3"),
    ("--eval-max-images", 1, "ROADMAP queue 1, item 3"),
    ("--mesh", "+", "ROADMAP queue 1, item 6"),
    ("--param-sharding", 1, "ROADMAP queue 1, item 6"),
    ("--checkpoint-backend", 1, "ROADMAP queue 1, item 6"),
    ("--coordinator", 1, "ROADMAP queue 1, item 6"),
    ("--num-processes", 1, "ROADMAP queue 1, item 6"),
    ("--process-id", 1, "ROADMAP queue 1, item 6"),
    ("--stop-poll-steps", 1, "ROADMAP queue 1, item 6"),
    ("--async-checkpoint", 0, "ROADMAP queue 1, item 7"),
    ("--profile-dir", 1, "ROADMAP queue 1, item 7"),
    ("--trace-dir", 1, "ROADMAP queue 1, item 7"),
    ("--metrics-csv", 1, "ROADMAP queue 1, item 7"),
    ("--prom-textfile", 1, "ROADMAP queue 1, item 7"),
    ("--diag-every", 1, "ROADMAP queue 1, item 7"),
    ("--no-monitor-numerics", 0, "ROADMAP queue 1, item 7"),
    ("--grad-spike-factor", 1, "ROADMAP queue 1, item 7"),
    ("--supervise", 0, "ROADMAP queue 1, item 7"),
    ("--max-restart-failures", 1, "ROADMAP queue 1, item 7"),
    ("--restart-window-s", 1, "ROADMAP queue 1, item 7"),
    ("--forensics-dir", 1, "ROADMAP queue 1, item 7"),
    ("--forensics-ring", 1, "ROADMAP queue 1, item 7"),
    ("--forensics-max-captures", 1, "ROADMAP queue 1, item 7"),
    ("--forensics-debounce-steps", 1, "ROADMAP queue 1, item 7"),
    ("--forensics-trace-steps", 1, "ROADMAP queue 1, item 7"),
    ("--no-forensics-hlo", 0, "ROADMAP queue 1, item 7"),
    ("--forensics-step-time-factor", 1, "ROADMAP queue 1, item 7"),
    ("--platform", 1, "the port picks its device with --device"),
)


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
                        "dense; ring and ulysses are refused with their ROADMAP item")
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
                   help="kept for the JAX CLI's sake: both recompute the whole step here "
                        "(models/glom.py::make_step_builder says why)")
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
    p.add_argument("--decoder", default="linear",
                   choices=["linear", "mlp", "linear_all", "mlp_all"])
    p.add_argument("--decoder-hidden-mult", type=int, default=2)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--halt-on-nan", action="store_true",
                   help="fail fast when a logging window shows nonfinite grads/loss")
    p.add_argument("--log-file", default=None)
    p.add_argument("--data", default="synthetic",
                   help="synthetic (the only stream in the port; the folder and image "
                        "streams are ROADMAP queue 1, item 3)")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (refused without a card)")
    refused = p.add_argument_group("refused: not in the port yet")
    for flag, nargs, _ in _REFUSED:
        kw = {"action": "store_true"} if nargs == 0 else {"nargs": None if nargs == 1 else nargs}
        refused.add_argument(flag, default=argparse.SUPPRESS, help=argparse.SUPPRESS, **kw)
    args = p.parse_args(argv)
    for flag, _, why in _REFUSED:
        if hasattr(args, flag[2:].replace("-", "_")):
            p.error(f"{flag} is not in the port's trainer yet ({why})")
    if args.data != "synthetic":
        p.error(f"--data {args.data} is not in the port yet (ROADMAP queue 1, item 3)")
    return args


def main(argv=None):
    args = parse_args(argv)
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
        loss_timestep=args.loss_timestep, noise_std=args.noise_std, decoder=args.decoder,
        decoder_hidden_mult=args.decoder_hidden_mult, steps=args.steps,
        log_every=args.log_every, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir, halt_on_nan=args.halt_on_nan, seed=args.seed,
    )
    trainer = Trainer(config, train_cfg, device=args.device,
                      logger=MetricLogger(path=args.log_file))
    batches = synthetic_batches(args.batch_size, args.image_size, config.channels, args.seed)
    final = trainer.fit(batches)
    print({"final": final})
    return final


if __name__ == "__main__":
    main()
