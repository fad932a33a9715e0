"""The accuracy harness of the quantized serving modes (``tools/quant_check.py``
for the port).

    python -m glom_tpu_torch.tools.quant_check --checkpoint-dir CKPT [--modes int8,bf16]
    python -m glom_tpu_torch.tools.quant_check --demo --device cpu

Runs each quant mode (:mod:`glom_tpu_torch.serving.quant`) against f32 on
both serving endpoints, the per-level ``/embed`` embeddings and the
``/reconstruct`` decode, through the checkpoint's kernels, and prints one
JSON report: per-level cosine and max-abs error.  Exits 1 when a mode misses
its threshold (:data:`~glom_tpu_torch.serving.quant.ACCURACY_THRESHOLDS`):
the gate for serving ``--quant int8|bf16`` is this tool passing on the
checkpoint about to be served.  Runs on ``cuda`` unless ``--device`` names
another device; ``--platform`` (the JAX tool's) is refused by name.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint-dir", default=None,
                   help="Trainer checkpoint dir (reads its config.json)")
    p.add_argument("--demo", action="store_true",
                   help="run on a throwaway demo checkpoint (a plumbing check)")
    p.add_argument("--modes", default="bf16,int8",
                   help="comma-separated quant modes to check against f32")
    p.add_argument("--batch", type=int, default=4, help="probe batch (random normal images)")
    p.add_argument("--iters", type=int, default=None,
                   help="GLOM iterations (default: the model's)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch versions of the kernels")
    p.add_argument("--device-probe-timeout", type=float, default=240,
                   help="seconds the first touch of the card may take before the tool "
                        "emits an error line and exits 2 (glom_tpu_torch.device_guard); "
                        "<= 0 disables the guard")
    p.add_argument("--platform", default=argparse.SUPPRESS, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if hasattr(args, "platform"):
        p.error("--platform is not in the port (the port picks its device with --device)")
    if not args.demo and not args.checkpoint_dir:
        p.error("need --checkpoint-dir or --demo")

    import numpy as np

    from glom_tpu_torch.config import resolve_device
    from glom_tpu_torch.device_guard import guarded_cuda_init
    from glom_tpu_torch.serving import quant
    from glom_tpu_torch.training import denoise

    modes = tuple(m.strip() for m in args.modes.split(",") if m.strip())
    for m in modes:
        if m not in quant.ACCURACY_THRESHOLDS:
            p.error(f"no acceptance threshold for mode {m!r} "
                    f"(known: {sorted(quant.ACCURACY_THRESHOLDS)})")
    device = resolve_device(args.device)
    guarded_cuda_init(device, args.device_probe_timeout,
                      lambda msg: print(f"quant_check: {msg}", file=sys.stderr, flush=True))
    ckpt_dir = args.checkpoint_dir
    if args.demo and ckpt_dir is None:
        import tempfile

        from glom_tpu_torch.serving.engine import make_demo_checkpoint

        ckpt_dir = tempfile.mkdtemp(prefix="glom-torch-quant-demo-")
        make_demo_checkpoint(ckpt_dir)

    _, config, train_cfg, params = denoise.load_checkpoint_state(ckpt_dir, device="cpu")
    imgs = np.random.RandomState(args.seed).randn(
        args.batch, config.channels, config.image_size, config.image_size).astype(np.float32)
    report = quant.accuracy_report(config, train_cfg, params, imgs, modes=modes,
                                   iters=args.iters, device=device)
    ok = all(r["pass"] for r in report.values())
    print(json.dumps({"checkpoint_dir": ckpt_dir, "batch": args.batch, "modes": report,
                      "pass": ok}, indent=2))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
