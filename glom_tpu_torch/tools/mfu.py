"""Model-FLOPs share of a measured train rate (``tools/mfu.py``).

Counts the train step's FLOPs two ways and turns an images/s rate (the
``value`` of ``python -m glom_tpu_torch.tools.bench``) into a share of the
card's peak:

  * model FLOPs: the analytic per-image cost of the GLOM update loop over
    the EXECUTED iterations (the loss timestep, ``iters // 2 + 1``), times 3
    for forward + backward; remat's recompute is excluded (overhead, not
    model work).  The same formula as ``glom_tpu``'s tool.
  * executed FLOPs: :func:`glom_tpu_torch.profiling.cost_analysis` on one
    train step of the PLAIN path (``ff_impl`` and ``attention_impl``
    ``"dense"``) of the same configuration, at the same executed count.
    ``FlopCounterMode`` counts aten products only and the port's kernels
    launch through ``ctypes``, so a kernel path would count short; the plain
    path runs the same products.  The configuration is the bench's default
    (bf16, remat "dots", which keeps the products: none is recomputed).

The peak comes from :data:`PEAK_TFLOPS`, keyed by the card's name
(``torch.cuda.get_device_name``); a card the table lacks needs
``--peak-tflops``: the tool never guesses.

    python -m glom_tpu_torch.tools.mfu --imgs-per-sec 300
    python -m glom_tpu_torch.tools.mfu --imgs-per-sec 300 --card "NVIDIA H100 80GB HBM3" \\
        --skip-executed                        # anywhere, no card needed
    python -m glom_tpu_torch.tools.mfu --imgs-per-sec 5 --config tiny --batch-size 2 \\
        --peak-tflops 1 --device cpu
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Tuple

import torch

# Dense peak TFLOP/s by card name and compute type, from the vendor's data
# sheet.  "float32" is the CUDA cores' rate (the port's float32 kernels run
# 3xTF32 on the tensor cores, bounded by it in PERF.md's table).
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": {      # H100 SXM5, 700 W
        "bfloat16": 989.4, "float32": 66.9,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, H100 SXM5 (700 W), dense",
    },
}


def model_flops_per_image(c, iters: int) -> float:
    """Analytic matmul FLOPs for one image's forward pass of ``iters``
    EXECUTED iterations (2 m n k a product): the patch embedding, both
    grouped FFs and the two consensus products per level.  ``glom_tpu``'s
    ``tools/mfu.py::model_flops_per_image``."""
    n, d, h, L = c.num_patches, c.dim, c.dim * c.ff_mult, c.levels
    patch = 2 * n * c.patch_dim * d
    ff_bu = 2 * n * L * (d * h + h * d)              # L groups, two layers
    ff_td = 2 * n * (L - 1) * (d * h + h * d)        # L-1 groups
    attn = 2 * L * (n * n * d + n * n * d)           # QK^T + AV per level
    return patch + iters * (ff_bu + ff_td + attn)


def train_flops_per_image(c, iters: int) -> float:
    """The train step's model FLOPs an image: forward + backward, the
    backward of a product graph being twice the forward (dX and dW)."""
    return 3.0 * model_flops_per_image(c, iters)


def peak_tflops(card: Optional[str], dtype: torch.dtype) -> Tuple[Optional[float], str]:
    """``(peak TFLOP/s, source)`` of ``card`` for ``dtype`` from
    :data:`PEAK_TFLOPS`; ``(None, why)`` for a card the table lacks."""
    row = PEAK_TFLOPS.get(card or "")
    if row is None:
        return None, (f"no data-sheet peak for {card!r} in PEAK_TFLOPS; "
                      f"pass --peak-tflops")
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    return row[name], f"{row['source']}, {name}"


def executed_flops_per_image(config, iters: int, executed: int, batch: int, device) -> float:
    """:func:`glom_tpu_torch.profiling.cost_analysis` of one train step of
    ``config``'s plain path (dense FF and attention) at ``executed``
    iterations and ``batch`` images on ``device``, per image."""
    import dataclasses

    from glom_tpu_torch.config import TrainConfig
    from glom_tpu_torch.profiling import cost_analysis
    from glom_tpu_torch.training import denoise
    from glom_tpu_torch.training.optim import Optimizer

    plain = dataclasses.replace(config, ff_impl="dense", attention_impl="dense")
    train = TrainConfig(batch_size=batch, iters=iters, loss_timestep=executed, log_every=0)
    optimizer = Optimizer.from_config(train)
    state = denoise.init_state(torch.Generator().manual_seed(0), plain, optimizer,
                               device=device)
    step = denoise.make_step_fn(plain, train, optimizer)
    img = torch.randn((batch, plain.channels, plain.image_size, plain.image_size),
                      generator=torch.Generator().manual_seed(1)).to(device)
    return cost_analysis(step, state, img)["flops"] / batch


def main(argv=None):
    from glom_tpu_torch.config import GlomConfig, TrainConfig, bench_preset, resolve_device
    from glom_tpu_torch.device_guard import guarded_cuda_init
    from glom_tpu_torch.training.denoise import resolve_loss_timestep

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--imgs-per-sec", type=float, required=True,
                   help="measured per-card training rate (tools/bench.py's value)")
    p.add_argument("--peak-tflops", type=float, default=None,
                   help="peak TFLOP/s of the card for the compute type; default from "
                        "PEAK_TFLOPS by --card")
    p.add_argument("--card", default=None,
                   help="card name, a key of PEAK_TFLOPS; default the card of --device")
    p.add_argument("--config", default="flagship", choices=["flagship", "large", "tiny"])
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--fp32", action="store_true",
                   help="float32 compute and the float32 peak (default bf16, as the bench)")
    p.add_argument("--loss-timestep", type=int, default=None,
                   help="executed iterations (unset = TrainConfig default, iters//2+1; 0 is "
                        "a valid explicit choice — the t=0 state)")
    p.add_argument("--skip-executed", action="store_true",
                   help="analytic numerator only (no train step is run)")
    p.add_argument("--device-probe-timeout", type=float, default=240,
                   help="seconds the first touch of the card may take before the tool "
                        "emits an error line and exits 2 (glom_tpu_torch.device_guard); "
                        "<= 0 disables the guard")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the executed count runs (the plain path's step)")
    args = p.parse_args(argv)

    dtype = torch.float32 if args.fp32 else torch.bfloat16
    card = args.card
    if card is None and args.peak_tflops is None:
        if not torch.cuda.is_available():
            p.error("no card to name: pass --card or --peak-tflops")
        guarded_cuda_init("cuda", args.device_probe_timeout,
                          lambda msg: print(f"mfu: {msg}", file=sys.stderr, flush=True))
        card = torch.cuda.get_device_name(0)
    if args.peak_tflops is not None:
        peak, source = args.peak_tflops, "--peak-tflops"
    else:
        peak, source = peak_tflops(card, dtype)
        if peak is None:
            p.error(source)

    kw, iters, _, _ = bench_preset(args.config)
    config = GlomConfig(compute_dtype=dtype, remat=True, **kw)
    executed = resolve_loss_timestep(TrainConfig(loss_timestep=args.loss_timestep, iters=iters),
                                     iters)
    fwd = model_flops_per_image(config, executed)
    train_flops = train_flops_per_image(config, executed)
    mfu = args.imgs_per_sec * train_flops / (peak * 1e12)
    print(f"analytic model FLOPs/img: fwd {fwd/1e9:.1f} GF "
          f"({executed} executed iterations of {iters}), train {train_flops/1e9:.1f} GF")
    print(f"peak                    : {peak} TF/s ({source})")
    print(f"MFU (model FLOPs)       : {100*mfu:.1f}%  "
          f"({args.imgs_per_sec} imgs/s x {train_flops/1e9:.1f} GF / {peak} TF/s)")
    if args.skip_executed:
        return
    device = resolve_device(args.device)
    guarded_cuda_init(device, args.device_probe_timeout,
                      lambda msg: print(f"mfu: {msg}", file=sys.stderr, flush=True))
    per_img = executed_flops_per_image(config, iters, executed, args.batch_size, device)
    util = args.imgs_per_sec * per_img / (peak * 1e12)
    print(f"executed FLOPs/img      : {per_img/1e9:.1f} GF "
          f"(x{per_img/train_flops:.2f} of model FLOPs — remat etc.; counted on the plain "
          f"path's step at b={args.batch_size}, {device.type})")
    print(f"hardware utilization    : {100*util:.1f}% of {peak} TF/s")


if __name__ == "__main__":
    main()
