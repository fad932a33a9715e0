"""CLI embedding extraction: ``python -m glom_tpu_torch.training.extract``
(``glom_tpu/training/extract.py``).

Loads a trainer checkpoint (either package's; self-describing through its
``config.json``), streams an ImageFolder tree through the forward, and
writes the patch-mean embedding of one level (or of every level) of each
image, with labels from the directory layout, to one ``.npz``: the keys and
the JSON line of ``glom_tpu``'s CLI.  The forward runs the checkpoint's
``ff_impl`` / ``attention_impl``, so a checkpoint trained on the kernels
extracts through them.  The run is on ``cuda`` unless ``--device cpu`` is
given; ``--platform`` (the JAX CLI's) is refused by name.

    python -m glom_tpu_torch.training.extract --checkpoint-dir CKPT \\
        --data-dir DATA --out embeddings.npz [--level -1 | --all-levels]
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Optional

import numpy as np
import torch

from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.models import glom as glom_model


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GLOM embedding extraction (PyTorch/CUDA port)")
    p.add_argument("--checkpoint-dir", required=True,
                   help="trainer checkpoint dir (reads its config.json)")
    p.add_argument("--data-dir", required=True, help="ImageFolder root")
    p.add_argument("--out", default="embeddings.npz")
    p.add_argument("--level", type=int, default=-1,
                   help="which level's columns to mean-pool (default: top)")
    p.add_argument("--all-levels", action="store_true",
                   help="save (N, levels, dim): one pooled vector per level")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--max-images", type=int, default=0, help="0 = all")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (refused without a card)")
    p.add_argument("--platform", default=argparse.SUPPRESS, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if hasattr(args, "platform"):
        from glom_tpu_torch.training.trainer import REASONS

        p.error(f"--platform is not in the port ({REASONS['device']})")
    return args


def extract_embeddings(params: dict, config: GlomConfig, batches: Iterable, *, level: int = -1,
                       all_levels: bool = False, iters: Optional[int] = None) -> np.ndarray:
    """The patch-mean embeddings of every image in ``batches`` (arrays or
    tensors ``(b, c, H, W)``), run through the GLOM tree ``params`` on its
    device: ``(N, dim)`` float32 for ``level``, or ``(N, levels, dim)`` with
    ``all_levels``.  Batches may differ in size (the tail needs no padding)."""
    device = glom_model.tree_leaves(params)[0].device
    chunks = []
    with torch.inference_mode():
        for imgs in batches:
            imgs = torch.as_tensor(imgs).to(device)
            pooled = glom_model.apply(params, imgs, config=config, iters=iters).mean(dim=1)
            out = pooled if all_levels else pooled[:, level]
            chunks.append(out.float().cpu().numpy())
    return np.concatenate(chunks)


def decoded_batches(files, batch_size: int, image_size: int):
    """Decoded ``(b, 3, S, S)`` float32 batches of ``files`` in order; one
    worker thread decodes batch i+1 while the caller runs batch i."""
    from glom_tpu_torch.training.image_stream import load_images

    chunks = [files[i:i + batch_size] for i in range(0, len(files), batch_size)]
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(load_images, chunks[0], image_size)
        for j in range(len(chunks)):
            imgs = pending.result()
            if j + 1 < len(chunks):
                pending = pool.submit(load_images, chunks[j + 1], image_size)
            yield imgs


def main(argv=None):
    args = parse_args(argv)

    from glom_tpu_torch.config import resolve_device
    from glom_tpu_torch.training.denoise import load_checkpoint_state
    from glom_tpu_torch.training.image_stream import labels_from_paths, list_image_files

    device = resolve_device(args.device)
    step, config, _, params = load_checkpoint_state(args.checkpoint_dir, device=device)

    files = list_image_files(args.data_dir)
    if args.max_images:
        files = files[:args.max_images]
    if not files:
        raise SystemExit(f"no images found under {args.data_dir}")
    labels, class_names = labels_from_paths(files)

    embeddings = extract_embeddings(
        params["glom"], config, decoded_batches(files, args.batch_size, config.image_size),
        level=args.level, all_levels=args.all_levels, iters=args.iters)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(
        args.out,
        embeddings=embeddings.astype(np.float32),
        labels=labels,
        class_names=np.array(class_names),
        paths=np.array(files),
        checkpoint_step=step,
        level=args.level if not args.all_levels else -999,
    )
    print(json.dumps({
        "out": args.out, "n": int(embeddings.shape[0]),
        "shape": list(embeddings.shape), "classes": len(class_names),
        "checkpoint_step": int(step),
    }))


if __name__ == "__main__":
    main()
