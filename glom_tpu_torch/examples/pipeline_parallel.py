"""Pipeline parallelism over the GLOM iteration loop (``glom_tpu``'s
``examples/pipeline_parallel.py``).

GLOM's depth is a weight-tied iteration loop, so PP here pipelines iteration
CHUNKS, not weight shards: every stage holds the whole parameter tree, and
only the level state flows from stage to stage.

The script starts its S ranks itself, one process a stage over gloo: on the
CPU with ``--device cpu``, else on the card, every rank on ``cuda:0`` (NCCL
refuses two ranks on one device; gloo stages what it does not take on CUDA
tensors through the host).  With no card and no ``--device cpu`` it exits
non-zero.

Run: python -m glom_tpu_torch.examples.pipeline_parallel [--device cpu] [--stages 4]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_rank(args) -> int:
    """One stage: the pipelined forward against the sequential one, and the
    gradients through the pipeline; rank 0 prints."""
    import torch.distributed as dist

    from glom_tpu_torch.config import GlomConfig
    from glom_tpu_torch.models import glom as glom_model
    from glom_tpu_torch.parallel import make_mesh, make_pipelined_apply
    from glom_tpu_torch.parallel.mesh import initialize_distributed

    device = initialize_distributed(args.store, args.stages, args.rank,
                                    device="cpu" if args.device == "cpu" else "cuda:0",
                                    backend="gloo", timeout_s=300)
    try:
        mesh = make_mesh((args.stages,), ("pipe",))
        config = GlomConfig(dim=64, levels=4, image_size=32, patch_size=8)
        params = glom_model.init(torch.Generator().manual_seed(0), config, device)
        img = np.random.default_rng(0).standard_normal((8, 3, 32, 32)).astype(np.float32)
        img = torch.from_numpy(img).to(device)

        # 8 microbatches through S stages; iters=8 => each stage runs 8/S iterations
        pp_apply = make_pipelined_apply(mesh, config, num_microbatches=8)
        with torch.no_grad():
            out = pp_apply(params, img, iters=8)
            seq = glom_model.apply(params, img, config=config, iters=8)
        err = float((out - seq).abs().max())
        if args.rank == 0:
            print(f"pipelined ({args.stages} stages):", tuple(out.shape))
            print(f"max |pipelined - sequential| = {err:.2e}")

        # gradients flow through the pipeline schedule (its reverse schedule):
        live = glom_model.tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = torch.mean(pp_apply(live, img, iters=8) ** 2)
        grads = torch.autograd.grad(loss, glom_model.tree_leaves(live))
        if args.rank == 0:
            print("grad leaves:", len(grads), flush=True)
        return 0 if err < 1e-4 else 1
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the ranks run (default: the card, every rank on cuda:0)")
    p.add_argument("--stages", type=int, default=4, help="pipeline stages, one rank each")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        return run_rank(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("pipeline_parallel: no CUDA device is available; pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return 2
    work = tempfile.mkdtemp(prefix="pipeline-")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT] + [x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x])}
    argv_rank = [sys.executable, "-m", "glom_tpu_torch.examples.pipeline_parallel",
                 "--device", args.device, "--stages", str(args.stages),
                 "--store", "file://" + os.path.join(work, "store")]
    procs = [subprocess.Popen(argv_rank + ["--rank", str(r)], env=env,
                              stdout=None if r == 0 else subprocess.DEVNULL)
             for r in range(args.stages)]
    try:
        codes = [proc.wait(timeout=600) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    return max(codes)


if __name__ == "__main__":
    sys.exit(main())
