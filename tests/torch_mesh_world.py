"""Start a gloo world of ``tests/torch_mesh_worker.py`` ranks and collect
their results, for the port's mesh tests.  Not a test module itself.

Each world rendezvouses through a ``file://`` store in its own directory, so
that several pytest-xdist workers never race for a TCP port; every rank runs
torch on one thread, and the group and the join both have a timeout.
"""

import json
import os
import subprocess
import sys

import numpy as np

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mesh_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_world(directory: str, world: int, jobs: list, timeout_s: float = 240.0) -> dict:
    """Run ``jobs`` on ``world`` ranks; returns ``{job name: [rank 0's
    results, rank 1's, ...]}`` (each an ``np.load`` of the rank's npz)."""
    os.makedirs(directory, exist_ok=True)
    spec = {"world": world, "init": "file://" + os.path.join(directory, "store"),
            "out": directory, "jobs": jobs, "timeout_s": timeout_s / 2}
    path = os.path.join(directory, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    logs = [open(os.path.join(directory, f"rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, path, str(r)], env=env, cwd=directory,
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    try:
        codes = [p.wait(timeout=timeout_s) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(codes):
        tails = []
        for r in range(world):
            with open(os.path.join(directory, f"rank{r}.log")) as f:
                tails.append(f"--- rank {r} (exit {codes[r]}) ---\n" + f.read()[-3000:])
        raise RuntimeError("a rank of the world failed:\n" + "\n".join(tails))
    return {job["name"]: [dict(np.load(os.path.join(directory, f"{job['name']}-{r}.npz")))
                          for r in range(world)] for job in jobs}


def assemble(parts: list, key: str, shape) -> np.ndarray:
    """The whole ``(b, n, ...)`` array from each rank's ``key`` and its
    ``rows`` / ``cols`` bounds (ranks holding the same block must agree)."""
    full = np.full(shape, np.nan, np.float32)
    for part in parts:
        (r0, r1), (c0, c1) = part["rows"], part["cols"]
        block = full[r0:r1, c0:c1]
        if not np.isnan(block).all():
            np.testing.assert_array_equal(block, part[key])
        full[r0:r1, c0:c1] = part[key]
    assert not np.isnan(full).any()
    return full
