"""One rank of a gloo world for the port's mesh tests (tests/test_torch_parallel*.py,
tests/test_torch_pipeline.py).

    python tests/torch_mesh_worker.py SPEC.json RANK

``SPEC.json`` names the world (``world``, a ``file://`` ``init`` method, the
``out`` directory, a ``timeout_s``) and the ``jobs`` every rank runs in
order; each job loads its inputs from an npz the test wrote and saves this
rank's results as ``<out>/<job name>-<rank>.npz``.  It imports only torch,
numpy and glom_tpu_torch (never JAX, glom_tpu, the test modules or the
conftest), and runs torch on one thread.  Not a test module itself.
"""

import io
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from glom_tpu_torch import checkpoint as ckpt_lib  # noqa: E402
from glom_tpu_torch.config import GlomConfig, TrainConfig  # noqa: E402
from glom_tpu_torch.convert import params_from_numpy  # noqa: E402
from glom_tpu_torch.parallel.comm import raw_all_reduce  # noqa: E402
from glom_tpu_torch.parallel.ff_shard import make_sharded_ff_pallas  # noqa: E402
from glom_tpu_torch.parallel.inference import make_data_parallel_forward  # noqa: E402
from glom_tpu_torch.parallel.mesh import initialize_distributed, make_mesh  # noqa: E402
from glom_tpu_torch.parallel.placement import (gather_leaf, gather_to_host,  # noqa: E402
                                               local_slice)
from glom_tpu_torch.parallel.pipeline import make_pipelined_apply  # noqa: E402
from glom_tpu_torch.parallel.ring import make_ring_consensus  # noqa: E402
from glom_tpu_torch.parallel.sharding import (level_sharded_pspecs,  # noqa: E402
                                              param_pspecs, replicated_pspecs)
from glom_tpu_torch.parallel.ulysses import make_ulysses_consensus  # noqa: E402
from glom_tpu_torch.training.denoise import DenoiseState, make_step_fn  # noqa: E402
from glom_tpu_torch.training.metrics import MetricLogger  # noqa: E402
from glom_tpu_torch.training.optim import Optimizer  # noqa: E402
from glom_tpu_torch.training.trainer import Trainer  # noqa: E402

torch.set_num_threads(1)


def _slices(mesh, b: int, n: int):
    """This rank's (rows, columns) of a (b, n, ...) array."""
    d, s = mesh.size("data"), mesh.size("seq")
    i, j = mesh.index("data"), mesh.index("seq")
    return slice(i * b // d, (i + 1) * b // d), slice(j * n // s, (j + 1) * n // s)


def _bounds(sl: slice) -> np.ndarray:
    return np.asarray([sl.start, sl.stop])


def job_consensus(job: dict) -> dict:
    inp = np.load(job["inputs"])
    mesh = make_mesh(job["mesh"])
    b, n = inp["levels"].shape[:2]
    rows, cols = _slices(mesh, b, n)
    levels = torch.from_numpy(inp["levels"])[rows, cols].clone().requires_grad_(True)
    mask = torch.from_numpy(inp["mask"]) if "mask" in inp else None
    make = make_ring_consensus if job["impl"] == "ring" else make_ulysses_consensus
    fn = make(mesh, attend_self=job["attend_self"], non_local_mask=mask, num_patches=n)
    out = fn(levels)
    (out * torch.from_numpy(inp["cot"])[rows, cols]).sum().backward()
    return {"out": out.detach().numpy(), "grad": levels.grad.numpy(), "rows": _bounds(rows),
            "cols": _bounds(cols)}


def job_ff(job: dict) -> dict:
    inp = np.load(job["inputs"])
    axes = tuple(job.get("axes", ("data", "model", "seq")))
    mesh = make_mesh(job["mesh"], axes)
    config = GlomConfig(dim=inp["x"].shape[-1], levels=job["levels"], image_size=16,
                        patch_size=4)
    extra = tuple(a for a in axes[3:] if mesh.size(a) > 1)
    if job["sharding"] == "tp":
        specs = param_pspecs(config)
    elif job["sharding"] == "ep":
        specs = level_sharded_pspecs(config, axis_size=mesh.size("model"),
                                     extra_axes={a: mesh.size(a) for a in extra} or None)
    else:
        specs = replicated_pspecs(config)
    spec = specs[job["net"]]
    params = {k: local_slice(torch.from_numpy(inp[k]), spec[k], mesh).requires_grad_(True)
              for k in ("w1", "b1", "w2", "b2")}
    b, n = inp["x"].shape[:2]
    rows, cols = _slices(mesh, b, n)
    x = torch.from_numpy(inp["x"])[rows, cols].clone().requires_grad_(True)
    ff_fn = make_sharded_ff_pallas(mesh, param_sharding=job["sharding"], fused_bwd=True,
                                   extra_expert_axes=extra)
    out = ff_fn(params, x)
    (out * torch.from_numpy(inp["cot"])[rows, cols]).sum().backward()
    res = {"out": out.detach().numpy(), "grad_x": x.grad.numpy(), "rows": _bounds(rows),
           "cols": _bounds(cols)}
    for k, p in params.items():
        # the whole batch's gradient: summed over the data and seq shards
        # (the trainer averages it), then gathered over the axes it is split over
        g = raw_all_reduce(raw_all_reduce(p.grad, mesh.axis("data")), mesh.axis("seq"))
        res[f"grad_{k}"] = gather_leaf(g, spec[k], mesh).numpy()
        res[f"local_{k}"] = np.asarray(p.shape)
    return res


def job_train(job: dict) -> dict:
    inp = np.load(job["inputs"])
    config = GlomConfig(**job["config"])
    train = TrainConfig(**{**job["train"], "mesh_shape": tuple(job["mesh"])})
    trainer = Trainer(config, train, device="cpu", logger=MetricLogger(stream=io.StringIO()))
    host = lambda: gather_to_host(trainer.state.params, trainer.mesh, trainer._specs)
    res = {"init": host(), "loss": [], "grad_norm": [], "nonfinite_grads": []}
    imgs, noise = inp["imgs"], inp["noise"]
    for k in range(len(imgs)):
        m = trainer.step(imgs[k], noise=torch.from_numpy(noise[k]))
        for key in ("loss", "grad_norm", "nonfinite_grads"):
            res[key].append(float(m[key]))
    res["final"] = host()
    res["psnr"] = float(trainer._eval(trainer.state.params, trainer.put(imgs[0]),
                                      noise=torch.from_numpy(noise[0])))
    if job.get("checkpoint"):
        # rank 0 writes the gathered state; a fresh trainer loads and slices it
        trainer.save(job["checkpoint"])
        again = Trainer(config, train, device="cpu", logger=MetricLogger(stream=io.StringIO()))
        res["restored_step"] = again.restore(job["checkpoint"])
        res["restored"] = gather_to_host(again.state.params, again.mesh, again._specs)
    return res


def _params(inp, config: GlomConfig, name: str) -> dict:
    """The ``name`` subtree of the npz's flat ``name/...`` keys, as tensors."""
    flat = {k: inp[k] for k in inp.files if k.startswith(name + "/")}
    return params_from_numpy(ckpt_lib.unflatten(flat)[name], config)


def _forward_outputs(out) -> dict:
    if isinstance(out, tuple):
        return {"final": out[0], "captured": out[1]}
    return {"out": out}


def job_pipe(job: dict) -> dict:
    """The pipelined forward at each of ``job["forward"]``'s calls, then (with
    ``job["step"]``) one train step through ``make_step_fn(apply_fn=...)``:
    its loss, grad norm, parameters and Adam's first moments."""
    inp = np.load(job["inputs"])
    mesh = make_mesh(job["mesh"], tuple(job["axes"]))
    config = GlomConfig(**job["config"])
    pp = make_pipelined_apply(mesh, config, **job.get("pipeline", {}))
    glom = _params(inp, config, "glom")
    img = torch.from_numpy(inp["img"])
    res = {}
    for i, call in enumerate(job.get("forward", [])):
        res[f"f{i}"] = _forward_outputs(pp(glom, img, **call))
    if "step" in job:
        train = TrainConfig(**job["step"])
        optimizer = Optimizer(train.learning_rate)
        params = {"glom": glom, "decoder": _params(inp, config, "decoder")}
        state = DenoiseState(params, optimizer.init(params), 0, torch.Generator())
        step = make_step_fn(config, train, optimizer, apply_fn=pp)
        new, metrics = step(state, img, noise=torch.from_numpy(inp["noise"]))
        res.update(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                   params=new.params, mu=new.opt_state["mu"])
    return res


def job_dp_forward(job: dict) -> dict:
    """make_data_parallel_forward at each of ``job["forward"]``'s calls."""
    inp = np.load(job["inputs"])
    mesh = make_mesh(job["mesh"], tuple(job["axes"]))
    config = GlomConfig(**job["config"])
    glom = _params(inp, config, "glom")
    return {f"f{i}": {"out": make_data_parallel_forward(mesh, config, **call)(
        glom, torch.from_numpy(inp["img"]))} for i, call in enumerate(job["forward"])}


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
    return {prefix.rstrip("/"): np.asarray(tree)}


JOBS = {"consensus": job_consensus, "ff": job_ff, "train": job_train, "pipe": job_pipe,
        "dp_forward": job_dp_forward}


def main(spec_path: str, rank: int) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    initialize_distributed(spec["init"], spec["world"], rank, device="cpu",
                           timeout_s=spec.get("timeout_s", 120))
    try:
        for job in spec["jobs"]:
            res = JOBS[job["kind"]](job)
            np.savez(os.path.join(spec["out"], f"{job['name']}-{rank}.npz"), **_flat(res))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
