"""One rank of a gloo world for the port's mesh tests (tests/test_torch_parallel*.py,
tests/test_torch_pipeline.py, tests/test_torch_sharded_serving.py,
tests/test_torch_elastic.py, tests/test_torch_sharded_checkpoint.py).

    python tests/torch_mesh_worker.py SPEC.json RANK

``SPEC.json`` names the world (``world``, a ``file://`` ``init`` method, the
``out`` directory, a ``timeout_s``) and the ``jobs`` every rank runs in
order; each job loads its inputs from an npz the test wrote and saves this
rank's results as ``<out>/<job name>-<rank>.npz``.  It imports only torch,
numpy and glom_tpu_torch (never JAX, glom_tpu, the test modules or the
conftest), and runs torch on one thread.  Not a test module itself.
"""

import dataclasses
import io
import json
import os
import signal
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from glom_tpu_torch import checkpoint as ckpt_lib  # noqa: E402
from glom_tpu_torch.config import GlomConfig, TrainConfig  # noqa: E402
from glom_tpu_torch.convert import params_from_numpy  # noqa: E402
from glom_tpu_torch.models import glom as glom_model  # noqa: E402
from glom_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
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
from glom_tpu_torch.serving.engine import ServingEngine  # noqa: E402
from glom_tpu_torch.tools.chaos import elastic_run, supervisor_state  # noqa: E402
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
    kw = dict(job.get("pipeline", {}))
    views = []
    if job.get("check_contiguous"):
        # the FF kernels take contiguous weights: note every leaf a stage
        # hands the FF function as a view
        plain = glom_model.make_ff_fn(config)

        def ff_fn(params, x):
            views.extend(k for k in ("w1", "b1", "w2") if not params[k].is_contiguous())
            ff_fn.calls += 1
            return plain(params, x)

        ff_fn.calls = 0
        kw["ff_fn"] = ff_fn
    pp = make_pipelined_apply(mesh, config, **kw)
    glom = _params(inp, config, "glom")
    img = torch.from_numpy(inp["img"])
    res = {}
    for i, call in enumerate(job.get("forward", [])):
        res[f"f{i}"] = _forward_outputs(pp(glom, img, **call))
    if job.get("check_contiguous"):
        res.update(ff_calls=kw["ff_fn"].calls, views=np.asarray(views, dtype=str))
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


def _tree_record(tree, prefix: str) -> dict:
    """Each leaf's local shape under ``prefix/path``, and whether every leaf
    is contiguous."""
    flat = _flat(glom_model.tree_map(lambda t: np.asarray(t.shape), tree), prefix + "/")
    flat[prefix + "_contiguous"] = all(t.is_contiguous() for t in glom_model.tree_leaves(tree))
    return flat


def _serve_calls(engine, imgs, endpoints) -> dict:
    """Each endpoint through the request path (submit, then the batch), and
    the index forward (parse's inner one) through the engine."""
    out = {}
    for ep in endpoints:
        fut = engine.submit(ep, imgs)
        engine.process_once(ep)
        out[ep] = fut.result(timeout=0)
    out["index"] = engine.run("index", imgs)
    return out


def job_serve(job: dict) -> dict:
    """A mesh serving engine (serving/sharded.py) on this rank, from the
    job's checkpoint: rank 0 leads and runs the job's calls, a follower
    follows until the leader drains (with ``die``, it leaves without
    following).  The leader also runs the refusals and, with ``one_rank``,
    the port's one-rank engine at the bucket a data rank computes on each
    data rank's rows."""
    if "timeout_s" in job:
        mesh_lib.DEFAULT_TIMEOUT_S = job["timeout_s"]
    imgs = np.load(job["inputs"])["imgs"]
    kw = dict(device="cpu", reload_poll_s=0, max_wait_ms=0.0, **job["engine"])
    for bad in job.get("refuse", []):
        # every rank builds the same engine and raises at the same place
        try:
            ServingEngine(job["ckpt"], **{**kw, **bad})
        except (ValueError, NotImplementedError) as e:
            bad["error"] = f"{type(e).__name__}: {e}"
    engine = ServingEngine(job["ckpt"], **kw)
    res = _tree_record(engine.params, "params")
    res["refusals"] = json.dumps(job.get("refuse", []))
    if not engine.is_leader:
        if job.get("die"):
            return res
        try:
            engine.run("embed", imgs)
        except RuntimeError as e:     # a follower serves no request
            res["own_call"] = str(e)
        res["calls"] = engine.follow()
        res["step"] = engine.step
        res["sets"] = np.asarray(sorted(engine._follower_sets))
        return res
    if job.get("die"):
        t0 = time.monotonic()
        try:
            _serve_calls(engine, imgs, ["embed"])
            res["error"] = ""
        except Exception as e:  # what the request's caller gets
            res["error"] = f"{type(e).__name__}: {e}"
        res["fail_s"] = time.monotonic() - t0
        res["status"] = engine.health()["status"]
        try:
            engine.run("embed", imgs)
            res["after"] = ""
        except Exception as e:
            res["after"] = f"{type(e).__name__}: {e}"
        engine.shutdown(drain=False)
        return res
    res.update(_serve_calls(engine, imgs, job["endpoints"]))
    try:
        engine.deploy.begin_shadow()
    except NotImplementedError as e:
        res["deploy_refused"] = str(e)
    if job.get("reload"):
        step, seed = job["reload"]
        params = ckpt_lib.load_tree(job["ckpt"], engine.step, "params")
        rng = np.random.default_rng(seed)
        ckpt_lib.save(job["ckpt"], step, {"params": glom_model.tree_map(
            lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype), params)})
        res["reloaded"] = engine.check_reload()
        res["step_after"] = engine.step
        res.update(_tree_record(engine.params, "reloaded"))
        res.update({f"{k}_after": v for k, v in _serve_calls(engine, imgs, ["embed"]).items()})
    res["captures"] = engine.registry.snapshot().get("serving_graph_captures", 0)
    health = engine.health()
    res["health"] = json.dumps(health, default=str)
    res["snapshots"] = json.dumps([dict(snap, family=name) for name, cache in engine.caches.items()
                                   for snap in cache.snapshots.values()], default=str)
    engine.shutdown(drain=False)
    if job.get("one_rank"):
        # the port's one-rank engine at a data rank's bucket, on each rank's rows
        d = engine.mesh.size("data")
        bucket = max(engine.buckets)
        per = bucket // d
        one_kw = {k: v for k, v in job["engine"].items() if k not in ("mesh_shape",
                                                                   "param_sharding")}
        one = ServingEngine(job["ckpt"], device="cpu", reload_poll_s=0,
                            **{**one_kw, "buckets": (per,)})
        for ep in ("embed", "reconstruct", "parse"):
            res[f"one_rank_{ep}"] = np.concatenate(
                [one.run(ep, imgs[i:i + per]) for i in range(0, len(imgs), per)])
        one.shutdown(drain=False)
    return res


class LossCapture:
    """A trainer logger keeping every step's loss at full precision (the
    JSONL log rounds it), across the attempts of an elastic run."""

    registry = None

    def __init__(self):
        self.losses = {}

    def log(self, step, **scalars):
        if "loss" in scalars:
            self.losses[int(step)] = float(scalars["loss"])

    def close(self):
        pass


def job_elastic(job: dict) -> dict:
    """``tools/chaos.py::elastic_run`` on this rank: every rank runs the same
    seeded supervisor; its losses (a rank of the last plan's mesh logs every
    step), the slots it consumed and its supervisor's state.  With ``tear``
    (a step N) an unfailed run to step N goes first, then rank 0 tears the
    last shard file of step N in half."""
    config = GlomConfig(**job["config"])
    train = TrainConfig(**job["train"])
    if job.get("tear"):
        at = int(job["tear"])
        elastic_run(hosts=job["hosts"], steps=at, batch=train.batch_size, spec=None,
                    ckpt_dir=train.checkpoint_dir, device="cpu", glom=config,
                    train=dataclasses.replace(train, steps=at), logger=LossCapture)
        if torch.distributed.get_rank() == 0:
            path = ckpt_lib.shard_paths(train.checkpoint_dir, at)[-1]
            os.truncate(path, os.path.getsize(path) // 2)
        torch.distributed.barrier()
    capture, slots, plans = LossCapture(), [], []
    sup = elastic_run(hosts=job["hosts"], steps=train.steps, batch=train.batch_size,
                      spec=job["spec"], ckpt_dir=train.checkpoint_dir, device="cpu",
                      slots=slots, glom=config, train=train, logger=lambda: capture,
                      plans=plans, seed=job.get("seed", 0))
    steps = sorted(capture.losses)
    return {"steps": np.asarray(steps, np.int64),
            "losses": np.asarray([capture.losses[k] for k in steps], np.float64),
            "slots": np.asarray(sorted(slots), np.int64),
            "state": json.dumps(supervisor_state(sup, plans), sort_keys=True)}


def job_replan(job: dict) -> dict:
    """``make_elastic_mesh`` for each host count of ``hosts`` in turn: which
    calls returned the mesh of the first call with the same count, whether
    this rank is a member of each, and that each member's barrier passes."""
    hosts = job["hosts"]
    made = [mesh_lib.make_elastic_mesh(h) for h in hosts]
    for m in made:
        if m is not None:
            m.barrier()
    first = [hosts.index(h) for h in hosts]
    return {"reused": np.asarray([i != f and made[i] is made[f] for i, f in enumerate(first)]),
            "member": np.asarray([m is not None for m in made])}


def job_stop(job: dict) -> dict:
    """``Trainer.fit`` on the job's mesh with a SIGTERM's stop requested on
    rank ``requester`` while it draws batch ``request_at``: the step every
    rank stops at."""
    config = GlomConfig(**job["config"])
    train = TrainConfig(**job["train"], mesh_shape=tuple(job["mesh"]))
    trainer = Trainer(config, train, device="cpu", logger=MetricLogger(stream=io.StringIO()))
    rank = torch.distributed.get_rank()
    rng = np.random.default_rng(0)

    def batches():
        k = 0
        while True:
            k += 1
            if rank == job["requester"] and k == job["request_at"]:
                trainer._request_stop(signal.SIGTERM, None)
            yield rng.standard_normal((train.batch_size, 3, config.image_size,
                                       config.image_size)).astype(np.float32)

    trainer.fit(batches())
    return {"stopped_at": int(trainer.state.step)}


def job_sharded(job: dict) -> dict:
    """A trainer on the job's mesh: with ``imgs`` it steps on them and saves
    sharded into ``ckpt`` and, gathered, as an npz into ``gathered``; with
    ``restore`` it restores that directory; either way its state comes back
    gathered (params, Adam's moments) with the step."""
    config = GlomConfig(**job["config"])
    train = TrainConfig(**job["train"], mesh_shape=tuple(job["mesh"]))
    trainer = Trainer(config, train, device="cpu", logger=MetricLogger(stream=io.StringIO()))
    res = {}
    if "imgs" in job:
        inp = np.load(job["imgs"])
        for k in range(len(inp["imgs"])):
            trainer.step(inp["imgs"][k], noise=torch.from_numpy(inp["noise"][k]))
        res["path"] = trainer.save(job["ckpt"], data_state={"consumed": 16, "seed": 3})
        gathered = trainer._host_trees({"consumed": 16, "seed": 3})
        if trainer.mesh.is_leader:
            ckpt_lib.save(job["gathered"], int(trainer.state.step), gathered)
    if "restore" in job:
        res["restored_step"] = trainer.restore(job["restore"])
    st = trainer.state
    res["step"] = int(st.step)
    res["state"] = {name: gather_to_host(tree, trainer.mesh, trainer._specs) for name, tree in
                    (("params", st.params), ("mu", st.opt_state["mu"]),
                     ("nu", st.opt_state["nu"]))}
    res["local_w1"] = np.asarray(st.params["glom"]["bottom_up"]["w1"].shape)
    return res


JOBS = {"consensus": job_consensus, "ff": job_ff, "train": job_train, "pipe": job_pipe,
        "dp_forward": job_dp_forward, "serve": job_serve, "elastic": job_elastic,
        "replan": job_replan, "stop": job_stop, "sharded": job_sharded}


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
