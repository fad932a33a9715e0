"""The port's sharded checkpoints (``checkpoint_backend="sharded"``:
``glom_tpu_torch/checkpoint.py::save_sharded`` and its loader, the
trainer's per-rank cursor, the shard-aware integrity policy) crossing
``glom_tpu``'s, both ways.

  * a TP save on a gloo world of 2 CPU ranks, ``(1, 2, 1)``, one shard file
    a rank, is read by ``glom_tpu``'s loader bitwise equal to the gathered
    npz of the same state, and its per-rank cursors by ``glom_tpu``'s
    ``restore(per_process=...)``;
  * ``glom_tpu``'s save on its faked 8-device ``(2, 4, 1)`` TP mesh (one
    shard file, many tiles) restores in the port's trainer on one rank and
    on 2 ranks ``(1, 2, 1)``, bitwise;
  * mixed tilings and missing tiles are refused with ``glom_tpu``'s
    messages, a save removes the same step's files of another world size and
    backend, and a corrupt shard file is quarantined with a fallback to the
    older step.
"""

import io
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from glom_tpu import checkpoint as jax_ckpt
from glom_tpu.config import GlomConfig as JaxGlomConfig
from glom_tpu.config import TrainConfig as JaxTrainConfig
from glom_tpu.training.trainer import Trainer as JaxTrainer
from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.resilience import integrity
from glom_tpu_torch.training.metrics import MetricLogger
from glom_tpu_torch.training.trainer import Trainer
from tests.torch_mesh_world import run_world

torch.set_num_threads(1)

TINY = dict(dim=16, levels=3, image_size=16, patch_size=4)
BASE = dict(batch_size=4, iters=2, learning_rate=1e-3, checkpoint_backend="sharded")


def _jax_save(directory: str):
    """glom_tpu's Trainer on its faked (2, 4, 1) TP mesh, two steps, saved
    sharded with a cursor; returns its flat arrays as its loader reads them."""
    tr = JaxTrainer(JaxGlomConfig(**TINY), JaxTrainConfig(
        batch_size=8, iters=2, learning_rate=1e-3, donate=False, mesh_shape=(2, 4, 1),
        param_sharding="tp", checkpoint_backend="sharded"))
    img = np.random.default_rng(0).standard_normal((8, 3, 16, 16)).astype(np.float32)
    for _ in range(2):
        tr.state, _ = tr._step(tr.state, jax.device_put(img, tr._batch_sh))
    path = tr.save(directory, data_state={"consumed": 16, "seed": 0})
    assert path.endswith("ckpt_2.shard0of1.npz")
    return jax_ckpt._load_arrays(directory, 2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_world")
    rng = np.random.default_rng(3)
    np.savez(root / "batches.npz",
             imgs=rng.standard_normal((2, 4, 3, 16, 16)).astype(np.float32),
             noise=rng.standard_normal((2, 4, 3, 16, 16)).astype(np.float32))
    jax_arrays = _jax_save(str(root / "jax"))
    jobs = [{"kind": "sharded", "name": "tp_save", "mesh": [1, 2, 1], "config": TINY,
             "train": dict(BASE, param_sharding="tp"), "imgs": str(root / "batches.npz"),
             "ckpt": str(root / "ours"), "gathered": str(root / "gathered")},
            {"kind": "sharded", "name": "tp_restore", "mesh": [1, 2, 1], "config": TINY,
             "train": dict(BASE, param_sharding="tp"), "restore": str(root / "jax")}]
    return root, jax_arrays, run_world(str(root / "world"), 2, jobs)


def _unflat(flat: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in flat.items() if k.startswith(prefix + "/")}


def test_a_two_rank_tp_save_is_glom_tpus_to_read(world):
    root, _, results = world
    ranks = results["tp_save"]
    assert str(ranks[0]["path"]).endswith("ckpt_2.shard0of2.npz") and str(ranks[1]["path"]) == ""
    assert ranks[0]["local_w1"].tolist() == [3, 16, 32]      # h=64 split over model
    names = sorted(os.listdir(root / "ours"))
    assert [n for n in names if n.startswith("ckpt_")] == ["ckpt_2.shard0of2.npz",
                                                          "ckpt_2.shard1of2.npz"]
    with open(root / "ours" / "manifest.json") as f:
        assert json.load(f)["shard_count"] == 2
    theirs = jax_ckpt._load_arrays(str(root / "ours"), 2)
    with np.load(root / "gathered" / "ckpt_2.npz") as z:
        gathered = dict(z)
    # every leaf of the gathered state, bitwise; the cursor once a rank
    assert set(theirs) == (set(gathered) - {"data/consumed", "data/seed"}) | {
        f"data@p{r}/{k}" for r in (0, 1) for k in ("consumed", "seed")}
    for k, v in gathered.items():
        if not k.startswith("data/"):
            assert theirs[k].dtype == v.dtype and np.array_equal(theirs[k], v), k
    for r in (0, 1):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "process_index", lambda r=r: r)    # glom_tpu's process r
            _, d = jax_ckpt.restore(str(root / "ours"), {"data": {"consumed": 0, "seed": 0}},
                                    per_process=("data",))
        assert {k: int(v) for k, v in d["data"].items()} == {"consumed": 16, "seed": 3}
    # glom_tpu's trainer resumes it on its own mesh
    tr = JaxTrainer(JaxGlomConfig(**TINY), JaxTrainConfig(
        batch_size=8, iters=2, learning_rate=1e-3, mesh_shape=(2, 4, 1), param_sharding="tp"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert tr.restore(str(root / "ours")) == 2
    w1 = np.asarray(jax.device_get(tr.state.params["glom"]["bottom_up"]["w1"]))
    assert np.array_equal(w1, gathered["params/glom/bottom_up/w1"])


def _port_trainer(directory=None, **tc):
    return Trainer(GlomConfig(**TINY), TrainConfig(**{**BASE, **tc}), device="cpu",
                   logger=MetricLogger(stream=io.StringIO()))


def _assert_state_is(state: dict, arrays: dict):
    """A port state (params, mu, nu; flat) against glom_tpu's flat arrays
    (``params/...``, ``opt/0/mu/...``, ``opt/0/nu/...``), bitwise."""
    want = {"params": _unflat(arrays, "params"), "mu": _unflat(arrays, "opt/0/mu"),
            "nu": _unflat(arrays, "opt/0/nu")}
    for name, flat in want.items():
        got = ckpt_lib.flatten({"x": state[name]})
        assert sorted(k[2:] for k in got) == sorted(flat), name
        for k, v in flat.items():
            assert np.array_equal(np.asarray(got["x/" + k]), v), (name, k)


def test_glom_tpus_faked_mesh_save_restores_on_one_and_two_ranks(world, tmp_path):
    root, jax_arrays, results = world
    # one rank, in this process
    tr = _port_trainer()
    with pytest.warns(UserWarning, match="glom_tpu's"):
        assert tr.restore(str(root / "jax")) == 2
    st = tr.state
    _assert_state_is({"params": st.params, "mu": st.opt_state["mu"], "nu": st.opt_state["nu"]},
                     jax_arrays)
    assert st.opt_state["count"] == int(jax_arrays["opt/0/count"]) == 2
    # two ranks, each holding its TP slice of the reassembled state
    for r in results["tp_restore"]:
        assert int(r["restored_step"]) == 2
        assert r["local_w1"].tolist() == [3, 16, 32]
        state = {name: _unflat(dict(r), f"state/{name}") for name in ("params", "mu", "nu")}
        nest = {name: ckpt_lib.unflatten(flat) for name, flat in state.items()}
        _assert_state_is(nest, jax_arrays)


def _both_refuse(paths, match):
    with pytest.raises(ValueError, match=match) as ours:
        ckpt_lib._load_sharded_arrays(paths)
    with pytest.raises(ValueError, match=match) as theirs:
        jax_ckpt._load_sharded_arrays(paths)
    assert str(ours.value) == str(theirs.value)


def test_mixed_tilings_and_missing_tiles_are_refused_as_glom_tpu_does(tmp_path):
    w = np.arange(8, dtype=np.float32).reshape(2, 4)
    left = {"params": {"w": ckpt_lib.Tile(w[:, :2], (2, 4), (0, 0))}}
    right = {"params": {"w": ckpt_lib.Tile(w[:, 2:], (2, 4), (0, 2))}}
    mixed, lone, whole = (str(tmp_path / n) for n in ("mixed", "lone", "whole"))
    # rank 1 of a world of 2 beside rank 0 of a world of 1 (a crashed run's)
    ckpt_lib.save_sharded(mixed, 1, right, rank=1, world=2)
    ckpt_lib.save_sharded(lone, 1, left)
    os.replace(os.path.join(lone, "ckpt_1.shard0of1.npz"),
               os.path.join(mixed, "ckpt_1.shard0of1.npz"))
    _both_refuse(ckpt_lib.shard_paths(mixed, 1), "inconsistent shard set")
    ckpt_lib.save_sharded(mixed, 2, right, rank=1, world=2)     # rank 0's never written
    _both_refuse(ckpt_lib.shard_paths(mixed, 2), "inconsistent shard set")
    ckpt_lib.save_sharded(lone, 3, left)                        # half of w's tiles
    _both_refuse(ckpt_lib.shard_paths(lone, 3), "missing tiles of 'params/w'")
    for rank, tiles in ((1, right), (0, left)):
        ckpt_lib.save_sharded(whole, 4, tiles, rank=rank, world=2)
    assert np.array_equal(ckpt_lib.load_arrays(whole, 4)["params/w"], w)
    assert np.array_equal(jax_ckpt._load_arrays(whole, 4)["params/w"], w)


def test_a_save_removes_the_steps_files_of_another_world_and_backend(tmp_path):
    d = str(tmp_path)
    ckpt_lib.save(d, 3, {"params": {"w": np.ones(2, np.float32)}})
    for rank in (1, 0):
        ckpt_lib.save_sharded(d, 3, {"params": {"w": np.ones(2, np.float32)}}, rank=rank,
                              world=2)
    assert sorted(n for n in os.listdir(d) if n.startswith("ckpt_")) == [
        "ckpt_3.shard0of2.npz", "ckpt_3.shard1of2.npz"]
    ckpt_lib.save_sharded(d, 3, {"params": {"w": np.zeros(2, np.float32)}})
    assert sorted(n for n in os.listdir(d) if n.startswith("ckpt_")) == ["ckpt_3.shard0of1.npz"]
    ckpt_lib.save(d, 3, {"params": {"w": np.ones(2, np.float32)}})
    assert not ckpt_lib.shard_paths(d, 3)
    # pruning counts shard steps as steps
    for step in (4, 5, 6):
        ckpt_lib.save_sharded(d, step, {"params": {"w": np.ones(2, np.float32)}}, keep=2)
    assert sorted({ckpt_lib.step_of(n) for n in os.listdir(d)} - {None}) == [5, 6]


def test_a_corrupt_shard_is_quarantined_and_the_older_step_restores(tmp_path):
    d = str(tmp_path / "ckpt")
    tr = _port_trainer(checkpoint_dir=d, checkpoint_every=1, steps=2, log_every=0)
    rng = np.random.default_rng(0)
    tr.fit(iter([rng.standard_normal((4, 3, 16, 16)).astype(np.float32) for _ in range(2)]))
    assert [os.path.basename(p) for p in ckpt_lib.shard_paths(d, 2)] == ["ckpt_2.shard0of1.npz"]
    step1 = ckpt_lib.load_tree(d, 1, "params")
    (shard,) = ckpt_lib.shard_paths(d, 2)
    with open(shard, "r+b") as f:
        f.truncate(os.path.getsize(shard) // 2)
    # no integrity record: the scan presumes it good, the load finds it torn
    assert integrity.latest_valid_step(d) == 2
    again = _port_trainer(checkpoint_dir=d)
    with pytest.warns(UserWarning, match="quarantined corrupt checkpoint step 2"):
        assert again.restore(d) == 1
    assert os.path.exists(shard + ".corrupt") and not ckpt_lib.shard_paths(d, 2)
    assert np.array_equal(again.state.params["glom"]["bottom_up"]["w1"].numpy(),
                          step1["glom"]["bottom_up"]["w1"])


@pytest.mark.parametrize("rank, keys, want", [
    (1, ("data@p0", "data@p1", "data"), "data@p1"),   # this rank's own copy
    (3, ("data@p0", "data@p1"), "data@p0"),           # a world that lacked rank 3
    (1, ("data",), "data"),                           # an npz step's shared cursor
    (0, ("params",), None)])
def test_a_rank_takes_its_own_cursor_else_rank_0s_else_the_shared_one(rank, keys, want):
    trees = {k: {"consumed": np.asarray(i)} for i, k in enumerate(keys)}
    got = ckpt_lib.per_process_tree(trees, "data", rank)
    assert got is (trees[want] if want else None)


def test_an_async_sharded_save_is_synchronous_with_glom_tpus_warning(tmp_path):
    tr = _port_trainer(async_checkpoint=True)
    with pytest.warns(UserWarning, match="saving synchronously"):
        path = tr.save(str(tmp_path), data_state={"consumed": 4})
    assert path.endswith("ckpt_0.shard0of1.npz") and tr._ckpt_thread is None
    assert ckpt_lib.load_tree(str(tmp_path), 0, "data@p0") == {"consumed": np.asarray(4)}
