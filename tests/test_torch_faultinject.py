"""The port's fault injection (glom_tpu_torch/resilience/faultinject.py) and
its seams against glom_tpu's on the CPU.

The spec grammar's cases mirror tests/test_resilience.py; the same spec and
seed fire the same ``(site, step, kind)`` sequence and draw the same
``uniform`` values in both packages; and each seam does what glom_tpu's does
on the same plan: ``data`` (``make_batches``' wrap), ``ckpt_write`` (a torn
or flipped save both loaders skip), ``reload`` (the watcher's retries) and a
``nan_batch`` that halts both trainers at the same step.
"""

import os
import re
import warnings

import numpy as np
import pytest
import torch

from glom_tpu import checkpoint as jax_ckpt
from glom_tpu.resilience import faultinject as jax_faultinject
from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.resilience import faultinject, integrity

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)


def test_parse_spec_forms_as_glom_tpu():
    spec = "ckpt_write:torn@step120; data:nan_batch@37; reload:io_error*3; data:delay@5*2"
    ours = [f.spec() for f in faultinject.FaultPlan.parse(spec).faults]
    assert ours == ["ckpt_write:torn@120", "data:nan_batch@37", "reload:io_error*3",
                    "data:delay@5*2"]
    assert ours == [f.spec() for f in jax_faultinject.FaultPlan.parse(spec).faults]
    assert faultinject.KINDS == jax_faultinject.KINDS


@pytest.mark.parametrize("bad", ["nope:torn", "ckpt_write:bogus", "ckpt_write",
                                 "data:nan_batch@x", "candidate_load:delay"])
def test_parse_rejects_as_glom_tpu(bad):
    with pytest.raises(ValueError) as ours:
        faultinject.FaultPlan.parse(bad)
    with pytest.raises(ValueError) as theirs:
        jax_faultinject.FaultPlan.parse(bad)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("seed", [0, 11])
def test_same_spec_and_seed_fire_the_same_sequence(seed):
    """The same spec, seed and site calls: the same (site, step, kind)
    sequence and the same uniform draws in both packages."""
    spec = ("reload:io_error*2; data:nan_batch@3; data:drop_batch@5; candidate:delay@2*2; "
            "ckpt_write:bitflip@4; candidate_load:bitflip")

    def drive(mod):
        plan = mod.FaultPlan.parse(spec, seed=seed)
        out = []
        for i in range(1, 8):
            for site, step in (("reload", None), ("data", i), ("candidate", None),
                               ("ckpt_write", i), ("candidate_load", None)):
                out.append((site, step, plan.fire(site, step=step),
                            plan.uniform(site, 0.0, 1000.0)))
        return out, plan.summary()

    ours, theirs = drive(faultinject), drive(jax_faultinject)
    assert ours == theirs
    kinds = [(s, k) for s, _, k, _ in ours[0] if k is not None]
    assert kinds == [("reload", "io_error"), ("candidate_load", "bitflip"),
                     ("reload", "io_error"), ("candidate", "delay"), ("data", "nan_batch"),
                     ("candidate", "delay"), ("ckpt_write", "bitflip"),
                     ("data", "drop_batch")]


def test_scoped_arming_and_disarm_on_error():
    assert faultinject.fire("data") is None and faultinject.uniform("data", 2.0, 3.0) == 2.0
    with faultinject.injected("data:nan_batch@1"):
        assert faultinject.armed() and faultinject.fire("data", step=1) == "nan_batch"
    assert not faultinject.armed()
    with pytest.raises(RuntimeError):
        with faultinject.injected("data:crash"):
            raise RuntimeError("boom")
    assert not faultinject.armed()


def test_data_seam_wraps_make_batches_as_glom_tpu():
    """nan_batch, drop_batch and crash on the synthetic stream, batch for
    batch as glom_tpu's stream."""
    from glom_tpu.training.data import make_batches as jax_make_batches
    from glom_tpu_torch.training.data import make_batches

    spec = "data:nan_batch@2; data:drop_batch@3; data:crash@6"
    got = {}
    for side, mod, make in (("ours", faultinject, make_batches),
                            ("theirs", jax_faultinject, jax_make_batches)):
        with mod.injected(spec):
            it = make(kind="synthetic", batch_size=2, image_size=8, seed=0, prefetch=0)
            batches = [next(it) for _ in range(3)]          # batches 1, 2, 4
            with pytest.raises(mod.FaultError):
                next(it)                                    # 5, then 6 crashes
                next(it)
        got[side] = batches
    for a, b in zip(got["ours"], got["theirs"]):
        np.testing.assert_array_equal(a, b)
    assert np.isnan(got["ours"][1]).all() and np.isfinite(got["ours"][2]).all()


def test_the_images_stream_keeps_no_wrap():
    """glom_tpu leaves the images stream unwrapped (its cursor must forward
    state_dict); so does the port."""
    from glom_tpu_torch.training import data

    src = open(data.__file__).read()
    block = src[src.index("def make_batches("):]
    assert block.count("fault_injected(") == 1
    assert block.index("fault_injected(") > block.index('elif kind == "images"')


@pytest.mark.parametrize("kind", ["torn", "bitflip"])
def test_a_faulted_save_is_skipped_by_both_loaders(tmp_path, kind):
    from glom_tpu.resilience import integrity as jax_integrity

    d = str(tmp_path)
    tree = {"params": {"w": np.arange(4096, dtype=np.float32)}}
    ckpt_lib.save(d, 1, tree)
    with faultinject.injected(f"ckpt_write:{kind}@2", seed=3):
        ckpt_lib.save(d, 2, {"params": {"w": np.ones(4096, np.float32)}})
    assert ckpt_lib.verify_file_integrity(d, 2) is False
    assert jax_ckpt.verify_file_integrity(d, 2) is False
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert jax_integrity.latest_valid_step(d, quarantine_corrupt=False) == 1
        assert integrity.latest_valid_step(d, quarantine_corrupt=False) == 1
        assert not [f for f in os.listdir(d) if f.endswith(".corrupt")]
        step, trees = integrity.restore_with_fallback(d, ("params",))
    assert step == 1
    np.testing.assert_array_equal(trees["params"]["w"], tree["params"]["w"])


def test_the_same_bitflip_plan_flips_the_same_byte_in_both(tmp_path):
    """The bitflip's offset is the plan's seeded draw: each package's save,
    against its own clean save, inverts the same byte."""
    arrays = {"params": {"w": np.arange(2048, dtype=np.float32)}}
    flipped = {}
    for side, mod, save in (("ours", faultinject, ckpt_lib.save),
                            ("theirs", jax_faultinject, jax_ckpt.save)):
        save(str(tmp_path / side / "clean"), 1, arrays)
        with mod.injected("ckpt_write:bitflip@1", seed=5):
            save(str(tmp_path / side / "flipped"), 1, arrays)
        clean, bad = (np.frombuffer(open(tmp_path / side / kind / "ckpt_1.npz", "rb").read(),
                                    np.uint8) for kind in ("clean", "flipped"))
        (at,) = np.nonzero(clean != bad)[0]
        assert bad[at] == clean[at] ^ 0xFF
        flipped[side] = (int(at), len(clean))
    assert flipped["ours"] == flipped["theirs"]


def test_reload_seam_retries_and_backs_off_as_glom_tpu(tmp_path):
    """reload:io_error*3 against the watcher: three failed attempts with
    the same backoff sleeps, then the next poll loads the newer step."""
    from glom_tpu.serving.engine import ServingEngine as JaxServingEngine
    from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint

    got = {}
    for side, mod in (("ours", faultinject), ("theirs", jax_faultinject)):
        d = str(tmp_path / side)
        make_demo_checkpoint(d, config=GlomConfig(**TINY), seed=0)
        slept = []
        kw = dict(buckets=(1,), reload_poll_s=0, warmup=False, sleep=slept.append)
        eng = (ServingEngine(d, device="cpu", **kw) if side == "ours"
               else JaxServingEngine(d, **kw))
        make_demo_checkpoint(d, config=GlomConfig(**TINY), seed=1, step=3)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with mod.injected("reload:io_error*3"):
                first, streak = eng.check_reload(), eng._reload_failstreak
                second = eng.check_reload()
        got[side] = (first, streak, second, int(eng.step), slept,
                     eng.registry.snapshot()["serving_reload_failures"])
        eng.shutdown(drain=False)
    assert got["ours"] == got["theirs"]
    assert got["ours"][:4] == (False, 1, True, 3) and got["ours"][5] == 3


def test_corrupt_manifest_reads_as_nothing_finalized(tmp_path):
    from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint

    d = str(tmp_path)
    make_demo_checkpoint(d, config=GlomConfig(**TINY), seed=0)
    eng = ServingEngine(d, device="cpu", buckets=(1,), reload_poll_s=0, warmup=False)
    make_demo_checkpoint(d, config=GlomConfig(**TINY), seed=1, step=2)
    with pytest.warns(UserWarning, match="corrupt reload manifest"):
        with faultinject.injected("reload:corrupt_manifest"):
            assert eng.check_reload() is False
    assert eng.check_reload() is True and eng.step == 2
    eng.shutdown(drain=False)


def test_a_nan_batch_halts_both_trainers_at_the_same_step():
    """data:nan_batch@3 on the synthetic stream: both trainers raise
    NonFiniteError (halt_on_nan, a log every step) at the same step."""
    from glom_tpu.config import GlomConfig as JaxGlomConfig
    from glom_tpu.config import TrainConfig as JaxTrainConfig
    from glom_tpu.training.data import make_batches as jax_make_batches
    from glom_tpu.training.trainer import NonFiniteError as JaxNonFiniteError
    from glom_tpu.training.trainer import Trainer as JaxTrainer
    from glom_tpu_torch.config import TrainConfig
    from glom_tpu_torch.training.data import make_batches
    from glom_tpu_torch.training.metrics import MetricLogger
    from glom_tpu_torch.training.trainer import NonFiniteError, Trainer

    import io

    # glom_tpu's trainer runs over the tests' 8 faked CPU devices: a batch of 8
    train = dict(batch_size=8, steps=5, log_every=1, halt_on_nan=True, seed=0)
    halted = {}
    ours = Trainer(GlomConfig(**TINY), TrainConfig(**train), device="cpu",
                   logger=MetricLogger(stream=io.StringIO()))
    theirs = JaxTrainer(JaxGlomConfig(**TINY), JaxTrainConfig(**train))
    for side, trainer, mod, make, err in (
            ("ours", ours, faultinject, make_batches, NonFiniteError),
            ("theirs", theirs, jax_faultinject, jax_make_batches, JaxNonFiniteError)):
        with mod.injected("data:nan_batch@3"):
            with pytest.raises(err) as e:
                trainer.fit(make(kind="synthetic", batch_size=8, image_size=16, seed=0,
                                 prefetch=0))
        halted[side] = int(re.search(r"at step (\d+)", str(e.value)).group(1))
    assert halted["ours"] == halted["theirs"] == 3
