"""The port's trainer with its observability and robustness fields
(glom_tpu_torch.training.trainer) against glom_tpu's, on the CPU.

With every field on, the two trainers log records with the same keys in the
same order (the times are the clocks', not compared), the same CSV columns
and the same phase spans in ``train_trace.json``.  The async save is bitwise
the synchronous one, and ``finish_saves`` re-raises a write that the
``ckpt_write`` fault seam tore.  Each trigger writes its bundle under
``glom_tpu``'s trigger name, with the bundle's files.  Only the mesh fields
and flags are still refused.
"""

import csv
import io
import json
import os

import numpy as np
import pytest
import torch

from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.kernels import _build
from glom_tpu_torch.obs import MetricRegistry
from glom_tpu_torch.obs import triggers as port_triggers
from glom_tpu_torch.resilience import faultinject
from glom_tpu_torch.training import train, trainer as trainer_mod
from glom_tpu_torch.training.data import synthetic_batches
from glom_tpu_torch.training.metrics import MetricLogger
from glom_tpu_torch.training.trainer import Trainer

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)
KERNELS = dict(ff_impl="pallas", attention_impl="pallas", ff_fused_bwd=True)


def _obs_fields(d, **kw):
    fields = dict(metrics_csv=str(d / "m.csv"), prom_textfile=str(d / "m.prom"),
                  trace_dir=str(d / "trace"), diag_every=2, forensics_dir=str(d / "f"),
                  checkpoint_dir=str(d / "ck"), checkpoint_every=2, async_checkpoint=True)
    fields.update(kw)
    return fields


def _trainer(train_cfg, logger=None, **cfg):
    return Trainer(GlomConfig(**TINY, **{**KERNELS, **cfg}), train_cfg, device="cpu",
                   logger=logger or MetricLogger(stream=io.StringIO()))


def _records(logger_stream):
    return [json.loads(line) for line in logger_stream.getvalue().splitlines()]


def _span_names(path):
    with open(path) as f:
        return sorted({e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"})


def test_records_csv_and_spans_equal_glom_tpus(tmp_path):
    """Both trainers, every field on: the record keys (in order), the CSV
    columns and the span names of the phase trace are the same."""
    from glom_tpu.config import GlomConfig as JaxGlomConfig
    from glom_tpu.config import TrainConfig as JaxTrainConfig
    from glom_tpu.training.metrics import MetricLogger as JaxLogger
    from glom_tpu.training.trainer import Trainer as JaxTrainer

    # glom_tpu's trainer runs over the tests' 8 faked CPU devices: a batch of 8
    common = dict(batch_size=8, steps=4, log_every=2, seed=0)
    out = {}
    for side in ("ours", "theirs"):
        d = tmp_path / side
        d.mkdir()
        stream = io.StringIO()
        if side == "ours":
            t = Trainer(GlomConfig(**TINY), TrainConfig(**common, **_obs_fields(d)),
                        device="cpu", logger=MetricLogger(stream=stream))
        else:
            t = JaxTrainer(JaxGlomConfig(**TINY), JaxTrainConfig(**common, **_obs_fields(d)),
                           logger=JaxLogger(stream=stream))
        t.fit(synthetic_batches(8, 16, 3, seed=0))
        with open(d / "m.csv") as f:
            columns = next(csv.reader(f))
        out[side] = ([list(r) for r in _records(stream)], columns,
                     _span_names(d / "trace" / "train_trace.json"),
                     ckpt_lib.latest_step(str(d / "ck")))
    for a, b in zip(out["ours"], out["theirs"]):
        assert a == b
    keys, columns, spans, step = out["ours"]
    assert step == 4 and "t_diag" in keys[-1] and "t_checkpoint" in keys[-1]
    assert {"data_wait", "h2d", "step", "log_sync", "diag", "checkpoint",
            "train_window"} <= set(spans)
    with open(tmp_path / "ours" / "m.prom") as f:
        assert "glom_steps_total 4" in f.read()


def test_a_callers_logger_registry_is_adopted(tmp_path):
    registry = MetricRegistry()
    logger = MetricLogger(stream=io.StringIO(), registry=registry)
    t = _trainer(TrainConfig(batch_size=2, steps=2, log_every=1), logger=logger)
    assert t.registry is registry
    t.fit(synthetic_batches(2, 16, 3, seed=1))
    assert registry.snapshot()["steps_total"] == 2.0


def _npz(directory, step):
    return ckpt_lib.load_arrays(directory, step)


def test_the_async_save_is_bitwise_the_sync_save(tmp_path):
    saved = {}
    for mode in (False, True):
        d = str(tmp_path / f"async_{mode}")
        t = _trainer(TrainConfig(batch_size=2, steps=3, log_every=0, checkpoint_dir=d,
                                 checkpoint_every=3, async_checkpoint=mode))
        t.fit(synthetic_batches(2, 16, 3, seed=2))
        assert t._ckpt_thread is None  # fit drained the writer
        saved[mode] = _npz(d, 3)
        # a save names its artifact at once; finish_saves makes it durable
        path = t.save(d)
        assert path == ckpt_lib.npz_path(d, 3)
        t.finish_saves()
    assert sorted(saved[True]) == sorted(saved[False])
    for k in saved[False]:
        np.testing.assert_array_equal(saved[True][k], saved[False][k], err_msg=k)


def test_finish_saves_reraises_a_write_the_fault_seam_tore(tmp_path):
    d = str(tmp_path / "ck")
    t = _trainer(TrainConfig(batch_size=2, steps=2, log_every=0, checkpoint_dir=d,
                             checkpoint_every=2, async_checkpoint=True))
    with faultinject.injected("ckpt_write:torn@2"):
        with pytest.raises(ckpt_lib.CorruptCheckpointError, match="step 2"):
            t.fit(synthetic_batches(2, 16, 3, seed=3))
    assert t._ckpt_thread is None
    # the next write of the same trainer is clean again
    t.save(d)
    t.finish_saves()


# -- the triggers --------------------------------------------------------------

def _stream(hook):
    """The synthetic stream, ``hook(i, batch)`` applied to batch ``i``
    (1-based) as it is drawn."""
    def gen():
        for i, batch in enumerate(synthetic_batches(2, 16, 3, seed=5), 1):
            yield hook(i, batch)
    return gen()


def _bundles(root):
    return sorted(n for n in os.listdir(root) if not n.startswith(".")
                  and os.path.isdir(os.path.join(root, n)))


def _scaled(i, batch):
    return batch * 1e3 if i == 5 else batch


def _slow(i, batch):
    import time

    if 9 <= i <= 12:
        time.sleep(0.4)
    return batch


def _rebuild(i, batch):
    if i == 3:
        _build._events["loads"] += 1   # a kernel library loaded mid-run
    return batch


def _crash(i, batch):
    if i == 3:
        raise ValueError("a data worker died")
    return batch


@pytest.mark.parametrize("trigger,spec,hook,steps,want", [
    ("nan", "data:nan_batch@2", None, 3, "nan-2"),
    ("grad_spike", None, _scaled, 6, "grad_spike-5"),
    ("step_time", None, _slow, 12, "step_time_regression-12"),
    ("recompile", None, _rebuild, 4, "recompile-3"),
    ("crash", None, _crash, 4, "crash-2"),
    ("preempt", None, None, 4, "preempt-2"),
    ("ckpt_corrupt", None, None, 4, "ckpt_corrupt-4"),
])
def test_each_trigger_writes_its_bundle(tmp_path, trigger, spec, hook, steps, want):
    from glom_tpu.obs import triggers as jax_triggers

    # the trigger names are glom_tpu's
    assert {k: v for k, v in vars(port_triggers).items() if k.startswith("TRIGGER_")} == {
        k: v for k, v in vars(jax_triggers).items() if k.startswith("TRIGGER_")}
    root = tmp_path / "f"
    ck = str(tmp_path / "ck")
    cfg = TrainConfig(batch_size=2, steps=steps, log_every=1, forensics_dir=str(root),
                      checkpoint_dir=ck, checkpoint_every=2)
    if trigger == "ckpt_corrupt":
        # step 4's artifact flipped at its write; a new trainer's resume
        # quarantines it and falls back to step 2
        with faultinject.injected("ckpt_write:bitflip@4"):
            _trainer(TrainConfig(batch_size=2, steps=4, log_every=0, checkpoint_dir=ck,
                                 checkpoint_every=2)).fit(synthetic_batches(2, 16, 3))
    t = _trainer(cfg)
    batches = _stream(hook or (lambda i, b: b))
    if trigger == "preempt":
        batches = _stream(lambda i, b: (t._request_stop(None, None), b)[1] if i == 2 else b)
    if trigger == "crash":
        with pytest.raises(ValueError, match="data worker"):
            t.fit(batches)
    elif spec is not None:
        with faultinject.injected(spec):
            t.fit(faultinject_stream(batches))
    else:
        t.fit(batches)
    bundles = _bundles(root)
    assert want in bundles, bundles
    bundle = root / want
    with open(bundle / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["trigger"] == want.rsplit("-", 1)[0]
    files = set(os.listdir(bundle))
    assert {"env.json", "config.json", "flight_recorder.jsonl", "metrics.json",
            "manifest.json"} <= files
    if trigger not in ("preempt", "ckpt_corrupt"):
        # the step snapshot: launches (none on the CPU), cost and memory
        # (none for a stop's bundle, as in glom_tpu, nor before a first step)
        assert {"kernels.json", "cost_analysis.json", "memory_analysis.json"} <= files
        with open(bundle / "cost_analysis.json") as f:
            assert json.load(f)["flops"] > 0
    if trigger == "crash":
        assert "ValueError: a data worker died" in manifest["detail"]["traceback"]
    if trigger == "ckpt_corrupt":
        assert manifest["detail"]["reason"] == "file CRC mismatch"


def faultinject_stream(it):
    from glom_tpu_torch.training.data import fault_injected

    return fault_injected(it)


def test_a_triggered_trace_covers_its_steps(tmp_path):
    root = tmp_path / "f"
    t = _trainer(TrainConfig(batch_size=2, steps=8, log_every=1, forensics_dir=str(root),
                             forensics_trace_steps=2))
    t.fit(_stream(_scaled))
    with open(root / "grad_spike-5" / "manifest.json") as f:
        manifest = json.load(f)
    assert (manifest["trace"], manifest["trace_state"]) == ("trace/", "complete")
    with open(root / "grad_spike-5" / "trace" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "step" in names


def test_only_the_mesh_fields_and_flags_are_refused():
    assert not hasattr(trainer_mod, "UNSUPPORTED")      # every TrainConfig field is taken
    with pytest.raises(NotImplementedError, match="orbax backend adapts the JAX ecosystem"):
        trainer_mod.check_supported(TrainConfig(checkpoint_backend="orbax"))
    assert set(trainer_mod.REASONS) == {"mesh", "device", "orbax"}
    assert "item 6b-rest, part 3" in trainer_mod.REASONS["mesh"]
    assert set(train._REFUSED) == {"--platform"}
    assert {why for _, why in train._REFUSED.values()} == {"device"}
    args = train.parse_args([
        "--async-checkpoint", "--trace-dir", "t", "--metrics-csv", "m", "--prom-textfile", "p",
        "--diag-every", "3", "--no-monitor-numerics", "--grad-spike-factor", "4",
        "--supervise", "--max-restart-failures", "2", "--restart-window-s", "9",
        "--forensics-dir", "f", "--forensics-ring", "8", "--forensics-max-captures", "1",
        "--forensics-debounce-steps", "5", "--forensics-trace-steps", "2",
        "--no-forensics-hlo", "--forensics-step-time-factor", "3"])
    assert (args.supervise, args.diag_every, args.forensics_trace_steps,
            args.no_forensics_hlo) == (True, 3, 2, True)
