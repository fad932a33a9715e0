"""The port's profiling plumbing on the CPU: ``glom_tpu_torch/profiling.py``,
``obs/timing.py``'s ``PhaseTimer`` and the trainer's ``profile_dir`` and
phase-timed loop, against glom_tpu's where the two are comparable
(``tests/test_profiling.py``, ``tests/test_obs.py``).

``cost_analysis`` of a plain forward is held against the analytic count of
``tools/mfu.py`` within 1 %; the phase timers against each other exactly.
"""

import json

import numpy as np
import pytest
import torch

from glom_tpu.obs import MetricRegistry
from glom_tpu.obs.timing import PhaseTimer as JaxPhaseTimer
from glom_tpu_torch import profiling
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.obs.timing import PHASES, PhaseTimer
from glom_tpu_torch.tools.mfu import model_flops_per_image
from glom_tpu_torch.training import train
from glom_tpu_torch.training.data import synthetic_batches
from glom_tpu_torch.training.metrics import MetricLogger
from glom_tpu_torch.training.trainer import Trainer

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)
FLOPS_RTOL = 0.01


def _names(path):
    with open(path) as f:
        return {e.get("name", "") for e in json.load(f)["traceEvents"]}


def test_trace_writes_a_file_holding_the_annotated_names(tmp_path):
    x = torch.randn(8, 8)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("data_wait"):
            y = x + 1
        with profiling.annotate("step"):
            (y @ y).sum()
    (path,) = profiling.trace_files(str(tmp_path))
    names = _names(path)
    assert {"data_wait", "step"} <= names and "aten::mm" in names


@pytest.mark.parametrize("t", [1, 3])
def test_cost_analysis_of_a_plain_forward_is_the_analytic_count(t):
    """FlopCounterMode over a tiny plain forward of t iterations counts the
    patch embedding, the four FF products and the two consensus products of
    each iteration: model_flops_per_image x b (tools/mfu.py)."""
    c, b = GlomConfig(**TINY), 2
    params = glom_model.init(torch.Generator().manual_seed(0), c)
    img = torch.randn(b, 3, 16, 16)
    with torch.no_grad():
        got = profiling.cost_analysis(
            lambda p, x: glom_model.apply(p, x, config=c, iters=t), params, img)["flops"]
    want = b * model_flops_per_image(c, t)
    n, d, h, L = c.num_patches, c.dim, c.dim * c.ff_mult, c.levels
    parts = {"patch": 2 * n * c.patch_dim * d * b, "ff": t * 2 * n * (2 * L - 1) * 2 * d * h * b,
             "consensus": t * 2 * L * 2 * n * n * d * b}
    assert abs(got - want) <= FLOPS_RTOL * want, (
        f"FlopCounterMode {got:.0f} against the analytic {want:.0f} "
        f"({(got - want) / want:+.2%}); analytic parts {parts}")


def test_cost_analysis_counts_the_backward_and_remats_recompute():
    """A train step counts the backward's products (3x the forward's, as
    tools/mfu.py's convention); "full" remat adds the recomputed forward's,
    "dots" keeps the products and adds none."""
    from glom_tpu_torch.training import denoise
    from glom_tpu_torch.training.optim import Optimizer

    flops = {}
    for name, kw in (("none", {}), ("dots", dict(remat=True, remat_policy="dots")),
                     ("full", dict(remat=True, remat_policy="full"))):
        c = GlomConfig(**TINY, **kw)
        tc = TrainConfig(batch_size=2, iters=4)
        opt = Optimizer.from_config(tc)
        state = denoise.init_state(torch.Generator().manual_seed(0), c, opt)
        step = denoise.make_step_fn(c, tc, opt)
        flops[name] = profiling.cost_analysis(step, state, torch.randn(2, 3, 16, 16))["flops"]
    model = 3 * 2 * model_flops_per_image(GlomConfig(**TINY), 3)
    assert flops["none"] == flops["dots"]
    assert abs(flops["none"] - model) <= 0.02 * model      # + the decoder's product
    assert flops["full"] > flops["dots"] + 0.9 * model / 3


def test_memory_analysis_degrades_on_the_cpu():
    calls = []
    with pytest.warns(UserWarning, match="no argument is on a CUDA device"):
        out = profiling.memory_analysis(lambda x: calls.append(x), torch.ones(2))
    assert out == {} and calls == []


def test_device_memory_profile_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        profiling.device_memory_profile(str(tmp_path / "snap.pickle"))


def test_debug_nans_toggle():
    x = torch.tensor(-1.0, requires_grad=True)
    profiling.debug_nans(True)
    try:
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).backward()
    finally:
        profiling.debug_nans(False)
    assert not torch.is_anomaly_enabled()
    x.grad = None
    torch.sqrt(x).backward()
    assert torch.isnan(x.grad)


class _Tracer:
    """A duck-typed tracer: start_trace / record / end."""

    def __init__(self):
        self.events = []

    def start_trace(self, name, attrs=None):
        self.events.append(("start", name, dict(attrs or {})))
        return len(self.events)

    def record(self, name, parent, t0, t1, observe=True):
        self.events.append(("record", name, parent, t1 - t0))

    def end(self, span, attrs=None):
        self.events.append(("end", span, dict(attrs or {})))


def _drive(timer_cls, t, registry, tracer):
    """One fixed script of phases on a fake clock: two windows and a close."""
    pt = timer_cls(clock=lambda: t[0], registry=registry, tracer=tracer)
    windows = []
    for _ in range(2):
        with pt.phase("data_wait"):
            t[0] += 0.25
        with pt.phase("h2d"):
            t[0] += 0.125
        with pt.phase("step"):
            t[0] += 1.0
        pt.count_step()
    pt.add("log_emit", 0.05)
    windows.append(pt.window())
    with pt.phase("step"):
        t[0] += 0.5
    pt.count_step()
    windows.append(pt.window())
    with pytest.raises(RuntimeError, match="must not nest"):
        with pt.phase("step"):
            with pt.phase("h2d"):
                pass
    pt.close()
    return windows


def test_phase_timer_gives_glom_tpus_windows_on_a_fake_clock():
    runs = []
    for cls in (JaxPhaseTimer, PhaseTimer):
        reg, tracer = MetricRegistry(), _Tracer()
        windows = _drive(cls, [100.0], reg, tracer)
        runs.append((windows, reg.histogram("phase_step").mean, reg.histogram("step_time").count,
                     tracer.events))
    assert runs[1] == runs[0]
    windows = runs[1][0]
    assert windows[0]["t_data_wait"] == pytest.approx(0.5)
    assert windows[0]["t_window"] == pytest.approx(2.75) and windows[0]["window_steps"] == 2
    assert windows[1] == {"t_step": 0.5, "t_window": 0.5, "window_steps": 1}
    assert PHASES[:3] == ("data_wait", "h2d", "step")


def _trainer(tmp_path, **kw):
    tc = TrainConfig(batch_size=2, iters=4, log_every=2, seed=0, **kw)
    return Trainer(GlomConfig(**TINY), tc, device="cpu",
                   logger=MetricLogger(path=str(tmp_path / "log.jsonl")))


def test_trainer_fit_with_profile_dir_writes_a_trace_of_the_step_phase(tmp_path):
    """glom_tpu's window: steps start+2 .. start+4 of the run, with the
    loop's phase names."""
    prof = tmp_path / "prof"
    trainer = _trainer(tmp_path, profile_dir=str(prof))
    steps = []
    real = trainer._step

    def counted(state, x, **kw):
        steps.append(torch.autograd._profiler_enabled())
        return real(state, x, **kw)

    trainer._step = counted
    trainer.fit(synthetic_batches(2, 16), steps=6)
    assert steps == [False, False, True, True, True, False]
    (path,) = profiling.trace_files(str(prof))
    names = _names(path)
    assert {"data_wait", "h2d", "step", "log_sync"} <= names


def test_trainer_trace_closes_when_the_run_ends_inside_its_window(tmp_path):
    trainer = _trainer(tmp_path, profile_dir=str(tmp_path / "prof"))
    trainer.fit(synthetic_batches(2, 16), steps=3)
    (path,) = profiling.trace_files(str(tmp_path / "prof"))
    assert "step" in _names(path)
    assert not torch.autograd._profiler_enabled()


def test_trainer_records_carry_the_loops_phase_times(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.fit(synthetic_batches(2, 16), steps=4)
    with open(tmp_path / "log.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [2, 4]
    for r in recs:
        for k in ("t_data_wait", "t_h2d", "t_step", "t_log_sync", "t_window"):
            assert r[k] >= 0, k
        assert r["window_steps"] == 2
        assert r["t_data_wait"] + r["t_h2d"] + r["t_step"] + r["t_log_sync"] <= r["t_window"]
        # glom_tpu's rate: the window's train time, its exporter writes
        # (t_log_emit, from the second window on) left out
        assert np.isclose(r["imgs_per_sec"], 4 / (r["t_window"] - r.get("t_log_emit", 0.0)))


def test_train_cli_takes_profile_dir(tmp_path):
    prof = tmp_path / "prof"
    train.main(["--dim", "32", "--levels", "3", "--image-size", "16", "--patch-size", "4",
                "--batch-size", "2", "--steps", "5", "--log-every", "5", "--device", "cpu",
                "--profile-dir", str(prof)])
    (path,) = profiling.trace_files(str(prof))
    assert "step" in _names(path)
