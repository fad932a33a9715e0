"""The port's self-healing supervisor (glom_tpu_torch.resilience.supervisor)
against glom_tpu's, and ``--supervise`` on the CPU.

Under the same injected clock, sleep, jitter seed and failure script, both
supervisors make the same decisions: the same backoffs, the same restarts
and give-up, the same counters and bundle names.  Then the training CLI
under ``--supervise`` with a ``data:crash`` fault restarts once and ends on
the parameters, bit for bit, of an unfailed run of the same steps (the
synthetic stream is not resumable, in either package: a resumed run draws
it from its start, so the unfailed run is one stopped at the last
checkpoint before the crash and resumed from it).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from glom_tpu.obs import ForensicsManager as JaxForensicsManager
from glom_tpu.obs import MetricRegistry as JaxRegistry
from glom_tpu.resilience import supervisor as jax_supervisor
from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch.obs import MetricRegistry
from glom_tpu_torch.obs.forensics import ForensicsManager
from glom_tpu_torch.resilience import faultinject, supervisor
from glom_tpu_torch.training import train

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)


class NonFiniteError(RuntimeError):
    """Named as the trainers' error: the supervisors match it by name."""


def _script():
    """fit attempts: four failures of each class, then a success."""
    return [supervisor.PreemptionError("host reclaimed"), OSError("nfs hiccup"),
            NonFiniteError("nan at step 9"), ValueError("bug"), "done"]


def _run(mod, registry, forensics, script, policy_kw, clock_steps):
    attempts = iter(script)
    t = {"now": 0.0}
    sleeps = []

    def fit_fn():
        t["now"] += clock_steps
        outcome = next(attempts)
        if isinstance(outcome, BaseException):
            # the reference's PreemptionError is its own class
            if isinstance(outcome, supervisor.PreemptionError):
                outcome = mod.PreemptionError(str(outcome))
            raise outcome
        return outcome

    def sleep(s):
        sleeps.append(s)
        t["now"] += s

    sup = mod.Supervisor(fit_fn, policy=mod.RestartPolicy(**policy_kw), registry=registry,
                         forensics=forensics, clock=lambda: t["now"], sleep=sleep, seed=7)
    try:
        result = sup.run()
    except mod.GiveUp as e:
        result = ("giveup", type(e.__cause__).__name__)
    return result, sleeps, sup.restarts, registry.snapshot()


@pytest.mark.parametrize("policy_kw,clock_steps", [
    ({"max_failures": 5, "window_s": 600.0}, 1.0),           # restarts through to done
    ({"max_failures": 3, "window_s": 600.0}, 1.0),           # the crash loop gives up
    ({"max_failures": 2, "window_s": 5.0, "backoff_base_s": 4.0}, 3.0),  # the window slides
], ids=["restarts", "gives_up", "window_slides"])
def test_supervisor_decides_as_glom_tpus(tmp_path, policy_kw, clock_steps):
    fake = {"c": 100.0}

    def clock():
        fake["c"] += 1.0
        return fake["c"]

    runs = []
    for mod, reg_cls, fm_cls, root in (
            (supervisor, MetricRegistry, ForensicsManager, tmp_path / "ours"),
            (jax_supervisor, JaxRegistry, JaxForensicsManager, tmp_path / "theirs")):
        fake["c"] = 100.0
        registry = reg_cls()
        fm = fm_cls(str(root), registry=registry, clock=clock)
        runs.append(_run(mod, registry, fm, _script(), policy_kw, clock_steps)
                    + (sorted(os.listdir(root)),))
    (res, sleeps, restarts, snap, bundles), (res2, sleeps2, restarts2, snap2, bundles2) = runs
    assert res == res2 and restarts == restarts2 and bundles == bundles2
    assert sleeps == pytest.approx(sleeps2, rel=0, abs=0)
    assert snap == snap2
    assert all(b.startswith("crash_restart-") for b in bundles)
    for name in bundles:
        with open(tmp_path / "ours" / name / "manifest.json") as f:
            ours = json.load(f)
        with open(tmp_path / "theirs" / name / "manifest.json") as f:
            theirs = json.load(f)
        for m in (ours, theirs):
            m["detail"].pop("traceback")
        assert ours == theirs


def test_classify_failure_is_glom_tpus_and_names_sticky_cuda_errors():
    for exc in (supervisor.PreemptionError("x"), NonFiniteError("x"), OSError("x"),
                faultinject.FaultError("x"), ValueError("x")):
        mine = supervisor.classify_failure(exc)
        if isinstance(exc, supervisor.PreemptionError):
            exc = jax_supervisor.PreemptionError("x")
        assert mine == jax_supervisor.classify_failure(exc)
    for msg in ("CUDA error: an illegal memory access was encountered",
                "grouped_ff kernel failed to launch: CUDA error 700 (an illegal memory access "
                "was encountered)", "CUDA error: device-side assert triggered",
                "CUDA error: unspecified launch failure"):
        assert supervisor.classify_failure(RuntimeError(msg)) == supervisor.REASON_CUDA_FATAL
    assert supervisor.classify_failure(RuntimeError("CUDA out of memory")) == "crash"


def test_a_sticky_cuda_error_gives_up_at_once(tmp_path):
    """A restart inside a process whose CUDA context is poisoned cannot
    succeed: no backoff, no second attempt, the cause named."""
    calls, sleeps = [], []

    def fit_fn():
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    registry = MetricRegistry()
    fm = ForensicsManager(str(tmp_path), registry=registry)
    sup = supervisor.Supervisor(fit_fn, registry=registry, forensics=fm, sleep=sleeps.append)
    with pytest.raises(supervisor.GiveUp, match="sticky CUDA error"):
        sup.run()
    assert calls == [1] and sleeps == [] and sup.restarts == 0
    assert registry.snapshot()["supervisor_giveups"] == 1.0
    (bundle,) = os.listdir(tmp_path)
    with open(tmp_path / bundle / "manifest.json") as f:
        detail = json.load(f)["detail"]
    assert (detail["reason"], detail["outcome"]) == ("cuda_fatal", "giveup")


ARGV = ["--dim", "32", "--levels", "3", "--image-size", "16", "--patch-size", "4",
        "--batch-size", "2", "--log-every", "1", "--device", "cpu", "--ff-impl", "pallas",
        "--fused-ff-bwd", "--attention-impl", "pallas", "--checkpoint-every", "2"]


def _final_params(directory):
    step = ckpt_lib.latest_step(directory)
    arrays = ckpt_lib.load_arrays(directory, step)
    return step, {k: v for k, v in arrays.items() if k.startswith("params")}


def test_supervised_cli_resumes_to_an_unfailed_runs_parameters(tmp_path, capsys):
    sup_dir, ref_dir, fdir = (str(tmp_path / n) for n in ("sup", "ref", "forensics"))
    with faultinject.injected("data:crash@3"):
        train.main(ARGV + ["--steps", "5", "--supervise", "--checkpoint-dir", sup_dir,
                           "--forensics-dir", fdir])
    # the unfailed run of the same steps: to the last checkpoint before the
    # crash, then a fresh process's resume from it
    train.main(ARGV + ["--steps", "2", "--checkpoint-dir", ref_dir])
    train.main(ARGV + ["--steps", "5", "--checkpoint-dir", ref_dir])
    capsys.readouterr()
    (s1, got), (s2, want) = _final_params(sup_dir), _final_params(ref_dir)
    assert s1 == s2 == 5 and sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    (restart,) = glob.glob(os.path.join(fdir, "crash_restart-*"))
    with open(os.path.join(restart, "metrics.json")) as f:
        metrics = json.load(f)
    assert metrics["supervisor_restarts"] == 1.0
    assert metrics["supervisor_restarts_io_error"] == 1.0
    # the failed attempt's trainer wrote its own crash bundle at step 2
    assert glob.glob(os.path.join(fdir, "crash-2"))
