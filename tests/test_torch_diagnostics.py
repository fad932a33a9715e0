"""The port's GLOM diagnostics and runtime monitors (glom_tpu_torch.obs.
diagnostics, glom_tpu_torch.obs.monitors) against glom_tpu's on the CPU.

The same seeded weights (``demo_params``, carried across by ``convert.py``)
and images go through both packages, float32, after the 2·L-iteration
forward: the attention entropy and the four contribution shares within 1e-5
absolute, the island agreement within 1e-4 (a mean of cosines of states
that each package reaches by its own summation order).  The kernel paths'
plain versions (``"pallas"``, ``"fused"``) give the dense path's numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glom_tpu import config as jax_config
from glom_tpu.obs import diagnostics as jax_diag
from glom_tpu.obs import monitors as jax_monitors
from glom_tpu_torch import convert
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.kernels import _build
from glom_tpu_torch.obs import diagnostics, monitors
from glom_tpu_torch.serving.engine import demo_params

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)
SHARE_ATOL = 1e-5
AGREE_ATOL = 1e-4


def _inputs(seed=0, b=2, **kw):
    c = GlomConfig(**TINY, **kw)
    tree = demo_params(c, TrainConfig(), seed=seed)["glom"]
    img = np.random.default_rng(seed + 7).standard_normal(
        (b, 3, 16, 16)).astype(np.float32)
    return c, tree, img


def _both(c, tree, img, **kw):
    ours = diagnostics.glom_diagnostics(convert.params_from_numpy(tree, c, "cpu"), img,
                                        config=c, iters=2 * c.levels)
    jc = jax_config.GlomConfig(**{k: v for k, v in c.to_json_dict().items()
                                  if k in ("dim", "levels", "image_size", "patch_size",
                                           "consensus_self", "local_consensus_radius")})
    theirs = jax_diag.glom_diagnostics(jax.tree_util.tree_map(jnp.asarray, tree), img,
                                       config=jc, iters=2 * c.levels)
    return ours, theirs


@pytest.mark.parametrize("kw", [{}, {"consensus_self": True},
                                {"local_consensus_radius": 1}],
                         ids=["soft_self_mask", "consensus_self", "radius_1"])
def test_diagnostics_match_glom_tpu(kw):
    c, tree, img = _inputs(**kw)
    ours, theirs = _both(c, tree, img)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        tol = AGREE_ATOL if k.startswith("island_agreement") else SHARE_ATOL
        assert abs(ours[k] - theirs[k]) <= tol, (k, ours[k], theirs[k])
    shares = [ours[f"contrib_share_{k}"] for k in ("prev", "bottom_up", "top_down", "attention")]
    assert abs(sum(shares) - 1.0) < 1e-5


def test_flatten_diagnostics_keys_equal_glom_tpus():
    raw = {"island_agreement": torch.tensor([0.5, 0.25, 0.0]), "attn_entropy": torch.ones(3),
           "contrib_share_prev": torch.tensor(0.25)}
    ours = diagnostics.flatten_diagnostics(raw)
    theirs = jax_diag.flatten_diagnostics({k: jnp.asarray(v.numpy()) for k, v in raw.items()})
    assert ours == theirs
    assert ours["island_agreement"] == 0.25 and ours["island_agreement_L1"] == 0.25


@pytest.mark.parametrize("impl", ["pallas", "fused"])
def test_the_kernel_paths_give_the_dense_paths_diagnostics(impl):
    """On the CPU each wrapper takes its plain version, so the config's
    kernel path (K1 + K4 on "pallas"; K8's forward and K1 + K4's extra
    iteration on "fused") must give the dense path's numbers."""
    kernels = {"ff_impl": impl, "attention_impl": "pallas", "ff_fused_bwd": True}
    c, tree, img = _inputs(seed=3, **kernels)
    dense = GlomConfig(**TINY)
    params = convert.params_from_numpy(tree, c, "cpu")
    got = diagnostics.glom_diagnostics(params, img, config=c)
    want = diagnostics.glom_diagnostics(params, img, config=dense)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])


# -- monitors -------------------------------------------------------------------

def test_numerics_monitor_decides_as_glom_tpus():
    rng = np.random.default_rng(0)
    norms = list(rng.uniform(1.0, 2.0, 12))
    norms[5] = 50.0          # a spike
    norms[8] = float("nan")  # a non-finite step
    norms[9] = 40.0          # clamped into the EMA, so not a second spike
    script = [{"grad_norm": g, "nonfinite_grads": float(i == 8) * 3,
               "loss_nonfinite": float(i == 8)} for i, g in enumerate(norms)]
    ours = monitors.NumericsMonitor(spike_factor=10.0)
    theirs = jax_monitors.NumericsMonitor(spike_factor=10.0)
    for lo in range(0, len(script), 3):
        window = script[lo:lo + 3]
        assert ours.update(window) == theirs.update(window)
        assert ours._ema == pytest.approx(theirs._ema, rel=1e-12)
    assert (ours.nan_events, ours.spike_events) == (theirs.nan_events, theirs.spike_events)
    assert ours.spike_events >= 1 and ours.nan_events == 1


def test_memory_monitor_reports_nothing_on_the_cpu():
    assert monitors.MemoryMonitor("cpu").sample() == {}
    assert jax_monitors.MemoryMonitor().sample() == {}


def test_recompile_monitor_counts_a_build_after_its_baseline(monkeypatch):
    """The first poll is the baseline (glom_tpu's first compile); a kernel
    build or load injected after it is a recompile."""
    events = {"builds": 5, "loads": 2}
    monkeypatch.setattr(_build, "_events", events)
    mon = monitors.RecompileMonitor(lambda: sum(_build.events().values()))
    assert mon.available
    assert mon.poll() == 1 and (mon.compiles, mon.recompiles) == (1, 0)
    assert mon.poll() == 0
    events["loads"] += 1
    assert mon.poll() == 1 and (mon.compiles, mon.recompiles) == (2, 1)
    assert mon.poll() == 0
    inert = monitors.RecompileMonitor(None)
    assert not inert.available and inert.poll() == 0 and inert.recompiles == 0
