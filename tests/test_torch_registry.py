"""The port's model registry (glom_tpu_torch/serving/registry.py) against
glom_tpu's on the CPU.

The same sequence of ``register`` / ``promote`` / ``sync_primary`` /
``remove`` calls under one fake clock gives equal ``snapshot()``s,
``lineage()``s and residency gauges in both registries; residency is
bounded as in glom_tpu; ``cache_signature`` is glom_tpu's tuple; and
``test_an_aliased_version_has_graphs_of_its_own`` says what ``aliased`` means
in the port: the same program, graphs captured against its own parameters.
"""

import os

import numpy as np
import pytest
import torch

from glom_tpu.config import GlomConfig as JaxGlomConfig
from glom_tpu.serving import registry as jax_registry
from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.serving import compile_cache, registry
from glom_tpu_torch.serving.engine import ServingEngine, ServingSet, make_demo_checkpoint

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)
ENDPOINTS = ("embed", "index", "parse", "reconstruct")


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _pair(**kw):
    return (registry.ModelRegistry(clock=FakeClock(), **kw),
            jax_registry.ModelRegistry(clock=FakeClock(), **kw))


def _register(regs, model, step, **kw):
    ours, theirs = regs
    ours.register(model, step, caches=ServingSet(step, {}, dict.fromkeys(ENDPOINTS)),
                  config=None, quant="f32", **kw)
    theirs.register(model, step, params={}, caches=dict.fromkeys(ENDPOINTS), config=None,
                    quant="f32", **kw)


def _sync(regs, model, step, source="reload"):
    ours, theirs = regs
    ours.sync_primary(model, step, ServingSet(step, {}, dict.fromkeys(ENDPOINTS)),
                      source=source)
    theirs.sync_primary(model, step, {}, source=source)


def _both(regs, method, *args):
    return [getattr(r, method)(*args) for r in regs]


SEQUENCES = {
    "deploy_promote": [("register", "default", 0, {"role": "primary", "source_dir": "D"}),
                       ("register", "default", 2, {"role": "candidate", "aliased": True}),
                       ("sync", "default", 2, "promote")],
    "deploy_rollback": [("register", "default", 0, {"role": "primary"}),
                        ("register", "default", 2, {"role": "candidate", "aliased": True}),
                        ("remove", "default", 2), ("sync", "default", 5, "reload"),
                        ("sync", "default", 0, "rollback")],
    "extra_models": [("register", "default", 0, {"role": "primary"}),
                     ("register", "alt", 7, {"role": "primary", "source_dir": "A"}),
                     ("register", "alt", 9, {}), ("promote", "alt", 9),
                     ("register", "default", 3, {"role": "candidate", "aliased": True}),
                     ("remove", "alt", 7), ("remove", "alt", 9)],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_the_same_calls_give_equal_snapshots_and_gauges(name):
    regs = _pair()
    for call in SEQUENCES[name]:
        if call[0] == "register":
            _register(regs, call[1], call[2], **call[3])
        elif call[0] == "sync":
            _sync(regs, call[1], call[2], call[3])
        else:
            _both(regs, call[0], call[1], call[2])
        ours, theirs = (r.snapshot() for r in regs)
        assert ours == theirs
    assert regs[0].metrics.snapshot() == regs[1].metrics.snapshot()
    for model in regs[1].models():
        assert regs[0].lineage(model)["history"] == regs[1].lineage(model)["history"]


def test_lineage_anchors_on_the_newest_valid_step_without_quarantining(tmp_path):
    d = str(tmp_path)
    make_demo_checkpoint(d, config=GlomConfig(**TINY), seed=0)
    make_demo_checkpoint(d, config=GlomConfig(**TINY), seed=1, step=3)
    make_demo_checkpoint(d, config=GlomConfig(**TINY), seed=2, step=7)
    path = ckpt_lib.npz_path(d, 7)
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    regs = _pair()
    _register(regs, "default", 0, role="primary", source_dir=d)
    ours, theirs = (r.lineage("default") for r in regs)
    assert not [f for f in os.listdir(d) if f.endswith(".corrupt")]
    assert ours == theirs
    assert (ours["latest_valid_step"], ours["primary_step"], ours["checkpoint_dir"]) == (3, 0, d)


def test_residency_is_bounded_as_glom_tpu():
    regs = _pair(max_versions_per_model=2)
    _register(regs, "m", 1, role="primary")
    _register(regs, "m", 2)
    for r, kw in zip(regs, ({"caches": ServingSet(3, {}, {})}, {"params": {}, "caches": {}})):
        with pytest.raises(ValueError, match="resident versions"):
            r.register("m", 3, config=None, quant="f32", **kw)
    assert _both(regs, "remove", "m", 1) == [True, True]
    _register(regs, "m", 3)
    assert regs[0].snapshot() == regs[1].snapshot()
    with pytest.raises(ValueError, match=">= 2"):
        registry.ModelRegistry(max_versions_per_model=1)


def test_duplicate_and_double_primary_refused_as_glom_tpu():
    regs = _pair()
    _register(regs, "m", 1, role="primary")
    for r, kw in zip(regs, ({"caches": ServingSet(1, {}, {})}, {"params": {}, "caches": {}})):
        with pytest.raises(ValueError, match="already resident"):
            r.register("m", 1, config=None, quant="f32", **kw)
        with pytest.raises(ValueError, match="primary"):
            r.register("m", 2, config=None, quant="f32", role="primary", **kw)
        with pytest.raises(ValueError, match="unknown role"):
            r.register("m", 4, config=None, quant="f32", role="shadow", **kw)
    assert _both(regs, "get", "m", 9) == [None, None]
    assert [v.step for v in regs[0].versions()] == [v.step for v in regs[1].versions()]


@pytest.mark.parametrize("quant,buckets,iters", [("f32", (1, 2, 4, 8), None),
                                                 ("bf16", (1, 8), 6), ("int8", (2,), 3)])
def test_cache_signature_is_glom_tpus(quant, buckets, iters):
    ours = registry.cache_signature(GlomConfig(**TINY, ff_impl="pallas"), quant, buckets,
                                    iters=iters)
    theirs = jax_registry.cache_signature(JaxGlomConfig(**TINY, ff_impl="pallas"), quant,
                                          buckets, iters=iters)
    assert ours == theirs
    assert ours != registry.cache_signature(GlomConfig(**TINY), quant, buckets, iters=iters)


def test_an_aliased_version_has_graphs_of_its_own(tmp_path):
    """Two versions of one signature are one program: the second is
    ``aliased`` (its summary says so, as glom_tpu's does) and reuses the
    first's ServingProgram, the same graph functions.  But a CUDA graph holds
    its parameters' addresses, so each version captures graphs of its own,
    against its own parameters: the caches are distinct objects, each
    answers with its own weights, and loading the second captured as many
    keys as the first."""
    d = str(tmp_path)
    make_demo_checkpoint(d, config=GlomConfig(**TINY), seed=0)
    ours = registry.ModelRegistry(clock=FakeClock())
    made = compile_cache.captures_made()
    v0 = registry.load_version("m", d, buckets=(1, 2), models=ours, role="primary",
                               device="cpu")
    first = compile_cache.captures_made() - made
    make_demo_checkpoint(d, config=GlomConfig(**TINY), seed=1, step=4)
    made = compile_cache.captures_made()
    v4 = registry.load_version("m", d, buckets=(1, 2), models=ours, step=4, device="cpu")
    assert compile_cache.captures_made() - made == first > 0
    assert not v0.aliased and v4.aliased and v4.summary()["cache_aliased"]
    assert v4.program is v0.program
    assert v4.caches.caches["embed"] is not v0.caches.caches["embed"]
    x = np.random.default_rng(0).standard_normal((1, 3, 16, 16)).astype(np.float32)
    out0 = v0.caches.caches["embed"](v0.params, x)
    out4 = v4.caches.caches["embed"](v4.params, x)
    assert not np.allclose(out0, out4)
    assert ours.metrics.snapshot()["registry_cache_alias_total"] == 1
    # glom_tpu's registry, the same two loads: the same flags in its summary
    theirs = jax_registry.ModelRegistry(clock=FakeClock())
    t0 = jax_registry.load_version("m", d, buckets=(1, 2), models=theirs, role="primary",
                                   step=0, warmup=False)
    t4 = jax_registry.load_version("m", d, buckets=(1, 2), models=theirs, step=4,
                                   warmup=False)
    for a, b in ((v0, t0), (v4, t4)):
        sa, sb = a.summary(), b.summary()
        assert {k: v for k, v in sa.items() if k != "loaded_at"} == {
            k: v for k, v in sb.items() if k != "loaded_at"}


def test_engine_registers_its_primary_and_syncs_it_across_a_reload(tmp_path):
    d = str(tmp_path)
    make_demo_checkpoint(d, config=GlomConfig(**TINY), seed=0)
    eng = ServingEngine(d, device="cpu", buckets=(1, 2), reload_poll_s=0)
    try:
        primary = eng.models.get(registry.DEFAULT_MODEL)
        assert primary.role == "primary" and primary.caches is eng.serving
        assert eng.models.snapshot()["models"] == ["default"]
        make_demo_checkpoint(d, config=GlomConfig(**TINY), seed=1, step=5)
        assert eng.check_reload() is True
        primary = eng.models.get(registry.DEFAULT_MODEL)
        assert primary.step == 5 and primary.caches is eng.serving
        assert len(eng.models.versions(registry.DEFAULT_MODEL)) == 1
    finally:
        eng.shutdown(drain=False)


def test_an_extra_model_loads_with_its_own_config(tmp_path):
    """An extra model keeps its own config and program (a narrower width
    than the primary's loads on the CPU; on the card the kernels' width
    check refuses what they cannot take, as for a primary)."""
    d, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    make_demo_checkpoint(d, config=GlomConfig(**TINY), seed=0)
    make_demo_checkpoint(d2, config=GlomConfig(dim=16, levels=2, image_size=8, patch_size=4),
                         seed=1)
    eng = ServingEngine(d, device="cpu", buckets=(1, 2), reload_poll_s=0,
                        extra_models={"narrow": d2})
    try:
        narrow = eng.models.get("narrow")
        assert narrow.config.dim == 16 and narrow.program is not eng._program
        x = np.zeros((1, 3, 8, 8), np.float32)
        assert narrow.caches.caches["embed"](narrow.params, x).shape == (1, 2, 16)
    finally:
        eng.shutdown(drain=False)
