"""The port's mesh (glom_tpu_torch.parallel) against glom_tpu's on the CPU.

The spec tables are compared with ``glom_tpu``'s ``PartitionSpec``s entry by
entry.  The ring and Ulysses consensus and the sharded grouped FF run on gloo
worlds of CPU processes (``tests/torch_mesh_worker.py``, one world per size,
started once by a module fixture), and are held, forward and gradient, against
``glom_tpu``'s on the faked 8-device CPU mesh (its FF on its Pallas kernel in
interpret mode, as ``glom_tpu``'s trainer runs it under TP and EP) and
against the port's own one-process ops, on the same numpy inputs.  Float32;
tolerance 1e-5 per op (normwise relative, and elementwise against the largest
magnitude).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glom_tpu import config as jax_config
from glom_tpu.parallel import ff_shard as jax_ff_shard
from glom_tpu.parallel import placement as jax_placement
from glom_tpu.parallel import ring as jax_ring
from glom_tpu.parallel import sharding as jax_sharding
from glom_tpu.parallel import ulysses as jax_ulysses
from glom_tpu.parallel.mesh import make_mesh as jax_make_mesh
from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.ops.consensus import consensus_attention
from glom_tpu_torch.ops.feedforward import grouped_ff_apply
from glom_tpu_torch.ops.masks import local_consensus_mask
from glom_tpu_torch.parallel import mesh as port_mesh
from glom_tpu_torch.parallel import placement, sharding
from glom_tpu_torch.parallel.mesh import AxisGroup, Mesh
from glom_tpu_torch.parallel.ring import make_ring_consensus
from glom_tpu_torch.parallel.ulysses import make_ulysses_consensus
from tests.torch_mesh_world import assemble, run_world

torch.set_num_threads(1)

OP_TOL = 1e-5
B, SIDE, D = 2, 4, 16          # n = 16 columns
N = SIDE * SIDE
RADIUS = 1.5


def _close(got, want, tol=OP_TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want), what
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max()), what


def _rng_arrays(seed, **shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


# -- the cases: consensus over seq, the FF over model ------------------------

# (name, ranks, impl, attend_self, masked, levels)
CONSENSUS = [
    ("ring_s2", 2, "ring", False, False, 3),
    ("ring_s2_self", 2, "ring", True, False, 3),
    ("ring_s2_mask", 2, "ring", False, True, 3),
    ("ulysses_s2", 2, "ulysses", False, False, 4),
    ("ulysses_s2_self", 2, "ulysses", True, False, 4),
    ("ulysses_s2_mask", 2, "ulysses", False, True, 4),
    ("ring_s4", 4, "ring", False, False, 3),
    ("ring_s4_mask", 4, "ring", True, True, 3),
    ("ulysses_s4_l6", 4, "ulysses", False, False, 6),       # pads 6 levels to 8
    ("ulysses_s4_mask", 4, "ulysses", True, True, 4),
]
# (name, mesh, axes, sharding, levels, net): the net's group count is
# levels (bottom_up) or levels - 1 (top_down)
FF = [
    ("ff_tp_121", (1, 2, 1), None, "tp", 3, "bottom_up"),
    ("ff_ep_121", (1, 2, 1), None, "ep", 3, "top_down"),          # 2 groups split
    ("ff_ep_121_rep", (1, 2, 1), None, "ep", 3, "bottom_up"),     # 3 groups replicated
    ("ff_rep_211", (2, 1, 1), None, "replicated", 3, "bottom_up"),
    ("ff_tp_221", (2, 2, 1), None, "tp", 3, "top_down"),
    ("ff_tp_112", (1, 2, 2), None, "tp", 3, "bottom_up"),
    ("ff_ep_factored", (1, 3, 1, 2), ("data", "model", "seq", "model2"), "ep", 3, "top_down"),
]
H = 32


def _consensus_inputs(levels, seed):
    arrays = _rng_arrays(seed, levels=(B, N, levels, D), cot=(B, N, levels, D))
    arrays["mask"] = local_consensus_mask(SIDE, RADIUS)
    return arrays


def _ff_inputs(groups, seed):
    return _rng_arrays(seed, w1=(groups, D, H), b1=(groups, H), w2=(groups, H, D),
                       b2=(groups, D), x=(B, N, groups, D), cot=(B, N, groups, D))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every case's inputs, and each world's results: one world of 2, one of
    4 and one of 6 ranks for the whole module."""
    root = tmp_path_factory.mktemp("mesh_ops")
    inputs, jobs = {}, {2: [], 4: [], 6: []}
    for k, (name, ranks, impl, attend_self, masked, levels) in enumerate(CONSENSUS):
        arrays = _consensus_inputs(levels, 10 + k)
        if not masked:
            del arrays["mask"]
        inputs[name] = arrays
        np.savez(root / f"{name}.npz", **arrays)
        jobs[ranks].append({"kind": "consensus", "name": name, "mesh": [1, 1, ranks],
                            "impl": impl, "attend_self": attend_self,
                            "inputs": str(root / f"{name}.npz")})
    for k, (name, mesh, axes, kind, levels, net) in enumerate(FF):
        arrays = _ff_inputs(levels if net == "bottom_up" else levels - 1, 40 + k)
        inputs[name] = arrays
        np.savez(root / f"{name}.npz", **arrays)
        job = {"kind": "ff", "name": name, "mesh": list(mesh), "sharding": kind,
               "levels": levels, "net": net, "inputs": str(root / f"{name}.npz")}
        if axes:
            job["axes"] = list(axes)
        jobs[int(np.prod(mesh))].append(job)
    results = {}
    for world, world_jobs in jobs.items():
        results.update(run_world(str(root / f"world{world}"), world, world_jobs))
    return inputs, results


def _jax_consensus(impl, ranks, arrays, attend_self):
    mesh = jax_make_mesh((1, 1, ranks), devices=jax.devices()[:ranks])
    make = jax_ring.make_ring_consensus if impl == "ring" else jax_ulysses.make_ulysses_consensus
    mask = jnp.asarray(arrays["mask"]) if "mask" in arrays else None
    fn = make(mesh, attend_self=attend_self, non_local_mask=mask)
    cot = jnp.asarray(arrays["cot"])
    levels = jnp.asarray(arrays["levels"])
    out, vjp = jax.vjp(jax.jit(fn), levels)
    return np.asarray(out), np.asarray(vjp(cot)[0])


@pytest.mark.parametrize("case", CONSENSUS, ids=[c[0] for c in CONSENSUS])
def test_sequence_parallel_consensus_matches_glom_tpu(worlds, case):
    """The ring and Ulysses consensus, each rank on its n/S columns, against
    glom_tpu's on S faked devices and the port's dense op on all columns:
    the output and the gradient of <out, cot> with respect to the levels."""
    name, ranks, impl, attend_self, _, _ = case
    inputs, results = worlds
    arrays = inputs[name]
    shape = arrays["levels"].shape
    got = assemble(results[name], "out", shape)
    got_grad = assemble(results[name], "grad", shape)
    want, want_grad = _jax_consensus(impl, ranks, arrays, attend_self)
    _close(got, want, what="forward vs glom_tpu")
    _close(got_grad, want_grad, what="gradient vs glom_tpu")
    levels = torch.from_numpy(arrays["levels"]).requires_grad_(True)
    mask = torch.from_numpy(arrays["mask"]) if "mask" in arrays else None
    out, _ = consensus_attention(levels, attend_self=attend_self, non_local_mask=mask)
    (out * torch.from_numpy(arrays["cot"])).sum().backward()
    _close(got, out.detach().numpy(), what="forward vs one process")
    _close(got_grad, levels.grad.numpy(), what="gradient vs one process")


def _jax_ff(mesh_shape, axes, kind, arrays):
    n = int(np.prod(mesh_shape))
    axes = axes or ("data", "model", "seq")
    mesh = jax_make_mesh(mesh_shape, axes, devices=jax.devices()[:n])
    extra = tuple(a for a in axes[3:] if mesh.shape[a] > 1)
    ff = jax_ff_shard.make_sharded_ff_pallas(mesh, param_sharding=kind, seq_axis="seq",
                                              fused_bwd=True, interpret=True,
                                              extra_expert_axes=extra)
    params = {k: jnp.asarray(arrays[k]) for k in ("w1", "b1", "w2", "b2")}
    out, vjp = jax.vjp(jax.jit(ff), params, jnp.asarray(arrays["x"]))
    gp, gx = vjp(jnp.asarray(arrays["cot"]))
    return np.asarray(out), {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx)


@pytest.mark.parametrize("case", FF, ids=[c[0] for c in FF])
def test_sharded_ff_matches_glom_tpu(worlds, case):
    """``make_sharded_ff_pallas`` (the kernels' wrappers, on the CPU their
    plain versions, with K2/K3's backward) per shard under tp, ep (a net the
    axis divides, one it does not, factored expert axes) and replicated,
    against glom_tpu's on its Pallas kernel in interpret mode and against the
    plain FF on one process: the output, the input's gradient and every
    parameter's (summed over the data and seq shards, as glom_tpu's
    shard_map transposes a replicated input, and all-gathered over the axes
    it is split over)."""
    name, mesh_shape, axes, kind, _, _ = case
    inputs, results = worlds
    arrays = inputs[name]
    parts = results[name]
    shape = arrays["x"].shape
    got = assemble(parts, "out", shape)
    got_gx = assemble(parts, "grad_x", shape)
    want, want_gp, want_gx = _jax_ff(mesh_shape, axes, kind, arrays)
    _close(got, want, what="forward vs glom_tpu")
    _close(got_gx, want_gx, what="dx vs glom_tpu")
    params = {k: torch.from_numpy(arrays[k]).requires_grad_(True) for k in want_gp}
    x = torch.from_numpy(arrays["x"]).requires_grad_(True)
    out = grouped_ff_apply(params, x)
    (out * torch.from_numpy(arrays["cot"])).sum().backward()
    _close(got, out.detach().numpy(), what="forward vs one process")
    for k in want_gp:
        for part in parts:
            _close(part[f"grad_{k}"], want_gp[k], what=f"d{k} vs glom_tpu")
            _close(part[f"grad_{k}"], params[k].grad.numpy(), what=f"d{k} vs one process")


def test_ep_and_tp_ranks_hold_their_shard_only(worlds):
    """Each rank holds 1/m of a split leaf: tp the hidden, ep the groups."""
    _, results = worlds
    for part in results["ff_tp_121"]:
        assert tuple(part["local_w1"]) == (3, D, H // 2) and tuple(part["local_b2"]) == (3, D)
    for part in results["ff_ep_121"]:
        assert tuple(part["local_w1"]) == (1, D, H)
    for part in results["ff_ep_121_rep"]:
        assert tuple(part["local_w1"]) == (3, D, H)
    # factored: the top-down net's 2 groups split over model2, not model (3)
    for part in results["ff_ep_factored"]:
        assert tuple(part["local_w1"]) == (1, D, H)


# -- the spec tables, entry by entry ----------------------------------------

SPEC_CONFIGS = [dict(dim=512, levels=6, image_size=224, patch_size=14),
                dict(dim=32, levels=3, image_size=16, patch_size=4),
                dict(dim=16, levels=4, image_size=16, patch_size=4)]


def _specs_equal(port, ref):
    if isinstance(port, dict):
        assert set(port) == set(ref)
        for k in port:
            _specs_equal(port[k], ref[k])
        return
    assert port == tuple(ref), (port, ref)


@pytest.mark.parametrize("kw", SPEC_CONFIGS, ids=["flagship", "tiny", "levels4"])
def test_param_pspecs_match_glom_tpu(kw):
    port, ref = GlomConfig(**kw), jax_config.GlomConfig(**kw)
    _specs_equal(sharding.param_pspecs(port), jax_sharding.param_pspecs(ref))
    _specs_equal(sharding.param_pspecs(port, model_axis="m"),
                 jax_sharding.param_pspecs(ref, model_axis="m"))


@pytest.mark.parametrize("kw", SPEC_CONFIGS, ids=["flagship", "tiny", "levels4"])
@pytest.mark.parametrize("axis_size,extra", [(2, None), (3, None), (1, None), (3, {"model2": 2}),
                                             (2, {"model2": 3})])
def test_level_sharded_pspecs_match_glom_tpu(kw, axis_size, extra):
    port, ref = GlomConfig(**kw), jax_config.GlomConfig(**kw)
    with warnings.catch_warnings(record=True) as port_warns:
        warnings.simplefilter("always")
        got = sharding.level_sharded_pspecs(port, axis_size=axis_size, extra_axes=extra)
    with warnings.catch_warnings(record=True) as ref_warns:
        warnings.simplefilter("always")
        want = jax_sharding.level_sharded_pspecs(ref, axis_size=axis_size, extra_axes=extra)
    _specs_equal(got, want)
    assert [str(w.message) for w in port_warns] == [str(w.message) for w in ref_warns]


def test_batch_state_specs_and_expert_axis_rule_match_glom_tpu():
    assert sharding.batch_pspec() == tuple(jax_sharding.batch_pspec())
    assert sharding.state_pspec() == tuple(jax_sharding.state_pspec())
    assert sharding.state_pspec("d", "s") == tuple(jax_sharding.state_pspec("d", "s"))
    for groups in range(1, 9):
        for cands in ([("model", 2)], [("model", 3), ("model2", 2)], [("a", 2), ("b", 2)],
                      [("model", 1)], [("model", 4), ("x", 2)]):
            assert sharding.pick_expert_axis(groups, cands) == jax_sharding.pick_expert_axis(
                groups, cands)


def test_resolve_pspec_matches_glom_tpu_on_state_paths():
    from jax.sharding import PartitionSpec as P

    cfg = GlomConfig(**SPEC_CONFIGS[1])
    tree = {"glom": sharding.param_pspecs(cfg), "decoder": sharding.decoder_pspecs()}
    port_flat = placement.flatten_specs(tree)
    ref_flat = jax_placement._flatten_specs(jax.tree_util.tree_map(
        lambda s: P(*s), tree, is_leaf=lambda x: isinstance(x, tuple)))
    paths = [("mu", "glom", "bottom_up", "w1"), ("nu", "glom", "top_down", "b1"),
             ("glom", "pos_emb"), ("0", "mu", "decoder", "w"), ("count",),
             ("glom", "bottom_up", "w2"), ("other", "w1")]
    for path in paths:
        for ndim in (0, 1, 2, 3):
            assert placement.resolve_pspec(path, port_flat, ndim) == tuple(
                jax_placement.resolve_pspec(path, ref_flat, ndim)), (path, ndim)


def test_state_shardings_place_the_moments_like_the_params():
    cfg = GlomConfig(**SPEC_CONFIGS[1])
    specs = {"glom": sharding.param_pspecs(cfg), "decoder": sharding.decoder_pspecs()}
    state = {"count": 3, "mu": {"glom": {"bottom_up": {"w1": torch.zeros(3, 32, 128)}}},
             "nu": {"decoder": {"b": torch.zeros(48)}}}
    got = placement.state_shardings(state, specs)
    assert got == {"count": (), "mu": {"glom": {"bottom_up": {"w1": (None, None, "model")}}},
                   "nu": {"decoder": {"b": (None,)}}}


# -- refusals ------------------------------------------------------------------

def _fake_mesh(**shape):
    """A mesh object of the given shape (no process group; only its sizes
    are read before any collective)."""
    shape = {"data": 1, "model": 1, "seq": 1, **shape}
    axes = {a: AxisGroup(a, None, tuple(range(s)), 0) for a, s in shape.items()}
    return Mesh(shape, 0, axes, None)


def test_a_mesh_that_does_not_cover_the_world_is_refused():
    with pytest.raises(ValueError, match=r"does not cover 1 devices"):
        port_mesh.make_mesh((2, 1, 1))
    with pytest.raises(ValueError, match="does not match axis_names"):
        port_mesh.make_mesh((1, 1))
    mesh = port_mesh.make_mesh((1, -1, 1))
    assert mesh.shape == {"data": 1, "model": 1, "seq": 1} and mesh.world_size == 1
    assert port_mesh.make_mesh().shape == {"data": 1, "model": 1, "seq": 1}


def test_columns_the_seq_axis_does_not_divide_are_refused():
    for make in (make_ring_consensus, make_ulysses_consensus):
        with pytest.raises(ValueError, match="n=16 patch columns not divisible by seq-axis "
                                             "size 3"):
            make(_fake_mesh(seq=3), num_patches=16)


def test_the_elastic_and_hybrid_meshes_on_one_process():
    """Without a process group the world is one rank: the elastic mesh of one
    host is it, a larger plan is refused with glom_tpu's message, and the
    hybrid mesh is the flat mesh of its total shape (ranks carry no slice
    metadata; tests/test_torch_elastic.py holds the shapes against
    glom_tpu's and runs the prefix meshes on gloo worlds)."""
    assert port_mesh.make_elastic_mesh(1, 1).shape == {"data": 1, "model": 1, "seq": 1}
    with pytest.raises(ValueError, match=r"re-planned mesh \(2, 1, 1\) needs 2 devices; "
                                         r"only 1 visible"):
        port_mesh.make_elastic_mesh(2, 1)
    assert port_mesh.make_hybrid_mesh((1, 1, 1), 1).shape == {"data": 1, "model": 1, "seq": 1}
    with pytest.raises(ValueError, match=r"does not cover 1 devices"):
        port_mesh.make_hybrid_mesh((1, 1, 1), 2)


def test_initialize_distributed_is_a_no_op_for_one_process():
    assert port_mesh.initialize_distributed(None, None, None) is None
    assert port_mesh.initialize_distributed(None, 1, 0) is None
    with pytest.raises(ValueError, match="needs a coordinator"):
        port_mesh.initialize_distributed(None, 2, 0, device="cpu")
    assert port_mesh.init_method("h:1") == "tcp://h:1"
    assert port_mesh.init_method("file:///x") == "file:///x"
    assert port_mesh.backend_for("cpu") == "gloo" and port_mesh.backend_for("cuda:1") == "nccl"
