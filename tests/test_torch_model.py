"""The port's model (glom_tpu_torch.models, convert, config) against glom_tpu
on the CPU.

The same seeded numpy weights and images go through both packages.  Float32
throughout.  Tolerances: 1e-5 absolute for one op (summation order only),
1e-4 absolute over a forward of 2*L iterations (the state is O(1) and each
iteration adds a few rounding steps).  The port runs with
``ff_impl``/``attention_impl`` ``"pallas"``, its serving default, which on
CPU tensors takes the kernels' plain versions; glom_tpu runs its XLA
("dense") path, the plain reference of its Pallas kernels.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glom_tpu import config as jax_config
from glom_tpu import convert as jax_convert
from glom_tpu.models import glom as jax_glom
from glom_tpu.models import heads as jax_heads
from glom_tpu.models.shim import Glom as JaxGlom
from glom_tpu_torch import Glom, convert
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.models import heads
from glom_tpu_torch.serving.engine import demo_params

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

OP_ATOL = 1e-5
FWD_ATOL = 1e-4
TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)


def _configs(**kw):
    """The port's config (on the kernels' path) and glom_tpu's (dense)."""
    port = GlomConfig(**TINY, ff_impl="pallas", attention_impl="pallas", **kw)
    ref = jax_config.GlomConfig(**TINY, **kw)
    return port, ref


def _weights(config, seed=0, decoder="linear"):
    return demo_params(config, TrainConfig(decoder=decoder), seed)


def _jnp(tree):
    if isinstance(tree, dict):
        return {k: _jnp(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _img(b=2, seed=1):
    return np.random.default_rng(seed).standard_normal((b, 3, 16, 16)).astype(np.float32)


def _port_apply(config, tree, img, **kw):
    params = convert.params_from_numpy(tree, config, "cpu")
    with torch.inference_mode():
        out = glom_model.apply(params, torch.from_numpy(img), config=config, **kw)
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


@pytest.mark.parametrize("case", [
    {}, {"consensus_self": True}, {"local_consensus_radius": 1}, {"local_consensus_radius": 2},
])
def test_apply_matches_glom_tpu(case):
    port, ref = _configs(**case)
    tree = _weights(port)["glom"]
    img = _img()
    want = jax_glom.apply(_jnp(tree), jnp.asarray(img), config=ref)
    got = _port_apply(port, tree, img)
    assert got.shape == (2, port.num_patches, port.levels, port.dim)
    np.testing.assert_allclose(got, np.asarray(want), atol=FWD_ATOL)


@pytest.mark.parametrize("impl", ["dense", "pallas"])
def test_apply_impls_agree_on_cpu(impl):
    """``dense`` is the plain ops; ``pallas`` the kernel wrappers, which take
    the same plain ops for CPU tensors: the two agree bit for bit."""
    port, _ = _configs()
    tree = _weights(port)["glom"]
    img = _img()
    want = _port_apply(port, tree, img)
    cfg = dataclasses.replace(port, ff_impl=impl, attention_impl=impl)
    np.testing.assert_array_equal(_port_apply(cfg, tree, img), want)


def test_apply_carried_levels():
    port, ref = _configs()
    tree = _weights(port)["glom"]
    img = _img()
    levels = np.random.default_rng(2).standard_normal(
        (2, port.num_patches, port.levels, port.dim)).astype(np.float32)
    want = jax_glom.apply(_jnp(tree), jnp.asarray(img), config=ref, iters=3,
                          levels=jnp.asarray(levels))
    got = _port_apply(port, tree, img, iters=3, levels=torch.from_numpy(levels))
    np.testing.assert_allclose(got, np.asarray(want), atol=FWD_ATOL)


def test_apply_return_all_includes_t0():
    port, ref = _configs()
    tree = _weights(port)["glom"]
    img = _img()
    want = np.asarray(jax_glom.apply(_jnp(tree), jnp.asarray(img), config=ref, iters=4,
                                     return_all=True))
    got = _port_apply(port, tree, img, iters=4, return_all=True)
    assert got.shape == (5, 2, port.num_patches, port.levels, port.dim)
    # t=0 is the learned init state, broadcast over batch and patches
    np.testing.assert_array_equal(got[0], np.broadcast_to(tree["init_levels"], got[0].shape))
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)


@pytest.mark.parametrize("t", [0, 3, 6])
def test_apply_capture_timestep(t):
    port, ref = _configs()
    tree = _weights(port)["glom"]
    img = _img()
    want_final, want_t = jax_glom.apply(_jnp(tree), jnp.asarray(img), config=ref,
                                        capture_timestep=t)
    final, at_t = _port_apply(port, tree, img, capture_timestep=t)
    np.testing.assert_allclose(final, np.asarray(want_final), atol=FWD_ATOL)
    np.testing.assert_allclose(at_t, np.asarray(want_t), atol=FWD_ATOL)


def test_apply_refuses_bad_inputs():
    port, _ = _configs()
    params = convert.params_from_numpy(_weights(port)["glom"], port, "cpu")
    with pytest.raises(ValueError, match="img must be"):
        glom_model.apply(params, torch.zeros((1, 3, 8, 8)), config=port)
    with pytest.raises(ValueError, match="carried levels"):
        glom_model.apply(params, torch.zeros((1, 3, 16, 16)), config=port,
                         levels=torch.zeros((1, 4, 3, 32)))
    with pytest.raises(ValueError, match="capture_timestep"):
        glom_model.apply(params, torch.zeros((1, 3, 16, 16)), config=port, iters=2,
                         capture_timestep=3)


@pytest.mark.parametrize("field,value,queue", [
    ("ff_impl", "fused", None),
    ("attention_impl", "auto", None),
    ("attention_impl", "ring", "needs a device mesh"),
    ("attention_impl", "ulysses", "needs a device mesh"),
])
def test_unported_impls_load_but_raise_on_forward(field, value, queue):
    """Every ``ff_impl`` / ``attention_impl`` of glom_tpu loads.  ``fused`` and
    ``auto`` run (on the CPU: the plain versions, the kernels' path bit for
    bit); ``ring`` and ``ulysses`` are bound to a mesh and refuse a forward
    without one, with glom_tpu's error (the Trainer injects them, or a caller
    passes ``consensus_fn``; tests/test_torch_parallel*.py run them)."""
    port, _ = _configs()
    cfg = dataclasses.replace(port, **{field: value})
    # the config (and so a checkpoint recording it) loads ...
    assert GlomConfig.from_json_dict(cfg.to_json_dict()) == cfg
    params = convert.params_from_numpy(_weights(port)["glom"], port, "cpu")
    img = torch.from_numpy(_img(1))
    if queue is None:
        with torch.inference_mode():
            got = glom_model.apply(params, img, config=cfg)
            want = glom_model.apply(params, img, config=port)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
        return
    # ... and only a forward asked to run a mesh-bound path without a mesh refuses
    with pytest.raises(ValueError, match=queue):
        glom_model.apply(params, img, config=cfg)
    # glom_tpu refuses it the same way
    with pytest.raises(ValueError, match=queue):
        jax_glom.make_consensus_fn(dataclasses.replace(_configs()[1], **{field: value}))


def test_update_divisors_and_initial_levels():
    port, ref = _configs()
    np.testing.assert_array_equal(glom_model.update_divisors(port, torch.float32).numpy(),
                                  np.asarray(jax_glom.update_divisors(ref, jnp.float32)))
    tree = _weights(port)["glom"]
    params = convert.params_from_numpy(tree, port, "cpu")
    got = glom_model.initial_levels(params, 2, port, torch.float32)
    want = jax_glom.initial_levels(_jnp(tree), 2, ref, jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["linear", "mlp", "linear_all", "mlp_all"])
def test_decoder_heads_match(arch):
    port, ref = _configs()
    dec = _weights(port, decoder=arch)["decoder"]
    shapes = heads.decoder_param_shapes(port, arch=arch)
    assert {k: v.shape for k, v in dec.items()} == shapes
    jax_init = jax_heads.decoder_init(jnp.zeros((2,), jnp.uint32), ref, arch=arch)
    assert {k: v.shape for k, v in jax_init.items()} == shapes
    state = np.random.default_rng(3).standard_normal(
        (2, port.num_patches, port.levels, port.dim)).astype(np.float32)
    want = jax_heads.decoder_apply(_jnp(dec), jnp.asarray(state), ref, arch=arch, level=1)
    got = heads.decoder_apply({k: torch.from_numpy(v) for k, v in dec.items()},
                              torch.from_numpy(state), port, arch=arch, level=1)
    assert got.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_ATOL)


def test_decoder_init_draws_from_the_generator():
    port, _ = _configs()
    a = heads.decoder_init(torch.Generator().manual_seed(0), port, arch="mlp")
    b = heads.decoder_init(torch.Generator().manual_seed(0), port, arch="mlp")
    assert {k: tuple(v.shape) for k, v in a.items()} == heads.decoder_param_shapes(port, arch="mlp")
    for k in a:
        torch.testing.assert_close(a[k], b[k], atol=0, rtol=0)


def test_init_shapes_and_param_count_match_glom_tpu():
    port, ref = _configs()
    params = glom_model.init(torch.Generator().manual_seed(0), port)
    jax_params = jax_glom.init(jnp.zeros((2,), jnp.uint32), ref)
    shapes = glom_model.tree_map(lambda t: tuple(t.shape), params)
    assert shapes == glom_model.param_shapes(port)
    assert shapes == {k: ({kk: tuple(vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                          else tuple(v.shape)) for k, v in jax_params.items()}
    assert glom_model.param_count(params) == jax_glom.param_count(jax_params)


def test_glom_module_matches_the_jax_shim():
    port, _ = _configs()
    tree = _weights(port)["glom"]
    img = _img()
    ref = JaxGlom(**TINY, params=_jnp(tree))
    model = Glom(**TINY, device="cpu", params=convert.params_from_numpy(tree, port, "cpu"),
                 ff_impl="pallas", attention_impl="pallas")
    assert model.num_params == ref.num_params
    with torch.inference_mode():
        out = model(img)
        out_all = model(img, iters=2, return_all=True)
        carried = model(img, iters=2, levels=out)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref(img)), atol=FWD_ATOL)
    np.testing.assert_allclose(out_all.numpy(), np.asarray(ref(img, iters=2, return_all=True)),
                               atol=FWD_ATOL)
    np.testing.assert_allclose(carried.numpy(),
                               np.asarray(ref(img, iters=2, levels=out.numpy())), atol=FWD_ATOL)


def test_glom_module_default_is_the_reference_size():
    model = Glom(device="cpu")
    assert model.num_params == 23532544
    assert isinstance(model, torch.nn.Module)
    assert sum(p.numel() for p in model.parameters()) == model.num_params


@pytest.mark.parametrize("radius", [0, 2])
def test_reference_state_dict_matches_glom_tpu_convert(radius):
    port, ref = _configs(local_consensus_radius=radius)
    tree = _weights(port)["glom"]
    params = convert.params_from_numpy(tree, port, "cpu")
    got = convert.to_reference_state_dict(params, port)
    want = jax_convert.jax_to_torch(tree, ref)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # and back: the port's import equals glom_tpu's torch_to_jax
    back = convert.from_reference_state_dict(got, port, "cpu")
    jax_back = jax_convert.torch_to_jax({k: v.numpy() for k, v in got.items()}, ref)
    flat = convert.params_to_numpy(back)
    for key in ("patch_embed", "bottom_up", "top_down"):
        for leaf in flat[key]:
            np.testing.assert_array_equal(flat[key][leaf], jax_back[key][leaf])
    for key in ("pos_emb", "init_levels"):
        np.testing.assert_array_equal(flat[key], jax_back[key])


def test_glom_module_reference_state_dict_round_trip():
    port, _ = _configs()
    tree = _weights(port)["glom"]
    model = Glom(**TINY, device="cpu", params=convert.params_from_numpy(tree, port, "cpu"))
    again = Glom.from_reference_state_dict(model.reference_state_dict(), **TINY, device="cpu")
    for a, b in zip(glom_model.tree_leaves(model.params()), glom_model.tree_leaves(again.params())):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_params_numpy_round_trip_and_dtype():
    port, _ = _configs()
    tree = _weights(port)["glom"]
    bf = dataclasses.replace(port, param_dtype=torch.bfloat16)
    params = convert.params_from_numpy(tree, bf, "cpu")
    assert all(p.dtype == torch.bfloat16 for p in glom_model.tree_leaves(params))
    back = convert.params_to_numpy(convert.params_from_numpy(tree, port, "cpu"))
    for a, b in zip(glom_model.tree_leaves(back), glom_model.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_config_json_crosses_between_packages():
    port = GlomConfig(dim=64, levels=4, param_dtype=torch.bfloat16, compute_dtype="float32",
                      ff_impl="pallas", attention_impl="pallas", local_consensus_radius=2)
    ref = jax_config.GlomConfig.from_json_dict(port.to_json_dict())
    assert ref.to_json_dict() == port.to_json_dict()
    assert GlomConfig.from_json_dict(ref.to_json_dict()) == port
    assert port.param_dtype is torch.bfloat16 and port.compute_dtype is torch.float32
    # every field of glom_tpu's configs has a counterpart of the same default
    assert GlomConfig().to_json_dict() == jax_config.GlomConfig().to_json_dict()
    assert TrainConfig().to_json_dict() == jax_config.TrainConfig().to_json_dict()


def test_train_config_drops_unknown_fields():
    d = TrainConfig(decoder="mlp", loss_timestep=3).to_json_dict()
    d["a_knob_from_a_newer_build"] = 1
    cfg = TrainConfig.from_json_dict(d)
    assert cfg.decoder == "mlp" and cfg.loss_timestep == 3
