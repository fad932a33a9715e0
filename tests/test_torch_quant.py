"""The port's quantized serving (glom_tpu_torch/serving/quant.py, the engine's
``quant``, python -m glom_tpu_torch.tools.quant_check) against glom_tpu's on
the CPU.

The int8 codes and scales are bitwise glom_tpu's on the same seeded trees
(the zero channel, per-level scales, bf16 input parameters), and so is the
dequantized tree.  The engines of both packages serve one checkpoint of the
small config (dim 32, 3 levels, 16/4) in each reduced mode; their /embed
and /reconstruct agree within 1e-2, relative (normwise): the bf16 rule.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glom_tpu import config as jax_config
from glom_tpu.serving import quant as jax_quant
from glom_tpu.serving.engine import ServingEngine as JaxServingEngine
from glom_tpu.serving.engine import make_demo_checkpoint as jax_make_demo_checkpoint
from glom_tpu.training import denoise as jax_denoise
from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch.serving import quant
from glom_tpu_torch.serving.engine import ServingEngine
from glom_tpu_torch.tools import quant_check
from glom_tpu_torch.training import denoise

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)
BF16_RTOL = 1e-2


def _imgs(k, seed=0):
    return np.random.default_rng(seed).standard_normal((k, 3, 16, 16)).astype(np.float32)


def _tree(seed=0):
    """A tree of every kind of leaf the model's has: grouped nets (one level
    much smaller than the others, one all-zero output channel), a patch
    embedding and decoder matrix, their biases, the embeddings, and an int
    leaf."""
    rng = np.random.default_rng(seed)
    w1 = rng.standard_normal((3, 32, 64)).astype(np.float32)
    w1[1] *= 0.01
    w1[2, :, 5] = 0.0
    return {"glom": {"bottom_up": {"w1": w1, "b1": rng.standard_normal((3, 64), np.float32),
                                   "w2": rng.standard_normal((3, 64, 32), np.float32),
                                   "b2": rng.standard_normal((3, 32), np.float32)},
                     "patch_embed": {"w": rng.standard_normal((48, 32), np.float32),
                                     "b": rng.standard_normal((32,), np.float32)},
                     "pos_emb": rng.standard_normal((16, 32), np.float32),
                     "init_levels": rng.standard_normal((3, 32), np.float32)},
            "decoder": {"w": rng.standard_normal((32, 48), np.float32)},
            "count": np.int32(3)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _as_np(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.float().numpy() if leaf.is_floating_point() else leaf.numpy()
    arr = np.asarray(leaf)
    return arr.astype(np.float32) if arr.dtype == jnp.bfloat16 else arr


def _same_trees(ours, theirs):
    a, b = _flat(ours), _flat(theirs)
    assert sorted(a) == sorted(b)
    for key in a:
        x, y = _as_np(a[key]), _as_np(b[key])
        assert x.dtype == y.dtype and x.shape == y.shape, key
        assert np.array_equal(x, y), key


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_modes_and_thresholds_are_glom_tpus():
    assert quant.QUANT_MODES == jax_quant.QUANT_MODES
    assert quant.ACCURACY_THRESHOLDS == jax_quant.ACCURACY_THRESHOLDS


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_quantize_tree_is_bitwise_glom_tpus(mode):
    tree = _tree()
    ours, theirs = quant.quantize_tree(tree, mode), jax_quant.quantize_tree(tree, mode)
    _same_trees(ours, theirs)
    if mode == "int8":
        w1 = ours["glom"]["bottom_up"]["w1"]
        assert w1["int8_q"].dtype == torch.int8 and tuple(w1["int8_scale"].shape) == (3, 1, 64)
        assert ours["glom"]["pos_emb"].dtype == torch.bfloat16   # embeddings stay bf16
        assert ours["glom"]["bottom_up"]["b1"].dtype == torch.bfloat16
        # the zero channel gets a unit scale and zero codes
        assert float(w1["int8_scale"][2, 0, 5]) == 1.0 and not w1["int8_q"][2, :, 5].any()
    assert int(ours["count"]) == 3


def test_int8_of_bf16_parameters_is_bitwise_glom_tpus():
    """A checkpoint in bf16: the port's leaves are bf16 tensors, glom_tpu's
    ml_dtypes arrays; both quantize, to the same codes."""
    tree = _tree(1)["glom"]["bottom_up"]
    ours = quant.quantize_tree({k: torch.from_numpy(v).to(torch.bfloat16)
                                for k, v in tree.items()}, "int8")
    theirs = jax_quant.quantize_tree({k: np.asarray(v, jnp.bfloat16) for k, v in tree.items()},
                                     "int8")
    assert ours["w1"]["int8_q"].dtype == torch.int8
    _same_trees(ours, theirs)


def test_dequantize_tree_is_bitwise_glom_tpus():
    tree = _tree(2)
    ours = quant.dequantize_tree(quant.quantize_tree(tree, "int8"))
    theirs = jax.jit(jax_quant.dequantize_tree)(jax_quant.quantize_tree(tree, "int8"))
    _same_trees(ours, theirs)
    assert ours["glom"]["bottom_up"]["w1"].dtype == torch.bfloat16


def test_f32_identity_and_unknown_mode():
    tree = _tree()
    assert quant.quantize_tree(tree, "f32") is tree
    with pytest.raises(ValueError, match="unknown quant mode"):
        quant.quantize_tree(tree, "fp4")


def test_quantized_forward_passes_the_state_through():
    seen = {}

    def fn(params, imgs, levels):
        seen.update(params=params, levels=levels)
        return imgs

    levels = torch.ones(2, 3)
    q = quant.quantize_tree({"w": np.ones((4, 4), np.float32)}, "int8")
    quant.quantized_forward(fn, "int8")(q, torch.zeros(1), levels)
    assert seen["levels"] is levels and seen["params"]["w"].dtype == torch.bfloat16
    assert quant.quantized_forward(fn, "f32") is fn


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("quant_ckpt"))
    jax_make_demo_checkpoint(d, config=jax_config.GlomConfig(**TINY))
    return d


@pytest.fixture(scope="module", params=["bf16", "int8"])
def engines(request, ckpt):
    mode = request.param
    ours = ServingEngine(ckpt, device="cpu", buckets=(2,), reload_poll_s=0, quant=mode)
    theirs = JaxServingEngine(ckpt, buckets=(2,), warmup=False, reload_poll_s=0, quant=mode,
                              quality_sample=0)
    yield mode, ours, theirs
    ours.shutdown(drain=False)
    theirs.shutdown(drain=False)


@pytest.mark.parametrize("endpoint", ["embed", "reconstruct"])
def test_endpoints_agree_with_glom_tpus_engine(engines, endpoint):
    mode, ours, theirs = engines
    x = _imgs(2, seed=3)
    got = ours.run(endpoint, x)
    want = np.asarray(theirs.caches[endpoint](theirs.params, x), np.float32)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _rel(got, want) <= BF16_RTOL, (mode, endpoint)
    assert ours.health()["quant"] == mode


def test_resident_bytes_and_the_kernels_dtype_rule(ckpt):
    """f32 > bf16 > int8 resident bytes, counted leaf by leaf; under int8
    every weight and bias reaches the forward as bf16 (the kernels take a
    weight only in the activation's dtype)."""
    sizes = {}
    for mode in ("f32", "bf16", "int8"):
        eng = ServingEngine(ckpt, device="cpu", buckets=(1,), reload_poll_s=0, quant=mode,
                            warmup=False)
        sizes[mode] = eng.param_bytes()
        if mode == "int8":
            glom = quant.dequantize_tree(eng.params)["glom"]
            assert {leaf.dtype for net in ("bottom_up", "top_down")
                    for leaf in glom[net].values()} == {torch.bfloat16}
    n = sizes["f32"] // 4
    assert sizes["bf16"] == 2 * n and sizes["f32"] > sizes["bf16"] > sizes["int8"]


def test_a_reload_requantizes(tmp_path):
    from glom_tpu_torch.config import GlomConfig
    from glom_tpu_torch.serving.engine import make_demo_checkpoint

    d = str(tmp_path)
    make_demo_checkpoint(d, config=GlomConfig(**TINY), seed=0)
    eng = ServingEngine(d, device="cpu", buckets=(2,), reload_poll_s=0, quant="int8")
    make_demo_checkpoint(d, config=GlomConfig(**TINY), seed=1, step=1)
    assert eng.check_reload() and eng.step == 1
    assert eng.params["glom"]["bottom_up"]["w1"]["int8_q"].dtype == torch.int8
    fresh = ServingEngine(d, device="cpu", buckets=(2,), reload_poll_s=0, quant="int8")
    x = _imgs(2, seed=4)
    assert np.array_equal(eng.run("embed", x), fresh.run("embed", x))


def test_unknown_quant_is_refused(ckpt):
    with pytest.raises(ValueError, match="unknown quant mode"):
        ServingEngine(ckpt, device="cpu", quant="fp4", warmup=False)


def test_accuracy_report_passes_and_agrees_with_glom_tpus(ckpt):
    _, config, train_cfg, params = denoise.load_checkpoint_state(ckpt, device="cpu")
    x = _imgs(3, seed=5)
    ours = quant.accuracy_report(config, train_cfg, params, x, device="cpu")
    jax_cfg = jax_config.GlomConfig(**TINY)
    _, _, jax_train, jax_params = jax_denoise.load_checkpoint_state(ckpt)
    theirs = jax_quant.accuracy_report(jax_cfg, jax_train, jax_params, x)
    for mode in ("bf16", "int8"):
        assert ours[mode]["pass"] and theirs[mode]["pass"]
        assert sorted(ours[mode]["embed"]) == sorted(theirs[mode]["embed"])
        assert ours[mode]["thresholds"] == theirs[mode]["thresholds"]


def test_quant_check_cli_exit_codes(ckpt, capsys, monkeypatch):
    assert quant_check.main(["--checkpoint-dir", ckpt, "--device", "cpu", "--batch", "2"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["pass"] and set(report["modes"]) == {"bf16", "int8"}
    # a mode that misses its threshold fails the gate, as glom_tpu's does
    monkeypatch.setitem(quant.ACCURACY_THRESHOLDS, "int8", {"cosine": 1.5, "max_abs_rel": 0.1})
    assert quant_check.main(["--checkpoint-dir", ckpt, "--device", "cpu", "--batch", "2",
                             "--modes", "int8"]) == 1
    assert json.loads(capsys.readouterr().out)["pass"] is False
    with pytest.raises(SystemExit) as e:
        quant_check.main(["--demo", "--platform", "cpu"])
    assert e.value.code == 2
    assert ckpt_lib.latest_step(ckpt) == 0
