"""GLOM's part-whole read-out in the port (glom_tpu_torch.models.islands,
glom_tpu_torch.obs.quality, glom_tpu_torch.hierarchy.parse) against
glom_tpu's on the CPU.

The same seeded numpy states go through both packages.  Float32.  The
agreement maps and the packed means 1e-6 absolute (a cosine of unit vectors
and a mean of O(1) values, summed in other orders); the labels, island
counts and sizes bitwise; the index forward 1e-5 absolute (``make_index_fn``
runs the whole forward, 6 iterations).  Where a labelling is compared
across the packages, each level's threshold sits midway between two
neighbouring agreement values, so that no cell lies within rounding of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glom_tpu import config as jax_config
from glom_tpu.hierarchy import parse as jax_parse
from glom_tpu.models import islands as jax_islands
from glom_tpu.obs import quality as jax_quality
from glom_tpu_torch import convert
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.hierarchy import parse
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.models import islands
from glom_tpu_torch.obs import quality
from glom_tpu_torch.serving.engine import demo_params

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)
SIDE = 4
AGREE_ATOL = 1e-6
MEAN_ATOL = 1e-6
FWD_ATOL = 1e-5


def _levels(b=2, seed=0, side=SIDE, L=3, d=32):
    """A state with structure: a few smooth fields plus noise, so that the
    agreement maps hold islands of several sizes."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((b, 1, L, d)).astype(np.float32)
    field = rng.standard_normal((b, side * side, L, d)).astype(np.float32)
    return (base + 0.8 * field).astype(np.float32)


def _split_thresholds(agree: np.ndarray, q: float = 0.5) -> tuple:
    """Per level, midway between the two agreement values around the
    ``q`` quantile of that level's cells (all images)."""
    out = []
    for lv in range(agree.shape[1]):
        vals = np.sort(agree[:, lv].ravel())
        i = min(max(int(q * len(vals)), 1), len(vals) - 1)
        assert vals[i] - vals[i - 1] > 1e-5
        out.append(float(np.float32((vals[i] + vals[i - 1]) / 2)))
    return tuple(out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_neighbor_agreement_and_agreement_maps_match(dtype):
    levels = _levels()
    jl = jnp.asarray(levels).astype(dtype)
    tl = torch.from_numpy(levels).to(getattr(torch, dtype))
    want = np.asarray(jax_islands.neighbor_agreement(jl.astype(jnp.float32), SIDE))
    got = islands.neighbor_agreement(tl.float(), SIDE).numpy()
    assert got.shape == (2, 3, SIDE, SIDE)
    np.testing.assert_allclose(got, want, atol=AGREE_ATOL)
    w32, wagree = jax_quality.agreement_maps(jl, SIDE)
    g32, gagree = quality.agreement_maps(tl, SIDE)
    assert g32.dtype == torch.float32
    np.testing.assert_array_equal(g32.numpy(), np.asarray(w32))
    np.testing.assert_allclose(gagree.numpy(), np.asarray(wagree), atol=AGREE_ATOL)
    log_n = float(np.log(SIDE * SIDE))
    for g, w in zip(quality.agreement_stats(gagree, log_n),
                    jax_quality.agreement_stats(wagree, log_n)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=AGREE_ATOL)


def test_neighbor_agreement_identical_columns_and_the_grid_check():
    maps = islands.neighbor_agreement(torch.ones(1, 16, 2, 8), 4)
    np.testing.assert_allclose(maps.numpy(), 1.0, rtol=1e-6)
    with pytest.raises(ValueError, match="not"):
        islands.neighbor_agreement(torch.zeros(1, 15, 2, 8), 4)


def test_label_islands_and_island_summary_equal_glom_tpu():
    rng = np.random.default_rng(5)
    for side in (1, 3, 6):
        agree = rng.uniform(-1, 1, (side, side))
        for thr in (-0.5, 0.0, 0.4):
            got, want = islands.label_islands(agree, thr), jax_islands.label_islands(agree, thr)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    stack = _levels(b=1, seed=2)[None].repeat(3, axis=0)
    stack[1:] += np.random.default_rng(3).standard_normal(stack[1:].shape).astype(np.float32)
    got = islands.island_summary(torch.from_numpy(stack), SIDE, threshold=0.3)
    want = jax_islands.island_summary(jnp.asarray(stack), SIDE, threshold=0.3)
    assert got["num_islands"].shape == (3, 3)
    np.testing.assert_allclose(got["mean_agreement"], want["mean_agreement"], atol=AGREE_ATOL)
    np.testing.assert_array_equal(got["num_islands"], want["num_islands"])


@pytest.mark.parametrize("side", range(1, 9))
def test_island_labels_bitwise_against_the_flood_fill(side):
    """The fixed-trip propagation, batched over 24 random masks at once,
    gives glom_tpu's host flood fill's labels and counts exactly."""
    rng = np.random.default_rng(100 + side)
    agree = rng.uniform(-1.0, 1.0, (24, side, side))
    thr = rng.uniform(-0.9, 0.9, (24,))
    mask = agree >= thr[:, None, None]
    labels, count = parse._island_labels(torch.from_numpy(mask), side)
    assert labels.dtype == count.dtype == torch.int32
    for i in range(24):
        want, sizes = jax_islands.label_islands(agree[i], float(thr[i]))
        np.testing.assert_array_equal(labels[i].numpy(), want, err_msg=f"trial {i}")
        assert int(count[i]) == len(sizes)


@pytest.mark.parametrize("case", ["empty", "full", "diagonal"])
def test_island_labels_degenerate_masks(case):
    mask = {"empty": np.zeros((3, 3), bool), "full": np.ones((4, 4), bool),
            "diagonal": np.eye(3, dtype=bool)}[case]
    labels, count = parse._island_labels(torch.from_numpy(mask), mask.shape[0])
    want, sizes = jax_islands.label_islands(mask.astype(np.float32), 0.5)
    np.testing.assert_array_equal(labels.numpy(), want)
    assert int(count) == len(sizes) == {"empty": 0, "full": 1, "diagonal": 3}[case]


def _unpacked(rows, levels, dim):
    return [parse.unpack_parse(r, levels, SIDE, dim) for r in np.asarray(rows)]


@pytest.mark.parametrize("q", [0.3, 0.5, 0.7])
def test_pack_rows_match_glom_tpu(q):
    cfg = GlomConfig(**TINY)
    ref = jax_config.GlomConfig(**TINY)
    levels = _levels(b=3, seed=int(q * 10))
    agree = quality.agreement_maps(torch.from_numpy(levels), SIDE)[1].numpy()
    thr = _split_thresholds(agree, q)
    got = parse.make_pack_fn(cfg, thr)(torch.from_numpy(levels)).numpy()
    want = np.asarray(jax_parse.make_pack_fn(ref, thr)(jnp.asarray(levels)))
    width = parse.parse_row_width(3, SIDE, 32)
    assert got.shape == want.shape == (3, width) and got.dtype == np.float32
    n, L = SIDE * SIDE, 3
    exact = L * (n + 1 + n)          # labels, counts and sizes: bitwise
    np.testing.assert_array_equal(got[:, :exact], want[:, :exact])
    np.testing.assert_allclose(got[:, exact:], want[:, exact:], atol=MEAN_ATOL)
    counts = got[:, L * n:L * n + L]
    assert counts.max() > 1          # the masks are neither empty nor one island
    # the means against a float64 segment mean of the same labels
    for i, per_level in enumerate(_unpacked(got, L, 32)):
        for lv, isl in enumerate(per_level):
            lab = np.asarray(isl["labels"]).ravel()
            for k in range(isl["num_islands"]):
                cells = levels[i, lab == k + 1, lv].astype(np.float64)
                assert isl["sizes"][k] == len(cells)
                np.testing.assert_allclose(isl["means"][k], cells.mean(0), atol=MEAN_ATOL)


def test_pack_takes_a_bfloat16_state_and_checks_its_thresholds():
    cfg = GlomConfig(**TINY)
    levels = torch.from_numpy(_levels()).bfloat16()
    rows = parse.make_pack_fn(cfg, (0.0, 0.0, 0.0))(levels)
    want = parse.make_pack_fn(cfg, (0.0, 0.0, 0.0))(levels.float())
    assert torch.equal(rows, want)
    with pytest.raises(ValueError, match="2 thresholds for 3 levels"):
        parse.make_pack_fn(cfg, (0.1, 0.2))
    assert parse._make_packer is parse.make_pack_fn


@pytest.mark.parametrize("spec, levels, want", [
    (None, 3, (parse.DEFAULT_THRESHOLD,) * 3),
    (0.5, 3, (0.5, 0.5, 0.5)),
    ("0.85", 2, (0.85, 0.85)),
    ("0.95, 0.9, 0.8", 3, (0.95, 0.9, 0.8)),
    ([0.1, 0.2], 2, (0.1, 0.2)),
    ("0.9,0.8", 3, "values for"),
    (1.5, 2, "cosine range"),
    ("hot,cold", 2, "bad threshold"),
    (" , ", 2, "empty"),
])
def test_threshold_grammar(spec, levels, want):
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            parse.parse_thresholds(spec, levels)
        with pytest.raises(ValueError, match=want):
            jax_parse.parse_thresholds(spec, levels)
    else:
        assert parse.parse_thresholds(spec, levels) == want
        assert jax_parse.parse_thresholds(spec, levels) == want
    assert parse.DEFAULT_THRESHOLD == jax_parse.DEFAULT_THRESHOLD


def test_unpack_round_trip_at_the_threshold_floor():
    """Threshold -1 puts every patch above it: one island a level covering
    the grid, whose mean is the plain patch mean."""
    cfg = GlomConfig(**TINY)
    levels = _levels(seed=3)
    rows = parse.make_pack_fn(cfg, (-1.0,) * 3)(torch.from_numpy(levels)).numpy()
    assert parse.parse_row_width(3, 2, 16) == 3 * (4 + 1 + 4 + 4 * 16)
    for i, per_level in enumerate(_unpacked(rows, 3, 32)):
        assert per_level == jax_parse.unpack_parse(rows[i], 3, SIDE, 32)
        for lv, isl in enumerate(per_level):
            assert isl["num_islands"] == 1 and isl["sizes"] == [SIDE * SIDE]
            assert isl["labels"] == np.ones((SIDE, SIDE), int).tolist()
            np.testing.assert_allclose(isl["means"][0], levels[i, :, lv].mean(0), rtol=1e-5,
                                       atol=1e-6)
    with pytest.raises(ValueError, match="columns"):
        parse.unpack_parse(np.zeros(7, np.float32), 3, 2, 16)


def _grid(rows):
    return np.asarray([rows], np.int32)


@pytest.mark.parametrize("case", ["cold", "stable", "moved", "appeared_vanished", "levels"])
def test_island_deltas(case):
    prev, cur, want = {
        "cold": (None, _grid([[1, 1, 0], [0, 2, 2], [0, 0, 0]]),
                 [{"appeared": [1, 2], "vanished": [], "moved": [], "stable": []}]),
        "stable": (_grid([[1, 1], [0, 2]]), _grid([[1, 1], [0, 2]]),
                   [{"appeared": [], "vanished": [], "moved": [], "stable": [1, 2]}]),
        "moved": (_grid([[1, 1, 0], [0, 0, 0], [0, 0, 0]]), _grid([[0, 1, 1], [0, 0, 0], [0, 0, 0]]),
                  [{"appeared": [], "vanished": [], "moved": [1], "stable": []}]),
        "appeared_vanished": (_grid([[1, 1], [0, 0]]), _grid([[0, 0], [1, 1]]),
                              [{"appeared": [1], "vanished": [1], "moved": [], "stable": []}]),
        "levels": (np.stack([np.array([[1, 1], [0, 0]], np.int32),
                             np.array([[1, 1], [1, 1]], np.int32)]),
                   np.stack([np.array([[1, 1], [0, 0]], np.int32),
                             np.array([[0, 0], [0, 0]], np.int32)]),
                   [{"appeared": [], "vanished": [], "moved": [], "stable": [1]},
                    {"appeared": [], "vanished": [1], "moved": [], "stable": []}]),
    }[case]
    assert parse.island_deltas(prev, cur) == want == jax_parse.island_deltas(prev, cur)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_index_fn_matches_glom_tpu(dtype):
    """The index forward through the port's kernels' path, cast to float32
    in the function whatever the compute dtype."""
    bf16 = dtype == "bfloat16"
    cfg = GlomConfig(**TINY, ff_impl="pallas", attention_impl="pallas",
                     compute_dtype="bfloat16" if bf16 else None)
    ref = jax_config.GlomConfig(**TINY, compute_dtype=jnp.bfloat16 if bf16 else None)
    tree = demo_params(cfg, TrainConfig(), 1)
    imgs = np.random.default_rng(4).standard_normal((2, 3, 16, 16)).astype(np.float32)
    want = np.asarray(jax_parse.make_index_fn(ref, None)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(imgs)))
    with torch.inference_mode():
        got = parse.make_index_fn(cfg, None)(convert.params_from_numpy(tree, cfg, "cpu"),
                                             torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    if bf16:
        # the frameworks round bfloat16 at other places: a few of its roundings
        diff = np.abs(got.numpy() - want)
        assert (diff <= 1e-2 * (1 + np.abs(want))).all()
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL)
    with torch.inference_mode():
        plain = glom_model.apply(convert.params_from_numpy(tree, cfg, "cpu")["glom"],
                                 torch.from_numpy(imgs), config=cfg)
    assert torch.equal(got, plain.float())
