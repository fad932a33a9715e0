"""The port's plain ops (glom_tpu_torch.ops) against glom_tpu's on the CPU.

Same numpy inputs through both packages; float32 throughout.  Tolerance
1e-5 absolute for one op: the two differ only in summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glom_tpu.ops import consensus as jax_consensus
from glom_tpu.ops import feedforward as jax_ff
from glom_tpu.ops import masks as jax_masks
from glom_tpu.ops import patch as jax_patch
from glom_tpu_torch.ops import consensus, feedforward, masks, patch

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

ATOL = 1e-5


def _ff_params(rng, g, d, h):
    return {
        "w1": rng.uniform(-d ** -0.5, d ** -0.5, (g, d, h)).astype(np.float32),
        "b1": rng.uniform(-d ** -0.5, d ** -0.5, (g, h)).astype(np.float32),
        "w2": rng.uniform(-h ** -0.5, h ** -0.5, (g, h, d)).astype(np.float32),
        "b2": rng.uniform(-h ** -0.5, h ** -0.5, (g, d)).astype(np.float32),
    }


def test_patchify_round_trip_and_order():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    patches = patch.patchify(torch.from_numpy(img), 4)
    assert patches.shape == (2, 16, 48)
    # the (p1 p2 c) feature order of the JAX package, bit for bit
    np.testing.assert_array_equal(patches.numpy(), np.asarray(jax_patch.patchify(jnp.asarray(img), 4)))
    back = patch.unpatchify(patches, 4, 16, 3)
    np.testing.assert_array_equal(back.numpy(), img)


def test_patch_embed_apply_matches():
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    p = {"w": rng.standard_normal((48, 32)).astype(np.float32),
         "b": rng.standard_normal((32,)).astype(np.float32)}
    want = jax_patch.patch_embed_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(img), 4)
    got = patch.patch_embed_apply({k: torch.from_numpy(v) for k, v in p.items()},
                                  torch.from_numpy(img), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("side,radius", [(4, 1.5), (5, 2.0), (16, 2.0), (3, 0.5)])
def test_local_consensus_mask_matches(side, radius):
    np.testing.assert_array_equal(masks.local_consensus_mask(side, radius),
                                  jax_masks.local_consensus_mask(side, radius))


def test_grouped_ff_plain_matches():
    rng = np.random.default_rng(2)
    p = _ff_params(rng, 3, 32, 128)
    x = rng.standard_normal((2, 16, 3, 32)).astype(np.float32)
    want = jax_ff.grouped_ff_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = feedforward.grouped_ff_apply({k: torch.from_numpy(v) for k, v in p.items()},
                                       torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_grouped_ff_plain_keeps_bf16_and_computes_f32():
    rng = np.random.default_rng(3)
    p = {k: torch.from_numpy(v).bfloat16() for k, v in _ff_params(rng, 2, 32, 64).items()}
    x = torch.from_numpy(rng.standard_normal((1, 4, 2, 32)).astype(np.float32)).bfloat16()
    got = feedforward.grouped_ff_apply(p, x)
    assert got.dtype == torch.bfloat16
    want = feedforward.grouped_ff_apply({k: v.float() for k, v in p.items()}, x.float())
    # one rounding of the float32 result to bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.bfloat16().float().numpy(), atol=0)


@pytest.mark.parametrize("attend_self", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_consensus_plain_matches(attend_self, use_mask):
    rng = np.random.default_rng(4)
    levels = rng.standard_normal((2, 16, 3, 32)).astype(np.float32)
    mask = masks.local_consensus_mask(4, 1.5) if use_mask else None
    want = jax_consensus.consensus_attention(
        jnp.asarray(levels), attend_self=attend_self,
        non_local_mask=None if mask is None else jnp.asarray(mask))
    got, lse = consensus.consensus_attention(
        torch.from_numpy(levels), attend_self=attend_self,
        non_local_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert lse.shape == (2, 3, 16, 1) and lse.dtype == torch.float32


def test_soft_self_mask_is_a_logit_not_minus_inf():
    # two identical columns: with the soft self-mask each still weighs itself
    levels = torch.ones((1, 2, 1, 4))
    out, lse = consensus.consensus_attention(levels)
    d = 4
    s = torch.tensor([consensus.TOKEN_ATTEND_SELF_VALUE, d ** -0.5 * 2.0])
    np.testing.assert_allclose(lse[0, 0, 0, 0].item(), torch.logsumexp(s, 0).item(), rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), levels.numpy(), rtol=1e-6)


def test_l2_normalize_eps_on_the_norm():
    x = torch.tensor([[0.0, 0.0], [3.0, 4.0]])
    got = consensus.l2_normalize(x)
    np.testing.assert_allclose(got.numpy(), [[0.0, 0.0], [0.6, 0.8]], rtol=1e-7)
    want = jax_consensus.l2_normalize(jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0)
