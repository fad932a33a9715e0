"""The port's kernel wrappers (glom_tpu_torch.kernels).

On the CPU a wrapper takes its kernel's plain version; these tests hold that
against glom_tpu's Pallas kernels run in interpret mode, forward and
backward (float32, 1e-5 absolute: one op, summation order only), and the
autograd Functions against ``jax.vjp`` of the Pallas custom VJPs.  The tests
marked ``gpu`` hold each CUDA kernel against its plain version on the card,
in float32 and bfloat16; without a card they skip.  They import no JAX, so on the GPU machine (which
has none) they run alone:

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

from glom_tpu_torch.kernels import _build
from glom_tpu_torch.kernels import _common
from glom_tpu_torch.kernels import consensus as consensus_kernel
from glom_tpu_torch.kernels import ff as ff_kernel
from glom_tpu_torch.ops import consensus as plain_consensus
from glom_tpu_torch.ops import feedforward as plain_ff
from glom_tpu_torch.ops.masks import local_consensus_mask

ATOL = 1e-5
# On the card each kernel is held against its plain version computed in
# float32 on the same inputs, with limits scaled to the output:
# ||got - want|| <= GPU_RTOL ||want|| and, element by element,
# |got - want| <= GPU_RTOL (min(1, max|want|) + |want|).  float32 differs by
# summation order; a bfloat16 output is rounded once (2**-8 relative).
GPU_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _ff_params(rng, g, d, h):
    return {
        "w1": rng.uniform(-d ** -0.5, d ** -0.5, (g, d, h)).astype(np.float32),
        "b1": rng.uniform(-d ** -0.5, d ** -0.5, (g, h)).astype(np.float32),
        "w2": rng.uniform(-h ** -0.5, h ** -0.5, (g, h, d)).astype(np.float32),
        "b2": rng.uniform(-h ** -0.5, h ** -0.5, (g, d)).astype(np.float32),
    }


def _torch(tree, device="cpu", dtype=torch.float32):
    return {k: torch.from_numpy(v).to(device=device, dtype=dtype) for k, v in tree.items()}


# -- CPU: the wrappers' plain path against the Pallas kernels ----------------

@pytest.mark.parametrize("strided", [False, True])
def test_grouped_ff_matches_pallas(strided):
    import jax.numpy as jnp

    from glom_tpu.kernels.ff_pallas import grouped_ff_pallas

    rng = np.random.default_rng(0)
    p = _ff_params(rng, 3, 32, 128)
    # the bottom-up input is a strided view of the (b, n, L+1, d) state
    full = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    x = full[..., :-1, :] if strided else np.ascontiguousarray(full[..., 1:, :])
    want = grouped_ff_pallas({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(np.ascontiguousarray(x)), interpret=True)
    xt = torch.from_numpy(full)[..., :-1, :] if strided else torch.from_numpy(x)
    with torch.inference_mode():
        got = ff_kernel.grouped_ff(_torch(p), xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("attend_self", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("kv_block", [None, 8])
def test_consensus_matches_pallas_out_and_lse(attend_self, use_mask, kv_block):
    """kv_block=None: the K/V-resident kernel (K4); 8: the streamed one (K5)."""
    import jax.numpy as jnp

    from glom_tpu.kernels import consensus_pallas

    rng = np.random.default_rng(1)
    levels = rng.standard_normal((2, 16, 3, 32)).astype(np.float32)
    mask = local_consensus_mask(4, 1.5) if use_mask else None
    mask_i8 = None if mask is None else jnp.asarray(mask.astype(np.int8))
    # kv_block routes to _forward_blocked, its absence (n <= 1024) to _forward
    want, want_lse = consensus_pallas._dispatch(
        jnp.asarray(levels), mask_i8, attend_self, True, kv_block)
    with torch.inference_mode():
        got, lse = consensus_kernel.consensus_attention(
            torch.from_numpy(levels), attend_self=attend_self,
            non_local_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL)


def _ff_case(strided, seed=5):
    rng = np.random.default_rng(seed)
    p = _ff_params(rng, 3, 32, 128)
    full = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    x = full[..., :-1, :] if strided else np.ascontiguousarray(full[..., 1:, :])
    g = rng.standard_normal(x.shape).astype(np.float32)
    xt = torch.from_numpy(full)[..., :-1, :] if strided else torch.from_numpy(x)
    return p, x, xt, g


def _jnp(tree):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("strided", [False, True])
def test_grouped_ff_backward_matches_pallas(strided):
    """The plain K2 (dX) and K3 (dW, on the hidden K2 hands it) against
    _backward_fused's two kernels."""
    import jax.numpy as jnp

    from glom_tpu.kernels.ff_pallas import _backward_fused

    p, x, xt, g = _ff_case(strided)
    want_dx, want = _backward_fused(jnp.asarray(np.ascontiguousarray(x)), _jnp(p),
                                    jnp.asarray(g), interpret=True)
    gt = torch.from_numpy(g)
    dx, hidden = ff_kernel.grouped_ff_dx(_torch(p), xt, gt, keep_hidden=True)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=ATOL)
    np.testing.assert_array_equal(dx.numpy(), ff_kernel.grouped_ff_dx(_torch(p), xt, gt).numpy())
    dw1, db1, dw2 = ff_kernel.grouped_ff_dw(_torch(p), xt, gt, hidden)
    for name, got in (("w1", dw1), ("b1", db1), ("w2", dw2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want[name]), atol=ATOL, err_msg=name)
    _, dp = ff_kernel.grouped_ff_backward(_torch(p), xt, gt)
    np.testing.assert_allclose(dp["b2"].numpy(), np.asarray(want["b2"]), atol=ATOL)


def _ff_case_hidden(strided, dtype=torch.float32, seed=16):
    """Seeded inputs at d=32, h=64, g=3 (the bottom-up view of a (2, 16, 4,
    32) state, or a contiguous copy), in ``dtype``: ``(p, x, g)`` as numpy
    float32 (values exact in ``dtype``) and ``(pt, xt, gt)`` as tensors."""
    rng = np.random.default_rng(seed)
    cut = lambda a: torch.from_numpy(a.astype(np.float32)).to(dtype)
    p = {k: cut(v) for k, v in _ff_params(rng, 3, 32, 64).items()}
    full = cut(rng.standard_normal((2, 16, 4, 32)))
    xt = full[..., :-1, :] if strided else full[..., 1:, :].contiguous()
    gt = cut(rng.standard_normal((2, 16, 3, 32)))
    as_np = lambda t: t.float().numpy()
    return ({k: as_np(v) for k, v in p.items()}, np.ascontiguousarray(as_np(xt)), as_np(gt),
            p, xt, gt)


@pytest.mark.parametrize("strided", [False, True])
def test_grouped_ff_backward_hands_k3_the_hidden(strided):
    """grouped_ff_backward on CPU tensors: the plain twin of the hidden K2
    hands K3, and K3's plain products on it, against jax.vjp of the fused
    Pallas backward in interpret mode (1e-5) and against the reference
    plain.grouped_ff_dw, which recomputes the hidden (1e-6)."""
    import jax

    from glom_tpu.kernels.ff_pallas import grouped_ff_pallas

    p, x, g, pt, xt, gt = _ff_case_hidden(strided)
    _, vjp = jax.vjp(lambda x_, p_: grouped_ff_pallas(p_, x_, interpret=True, fused_bwd=True),
                     x, _jnp(p))
    want_dx, want = vjp(g)
    hid, dh = plain_ff.grouped_ff_hidden(pt, xt, gt)
    assert hid.shape == dh.shape == (3, 32, 64) and hid.dtype == dh.dtype == torch.float32
    dx, got = ff_kernel.grouped_ff_backward(pt, xt, gt)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=ATOL)
    ref = plain_ff.grouped_ff_dw(pt, xt, gt)
    for k, r in zip(("w1", "b1", "w2"), ref):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), r.numpy(), atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["b2"].numpy(), np.asarray(want["b2"]), atol=ATOL)
    for k, r in zip(("w1", "b1", "w2"),
                    plain_ff.grouped_ff_dw_from_hidden(xt, gt, hid, dh, torch.float32)):
        np.testing.assert_allclose(got[k].numpy(), r.numpy(), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("strided", [False, True])
def test_grouped_ff_backward_hands_k3_the_hidden_bf16(strided):
    """The same in bfloat16 (inputs, weights and cotangent): within one
    bfloat16 rounding (2**-8 of the largest value) of jax.vjp of the fused
    Pallas backward, and of the reference plain.grouped_ff_dw."""
    import jax
    import jax.numpy as jnp

    from glom_tpu.kernels.ff_pallas import grouped_ff_pallas

    p, x, g, pt, xt, gt = _ff_case_hidden(strided, torch.bfloat16, seed=17)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    _, vjp = jax.vjp(lambda x_, p_: grouped_ff_pallas(p_, x_, interpret=True, fused_bwd=True),
                     bf(x), {k: bf(v) for k, v in p.items()})
    want_dx, want = vjp(bf(g))
    dx, got = ff_kernel.grouped_ff_backward(pt, xt, gt)
    ref = dict(zip(("w1", "b1", "w2"), plain_ff.grouped_ff_dw(pt, xt, gt)))
    pairs = [("x", dx, want_dx)] + [(k, got[k], want[k]) for k in ("w1", "b1", "w2", "b2")]
    pairs += [(k + " (plain)", got[k], ref[k]) for k in ref]
    for name, a, w in pairs:
        assert a.dtype == torch.bfloat16, name
        w = np.asarray(w.float() if isinstance(w, torch.Tensor) else w, np.float32)
        np.testing.assert_allclose(a.float().numpy(), w, rtol=0,
                                   atol=2.0 ** -8 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("fused_bwd", [True, False])
def test_grouped_ff_autograd_matches_jax_vjp(fused_bwd):
    """The autograd Function (K1 forward; K2 + K3 or the plain VJP backward)
    against jax.vjp of grouped_ff_pallas with the same fused_bwd."""
    import jax

    from glom_tpu.kernels.ff_pallas import grouped_ff_pallas

    p, x, _, g = _ff_case(True, seed=6)
    _, vjp = jax.vjp(lambda x_, p_: grouped_ff_pallas(p_, x_, interpret=True, fused_bwd=fused_bwd),
                     np.ascontiguousarray(x), _jnp(p))
    want_dx, want = vjp(g)
    # the strided bottom-up view of a state that requires grad
    full = torch.zeros((2, 16, 4, 32))
    full[..., :-1, :] = torch.from_numpy(x)
    full.requires_grad_(True)
    pg = {k: v.requires_grad_(True) for k, v in _torch(p).items()}
    ff_kernel.grouped_ff(pg, full[..., :-1, :], fused_bwd=fused_bwd).backward(torch.from_numpy(g))
    np.testing.assert_allclose(full.grad[..., :-1, :].numpy(), np.asarray(want_dx), atol=ATOL)
    assert not full.grad[..., -1, :].any()
    for k in pg:
        np.testing.assert_allclose(pg[k].grad.numpy(), np.asarray(want[k]), atol=ATOL, err_msg=k)


def _consensus_case(attend_self, use_mask, seed=7):
    import jax.numpy as jnp

    from glom_tpu.kernels import consensus_pallas

    rng = np.random.default_rng(seed)
    levels = rng.standard_normal((2, 16, 3, 32)).astype(np.float32)
    g = rng.standard_normal(levels.shape).astype(np.float32)
    mask = local_consensus_mask(4, 1.5) if use_mask else None
    mask_i8 = None if mask is None else jnp.asarray(mask.astype(np.int8))
    out, lse = consensus_pallas._dispatch(jnp.asarray(levels), mask_i8, attend_self, True, None)
    return levels, g, mask, mask_i8, out, lse


@pytest.mark.parametrize("attend_self", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_consensus_backward_matches_pallas(attend_self, use_mask):
    """The plain K6 (dKV) + K7 (dQ) against _backward_flash's two kernels; K7
    alone against the gradient through the queries only."""
    import jax
    import jax.numpy as jnp

    from glom_tpu.kernels import consensus_pallas

    levels, g, mask, mask_i8, out, lse = _consensus_case(attend_self, use_mask)
    want = consensus_pallas._backward_flash(jnp.asarray(levels), mask_i8, out, lse,
                                            jnp.asarray(g), attend_self=attend_self,
                                            interpret=True)
    lt, gt = torch.from_numpy(levels), torch.from_numpy(g)
    mt = None if mask is None else torch.from_numpy(mask)
    _, lse_t = plain_consensus.consensus_attention(lt, attend_self=attend_self, non_local_mask=mt)
    delta = (gt * torch.from_numpy(np.array(out))).sum(-1).permute(0, 2, 1)[..., None]
    kw = dict(attend_self=attend_self, non_local_mask=mt)
    dq = consensus_kernel.consensus_dq(lt, gt, lse_t, delta, **kw)
    dkv = consensus_kernel.consensus_dkv(lt, gt, lse_t, delta, **kw)
    np.testing.assert_allclose((dq + dkv).numpy(), np.asarray(want), atol=ATOL)

    # dQ alone: the same attention with the keys and values held fixed
    jmask = None if mask is None else jnp.asarray(mask)
    n, d = levels.shape[1], levels.shape[-1]

    def through_queries(q):
        kv = jax.lax.stop_gradient(jnp.asarray(levels))
        k = kv / jnp.maximum(jnp.linalg.norm(kv, axis=-1, keepdims=True), 1e-12)
        sim = jnp.einsum("bild,bjld->blij", q, k) * d ** -0.5
        if not attend_self:
            sim = jnp.where(jnp.eye(n, dtype=bool), -5e-4, sim)
        if jmask is not None:
            sim = jnp.where(jmask, -jnp.finfo(jnp.float32).max, sim)
        return jnp.einsum("blij,bjld->bild", jax.nn.softmax(sim, axis=-1), kv)

    _, vjp = jax.vjp(through_queries, jnp.asarray(levels))
    np.testing.assert_allclose(dq.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), atol=ATOL)


@pytest.mark.parametrize("attend_self", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("flash_bwd", [True, False])
def test_consensus_autograd_matches_jax_vjp(attend_self, use_mask, flash_bwd):
    import jax
    import jax.numpy as jnp

    from glom_tpu.kernels.consensus_pallas import consensus_attention_pallas

    levels, g, mask, _, _, _ = _consensus_case(attend_self, use_mask, seed=8)
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda x: consensus_attention_pallas(
        x, attend_self=attend_self, non_local_mask=jmask, interpret=True, flash_bwd=flash_bwd),
        jnp.asarray(levels))
    lt = torch.from_numpy(levels).requires_grad_(True)
    out, lse = consensus_kernel.consensus_attention(
        lt, attend_self=attend_self, flash_bwd=flash_bwd,
        non_local_mask=None if mask is None else torch.from_numpy(mask))
    assert not lse.requires_grad
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), atol=ATOL)


@pytest.mark.parametrize("attend_self,use_mask", [(False, False), (True, False), (False, True)])
def test_consensus_dq_on_k6s_ds_is_the_plain_composition(attend_self, use_mask):
    """On the CPU, K6 with its dS' kept gives the plain dKV and the plain
    dS' (float32 (b, L, n, n rounded up to 32), zero past n), and K7 on that
    dS' is its plain twin, dS' V, which agrees with the plain K7 that
    recomputes the logits (n=20, off the 32-key block)."""
    rng = np.random.default_rng(15)
    side = 4 if use_mask else 5
    n = side * side
    levels = torch.from_numpy(rng.standard_normal((2, n, 3, 8)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, n, 3, 8)).astype(np.float32))
    mask = torch.from_numpy(local_consensus_mask(side, 1.5)) if use_mask else None
    kw = dict(attend_self=attend_self, non_local_mask=mask)
    out, lse = plain_consensus.consensus_attention(levels, **kw)
    delta = (g * out).sum(-1).permute(0, 2, 1)[..., None].contiguous()
    dkv, ds = consensus_kernel.consensus_dkv(levels, g, lse, delta, keep_ds=True, **kw)
    assert torch.equal(dkv, plain_consensus.consensus_dkv(levels, g, lse, delta, **kw))
    assert ds.dtype == torch.float32 and tuple(ds.shape) == consensus_kernel.ds_shape(levels)
    assert tuple(ds.shape) == (2, 3, n, 32) and not ds[..., n:].any()
    dq = consensus_kernel.consensus_dq(levels, g, lse, delta, ds=ds, **kw)
    assert torch.equal(dq, plain_consensus.consensus_dq_from_ds(levels, ds))
    np.testing.assert_allclose(dq.numpy(), plain_consensus.consensus_dq(
        levels, g, lse, delta, **kw).numpy(), atol=ATOL)
    with pytest.raises(ValueError, match="ds must be"):
        consensus_kernel.consensus_dq(levels, g, lse, delta, ds=ds[..., :n].contiguous(), **kw)


@pytest.mark.parametrize("b,n,L,limit,count", [
    (8, 256, 6, None, 1),          # flagship: 12.6 MB, one chunk
    (1, 2304, 6, None, 1),         # n=2304, b=1: 127 MB
    (8, 2304, 6, None, 4),         # 1.02 GB: two batch rows (12 pairs, 255 MB) a chunk
    (3, 40, 5, 4 * 40 * 64 * 7, 3),     # 7 pairs a chunk: one batch row of 5 levels
    (2, 40, 5, 4 * 40 * 64 * 3, 4),     # 3 pairs: levels of one row at a time (3 + 2)
    (2, 40, 5, 1, 10),             # a cap below one pair still runs one pair a chunk
])
def test_ds_chunks_cap_the_workspace(b, n, L, limit, count):
    """consensus_backward's views: each (b, l) pair in exactly one chunk, in
    order, and each chunk's dS' within the cap wherever one pair fits."""
    chunks = consensus_kernel.ds_chunks(b, n, L, limit)
    assert len(chunks) == count
    cap = consensus_kernel.DS_CHUNK_BYTES if limit is None else limit
    pair_bytes = 4 * n * plain_consensus.ds_columns(n)
    seen = []
    for bs, ls in chunks:
        pairs = [(i, j) for i in range(b)[bs] for j in range(L)[ls]]
        assert pairs and (len(pairs) * pair_bytes <= cap or len(pairs) == 1)
        seen += pairs
    assert seen == [(i, j) for i in range(b) for j in range(L)]


# -- what the wrappers refuse -------------------------------------------------

def _good_ff(d=128, g=2, h=256, dtype=torch.float32):
    rng = np.random.default_rng(2)
    return _torch(_ff_params(rng, g, d, h), dtype=dtype), torch.zeros((2, 4, g, d), dtype=dtype)


def _empty_ff(d, h, g=2):
    """FF parameters and x of width ``d`` and hidden ``h``, either of them 0."""
    return ({"w1": torch.zeros((g, d, h)), "b1": torch.zeros((g, h)), "w2": torch.zeros((g, h, d)),
             "b2": torch.zeros((g, d))}, torch.zeros((2, 4, g, d)))


def test_ff_check_accepts_the_main_path_view():
    p, _ = _good_ff()
    lwi = torch.zeros((2, 4, 3, 128))
    ff_kernel._check(p, lwi[..., :-1, :])


@pytest.mark.parametrize("case", ["dtype", "param_dtype", "shape", "dim", "hidden", "strides",
                                  "misaligned", "rank"])
def test_ff_check_refuses(case):
    p, x = _good_ff()
    if case == "dtype":
        x, err = x.half(), TypeError
    elif case == "param_dtype":
        p["w2"], err = p["w2"].bfloat16(), TypeError
    elif case == "shape":
        p["b1"], err = p["b1"][:, :-1], ValueError
    elif case == "dim":
        # K1, K2 and K3 take every positive width: off a multiple of 128 the
        # wrappers run them on zero-padded copies (their layouts then not
        # the caller's concern); a width that is not positive is refused
        kernels = ("grouped_ff kernel (K1)", "grouped_ff_dx kernel (K2)",
                   "grouped_ff_dw kernel (K3)")
        for d in (8, 16, 64, 96, 600, 640, 1024):
            wide_p, wide_x = _good_ff(d=d, h=64)
            for kernel in kernels:
                ff_kernel._check(wide_p, wide_x, kernel)
            assert ff_kernel._padded(wide_p, wide_x) == (d % 128 != 0)
        ff_kernel._check(*_good_ff(d=96), "grouped_ff_dx kernel (K2)")
        ff_kernel._check(*_good_ff(d=96)[:1], torch.zeros((4, 2, 2, 96)).transpose(0, 1))
        p, x = _empty_ff(0, 256)
        for kernel in kernels[1:]:
            with pytest.raises(ValueError, match=r"\(K[23]\).*positive width.*d=0"):
                ff_kernel._check(p, x, kernel)
        err = ValueError
    elif case == "hidden":
        # any positive h: off a multiple of 64 the wrappers pad it too
        for h in (32, 96, 200):
            hp, hx = _good_ff(h=h)
            ff_kernel._check(hp, hx)
            assert ff_kernel._padded(hp, hx)
        p, x = _empty_ff(128, 0)
        err = ValueError
    elif case == "strides":
        x, err = torch.zeros((4, 2, 2, 128)).transpose(0, 1), ValueError
    elif case == "misaligned":
        w2 = torch.zeros(p["w2"].numel() + 1)[1:].view(p["w2"].shape)
        p["w2"], err = w2, ValueError
    else:
        x, err = x[0], ValueError
    with pytest.raises(err):
        ff_kernel._check(p, x)


@pytest.mark.parametrize("case", ["dtype", "dim", "mask_shape", "mask_dtype", "last_stride"])
def test_consensus_check_refuses(case):
    levels = torch.zeros((2, 8, 3, 128))
    mask = None
    err = ValueError
    if case == "dtype":
        levels, err = levels.double(), TypeError
    elif case == "dim":
        # K4, K6 and K7 take every positive width (above 512 the wide
        # designs; off a multiple of 128 on zero-padded copies, the model's
        # width scaling the logits) and refuse a width that is not positive
        kernels = ("consensus kernel (K4)", "consensus_dkv kernel (K6)",
                   "consensus_dq kernel (K7)")
        for d in (8, 16, 64, 96, 512, 600, 640, 1024, 2048):
            for kernel in kernels:
                consensus_kernel._check(torch.zeros((2, 8, 3, d)), None, kernel)
            padded = consensus_kernel._kernel_levels(torch.zeros((2, 8, 3, d)))
            assert padded.shape[-1] == -(-d // 128) * 128 and padded.is_contiguous()
        for kernel in kernels[1:]:
            with pytest.raises(ValueError, match=r"\(K[67]\).*positive width"):
                consensus_kernel._check(torch.zeros((2, 8, 3, 0)), None, kernel)
        levels = torch.zeros((2, 8, 3, 0))
    elif case == "mask_shape":
        mask = torch.zeros((8, 7), dtype=torch.bool)
    elif case == "mask_dtype":
        mask, err = torch.zeros((8, 8), dtype=torch.float32), TypeError
    else:
        levels = torch.zeros((2, 8, 128, 3)).transpose(2, 3)
    with pytest.raises(err):
        consensus_kernel._check(levels, mask)


def test_consensus_forward_needs_16_byte_rows():
    """The forward copies rows in 16-byte vectors: 4 float32 or 8 bfloat16
    elements; a dimension of size 1 is never stepped over."""
    x = torch.zeros((2, 8, 3, 128))
    assert consensus_kernel._rows_aligned(x) and consensus_kernel._rows_aligned(x[..., 1:, :])
    assert not consensus_kernel._rows_aligned(torch.zeros(x.numel() + 1)[1:].view(x.shape))
    y = torch.zeros((2, 8, 3, 136), dtype=torch.bfloat16)
    assert not consensus_kernel._rows_aligned(y[..., 4:])
    assert consensus_kernel._rows_aligned(y[..., 8:]) and not consensus_kernel._rows_aligned(y[:1, :1, :1, 4:])
    assert consensus_kernel._rows_aligned(torch.zeros((1, 4, 8, 128)).as_strided((1, 4, 1, 128), (5, 1024, 3, 1)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_backward_wrappers_copy_rows_off_a_boundary(dtype, offset):
    """The backward kernels read rows as 4-element vectors (K2, K6, K7) or
    in 16-byte pieces (K3): the predicate says "off a boundary" for views
    ``offset`` elements into a flat buffer, and fresh_copy gives the same
    values in storage on the boundary, which the wrappers then launch on
    (glom_tpu's kernels take any layout)."""
    shape = (2, 8, 3, 128)
    flat = torch.arange(int(np.prod(shape)) + offset, dtype=torch.float32).to(dtype)
    base = flat[:-offset].view(shape)
    off = flat[offset:].view(shape)
    for view in (off, off[..., :-1, :]):
        strides = (view.stride(1), view.stride(2))
        assert not _common.vector_aligned(view, *strides)
        assert not _common.vector_aligned(view, *strides, nbytes=16)
        copy = _common.fresh_copy(view)
        assert torch.equal(copy, view) and copy.is_contiguous()
        assert copy.data_ptr() != view.data_ptr()
        assert _common.vector_aligned(copy, copy.stride(1), copy.stride(2), nbytes=16)
    # the strided bottom-up view of an aligned state needs no copy
    assert _common.vector_aligned(base[..., :-1, :], base.stride(1), base.stride(2), nbytes=16)
    p, _ = _good_ff(g=2, dtype=dtype)
    assert ff_kernel._kernel_operands(p, base[..., :-1, :])[1].data_ptr() == base.data_ptr()
    got = ff_kernel._kernel_operands(p, off[..., :-1, :])[1]
    assert torch.equal(got, off[..., :-1, :]) and got.data_ptr() % 16 == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_forward_copies_rows_off_a_16_byte_boundary(dtype, offset):
    """K1 copies x's rows in 16-byte pieces (4 float32 or 8 bfloat16
    elements): for a bottom-up view, a top-down view and a contiguous input
    ``offset`` elements into a flat buffer the predicate says "off" and the
    forward launches on a fresh copy with the same values; the views of a
    state on the boundary launch as they are.  A bfloat16 view 4 elements in
    lies on an 8-byte boundary, which is not enough."""
    shape = (2, 8, 4, 128)
    flat = torch.arange(int(np.prod(shape)) + 8, dtype=torch.float32).to(dtype)
    base = flat[:-8].view(shape)
    p3, _ = _good_ff(g=3, dtype=dtype)
    p2, _ = _good_ff(g=2, dtype=dtype)
    offsets = [offset] + ([4] if dtype == torch.bfloat16 else [])
    for off in offsets:
        state = flat[off:off + base.numel()].view(shape)
        for p, view in ((p3, state[..., :-1, :]), (p2, state[..., 2:, :]),
                        (p3, flat[off:off + 2 * 8 * 3 * 128].view(2, 8, 3, 128))):
            assert not _common.vector_aligned(view, ff_kernel._row_stride(view), view.stride(2),
                                              nbytes=16)
            got = ff_kernel._kernel_operands(p, view)[1]
            assert torch.equal(got, view) and got.data_ptr() != view.data_ptr()
            assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    for p, view in ((p3, base[..., :-1, :]), (p2, base[..., 2:, :])):
        assert ff_kernel._kernel_operands(p, view)[1].data_ptr() == view.data_ptr()


def test_wrappers_refuse_grad_and_other_devices():
    """Under autograd the wrappers record their backward (no refusal since
    the backward kernels landed); off the CPU and CUDA they still raise."""
    p, x = _good_ff()
    x.requires_grad_(True)
    y = ff_kernel.grouped_ff(p, x)
    assert y.requires_grad and y.grad_fn is not None
    with torch.no_grad():
        assert not ff_kernel.grouped_ff(p, x).requires_grad
    out, lse = consensus_kernel.consensus_attention(torch.zeros((1, 4, 2, 8), requires_grad=True))
    assert out.requires_grad and not lse.requires_grad
    # neither a CUDA nor a CPU tensor: no plain-version fallback either
    meta = torch.zeros((1, 4, 2, 128), device="meta")
    with pytest.raises(ValueError):
        consensus_kernel.consensus_attention(meta)
    with torch.inference_mode(), pytest.raises(ValueError):
        ff_kernel.grouped_ff({k: v.to("meta") for k, v in p.items()}, meta)
    with pytest.raises(ValueError):
        ff_kernel.grouped_ff_dx({k: v.to("meta") for k, v in p.items()}, meta, meta)
    with pytest.raises(ValueError):
        consensus_kernel.consensus_dq(meta, meta, meta, meta)
    # K3 reads the hidden K2 hands it and has no path without one
    with pytest.raises(ValueError, match="keep_hidden"):
        ff_kernel.grouped_ff_dw(p, x.detach(), torch.zeros_like(x), None)


def test_build_lists_sources_and_needs_nvcc(monkeypatch):
    assert set(_build.sources()) == {"grouped_ff", "grouped_ff_bwd", "consensus", "consensus_bwd",
                                     "fused_update"}
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_build_plan_is_cached_and_refuses_no_plan(monkeypatch):
    calls = []

    def fake_function(name, symbol, argtypes):
        assert len(argtypes) == 3
        return lambda *args: calls.append(args) or (args[0] - 1)

    monkeypatch.setattr(_build, "function", fake_function)
    monkeypatch.setattr(_build, "_plans", {})
    assert _build.plan("consensus", "glom_consensus_splits", 0, 3, 7, 9) == 2
    assert _build.plan("consensus", "glom_consensus_splits", 0, 3, 7, 9) == 2
    assert calls == [(3, 7, 9)]   # the second call hit the cache
    with pytest.raises(RuntimeError, match="no plan"):
        _build.plan("consensus", "glom_consensus_splits", 0, 1, 7, 9)


def test_build_key_follows_the_sources():
    src = _build.sources()["grouped_ff"]
    assert _build._digest(src) == _build._digest(src)
    assert _build._digest(src) != _build._digest(_build.sources()["consensus"])


# -- GPU: each kernel against its plain version on the card -----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _f32(tree):
    return {k: v.float() for k, v in tree.items()}


def _assert_close(got, want, dtype, part=None):
    """``got`` (``dtype``) against ``want`` (float32) under GPU_RTOL's
    limits.  ``part``, a term of ``want`` that the output adds to a larger
    one, is held on its own: the error within GPU_RTOL of its norm plus the
    output type's rounding of ``want``."""
    rtol = GPU_RTOL[dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err, norm = torch.linalg.vector_norm(diff).item(), torch.linalg.vector_norm(w).item()
    assert torch.isfinite(g).all()
    assert err <= rtol * norm, (err, norm)
    bad = diff > rtol * (min(1.0, w.abs().max().item()) + w.abs())
    assert not bad.any(), (diff.max().item(), int(bad.sum()))
    if part is not None:
        part_norm = torch.linalg.vector_norm(part.float()).item()
        assert err <= rtol * part_norm + torch.finfo(dtype).eps / 2 * norm, (err, part_norm, norm)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,n", [(128, 20), (384, 70), (512, 64)])
@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("g,extra", [(3, 0), (11, 64)])
def test_gpu_grouped_ff_matches_plain(cuda, dtype, d, n, splits, g, extra):
    """splits None: the planned count (several, at these few rows); 1: the
    block writes the output itself; 3: uneven shares of K1b's hidden slabs.
    g=11 is the fuse_ff call's group count; extra=64 puts h off the 128-wide
    tile (K1a's last hidden tile half full)."""
    rng = np.random.default_rng(3)
    p = _torch(_ff_params(rng, g, d, 4 * d + extra), cuda, dtype)
    lwi = torch.from_numpy(rng.standard_normal((2, n, g + 1, d)).astype(np.float32)).to(cuda, dtype)
    before = ff_kernel.grouped_ff.launches
    with torch.inference_mode():
        for x in (lwi[..., :-1, :], lwi[..., 1:, :].contiguous()):
            got = ff_kernel.grouped_ff(p, x, splits=splits)
            assert got.dtype == dtype and got.shape == x.shape
            _assert_close(got, plain_ff.grouped_ff_apply(_f32(p), x.float()), dtype)
    assert ff_kernel.grouped_ff.launches == before + 2


@pytest.mark.gpu
def test_gpu_grouped_ff_flagship_matches_float64(cuda):
    """K1 at the flagship's bottom-up call (b=8, n=256, g=6, d=512, h=2048,
    the strided view), float32, against the same function in float64:
    within GPU_RTOL normwise and elementwise, as the float32 plain version
    is."""
    rng = np.random.default_rng(15)
    p = _torch(_ff_params(rng, 6, 512, 2048), cuda)
    lwi = torch.from_numpy(rng.standard_normal((8, 256, 7, 512)).astype(np.float32)).to(cuda)
    x = lwi[..., :-1, :]
    with torch.inference_mode():
        got = ff_kernel.grouped_ff(p, x).double()
        w1, b1, w2, b2 = (p[k].double() for k in ("w1", "b1", "w2", "b2"))
        pre = torch.einsum("bngd,gdh->bngh", x.double(), w1) + b1
        want = torch.einsum("bngh,ghd->bngd", 0.5 * pre * (1.0 + torch.erf(pre * 2.0 ** -0.5)),
                            w2) + b2
    rtol = GPU_RTOL[torch.float32]
    diff = (got - want).abs()
    assert torch.linalg.vector_norm(diff) <= rtol * torch.linalg.vector_norm(want)
    assert (diff <= rtol * (min(1.0, want.abs().max().item()) + want.abs())).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_gpu_grouped_ff_takes_rows_off_a_16_byte_boundary(cuda, dtype, offset):
    """K1 on inputs whose rows lie off a 16-byte boundary (``offset``
    elements into a flat buffer; glom_tpu's kernel takes any layout): the
    wrapper copies them into fresh storage, launches K1 once a call, and
    agrees with the plain version."""
    rng = np.random.default_rng(16)
    p = _torch(_ff_params(rng, 3, 128, 192), cuda, dtype)
    shape = (2, 24, 4, 128)
    flat = torch.from_numpy(
        rng.standard_normal(int(np.prod(shape)) + offset).astype(np.float32)).to(cuda, dtype)
    state = flat[offset:].view(shape)
    before = ff_kernel.grouped_ff.launches
    with torch.inference_mode():
        for x in (state[..., :-1, :], state[..., 1:, :]):
            assert not _common.vector_aligned(x, ff_kernel._row_stride(x), x.stride(2), nbytes=16)
            _assert_close(ff_kernel.grouped_ff(p, x), plain_ff.grouped_ff_apply(_f32(p), x.float()),
                          dtype)
    assert ff_kernel.grouped_ff.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("attend_self,radius", [(False, 0), (True, 0), (False, 1.5)])
@pytest.mark.parametrize("side", [5, 16, 48])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("splits", [None, 1, 2, 3, 4, 5, 6, 7, 8])
def test_gpu_consensus_matches_plain(cuda, dtype, attend_self, radius, side, b, splits):
    """side 5: n=25, one ragged key block; 16: n=256; 48: n=2304, the
    streamed regime.  splits None: the planned count; 1 to 8: every count
    the planner can pick (at n=25 all are one block, whose keys are one key
    block)."""
    rng = np.random.default_rng(4)
    n = side * side
    levels = torch.from_numpy(rng.standard_normal((b, n, 3, 128)).astype(np.float32)).to(cuda, dtype)
    mask = (torch.from_numpy(local_consensus_mask(side, radius)).to(cuda)
            if radius else None)
    before = consensus_kernel.consensus_attention.launches
    with torch.inference_mode():
        got, lse = consensus_kernel.consensus_attention(
            levels, attend_self=attend_self, non_local_mask=mask, splits=splits)
        want, want_lse = plain_consensus.consensus_attention(
            levels.float(), attend_self=attend_self, non_local_mask=mask)
    assert consensus_kernel.consensus_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == levels.shape
    _assert_close(got, want, dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 256, 384, 512])
@pytest.mark.parametrize("splits", [1, 3])
def test_gpu_consensus_widths(cuda, dtype, d, splits):
    """Every width the kernel takes (a warp's slice of d is d/4: 32 to 128
    columns), on the strided levels view of the model's loop, n=70 (a ragged
    query tile and key block)."""
    rng = np.random.default_rng(5)
    lwi = torch.from_numpy(rng.standard_normal((2, 70, 4, d)).astype(np.float32)).to(cuda, dtype)
    levels = lwi[..., 1:, :]
    with torch.inference_mode():
        got, lse = consensus_kernel.consensus_attention(levels, splits=splits)
        want, want_lse = plain_consensus.consensus_attention(levels.float())
    _assert_close(got, want, dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,splits", [(8, None), (1, None), (1, 4)])
def test_gpu_consensus_is_deterministic(cuda, dtype, b, splits):
    """No atomics: two calls give the same bits, out and lse, at the main
    path's widths, with one split and several."""
    rng = np.random.default_rng(6)
    levels = torch.from_numpy(rng.standard_normal((b, 256, 2, 512)).astype(np.float32)).to(cuda, dtype)
    with torch.inference_mode():
        a, lse_a = consensus_kernel.consensus_attention(levels, splits=splits)
        c, lse_c = consensus_kernel.consensus_attention(levels, splits=splits)
    assert torch.equal(a, c) and torch.equal(lse_a, lse_c)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strided", [True, False])
@pytest.mark.parametrize("rows", [1, 49, 256, 2048])
@pytest.mark.parametrize("g", [5, 6])
@pytest.mark.parametrize("h", [ff_kernel.HIDDEN_CHUNK, 2048])
@pytest.mark.parametrize("d", [128, 256, 384, 512])
def test_gpu_grouped_ff_dx_matches_plain(cuda, d, h, g, rows, strided, dtype):
    """K2 against its plain version over the widths it takes (d, and h from
    the smallest the wrapper takes to the flagship's), both group counts of
    the main path, row counts on and off its 32-row tile (2048 = b 8 x n
    256), the strided bottom-up view and a contiguous input; two calls give
    the same bits."""
    rng = np.random.default_rng(d + h + g + rows)
    p = _torch(_ff_params(rng, g, d, h), cuda, dtype)
    b, n = (8, rows // 8) if rows > 256 else (1, rows)
    lwi = torch.from_numpy(rng.standard_normal((b, n, g + 1, d)).astype(np.float32)).to(cuda, dtype)
    x = lwi[..., :-1, :] if strided else lwi[..., 1:, :].contiguous()
    dout = torch.from_numpy(rng.standard_normal((b, n, g, d)).astype(np.float32)).to(cuda, dtype)
    before = ff_kernel.grouped_ff_dx.launches
    got = ff_kernel.grouped_ff_dx(p, x, dout)
    assert ff_kernel.grouped_ff_dx.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    _assert_close(got, plain_ff.grouped_ff_dx(_f32(p), x.float(), dout.float()), dtype)
    assert torch.equal(got, ff_kernel.grouped_ff_dx(p, x, dout))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_gpu_grouped_ff_dx_splits_the_hidden(cuda, splits, dtype):
    """K2 with its hidden split over 1, 2, 3 (the last split short) and 8
    blocks a row tile, at b=1 flagship shapes: each against the plain
    version, two calls bitwise equal, one launch a call."""
    rng = np.random.default_rng(15)
    p = _torch(_ff_params(rng, 6, 512, 2048), cuda, dtype)
    lwi = torch.from_numpy(rng.standard_normal((1, 256, 7, 512)).astype(np.float32)).to(cuda, dtype)
    x = lwi[..., :-1, :]
    dout = torch.from_numpy(rng.standard_normal((1, 256, 6, 512)).astype(np.float32)).to(cuda, dtype)
    before = ff_kernel.grouped_ff_dx.launches
    got = ff_kernel.grouped_ff_dx(p, x, dout, splits=splits)
    assert ff_kernel.grouped_ff_dx.launches == before + 1
    _assert_close(got, plain_ff.grouped_ff_dx(_f32(p), x.float(), dout.float()), dtype)
    assert torch.equal(got, ff_kernel.grouped_ff_dx(p, x, dout, splits=splits))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,n", [(128, 20), (384, 70), (512, 64)])
def test_gpu_grouped_ff_backward_matches_plain(cuda, dtype, d, n):
    """K2 (dX) and K3 (dW, on the hidden K2 hands it) against their plain
    versions, on the strided bottom-up view and a contiguous input; rows 40,
    140, 128 leave ragged row tiles."""
    rng = np.random.default_rng(9)
    p = _torch(_ff_params(rng, 3, d, 4 * d), cuda, dtype)
    lwi = torch.from_numpy(rng.standard_normal((2, n, 4, d)).astype(np.float32)).to(cuda, dtype)
    g = torch.from_numpy(rng.standard_normal((2, n, 3, d)).astype(np.float32)).to(cuda, dtype)
    before = (ff_kernel.grouped_ff_dx.launches, ff_kernel.grouped_ff_dw.launches)
    for x in (lwi[..., :-1, :], lwi[..., 1:, :].contiguous()):
        got, hidden = ff_kernel.grouped_ff_dx(p, x, g, keep_hidden=True)
        assert got.dtype == dtype and got.shape == x.shape
        _assert_close(got, plain_ff.grouped_ff_dx(_f32(p), x.float(), g.float()), dtype)
        for name, got_w, want_w in zip(("w1", "b1", "w2"), ff_kernel.grouped_ff_dw(p, x, g, hidden),
                                       plain_ff.grouped_ff_dw(_f32(p), x.float(), g.float())):
            assert got_w.dtype == dtype and got_w.shape == p[name].shape
            _assert_close(got_w, want_w, dtype)
    assert (ff_kernel.grouped_ff_dx.launches, ff_kernel.grouped_ff_dw.launches) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("attend_self,radius", [(False, 0), (True, 0), (False, 1.5)])
@pytest.mark.parametrize("side", [5, 16, 48])
def test_gpu_consensus_backward_matches_plain(cuda, dtype, attend_self, radius, side):
    """K6 (dKV, with the dS' it hands K7) and K7 (dQ, on that dS') against
    their plain versions, the dS' against the plain dS' (every element
    written, zero past n); side 5: n=25, a ragged block; 48: n=2304."""
    rng = np.random.default_rng(10)
    n = side * side
    b = 1 if n > 1024 else 2
    levels = torch.from_numpy(rng.standard_normal((b, n, 3, 128)).astype(np.float32)).to(cuda, dtype)
    g = torch.from_numpy(rng.standard_normal((b, n, 3, 128)).astype(np.float32)).to(cuda, dtype)
    mask = (torch.from_numpy(local_consensus_mask(side, radius)).to(cuda)
            if radius else None)
    kw = dict(attend_self=attend_self, non_local_mask=mask)
    with torch.no_grad():
        out, lse = plain_consensus.consensus_attention(levels, **kw)
    delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1).unsqueeze(-1).contiguous()
    before = (consensus_kernel.consensus_dkv.launches, consensus_kernel.consensus_dq.launches)
    # K6's key term, beside its larger value term, is also held on its own
    key_term, _ = plain_consensus.consensus_dkv_terms(levels.float(), g.float(), lse, delta, **kw)
    dkv, ds = consensus_kernel.consensus_dkv(levels, g, lse, delta, keep_ds=True, **kw)
    dq = consensus_kernel.consensus_dq(levels, g, lse, delta, ds=ds, **kw)
    for got, ref, part in ((dkv, plain_consensus.consensus_dkv, key_term),
                           (dq, plain_consensus.consensus_dq, None)):
        assert got.dtype == dtype and got.shape == levels.shape
        _assert_close(got, ref(levels.float(), g.float(), lse, delta, **kw), dtype, part)
    want_ds = plain_consensus.consensus_ds(levels.float(), g.float(), lse, delta, **kw)
    assert ds.shape == want_ds.shape and not ds[..., n:].any()
    _assert_close(ds, want_ds, torch.float32)
    assert (consensus_kernel.consensus_dkv.launches, consensus_kernel.consensus_dq.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.gpu
def test_gpu_consensus_dq_needs_k6s_ds(cuda):
    """On the card K7 is a product of K6's dS' and the levels: without the
    dS' it raises (there is no path that recomputes the logits, and no
    fallback to the plain version), and it launches nothing."""
    x = torch.zeros((1, 8, 2, 128), device=cuda)
    lse = torch.zeros((1, 2, 8, 1), device=cuda)
    before = consensus_kernel.consensus_dq.launches
    with pytest.raises(ValueError, match="keep_ds"):
        consensus_kernel.consensus_dq(x, x, lse, lse)
    assert consensus_kernel.consensus_dq.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_consensus_backward_runs_in_chunks(cuda, dtype, monkeypatch):
    """Under a small dS' cap consensus_backward runs K6 and K7 over views of
    levels (whole batch rows, then levels of one row) and gives the bits of
    one chunk, counting one launch of each a call."""
    rng = np.random.default_rng(16)
    levels = torch.from_numpy(rng.standard_normal((3, 40, 4, 128)).astype(np.float32)).to(cuda, dtype)
    g = torch.from_numpy(rng.standard_normal((3, 40, 4, 128)).astype(np.float32)).to(cuda, dtype)
    with torch.no_grad():
        out, lse = consensus_kernel.consensus_attention(levels)
    whole = consensus_kernel.consensus_backward(levels, None, out, lse, g)
    _assert_close(whole, consensus_kernel.plain_vjp(levels.float(), None, g.float()), dtype)
    for pairs in (4, 3):   # one batch row a chunk; three levels, then one
        monkeypatch.setattr(consensus_kernel, "DS_CHUNK_BYTES", pairs * 4 * 40 * 64)
        before = (consensus_kernel.consensus_dkv.launches, consensus_kernel.consensus_dq.launches)
        assert torch.equal(consensus_kernel.consensus_backward(levels, None, out, lse, g), whole)
        assert (consensus_kernel.consensus_dkv.launches, consensus_kernel.consensus_dq.launches) == (
            before[0] + 1, before[1] + 1)


@pytest.mark.gpu
def test_gpu_backward_kernels_are_deterministic(cuda):
    """No atomics: two runs of each backward kernel give the same bits."""
    rng = np.random.default_rng(11)
    p = _torch(_ff_params(rng, 3, 256, 1024), cuda)
    x = torch.from_numpy(rng.standard_normal((4, 64, 3, 256)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(cuda)
    (dx, hidden), (dx2, hidden2) = (ff_kernel.grouped_ff_dx(p, x, g, keep_hidden=True)
                                    for _ in range(2))
    assert torch.equal(dx, dx2) and all(torch.equal(u, v) for u, v in zip(hidden, hidden2))
    assert torch.equal(ff_kernel.grouped_ff_dx(p, x, g), ff_kernel.grouped_ff_dx(p, x, g))
    for u, v in zip(ff_kernel.grouped_ff_dw(p, x, g, hidden), ff_kernel.grouped_ff_dw(p, x, g, hidden)):
        assert torch.equal(u, v)
    with torch.no_grad():
        out, lse = consensus_kernel.consensus_attention(x)
    delta = (g * out).sum(-1).permute(0, 2, 1).unsqueeze(-1).contiguous()
    (dkv, ds), (dkv2, ds2) = (consensus_kernel.consensus_dkv(x, g, lse, delta, keep_ds=True)
                              for _ in range(2))
    assert torch.equal(dkv, dkv2) and torch.equal(ds, ds2)
    assert torch.equal(consensus_kernel.consensus_dkv(x, g, lse, delta), dkv)
    assert torch.equal(consensus_kernel.consensus_dq(x, g, lse, delta, ds=ds),
                       consensus_kernel.consensus_dq(x, g, lse, delta, ds=ds))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_gpu_backward_kernels_take_vector_aligned_rows(cuda, dtype, offset):
    """The backward kernels on inputs whose rows lie off a vector boundary
    (``offset`` elements into a flat buffer), as glom_tpu's kernels take any
    layout: each wrapper copies them into fresh storage, launches its kernel
    once, and K2, K3, K6 and K7 agree with their plain versions."""
    rng = np.random.default_rng(13)
    p = _torch(_ff_params(rng, 2, 128, 256), cuda, dtype)
    shape = (2, 8, 3, 128)
    t = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(cuda, dtype)
    off = t(int(np.prod(shape)) + offset)[offset:].view(shape)
    x, g = off[..., :-1, :], t(2, 8, 2, 128)
    g_off = t(2 * 8 * 2 * 128 + offset)[offset:].view(2, 8, 2, 128)
    counters = (ff_kernel.grouped_ff_dx, ff_kernel.grouped_ff_dw, consensus_kernel.consensus_dkv,
                consensus_kernel.consensus_dq)
    before = [f.launches for f in counters]
    p32 = _f32(p)
    for xx, gg in ((x, g), (x, g_off)):
        dx, hidden = ff_kernel.grouped_ff_dx(p, xx, gg, keep_hidden=True)
        _assert_close(dx, plain_ff.grouped_ff_dx(p32, xx.float(), gg.float()), dtype)
        for got, want in zip(ff_kernel.grouped_ff_dw(p, xx, gg, hidden),
                             plain_ff.grouped_ff_dw(p32, xx.float(), gg.float())):
            _assert_close(got, want, dtype)
    levels, dout = off, t(int(np.prod(shape)) + offset)[offset:].view(shape)
    with torch.no_grad():
        out, lse = plain_consensus.consensus_attention(levels.float())
    delta = (dout.float() * out).sum(-1).permute(0, 2, 1).unsqueeze(-1).contiguous()
    key_term, _ = plain_consensus.consensus_dkv_terms(levels.float(), dout.float(), lse, delta)
    dkv, ds = consensus_kernel.consensus_dkv(levels, dout, lse, delta, keep_ds=True)
    dq = consensus_kernel.consensus_dq(levels, dout, lse, delta, ds=ds)
    for got, ref, part in ((dkv, plain_consensus.consensus_dkv, key_term),
                           (dq, plain_consensus.consensus_dq, None)):
        _assert_close(got, ref(levels.float(), dout.float(), lse, delta), dtype, part)
    assert [f.launches - b for f, b in zip(counters, before)] == [2, 2, 1, 1]


def _grouped_ff_dw_f64(p, x, g):
    """``(dW1, db1, dW2)`` of the grouped FF in float64: the formulas of
    plain.grouped_ff_dw, with the cotangent cast to ``x``'s type first."""
    x64, g64 = x.double(), g.to(x.dtype).double()
    w1, b1, w2 = (p[k].double() for k in ("w1", "b1", "w2"))
    pre = torch.einsum("bngd,gdh->bngh", x64, w1) + b1
    cdf = 0.5 * (1.0 + torch.erf(pre * 2.0 ** -0.5))
    pdf = torch.exp(-0.5 * pre * pre) / (2.0 * np.pi) ** 0.5
    dh = torch.einsum("bngd,ghd->bngh", g64, w2) * (cdf + pre * pdf)
    return (torch.einsum("bngd,bngh->gdh", x64, dh), dh.sum(dim=(0, 1)),
            torch.einsum("bngh,bngd->ghd", pre * cdf, g64))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strided", [True, False])
@pytest.mark.parametrize("rows", [1, 49, 256, 2048])
@pytest.mark.parametrize("g", [5, 6])
@pytest.mark.parametrize("h", [192, 2048])
@pytest.mark.parametrize("d", [128, 256, 384, 512])
def test_gpu_grouped_ff_dw_matches_plain(cuda, d, h, g, rows, strided, dtype):
    """K3 on the hidden K2 hands it against its reference, over the widths
    it takes (h 192: a dW1 tile of 64 live columns, a dW2 tile of 64 live
    rows), both group counts of the main path, row counts on and off its
    32-row slab (2048 = b 8 x n 256), the strided bottom-up view and a
    contiguous input, with the planned split of the rows; the hidden against
    its plain twin; two calls give the same bits, one launch each.  The
    reference is computed in float64: over 2048 rows at d=512, h=192, the
    float32 plain.grouped_ff_dw is itself off the exact sums by up to 1.07
    of the elementwise limit (K3: 0.31; NVIDIA H100, 700 W)."""
    rng = np.random.default_rng(d + h + g + rows + 1)
    p = _torch(_ff_params(rng, g, d, h), cuda, dtype)
    b, n = (8, rows // 8) if rows > 256 else (1, rows)
    lwi = torch.from_numpy(rng.standard_normal((b, n, g + 1, d)).astype(np.float32)).to(cuda, dtype)
    x = lwi[..., :-1, :] if strided else lwi[..., 1:, :].contiguous()
    dout = torch.from_numpy(rng.standard_normal((b, n, g, d)).astype(np.float32)).to(cuda, dtype)
    p32, x32, g32 = _f32(p), x.float(), dout.float()
    _, hidden = ff_kernel.grouped_ff_dx(p, x, dout, keep_hidden=True)
    for got, want in zip(hidden, plain_ff.grouped_ff_hidden(p32, x32, g32)):
        _assert_close(got, want, torch.float32)
    before = ff_kernel.grouped_ff_dw.launches
    got = ff_kernel.grouped_ff_dw(p, x, dout, hidden)
    assert ff_kernel.grouped_ff_dw.launches == before + 1
    for name, u, w in zip(("w1", "b1", "w2"), got, _grouped_ff_dw_f64(p, x, dout)):
        assert u.dtype == dtype and u.shape == p[name].shape
        _assert_close(u, w, dtype)
    assert all(torch.equal(u, v) for u, v in zip(got, ff_kernel.grouped_ff_dw(p, x, dout, hidden)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [49, 256])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_gpu_grouped_ff_dw_splits_the_rows(cuda, splits, rows, dtype):
    """K3 with the rows split over 1, 2, 3 and 8 blocks a tile (partial sums
    through the f32 workspace, added in order by the second kernel; with 49
    rows, two slabs, at most two splits hold any), at b=1 flagship widths:
    against the reference, two calls bitwise equal, one launch a call."""
    rng = np.random.default_rng(16)
    p = _torch(_ff_params(rng, 6, 512, 2048), cuda, dtype)
    lwi = torch.from_numpy(rng.standard_normal((1, rows, 7, 512)).astype(np.float32)).to(cuda, dtype)
    x = lwi[..., :-1, :]
    dout = torch.from_numpy(rng.standard_normal((1, rows, 6, 512)).astype(np.float32)).to(cuda, dtype)
    _, hidden = ff_kernel.grouped_ff_dx(p, x, dout, keep_hidden=True)
    before = ff_kernel.grouped_ff_dw.launches
    got = ff_kernel.grouped_ff_dw(p, x, dout, hidden, splits=splits)
    assert ff_kernel.grouped_ff_dw.launches == before + 1
    for u, w in zip(got, plain_ff.grouped_ff_dw(_f32(p), x.float(), dout.float())):
        _assert_close(u, w, dtype)
    again = ff_kernel.grouped_ff_dw(p, x, dout, hidden, splits=splits)
    assert all(torch.equal(u, v) for u, v in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_gpu_consensus_forward_takes_rows_off_a_16_byte_boundary(cuda, dtype, offset):
    """The forward kernel on levels whose rows lie off a 16-byte boundary
    (``offset`` elements into a flat buffer, as consensus_pallas.py takes any
    layout): the wrapper copies them into fresh storage and launches the
    kernel, which agrees with the plain version."""
    rng = np.random.default_rng(14)
    shape = (2, 24, 3, 128)
    flat = torch.from_numpy(
        rng.standard_normal(int(np.prod(shape)) + offset).astype(np.float32)).to(cuda, dtype)
    levels = flat[offset:].view(shape)
    assert not consensus_kernel._rows_aligned(levels)
    before = consensus_kernel.consensus_attention.launches
    out, lse = consensus_kernel.consensus_attention(levels)
    assert consensus_kernel.consensus_attention.launches == before + 1
    want, want_lse = plain_consensus.consensus_attention(levels.float())
    _assert_close(out, want, dtype)
    _assert_close(lse, want_lse, torch.float32)


@pytest.mark.gpu
def test_gpu_autograd_through_the_kernels(cuda):
    """The autograd Functions on the card against autograd through the plain
    ops, float32: K1 + K2 + K3 and the consensus forward + K6 + K7."""
    dtype = torch.float32
    rng = np.random.default_rng(12)
    p = _torch(_ff_params(rng, 3, 128, 512), cuda, dtype)
    base = torch.from_numpy(rng.standard_normal((2, 40, 4, 128)).astype(np.float32)).to(cuda, dtype)
    g = torch.from_numpy(rng.standard_normal((2, 40, 3, 128)).astype(np.float32)).to(cuda, dtype)
    grads = []
    for kernels in (True, False):
        lwi = base.clone().requires_grad_(True)
        pg = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        if kernels:
            y = ff_kernel.grouped_ff(pg, lwi[..., :-1, :])
            y = y + consensus_kernel.consensus_attention(y, attend_self=False)[0]
        else:
            y = plain_ff.grouped_ff_apply(pg, lwi[..., :-1, :])
            y = y + plain_consensus.consensus_attention(y, attend_self=False)[0]
        y.backward(g)
        grads.append([lwi.grad] + [pg[k].grad for k in sorted(pg)])
    for got, want in zip(*grads):
        _assert_close(got, want, dtype)


@pytest.mark.gpu
def test_gpu_bf16_loss_backpropagates_through_the_kernels(cuda):
    """compute_dtype bfloat16: the denoising loss through all six kernels
    (their bf16 instances) against the plain ops on the card, to bf16's
    precision, with finite float32 gradients."""
    from glom_tpu_torch.config import GlomConfig, TrainConfig
    from glom_tpu_torch.models import glom as glom_model
    from glom_tpu_torch.training import denoise, optim

    kw = dict(dim=128, levels=3, image_size=32, patch_size=8, compute_dtype="bfloat16")
    train_cfg = TrainConfig(batch_size=2)
    state = denoise.init_state(torch.Generator().manual_seed(0), GlomConfig(**kw),
                               optim.Optimizer(1e-3), device=cuda)
    gen = torch.Generator().manual_seed(1)
    img = torch.randn((2, 3, 32, 32), generator=gen).to(cuda)
    noise = torch.randn((2, 3, 32, 32), generator=gen).to(cuda)
    losses = []
    for impl in ("pallas", "dense"):
        cfg = GlomConfig(**kw, ff_impl=impl, attention_impl=impl, ff_fused_bwd=True)
        loss, grads = denoise.loss_and_grads(denoise.make_loss_fn(cfg, train_cfg),
                                             state.params, img, noise=noise)
        for g in glom_model.tree_leaves(grads):
            assert g.dtype == torch.float32 and torch.isfinite(g).all()
        losses.append(loss.item())
    np.testing.assert_allclose(losses[0], losses[1], rtol=2e-2)


# -- GPU: the fused level update (K8) against its plain version ------------

def _update_inputs(rng, device, dtype, *, b, side, L=3, d=128, h=None, radius=0):
    """One update's inputs on ``device``: levels and the tokens as strided
    views of one (b, n, L+1, d) buffer, as the model's loop holds them."""
    from glom_tpu_torch.kernels import fused_update

    n, h = side * side, h if h is not None else 4 * d
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device, dtype)
    bu, td = _torch(_ff_params(rng, L, d, h), device, dtype), _torch(_ff_params(rng, L - 1, d, h), device, dtype)
    lwi = t(rng.standard_normal((b, n, L + 1, d)))
    pos = t(rng.standard_normal((n, d)))[None, :, None, :]
    mask = torch.from_numpy(local_consensus_mask(side, radius)).to(device) if radius else None
    return fused_update, (bu, td, lwi[..., 1:, :], lwi[..., :1, :], pos), mask


# -- GPU: the forward kernels past d=512 ---------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [640, 768, 1024, 2048])
@pytest.mark.parametrize("side,b", [(24, 2), (48, 1)])
@pytest.mark.parametrize("attend_self,radius", [(False, 0), (True, 0), (False, 1.5)])
@pytest.mark.parametrize("splits", [None, 2])
def test_gpu_wide_consensus_matches_plain(cuda, dtype, d, side, b, attend_self, radius, splits):
    """K4 above d=512 (csrc/consensus_wide.cuh) on the strided levels view
    of the model's loop: n=576 (the large preset) and n=2304 (the K5 route),
    the self-mask, the locality mask, the planned split count and 2; one
    launch a call, two calls the same bits."""
    rng = np.random.default_rng(d + side)
    n = side * side
    lwi = torch.from_numpy(rng.standard_normal((b, n, 3, d)).astype(np.float32)).to(cuda, dtype)
    levels = lwi[..., 1:, :]
    mask = torch.from_numpy(local_consensus_mask(side, radius)).to(cuda) if radius else None
    kw = dict(attend_self=attend_self, non_local_mask=mask)
    before = consensus_kernel.consensus_attention.launches
    with torch.inference_mode():
        got, lse = consensus_kernel.consensus_attention(levels, splits=splits, **kw)
        want, want_lse = plain_consensus.consensus_attention(levels.float(), **kw)
        again, lse_again = consensus_kernel.consensus_attention(levels, splits=splits, **kw)
    assert consensus_kernel.consensus_attention.launches == before + 2
    assert got.dtype == dtype and got.shape == levels.shape
    _assert_close(got, want, dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    assert torch.equal(got, again) and torch.equal(lse, lse_again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [640, 1024])
@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("g", [7, 8])
def test_gpu_wide_grouped_ff_matches_plain(cuda, dtype, d, splits, g):
    """K1 above d=512 on the model's two calls (g=8: the bottom-up strided
    view; g=7: the top-down input), n=70, h=4d."""
    rng = np.random.default_rng(d + g)
    p = _torch(_ff_params(rng, g, d, 4 * d), cuda, dtype)
    lwi = torch.from_numpy(rng.standard_normal((2, 70, g + 1, d)).astype(np.float32)).to(cuda, dtype)
    before = ff_kernel.grouped_ff.launches
    with torch.inference_mode():
        for x in (lwi[..., :-1, :], lwi[..., 1:, :].contiguous()):
            got = ff_kernel.grouped_ff(p, x, splits=splits)
            assert got.dtype == dtype and got.shape == x.shape
            _assert_close(got, plain_ff.grouped_ff_apply(_f32(p), x.float()), dtype)
    assert ff_kernel.grouped_ff.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [640, 1024])
@pytest.mark.parametrize("attend_self,radius", [(False, 0), (True, 0), (False, 1.5)])
@pytest.mark.parametrize("b,side", [(1, 6), (2, 24)])
def test_gpu_wide_fused_update_matches_reference(cuda, dtype, d, attend_self, radius, b, side):
    """K8 above d=512 (its consensus stage the wide design), L=3, h=4d:
    n=36 and n=576; one launch a call."""
    rng = np.random.default_rng(d + side)
    fu, args, mask = _update_inputs(rng, cuda, dtype, b=b, side=side, d=d, radius=radius)
    before = fu.fused_level_update.launches
    with torch.inference_mode():
        got = fu.fused_level_update(*args, attend_self=attend_self, non_local_mask=mask)
        want = _reference(fu, args, mask, attend_self)
    assert fu.fused_level_update.launches == before + 1
    _assert_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [640, 1024])
@pytest.mark.parametrize("attend_self,radius", [(False, 0), (True, 0), (False, 1.5)])
def test_gpu_wide_backward_kernels_match_plain(cuda, dtype, d, attend_self, radius):
    """Above d=512: K2 (the composition through the hidden) and K3 on it, on
    the strided bottom-up view, g=3, 70 rows, h=4d; K6 (the wide design) and
    K7 on its dS', n=36 at b=2, L=3; each against its plain version, two
    calls bitwise, one launch of each a call."""
    rng = np.random.default_rng(d + int(attend_self) + int(radius))
    p = _torch(_ff_params(rng, 3, d, 4 * d), cuda, dtype)
    lwi = torch.from_numpy(rng.standard_normal((2, 35, 4, d)).astype(np.float32)).to(cuda, dtype)
    x = lwi[..., :-1, :]
    g = torch.from_numpy(rng.standard_normal((2, 35, 3, d)).astype(np.float32)).to(cuda, dtype)
    counts = lambda: (ff_kernel.grouped_ff_dx.launches, ff_kernel.grouped_ff_dw.launches,
                      consensus_kernel.consensus_dkv.launches, consensus_kernel.consensus_dq.launches)
    before = counts()
    dx, hidden = ff_kernel.grouped_ff_dx(p, x, g, keep_hidden=True)
    _assert_close(dx, plain_ff.grouped_ff_dx(_f32(p), x.float(), g.float()), dtype)
    assert torch.equal(dx, ff_kernel.grouped_ff_dx(p, x, g))
    dw = ff_kernel.grouped_ff_dw(p, x, g, hidden)
    for got_w, want_w in zip(dw, plain_ff.grouped_ff_dw(_f32(p), x.float(), g.float())):
        _assert_close(got_w, want_w, dtype)
    levels = torch.from_numpy(rng.standard_normal((2, 36, 3, d)).astype(np.float32)).to(cuda, dtype)
    gl = torch.from_numpy(rng.standard_normal((2, 36, 3, d)).astype(np.float32)).to(cuda, dtype)
    mask = torch.from_numpy(local_consensus_mask(6, radius)).to(cuda) if radius else None
    kw = dict(attend_self=attend_self, non_local_mask=mask)
    with torch.no_grad():
        out, lse = plain_consensus.consensus_attention(levels, **kw)
    delta = (gl.float() * out.float()).sum(-1).permute(0, 2, 1).unsqueeze(-1).contiguous()
    key_term, _ = plain_consensus.consensus_dkv_terms(levels.float(), gl.float(), lse, delta, **kw)
    dkv, ds = consensus_kernel.consensus_dkv(levels, gl, lse, delta, keep_ds=True, **kw)
    dq = consensus_kernel.consensus_dq(levels, gl, lse, delta, ds=ds, **kw)
    _assert_close(dkv, plain_consensus.consensus_dkv(levels.float(), gl.float(), lse, delta, **kw),
                  dtype, key_term)
    _assert_close(dq, plain_consensus.consensus_dq(levels.float(), gl.float(), lse, delta, **kw),
                  dtype)
    assert not ds[..., 36:].any()
    assert torch.equal(dkv, consensus_kernel.consensus_dkv(levels, gl, lse, delta, **kw))
    assert counts() == (before[0] + 2, before[1] + 1, before[2] + 2, before[3] + 1)


def _reference(fused_update, args, mask, attend_self):
    """K8's plain version on the kernel's inputs: the composition in float32,
    rounded once to their type."""
    return fused_update.plain_update(*args, mask, attend_self=attend_self)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("attend_self,radius", [(False, 0), (True, 0), (False, 1.5)])
@pytest.mark.parametrize("b,side", [(1, 5), (8, 5), (2, 16), (1, 32)])
def test_gpu_fused_update_matches_reference(cuda, dtype, attend_self, radius, b, side):
    """side 5: n=25, a ragged tile and key block; 16: n=256; 32: n=1024, the
    largest the fused path is chosen for.  One launch a call."""
    rng = np.random.default_rng(11)
    fu, args, mask = _update_inputs(rng, cuda, dtype, b=b, side=side, radius=radius)
    before = fu.fused_level_update.launches
    with torch.inference_mode():
        got = fu.fused_level_update(*args, attend_self=attend_self, non_local_mask=mask)
        want = _reference(fu, args, mask, attend_self)
    assert fu.fused_level_update.launches == before + 1
    assert got.dtype == dtype and got.shape == args[2].shape and got.is_contiguous()
    _assert_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,L", [(128, 64, 2), (256, 192, 3), (384, 1536, 4), (512, 2048, 6)])
def test_gpu_fused_update_widths_and_hidden_edges(cuda, dtype, d, h, L):
    """Every width the kernel takes; h = 64 (one chunk of K1's, four of K8's)
    and 192 (not a power of two); L = 2, where level 0 reads the tokens and
    level 1 is the top."""
    rng = np.random.default_rng(12)
    fu, args, _ = _update_inputs(rng, cuda, dtype, b=2, side=6, L=L, d=d, h=h)
    with torch.inference_mode():
        got = fu.fused_level_update(*args)
        want = _reference(fu, args, None, False)
    _assert_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side,h,radius", [(5, 192, 1.5), (16, 512, 0)])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_gpu_fused_update_splits_agree(cuda, dtype, side, h, radius, splits):
    """A tile's hidden chunks and keys shared by up to 8 blocks, their partial
    terms combined by the second kernel.  side 5, h 192: one key block and
    three hidden chunks, so with 8 splits most blocks have no key and five no
    chunk; side 16, h 512: uneven shares with 3 splits.  Two runs give the
    same bits, and a call counts as one launch."""
    rng = np.random.default_rng(15)
    fu, args, mask = _update_inputs(rng, cuda, dtype, b=2, side=side, h=h, radius=radius)
    before = fu.fused_level_update.launches
    with torch.inference_mode():
        got = fu.fused_level_update(*args, non_local_mask=mask, splits=splits)
        again = fu.fused_level_update(*args, non_local_mask=mask, splits=splits)
        want = _reference(fu, args, mask, False)
    assert fu.fused_level_update.launches == before + 2
    assert torch.equal(got, again)
    _assert_close(got, want, dtype)
    with pytest.raises(ValueError, match="splits"):
        fu.fused_level_update(*args, splits=9)


@pytest.mark.gpu
def test_gpu_fused_update_reads_views_and_refuses_misaligned_rows(cuda):
    """Contiguous copies of the strided views give the same bits; two runs
    give the same bits.  Inputs whose rows lie 1-3 elements off the
    kernels' 16-byte boundary are copied into fresh storage, not refused (as
    glom_tpu's kernel takes any layout), and agree with the plain version in
    float32 and bfloat16, one launch a call; a width the kernels do not take
    is still refused by name."""
    rng = np.random.default_rng(13)
    fu, args, _ = _update_inputs(rng, cuda, torch.float32, b=2, side=5)
    bu, td, levels, bottom, pos = args
    assert not levels.is_contiguous()
    with torch.inference_mode():
        a = fu.fused_level_update(bu, td, levels, bottom, pos)
        again = fu.fused_level_update(bu, td, levels, bottom, pos)
        c = fu.fused_level_update(bu, td, levels.contiguous(), bottom.contiguous(), pos.contiguous())
    assert torch.equal(a, again) and torch.equal(a, c)
    for dtype in (torch.float32, torch.bfloat16):
        fu, (bu, td, levels, bottom, pos), _ = _update_inputs(rng, cuda, dtype, b=2, side=5)
        for offset in (1, 2, 3):
            def shifted(t):
                flat = torch.zeros(t.numel() + offset, dtype=dtype, device=cuda)
                return flat[offset:].view(t.shape).copy_(t)

            views = (shifted(levels), shifted(bottom), shifted(pos))
            assert not any(fu._rows_aligned(t) for t in views)
            before = fu.fused_level_update.launches
            with torch.inference_mode():
                got = fu.fused_level_update(bu, td, *views)
            assert fu.fused_level_update.launches == before + 1
            _assert_close(got, _reference(fu, (bu, td, levels, bottom, pos), None, False), dtype)
    # a width off a multiple of 128 runs on zero-padded copies, one launch
    def narrow_net(p):
        return {"w1": p["w1"][:, :96].contiguous(), "b1": p["b1"],
                "w2": p["w2"][..., :96].contiguous(), "b2": p["b2"][..., :96].contiguous()}

    narrow = (narrow_net(bu), narrow_net(td), levels[..., :96], bottom[..., :96], pos[..., :96])
    before = fu.fused_level_update.launches
    with torch.inference_mode():
        got = fu.fused_level_update(*narrow)
    assert fu.fused_level_update.launches == before + 1 and got.shape[-1] == 96
    _assert_close(got, _reference(fu, narrow, None, False), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8])
def test_gpu_fused_update_rounds_once_in_bf16(cuda, b):
    """In bfloat16 K8 forms every term in float32, the consensus term
    included (K4's kernel with a float32 output), its f32 top-down input
    with its low tf32 part, and rounds once at its store: all but a few in
    ten thousand elements are the bits of the float32 composition rounded
    once (plain_update).  An operand cut to tf32 on its way (the first
    design's top-down input) moved about 1.5 % of them.  b=1 runs K8b with
    the split its planner picks there."""
    rng = np.random.default_rng(16)
    fu, args, _ = _update_inputs(rng, cuda, torch.bfloat16, b=b, side=16, d=256, h=512)
    before = fu.fused_level_update.launches
    with torch.inference_mode():
        got = fu.fused_level_update(*args)
        want = _reference(fu, args, None, False)
    assert fu.fused_level_update.launches == before + 1
    _assert_close(got, want, torch.bfloat16)
    same = (got == want).float().mean().item()
    assert same >= 0.999, same


@pytest.mark.gpu
@pytest.mark.parametrize("ff_fused_bwd", [True, False])
def test_gpu_fused_update_autograd_runs_the_unfused_kernels(cuda, ff_fused_bwd):
    """K8 forward; the backward launches K1 twice and K4 once again, then K2,
    K3 (with ff_fused_bwd), K6 and K7, and gives the gradients of the plain
    composition, under torch.utils.checkpoint too."""
    from torch.utils.checkpoint import checkpoint

    rng = np.random.default_rng(14)
    fu, args, mask = _update_inputs(rng, cuda, torch.float32, b=2, side=6, radius=1.5)
    g = torch.from_numpy(rng.standard_normal(tuple(args[2].shape)).astype(np.float32)).to(cuda)

    def leaves():
        bu, td, levels, bottom, pos = args
        fresh = lambda t: t.detach().clone().requires_grad_(True)
        return [{k: fresh(v) for k, v in bu.items()}, {k: fresh(v) for k, v in td.items()},
                fresh(levels), fresh(bottom), fresh(pos)]

    def flat(ls):
        return list(ls[0].values()) + list(ls[1].values()) + ls[2:]

    ref = leaves()
    fu.reference_update(*ref, mask).backward(g)
    counters = {"k8": fu.fused_level_update, "k1": ff_kernel.grouped_ff,
                "k2": ff_kernel.grouped_ff_dx, "k3": ff_kernel.grouped_ff_dw,
                "k4": consensus_kernel.consensus_attention, "k6": consensus_kernel.consensus_dkv,
                "k7": consensus_kernel.consensus_dq}
    bwd = 2 if ff_fused_bwd else 0
    for wrap in (False, True):
        mine = leaves()
        before = {k: f.launches for k, f in counters.items()}
        step = lambda lv: fu.fused_level_update(mine[0], mine[1], lv, mine[3], mine[4],
                                                non_local_mask=mask, ff_fused_bwd=ff_fused_bwd)
        out = checkpoint(step, mine[2], use_reentrant=False) if wrap else step(mine[2])
        out.backward(g)
        got = {k: f.launches - before[k] for k, f in counters.items()}
        assert got == {"k8": 2 if wrap else 1, "k1": 2, "k2": bwd, "k3": bwd, "k4": 1, "k6": 1,
                       "k7": 1}, got
        for a, w in zip(flat(mine), flat(ref)):
            _assert_close(a.grad, w.grad, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("ff_impl", ["pallas", "fused", "dense"])
def test_gpu_remat_dots_gives_the_unwrapped_steps_loss_and_gradients(cuda, ff_impl):
    """remat_policy="dots" on the card (models/glom.py::_save_dots through
    selective checkpointing): the kernels' autograd Functions launch through
    ctypes, out of the dispatch mode's sight, so nothing of theirs is kept
    and the backward recomputes them; on the kernel paths "dots" launches
    what "full" launches.  Loss and gradients are those of remat=False, and
    the plain path's kept products give them too."""
    from glom_tpu_torch.config import GlomConfig
    from glom_tpu_torch.kernels import wrappers
    from glom_tpu_torch.models import glom as glom_model

    attention = "dense" if ff_impl == "dense" else "pallas"
    base = GlomConfig(dim=128, levels=3, image_size=32, patch_size=8, ff_impl=ff_impl,
                      attention_impl=attention, ff_fused_bwd=True)
    params0 = glom_model.init(torch.Generator().manual_seed(0), base, device=cuda)
    img = torch.randn((2, 3, 32, 32), generator=torch.Generator().manual_seed(1)).to(cuda)

    def run(**kw):
        cfg = GlomConfig(**{**base.to_json_dict(), **kw})
        params = glom_model.tree_map(lambda p: p.detach().clone().requires_grad_(True), params0)
        before = {k: f.launches for k, f in wrappers().items()}
        final, captured = glom_model.apply(params, img, config=cfg, iters=4, capture_timestep=2)
        loss = (captured ** 2).mean() + (final ** 2).mean()
        loss.backward()
        launched = {k: f.launches - before[k] for k, f in wrappers().items()}
        return loss.detach(), glom_model.tree_leaves(params), launched

    plain_loss, plain_params, plain_launched = run(remat=False)
    dots_loss, dots_params, dots_launched = run(remat=True, remat_policy="dots")
    _, _, full_launched = run(remat=True, remat_policy="full")
    assert torch.equal(dots_loss, plain_loss)
    for a, w in zip(dots_params, plain_params):
        err = torch.linalg.vector_norm(a.grad - w.grad) / torch.linalg.vector_norm(w.grad)
        assert err <= 1e-6, err.item()
    assert dots_launched == full_launched
    if ff_impl == "dense":
        assert not any(plain_launched.values())
    else:
        # the recompute runs each forward kernel once more
        forward = "fused_level_update" if ff_impl == "fused" else "grouped_ff"
        assert dots_launched[forward] == 2 * plain_launched[forward] > 0


@pytest.mark.gpu
def test_gpu_profiling_reads_the_cards_memory(cuda, tmp_path):
    """profiling.memory_analysis measures one call's peak on the card (an
    allocation of 64 MB inside the call shows), and device_memory_profile
    writes the allocator's snapshot."""
    import pickle

    from glom_tpu_torch import profiling

    x = torch.ones(1024, device=cuda)
    mem = profiling.memory_analysis(lambda t: (t.repeat(16384) * 2).sum(), x)
    assert mem["temp_bytes"] >= 2 * 64 * 2 ** 20 and mem["peak_bytes"] >= mem["resident_bytes"]
    path = tmp_path / "snapshot.pickle"
    profiling.device_memory_profile(str(path))
    with open(path, "rb") as f:
        assert "segments" in pickle.load(f)
