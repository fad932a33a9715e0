"""The port's kernel wrappers (glom_tpu_torch.kernels).

On the CPU a wrapper takes its kernel's plain version; these tests hold that
against glom_tpu's Pallas kernels run in interpret mode (float32, 1e-5
absolute: one op, summation order only).  The tests marked ``gpu`` hold each
CUDA kernel against its plain version on the card, in float32 and bfloat16;
without a card they skip.  They import no JAX, so on the GPU machine (which
has none) they run alone:

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from glom_tpu_torch.kernels import _build
from glom_tpu_torch.kernels import consensus as consensus_kernel
from glom_tpu_torch.kernels import ff as ff_kernel
from glom_tpu_torch.ops import consensus as plain_consensus
from glom_tpu_torch.ops import feedforward as plain_ff
from glom_tpu_torch.ops.masks import local_consensus_mask

ATOL = 1e-5
# on the card: float32 differs by summation order; bfloat16 outputs may
# round to a neighbouring value (2**-8 relative)
GPU_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


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


# -- what the wrappers refuse -------------------------------------------------

def _good_ff(d=128, g=2, h=256, dtype=torch.float32):
    rng = np.random.default_rng(2)
    return _torch(_ff_params(rng, g, d, h), dtype=dtype), torch.zeros((2, 4, g, d), dtype=dtype)


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
        p, x = _good_ff(d=96, h=256)
        err = ValueError
    elif case == "hidden":
        p, x = _good_ff(h=96)
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
        levels = torch.zeros((2, 8, 3, 640))
    elif case == "mask_shape":
        mask = torch.zeros((8, 7), dtype=torch.bool)
    elif case == "mask_dtype":
        mask, err = torch.zeros((8, 8), dtype=torch.float32), TypeError
    else:
        levels = torch.zeros((2, 8, 128, 3)).transpose(2, 3)
    with pytest.raises(err):
        consensus_kernel._check(levels, mask)


def test_wrappers_refuse_grad_and_other_devices():
    p, x = _good_ff()
    x.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="queue 2"):
        ff_kernel.grouped_ff(p, x)
    with pytest.raises(NotImplementedError, match="queue 2"):
        consensus_kernel.consensus_attention(torch.zeros((1, 4, 2, 8), requires_grad=True))
    # neither a CUDA nor a CPU tensor: no plain-version fallback either
    meta = torch.zeros((1, 4, 2, 128), device="meta")
    with pytest.raises(ValueError):
        consensus_kernel.consensus_attention(meta)
    with torch.inference_mode(), pytest.raises(ValueError):
        ff_kernel.grouped_ff({k: v.to("meta") for k, v in p.items()}, meta)


def test_build_lists_sources_and_needs_nvcc(monkeypatch):
    assert set(_build.sources()) == {"grouped_ff", "consensus"}
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


def _assert_close(got, want, dtype):
    atol, rtol = GPU_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,n", [(128, 20), (384, 70), (512, 64)])
@pytest.mark.parametrize("splits", [None, 1, 3])
def test_gpu_grouped_ff_matches_plain(cuda, dtype, d, n, splits):
    """splits None: the planned count (several, at these few rows); 1: the
    block writes the output itself; 3: uneven shares of the hidden chunks."""
    rng = np.random.default_rng(3)
    p = _torch(_ff_params(rng, 3, d, 4 * d), cuda, dtype)
    lwi = torch.from_numpy(rng.standard_normal((2, n, 4, d)).astype(np.float32)).to(cuda, dtype)
    before = ff_kernel.grouped_ff.launches
    with torch.inference_mode():
        for x in (lwi[..., :-1, :], lwi[..., 1:, :].contiguous()):
            got = ff_kernel.grouped_ff(p, x, splits=splits)
            assert got.dtype == dtype and got.shape == x.shape
            _assert_close(got, plain_ff.grouped_ff_apply(p, x), dtype)
    assert ff_kernel.grouped_ff.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("attend_self,radius", [(False, 0), (True, 0), (False, 1.5)])
@pytest.mark.parametrize("side", [5, 16, 48])
@pytest.mark.parametrize("splits", [None, 1, 3])
def test_gpu_consensus_matches_plain(cuda, dtype, attend_self, radius, side, splits):
    """side 5: n=25, a ragged key block; 48: n=2304, the streamed regime.
    splits None: the planned count; 1: one block takes every key; 3: the
    keys shared by up to 3 blocks (one at n=25, whose keys are one block)."""
    rng = np.random.default_rng(4)
    n = side * side
    b = 1 if n > 1024 else 2
    levels = torch.from_numpy(rng.standard_normal((b, n, 3, 128)).astype(np.float32)).to(cuda, dtype)
    mask = (torch.from_numpy(local_consensus_mask(side, radius)).to(cuda)
            if radius else None)
    before = consensus_kernel.consensus_attention.launches
    with torch.inference_mode():
        got, lse = consensus_kernel.consensus_attention(
            levels, attend_self=attend_self, non_local_mask=mask, splits=splits)
        want, want_lse = plain_consensus.consensus_attention(
            levels, attend_self=attend_self, non_local_mask=mask)
    assert consensus_kernel.consensus_attention.launches == before + 1
    _assert_close(got, want, dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
