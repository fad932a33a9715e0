"""The port's ``remat_policy`` against glom_tpu's on the CPU: what a remat
step saves for its backward.

glom_tpu's "dots" (``jax.checkpoint_policies.checkpoint_dots``) keeps the
outputs of the step's matrix products and recomputes the elementwise work;
"full" keeps only the step's input.  So on the plain path the elements saved
under "dots" lie strictly between "full" and no remat.  On the kernel paths
a ``pallas_call`` is not a dot, and "dots" saves what "full" saves.  The
port must compare the same way.

Counts: glom_tpu's with ``saved_residuals`` on ``glom.apply``; the port's
with ``saved_tensors_hooks`` on ``apply`` (every tensor autograd saves,
``torch.utils.checkpoint``'s own inputs included) plus what selective
checkpointing keeps for "dots", which does not pass through those hooks: the
outputs for which the port's policy, ``models/glom.py::_save_dots``, says
``MUST_SAVE``.  The config is ``dim=32, levels=3, image_size=16,
patch_size=4``, b=2, 4 iterations, float32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals

from glom_tpu import config as jax_config
from glom_tpu.models import glom as jax_glom
from glom_tpu_torch import convert
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.serving.engine import demo_params

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)
REMATS = {"none": dict(remat=False), "dots": dict(remat=True, remat_policy="dots"),
          "full": dict(remat=True, remat_policy="full")}


def _kw(ff_impl, remat):
    kw = dict(ff_impl=ff_impl, ff_fused_bwd=True, **REMATS[remat])
    if ff_impl == "pallas":
        kw["attention_impl"] = "pallas"
    return kw


def _img():
    return np.random.default_rng(1).standard_normal((2, 3, 16, 16)).astype(np.float32)


def _tree():
    return demo_params(GlomConfig(**TINY), TrainConfig(), 0)["glom"]


def port_saved(ff_impl, remat, monkeypatch):
    """``(elements saved, loss, gradients)`` of the port's forward of 4
    iterations and the backward of a mean-square loss."""
    cfg = GlomConfig(**TINY, **_kw(ff_impl, remat))
    params = glom_model.tree_map(lambda p: p.requires_grad_(True),
                                 convert.params_from_numpy(_tree(), cfg, "cpu"))
    saved = [0]
    policy = glom_model._save_dots

    def counted_policy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if decision == glom_model.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            saved[0] += ctx.op_output.numel()
        return decision

    monkeypatch.setattr(glom_model, "_save_dots", counted_policy)

    def pack(t):
        saved[0] += t.numel()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = glom_model.apply(params, torch.from_numpy(_img()), config=cfg, iters=4)
    loss = (out ** 2).mean()
    loss.backward()
    grads = glom_model.tree_map(lambda p: p.grad.numpy().copy(), params)
    return saved[0], loss.item(), grads


def glom_tpu_saved(ff_impl, remat):
    cfg = jax_config.GlomConfig(**TINY, **_kw(ff_impl, remat))
    tree = jax.tree_util.tree_map(jnp.asarray, _tree())
    img = jnp.asarray(_img())
    res = saved_residuals(lambda p: jax_glom.apply(p, img, config=cfg, iters=4), tree)
    return sum(int(np.prod(aval.shape)) for aval, _ in res)


def test_dots_saves_between_full_and_no_remat_on_the_plain_path(monkeypatch):
    """The repair's pin: on the dense path "dots" keeps the products'
    outputs (before the repair it saved 13,824 under both policies), so its
    count lies strictly between "full" and no remat, as glom_tpu's does;
    loss and gradients are those of no remat."""
    port = {r: port_saved("dense", r, monkeypatch) for r in REMATS}
    ref = {r: glom_tpu_saved("dense", r) for r in REMATS}
    assert ref["full"] < ref["dots"] < ref["none"], ref
    counts = {r: v[0] for r, v in port.items()}
    assert counts["full"] < counts["dots"] < counts["none"], counts
    # what "dots" adds is the products' outputs: per iteration the two FF
    # layers of both nets in float32 and the two consensus products
    c, b, it = GlomConfig(**TINY), 2, 4
    n, L, d, h = c.num_patches, c.levels, c.dim, c.dim * c.ff_mult
    products = it * b * (n * (2 * L - 1) * (h + d) + L * (n * n + n * d))
    assert counts["dots"] - counts["full"] == products
    for r in ("dots", "full"):
        assert port[r][1] == port["none"][1]
        for k in ("bottom_up", "top_down", "patch_embed"):
            for leaf in port["none"][2][k]:
                np.testing.assert_allclose(port[r][2][k][leaf], port["none"][2][k][leaf],
                                           rtol=1e-6, atol=1e-9, err_msg=f"{r} {k}/{leaf}")


@pytest.mark.parametrize("ff_impl", ["pallas", "fused"])
def test_on_the_kernel_paths_dots_saves_what_full_saves_as_in_glom_tpu(ff_impl, monkeypatch):
    """A kernel's autograd Function is opaque to the policy, as a pallas_call
    is to checkpoint_dots: on the "pallas" and "fused" paths (their plain
    versions here) "dots" and "full" compare as glom_tpu's do."""
    port = {r: port_saved(ff_impl, r, monkeypatch)[0] for r in REMATS}
    ref = {r: glom_tpu_saved(ff_impl, r) for r in REMATS}
    assert ref["dots"] == ref["full"] <= ref["none"], ref
    assert port["dots"] == port["full"] < port["none"], port
