"""GLOM-level diagnostics (``glom_tpu/obs/diagnostics.py``): watching island
formation during training.

Three numbers a diagnostics point, at a cadence the trainer controls
(``TrainConfig.diag_every``), never per step:

  * per-level island agreement — mean 4-neighbour cosine agreement of the
    final state (:func:`glom_tpu_torch.models.islands.neighbor_agreement`,
    the one definition);
  * consensus attention entropy — mean softmax entropy per level of the
    dense consensus distribution over the final state (high = columns
    still averaging everyone, low = committed islands);
  * per-contribution norm shares — relative L2 mass of the four update
    terms (prev state, bottom-up, top-down, attention) in one extra GLOM
    iteration from the final state.

The forward and the extra iteration run through the trainer's own
consensus and FF functions: on a card the kernels the config names (K1 and
K4, or K8 for the forward on ``"fused"``).  The entropy recomputes the
dense logits from the final state rather than instrumenting the loop, so
the diagnostics describe the model state whichever path computed it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.models.islands import neighbor_agreement
from glom_tpu_torch.ops.consensus import TOKEN_ATTEND_SELF_VALUE, l2_normalize


def _attention_entropy(levels: torch.Tensor, config: GlomConfig) -> torch.Tensor:
    """Mean consensus-softmax entropy per level, ``(L,)`` nats: the dense
    reference logits (soft self-mask, hard locality mask) of the final
    state, O(n^2) once a diagnostics point."""
    d = levels.shape[-1]
    sim = torch.einsum("bild,bjld->blij", levels, l2_normalize(levels, dim=-1)) * (d ** -0.5)
    if not config.consensus_self:
        n = levels.shape[1]
        eye = torch.eye(n, dtype=torch.bool, device=levels.device)
        sim = sim.masked_fill(eye, TOKEN_ATTEND_SELF_VALUE)
    mask = glom_model.resolve_locality_mask(config, levels.device)
    if mask is not None:
        sim = sim.masked_fill(mask, -torch.finfo(sim.dtype).max)
    logp = torch.log_softmax(sim.float(), dim=-1)
    ent = -torch.sum(torch.exp(logp) * logp, dim=-1)      # (b, L, n)
    return ent.mean(dim=(0, 2))


def _contribution_shares(params, levels: torch.Tensor, tokens: torch.Tensor,
                         config: GlomConfig, consensus_fn, ff_fn) -> Dict[str, torch.Tensor]:
    """Relative L2 mass of the four update terms in one GLOM iteration from
    ``levels``, with the term layout of ``models/glom.py::_update_step``."""
    pos_embs = params["pos_emb"][None, :, None, :].to(levels.dtype)
    bottom = tokens[:, :, None, :]
    stacked = torch.cat([bottom, levels], dim=-2)
    bu = ff_fn(params["bottom_up"], stacked[..., :-1, :])
    td = ff_fn(params["top_down"], stacked[..., 2:, :] + pos_embs)
    td = F.pad(td, (0, 0, 0, 1))
    att = consensus_fn(levels)

    def mass(x):
        return torch.sqrt(torch.sum(x.float() ** 2))

    norms = {"prev": mass(levels), "bottom_up": mass(bu),
             "top_down": mass(td), "attention": mass(att)}
    total = sum(norms.values()) + 1e-12
    return {f"contrib_share_{k}": v / total for k, v in norms.items()}


def make_diagnostics_fn(config: GlomConfig, *, iters: Optional[int] = None, consensus_fn=None,
                        ff_fn=None, fused_fn=None, device=None):
    """``(glom_params, img) -> {name: tensor}``: ``island_agreement`` (L,),
    ``attn_entropy`` (L,) and the four ``contrib_share_*`` scalars, computed
    without gradients.  Functions not given are the config's on ``device``
    (the card by default), by ``glom_tpu``'s rule: with ``ff_impl="fused"``,
    none injected and the fused update supported, the forward runs K8 and
    the extra iteration the grouped FF and the consensus."""
    c = config
    n_iters = iters if iters is not None else c.default_iters
    if (fused_fn is None and consensus_fn is None and ff_fn is None
            and glom_model.fused_update_supported(c, device)):
        fused_fn = glom_model.make_fused_update_fn(c, device)
    if consensus_fn is None:
        consensus_fn = glom_model.make_consensus_fn(c, device)
    if ff_fn is None:
        ff_fn = glom_model.make_ff_fn(c)

    @torch.no_grad()
    def diag_fn(glom_params, img):
        params_c, img_c, compute_dtype = glom_model.cast_for_compute(glom_params, img, c)
        final = glom_model.apply(glom_params, img, config=c, iters=n_iters,
                                 consensus_fn=consensus_fn, ff_fn=ff_fn, fused_fn=fused_fn)
        out = {
            "island_agreement": neighbor_agreement(final, c.num_patches_side).mean(
                dim=(0, 2, 3)),
            "attn_entropy": _attention_entropy(final, c),
        }
        tokens, _ = glom_model.embed_inputs(params_c, img_c, c)
        out.update(_contribution_shares(params_c, final.to(compute_dtype), tokens, c,
                                        consensus_fn, ff_fn))
        # by key, as glom_tpu's jitted function returns its dict: the
        # records' and the CSV's column order follow it
        return dict(sorted(out.items()))

    return diag_fn


def flatten_diagnostics(diag: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Host-side flattening to JSONL-ready scalars: vectors indexed per
    level (``island_agreement_L0`` ... plus the ``island_agreement`` mean),
    scalars passed through."""
    out: Dict[str, float] = {}
    for k, v in diag.items():
        arr = np.asarray(v.detach().float().cpu() if isinstance(v, torch.Tensor) else v)
        if arr.ndim == 0:
            out[k] = float(arr)
        else:
            for i, x in enumerate(arr.ravel()):
                out[f"{k}_L{i}"] = float(x)
            out[k] = float(arr.mean())
    return out


def glom_diagnostics(params: dict, img, *, config: GlomConfig, iters: Optional[int] = None,
                     consensus_fn=None, ff_fn=None) -> Dict[str, float]:
    """One-shot convenience (build, run, flatten) on the device of
    ``params``; loops build the function once with
    :func:`make_diagnostics_fn`."""
    device = glom_model.tree_leaves(params)[0].device
    fn = make_diagnostics_fn(config, iters=iters, consensus_fn=consensus_fn, ff_fn=ff_fn,
                             device=device)
    return flatten_diagnostics(fn(params, torch.as_tensor(img).to(device, torch.float32)))
