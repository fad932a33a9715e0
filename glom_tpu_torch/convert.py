"""Weight conversion (``glom_tpu/convert.py``).

* :func:`params_from_numpy` / :func:`params_to_numpy`: the JAX package's
  parameter tree as numpy arrays <-> the port's tree of tensors.  The names
  and shapes are the same, so this is a dtype and device move.
* :func:`from_reference_state_dict` / :func:`to_reference_state_dict`: the
  reference PyTorch ``Glom.state_dict()`` <-> the port's tree.  The
  reference implements the per-level MLPs as grouped 1x1 ``Conv1d``
  (weights ``(g*d_out, d_in, 1)``); here they are stacked ``(g, d_in,
  d_out)`` matrices.  Reference keys:

      image_to_tokens.1.{weight,bias}   Linear(p^2*3, dim)
      pos_emb.weight                    Embedding(n, dim)
      init_levels                       (L, dim)
      bottom_up.net.{1,3}.{weight,bias} Conv1d, groups=L
      top_down.net.{1,3}.{weight,bias}  Conv1d, groups=L-1
      (attention.non_local_mask)        buffer, only with a locality radius
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.models.glom import tree_map
from glom_tpu_torch.ops.masks import local_consensus_mask


def params_from_numpy(tree: dict, config: GlomConfig, device=None) -> dict:
    """numpy tree -> tensors in ``config.param_dtype`` on ``device``."""
    return tree_map(
        lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))
        .to(device=device, dtype=config.param_dtype),
        tree,
    )


def params_to_numpy(params: dict) -> dict:
    """Tensors -> float32 numpy tree (bf16 has no numpy dtype)."""
    return tree_map(lambda t: t.detach().to("cpu", torch.float32).numpy(), params)


def _conv_to_stack(weight: torch.Tensor, bias: torch.Tensor, groups: int):
    out_ch, d_in, k = weight.shape
    if k != 1 or out_ch % groups:
        raise ValueError(f"unexpected conv weight shape {tuple(weight.shape)} for {groups} groups")
    d_out = out_ch // groups
    w = weight[..., 0].reshape(groups, d_out, d_in).transpose(1, 2)
    return w.contiguous(), bias.reshape(groups, d_out).contiguous()


def _stack_to_conv(w: torch.Tensor, b: torch.Tensor):
    g, d_in, d_out = w.shape
    return (w.transpose(1, 2).reshape(g * d_out, d_in, 1).contiguous(),
            b.reshape(g * d_out).contiguous())


def from_reference_state_dict(state_dict: Dict[str, object], config: GlomConfig,
                              device=None) -> dict:
    """Reference ``Glom.state_dict()`` (tensors or arrays) -> the port's tree."""
    sd = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
          for k, v in state_dict.items()}
    L = config.levels

    def ff(prefix, groups):
        w1, b1 = _conv_to_stack(sd[f"{prefix}.net.1.weight"], sd[f"{prefix}.net.1.bias"], groups)
        w2, b2 = _conv_to_stack(sd[f"{prefix}.net.3.weight"], sd[f"{prefix}.net.3.bias"], groups)
        return {"w1": w1, "b1": b1, "w2": w2, "b2": b2}

    params = {
        # torch Linear weight is (out, in); the tree stores (in, out)
        "patch_embed": {"w": sd["image_to_tokens.1.weight"].T.contiguous(),
                        "b": sd["image_to_tokens.1.bias"]},
        "pos_emb": sd["pos_emb.weight"],
        "init_levels": sd["init_levels"],
        "bottom_up": ff("bottom_up", L),
        "top_down": ff("top_down", L - 1),
    }
    return tree_map(lambda t: t.to(device=device, dtype=config.param_dtype), params)


def to_reference_state_dict(params: dict, config: GlomConfig) -> Dict[str, torch.Tensor]:
    """The port's tree -> reference-layout ``state_dict`` (CPU tensors)."""
    p = tree_map(lambda t: t.detach().cpu(), params)
    sd = {
        "image_to_tokens.1.weight": p["patch_embed"]["w"].T.contiguous(),
        "image_to_tokens.1.bias": p["patch_embed"]["b"],
        "pos_emb.weight": p["pos_emb"],
        "init_levels": p["init_levels"],
    }
    for prefix in ("bottom_up", "top_down"):
        w1, b1 = _stack_to_conv(p[prefix]["w1"], p[prefix]["b1"])
        w2, b2 = _stack_to_conv(p[prefix]["w2"], p[prefix]["b2"])
        sd.update({f"{prefix}.net.1.weight": w1, f"{prefix}.net.1.bias": b1,
                   f"{prefix}.net.3.weight": w2, f"{prefix}.net.3.bias": b2})
    if config.local_consensus_radius > 0:
        sd["attention.non_local_mask"] = torch.from_numpy(local_consensus_mask(
            config.num_patches_side, config.local_consensus_radius))[None]
    return sd
