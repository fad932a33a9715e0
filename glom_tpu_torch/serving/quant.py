"""Reduced-precision serving: int8 weights and bf16 activations
(``glom_tpu/serving/quant.py``).

Three quant modes, one per engine:

  * ``f32``  -- the checkpoint's own dtype; the accuracy reference;
  * ``bf16`` -- every float leaf cast to bf16 on the host before it moves
    to the card (half the resident bytes), and bf16 compute;
  * ``int8`` -- weight-only symmetric per-output-channel int8: each matrix
    leaf (dict key ``w``, ``w1`` or ``w2``) is stored as ``{"int8_q": int8,
    "int8_scale": f32}`` and dequantized to bf16 inside the forward (inside
    the captured graph), the product taken in f32 and rounded to bf16 once;
    every other float leaf (biases, the position and init embeddings) is
    cast to bf16.  Activations run in bf16.

The hand kernels take a weight only in the activation's dtype
(``kernels/ff.py``), so under both reduced modes every weight and bias
reaches K1 and K8 as bf16.  The int8 codes and scales are computed in numpy
by ``glom_tpu``'s arithmetic, bit for bit.  A bf16 leaf is a torch tensor:
numpy has no bf16 dtype.

:func:`accuracy_report` is the accuracy harness
(``python -m glom_tpu_torch.tools.quant_check``): per-level cosine and
max-abs error of each mode against f32 on both endpoints, judged by
:data:`ACCURACY_THRESHOLDS`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

QUANT_MODES = ("f32", "bf16", "int8")

# Acceptance thresholds per quant mode (glom_tpu's, unchanged): cosine
# similarity against the f32 reference (per level for /embed, whole tensor
# for /reconstruct) at least `cosine`, and the max abs error over the f32
# output's abs max at most `max_abs_rel`.
ACCURACY_THRESHOLDS = {
    "bf16": {"cosine": 0.995, "max_abs_rel": 0.05},
    "int8": {"cosine": 0.99, "max_abs_rel": 0.10},
}

_QKEY, _SKEY = "int8_q", "int8_scale"
# every matmul weight of the parameter trees sits under one of these keys;
# biases and the position/init embeddings never do
_MATMUL_KEYS = frozenset({"w", "w1", "w2"})


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and _QKEY in x and _SKEY in x


def _is_float(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    return np.issubdtype(np.asarray(leaf).dtype, np.floating)


def _host_f32(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", torch.float32).numpy()
    return np.asarray(leaf, dtype=np.float32)


def _quantize_leaf_int8(w32: np.ndarray) -> dict:
    """Symmetric per-output-channel int8, the scale taken over the
    input-feature axis only (axis -2): the grouped ``(L, d, h)`` nets get a
    ``(L, 1, h)`` scale, one per (level, channel)."""
    amax = np.max(np.abs(w32), axis=-2, keepdims=True)
    scale = (amax / 127.0 + np.float32(amax == 0.0)).astype(np.float32)
    q = np.clip(np.rint(w32 / scale), -127, 127).astype(np.int8)
    return {_QKEY: torch.from_numpy(q), _SKEY: torch.from_numpy(scale)}


def quantize_tree(params, mode: str):
    """Host-side quantization of a parameter tree (nested dicts of tensors
    or numpy arrays) for serving.

    ``f32`` returns the tree unchanged; ``bf16`` casts the float leaves to
    bf16 tensors; ``int8`` replaces the matmul weights (key ``w``, ``w1`` or
    ``w2``, two axes or more) with ``{"int8_q", "int8_scale"}`` records and
    casts the other float leaves to bf16.  Leaves of the result are CPU
    tensors (a tensor leaf keeps its device under ``bf16``)."""
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {mode!r}; one of {QUANT_MODES}")
    if mode == "f32":
        return params

    def one(key, leaf):
        if not _is_float(leaf):
            return leaf
        ndim = leaf.dim() if isinstance(leaf, torch.Tensor) else np.ndim(leaf)
        if mode == "int8" and ndim >= 2 and key in _MATMUL_KEYS:
            return _quantize_leaf_int8(_host_f32(leaf))
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().to(torch.bfloat16)
        return torch.from_numpy(_host_f32(leaf)).to(torch.bfloat16)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else one(k, v) for k, v in tree.items()}

    return walk(params)


def dequantize_tree(params):
    """The inverse inside the forward: int8 records become bf16 weights (the
    product in f32, then one rounding); every other leaf passes through.
    The identity on f32 and bf16 trees."""
    if _is_qleaf(params):
        return (params[_QKEY].to(torch.float32) * params[_SKEY]).to(torch.bfloat16)
    if isinstance(params, dict):
        return {k: dequantize_tree(v) for k, v in params.items()}
    return params


def tree_to(tree, device):
    """Every leaf of a (possibly quantized) tree moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


def tree_nbytes(tree) -> int:
    """Bytes the leaves of a (possibly quantized) tree hold."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def serving_config(config, mode: str):
    """The model config a quantized engine runs: bf16 compute for the
    reduced modes, unchanged for f32."""
    if mode == "f32":
        return config
    return dataclasses.replace(config, compute_dtype=torch.bfloat16)


def quantized_forward(fn, mode: str):
    """Wrap an endpoint forward ``fn(params, imgs, *rest)`` so that it takes
    the quantized tree and dequantizes inside the forward.  Further
    arguments (a session's carried ``levels``) pass through unquantized:
    state is activations, not weights."""
    if mode == "f32":
        return fn

    def f(qparams, imgs, *rest):
        return fn(dequantize_tree(qparams), imgs, *rest)

    return f


# -- the accuracy harness (python -m glom_tpu_torch.tools.quant_check) -------

def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    a = a.astype(np.float64).ravel()
    b = b.astype(np.float64).ravel()
    denom = float(np.linalg.norm(a) * np.linalg.norm(b))
    return float(a @ b / denom) if denom else 1.0


def _errors(ref: np.ndarray, got: np.ndarray) -> Dict[str, float]:
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    scale = float(np.max(np.abs(ref))) or 1.0
    return {
        "cosine": round(_cosine(ref, got), 6),
        "max_abs": round(float(np.max(np.abs(ref - got))), 6),
        "max_abs_rel": round(float(np.max(np.abs(ref - got))) / scale, 6),
    }


def accuracy_report(config, train_cfg, params, imgs, modes=("bf16", "int8"), *,
                    iters: Optional[int] = None, device=None):
    """Each quant mode against the f32 reference on both serving endpoints:
    ``{mode: {"embed": {"overall", "level_<l>"...}, "reconstruct",
    "thresholds", "worst_cosine", "worst_max_abs_rel", "pass"}}``.
    ``params`` is the f32 tree (tensors or numpy), ``imgs`` a ``(b, c, H,
    W)`` float32 array; the forwards run on ``device`` (``cuda`` unless
    named) with the config's kernels."""
    from glom_tpu_torch.config import resolve_device
    from glom_tpu_torch.models import glom as glom_model
    from glom_tpu_torch.serving.engine import make_embed_fn, make_reconstruct_fn
    from glom_tpu_torch.training import denoise

    dev = resolve_device(device)
    embed_iters = iters if iters is not None else config.default_iters
    recon_iters = iters if iters is not None else (
        train_cfg.iters if train_cfg.iters is not None else config.default_iters)
    timestep = denoise.resolve_loss_timestep(train_cfg, recon_iters)
    x = torch.from_numpy(np.ascontiguousarray(imgs, np.float32)).to(dev)

    def run(mode):
        cfg = serving_config(config, mode)
        fns = glom_model.resolve_step_fns(cfg, dev)
        qp = tree_to(quantize_tree(params, mode), dev)
        embed = quantized_forward(make_embed_fn(cfg, embed_iters, fns), mode)
        recon = quantized_forward(make_reconstruct_fn(cfg, train_cfg, timestep, fns), mode)
        with torch.inference_mode():
            return embed(qp, x).cpu().numpy(), recon(qp, x).cpu().numpy()

    ref_embed, ref_recon = run("f32")
    report = {}
    for mode in modes:
        if mode == "f32":
            continue
        got_embed, got_recon = run(mode)
        levels = {f"level_{l}": _errors(ref_embed[:, l], got_embed[:, l])
                  for l in range(ref_embed.shape[1])}
        embed_err = _errors(ref_embed, got_embed)
        recon_err = _errors(ref_recon, got_recon)
        thr = ACCURACY_THRESHOLDS[mode]
        worst_cos = min([embed_err["cosine"], recon_err["cosine"]]
                        + [v["cosine"] for v in levels.values()])
        # each level normalizes by its own abs max, so a degraded upper level
        # cannot hide behind the whole tensor's scale
        worst_rel = max([embed_err["max_abs_rel"], recon_err["max_abs_rel"]]
                        + [v["max_abs_rel"] for v in levels.values()])
        report[mode] = {
            "embed": {"overall": embed_err, **levels},
            "reconstruct": recon_err,
            "thresholds": dict(thr),
            "worst_cosine": round(worst_cos, 6),
            "worst_max_abs_rel": round(worst_rel, 6),
            "pass": bool(worst_cos >= thr["cosine"] and worst_rel <= thr["max_abs_rel"]),
        }
    return report
