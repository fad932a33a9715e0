"""Held-out evaluation of the denoising-SSL representations
(``glom_tpu/training/eval.py``).

  * :func:`embed_levels` / :func:`embed` — pooled level embeddings of the
    final state;
  * :func:`linear_probe` — the closed-form ridge classifier on frozen
    embeddings and its accuracies;
  * :func:`make_psnr_fn` / :func:`reconstruction_psnr` — the decoder's
    denoising PSNR;
  * :class:`EvalSuite` — all of it on a fixed held-out set, which the
    trainer runs every ``eval_every`` steps;
  * :func:`holdout_split` — the held-out files, the same ones
    ``glom_tpu`` holds out.

Forwards run under ``torch.no_grad()`` on the device of the parameters.  The
noise comes from a ``torch.Generator`` the caller passes (the trainer's
eval draws from one of its own, never from the train step's), or from
``noise=`` (tests hand in ``glom_tpu``'s).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.models.heads import decoder_apply, decoder_patches
from glom_tpu_torch.ops.patch import patchify
from glom_tpu_torch.training.denoise import WholeBatch


def _device(params: dict) -> torch.device:
    return params["pos_emb"].device


def embed_levels(params: dict, imgs: torch.Tensor, *, config: GlomConfig,
                 iters: Optional[int] = None, consensus_fn=None, ff_fn=None) -> torch.Tensor:
    """``(b, c, H, W) -> (b, L, d)``: the final state of every level,
    mean-pooled over the columns; one forward serves the single-level and
    the all-levels probes."""
    with torch.no_grad():
        out = glom_model.apply(params, imgs, config=config, iters=iters,
                               consensus_fn=consensus_fn, ff_fn=ff_fn)
    return torch.mean(out, dim=1)


def embed(params: dict, imgs: torch.Tensor, *, config: GlomConfig, iters: Optional[int] = None,
          level: int = -1, consensus_fn=None, ff_fn=None) -> torch.Tensor:
    """``(b, c, H, W) -> (b, d)``: :func:`embed_levels` at ``level``."""
    return embed_levels(params, imgs, config=config, iters=iters, consensus_fn=consensus_fn,
                        ff_fn=ff_fn)[:, level]


def ridge_weights(feats: torch.Tensor, targets: torch.Tensor, l2: float) -> torch.Tensor:
    """The ridge solution ``(XᵀX + l2·I)⁻¹ XᵀY`` in the inputs' dtype.  With
    fewer rows than features the Gram is rank-deficient and ``l2·I`` alone
    makes the system solvable."""
    eye = torch.eye(feats.shape[1], dtype=feats.dtype, device=feats.device)
    return torch.linalg.solve(feats.T @ feats + l2 * eye, feats.T @ targets)


def standardize(train_x, test_x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both feature sets in float32, scaled by the train set's mean and
    (population) standard deviation plus 1e-6, as the probe takes them."""
    x = torch.as_tensor(train_x).float()
    mean, std = x.mean(0), torch.std(x, dim=0, correction=0) + 1e-6
    return (x - mean) / std, (torch.as_tensor(test_x, device=x.device).float() - mean) / std


def linear_probe(train_x, train_y, test_x, test_y, *, num_classes: int, l2: float = 1e-3,
                 l2_grid=None) -> Tuple[float, float]:
    """Closed-form ridge regression to one-hot targets on frozen embeddings;
    returns ``(train_accuracy, test_accuracy)``.  Tensors or arrays; the
    solve runs in float32 on the features' device.

    ``l2_grid``: candidate strengths, one chosen on the last 20 % of the
    TRAIN half (the first that scores best there) and refit on the whole
    train half; below 5 validation rows the fixed ``l2`` stands.  The test
    half never influences the choice."""
    x, xt = standardize(train_x, test_x)
    train_y = torch.as_tensor(train_y, device=x.device).long()
    test_y = torch.as_tensor(test_y, device=x.device).long()
    onehot = F.one_hot(train_y, num_classes).float()

    def acc_w(w, feats, labels):
        pred = torch.argmax(feats @ w, dim=-1)
        return float(torch.mean((pred == labels).float()))

    n_fit = max(1, int(len(x) * 0.8))
    if l2_grid is not None and len(l2_grid) > 0 and len(x) - n_fit >= 5:
        best = None
        for cand in l2_grid:
            w_val = ridge_weights(x[:n_fit], onehot[:n_fit], cand)
            val_acc = acc_w(w_val, x[n_fit:], train_y[n_fit:])
            if best is None or val_acc > best[0]:
                best = (val_acc, cand)
        l2 = best[1]

    w = ridge_weights(x, onehot, l2)
    return acc_w(w, x, train_y), acc_w(w, xt, test_y)


def make_psnr_fn(config: GlomConfig, *, noise_std: float = 1.0, iters: Optional[int] = None,
                 timestep: Optional[int] = None, level: int = -1, data_range: float = 2.0,
                 consensus_fn=None, ff_fn=None, fused_fn=None, decoder: str = "linear",
                 shard=None):
    """The eval twin of the denoising objective: ``psnr(params, imgs, *,
    generator=None, noise=None) -> psnr_db`` (a float32 scalar tensor).
    ``noise`` (standard normal, ``imgs``' shape) replaces the draw from
    ``generator``.  The forward stops at ``timestep`` (default
    ``iters // 2 + 1``), as the train step's does.  ``shard`` (as
    :func:`~glom_tpu_torch.training.denoise.make_step_fn` takes it) decodes
    this process's rows and columns of the whole batch's noised images, and
    averages the MSE over the processes before the PSNR."""
    if iters is None:
        iters = config.default_iters
    if timestep is None:
        timestep = iters // 2 + 1
    shard = shard if shard is not None else WholeBatch()
    columns = shard.columns

    def psnr_fn(params: dict, imgs: torch.Tensor, *, generator=None, noise=None):
        if noise is None:
            noise = torch.randn(imgs.shape, generator=generator, device=imgs.device,
                                dtype=imgs.dtype)
        mine = shard.rows(imgs.shape[0])
        img = imgs[mine]
        with torch.no_grad():
            state = glom_model.apply(params["glom"], img + noise[mine].to(img.dtype) * noise_std,
                                     config=config, iters=timestep, consensus_fn=consensus_fn,
                                     ff_fn=ff_fn, fused_fn=fused_fn, columns=columns)
            if columns is None:
                recon = decoder_apply(params["decoder"], state, config, arch=decoder, level=level)
                target = img
            else:
                recon = decoder_patches(params["decoder"], state, config, arch=decoder,
                                        level=level)
                target = patchify(img, config.patch_size)[:, columns]
            (mse,) = shard.mean([torch.mean((recon.float() - target.float()) ** 2)])
            return 20.0 * np.log10(data_range) - 10.0 * torch.log10(mse)

    return psnr_fn


class EvalSuite:
    """Held-out evaluation for the trainer: a FIXED set of images the train
    step never sees, and at each eval point

      * the denoising PSNR on them, with fresh noise a call, and
      * with labels, the linear probe on frozen pooled embeddings: fit on
        the probe-train part, accuracy on the probe-test part, for the
        configured level and for all levels concatenated.

    Images run in chunks of ``chunk``; a tail short of a chunk is left out,
    as ``glom_tpu`` leaves it."""

    def __init__(self, config: GlomConfig, psnr_images, *, probe_images=None,
                 probe_labels=None, num_classes: Optional[int] = None,
                 probe_train_fraction: float = 0.5, probe_l2_grid=None, noise_std: float = 1.0,
                 iters: Optional[int] = None, timestep: Optional[int] = None, level: int = -1,
                 chunk: int = 32, decoder: str = "linear"):
        self.config = config
        self.iters = iters
        self.psnr_images = np.asarray(psnr_images, np.float32)
        self.chunk = min(chunk, len(self.psnr_images))
        self._psnr = make_psnr_fn(config, noise_std=noise_std, iters=iters, timestep=timestep,
                                  level=level, decoder=decoder)
        self._level = level

        self.probe_images = None
        if probe_images is not None:
            if probe_labels is None:
                raise ValueError("probe_images needs probe_labels")
            imgs = np.asarray(probe_images, np.float32)
            labels = np.asarray(probe_labels)
            if num_classes is None:
                num_classes = int(labels.max()) + 1
            # ImageFolder eval sets arrive grouped by class (sorted paths):
            # shuffle deterministically so both halves mix classes
            perm = np.random.default_rng(0xB0BE).permutation(len(imgs))
            self.probe_images, self.probe_labels = imgs[perm], labels[perm]
            self._probe_split = max(1, int(len(imgs) * probe_train_fraction))
            self._probe_l2_grid = probe_l2_grid
            self.num_classes = num_classes

    def _chunked_embed(self, params: dict, imgs: np.ndarray):
        """``((n, L, d) embeddings on the params' device, n)``, n the rows
        that fill whole chunks."""
        chunk = min(self.chunk, len(imgs))   # the probe set may be under a chunk
        n = (len(imgs) // chunk) * chunk
        dev = _device(params)
        outs = [embed_levels(params, torch.from_numpy(imgs[i:i + chunk]).to(dev),
                             config=self.config, iters=self.iters)
                for i in range(0, n, chunk)]
        return torch.cat(outs), n

    def run(self, params: dict, generator: Optional[torch.Generator] = None, *,
            noise=None) -> dict:
        """``{"eval_psnr_db", and with labels "probe_train_acc",
        "probe_test_acc", "probe_all_train_acc", "probe_all_test_acc"}``
        (``probe_all``: all levels concatenated).  The PSNR noise comes
        from ``generator`` (on the params' device), or from ``noise``, the
        held-out images' shape."""
        dev = _device(params["glom"])
        psnrs = []
        n = (len(self.psnr_images) // self.chunk) * self.chunk
        for i in range(0, n, self.chunk):
            sl = slice(i, i + self.chunk)
            nz = None if noise is None else torch.as_tensor(noise[sl]).to(dev)
            psnrs.append(float(self._psnr(params, torch.from_numpy(self.psnr_images[sl]).to(dev),
                                          generator=generator, noise=nz)))
        metrics = {"eval_psnr_db": float(np.mean(psnrs))}

        if self.probe_images is not None:
            # (N, L, d) pooled embeddings of every level from one forward
            feats, n_used = self._chunked_embed(params["glom"], self.probe_images)
            labels = torch.from_numpy(self.probe_labels[:n_used]).to(dev)
            k = min(self._probe_split, n_used - 1)

            def probe(f):
                return linear_probe(f[:k], labels[:k], f[k:], labels[k:],
                                    num_classes=self.num_classes, l2_grid=self._probe_l2_grid)

            # of record: the configured level (the top by default)
            metrics["probe_train_acc"], metrics["probe_test_acc"] = probe(feats[:, self._level])
            # beside it: all levels concatenated, L*d features
            metrics["probe_all_train_acc"], metrics["probe_all_test_acc"] = probe(
                feats.reshape(len(feats), -1))
        return metrics


def holdout_split(files, fraction: float, *, seed: int = 0):
    """Deterministic ``(train_files, eval_files)`` split of a file list; the
    eval files never enter the training stream.  ``glom_tpu``'s
    permutation, so both packages hold out the same files."""
    files = list(files)
    n_eval = max(1, int(len(files) * fraction))
    perm = np.random.default_rng((seed, 0xE7A1)).permutation(len(files))
    eval_idx = set(perm[:n_eval].tolist())
    train = [f for i, f in enumerate(files) if i not in eval_idx]
    evals = [f for i, f in enumerate(files) if i in eval_idx]
    return train, evals


def reconstruction_psnr(params: dict, imgs: torch.Tensor, *, config: GlomConfig,
                        generator: Optional[torch.Generator] = None, noise=None,
                        noise_std: float = 1.0, iters: Optional[int] = None,
                        timestep: Optional[int] = None, level: int = -1,
                        data_range: float = 2.0, consensus_fn=None) -> float:
    """One-shot :func:`make_psnr_fn`: the PSNR in dB as a float."""
    fn = make_psnr_fn(config, noise_std=noise_std, iters=iters, timestep=timestep, level=level,
                      data_range=data_range, consensus_fn=consensus_fn)
    return float(fn(params, imgs, generator=generator, noise=noise))
