"""``Glom``: the reference's module API as an ``nn.Module``
(``glom_tpu/models/shim.py``).

Same ctor kwargs as the reference ``Glom`` (``dim``, ``levels``,
``image_size``, ``patch_size``, ``consensus_self``,
``local_consensus_radius``), same ``forward(img, iters=None, levels=None,
return_all=False)`` and output shapes.  The parameters are the JAX
package's tree, registered as nested ``ParameterDict``s; the forward is
:func:`glom_tpu_torch.models.glom.apply`.  ``save`` / ``load`` write and
read a params-only checkpoint (``{"params": ...}`` in the npz layout of
``glom_tpu_torch/checkpoint.py``), which ``glom_tpu``'s ``Glom.load`` reads,
and the other way round.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch.config import GlomConfig, resolve_device
from glom_tpu_torch.convert import (
    from_reference_state_dict, params_from_numpy, params_to_numpy, to_reference_state_dict)
from glom_tpu_torch.models import glom as glom_model


def _register(tree):
    if isinstance(tree, dict):
        return nn.ParameterDict({k: _register(v) for k, v in tree.items()})
    return nn.Parameter(tree)


def _unregister(module):
    if isinstance(module, nn.ParameterDict):
        return {k: _unregister(v) for k, v in module.items()}
    return module


class Glom(nn.Module):
    """Runs on ``cuda`` unless ``device`` names another device; without a
    card it raises unless ``device="cpu"``.  ``params`` (a tree as
    :func:`glom_tpu_torch.models.glom.init` makes) replaces the seeded init;
    extra kwargs (``ff_impl``, ``attention_impl``, dtypes) go to
    :class:`GlomConfig`."""

    def __init__(
        self,
        *,
        dim: int = 512,
        levels: int = 6,
        image_size: int = 224,
        patch_size: int = 14,
        consensus_self: bool = False,
        local_consensus_radius: int = 0,
        generator: Optional[torch.Generator] = None,
        params: Optional[dict] = None,
        device=None,
        **config_kwargs,
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.config = GlomConfig(
            dim=dim,
            levels=levels,
            image_size=image_size,
            patch_size=patch_size,
            consensus_self=consensus_self,
            local_consensus_radius=local_consensus_radius,
            **config_kwargs,
        )
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            params = glom_model.init(generator, self.config)
        self.tree = _register(glom_model.tree_map(lambda p: p.to(self.device), params))

    @classmethod
    def from_reference_state_dict(cls, state_dict, **kwargs) -> "Glom":
        """Build from a reference ``Glom.state_dict()``."""
        model = cls(**kwargs)
        params = from_reference_state_dict(state_dict, model.config, model.device)
        model.tree = _register(params)
        return model

    def params(self) -> dict:
        """The parameter tree, as ``apply`` takes it."""
        return _unregister(self.tree)

    def forward(self, img, iters=None, levels=None, return_all=False):
        img = torch.as_tensor(img, device=self.device)
        if levels is not None:
            levels = torch.as_tensor(levels, device=self.device)
        return glom_model.apply(
            self.params(), img, config=self.config, iters=iters, levels=levels,
            return_all=return_all,
        )

    @property
    def num_params(self) -> int:
        return glom_model.param_count(self.params())

    def save(self, directory: str, step: int = 0) -> str:
        """Write the parameters as a checkpoint (atomic npz, integrity
        record, manifest); returns its path."""
        return ckpt_lib.save(directory, step, {"params": params_to_numpy(self.params())})

    def load(self, directory: str, step: Optional[int] = None) -> int:
        """Restore the parameters from a checkpoint (the manifest's newest
        step by default); returns the step.  A tree of other shapes than
        this model's raises ``ValueError``."""
        if step is None:
            step = ckpt_lib.latest_step(directory)
            if step is None:
                raise FileNotFoundError(f"no checkpoint manifest in {directory}")
        tree = ckpt_lib.load_tree(directory, step, "params")
        want = glom_model.param_shapes(self.config)
        got = glom_model.tree_map(lambda a: tuple(a.shape), tree)
        if got != want:
            raise ValueError(f"checkpoint step {step} in {directory} holds parameters of "
                             f"shapes {got}; this model's are {want}")
        self.tree = _register(params_from_numpy(tree, self.config, self.device))
        return step

    def reference_state_dict(self) -> dict:
        """The parameters in the reference's ``state_dict`` layout."""
        return to_reference_state_dict(self.params(), self.config)
