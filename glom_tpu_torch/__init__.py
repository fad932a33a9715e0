"""glom_tpu_torch — the PyTorch / CUDA port of ``glom_tpu`` for an NVIDIA
H100.

It keeps ``glom_tpu``'s module layout, parameter names and checkpoint
format, imports nothing of ``glom_tpu`` or JAX, and replaces each Pallas
TPU kernel on its path with a kernel written by hand for Hopper
(``glom_tpu_torch/kernels/csrc``).  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.

  * ``Glom`` — the reference module API as an ``nn.Module``
  * ``GlomConfig`` / ``TrainConfig`` — the configs, ``config.json``-compatible
  * ``glom_tpu_torch.models.glom`` — functional ``init`` / ``apply``
  * ``glom_tpu_torch.kernels`` — the CUDA kernels and their wrappers
  * ``glom_tpu_torch.serving`` — engine and HTTP server
"""

from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.models.shim import Glom

__all__ = ["Glom", "GlomConfig", "TrainConfig"]
