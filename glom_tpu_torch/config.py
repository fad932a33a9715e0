"""Configuration of the PyTorch port.

``GlomConfig`` and ``TrainConfig`` carry the same field names and defaults
as ``glom_tpu.config``, so a checkpoint directory's ``config.json`` crosses
between the two packages unchanged.  Dtypes are torch dtypes here and are
written by name (``"float32"``, ``"bfloat16"``), as the JAX package writes
them.

The kernel selectors keep their names: ``ff_impl="pallas"`` and
``attention_impl="pallas"`` select the port's hand-written CUDA kernels,
``ff_impl="fused"`` the fused level update (K8), and
``attention_impl="auto"`` the choice by the measured crossover
(``models/glom.py``).  ``ring`` and ``ulysses`` name a path the port does
not implement yet: they are accepted, so every JAX checkpoint loads, and a
forward asked to run one raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}
_DTYPE_NAMES = {v: k for k, v in DTYPES.items()}

ATTENTION_IMPLS = ("auto", "dense", "pallas", "ring", "ulysses")
FF_IMPLS = ("dense", "pallas", "fused")
DECODER_ARCHS = ("linear", "mlp", "linear_all", "mlp_all")


def dtype_name(dtype: torch.dtype) -> str:
    return _DTYPE_NAMES[dtype]


def to_dtype(value) -> torch.dtype:
    """A torch dtype from a torch dtype or its name."""
    if isinstance(value, torch.dtype):
        return value
    if value not in DTYPES:
        raise ValueError(f"unknown dtype {value!r}; one of {sorted(DTYPES)}")
    return DTYPES[value]


@dataclasses.dataclass(frozen=True)
class GlomConfig:
    """Model config; the fields of ``glom_tpu.config.GlomConfig``."""

    dim: int = 512
    levels: int = 6
    image_size: int = 224
    patch_size: int = 14
    consensus_self: bool = False
    local_consensus_radius: int = 0
    channels: int = 3
    ff_mult: int = 4
    param_dtype: torch.dtype = torch.float32
    compute_dtype: Optional[torch.dtype] = None   # None => param dtype
    # the step's knobs, read by models/glom.py::make_step_builder for
    # serving and training alike (scan_unroll: accepted, no effect here)
    remat: bool = False
    remat_policy: str = "dots"
    attention_impl: str = "dense"
    ff_impl: str = "dense"
    ff_fused_bwd: bool = False
    fuse_ff: bool = False
    scan_unroll: int = 1

    def __post_init__(self):
        object.__setattr__(self, "param_dtype", to_dtype(self.param_dtype))
        if self.compute_dtype is not None:
            object.__setattr__(self, "compute_dtype", to_dtype(self.compute_dtype))
        if self.scan_unroll < 1:
            raise ValueError("scan_unroll must be >= 1")
        if self.image_size % self.patch_size != 0:
            raise ValueError(
                f"image_size {self.image_size} not divisible by patch_size {self.patch_size}"
            )
        if self.levels < 2:
            raise ValueError("levels must be >= 2 (top_down uses levels-1 groups)")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if self.ff_impl not in FF_IMPLS:
            raise ValueError(f"unknown ff_impl {self.ff_impl!r}")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")

    @property
    def num_patches_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_side ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size ** 2 * self.channels

    @property
    def default_iters(self) -> int:
        return 2 * self.levels

    @property
    def state_shape(self) -> Tuple[int, int]:
        return (self.levels, self.dim)

    @property
    def resolved_compute_dtype(self) -> torch.dtype:
        return self.compute_dtype or self.param_dtype

    def to_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["param_dtype"] = dtype_name(self.param_dtype)
        d["compute_dtype"] = (
            None if self.compute_dtype is None else dtype_name(self.compute_dtype)
        )
        return d

    @classmethod
    def from_json_dict(cls, d: dict) -> "GlomConfig":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of ``glom_tpu.config.TrainConfig``.  This slice reads only
    the decode-path fields (``iters``, ``loss_timestep``, ``loss_level``,
    ``decoder``, ``decoder_hidden_mult``); the rest round-trip through
    ``config.json`` for the training slice."""

    batch_size: int = 8
    grad_accum_steps: int = 1
    learning_rate: float = 3e-4
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0
    iters: Optional[int] = None
    loss_timestep: Optional[int] = None
    loss_level: int = -1
    noise_std: float = 1.0
    consistency: str = "none"
    consistency_weight: float = 0.1
    consistency_temperature: float = 0.1
    consistency_level: int = -1
    decoder: str = "linear"
    decoder_hidden_mult: int = 2
    steps: int = 100
    log_every: int = 10
    eval_every: int = 0
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_backend: str = "npz"
    monitor_numerics: bool = True
    grad_spike_factor: float = 10.0
    halt_on_nan: bool = False
    diag_every: int = 0
    metrics_csv: Optional[str] = None
    prom_textfile: Optional[str] = None
    forensics_dir: Optional[str] = None
    forensics_ring: int = 256
    forensics_max_captures: int = 3
    forensics_debounce_steps: int = 200
    forensics_trace_steps: int = 0
    forensics_hlo: bool = True
    forensics_step_time_factor: float = 2.0
    async_checkpoint: bool = False
    profile_dir: Optional[str] = None
    trace_dir: Optional[str] = None
    seed: int = 0
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axes: Tuple[str, ...] = ("data", "model", "seq")
    param_sharding: str = "tp"
    donate: bool = True
    stop_poll_steps: int = 10

    def __post_init__(self):
        if self.decoder not in DECODER_ARCHS:
            raise ValueError(
                f"unknown decoder arch {self.decoder!r}; one of {DECODER_ARCHS}"
            )
        if self.decoder_hidden_mult < 1:
            raise ValueError(
                f"decoder_hidden_mult must be >= 1, got {self.decoder_hidden_mult}"
            )
        if self.grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {self.grad_accum_steps}")
        if self.batch_size % self.grad_accum_steps != 0:
            raise ValueError(
                f"batch_size {self.batch_size} not divisible by "
                f"grad_accum_steps {self.grad_accum_steps}"
            )
        if self.checkpoint_backend not in ("npz", "orbax", "sharded"):
            raise ValueError(f"unknown checkpoint backend {self.checkpoint_backend!r}")
        if self.stop_poll_steps < 1:
            raise ValueError(f"stop_poll_steps must be >= 1, got {self.stop_poll_steps}")

    def to_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d.get("mesh_shape") is not None:
            d["mesh_shape"] = list(d["mesh_shape"])
        d["mesh_axes"] = list(d["mesh_axes"])
        return d

    @classmethod
    def from_json_dict(cls, d: dict) -> "TrainConfig":
        """Fields this build does not know are dropped, as
        ``glom_tpu.training.denoise.load_checkpoint_state`` drops them."""
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        if d.get("mesh_shape") is not None:
            d["mesh_shape"] = tuple(d["mesh_shape"])
        d["mesh_axes"] = tuple(d.get("mesh_axes", ("data", "model", "seq")))
        return cls(**d)


# Bench and tooling presets, glom_tpu's (``glom_tpu/config.py``), shared by
# ``tools/bench.py``, ``tools/mfu.py`` and ``tools/breakdown.py`` so that their
# model shapes cannot drift apart.  ``tpu_batch`` keeps glom_tpu's name: it is
# the batch on an accelerator, the card here.
#   flagship: the reference default (glom_pytorch.py:80-86), the benchmark's
#             config of record
#   large:    dim=1024, levels=8, 384/16, n=576 (every kernel takes it, in
#             both directions)
#   tiny:     a CPU-runnable smoke config, never a number of record
BENCH_PRESETS = {
    "flagship": dict(model_kwargs={}, iters=12, tpu_batch=32, cpu_batch=4),
    "large": dict(
        model_kwargs=dict(dim=1024, levels=8, image_size=384, patch_size=16),
        iters=16, tpu_batch=4, cpu_batch=1,
    ),
    "tiny": dict(
        model_kwargs=dict(dim=64, levels=3, image_size=64, patch_size=8),
        iters=4, tpu_batch=8, cpu_batch=8,
    ),
}


def bench_preset(name: str):
    """``(model_kwargs, iters, batch on a card, batch on the CPU)``."""
    p = BENCH_PRESETS[name]
    return dict(p["model_kwargs"]), p["iters"], p["tpu_batch"], p["cpu_batch"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Without a card, asking for ``cuda`` (explicitly or by default)
    raises; nothing moves to the CPU unless the caller says ``cpu``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
