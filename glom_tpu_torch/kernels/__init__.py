"""The port's hand-written CUDA kernels for Hopper (``csrc/*.cu``), their
ctypes wrappers, and ``_build.py``, which compiles them with nvcc.

Each wrapper takes CPU tensors to its kernel's plain PyTorch version and
CUDA tensors to the kernel; its ``launches`` attribute counts launches."""


def wrappers() -> dict:
    """``{name: wrapper}`` of the seven kernel wrappers, whose ``launches``
    count their kernels' launches in this process."""
    from glom_tpu_torch.kernels import consensus, ff, fused_update

    return {"fused_level_update": fused_update.fused_level_update,
            "grouped_ff": ff.grouped_ff, "grouped_ff_dx": ff.grouped_ff_dx,
            "grouped_ff_dw": ff.grouped_ff_dw,
            "consensus_attention": consensus.consensus_attention,
            "consensus_dkv": consensus.consensus_dkv,
            "consensus_dq": consensus.consensus_dq}
