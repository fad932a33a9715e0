"""The port's hand-written CUDA kernels for Hopper (``csrc/*.cu``), their
ctypes wrappers, and ``_build.py``, which compiles them with nvcc.

Each wrapper takes CPU tensors to its kernel's plain PyTorch version and
CUDA tensors to the kernel; its ``launches`` attribute counts launches."""
