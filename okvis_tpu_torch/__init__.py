"""okvis_tpu_torch — the PyTorch/CUDA port of okvis_tpu for one NVIDIA H100.

The package mirrors ``okvis_tpu``'s module tree and function names; the JAX
package stays the reference the port is held against. It imports torch and
numpy only. Its two hand-written CUDA kernels (Harris+NMS, Hamming
XOR+popcount) live in ``csrc/`` and are built with nvcc at first use
(``ops/cuda_lib.py``).
"""

from .device import resolve_device, set_full_precision  # noqa: F401
