"""Device selection and float32 precision for the port's entry points.

Entry points default to the CUDA card and raise when there is none, unless
the caller asks for the CPU explicitly (``device="cpu"``), as the CPU tests
do: a run that meant to measure the card never falls back to the host.

Resolving a device also turns TF32 off for float32 matmuls and convolutions.
The BRISK blur pyramid is a float32 matmul whose outputs are compared with
each other to form descriptor bits, so it must keep every mantissa bit (the
JAX package runs it at ``Precision.HIGHEST``).
"""

from __future__ import annotations

import torch


def set_full_precision() -> None:
    """Keep float32 matmuls and cuDNN convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; raise if it is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "okvis_tpu_torch: no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    set_full_precision()
    return dev
