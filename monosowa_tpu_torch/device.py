"""Device selection: the card unless the caller names another device."""

from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def full_float32_matmuls() -> None:
    """Float32 matrix products and convolutions in full float32: TF32 off
    for cuBLAS and cuDNN, process-wide.  PyTorch leaves cuDNN's TF32 on
    by default; the JAX package asks for ``Precision.HIGHEST``
    (``ops/tfl.py``), and every check of the port against its plain
    versions and the JAX package holds float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """``None`` means ``cuda``.  Asking for a CUDA device on a machine
    without one raises; nothing falls back to the CPU.  A CUDA device
    turns TF32 off (``full_float32_matmuls``)."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        full_float32_matmuls()
    return dev
