"""The float32 math policy of the port's serving and training paths: TF32
stays off for cuBLAS (float32 GEMMs) and cuDNN (the GRU), whose default is
on, so the card computes what the JAX package computes in float32."""

from __future__ import annotations

import torch


def require_f32_math() -> None:
    """Turn TF32 off for float32 GEMMs (cuBLAS) and cuDNN (the GRU)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_f32_math(path: str) -> None:
    """Raise if TF32 was turned back on since :func:`require_f32_math`;
    ``path`` names the caller in the message."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError(f"TF32 was turned back on; the {path} computes "
                           "in float32")
