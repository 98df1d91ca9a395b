"""The math policy of the port's serving and training paths.

- float32 GEMMs and the GRU stay float32: TF32 is off for cuBLAS and cuDNN,
  whose default is on, so the card computes what the JAX package computes
  in float32.
- bf16 GEMMs (``compute_dtype="bfloat16"``) accumulate in float32, as XLA's
  do: cuBLAS's reduced-precision reduction for bf16, on by default, may
  reduce split-K partial sums in bf16, and is turned off.
- Where the JAX path mixes float32 and bf16 operands, jnp promotes them
  (``jnp.result_type``: float32); ``F.linear``, ``torch.bmm`` and
  ``torch.einsum`` raise on mixed dtypes instead, so those sites promote
  with :func:`promote`.
"""

from __future__ import annotations

import torch


def require_f32_math() -> None:
    """Turn TF32 off for float32 GEMMs (cuBLAS) and cuDNN (the GRU), and
    reduced-precision reductions off for bf16 GEMMs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def check_f32_math(path: str) -> None:
    """Raise if TF32, or bf16 reduced-precision reductions, were turned back
    on since :func:`require_f32_math`; ``path`` names the caller."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError(f"TF32 was turned back on; the {path} computes "
                           "in float32")
    if torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        raise RuntimeError(f"bf16 reduced-precision reductions were turned "
                           f"back on; the {path} accumulates bf16 GEMMs in "
                           "float32")


def promote(*tensors: torch.Tensor):
    """``tensors`` cast to their common type, ``jnp.result_type``'s for
    {float32, bfloat16}: float32 if any is float32."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return tuple(t.to(dtype) for t in tensors)
