"""Model assembly (counterpart of ``vqatpu.models``)."""

from vqatpu_torch.models.registry import build_model

__all__ = ["build_model"]
