"""Data helpers (counterpart of ``vqatpu.data``)."""

from vqatpu_torch.data.dictionary import Dictionary

__all__ = ["Dictionary"]
