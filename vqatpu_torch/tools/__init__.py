"""Offline tools (counterpart of ``vqatpu.tools``)."""
