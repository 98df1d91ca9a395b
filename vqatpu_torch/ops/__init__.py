"""Model building blocks (counterparts of ``vqatpu.ops``)."""
