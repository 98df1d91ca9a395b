"""PyTorch/CUDA port of ``vqatpu`` for NVIDIA Hopper (H100).

The JAX package ``vqatpu`` stays the reference; this package imports
nothing of it and no JAX.  This slice serves the free-form CTI model:
``vqatpu_torch.serve.InferenceSession`` and ``python -m
vqatpu_torch.cli.serve``, with the two CTI kernels hand-written in CUDA
(``vqatpu_torch/kernels/csrc``).
"""
