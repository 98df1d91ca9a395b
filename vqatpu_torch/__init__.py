"""PyTorch/CUDA port of ``vqatpu`` for NVIDIA Hopper (H100).

The JAX package ``vqatpu`` stays the reference; this package imports
nothing of it and no JAX.  It serves, trains and evaluates the free-form
CTI model: ``vqatpu_torch.serve.InferenceSession`` and ``python -m
vqatpu_torch.cli.serve``; ``python -m vqatpu_torch.cli.ffoe_train`` and
``ffoe_test`` over VQA-2.0 or TDIUC datasets; the three CTI kernels and
their backwards are hand-written in CUDA (``vqatpu_torch/kernels/csrc``).
"""
