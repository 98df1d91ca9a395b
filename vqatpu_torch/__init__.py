"""PyTorch/CUDA port of ``vqatpu`` for NVIDIA Hopper (H100).

The JAX package ``vqatpu`` stays the reference; this package imports
nothing of it and no JAX.  It serves, trains and evaluates the free-form
models, CTI, BAN (with the counter and the distillation loss) and SAN:
``vqatpu_torch.serve.InferenceSession`` and ``python -m
vqatpu_torch.cli.serve``; ``python -m vqatpu_torch.cli.ffoe_train`` and
``ffoe_test`` over VQA-2.0 or TDIUC datasets, with the features on the
card (``data.device_store``) or batches assembled by the port's C++ host
runtime (``vqatpu_torch/native``, ``data.native``); ``evaluate_tdiuc`` and
``ensemble`` score and combine the exports.  The three CTI kernels and
their backwards are hand-written in CUDA (``vqatpu_torch/kernels/csrc``);
BAN and SAN run on PyTorch's own kernels, as they run on XLA's in JAX.
"""
