"""PyTorch/CUDA port of ``vqatpu`` for NVIDIA Hopper (H100).

The JAX package ``vqatpu`` stays the reference; this package imports
nothing of it and no JAX.  It serves and trains the free-form CTI model:
``vqatpu_torch.serve.InferenceSession``, ``python -m
vqatpu_torch.cli.serve`` and the train and eval steps of
``vqatpu_torch.train``, with the three CTI kernels and their backwards
hand-written in CUDA (``vqatpu_torch/kernels/csrc``).
"""
