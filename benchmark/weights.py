"""Weights from a seed, made on the device in a few large calls: one
uniform draw for every uniform leaf, one normal draw for the others, then
each weight-norm scale set to its direction's norm (so that the weight is
the direction), as the published initialisation does."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def make(leaves: List[Tuple[str, tuple, tuple]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """``leaves`` as ``reference.<arch>.leaves`` gives them -> ``{name:
    float32 tensor}``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for kind, draw in (("uniform", torch.rand), ("normal", torch.randn)):
        group = [(n, s, i) for n, s, i in leaves if i[0] == kind]
        sizes = [math.prod(s) for _, s, _ in group]
        flat = draw(sum(sizes), generator=gen, device=device)
        for (name, shape, init), x in zip(group, flat.split(sizes)):
            x = x.view(shape)
            if kind == "uniform":
                x = x.mul_(2.0 * init[1]).sub_(init[1])
            elif init[1] is not None:
                x[init[1]] = 0.0  # the pad token's row
            out[name] = x
    for name, shape, init in leaves:
        if init[0] == "norm":
            v = out[init[1]]
            out[name] = (v.reshape(v.shape[0], -1).square().sum(1).sqrt()
                         if init[2] else v.square().sum().sqrt())
    return {name: out[name] for name, _, _ in leaves}
