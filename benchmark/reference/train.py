"""The plain reference of the training step and of the logits sweep.

Training (``FFOE/train.py``, ``MC/train.py``): per microbatch the BCE loss
over its rows and its gradients; every ``update_freq`` microbatches their
mean, scaled by ``min(clip / (||g|| + 1e-6), 1)`` of the norm of all of
them together, and torch's Adamax (``u = max(b2 u, |g| + eps)``, the step
divided by ``1 - b1^t``).  Every weight trains (the published default
loads the tf-idf word tables, which makes the copy trainable too)."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch

from benchmark.reference.trilinear import Dropout, bce_mean

B1, B2, EPS = 0.9, 0.999, 1e-8


def train(arch, w0: Dict[str, torch.Tensor], m: dict, update_freq: int,
          clip: float, lr: float, rows: Iterable[dict],
          generator: Optional[torch.Generator], updates: int,
          alter: Optional[Callable] = None) -> dict:
    """Run ``updates`` updates from the weights ``w0`` over the microbatches
    ``rows`` (dicts of ``v``, ``v_mask``, ``q``, ``a``, ``target`` on the
    device) with dropout from ``generator``.  -> ``losses`` (a float64
    tensor, one a microbatch), ``grad`` (each leaf's norm of the first
    update's gradient as Adamax takes it) and ``change`` (each leaf's norm
    of its change after the last update).  ``alter(logits)``, if given,
    stands in for the logits (a planted fault)."""
    names = list(w0)
    w = {k: t.detach().clone().requires_grad_(True) for k, t in w0.items()}
    mom = {k: torch.zeros_like(t) for k, t in w0.items()}
    inf = {k: torch.zeros_like(t) for k, t in w0.items()}
    losses, acc, count, t = [], None, 0, 0
    grad_norms = None
    for r in rows:
        logits = arch.forward(w, m, r["v"], r["q"], r["a"], r["v_mask"],
                              Dropout(generator))
        if alter is not None:
            logits = alter(logits)
        loss = bce_mean(logits, r["target"])
        grads = torch.autograd.grad(loss, [w[k] for k in names])
        losses.append(loss.detach().double())
        acc = list(grads) if acc is None else [x + g for x, g in zip(acc, grads)]
        count += 1
        if count < update_freq:
            continue
        with torch.no_grad():
            g = [x / count for x in acc] if count > 1 else acc
            norm = torch.sqrt(sum(x.square().sum() for x in g))
            coef = torch.clamp(clip / (norm + 1e-6), max=1.0)
            g = [x * coef for x in g]
            t += 1
            if grad_norms is None:
                grad_norms = torch.stack([x.double().norm() for x in g])
            for k, x in zip(names, g):
                mom[k].mul_(B1).add_(x * (1.0 - B1))
                inf[k] = torch.maximum(inf[k] * B2, x.abs() + EPS)
                w[k] -= lr * mom[k] / (inf[k] * (1.0 - B1 ** t))
        acc, count = None, 0
        if t == updates:
            break
    if t != updates:
        raise ValueError(f"{t} updates from the microbatches, {updates} asked")
    with torch.no_grad():
        change = torch.stack([(w[k] - w0[k]).double().norm() for k in names])
    return {"names": names, "losses": torch.stack(losses).cpu(),
            "grad": grad_norms.cpu(), "change": change.cpu()}


@torch.no_grad()
def logits(arch, w: Dict[str, torch.Tensor], m: dict,
           rows: Iterable[dict]) -> list:
    """The eval forward (no dropout) of each block of rows, on the host."""
    return [arch.forward(w, m, r["v"], r["q"], r["a"], r["v_mask"],
                         Dropout(None)).cpu() for r in rows]
