"""Blockwise (flash-style) trilinear attention and pooling over the V axis
(``vqatpu/kernels/blockwise.py:47-132``), CTI's large-V path.

The same math as K1 then K2 (``vqatpu_torch.kernels.trilinear``) without
the [B, V, Q, A, G] attention tensor:

- :func:`softmax_stats`: one pass over V blocks keeping, per (sample,
  glimpse), the running max ``m`` and the rescaled denominator ``den`` of
  the masked softmax over (V, Q, A), the online softmax;
- :func:`attention_pool_blockwise`: per glimpse, a second pass that forms
  ``exp(logits - m)`` block by block and adds the weighted trilinear pool
  of the block to a [B, D] accumulator, divided by ``den`` at the end.

V is padded with zero rows to a multiple of the block (masked out).  A
masked logit is ``NEG_BIG`` before the exponential and its exponential is
multiplied by the mask, so a fully masked sample (a padding row of a
serving bucket) gives ``den`` at its floor of 1e-30 and a zero pool, finite.
Each block's body runs under ``torch.utils.checkpoint`` while grad is on,
as JAX's ``jax.checkpoint``, so the backward keeps O(block) in V too.

JAX computes this with ``lax.scan`` and einsums, not Pallas, and so does
the port, with a Python loop over the blocks and ``torch.einsum``: no
kernel of the port runs here.  Mixed float32/bf16 operands are promoted
(:func:`~vqatpu_torch.numerics.promote`), as jnp promotes them.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from vqatpu_torch.kernels.trilinear import precontract_qa  # noqa: F401
from vqatpu_torch.numerics import promote

NEG_BIG = -1e30


def _pad_v_blocks(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    """Pad axis 1 (V) to a multiple of ``block`` -> [n_blocks, B, block,
    ...], n_blocks."""
    B, V = x.shape[:2]
    n_blocks = -(-V // block)
    pad = n_blocks * block - V
    if pad:
        x = torch.cat([x, x.new_zeros((B, pad) + tuple(x.shape[2:]))], 1)
    x = x.reshape(B, n_blocks, block, *x.shape[2:])
    return x.movedim(1, 0), n_blocks


def _block_logits(v_blk: torch.Tensor, tqa: torch.Tensor) -> torch.Tensor:
    """v_blk [B, Vb, R, X] -> logits [B, Vb, Q, A, G]."""
    return torch.einsum("birx,bjlrxg->bijlg", *promote(v_blk, tqa))


def _run(body, *args):
    """``body(*args)``, checkpointed while grad is on."""
    if torch.is_grad_enabled():
        return checkpoint(body, *args, use_reentrant=False)
    return body(*args)


def _stats_body(m, den, v_blk, mask_blk, tqa):
    logits = _block_logits(v_blk, tqa)
    mask5 = mask_blk[:, :, None, None, None]
    neg = torch.where(mask5 > 0, logits, torch.full_like(logits, NEG_BIG))
    bm = neg.amax(dim=(1, 2, 3))  # [B, G]
    m_new = torch.maximum(m, bm)
    scale = torch.exp(m - m_new)
    e = torch.exp(neg - m_new[:, None, None, None, :]) * mask5
    return m_new, den * scale + e.sum(dim=(1, 2, 3))


def softmax_stats(v_r: torch.Tensor, tqa: torch.Tensor, v_mask: torch.Tensor,
                  block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax normalizers over the flattened (V, Q, A) axes:
    ``v_r`` [B, V, R, X], ``tqa`` [B, Q, A, R, X, G], ``v_mask`` [B, V] ->
    (m [B, G], den [B, G]) float32 such that ``att = exp(logits - m) * mask
    / den``."""
    B, G = v_r.shape[0], tqa.shape[-1]
    v_blocks, _ = _pad_v_blocks(v_r, block)
    m_blocks, _ = _pad_v_blocks(v_mask.float(), block)
    m = torch.full((B, G), NEG_BIG, dtype=torch.float32, device=v_r.device)
    den = torch.zeros((B, G), dtype=torch.float32, device=v_r.device)
    for v_blk, mask_blk in zip(v_blocks, m_blocks):
        m, den = _run(_stats_body, m, den, v_blk, mask_blk, tqa)
    return m, den.clamp_min(1e-30)


def attention_pool_blockwise(v_r: torch.Tensor, tqa: torch.Tensor,
                             v_mask: torch.Tensor, m: torch.Tensor,
                             den: torch.Tensor, g: int, vt: torch.Tensor,
                             qt: torch.Tensor, at: torch.Tensor,
                             block: int) -> torch.Tensor:
    """Glimpse ``g``'s weighted trilinear pool ``sum_{v,q,a} att[v,q,a]
    vt[v] * qt[q] * at[a]`` without the attention: -> joint [B, D]
    float32."""
    v_blocks, _ = _pad_v_blocks(v_r, block)
    vt_blocks, _ = _pad_v_blocks(vt, block)
    m_blocks, _ = _pad_v_blocks(v_mask.float(), block)
    m_g = m[:, g]

    def body(acc, v_blk, vt_blk, mask_blk, tqa, m_g, qt, at):
        logits = _block_logits(v_blk, tqa)[..., g]  # [B, Vb, Q, A]
        mask4 = mask_blk[:, :, None, None]
        e = torch.exp(torch.where(mask4 > 0, logits,
                                  torch.full_like(logits, NEG_BIG))
                      - m_g[:, None, None, None]) * mask4
        wq = torch.einsum("bvqa,bqd->bvad", *promote(e, qt))
        wqa = torch.einsum("bvad,bad->bvd", *promote(wq, at))
        return acc + torch.einsum("bvd,bvd->bd", *promote(wqa, vt_blk))

    acc = torch.zeros((v_r.shape[0], vt.shape[-1]), dtype=torch.float32,
                      device=v_r.device)
    for v_blk, vt_blk, mask_blk in zip(v_blocks, vt_blocks, m_blocks):
        acc = _run(body, acc, v_blk, vt_blk, mask_blk, tqa, m_g, qt, at)
    return acc / den[:, g, None]
