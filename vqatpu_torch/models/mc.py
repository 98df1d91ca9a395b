"""Multiple-choice (Visual7W) models (``vqatpu/models/mc.py``, reference
``MC/base_model.py``).  Each takes a row per (question, candidate): ``q``
the question tokens, ``a`` [B, 6] the candidate's tokens, and returns
``(logits [B, 2], att)``, the 2-way match / non-match logits.  The call
convention is the free-form models' (:mod:`vqatpu_torch.models.ffoe`).

- :class:`TanModel` (``:133-221``): CTI with a 2-way head, the attention
  under ``v_att``; its path is JAX's ``kernel_backend="pallas"`` one, K1
  for the attention and K2 for each glimpse's pool.  As in JAX it reads
  neither ``fused_v_tucker`` nor ``v_block_size``.
- :class:`BanModelMC` (``:33-130``): a second bilinear attention ``va_att``
  over (v, answer states), with ``tva_net{g}`` / ``a_prj{g}`` residuals on
  the answer stream and, with ``use_counter``, the counting branch on the
  question stream; it pools the last states alone, ``q_state.sum(1) +
  a_state.sum(1)``.  ``att`` [B, G, V, Q].
- :class:`StackedAttentionModelMC` (``:224-272``): two SAN streams on the
  GRUs' last states, summed; ``att`` is None.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vqatpu_torch.config import ModelConfig
from vqatpu_torch.models.ffoe import TrilinearModel
from vqatpu_torch.ops.attention import (BiAttention, StackedAttention,
                                        box_mask_from_features)
from vqatpu_torch.ops.bilinear import BCNet
from vqatpu_torch.ops.classifier import SimpleClassifier
from vqatpu_torch.ops.counter import Counter
from vqatpu_torch.ops.embedding import WordEmbedding
from vqatpu_torch.ops.linear import FCNet
from vqatpu_torch.ops.module import Ctx
from vqatpu_torch.ops.rnn import QuestionEmbedding


class TanModel(TrilinearModel):
    """CTI for multiple choice (``MC/base_model.py:112-152``)."""

    att_name = "v_att"


class BanModelMC(nn.Module):
    """BAN with a second bilinear attention over (v, answer)
    (``MC/base_model.py:19-77``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.num_hid
        self.w_emb = WordEmbedding(cfg.ntoken, 300, 0.0, cfg.op)
        self.q_emb = QuestionEmbedding(cfg.word_dim, H, cfg.num_layers)
        self.wa_emb = WordEmbedding(cfg.ntoken, 300, 0.0, cfg.op)
        self.ans_emb = QuestionEmbedding(cfg.word_dim, H, cfg.num_layers)
        self.v_att = BiAttention(cfg.v_dim, H, H, cfg.gamma)
        self.va_att = BiAttention(cfg.v_dim, H, H, cfg.gamma)
        self.classifier = SimpleClassifier(H, H * 2, cfg.num_classes,
                                           cfg.activation, cfg.dropout)
        for g in range(cfg.gamma):
            self.add_module(f"b_net{g}", BCNet(cfg.v_dim, H, H, None, k=1))
            self.add_module(f"tva_net{g}", BCNet(cfg.v_dim, H, H, None, k=1))
            self.add_module(f"q_prj{g}", FCNet((H, H), "", 0.2))
            self.add_module(f"a_prj{g}", FCNet((H, H), "", 0.2))
            if cfg.use_counter:
                self.add_module(f"c_prj{g}",
                                FCNet((cfg.objects + 1, H), "ReLU", 0.0))
        self.counter = Counter(cfg.objects) if cfg.use_counter else None

    @property
    def inputs(self):
        return ("v", "q", "a", "b") if self.cfg.use_counter else ("v", "q", "a")

    def forward(self, v: torch.Tensor, q: torch.Tensor,
                a: Optional[torch.Tensor] = None,
                v_mask: Optional[torch.Tensor] = None,
                ctx: Optional[Ctx] = None, b: Optional[torch.Tensor] = None):
        if a is None:
            raise ValueError("BanModelMC needs answer tokens")
        if v_mask is None:
            v_mask = box_mask_from_features(v)
        q_state = self.q_emb(self.w_emb(q, ctx))       # [B, Q, H]
        a_state = self.ans_emb(self.wa_emb(a, ctx))    # [B, A, H]
        att_qv, logits_qv = self.v_att.apply_gqv(v, q_state, v_mask, ctx)
        va_att_qv, _ = self.va_att.apply_gqv(v, a_state, v_mask, ctx)
        if self.counter is not None:
            if b is None:
                raise ValueError("BAN with the counter needs the spatials b")
            boxes = b[:, :, :4].transpose(1, 2)  # [B, 4, V]
        for g in range(self.cfg.gamma):
            b_emb = getattr(self, f"b_net{g}").apply_with_weights_qv(
                v, q_state, att_qv[:, g], ctx)
            va_emb = getattr(self, f"tva_net{g}").apply_with_weights_qv(
                v, a_state, va_att_qv[:, g], ctx)
            q_state = (getattr(self, f"q_prj{g}")(b_emb[:, None, :], ctx)
                       + q_state)
            a_state = (getattr(self, f"a_prj{g}")(va_emb[:, None, :], ctx)
                       + a_state)
            if self.counter is not None:
                # a padded box's logits are -inf over Q: sigmoid 0
                embed = self.counter(boxes, logits_qv[:, g].amax(1))
                q_state = q_state + getattr(self, f"c_prj{g}")(
                    embed, ctx)[:, None, :]
        pooled = q_state.sum(1) + a_state.sum(1)
        return self.classifier(pooled, ctx), att_qv.transpose(2, 3)


class StackedAttentionModelMC(nn.Module):
    """SAN for multiple choice: question and answer attention streams summed
    (``MC/base_model.py:80-109``)."""

    inputs = ("v", "q", "a")

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.num_hid
        self.w_emb = WordEmbedding(cfg.ntoken, 300, 0.0, cfg.op)
        self.q_emb = QuestionEmbedding(cfg.word_dim, H, cfg.num_layers)
        self.wa_emb = WordEmbedding(cfg.ntoken, 300, 0.0, cfg.op)
        self.a_emb = QuestionEmbedding(cfg.word_dim, H, cfg.num_layers)
        self.v_att = StackedAttention(cfg.num_stacks, cfg.v_dim, H, H,
                                      cfg.dropout)
        self.va_att = StackedAttention(cfg.num_stacks, cfg.v_dim, H, H,
                                       cfg.dropout)
        self.classifier = SimpleClassifier(H, H * 2, cfg.num_classes,
                                           cfg.activation, cfg.dropout)

    def forward(self, v: torch.Tensor, q: torch.Tensor,
                a: Optional[torch.Tensor] = None,
                v_mask: Optional[torch.Tensor] = None,
                ctx: Optional[Ctx] = None, b: Optional[torch.Tensor] = None):
        if a is None:
            raise ValueError("StackedAttentionModelMC needs answer tokens")
        q_last = self.q_emb.forward_last(self.w_emb(q, ctx))   # [B, H]
        a_last = self.a_emb.forward_last(self.wa_emb(a, ctx))  # [B, H]
        vq = self.v_att(v, q_last, ctx=ctx)
        va = self.va_att(v, a_last, ctx=ctx)
        return self.classifier(vq + va, ctx), None
