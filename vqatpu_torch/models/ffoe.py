"""Free-form open-ended CTI model (``vqatpu/models/ffoe.py:179-330``).

``forward(v, q, a, v_mask)`` takes ``v`` [B, V, v_dim] region features,
``q`` [B, Q] and ``a`` [B, A] token ids and an optional ``v_mask`` [B, V]
bool of real boxes, and returns ``(logits [B, num_classes], att
[B, V, Q, A, G])``.  The blockwise large-V path, ``fused_v_tucker`` and
``remat_glimpse`` are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vqatpu_torch.config import ModelConfig
from vqatpu_torch.ops.attention import TriAttention, box_mask_from_features
from vqatpu_torch.ops.classifier import SimpleClassifier
from vqatpu_torch.ops.embedding import WordEmbedding
from vqatpu_torch.ops.linear import FCNet
from vqatpu_torch.ops.rnn import QuestionEmbedding
from vqatpu_torch.ops.trilinear import TCNet


class CTIModel(nn.Module):
    """Dual GRU streams (question + answer), trilinear attention, and per
    glimpse a joint embedding with residual updates to both streams
    (``FFOE/base_model.py:95-136``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.num_hid
        self.w_emb = WordEmbedding(cfg.ntoken, 300, 0.0, cfg.op)
        self.q_emb = QuestionEmbedding(cfg.word_dim, H, cfg.num_layers)
        self.wa_emb = WordEmbedding(cfg.ntoken, 300, 0.0, cfg.op)
        self.ans_emb = QuestionEmbedding(cfg.word_dim, H, cfg.num_layers)
        self.t_att = TriAttention(cfg.v_dim, H, H, cfg.h_mm, 1, cfg.rank,
                                  cfg.gamma, cfg.k)
        self.classifier = SimpleClassifier(H, H * 2, cfg.num_classes,
                                           cfg.activation, cfg.dropout)
        for g in range(cfg.gamma):
            # k=2 joint-embedding TCNet: d = 2*h_mm = num_hid, no rank nets
            self.add_module(f"t_net{g}", TCNet(
                cfg.v_dim, H, H, cfg.h_mm, cfg.h_out, cfg.rank, 1, k=2,
                joint_only=True))
            self.add_module(f"q_prj{g}", FCNet((H, H), "", 0.2))
            self.add_module(f"a_prj{g}", FCNet((H, H), "", 0.2))

    def forward(self, v: torch.Tensor, q: torch.Tensor, a: torch.Tensor,
                v_mask: Optional[torch.Tensor] = None):
        if v_mask is None:
            v_mask = box_mask_from_features(v)
        q_state = self.q_emb(self.w_emb(q))       # [B, Q, H]
        a_state = self.ans_emb(self.wa_emb(a))    # [B, A, H]
        att = self.t_att(v, q_state, a_state, v_mask)  # [B, V, Q, A, G]
        for g in range(self.cfg.gamma):
            joint = getattr(self, f"t_net{g}").apply_with_weights(
                v, q_state, a_state, att[..., g])
            joint = joint[:, None, :]
            q_state = getattr(self, f"q_prj{g}")(joint) + q_state
            a_state = getattr(self, f"a_prj{g}")(joint) + a_state
        pooled = q_state.sum(1) + a_state.sum(1)
        return self.classifier(pooled), att
