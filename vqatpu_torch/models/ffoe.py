"""Free-form open-ended CTI model (``vqatpu/models/ffoe.py:179-330``).

``forward(v, q, a, v_mask, ctx)`` takes ``v`` [B, V, v_dim] region
features, ``q`` [B, Q] and ``a`` [B, A] token ids, an optional ``v_mask``
[B, V] bool of real boxes and the training context ``ctx`` (None at eval:
no dropout), and returns ``(logits [B, num_classes], att [B, V, Q, A,
G])``.  Dropout sites fire in the order of
``vqatpu/models/ffoe.py:241-325``.  The blockwise large-V path,
``fused_v_tucker`` and ``remat_glimpse`` are not ported yet: a
``v_block_size`` below the box count raises (JAX's blockwise path returns
no attention, ``:357``).

With bf16 parameters and a bf16 ``v`` (``compute_dtype="bfloat16"``) the
dtypes follow JAX's Pallas backend: the GRU states, the rank projections
and ``vt`` are bf16; ``att`` and each glimpse's joint embedding are
float32 (the kernels' outputs); the residuals promote ``q_state`` and
``a_state`` to float32 after the first glimpse (``:321-322``), so ``qt``
and ``at`` are float32 at the second, and the logits are float32.
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
from vqatpu_torch.ops.module import Ctx
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
                v_mask: Optional[torch.Tensor] = None,
                ctx: Optional[Ctx] = None):
        block = self.cfg.v_block_size
        if block > 0 and v.shape[1] > block:
            raise NotImplementedError(
                f"v_block_size={block} with {v.shape[1]} boxes selects JAX's "
                "blockwise path, which returns no attention; it is not "
                "ported (ROADMAP queue A item 8)")
        if v_mask is None:
            v_mask = box_mask_from_features(v)
        q_state = self.q_emb(self.w_emb(q, ctx))       # [B, Q, H]
        a_state = self.ans_emb(self.wa_emb(a, ctx))    # [B, A, H]
        att, _ = self.t_att(v, q_state, a_state, v_mask, ctx)  # [B,V,Q,A,G]
        for g in range(self.cfg.gamma):
            joint = getattr(self, f"t_net{g}").apply_with_weights(
                v, q_state, a_state, att[..., g], ctx)
            joint = joint[:, None, :]
            q_state = getattr(self, f"q_prj{g}")(joint, ctx) + q_state
            a_state = getattr(self, f"a_prj{g}")(joint, ctx) + a_state
        pooled = q_state.sum(1) + a_state.sum(1)
        return self.classifier(pooled, ctx), att
