"""Free-form open-ended models: BAN, SAN and CTI (``vqatpu/models/ffoe.py``).

Every model has one call convention, ``forward(v, q, a=None, v_mask=None,
ctx=None, b=None)``: ``v`` [B, V, v_dim] region features, ``q`` [B, Q]
question tokens, ``a`` [B, A] answer tokens, an optional ``v_mask`` [B, V]
bool of real boxes, the training context ``ctx`` (None at eval: no
dropout) and ``b`` [B, V, 6] spatials.  Each model reads the keys it needs
(:attr:`inputs`; ``v_mask`` defaults to the boxes whose features are not
all zero) and ignores the rest, as JAX's ``apply(params, batch, ctx)``
does; it returns ``(logits [B, num_classes], att)``.

- :class:`BanModel` (``:38-131``): bilinear attention, per glimpse a
  bilinear pooling with a residual update of the question states and, with
  ``use_counter``, the counting branch on the boxes ``b[..., :4]``;
  ``att`` [B, G, V, Q].
- :class:`StackedAttentionModel` (``:134-176``): SAN on the GRU's last
  state; ``att`` is None.
- :class:`CTIModel` (``:179-330``): ``att`` [B, V, Q, A, G], its body
  :class:`TrilinearModel`, which the multiple-choice ``TanModel`` shares.

Dropout sites fire in JAX's order.

CTI's blockwise large-V path, ``fused_v_tucker`` and ``remat_glimpse`` are
not ported yet: a ``v_block_size`` below the box count raises (JAX's
blockwise path returns no attention, ``:357``).  With bf16 parameters and a
bf16 ``v`` (``compute_dtype="bfloat16"``) CTI's dtypes follow JAX's Pallas
backend: the GRU states, the rank projections
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
from vqatpu_torch.numerics import promote
from vqatpu_torch.ops.attention import (BiAttention, StackedAttention,
                                        TriAttention, box_mask_from_features)
from vqatpu_torch.ops.bilinear import BCNet
from vqatpu_torch.ops.classifier import SimpleClassifier
from vqatpu_torch.ops.counter import Counter
from vqatpu_torch.ops.embedding import WordEmbedding
from vqatpu_torch.ops.linear import FCNet
from vqatpu_torch.ops.module import Ctx
from vqatpu_torch.ops.rnn import QuestionEmbedding
from vqatpu_torch.ops.trilinear import TCNet


class BanModel(nn.Module):
    """Bilinear attention network with glimpse-residual question updates and
    the optional counting branch (``FFOE/base_model.py:21-67``).

    At bf16 compute the counter's output is float32 (its one-hot is), so
    with ``use_counter`` the question states are float32 from the first
    glimpse's counter residual on, as in JAX."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.num_hid
        self.w_emb = WordEmbedding(cfg.ntoken, 300, 0.0, cfg.op)
        self.q_emb = QuestionEmbedding(cfg.word_dim, H, cfg.num_layers)
        self.v_att = BiAttention(cfg.v_dim, H, H, cfg.gamma)
        self.classifier = SimpleClassifier(H, H * 2, cfg.num_classes,
                                           cfg.activation, cfg.dropout)
        for g in range(cfg.gamma):
            self.add_module(f"b_net{g}", BCNet(cfg.v_dim, H, H, None, k=1))
            self.add_module(f"q_prj{g}", FCNet((H, H), "", 0.2))
            if cfg.use_counter:
                self.add_module(f"c_prj{g}",
                                FCNet((cfg.objects + 1, H), "ReLU", 0.0))
        self.counter = Counter(cfg.objects) if cfg.use_counter else None

    @property
    def inputs(self):
        return ("v", "q", "b") if self.cfg.use_counter else ("v", "q")

    def forward(self, v: torch.Tensor, q: torch.Tensor,
                a: Optional[torch.Tensor] = None,
                v_mask: Optional[torch.Tensor] = None,
                ctx: Optional[Ctx] = None, b: Optional[torch.Tensor] = None):
        if v_mask is None:
            v_mask = box_mask_from_features(v)
        q_state = self.q_emb(self.w_emb(q, ctx))  # [B, Q, H]
        att_qv, logits_qv = self.v_att.apply_gqv(v, q_state, v_mask, ctx)
        if self.counter is not None:
            if b is None:
                raise ValueError("BAN with the counter needs the spatials b")
            boxes = b[:, :, :4].transpose(1, 2)  # [B, 4, V]
        q_states = []
        for g in range(self.cfg.gamma):
            b_emb = getattr(self, f"b_net{g}").apply_with_weights_qv(
                v, q_state, att_qv[:, g], ctx)
            q_state = (getattr(self, f"q_prj{g}")(b_emb[:, None, :], ctx)
                       + q_state)
            if self.counter is not None:
                # a padded box's logits are -inf over Q: sigmoid 0
                embed = self.counter(boxes, logits_qv[:, g].amax(1))
                q_state = q_state + getattr(self, f"c_prj{g}")(
                    embed, ctx)[:, None, :]
            q_states.append(q_state)
        pooled = torch.stack(promote(*q_states), 1).sum(1)  # [B, Q, H]
        return (self.classifier(pooled.sum(1), ctx),
                att_qv.transpose(2, 3))


class StackedAttentionModel(nn.Module):
    """SAN (``FFOE/base_model.py:70-92``): stacked attention on the GRU's
    last hidden state."""

    inputs = ("v", "q")

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.num_hid
        self.w_emb = WordEmbedding(cfg.ntoken, 300, 0.0, cfg.op)
        self.q_emb = QuestionEmbedding(cfg.word_dim, H, cfg.num_layers)
        self.v_att = StackedAttention(cfg.num_stacks, cfg.v_dim, H, H,
                                      cfg.dropout)
        self.classifier = SimpleClassifier(H, H * 2, cfg.num_classes,
                                           cfg.activation, cfg.dropout)

    def forward(self, v: torch.Tensor, q: torch.Tensor,
                a: Optional[torch.Tensor] = None,
                v_mask: Optional[torch.Tensor] = None,
                ctx: Optional[Ctx] = None, b: Optional[torch.Tensor] = None):
        q_last = self.q_emb.forward_last(self.w_emb(q, ctx))  # [B, H]
        return self.classifier(self.v_att(v, q_last, ctx=ctx), ctx), None


class TrilinearModel(nn.Module):
    """The CTI body that the free-form :class:`CTIModel` and the
    multiple-choice :class:`~vqatpu_torch.models.mc.TanModel` share
    (``FFOE/base_model.py:95-136``, ``MC/base_model.py:112-152``): dual GRU
    streams (question + answer), trilinear attention, and per glimpse a
    joint embedding with residual updates to both streams.  The attention
    lives under :attr:`att_name` (``t_att`` in CTI, ``v_att`` in TanModel,
    JAX's tree paths); the classifier has ``cfg.num_classes`` outputs."""

    att_name = "t_att"
    inputs = ("v", "q", "a")

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.num_hid
        self.w_emb = WordEmbedding(cfg.ntoken, 300, 0.0, cfg.op)
        self.q_emb = QuestionEmbedding(cfg.word_dim, H, cfg.num_layers)
        self.wa_emb = WordEmbedding(cfg.ntoken, 300, 0.0, cfg.op)
        self.ans_emb = QuestionEmbedding(cfg.word_dim, H, cfg.num_layers)
        self.add_module(self.att_name, TriAttention(
            cfg.v_dim, H, H, cfg.h_mm, 1, cfg.rank, cfg.gamma, cfg.k))
        self.classifier = SimpleClassifier(H, H * 2, cfg.num_classes,
                                           cfg.activation, cfg.dropout)
        for g in range(cfg.gamma):
            # k=2 joint-embedding TCNet: d = 2*h_mm = num_hid, no rank nets
            self.add_module(f"t_net{g}", TCNet(
                cfg.v_dim, H, H, cfg.h_mm, cfg.h_out, cfg.rank, 1, k=2,
                joint_only=True))
            self.add_module(f"q_prj{g}", FCNet((H, H), "", 0.2))
            self.add_module(f"a_prj{g}", FCNet((H, H), "", 0.2))

    def forward(self, v: torch.Tensor, q: torch.Tensor,
                a: Optional[torch.Tensor] = None,
                v_mask: Optional[torch.Tensor] = None,
                ctx: Optional[Ctx] = None, b: Optional[torch.Tensor] = None):
        if a is None:
            raise ValueError(f"{type(self).__name__} needs answer tokens")
        if v_mask is None:
            v_mask = box_mask_from_features(v)
        q_state = self.q_emb(self.w_emb(q, ctx))       # [B, Q, H]
        a_state = self.ans_emb(self.wa_emb(a, ctx))    # [B, A, H]
        att, _ = getattr(self, self.att_name)(
            v, q_state, a_state, v_mask, ctx)          # [B, V, Q, A, G]
        for g in range(self.cfg.gamma):
            joint = getattr(self, f"t_net{g}").apply_with_weights(
                v, q_state, a_state, att[..., g], ctx)
            joint = joint[:, None, :]
            q_state = getattr(self, f"q_prj{g}")(joint, ctx) + q_state
            a_state = getattr(self, f"a_prj{g}")(joint, ctx) + a_state
        pooled = q_state.sum(1) + a_state.sum(1)
        return self.classifier(pooled, ctx), att


class CTIModel(TrilinearModel):
    """The free-form CTI model (``vqatpu/models/ffoe.py:179-330``); a
    ``v_block_size`` below the box count selects JAX's blockwise path,
    which is not ported, and raises."""

    def forward(self, v: torch.Tensor, q: torch.Tensor,
                a: Optional[torch.Tensor] = None,
                v_mask: Optional[torch.Tensor] = None,
                ctx: Optional[Ctx] = None, b: Optional[torch.Tensor] = None):
        block = self.cfg.v_block_size
        if block > 0 and v.shape[1] > block:
            raise NotImplementedError(
                f"v_block_size={block} with {v.shape[1]} boxes selects JAX's "
                "blockwise path, which returns no attention; it is not "
                "ported (ROADMAP queue A item 8)")
        return super().forward(v, q, a, v_mask, ctx, b)
