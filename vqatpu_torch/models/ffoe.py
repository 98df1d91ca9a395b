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

CTI's blockwise large-V path returns ``att=None`` (``:357``); every caller
discards the attention.  With bf16 parameters and a
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
from torch.func import functional_call

from vqatpu_torch.config import ModelConfig
from vqatpu_torch.numerics import promote
from vqatpu_torch.ops.attention import (BiAttention, StackedAttention,
                                        TriAttention, box_mask_from_features)
from vqatpu_torch.ops.bilinear import BCNet
from vqatpu_torch.ops.classifier import SimpleClassifier
from vqatpu_torch.ops.counter import Counter
from vqatpu_torch.ops.embedding import WordEmbedding
from vqatpu_torch.ops.linear import FCNet
from vqatpu_torch.kernels.blockwise import (attention_pool_blockwise,
                                            precontract_qa, softmax_stats)
from vqatpu_torch.ops.module import Ctx, checkpoint_with_dropout
from vqatpu_torch.ops.rnn import QuestionEmbedding
from vqatpu_torch.ops.trilinear import TCNet, fused_tucker_projection


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
        q_state = self.q_emb(self.w_emb(q, ctx), ctx)  # [B, Q, H]
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
        q_last = self.q_emb.forward_last(self.w_emb(q, ctx), ctx)  # [B, H]
        return self.classifier(self.v_att(v, q_last, ctx=ctx), ctx), None


class _Glimpse(nn.Module):
    """A glimpse's joint embedding as a module's forward, so that
    ``functional_call`` runs it on the weights the model's forward read."""

    def __init__(self, net: TCNet):
        super().__init__()
        self.net = net

    def forward(self, ctx, v, q, a, w):
        return self.net.apply_with_weights(v, q, a, w, ctx)


def _remat_joint(net: TCNet, ctx: Optional[Ctx], v, q_state, a_state, w):
    """``net.apply_with_weights`` under
    :func:`~vqatpu_torch.ops.module.checkpoint_with_dropout`.  The weights
    are checkpoint inputs: at bf16 compute they are the forward's bf16
    casts (``functional_call`` has swapped them in), which the recompute in
    the backward, after ``functional_call`` has put the float32 masters
    back, must run on too."""
    glimpse = _Glimpse(net)
    weights = dict(glimpse.named_parameters())
    return checkpoint_with_dropout(
        lambda c, ws, *x: functional_call(glimpse, ws, (c, *x)),
        ctx, weights, v, q_state, a_state, w)


class TrilinearModel(nn.Module):
    """The CTI body that the free-form :class:`CTIModel` and the
    multiple-choice :class:`~vqatpu_torch.models.mc.TanModel` share
    (``FFOE/base_model.py:95-136``, ``MC/base_model.py:112-152``): dual GRU
    streams (question + answer), trilinear attention, and per glimpse a
    joint embedding with residual updates to both streams.  The attention
    lives under :attr:`att_name` (``t_att`` in CTI, ``v_att`` in TanModel,
    JAX's tree paths); the classifier has ``cfg.num_classes`` outputs.

    With :attr:`reads_v_knobs` (CTI; TanModel ignores them, as JAX's does)
    the forward takes JAX's three variants (``vqatpu/models/ffoe.py:
    250-357``):

    - ``0 < v_block_size < V`` (``:250-253``): the blockwise path
      (:mod:`vqatpu_torch.kernels.blockwise`, ``_apply_blockwise``
      ``:332-357``), which runs none of the CUDA kernels and returns
      ``att=None``;
    - ``fused_v_tucker`` without ``remat_glimpse`` (``:255-275``): the 1+γ
      v-side tuckers as one GEMM with one dropout mask on ``v``
      (:func:`~vqatpu_torch.ops.trilinear.fused_tucker_projection`), drawn
      before the attention's other masks;
    - ``remat_glimpse`` (``:292-322``): each glimpse's joint embedding runs
      under ``torch.utils.checkpoint`` (:func:`_remat_joint`), so its
      tucker activations are not kept for the backward but recomputed with
      the same dropout masks; the recompute launches K2 again.
    """

    att_name = "t_att"
    reads_v_knobs = False
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

    def _residual(self, g: int, joint, q_state, a_state, ctx):
        joint = joint[:, None, :]
        return (getattr(self, f"q_prj{g}")(joint, ctx) + q_state,
                getattr(self, f"a_prj{g}")(joint, ctx) + a_state)

    def _head(self, q_state, a_state, ctx):
        return self.classifier(q_state.sum(1) + a_state.sum(1), ctx)

    def forward(self, v: torch.Tensor, q: torch.Tensor,
                a: Optional[torch.Tensor] = None,
                v_mask: Optional[torch.Tensor] = None,
                ctx: Optional[Ctx] = None, b: Optional[torch.Tensor] = None):
        if a is None:
            raise ValueError(f"{type(self).__name__} needs answer tokens")
        cfg = self.cfg
        knobs = self.reads_v_knobs
        q_state = self.q_emb(self.w_emb(q, ctx), ctx)       # [B, Q, H]
        a_state = self.ans_emb(self.wa_emb(a, ctx), ctx)    # [B, A, H]
        if v_mask is None:
            v_mask = box_mask_from_features(v)
        if knobs and 0 < cfg.v_block_size < v.shape[1]:
            return self._forward_blockwise(v, q_state, a_state, v_mask, ctx)
        att_net = getattr(self, self.att_name)
        nets = [getattr(self, f"t_net{g}") for g in range(cfg.gamma)]
        v_ts = [None] * (1 + cfg.gamma)
        if knobs and cfg.fused_v_tucker and not cfg.remat_glimpse:
            # one dropout draw and activation for every net: valid only
            # while their configs agree (JAX's assert)
            tuckers = [att_net.tc.v_tucker] + [n.v_tucker for n in nets]
            if len({(t.dropout, t.act) for t in tuckers}) > 1:
                raise ValueError("fused_v_tucker requires matching "
                                 "t_att/t_net tucker configs")
            v_ts = fused_tucker_projection(tuckers, v, tuckers[1].dropout,
                                           tuckers[1].act, ctx)
        att, _ = att_net(v, q_state, a_state, v_mask, ctx,
                         v_t=v_ts[0])                   # [B, V, Q, A, G]
        for g, net in enumerate(nets):
            if knobs and cfg.remat_glimpse:
                joint = _remat_joint(net, ctx, v, q_state, a_state,
                                     att[..., g])
            else:
                joint = net.apply_with_weights(
                    v, q_state, a_state, att[..., g], ctx, v_t=v_ts[1 + g])
            q_state, a_state = self._residual(g, joint, q_state, a_state, ctx)
        return self._head(q_state, a_state, ctx), att

    def _forward_blockwise(self, v, q_state, a_state, v_mask, ctx):
        """The same math with O(v_block_size) memory in V; no attention."""
        block = self.cfg.v_block_size
        v_r, q_r, a_r, T = getattr(self, self.att_name).tc.rank_projections(
            v, q_state, a_state, ctx)
        tqa = precontract_qa(q_r, a_r, T)
        m, den = softmax_stats(v_r, tqa, v_mask, block)
        for g in range(self.cfg.gamma):
            vt, qt, at = getattr(self, f"t_net{g}").tucker_projections(
                v, q_state, a_state, ctx)
            joint = attention_pool_blockwise(v_r, tqa, v_mask, m, den, g,
                                             vt, qt, at, block)
            q_state, a_state = self._residual(g, joint, q_state, a_state, ctx)
        return self._head(q_state, a_state, ctx), None


class CTIModel(TrilinearModel):
    """The free-form CTI model (``vqatpu/models/ffoe.py:179-357``): the
    shared body with the v-side knobs read."""

    reads_v_knobs = True
