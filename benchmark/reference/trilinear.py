"""Plain float32 PyTorch reference of the CTI body (Do et al., "Compact
Trilinear Interaction for Visual Question Answering", ICCV 2019,
arXiv:1909.11874): the free-form model of ``FFOE/base_model.py`` and the
multiple-choice TanModel of ``MC/base_model.py`` share it and differ in
their head's width and the name of their attention.

Written from the published model's equations, with no kernel, cache or
batching of the program, and imports nothing but ``torch``:

- words: a 300-d table and its 300-d copy, concatenated (op ``c``); the
  pad token (index ``ntoken``) reads zeros;
- a one-layer GRU over every token, in torch's gate order (r, z, n);
- weight-normed linears ``y = (x vᵀ) g / ||v||_F + b`` behind dropout;
- the trilinear attention: three tucker projections (to ``h_mm``), three
  stacks of ``rank`` nets (to ``h_mm / rank`` each, one dropout mask that
  the ranks share), the PARALIND core ``T`` joining them into logits
  ``[B, V, Q, A, G]``, and a softmax over (V, Q, A) per glimpse with the
  padded boxes at zero;
- per glimpse the joint embedding, a trilinear pool of 2·h_mm-wide
  tuckers of v, q and a weighted by that glimpse's attention, added to the
  question and answer states through a linear each;
- the classifier on the summed states: linear, ReLU, dropout, linear.

Dropout follows ``torch.nn.Dropout``: an element is kept where a uniform
draw is below ``1 - rate`` and scaled by ``1 / (1 - rate)``.  The draws
come from the generator handed in, one per site, in the published model's
order: the attention's v, q, a tuckers and rank nets, then per glimpse
the joint's v, q, a tuckers and the two residual linears, then the
classifier.  With the same generator state the masks are the program's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

# dropout rates of the published model (``tc.py``: (0.2, 0.5) for the q/a
# and v sides of every trilinear net; ``FFOE/base_model.py``: 0.2 on the
# residual linears); the classifier's is the config's ``dropout``
DROP_QA, DROP_V, DROP_PRJ = 0.2, 0.5, 0.2
WORD_DIM = 300
NEG_BIG = -1e30


def leaves(m: dict, att: str, n_cls: int) -> List[Tuple[str, tuple, tuple]]:
    """``[(name, shape, init)]`` of every weight, under the names of the
    checkpoint layout.  ``init``: ``("normal", pad_row)``, ``("uniform",
    bound)`` or ``("norm", v_name, per_rank)`` (a weight-norm scale equal
    to its direction's Frobenius norm, so that the weight is ``v``)."""
    H, d, R = m["num_hid"], m["h_mm"] * m["k"], m["rank"]
    X, G, ntok = m["h_mm"] // R, m["gamma"], m["ntoken"]
    out: List[Tuple[str, tuple, tuple]] = []

    def wn(name, n_out, n_in):
        b = 1.0 / n_in ** 0.5
        out.extend([(f"{name}.v", (n_out, n_in), ("uniform", b)),
                    (f"{name}.g", (), ("norm", f"{name}.v", False)),
                    (f"{name}.b", (n_out,), ("uniform", b))])

    for emb, rnn in (("w_emb", "q_emb"), ("wa_emb", "ans_emb")):
        out.append((f"{emb}.emb", (ntok + 1, WORD_DIM), ("normal", ntok)))
        out.append((f"{emb}.emb_", (ntok + 1, WORD_DIM), ("normal", ntok)))
        b = 1.0 / H ** 0.5
        out.extend([(f"{rnn}.weight_ih_l0", (3 * H, 2 * WORD_DIM), ("uniform", b)),
                    (f"{rnn}.weight_hh_l0", (3 * H, H), ("uniform", b)),
                    (f"{rnn}.bias_ih_l0", (3 * H,), ("uniform", b)),
                    (f"{rnn}.bias_hh_l0", (3 * H,), ("uniform", b))])
    tc = f"{att}.tc"
    out.append((f"{tc}.T_g", (R, X, X, X, G, 1), ("normal", None)))
    for side, n_in in (("v", m["v_dim"]), ("q", H), ("a", H)):
        wn(f"{tc}.{side}_tucker.l0", d, n_in)
    for side in ("v", "q", "a"):
        name, b = f"{tc}.{side}_net.l0", 1.0 / d ** 0.5
        out.extend([(f"{name}.v", (R, X, d), ("uniform", b)),
                    (f"{name}.g", (R,), ("norm", f"{name}.v", True)),
                    (f"{name}.b", (R, X), ("uniform", b))])
    wn("classifier.l1", 2 * H, H)
    wn("classifier.l2", n_cls, 2 * H)
    for g in range(G):
        for side, n_in in (("v", m["v_dim"]), ("q", H), ("a", H)):
            wn(f"t_net{g}.{side}_tucker.l0", 2 * m["h_mm"], n_in)
        wn(f"q_prj{g}.l0", H, H)
        wn(f"a_prj{g}.l0", H, H)
    return out


class Dropout:
    """The masks of ``torch.nn.Dropout`` drawn from ``generator``; None
    (eval) keeps everything."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.generator is None or rate <= 0.0:
            return x
        keep = 1.0 - rate
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def wn_linear(w: Dict[str, torch.Tensor], name: str,
              x: torch.Tensor) -> torch.Tensor:
    v = w[f"{name}.v"]
    return F.linear(x, v) * (w[f"{name}.g"] / v.square().sum().sqrt()) \
        + w[f"{name}.b"]


def rank_nets(w, name: str, x: torch.Tensor) -> torch.Tensor:
    """``rank`` weight-normed linears over the same input, ReLU: [..., d]
    -> [..., R, X]."""
    v = w[f"{name}.v"]
    R, X, d = v.shape
    scale = w[f"{name}.g"] / v.reshape(R, -1).square().sum(1).sqrt()
    y = F.linear(x, v.reshape(R * X, d)) * scale.repeat_interleave(X) \
        + w[f"{name}.b"].reshape(-1)
    return torch.relu(y).reshape(*x.shape[:-1], R, X)


def embed(w, name: str, tokens: torch.Tensor, ntoken: int) -> torch.Tensor:
    keep = (tokens != ntoken).to(torch.float32)[..., None]
    return torch.cat([w[f"{name}.emb"][tokens] * keep,
                      w[f"{name}.emb_"][tokens] * keep], -1)


def gru(w, name: str, x: torch.Tensor) -> torch.Tensor:
    """Every step's state of a one-layer GRU from a zero state, [B, T, H]."""
    w_hh, b_hh = w[f"{name}.weight_hh_l0"], w[f"{name}.bias_hh_l0"]
    gi = F.linear(x, w[f"{name}.weight_ih_l0"], w[f"{name}.bias_ih_l0"])
    h = x.new_zeros(x.shape[0], w_hh.shape[1])
    states = []
    for t in range(x.shape[1]):
        i_r, i_z, i_n = gi[:, t].chunk(3, -1)
        h_r, h_z, h_n = F.linear(h, w_hh, b_hh).chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        h = (1.0 - z) * torch.tanh(i_n + r * h_n) + z * h
        states.append(h)
    return torch.stack(states, 1)


def attention(w, att: str, v, q_state, a_state, v_mask, drop: Dropout):
    """The trilinear attention [B, V, Q, A, G]."""
    tc = f"{att}.tc"
    v_t = torch.relu(wn_linear(w, f"{tc}.v_tucker.l0", drop(v, DROP_V)))
    q_t = torch.relu(wn_linear(w, f"{tc}.q_tucker.l0", drop(q_state, DROP_QA)))
    a_t = torch.relu(wn_linear(w, f"{tc}.a_tucker.l0", drop(a_state, DROP_QA)))
    v_r = rank_nets(w, f"{tc}.v_net.l0", drop(v_t, DROP_V))
    q_r = rank_nets(w, f"{tc}.q_net.l0", drop(q_t, DROP_QA))
    a_r = rank_nets(w, f"{tc}.a_net.l0", drop(a_t, DROP_QA))
    T = w[f"{tc}.T_g"][..., 0]
    ta = torch.einsum("blrz,rxyzg->blrxyg", a_r, T)
    tqa = torch.einsum("bjry,blrxyg->bjlrxg", q_r, ta)
    logits = torch.einsum("birx,bjlrxg->bijlg", v_r, tqa)
    mask5 = v_mask[:, :, None, None, None]
    neg = torch.where(mask5, logits, torch.full_like(logits, NEG_BIG))
    e = torch.exp(neg - neg.amax(dim=(1, 2, 3), keepdim=True)) * mask5
    return e / e.sum(dim=(1, 2, 3), keepdim=True).clamp_min(1e-30)


def joint(w, g: int, v, q_state, a_state, att_g, drop: Dropout):
    """Glimpse ``g``'s pooled joint embedding [B, 2·h_mm]."""
    vt = torch.relu(wn_linear(w, f"t_net{g}.v_tucker.l0", drop(v, DROP_V)))
    qt = torch.relu(wn_linear(w, f"t_net{g}.q_tucker.l0",
                              drop(q_state, DROP_QA)))
    at = torch.relu(wn_linear(w, f"t_net{g}.a_tucker.l0",
                              drop(a_state, DROP_QA)))
    wv = torch.einsum("bvqa,bvd->bqad", att_g, vt)
    return torch.einsum("bqad,bqd->bad", wv, qt).mul(at).sum(1)


def forward(w, m: dict, att: str, v, q, a, v_mask,
            drop: Dropout) -> torch.Tensor:
    """Logits [B, n_cls] of features ``v`` [B, V, v_dim] (``v_mask`` [B, V]
    marks the real boxes), question tokens ``q`` [B, Q] and answer tokens
    ``a`` [B, A]."""
    q_state = gru(w, "q_emb", embed(w, "w_emb", q, m["ntoken"]))
    a_state = gru(w, "ans_emb", embed(w, "wa_emb", a, m["ntoken"]))
    att_w = attention(w, att, v, q_state, a_state, v_mask, drop)
    for g in range(m["gamma"]):
        j = joint(w, g, v, q_state, a_state, att_w[..., g], drop)[:, None]
        q_state = wn_linear(w, f"q_prj{g}.l0", drop(j, DROP_PRJ)) + q_state
        a_state = wn_linear(w, f"a_prj{g}.l0", drop(j, DROP_PRJ)) + a_state
    h = torch.relu(wn_linear(w, "classifier.l1",
                             q_state.sum(1) + a_state.sum(1)))
    return wn_linear(w, "classifier.l2", drop(h, m["dropout"]))


def bce_mean(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``nn.BCEWithLogitsLoss(reduction='sum')`` over the rows, divided by
    their number (the reference's criterion)."""
    per = (logits.clamp_min(0.0) - logits * target
           + torch.log1p(torch.exp(-logits.abs())))
    return per.sum() / logits.shape[0]


def model_flop(m: dict, n_cls: int, V: int, Q: int, A: int,
               train: bool) -> int:
    """Operations of one row's forward (and, with ``train``, its backward)
    at these shapes: 2 per multiply-add of every product the equations
    above hold, whatever computes them; elementwise work is not counted.
    The backward takes each product twice more (the gradient of each
    operand), except the gradient of the image features, which nothing
    needs."""
    H, R, G = m["num_hid"], m["rank"], m["gamma"]
    d = m["h_mm"] * m["k"]
    X, D, W = m["h_mm"] // R, 2 * m["h_mm"], 2 * WORD_DIM
    fwd_w = {}  # products with a weight: (forward FLOP, input needs grad)

    def lin(key, rows, n_in, n_out, grad_in=True):
        fwd_w[key] = (2 * rows * n_in * n_out, grad_in)

    for s, T_ in (("q", Q), ("a", A)):
        lin(f"gru_{s}_in", T_, W, 3 * H)
        lin(f"gru_{s}_hh", T_, H, 3 * H)
    lin("att_v_tucker", V, m["v_dim"], d, grad_in=False)
    lin("att_q_tucker", Q, H, d)
    lin("att_a_tucker", A, H, d)
    for s, rows in (("v", V), ("q", Q), ("a", A)):
        lin(f"att_{s}_net", rows, d, R * X)
    for g in range(G):
        lin(f"j{g}_v_tucker", V, m["v_dim"], D, grad_in=False)
        lin(f"j{g}_q_tucker", Q, H, D)
        lin(f"j{g}_a_tucker", A, H, D)
        lin(f"prj{g}_q", 1, H, H)
        lin(f"prj{g}_a", 1, H, H)
    lin("cls_l1", 1, H, 2 * H)
    lin("cls_l2", 1, 2 * H, n_cls)
    # products of activations: the core, the logits, the pools
    core = (2 * A * R * X ** 3 * G      # a_r . T
            + 2 * Q * A * R * X * X * G  # q_r . (a_r T)
            + 2 * V * R * X * Q * A * G)  # v_r . (q_r a_r T): the logits
    pool = G * 2 * D * (V * Q * A + Q * A + A)
    fwd = sum(f for f, _ in fwd_w.values()) + core + pool
    if not train:
        return fwd
    bwd = sum(f * (2 if grad_in else 1) for f, grad_in in fwd_w.values())
    # both operands of every activation product need their gradient
    bwd += 2 * core + 2 * pool
    return fwd + bwd
