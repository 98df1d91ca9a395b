"""The object-counting module of Zhang et al., ICLR'18
(``vqatpu/ops/counter.py:26-163``, reference ``src/counting.py``).

- the ``min(objects, V)`` boxes of highest attention are kept (the math is
  invariant to their order; the choice among tied boxes is lower index
  first, as ``lax.top_k``'s);
- the attention goes through a sigmoid;
- eight monotonic ``PiecewiseLin(16)`` activations (``f0`` ... ``f7``)
  deduplicate over attention outer products and IoU distances;
- the soft count becomes an interpolated one-hot of ``objects + 1`` bins,
  scaled by a confidence.

Dtypes follow JAX's at bf16 compute: a ``PiecewiseLin`` gives the common
type of its input and its weights (its one-hot contraction takes the
input's dtype), and the one-hot of the count is float32
(``jax.nn.one_hot``'s default), so the output is float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vqatpu_torch.numerics import promote


class PiecewiseLin(nn.Module):
    """Monotonic piecewise-linear map of [0, 1] with ``n`` segments
    (``counting.py:148-176``).  The weights enter as ``w * sign(w)``, whose
    gradient ``sign(w)`` keeps the zero-initialised ``weight[0]`` at zero
    (``vqatpu/ops/counter.py:44``)."""

    def __init__(self, n: int = 16):
        super().__init__()
        self.n = n
        w = torch.ones(n + 1)
        w[0] = 0.0
        self.weight = nn.Parameter(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight * torch.sign(self.weight)
        w = w / w.sum()
        csum = torch.cumsum(w, 0)
        y = self.n * x
        idx = torch.floor(y).long()
        f = y - torch.floor(y)
        # one-hot contractions, as JAX's: a gather's backward on the card is
        # an index_put over a 17-entry table (83 ms of a 118 ms BAN step at
        # B=256 on the H100), the contraction's a small GEMV
        oh_l = F.one_hot(idx.clamp(0, self.n), self.n + 1).to(x.dtype)
        oh_r = F.one_hot((idx + 1).clamp(0, self.n), self.n + 1).to(x.dtype)
        left = torch.matmul(*promote(oh_l, csum))
        seg = torch.matmul(*promote(oh_r, w))
        return left + f * seg


class Counter(nn.Module):
    def __init__(self, objects: int = 10):
        super().__init__()
        self.objects = objects
        for i in range(8):
            self.add_module(f"f{i}", PiecewiseLin(16))

    def _f(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"f{i}")(x)

    @staticmethod
    def _outer_product(x):
        return x[..., :, None] * x[..., None, :]

    @staticmethod
    def _outer_diff(x):
        return (x[..., :, None] - x[..., None, :]).abs()

    @staticmethod
    def _area(box):
        # box [B, 4, m] as (x1, y1, x2, y2)
        x = (box[:, 2, :] - box[:, 0, :]).clamp_min(0)
        y = (box[:, 3, :] - box[:, 1, :]).clamp_min(0)
        return x * y

    def _iou(self, a, b):
        min_pt = torch.maximum(a[:, :2, :, None], b[:, :2, None, :])
        max_pt = torch.minimum(a[:, 2:, :, None], b[:, 2:, None, :])
        inter = (max_pt - min_pt).clamp_min(0)
        inter_area = inter[:, 0] * inter[:, 1]
        area_a = self._area(a)[:, :, None]
        area_b = self._area(b)[:, None, :]
        return inter_area / (area_a + area_b - inter_area + 1e-12)

    def forward(self, boxes: torch.Tensor,
                attention: torch.Tensor) -> torch.Tensor:
        """``boxes`` [B, 4, m], ``attention`` [B, m] -> count features
        [B, objects + 1]."""
        n = min(self.objects, attention.shape[1])
        # descending, ties lower index first (lax.top_k's order)
        att, idx = torch.sort(attention, dim=1, descending=True, stable=True)
        att, idx = att[:, :n], idx[:, :n]
        boxes = boxes.gather(2, idx[:, None, :].expand(-1, 4, -1))
        att = torch.sigmoid(att)

        relevancy = self._outer_product(att)
        distance = 1.0 - self._iou(boxes, boxes)
        score = self._f(0, relevancy) * self._f(1, distance)

        # deduplicate (counting.py:67-77): the outer difference of the
        # [B, n, n] dedup score over its last axis, [B, n, n, n], multiplied
        # down its first n axis
        dedup_score = self._f(3, relevancy) * self._f(4, distance)
        att_diff = self._outer_diff(att)
        score_diff = self._outer_diff(dedup_score)
        sim = self._f(2, 1.0 - score_diff).prod(1) * self._f(2, 1.0 - att_diff)
        row_sims = sim.sum(2)
        score = score / self._outer_product(row_sims)

        correction = self._f(0, att * att) / row_sims
        score = score.sum(2).sum(1, keepdim=True) + correction.sum(
            1, keepdim=True)
        score = torch.sqrt(score + 1e-20)
        one_hot = self._to_one_hot(score)

        att_conf = (self._f(5, att) - 0.5).abs()
        dist_conf = (self._f(6, distance) - 0.5).abs()
        conf = self._f(7, att_conf.mean(1, keepdim=True)
                       + dist_conf.mean(2).mean(1, keepdim=True))
        return one_hot * conf

    def _to_one_hot(self, scores: torch.Tensor) -> torch.Tensor:
        """[B, 1] soft count -> float32 interpolated one-hot [B, objects + 1]
        (``counting.py:79-96``)."""
        scores = scores.clamp(0.0, float(self.objects))
        i = torch.floor(scores).long()[:, 0]
        f = scores - torch.floor(scores)
        bins = self.objects + 1
        tl = F.one_hot(i.clamp(0, self.objects), bins).float()
        tr = F.one_hot((i + 1).clamp(0, self.objects), bins).float()
        return (1.0 - f) * tl + f * tr
