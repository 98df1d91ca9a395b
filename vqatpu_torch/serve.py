"""Inference session: checkpoint -> answer strings
(``vqatpu/serve.py:146-298``).

- Requests are packed into the smallest batch bucket (1, 8, 32, 128 by
  default) and the padded rows are fully masked; a request larger than the
  largest bucket is chunked.
- Boxes beyond ``max_boxes`` are cut, fewer are zero-padded, and a box is
  real where its features are not all zero.
- The forward runs under ``torch.inference_mode()`` on ``device`` (``cuda``
  unless the caller asks for ``cpu``), in float32 throughout: the session
  turns TF32 off for cuBLAS and for cuDNN (the GRU) and refuses to run if
  either is turned back on.

Only the float32 wire and float32 compute are ported; the narrowed wires,
bf16 compute, ``MicroBatcher`` and by-id serving are ROADMAP queue A items 2
and 3.

Usage::

    sess = InferenceSession.from_checkpoint(ckpt, model_cfg, label2ans)
    answers = sess.answer(features, spatials, question_tokens, answer_tokens)
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vqatpu_torch.config import ModelConfig
from vqatpu_torch.models import build_model
from vqatpu_torch.weights import load_jax_params, load_params_file


def require_f32_math() -> None:
    """Turn TF32 off for float32 GEMMs (cuBLAS) and cuDNN (the GRU), whose
    default is on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class InferenceSession:
    def __init__(self, model: torch.nn.Module, label2ans: Sequence[str],
                 batch_buckets: Sequence[int] = (1, 8, 32, 128),
                 max_boxes: int = 50, transfer_dtype=None,
                 compute_dtype: str = "float32", device="cuda"):
        if transfer_dtype not in (None, "float32", np.float32):
            raise NotImplementedError(
                f"transfer_dtype={transfer_dtype!r}: only the float32 wire "
                "is ported (ROADMAP queue A item 2)")
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={compute_dtype!r}: only float32 compute is "
                "ported (ROADMAP queue A item 2)")
        require_f32_math()
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.label2ans = list(label2ans)
        self.batch_buckets = sorted(batch_buckets)
        self.max_boxes = max_boxes
        self.transfer_dtype = transfer_dtype
        self.compute_dtype = compute_dtype
        # forwards run, in all and per bucket size
        self.forwards = 0
        self.bucket_calls: Dict[int, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def from_checkpoint(cls, path: str, cfg: ModelConfig,
                        label2ans: Sequence[str], **kw) -> "InferenceSession":
        model = load_jax_params(build_model(cfg), load_params_file(path))
        return cls(model, label2ans, **kw)

    @property
    def num_classes(self) -> int:
        return self.model.cfg.num_classes

    def _bucket_for(self, n: int) -> int:
        i = bisect.bisect_left(self.batch_buckets, n)
        return self.batch_buckets[min(i, len(self.batch_buckets) - 1)]

    def logits(self, v: np.ndarray, b: Optional[np.ndarray], q: np.ndarray,
               a: Optional[np.ndarray] = None) -> np.ndarray:
        """Batched raw logits [N, num_classes].  ``v`` [N, boxes, v_dim],
        ``q`` [N, Q] and ``a`` [N, A] int tokens; ``b`` (spatials) is
        unused by CTI.  N may exceed the largest bucket."""
        if a is None:
            raise ValueError("CTI needs answer tokens")
        n = v.shape[0]
        if n == 0:
            return np.zeros((0, self.num_classes), np.float32)
        largest = self.batch_buckets[-1]
        # every chunk is enqueued before the first is read back, so the
        # host packs chunk i+1 while the card runs chunk i
        outs = [self._forward_chunk(v[s:s + largest], q[s:s + largest],
                                    a[s:s + largest])
                for s in range(0, n, largest)]
        return torch.cat(outs).cpu().numpy()

    def _forward_chunk(self, v, q, a) -> torch.Tensor:
        v = v[:, :self.max_boxes]
        n, boxes = v.shape[:2]
        bucket = self._bucket_for(n)
        vp = np.zeros((bucket, self.max_boxes, v.shape[2]), np.float32)
        vp[:n, :boxes] = v
        mask = np.zeros((bucket, self.max_boxes), bool)
        mask[:n, :boxes] = np.abs(v).sum(-1) != 0
        qp = np.zeros((bucket, q.shape[1]), np.int64)
        qp[:n] = q
        ap = np.zeros((bucket, a.shape[1]), np.int64)
        ap[:n] = a
        dev = self.device
        with self._lock, torch.inference_mode():
            if (torch.backends.cuda.matmul.allow_tf32
                    or torch.backends.cudnn.allow_tf32):
                raise RuntimeError("TF32 was turned back on; the serving "
                                   "path computes in float32")
            logits, _ = self.model(torch.from_numpy(vp).to(dev),
                                   torch.from_numpy(qp).to(dev),
                                   torch.from_numpy(ap).to(dev),
                                   torch.from_numpy(mask).to(dev))
            self.forwards += 1
            self.bucket_calls[bucket] = self.bucket_calls.get(bucket, 0) + 1
        return logits[:n]

    def answer(self, v, b, q, a=None) -> List[str]:
        """Argmax answer strings for a batch of requests."""
        logits = self.logits(v, b, q, a)
        return [self.label2ans[int(i)] for i in logits.argmax(1)]
