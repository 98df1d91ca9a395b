"""The traffic's inputs, made from the run's seed: questions, answers and
targets on the host, as a loader hands them over, and the order in which
they come.  Every seed gives the same sizes; only values and order move.

A workload file's keys read here:

- ``questions``: how many questions the split has (free-form: a question
  has ``question_tokens`` real tokens, padded to the config's
  ``question_len`` with the pad token, and an answer of ``answer_tokens``
  tokens; ``labels`` distinct soft-score labels, each 0.3, 0.6, 0.9 or 1);
- ``candidates`` (multiple choice): the choices a question offers, one of
  them right, each of ``answer_tokens`` tokens.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, Optional

import numpy as np

# streams of one seed, kept apart
WEIGHTS, STORE, FIELDS, ORDER, DROPOUT, SAMPLE = range(1, 7)
SCORES = np.array([0.3, 0.6, 0.9, 1.0], np.float32)


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed of its own for each stream of ``seed`` (any size)."""
    words = [int(seed) >> (32 * i) & 0xFFFFFFFF
             for i in range(max(1, (int(seed).bit_length() + 31) // 32))]
    state = np.random.SeedSequence(words + list(tags)).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def _tokens(rng, n: int, width: int, lengths, ntoken: int) -> np.ndarray:
    """``[n, width]`` int32 word ids, each row ``lengths`` real tokens and
    then the pad token ``ntoken``."""
    tok = rng.integers(0, ntoken, (n, width), dtype=np.int32)
    real = rng.integers(lengths[0], lengths[1] + 1, n)
    tok[np.arange(width)[None, :] >= real[:, None]] = ntoken
    return tok


def fields(m: dict, shapes: dict, wl: dict, seed: int) -> Dict[str, np.ndarray]:
    """Every question of the split (see the module docstring)."""
    rng = np.random.default_rng(derive(seed, FIELDS))
    n, ntok = wl["questions"], m["ntoken"]
    out = {"q": _tokens(rng, n, shapes["question_len"], wl["question_tokens"],
                        ntok)}
    if "candidates" in wl:
        c = wl["candidates"]
        out["ans_mc"] = _tokens(rng, n * c, shapes["answer_len"],
                                wl["answer_tokens"], ntok).reshape(n, c, -1)
        label = np.zeros((n, c), np.float32)
        label[np.arange(n), rng.integers(0, c, n)] = 1.0
        out["label"] = label
        return out
    out["a"] = _tokens(rng, n, shapes["answer_len"], wl["answer_tokens"], ntok)
    k_max, n_ans = wl["labels"][1], m["num_ans_candidates"]
    k = rng.integers(wl["labels"][0], k_max + 1, n)
    base = rng.integers(0, n_ans, n)
    stride = rng.integers(1, n_ans // k_max, n)  # k_max distinct labels
    out["t_label"] = ((base[:, None] + np.arange(k_max)[None, :]
                       * stride[:, None]) % n_ans).astype(np.int32)
    score = SCORES[rng.integers(0, len(SCORES), (n, k_max))]
    score[np.arange(k_max)[None, :] >= k[:, None]] = 0.0
    out["t_score"] = score
    return out


def batch(f: Dict[str, np.ndarray], idx: np.ndarray, n_ans: int) -> dict:
    """The loader's batch of the questions ``idx``: the fields, ``qid`` and
    the card-resident store's ``ds_idx``; free-form targets dense."""
    idx = np.asarray(idx, np.int64)
    out = {"q": f["q"][idx], "qid": idx.copy(), "ds_idx": idx}
    if "label" in f:
        out["label"] = f["label"][idx]
        out["ans_mc"] = f["ans_mc"][idx]
        return out
    out["a"] = f["a"][idx]
    score = f["t_score"][idx]
    r, c = np.nonzero(score > 0)
    target = np.zeros((len(idx), n_ans), np.float32)
    target[r, f["t_label"][idx][r, c]] = score[r, c]
    out["target"] = target
    return out


def expand(b: dict) -> dict:
    """A multiple-choice batch as rows, one per (question, candidate): the
    question and its ``ds_idx`` repeated, the candidate's tokens as ``a``
    and ``[right, wrong]`` as the target (``MC/train.py``).  A free-form
    batch is its rows already."""
    if "label" not in b:
        return b
    B, c = b["label"].shape
    label = b["label"].reshape(B * c, 1)
    return {"q": np.repeat(b["q"], c, 0), "a": b["ans_mc"].reshape(B * c, -1),
            "target": np.concatenate([label, 1.0 - label], 1),
            "ds_idx": np.repeat(b["ds_idx"], c, 0)}


class Stream:
    """The loader's batches of ``batch_q`` questions: shuffled, a new order
    each pass over the split, drawn from the seed (``shuffle``); or in
    order from a start drawn from the seed, wrapping round, as an eval
    sweep goes.  Iterates until :meth:`stop`."""

    def __init__(self, f: Dict[str, np.ndarray], n_ans: int, batch_q: int,
                 seed: int, shuffle: bool):
        self.f, self.n_ans, self.batch_q = f, n_ans, batch_q
        self.n = len(f["q"])
        self.rng = np.random.default_rng(derive(seed, ORDER))
        self.shuffle = shuffle
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def indices(self) -> Iterator[np.ndarray]:
        n, bq = self.n, self.batch_q
        if not self.shuffle:
            at = int(self.rng.integers(0, n))
            while True:
                yield (at + np.arange(bq)) % n
                at = (at + bq) % n
        while True:
            order = self.rng.permutation(n)
            for lo in range(0, n - bq + 1, bq):
                yield order[lo:lo + bq]

    def __iter__(self):
        for idx in self.indices():
            if self._stop.is_set():
                return
            yield batch(self.f, idx, self.n_ans)


def first(stream: Stream, k: int) -> list:
    """The first ``k`` batches of a fresh stream."""
    out = []
    for b in stream:
        out.append(b)
        if len(out) == k:
            return out
    raise ValueError("the stream ended early")


def drain(it: Optional[Iterator]) -> None:
    for _ in it or ():
        pass
