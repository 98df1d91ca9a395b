"""tf-idf weighted GloVe embedding initialization for out-of-GloVe vocab,
a copy of ``vqatpu.data.tfidf`` (``vqatpu/data/tfidf.py:33-298``) whose
:func:`tfidf_loading` writes into a port :class:`~vqatpu_torch.ops.
embedding.WordEmbedding`'s tables.

Reference: the original ``src/dataset.py:100-189`` (the *live*
``tfidf_from_questions`` consumed by ``utils.tfidf_loading``,
``utils.py:377-409``).  Builds a sparse word-coocurrence stochastic matrix
from question text so rows for extended-vocab words become tf-idf mixes of
GloVe rows.

Documented divergence: the reference has an indexing typo
(``vals[col] /= df[col]`` at ``dataset.py:165``) where its upstream
(hengyuan-hu/ban-vqa) uses ``vals[idx] /= df[col]``; we implement the
intended upstream math.

No torch.sparse: the co-occurrence pairs are generated with vectorized
numpy (questions grouped by token count, one ``triu_indices`` gather per
group), coalesced/normalized with ``np.unique``/``np.bincount``, and the
mix is applied as a scipy CSR @ dense — the same C-speed sparse matmul the
reference gets from ``torch.sparse.mm``, at VQA-2.0 scale (~650k questions,
millions of nonzeros) in seconds.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from vqatpu_torch.data.dictionary import Dictionary


def _iter_question_texts(names: Sequence[str], dataroot: str,
                         target: Sequence[str]):
    if "TDIUC" in target:
        for name in names:
            path = os.path.join(dataroot, f"TDIUC_{name}_questions.json")
            with open(path) as f:
                for q in json.load(f)["questions"]:
                    yield q["question"]
    if "vqa" in target:
        for name in names:
            suffix = name + "2014" if name[:4] != "test" else name
            path = os.path.join(
                dataroot, f"v2_OpenEnded_mscoco_{suffix}_questions.json")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                for q in json.load(f)["questions"]:
                    yield q["question"]
    if "vg" in target:
        path = os.path.join(dataroot, "question_answers.json")
        with open(path) as f:
            for vg in json.load(f):
                for q in vg["qas"]:
                    yield q["question"]
    if "v7w" in target:
        for name in names:
            path = os.path.join(dataroot, f"v7w_{name}_questions.json")
            with open(path) as f:
                for q in json.load(f)["questions"]:
                    yield q["question"]
            stat_path = os.path.join(dataroot, f"v7w_{name}_stat_words.json")
            if os.path.exists(stat_path):
                with open(stat_path) as f:
                    for s in json.load(f).values():
                        yield " ".join(",".join(s).split(","))


class SparseRowStochastic:
    """Row-stochastic sparse matrix in coalesced COO arrays."""

    def __init__(self, row: np.ndarray, col: np.ndarray, val: np.ndarray,
                 shape: Tuple[int, int]):
        self.row = np.asarray(row, np.int64)
        self.col = np.asarray(col, np.int64)
        self.val = np.asarray(val, np.float64)
        self.shape = shape

    @property
    def rows(self) -> Dict[int, Dict[int, float]]:
        """Dict-of-dicts view for inspection/tests (built on demand)."""
        out: Dict[int, Dict[int, float]] = {}
        for r, c, v in zip(self.row.tolist(), self.col.tolist(),
                           self.val.tolist()):
            out.setdefault(r, {})[c] = v
        return out

    def matmul_dense(self, dense: np.ndarray) -> np.ndarray:
        """[N, N'] @ [N', F] without densifying; only for rows present."""
        import scipy.sparse as sp

        dense = np.asarray(dense, np.float32)
        keep = self.col < dense.shape[0]
        mat = sp.csr_matrix(
            (self.val[keep], (self.row[keep], self.col[keep])),
            shape=(self.shape[0], dense.shape[0]))
        return np.asarray(mat @ dense, np.float32)

    __matmul__ = matmul_dense


def _build_row_stochastic(flat: np.ndarray, lens: np.ndarray, n_base: int,
                          n_vocab: int) -> SparseRowStochastic:
    """Vectorized co-occurrence -> tf-idf -> row-stochastic build.

    ``flat`` is every question's token ids concatenated, ``lens`` the per-
    question token counts.  Semantics match the reference loop
    (``dataset.py:145-168``): document frequency counts every token
    occurrence; each unordered in-question position pair (i<j) contributes
    1/df to both directed entries whose row is a base-vocab word
    (duplicated words therefore self-pair, as positions do in the
    reference's ``itertools.combinations``)."""
    flat = np.ascontiguousarray(flat, np.int32)  # vocab ids fit comfortably
    df = np.bincount(flat, minlength=n_vocab).astype(np.float64)
    inv_df = np.zeros(n_vocab, np.float64)
    np.divide(1.0, df, out=inv_df, where=df > 0)
    starts = np.concatenate([[0], np.cumsum(lens)])

    # Every entry's value is 1/df[col], so coalescing (row, col) duplicates
    # only needs a COUNT per unique key: one in-place np.sort of packed int
    # keys (no argsort, no value permutation) replaces the np.unique(int64,
    # return_inverse) pass that dominated build time at VQA-2.0 scale.
    key_dtype = np.int32 if n_base * n_vocab < 2 ** 31 else np.int64
    key_parts: List[np.ndarray] = []
    for L in np.unique(lens):
        if L < 2:
            continue
        qidx = np.nonzero(lens == L)[0]
        toks2d = flat[(starts[qidx][:, None] + np.arange(L)[None, :])]
        iu, ju = np.triu_indices(int(L), k=1)
        c0 = toks2d[:, iu].ravel()
        c1 = toks2d[:, ju].ravel()
        m0 = c0 < n_base
        m1 = c1 < n_base
        key_parts.append(c0[m0].astype(key_dtype) * n_vocab + c1[m0])
        key_parts.append(c1[m1].astype(key_dtype) * n_vocab + c0[m1])

    if not key_parts or not any(k.size for k in key_parts):
        return SparseRowStochastic(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                   np.zeros(0, np.float64), (1, n_vocab))

    keys = np.concatenate(key_parts)
    key_parts.clear()
    keys.sort()
    first = np.r_[0, np.flatnonzero(np.diff(keys)) + 1]
    counts = np.diff(np.r_[first, keys.size]).astype(np.float64)
    ukeys = keys[first]
    crow = (ukeys // n_vocab).astype(np.int64)
    ccol = (ukeys % n_vocab).astype(np.int64)
    cval = counts * inv_df[ccol]
    nrows = int(crow[-1]) + 1
    rowsum = np.bincount(crow, weights=cval, minlength=nrows)
    cval = cval / rowsum[crow]
    return SparseRowStochastic(crow, ccol, cval, (nrows, n_vocab))


def tfidf_from_questions(names: Sequence[str], dictionary: Dictionary,
                         dataroot: str = "data_vqa",
                         target: Sequence[str] = ("vqa",),
                         glove_file: str = None
                         ) -> Tuple[SparseRowStochastic, np.ndarray]:
    """Returns (tfidf row-stochastic matrix, GloVe rows for extended vocab).

    Side effect (as in the reference): extends ``dictionary`` with every word
    seen in the target question files.
    """
    N = len(dictionary)
    flat: List[int] = []
    lens: List[int] = []
    for text in _iter_question_texts(names, dataroot, target):
        # src/dataset.py's tokenizer (the tfidf one) strips '.' (:46)
        toks = dictionary.tokenize(text, add_word=True, strip_period=True)
        flat.extend(toks)
        lens.append(len(toks))
    tfidf = _build_row_stochastic(
        np.asarray(flat, np.int64), np.asarray(lens, np.int64), N,
        len(dictionary))

    # GloVe rows for the words the question files appended to the dictionary
    if glove_file is None:
        glove_file = os.path.join(dataroot, "glove", "glove.6B.300d.txt")
    if os.path.exists(glove_file):
        weights, _ = create_glove_embedding_init(dictionary.idx2word[N:], glove_file)
    else:
        weights = np.zeros((len(dictionary) - N, 300), np.float32)
    return tfidf, weights


def create_glove_embedding_init(idx2word: Sequence[str], glove_file: str
                                ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """GloVe txt -> [len(idx2word), emb_dim] matrix (``dataset.py:79-98``)."""
    word2emb: Dict[str, np.ndarray] = {}
    with open(glove_file, encoding="utf-8") as f:
        entries = f.readlines()
    emb_dim = len(entries[0].split(" ")) - 1
    weights = np.zeros((len(idx2word), emb_dim), np.float32)
    for entry in entries:
        vals = entry.split(" ")
        word2emb[vals[0]] = np.asarray(list(map(float, vals[1:])), np.float32)
    for idx, word in enumerate(idx2word):
        if word in word2emb:
            weights[idx] = word2emb[word]
    return weights, word2emb


def _read_embedding_cache(path: str):
    """Read ``embed_tfidf_weights.pkl`` in either format: our plain pickle
    {"emb", "emb_"}, or the reference's torch.save of the whole WordEmbedding
    module (``utils.py:398-401``) — drop-in dataroot compatibility.  Returns
    None when unreadable (caller recomputes)."""
    import pickle

    try:
        with open(path, "rb") as f:
            cached = pickle.load(f)
        if isinstance(cached, dict) and "emb" in cached:
            return cached
    except Exception:
        pass
    try:  # torch.save zipfile format holding the reference nn.Module.
        # The reference's module classes (src.language_model.WordEmbedding)
        # aren't importable here, so unresolvable classes unpickle into
        # permissive stubs; the tensors themselves reconstruct via torch's
        # own (importable) rebuild machinery.
        import pickle as _pickle
        import types

        import torch

        class _Stub:
            def __init__(self, *a, **k):
                pass

        class _Unpickler(_pickle.Unpickler):
            def find_class(self, mod, name):
                try:
                    return super().find_class(mod, name)
                except (ImportError, AttributeError):
                    return type(name, (_Stub,), {})

        pm = types.SimpleNamespace(__name__="vqatpu_stub_pickle",
                                   Unpickler=_Unpickler, load=_pickle.load)
        obj = torch.load(path, map_location="cpu", pickle_module=pm,
                         weights_only=False)

        def weight_of(o, name):
            sub = o.__dict__.get("_modules", {}).get(name)
            if sub is None:
                return None
            w = sub.__dict__.get("_parameters", {}).get("weight")
            return None if w is None else np.asarray(w.detach().numpy())

        emb = weight_of(obj, "emb")
        if emb is None:
            return None
        return {"emb": emb, "emb_": weight_of(obj, "emb_") if
                weight_of(obj, "emb_") is not None else emb}
    except Exception:
        return None


def tfidf_loading(w_emb, dataroot: str, dictionary: Dictionary,
                  names: Sequence[str] = ("train", "val", "test2015"),
                  target: Sequence[str] = ("vqa",), cache: bool = True):
    """Full tf-idf loading path with the reference's pickle cache
    (``embed_tfidf_weights.pkl``, ``utils.py:383-402``): writes GloVe into
    ``w_emb.emb`` and the tf-idf-mixed rows into ``w_emb.emb_`` (a
    :class:`~vqatpu_torch.ops.embedding.WordEmbedding`, in place); returns
    ``w_emb``.  ``vqatpu.data.tfidf.tfidf_loading`` returns the same tables
    as a new param dict."""
    import pickle

    import torch

    cat = hasattr(w_emb, "emb_")
    cache_path = os.path.join(dataroot, "embed_tfidf_weights.pkl")
    cached = (_read_embedding_cache(cache_path)
              if cache and os.path.isfile(cache_path) else None)
    if cached is not None:
        tables = {"emb": cached["emb"], "emb_": cached["emb_"]}
    else:
        weight_init = np.load(os.path.join(dataroot, "glove6b_init_300d.npy"))
        tfidf, weights = tfidf_from_questions(list(names), dictionary,
                                              dataroot, target)
        base = weight_init
        if weights.size > 0:
            base = np.concatenate([weight_init, weights], 0)
        mixed = tfidf.matmul_dense(base)
        tables = w_emb.pretrained_tables(weight_init)
        if cat:
            n = min(mixed.shape[0], w_emb.ntoken)
            tables["emb_"][:n] = mixed[:n]
        if cache:
            with open(cache_path, "wb") as f:
                pickle.dump({"emb": tables["emb"],
                             "emb_": tables.get("emb_", tables["emb"])}, f)
    with torch.no_grad():
        for name in ("emb", "emb_") if cat else ("emb",):
            param = getattr(w_emb, name)
            param.copy_(torch.as_tensor(np.asarray(tables[name], np.float32)))
    return w_emb
