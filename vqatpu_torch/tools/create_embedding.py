"""Answer-string embedding tools (``vqatpu/tools/create_embedding.py:
24-152``).

- :func:`create_answer_glove`: GloVe matrices of the answer strings, the
  50/100/200/300-d files side by side (reference
  ``tools/create_embedding.py``; a multi-word answer sums its words' rows).
- :func:`create_answer_embedding`: every answer through the word embedding
  (GloVe rows) and a GRU, its last state -> ``answer_embedding.pkl``
  [num_ans, num_hid] (reference ``tools/create_answer_embedding.py``), on
  the card unless ``device="cpu"``.  JAX draws the GRU's weights from
  ``jax.random.PRNGKey(seed)``, which the port cannot reproduce without
  JAX: it takes them as a ``gru_params`` tree (JAX's ``{"fwd": {w_ih,
  w_hh, b_ih, b_hh}}``), and without one draws them from a
  ``torch.Generator`` seeded with ``seed`` (torch's U(-1/sqrt(H),
  1/sqrt(H))), so its file differs from JAX's for the same seed.
- :func:`create_bert_embedding`: 768-d pooled BERT rows of the vocabulary
  (reference ``tools/create_bert_embedding.py``), gated on
  ``transformers``, on the card unless ``device="cpu"``; a model and
  tokenizer may be passed in.

Run: ``python -m vqatpu_torch.tools.create_embedding --dataroot data_vqa
--kind glove|gru|bert [--num_hid 1024] [--device cuda]``.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from vqatpu_torch.data.dictionary import Dictionary
from vqatpu_torch.data.tfidf import create_glove_embedding_init


def glove_rows_with_fallback(strings: Sequence[str],
                             word2emb: Dict[str, np.ndarray],
                             emb_dim: int) -> np.ndarray:
    """A GloVe row per string; a string not in GloVe sums its words' rows
    (``create_embedding.py:30-42``)."""
    weights = np.zeros((len(strings), emb_dim), np.float32)
    for idx, s in enumerate(strings):
        if s in word2emb:
            weights[idx] = word2emb[s]
        else:
            for w in s.split(" "):
                if w in word2emb:
                    weights[idx] += word2emb[w]
    return weights


def create_answer_glove(dataroot: str, emb_dims=(50, 100, 200, 300)) -> str:
    with open(os.path.join(dataroot, "cache", "trainval_label2ans.pkl"),
              "rb") as f:
        label2ans = pickle.load(f)
    parts = []
    for emb_dim in emb_dims:
        glove_file = os.path.join(dataroot, "glove",
                                  f"glove.6B.{emb_dim}d.txt")
        _, word2emb = create_glove_embedding_init([], glove_file)
        parts.append(glove_rows_with_fallback(label2ans, word2emb, emb_dim))
    out = os.path.join(dataroot, f"glove6b_emb_{sum(emb_dims)}d.npy")
    np.save(out, np.hstack(parts))
    return out


def _seeded_gru(in_dim: int, num_hid: int, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    bound = 1.0 / num_hid ** 0.5

    def uni(*shape):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * bound).numpy()

    return {"fwd": {"w_ih": uni(3 * num_hid, in_dim),
                    "w_hh": uni(3 * num_hid, num_hid),
                    "b_ih": uni(3 * num_hid), "b_hh": uni(3 * num_hid)}}


def create_answer_embedding(dataroot: str, num_hid: int = 1024,
                            op: str = "c", seed: int = 0,
                            gru_params: Optional[dict] = None,
                            device="cuda") -> str:
    """Encode every answer with the word embedding (GloVe init) and a GRU
    in eval mode; ``gru_params``: the GRU's weights, a JAX-layout tree
    (else drawn from ``seed``, see the module docstring)."""
    from vqatpu_torch.ops.embedding import WordEmbedding
    from vqatpu_torch.ops.rnn import QuestionEmbedding
    from vqatpu_torch.weights import torch_state_from_jax

    dictionary = Dictionary.load_from_file(
        os.path.join(dataroot, "dictionary.pkl"))
    with open(os.path.join(dataroot, "cache", "trainval_ans2label.pkl"),
              "rb") as f:
        ans_list = list(pickle.load(f))
    w_emb = WordEmbedding(dictionary.ntoken, 300, 0.0, op)
    glove = np.load(os.path.join(dataroot, "glove6b_init_300d.npy"))
    w_emb.load_state_dict({k: torch.from_numpy(t) for k, t in
                           w_emb.pretrained_tables(glove).items()})
    ans_emb = QuestionEmbedding(w_emb.out_dim, num_hid)
    if gru_params is None:
        gru_params = _seeded_gru(w_emb.out_dim, num_hid, seed)
    ans_emb.load_state_dict(torch_state_from_jax(gru_params), strict=True)
    # create_answer_embedding.py tokenizes as src/dataset.py ('.' stripped)
    tokens = torch.tensor(
        [dictionary.tokenize_padded(a, 3, strip_period=True)
         for a in ans_list], dtype=torch.int64)
    w_emb, ans_emb = w_emb.to(device).eval(), ans_emb.to(device).eval()
    with torch.inference_mode():
        enc = ans_emb.forward_last(w_emb(tokens.to(device)))
    out = os.path.join(dataroot, "answer_embedding.pkl")
    with open(out, "wb") as f:
        pickle.dump(enc.float().cpu().numpy(), f)
    return out


def bert_embedding_matrix(idx2word, model, tokenizer,
                          device="cuda") -> np.ndarray:
    """Per-word pooled-BERT rows (``tools/create_bert_embedding.py:7-14``):
    each word's wordpieces through ``model`` on ``device``, its
    ``pooler_output``."""
    hidden = int(model.config.hidden_size)
    weights = np.zeros((len(idx2word), hidden), np.float32)
    model = model.to(device)
    with torch.no_grad():
        for idx, word in enumerate(idx2word):
            ids = tokenizer.convert_tokens_to_ids(tokenizer.tokenize(word))
            if not ids:
                continue
            out = model(torch.tensor([ids], device=device))
            pooled = out[1] if isinstance(out, tuple) else out.pooler_output
            weights[idx] = pooled[0].float().cpu().numpy()
    return weights


def create_bert_embedding(dataroot: str,
                          model_name: str = "bert-base-uncased",
                          model=None, tokenizer=None, device="cuda") -> str:
    """The vocabulary's pooled BERT rows -> ``bert_embedding.npy``, BERT
    run on ``device``; without
    ``model`` / ``tokenizer`` they come from ``transformers``'
    ``from_pretrained(model_name)``, which needs the weights locally."""
    if model is None or tokenizer is None:
        try:
            from transformers import BertModel, BertTokenizer
        except ImportError as e:
            raise RuntimeError(
                "transformers unavailable for BERT embeddings") from e
        tokenizer = tokenizer or BertTokenizer.from_pretrained(model_name)
        model = model or BertModel.from_pretrained(model_name)
    model.eval()
    d = Dictionary.load_from_file(os.path.join(dataroot, "dictionary.pkl"))
    out_path = os.path.join(dataroot, "bert_embedding.npy")
    np.save(out_path, bert_embedding_matrix(d.idx2word, model, tokenizer,
                                           device))
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataroot", default="data_vqa")
    parser.add_argument("--kind", choices=["glove", "gru", "bert"],
                        default="gru")
    parser.add_argument("--num_hid", type=int, default=1024)
    parser.add_argument("--device", default="cuda",
                        help="device of the gru and bert encodings")
    args = parser.parse_args(argv)
    if args.kind == "glove":
        print(create_answer_glove(args.dataroot))
    elif args.kind == "gru":
        print(create_answer_embedding(args.dataroot, args.num_hid,
                                      device=args.device))
    else:
        print(create_bert_embedding(args.dataroot, device=args.device))


if __name__ == "__main__":
    main()
