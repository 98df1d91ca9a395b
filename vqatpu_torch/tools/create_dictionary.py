"""Build the question vocabulary and its GloVe init matrix
(``vqatpu/tools/create_dictionary.py:26-58``, reference
``tools/create_dictionary.py``).  Host only: it touches no device.

Run: ``python -m vqatpu_torch.tools.create_dictionary --dataroot data_vqa``
(``--emb_dim 300``).  It writes ``{dataroot}/dictionary.pkl`` and
``{dataroot}/glove6b_init_{emb_dim}d.npy`` from
``{dataroot}/glove/glove.6B.{emb_dim}d.txt``, the JAX tool's files.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from vqatpu_torch.data.dictionary import Dictionary
from vqatpu_torch.data.tfidf import create_glove_embedding_init

VQA_QUESTION_FILES = (
    "v2_OpenEnded_mscoco_train2014_questions.json",
    "v2_OpenEnded_mscoco_val2014_questions.json",
    "v2_OpenEnded_mscoco_test2015_questions.json",
    "v2_OpenEnded_mscoco_test-dev2015_questions.json",
)


def create_dictionary(dataroot: str, files=VQA_QUESTION_FILES) -> Dictionary:
    """Every question of the files that exist, tokenized with ``add_word``
    and the dictionary's period strip (``src/dataset.py:46``)."""
    d = Dictionary()
    for path in files:
        full = os.path.join(dataroot, path)
        if not os.path.exists(full):
            continue
        with open(full) as f:
            for q in json.load(f)["questions"]:
                d.tokenize(q["question"], add_word=True, strip_period=True)
    return d


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataroot", default="data_vqa")
    parser.add_argument("--emb_dim", type=int, default=300)
    args = parser.parse_args(argv)

    d = create_dictionary(args.dataroot)
    d.dump_to_file(os.path.join(args.dataroot, "dictionary.pkl"))
    print(f"dictionary: {d.ntoken} words")

    glove_file = os.path.join(args.dataroot, "glove",
                              f"glove.6B.{args.emb_dim}d.txt")
    weights, _ = create_glove_embedding_init(d.idx2word, glove_file)
    out = os.path.join(args.dataroot, f"glove6b_init_{args.emb_dim}d.npy")
    np.save(out, weights)
    print(f"wrote {out} {weights.shape}")


if __name__ == "__main__":
    main()
