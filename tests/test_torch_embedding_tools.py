"""The answer-embedding tools against ``vqatpu.tools.create_embedding`` on
the CPU: the GloVe answer matrices on a synthetic GloVe text file (equal
files), the GRU answer encoding with JAX's own GRU weights (within 1e-5),
its seeded default, and the BERT rows with a tiny random-init
``BertModel`` (equal, as ``tests/test_tools.py`` runs JAX's)."""

import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax

from vqatpu.data.synthetic import make_vqa_fixture
from vqatpu.ops import QuestionEmbedding as JaxQuestionEmbedding
from vqatpu.tools import create_embedding as jtool
from vqatpu_torch.tools import create_embedding as tool


def glove_root(root):
    os.makedirs(os.path.join(root, "cache"))
    os.makedirs(os.path.join(root, "glove"))
    with open(os.path.join(root, "cache", "trainval_label2ans.pkl"),
              "wb") as f:
        pickle.dump(["red", "blue bird", "unknownword", "bird"], f)
    for dim in (2, 3):
        with open(os.path.join(root, "glove", f"glove.6B.{dim}d.txt"),
                  "w") as f:
            for i, w in enumerate(("red", "blue", "bird", "cat")):
                f.write(w + " " + " ".join(f"{0.25 * (i + 1) + j:.4f}"
                                           for j in range(dim)) + "\n")
    return root


def test_create_answer_glove_writes_jaxs_file(tmp_path):
    a, b = (glove_root(str(tmp_path / n)) for n in ("jax", "port"))
    want = np.load(jtool.create_answer_glove(a, emb_dims=(2, 3)))
    out = tool.create_answer_glove(b, emb_dims=(2, 3))
    assert os.path.basename(out) == "glove6b_emb_5d.npy"
    got = np.load(out)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2], 0.0)  # not in GloVe: zeros


@pytest.fixture(scope="module")
def vqa_roots(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data_vqa"))
    make_vqa_fixture(root, n_train=4, n_val=2, n_images=2, v_dim=8)
    shutil.copytree(root, root + "_port")
    return root, root + "_port"


def test_create_answer_embedding_with_jaxs_gru(vqa_roots):
    """JAX's ``create_answer_embedding`` draws its GRU from
    ``PRNGKey(seed)``; given those weights the port's file agrees."""
    root_j, root_p = vqa_roots
    with open(jtool.create_answer_embedding(root_j, num_hid=16, seed=0),
              "rb") as f:
        want = pickle.load(f)
    _, k2 = jax.random.split(jax.random.PRNGKey(0))
    gru = jax.tree.map(np.asarray, JaxQuestionEmbedding(600, 16).init(k2))
    with open(tool.create_answer_embedding(root_p, num_hid=16,
                                           gru_params=gru, device="cpu"),
              "rb") as f:
        got = pickle.load(f)
    assert got.shape == want.shape == (len(want), 16)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_answer_embedding_seeded_default(vqa_roots):
    """Without weights the GRU is drawn from a torch.Generator: the same
    seed gives the same file, another seed another one."""
    root = vqa_roots[1]
    runs = []
    for seed in (3, 3, 4):
        with open(tool.create_answer_embedding(root, num_hid=8, seed=seed,
                                               device="cpu"), "rb") as f:
            runs.append(pickle.load(f))
    assert np.isfinite(runs[0]).all() and runs[0].shape[1] == 8
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])


def test_create_bert_embedding_with_tiny_model(tmp_path, monkeypatch):
    """A tiny random-init BertModel and a stub tokenizer (no download): the
    port's rows equal JAX's tool's."""
    monkeypatch.setenv("USE_TF", "0")  # torch's BERT; TensorFlow unneeded
    transformers = pytest.importorskip("transformers")
    from vqatpu.data.dictionary import Dictionary as JaxDictionary

    d = JaxDictionary()
    d.tokenize("what color is the cat", add_word=True)
    for sub in ("jax", "port"):
        os.makedirs(tmp_path / sub)
        d.dump_to_file(str(tmp_path / sub / "dictionary.pkl"))
    torch.manual_seed(0)
    model = transformers.BertModel(transformers.BertConfig(
        vocab_size=64, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=8))

    class StubTokenizer:
        def tokenize(self, word):
            return list(word)[:4]

        def convert_tokens_to_ids(self, tokens):
            return [ord(t) % 64 for t in tokens]

    want = np.load(jtool.create_bert_embedding(
        str(tmp_path / "jax"), model=model, tokenizer=StubTokenizer()))
    got = np.load(tool.create_bert_embedding(
        str(tmp_path / "port"), model=model, tokenizer=StubTokenizer(),
        device="cpu"))
    assert got.shape == (d.ntoken, 16) and np.abs(got).sum() > 0
    np.testing.assert_array_equal(got, want)
