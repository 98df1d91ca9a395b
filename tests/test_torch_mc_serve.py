"""vqatpu_torch's multiple-choice serving and entry points on the CPU at
small width: ``InferenceSession.mc_scores`` / ``answer_mc`` against
vqatpu's session on the same weights (1e-5; picks equal), the
``MicroBatcher``, HTTP ``/answer_mc`` (``mc_tokens`` as JSON and npz,
``mc_answers`` strings) on a ``--task mc`` server built by the CLI, and
``mc_train`` / ``mc_test`` on the Visual7W fixture: per-step losses equal
on the Python loader, the C++ loader and the card-resident store, the
accuracy equal with the store on and off, and the grid path.
"""

import io
import json
import os
import re
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vqatpu.config import ModelConfig as JaxModelConfig
from vqatpu.models import build_model as jax_build_model
from vqatpu.serve import InferenceSession as JaxSession
from vqatpu_torch.cli import mc_test, mc_train
from vqatpu_torch.cli import serve as cli
from vqatpu_torch.config import ModelConfig
from vqatpu_torch.data import Dictionary
from vqatpu_torch.data.synthetic import add_v7w_grid_fixture, make_v7w_fixture
from vqatpu_torch.models import build_model
from vqatpu_torch.serve import InferenceSession, MicroBatcher
from vqatpu_torch.weights import load_jax_params, numpy_params

NTOKEN, V_DIM = 30, 16
CFG = dict(ntoken=NTOKEN, v_dim=V_DIM, num_ans_candidates=7, model="tan",
           num_hid=16, h_mm=8, rank=2, gamma=2, task="mc")
LABELS = ["match", "nonmatch"]
SESSION = dict(batch_buckets=(4, 16), max_boxes=10)
TOL = 1e-5


def questions(n, seed=0, c=4):
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 8, V_DIM).astype(np.float32)
    v[:, 6:] = 0.0
    b = rng.rand(n, 8, 6).astype(np.float32)
    q = rng.randint(0, NTOKEN + 1, (n, 12))
    mc = rng.randint(0, NTOKEN + 1, (n, c, 6))
    return v, b, q, mc


@pytest.fixture(scope="module")
def sessions():
    params = numpy_params(ModelConfig(**CFG), seed=2)
    model = load_jax_params(build_model(ModelConfig(**CFG)), params)
    port = InferenceSession(model, LABELS, device="cpu", **SESSION)
    ref = JaxSession(jax_build_model(JaxModelConfig(**CFG)),
                     jax.tree.map(jnp.asarray, params), LABELS, **SESSION)
    return port, ref


@pytest.mark.parametrize("n,c", [(1, 4), (4, 4), (5, 4), (3, 2)])
def test_mc_scores_match_jax(sessions, n, c):
    """4 to 20 candidate rows: one bucket, a chunk past the largest, and
    two candidates a question."""
    port, ref = sessions
    v, b, q, mc = questions(n, seed=n, c=c)
    got = port.mc_scores(v, b, q, mc)
    want = ref.mc_scores(v, b, q, mc)
    assert got.shape == (n, c)
    np.testing.assert_allclose(got, want, atol=TOL)
    assert ((got >= 0) & (got <= 1)).all()
    assert port.answer_mc(v, b, q, mc) == ref.answer_mc(v, b, q, mc) == \
        list(got.argmax(1))
    cands = [[f"c{i}{j}" for j in range(c)] for i in range(n)]
    assert port.answer_mc(v, b, q, mc, cands) == [
        cands[i][j] for i, j in enumerate(got.argmax(1))]


def test_mc_scores_through_the_microbatcher(sessions):
    port, _ = sessions
    mb = MicroBatcher(port, max_batch=16)
    try:
        v, b, q, mc = questions(3, seed=7)
        np.testing.assert_allclose(mb.mc_scores(v, b, q, mc),
                                   port.mc_scores(v, b, q, mc), atol=TOL)
        assert mb.answer_mc(v, b, q, mc) == port.answer_mc(v, b, q, mc)
        assert mb.rows_served == 24  # two calls of 3 x 4 candidate rows
    finally:
        mb.close()


def post(port, path, payload, npz=False):
    if npz:
        buf = io.BytesIO()
        np.savez(buf, **payload)
        data, ctype = buf.getvalue(), "application/x-npz"
    else:
        data, ctype = json.dumps(payload).encode(), "application/json"
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``mc_train`` three ways on the fixture (2 epochs of 4 steps at batch
    4): -> (dataroot, the flags, {way: (log.txt, its losses, output)})."""
    base = tmp_path_factory.mktemp("mc_cli")
    root = str(base / "data_v7w")
    make_v7w_fixture(root, n_train=16, n_val=8, n_images=6, v_dim=V_DIM)
    add_v7w_grid_fixture(root, n_images=6, v_dim=V_DIM)
    flags = ["--model", "cti", "--dataroot", root, "--num_hid", "16",
             "--h_mm", "8", "--rank", "2", "--batch_size", "4",
             "--max_boxes", "12", "--device", "cpu"]
    runs = {}
    for way, extra in (("python", ["--device_features", "off",
                                   "--no_native_loader"]),
                       ("native", ["--device_features", "off"]),
                       ("store", [])):
        out = str(base / way)
        mc_train.main(flags + extra + ["--output", out, "--epochs", "2"])
        text = open(os.path.join(out, "log.txt")).read()
        runs[way] = (text, re.findall(r"train_loss: (\S+),", text), out)
    return root, flags, runs


def test_mc_train_on_its_three_input_paths(trained):
    """The same losses and eval scores on each path, checkpoints from epoch
    0 (``MC/train.py:29``), and each path's decision in the log."""
    _, _, runs = trained
    logs = {w: (t, losses) for w, (t, losses, _) in runs.items()}
    assert logs["python"][1] == logs["native"][1] == logs["store"][1]
    assert len(logs["store"][1]) == 2
    scores = {w: re.findall(r"eval score: (\S+) \(100.00\)", t)
              for w, (t, _) in logs.items()}
    assert scores["python"] == scores["native"] == scores["store"]
    assert len(scores["store"]) == 2
    assert "device feature store: " in logs["store"][0]
    assert "eval device feature store: " in logs["store"][0]
    assert "feature store" not in logs["native"][0]
    for _, _, out in runs.values():
        assert {"model_epoch0.ckpt", "model_epoch1.ckpt"} <= set(os.listdir(out))


@pytest.mark.parametrize("wire", ["int8", "bfloat16"])
def test_mc_train_on_a_narrowed_wire(trained, wire):
    """A narrowed wire trains the same on the store (tables cast by the
    wire at build) and on the C++ loader (each batch cast, int8 quantized
    on assembly)."""
    root, flags, _ = trained
    losses = []
    for extra in ([], ["--device_features", "off"]):
        out = os.path.join(os.path.dirname(root), f"{wire}{len(extra)}")
        mc_train.main(flags + extra + ["--transfer_dtype", wire, "--output",
                                       out, "--epochs", "1"])
        text = open(os.path.join(out, "log.txt")).read()
        assert ("device feature store: " in text) == (not extra)
        losses.append(re.findall(r"(train_loss: \S+, .*|eval score: .*)",
                                 text))
    assert losses[0] == losses[1] and len(losses[0]) == 2


def test_mc_test_with_the_store_on_and_off(trained, capsys):
    root, flags, runs = trained
    acc = [mc_test.main(flags + ["--split", split, "--input", runs["store"][2],
                                 "--epoch", "1", "--device_features", flag])
           for split in ("val", "test") for flag in ("on", "off")]
    assert acc[0] == acc[1] and acc[2] == acc[3]
    out = capsys.readouterr().out
    assert f"val accuracy: {100 * acc[0]:.2f}" in out
    assert f"test accuracy: {100 * acc[2]:.2f}" in out


def test_mc_train_on_the_grid_path(trained):
    root, flags, _ = trained
    out = os.path.join(os.path.dirname(root), "grid")
    state = mc_train.main(flags[:-4] + ["--max_boxes", "196", "--device",
                                        "cpu", "--use_feature", "grid",
                                        "--output", out, "--epochs", "1"])
    text = open(os.path.join(out, "log.txt")).read()
    assert "1177 box rows" in text  # 6 images x 196 cells and the sentinel
    assert np.isfinite(float(re.findall(r"train_loss: (\S+),", text)[0]))
    assert state.step == 4


def test_serve_cli_task_mc(trained):
    """``cli.serve --task mc`` on an ``mc_train`` checkpoint: ``/answer_mc``
    with ``mc_tokens`` (JSON and npz) and with ``mc_answers`` strings
    equals the session's scores and picks; ``/answer`` still serves."""
    root, _, runs = trained
    args = cli.build_parser().parse_args([
        "--dataroot", root, "--input", runs["store"][2], "--epoch", "1",
        "--model", "cti", "--task", "mc", "--v_dim", str(V_DIM), "--num_hid",
        "16", "--h_mm", "8", "--rank", "2", "--max_boxes", "12", "--port",
        "0", "--device", "cpu", "--micro_batch", "8"])
    session, server = cli.build_server(args)
    port = server.server_address[1]
    import threading
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        assert session.session.label2ans == LABELS
        d = Dictionary.load_from_file(os.path.join(root, "dictionary.pkl"))
        v, _, q, mc = questions(3, seed=11)
        mc = np.minimum(mc, d.ntoken)
        q = np.minimum(q, d.ntoken)
        want = session.session.mc_scores(v, None, q, mc)
        for npz in (False, True):
            payload = {"features": v, "question_tokens": q, "mc_tokens": mc}
            if not npz:
                payload = {k: x.tolist() for k, x in payload.items()}
            out = post(port, "/answer_mc", payload, npz)
            np.testing.assert_allclose(out["scores"], want, atol=TOL)
            assert out["picks"] == list(want.argmax(1)) and "answers" not in out
        cands = [["red", "blue", "two", "cat"]] * 3
        out = post(port, "/answer_mc", {"features": v.tolist(),
                                        "questions": ["what color is it?"] * 3,
                                        "mc_answers": cands})
        toks = np.asarray([[d.tokenize_padded(s, 6) for s in r] for r in cands])
        qs = np.asarray([d.tokenize_padded("what color is it?", 12)] * 3)
        want = session.session.mc_scores(v, None, qs, toks)
        np.testing.assert_allclose(out["scores"], want, atol=TOL)
        assert out["answers"] == [cands[i][j]
                                  for i, j in enumerate(want.argmax(1))]
        out = post(port, "/answer", {"features": v.tolist(),
                                     "question_tokens": q.tolist(),
                                     "answer_tokens": mc[:, 0].tolist()})
        assert set(out["answers"]) <= set(LABELS)
    finally:
        server.shutdown()
        server.server_close()
        session.close()
