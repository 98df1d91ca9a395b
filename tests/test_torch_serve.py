"""vqatpu_torch serving against vqatpu's on the CPU at small width: the
InferenceSession (bucketing, chunking, padding invariance, the empty
request), the HTTP front end (JSON and npz wires, the refused endpoints)
and checkpoints written by vqatpu's trainer."""

import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from vqatpu.cli import serve as jax_cli
from vqatpu.config import ModelConfig as JaxModelConfig
from vqatpu.data.dictionary import Dictionary as JaxDictionary
from vqatpu.data.synthetic import ANSWERS, make_vqa_fixture
from vqatpu.models import build_model as jax_build_model
from vqatpu.serve import InferenceSession as JaxSession
from vqatpu.train.checkpoints import save_checkpoint, save_params
from vqatpu.train.steps import make_train_state
from vqatpu_torch.cli import serve as cli
from vqatpu_torch.config import ModelConfig
from vqatpu_torch.data import Dictionary
from vqatpu_torch.serve import InferenceSession
from vqatpu_torch.weights import load_params_file

NTOKEN, V_DIM, NUM_ANS = 30, 16, 7
ANS = [f"ans{i}" for i in range(NUM_ANS)]
CFG = dict(ntoken=NTOKEN, v_dim=V_DIM, num_ans_candidates=NUM_ANS,
           model="cti", num_hid=16, h_mm=8, rank=2, gamma=2)  # test_serve.py
SESSION = dict(batch_buckets=(2, 4, 8), max_boxes=10)
WORDS = "what color is the cat dog red blue"


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A model_epoch0.ckpt as vqatpu's trainer writes it: params and the
    optimizer state (optax and vqatpu NamedTuples)."""
    path = tmp_path_factory.mktemp("torch_serve") / "model_epoch0.ckpt"
    state = make_train_state(jax_build_model(JaxModelConfig(**CFG)),
                             jax.random.PRNGKey(0))
    save_checkpoint(str(path), state, epoch=0)
    return str(path)


@pytest.fixture(scope="module")
def sessions(ckpt):
    port = InferenceSession.from_checkpoint(ckpt, ModelConfig(**CFG), ANS,
                                            device="cpu", **SESSION)
    ref = JaxSession.from_checkpoint(ckpt, JaxModelConfig(**CFG), ANS,
                                     **SESSION)
    return port, ref


def reqs(rng, n, boxes=6):
    v = rng.randn(n, boxes, V_DIM).astype(np.float32)
    v[:, boxes - 1] = 0.0  # one padded box per request
    b = rng.rand(n, boxes, 6).astype(np.float32)
    q = rng.randint(0, NTOKEN + 1, (n, 12))
    a = rng.randint(0, NTOKEN + 1, (n, 3))
    return v, b, q, a


@pytest.mark.parametrize("n", [1, 3, 8, 19])
def test_session_matches_jax(sessions, rng, n):
    """19 rows are chunked beyond the largest bucket (8, 8, then 3 in
    bucket 4)."""
    port, ref = sessions
    v, b, q, a = reqs(rng, n)
    got = port.logits(v, b, q, a)
    assert got.shape == (n, NUM_ANS) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref.logits(v, b, q, a), atol=1e-5)
    assert port.answer(v, b, q, a) == ref.answer(v, b, q, a)


def test_bucketing_and_chunking(ckpt, rng):
    sess = InferenceSession.from_checkpoint(ckpt, ModelConfig(**CFG), ANS,
                                            device="cpu", **SESSION)
    v, b, q, a = reqs(rng, 19)
    sess.logits(v[:3], b[:3], q[:3], a[:3])
    assert sess.bucket_calls == {4: 1}
    sess.logits(v[:1], b[:1], q[:1], a[:1])
    assert sess.bucket_calls == {2: 1, 4: 1}
    sess.logits(v, b, q, a)
    assert sess.bucket_calls == {2: 1, 4: 2, 8: 2}
    assert sess.forwards == 5


def test_padding_invariance(sessions, rng):
    """Padded rows and padded boxes do not change the real rows' logits."""
    port, _ = sessions
    v, b, q, a = reqs(rng, 4)
    full = port.logits(v, b, q, a)
    np.testing.assert_allclose(port.logits(v[:3], b[:3], q[:3], a[:3]),
                               full[:3], atol=1e-5)
    v_pad = np.concatenate([v, np.zeros((4, 3, V_DIM), np.float32)], 1)
    np.testing.assert_allclose(port.logits(v_pad, b, q, a), full, atol=1e-5)


def test_empty_and_oversized_requests(sessions, rng):
    port, ref = sessions
    v, b, q, a = reqs(rng, 3)
    out = port.logits(v[:0], b[:0], q[:0], a[:0])
    assert out.shape == (0, NUM_ANS) and out.dtype == np.float32
    v_big = np.concatenate([v, rng.randn(3, 8, V_DIM).astype(np.float32)], 1)
    got = port.logits(v_big, None, q, a)  # 14 boxes > max_boxes=10
    np.testing.assert_allclose(got, port.logits(v_big[:, :10], None, q, a),
                               atol=1e-6)
    np.testing.assert_allclose(got, ref.logits(v_big, None, q, a), atol=1e-5)


def test_session_refuses_what_is_not_ported(sessions, rng):
    port, _ = sessions
    with pytest.raises(NotImplementedError, match="float32 wire"):
        InferenceSession(port.model, ANS, transfer_dtype=np.float16,
                         device="cpu")
    with pytest.raises(NotImplementedError, match="float32 compute"):
        InferenceSession(port.model, ANS, compute_dtype="bfloat16",
                         device="cpu")
    v, b, q, _ = reqs(rng, 1)
    with pytest.raises(ValueError, match="answer tokens"):
        port.logits(v, b, q)


def test_session_enforces_f32_math(sessions, rng):
    port, _ = sessions
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    v, b, q, a = reqs(rng, 1)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            port.logits(v, b, q, a)
    finally:
        torch.backends.cudnn.allow_tf32 = False


def test_save_params_file_loads(ckpt, tmp_path):
    """Both vqatpu weight files read into the same tree, without JAX's
    classes: a checkpoint's optimizer state is read as inert placeholders."""
    from_ckpt = load_params_file(ckpt)
    path = str(tmp_path / "params.pkl")
    save_params(path, from_ckpt)
    from_params = load_params_file(path)
    assert jax.tree.structure(from_params) == jax.tree.structure(from_ckpt)
    for x, y in zip(jax.tree.leaves(from_params), jax.tree.leaves(from_ckpt)):
        np.testing.assert_array_equal(x, y)


# -- HTTP ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def servers(sessions):
    """The port's server and vqatpu's, on the same checkpoint."""
    d_port, d_ref = Dictionary(), JaxDictionary()
    d_port.tokenize(WORDS, add_word=True)
    d_ref.tokenize(WORDS, add_word=True)
    port = cli.serve_in_thread(sessions[0], d_port, "cti", 0)
    ref = jax_cli.serve_in_thread(sessions[1], d_ref, "cti", 0)
    yield port.server_address[1], ref.server_address[1]
    for srv in (port, ref):
        srv.shutdown()
        srv.server_close()


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
        body = r.read()
        if r.headers.get("Content-Type") == "application/x-npz":
            with np.load(io.BytesIO(body)) as z:
                return {"logits": z["logits"]}
        return json.loads(body)


def post_error(port, path, payload):
    with pytest.raises(urllib.error.HTTPError) as ei:
        post(port, path, payload)
    return ei.value.code, json.loads(ei.value.read())["error"]


def test_healthz(servers):
    for port in servers:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            assert json.loads(r.read()) == {"status": "ok", "model": "cti"}


@pytest.mark.parametrize("npz", [False, True])
def test_http_matches_jax_server(servers, rng, npz):
    v, _, q, a = reqs(rng, 5)
    arrays = {"features": v, "question_tokens": q, "answer_tokens": a}
    payload = arrays if npz else {k: x.tolist() for k, x in arrays.items()}
    port, ref = servers
    got = np.asarray(post(port, "/logits", payload, npz)["logits"])
    want = np.asarray(post(ref, "/logits", payload, npz)["logits"])
    assert got.shape == (5, NUM_ANS)
    np.testing.assert_allclose(got, want, atol=1e-5)
    out = post(port, "/answer", payload, npz)
    assert out["answers"] == post(ref, "/answer", payload, npz)["answers"]
    assert out["answers"] == [ANS[i] for i in got.argmax(1)]
    assert out["latency_ms"] >= 0


def test_http_tokenizes_question_strings(servers, rng):
    v, _, _, a = reqs(rng, 2)
    payload = {"features": v.tolist(), "answer_tokens": a.tolist(),
               "questions": ["What color is the cat?", "the dog's color"]}
    answers = [post(p, "/answer", payload)["answers"] for p in servers]
    assert answers[0] == answers[1] and len(answers[0]) == 2


@pytest.mark.parametrize("path,needs", [("/answer_mc", "--task mc"),
                                        ("/answer_by_id", "--feature_split"),
                                        ("/logits_by_id", "--feature_split")])
def test_http_refuses_what_the_server_was_not_started_for(servers, path,
                                                          needs):
    payload = {"image_ids": [1], "question_tokens": [[0] * 12],
               "features": [[[0.0] * V_DIM]], "mc_answers": [["red"]]}
    for port in servers:
        code, error = post_error(port, path, payload)
        assert code == 400 and needs in error


def test_http_malformed_request_is_400(servers, rng):
    for port in servers:
        code, error = post_error(port, "/answer", {"features": "not an array"})
        assert code == 400 and error
    code, _ = post_error(servers[0], "/nowhere", {})
    assert code == 404
    test_healthz(servers)


def test_build_session_and_cli_flags(ckpt, tmp_path, rng):
    """The CLI's path from a dataroot and a checkpoint to a session, and the
    flags of what is not ported."""
    root = str(tmp_path / "data_vqa")
    dictionary = make_vqa_fixture(root, n_train=8, n_val=4, n_images=4,
                                  v_dim=V_DIM)
    cfg = JaxModelConfig(**dict(CFG, ntoken=dictionary.ntoken,
                                num_ans_candidates=len(ANSWERS)))
    state = make_train_state(jax_build_model(cfg), jax.random.PRNGKey(1))
    save_checkpoint(str(tmp_path / "sm" / "model_epoch3.ckpt"), state, 3)
    args = cli.build_parser().parse_args([
        "--dataroot", root, "--input", str(tmp_path / "sm"), "--epoch", "3",
        "--v_dim", str(V_DIM), "--num_hid", "16", "--h_mm", "8",
        "--rank", "2", "--max_boxes", "12", "--device", "cpu"])
    sess, d = cli.build_session(args)
    assert sess.device == torch.device("cpu")
    v = rng.randn(2, 8, V_DIM).astype(np.float32)
    q = np.asarray([d.tokenize_padded("what color is the cat?", 12)] * 2)
    a = rng.randint(0, dictionary.ntoken, (2, 3))
    answers = sess.answer(v, None, q, a)
    assert len(answers) == 2 and all(x in sess.label2ans for x in answers)

    for flags in (["--feature_split", "val"], ["--micro_batch", "8"]):
        with pytest.raises(SystemExit) as e:
            cli.main(["--device", "cpu", *flags])
        assert e.value.code == 2
    args.transfer_dtype = "int8"
    with pytest.raises(NotImplementedError):
        cli.build_session(args)
