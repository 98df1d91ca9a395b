"""vqatpu_torch serving against vqatpu's on the CPU at small width: the
InferenceSession (bucketing, chunking, padding invariance, the empty
request, bf16 compute, the float16/bfloat16/int8 wires), the feature store
and by-id serving, the MicroBatcher, the HTTP front end (JSON and npz
wires, the by-id endpoints, the serving flags, the refused endpoints) and
checkpoints written by vqatpu's trainer.

Tolerances: 1e-5 on logits with float32 compute, on every wire (the host
arrays are bit-identical, the rest is the float32 contract); bf16 compute is
held by the budget of ``tests/test_torch_model.py`` against JAX's Pallas
backend.  By-id serving on the CPU equals the upload path exactly.
"""

import io
import json
import os
import pickle
import threading
import urllib.error
import urllib.request

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vqatpu.cli import serve as jax_cli
from vqatpu.config import ModelConfig as JaxModelConfig
from vqatpu.data import device_store as jax_device_store
from vqatpu.data.dictionary import Dictionary as JaxDictionary
from vqatpu.data.features import FeatureStore as JaxFeatureStore
from vqatpu.data.native import quantize_rows_any
from vqatpu.data.synthetic import ANSWERS, make_vqa_fixture
from vqatpu.models import build_model as jax_build_model
from vqatpu.serve import InferenceSession as JaxSession
from vqatpu.serve import ResidentFeatures as JaxResidentFeatures
from vqatpu.train.checkpoints import save_checkpoint, save_params
from vqatpu.train.steps import make_train_state
from vqatpu_torch.cli import serve as cli
from vqatpu_torch.config import ModelConfig
from vqatpu_torch.data import Dictionary
from vqatpu_torch.data import device_store
from vqatpu_torch.data import features as features_mod
from vqatpu_torch.data.features import FeatureStore
from vqatpu_torch.data.quantize import quantize_rows
from vqatpu_torch.serve import InferenceSession, MicroBatcher, ResidentFeatures
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
    """Unknown wires and compute dtypes raise, and so does a CTI request
    without answer tokens; MC scoring runs (``tests/test_torch_mc_serve.py``
    holds it to JAX's)."""
    port, ref = sessions
    v, b, q, a = reqs(rng, 1)
    np.testing.assert_allclose(port.mc_scores(v, b, q, a[:, None]),
                               ref.mc_scores(v, b, q, a[:, None]), atol=1e-6)
    assert port.answer_mc(v, b, q, a[:, None]) == [0]
    with pytest.raises(ValueError, match="transfer_dtype"):
        InferenceSession(port.model, ANS, transfer_dtype="int4", device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        InferenceSession(port.model, ANS, compute_dtype="float16",
                         device="cpu")
    with pytest.raises(ValueError, match="answer tokens"):
        port.logits(v, b, q)


def test_answer_by_embedding(sessions, rng):
    """Embedding-distance decoding (``vqatpu/serve.py:426-434``): the row of
    ``ans_emb`` nearest each output wins, as on JAX's session."""
    port, ref = sessions
    v, b, q, a = reqs(rng, 2)
    logits = port.logits(v, b, q, a)
    ans_emb = rng.randn(NUM_ANS, NUM_ANS).astype(np.float32) * 10
    ans_emb[3], ans_emb[5] = logits[0], logits[1]
    got = port.answer_by_embedding(v, b, q, ans_emb, a)
    assert got == [ANS[3], ANS[5]]
    assert got == ref.answer_by_embedding(v, b, q, ans_emb, a)


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


def test_session_keeps_bf16_gemms_accumulating_in_f32(sessions, rng):
    """cuBLAS may reduce bf16 split-K sums in bf16 unless told not to; the
    session turns that off and refuses to run if it is turned back on."""
    port, _ = sessions
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    v, b, q, a = reqs(rng, 1)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    try:
        with pytest.raises(RuntimeError, match="reduced-precision"):
            port.logits(v, b, q, a)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


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
    """The CLI's path from a dataroot and a checkpoint to a session, with
    each wire and compute dtype."""
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

    for wire, compute in (("int8", "float32"), ("float16", "bfloat16")):
        args.transfer_dtype, args.compute_dtype = wire, compute
        sess2, _ = cli.build_session(args)
        assert (sess2.transfer_dtype, sess2.compute_dtype) == (wire, compute)
        assert sess2.answer(v, None, q, a) and len(sess2.answer(v, None, q, a)) == 2
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", "--transfer_dtype", "int4"])
    assert e.value.code == 2


# -- bf16 compute and the wires ------------------------------------------------

def test_session_bf16_matches_jax_pallas_backend(ckpt, sessions, rng):
    """compute_dtype="bfloat16": float32 logits, within the budget of JAX's
    own bf16 error against its float32 logits, and within the direct bound
    of JAX's Pallas-backend bf16 session (the budget and bound of
    tests/test_torch_model.py)."""
    _, ref32 = sessions
    port = InferenceSession.from_checkpoint(
        ckpt, ModelConfig(**CFG), ANS, device="cpu", compute_dtype="bfloat16",
        **SESSION)
    ref16 = JaxSession.from_checkpoint(
        ckpt, JaxModelConfig(**CFG, kernel_backend="pallas"), ANS,
        compute_dtype="bfloat16", **SESSION)
    assert next(port.model.parameters()).dtype == torch.bfloat16
    v, b, q, a = reqs(rng, 11)
    got = port.logits(v, b, q, a)
    with pltpu.force_tpu_interpret_mode():
        want16 = ref16.logits(v, b, q, a)
    want32 = ref32.logits(v, b, q, a)
    assert got.dtype == np.float32 and got.shape == (11, NUM_ANS)
    own = np.abs(want16 - want32).max()
    assert np.abs(got - want32).max() <= 2.0 * own + 1e-4
    assert np.abs(got - want16).max() <= 1e-2 * np.abs(want32).max()


WIRES = {"float16": np.float16, "bfloat16": jnp.bfloat16, "int8": "int8"}


@pytest.mark.parametrize("wire", list(WIRES))
def test_wire_host_arrays_are_jax_bits(sessions, rng, wire):
    """The arrays a wire ships are JAX's bit for bit: int8 rows and scales
    against ``vqatpu.data.native.quantize_rows_any``, the float16 cast, and
    the bf16 cast against ml_dtypes' round to nearest even."""
    port, _ = sessions
    sess = InferenceSession(port.model, ANS, transfer_dtype=wire,
                            device="cpu", **SESSION)
    v, _, q, a = reqs(rng, 3)
    host, n = sess.pack(v, q, a)
    f32, _ = port.pack(v, q, a)
    vp = f32["v"]
    assert n == 3 and vp.shape == (4, 10, V_DIM)
    if wire == "int8":
        want_q, want_s = quantize_rows_any(vp)
        np.testing.assert_array_equal(host["v"], want_q)
        np.testing.assert_array_equal(host["v_scale"].view(np.uint32),
                                      want_s.view(np.uint32))
        assert host["v"].dtype == np.int8
    elif wire == "float16":
        np.testing.assert_array_equal(host["v"].view(np.uint16),
                                      vp.astype(np.float16).view(np.uint16))
    else:
        np.testing.assert_array_equal(
            host["v"].view(torch.int16).numpy().view(np.uint16),
            vp.astype(ml_dtypes.bfloat16).view(np.uint16))
    np.testing.assert_array_equal(host["v_mask"], f32["v_mask"])


@pytest.mark.parametrize("wire", list(WIRES))
def test_wire_logits_match_jax_session(ckpt, sessions, rng, wire):
    """float32 compute on each wire against JAX's session on the same wire
    (1e-5, the float32 contract); the wire really narrows the features."""
    port, ref32 = sessions
    sess = InferenceSession(port.model, ANS, transfer_dtype=wire,
                            device="cpu", **SESSION)
    ref = JaxSession.from_checkpoint(ckpt, JaxModelConfig(**CFG), ANS,
                                     transfer_dtype=WIRES[wire], **SESSION)
    v, b, q, a = reqs(rng, 11)
    got = sess.logits(v, b, q, a)
    np.testing.assert_allclose(got, ref.logits(v, b, q, a), atol=1e-5)
    assert not np.array_equal(got, port.logits(v, b, q, a))


def test_bf16_wire_rounds_like_ml_dtypes():
    """numpy has no bf16; the bf16 wire casts with torch, whose rounding
    to nearest even is ml_dtypes' (JAX's host cast), ties and subnormals
    included."""
    rs = np.random.RandomState(0)
    bits = np.concatenate([
        rs.randint(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32),
        np.array([0x3F808000, 0x3F818000, 0x3F80FFFF, 0x00008000, 0x00018000,
                  0x80000001, 0x7F7FFFFF, 0xFF7F8000], np.uint32)])
    x = bits.view(np.float32)
    x = x[np.isfinite(x)]
    got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(got.view(np.uint16),
                                  x.astype(ml_dtypes.bfloat16).view(np.uint16))


def test_quantize_rows_is_jax_bit_for_bit(rng):
    v = (rng.randn(5, 7, 33) * rng.rand(5, 7, 1) * 10).astype(np.float32)
    v[1, 2] = 0.0
    v[3, 4, :] = -2.5  # a row of ties
    q, s = quantize_rows(v)
    want_q, want_s = quantize_rows_any(v)
    np.testing.assert_array_equal(q, want_q)
    np.testing.assert_array_equal(s.view(np.uint32), want_s.view(np.uint32))
    assert s[1, 2] == 1.0 and (q[1, 2] == 0).all()
    np.testing.assert_array_equal(quantize_rows(q * s[..., None])[0], q)


# -- the feature store and by-id serving ---------------------------------------

@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    """The synthetic VQA fixture (hdf5 features), with the val split also
    written as .npz, and a fixed-layout split ``fx36``."""
    root = str(tmp_path_factory.mktemp("torch_byid") / "data_vqa")
    make_vqa_fixture(root, n_train=8, n_val=8, n_images=6, v_dim=V_DIM)
    import h5py
    with h5py.File(os.path.join(root, "val.hdf5"), "r") as hf:
        np.savez(os.path.join(root, "npzval.npz"),
                 **{k: np.asarray(hf[k]) for k in hf})
    with open(os.path.join(root, "val_imgid2idx.pkl"), "rb") as f:
        ids = pickle.load(f)
    with open(os.path.join(root, "npzval_imgid2idx.pkl"), "wb") as f:
        pickle.dump(ids, f)
    rs = np.random.RandomState(5)
    feats = rs.randn(4, 12, V_DIM).astype(np.float32)
    feats[2, 7:] = 0.0
    np.savez(os.path.join(root, "fx36.npz"), image_features=feats,
             spatial_features=rs.rand(4, 12, 6).astype(np.float32))
    with open(os.path.join(root, "fx36_imgid2idx.pkl"), "wb") as f:
        pickle.dump({70 + i: i for i in range(4)}, f)
    return root


@pytest.mark.parametrize("split", ["val", "npzval", "fx"])
@pytest.mark.parametrize("quantize", [False, True])
def test_store_and_device_tables_match_jax(dataroot, split, quantize):
    """FeatureStore (from .hdf5 and .npz, adaptive and fixed), its host
    gather and the card's tables (rows, scales, spatials, the row-index
    table and the sentinel) are JAX's bit for bit."""
    mine = ResidentFeatures.from_dataroot(dataroot, split, max_boxes=10,
                                          quantize=quantize)
    theirs = JaxResidentFeatures.from_dataroot(dataroot, split, max_boxes=10,
                                               quantize=quantize)
    assert mine.store.adaptive == theirs.store.adaptive == (split != "fx")
    assert mine.store.quantized == theirs.store.quantized == quantize
    assert (mine.store.v_dim, mine.store.s_dim) == (V_DIM, 6)
    ids = sorted(mine.img_id2idx)
    assert ids == sorted(theirs.img_id2idx)
    for x, y in zip(mine.gather(ids), theirs.gather(ids)):
        np.testing.assert_array_equal(x, y)
    for table_q in (False, True):
        got = mine.device_tables(quantize=table_q)
        want = theirs.device_tables(quantize=table_q)
        assert got[4] == want[4]
        for x, y in zip(got[:4], want[:4]):
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    store = mine.store
    np.testing.assert_array_equal(
        device_store.store_rows_table(store, 7, sentinel=-1),
        jax_device_store.store_rows_table(theirs.store, 7, row_offset=0,
                                          sentinel=-1))


def test_feature_store_quantize_and_get_match_jax(dataroot, monkeypatch):
    path = os.path.join(dataroot, "val.hdf5")
    mine = FeatureStore.from_hdf5(path)
    theirs = JaxFeatureStore.from_hdf5(path)
    for i in range(3):
        for x, y in zip(mine.quantize().get(i, 10),
                        theirs.quantize().get(i, 10)):
            np.testing.assert_array_equal(x, y)
    # quantized as read, 16 box rows at a time: the whole store's bits
    monkeypatch.setattr(features_mod, "QUANTIZE_CHUNK_BYTES", 64 * V_DIM)
    chunked = FeatureStore.from_hdf5(path, quantize=True)
    np.testing.assert_array_equal(chunked.features, mine.quantize().features)
    np.testing.assert_array_equal(chunked.feat_scales,
                                  mine.quantize().feat_scales)


def by_id_sessions(port_model, rf, placement, quantize, **kw):
    sess = InferenceSession(port_model, ANS, device="cpu", **SESSION, **kw)
    sess.attach_features(rf, placement=placement, quantize=quantize)
    return sess


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_logits_by_id_device_f32_equals_upload(sessions, dataroot, rng,
                                               compute_dtype):
    """float32 tables on the device: the on-device gather, the sentinel
    mask and the forward give the upload path's logits on the gathered
    features exactly (CPU), at either compute dtype; 13 requests run in
    two buckets."""
    port, _ = sessions
    rf = ResidentFeatures.from_dataroot(dataroot, "val", max_boxes=10)
    sess = by_id_sessions(port.model, rf, "device", False,
                          compute_dtype=compute_dtype)
    assert sess._tables[0].dtype == torch.float32 and sess._tables[1] is None
    ids = [sorted(rf.img_id2idx)[i % 6] for i in range(13)]
    q = rng.randint(0, NTOKEN + 1, (13, 12))
    a = rng.randint(0, NTOKEN + 1, (13, 3))
    got = sess.logits_by_id(ids, q, a)
    v, b = rf.gather(ids)
    np.testing.assert_array_equal(got, sess.logits(v, b, q, a))
    assert sess.answer_by_id(ids, q, a) == [ANS[i] for i in got.argmax(1)]


def test_logits_by_id_int8_equals_the_int8_wire_and_host_is_upload(
        sessions, dataroot, rng):
    """int8 tables give the int8 wire's logits exactly (quantization is
    idempotent, so the rows are the wire's); host placement is the upload
    path."""
    port, ref = sessions
    rf = ResidentFeatures.from_dataroot(dataroot, "val", max_boxes=10)
    sess = by_id_sessions(port.model, rf, "device", True)
    feats, scales, spats = sess._tables
    assert feats.dtype == torch.int8 and scales.dtype == torch.float32
    ids = sorted(rf.img_id2idx)
    q = rng.randint(0, NTOKEN + 1, (6, 12))
    a = rng.randint(0, NTOKEN + 1, (6, 3))
    got = sess.logits_by_id(ids, q, a)
    v, b = rf.gather(ids)
    wire8 = InferenceSession(port.model, ANS, transfer_dtype="int8",
                             device="cpu", **SESSION)
    np.testing.assert_array_equal(got, wire8.logits(v, b, q, a))
    jref = JaxSession(ref.model, ref.params, ANS, **SESSION)
    jref.attach_features(JaxResidentFeatures.from_dataroot(
        dataroot, "val", max_boxes=10), placement="device", quantize=True)
    np.testing.assert_allclose(got, jref.logits_by_id(ids, q, a), atol=1e-5)
    sess.attach_features(rf, placement="host")
    assert sess._tables is None
    np.testing.assert_array_equal(sess.logits_by_id(ids, q, a),
                                  port.logits(v, b, q, a))


def test_by_id_errors(sessions, dataroot, rng):
    port, _ = sessions
    rf = ResidentFeatures.from_dataroot(dataroot, "val", max_boxes=10)
    sess = InferenceSession(port.model, ANS, device="cpu", **SESSION)
    q = rng.randint(0, NTOKEN + 1, (1, 12))
    a = rng.randint(0, NTOKEN + 1, (1, 3))
    with pytest.raises(RuntimeError, match="attach_features"):
        sess.logits_by_id([1000], q, a)
    with pytest.raises(ValueError, match="boxes"):
        sess.attach_features(ResidentFeatures(rf.store, rf.img_id2idx, 7))
    with pytest.raises(ValueError, match="placement"):
        sess.attach_features(rf, placement="disk")
    sess.attach_features(rf)
    with pytest.raises(KeyError, match="unknown image_id"):
        sess.logits_by_id([999999], q, a)
    out = sess.logits_by_id([], q[:0], a[:0])
    assert out.shape == (0, NUM_ANS) and out.dtype == np.float32
    with pytest.raises(FileNotFoundError):
        ResidentFeatures.from_dataroot(dataroot, "test")


# -- MicroBatcher ----------------------------------------------------------------

def test_micro_batcher_coalesces_and_matches(sessions, rng):
    """Eight simultaneous single-row requests coalesce into few bucketed
    forwards, and each caller gets a direct call's logits."""
    port, _ = sessions
    mb = MicroBatcher(port, max_batch=8, max_wait_ms=100.0)
    try:
        v, b, q, a = reqs(rng, 8)
        want = port.logits(v, b, q, a)
        got = [None] * 8
        start = threading.Barrier(8)

        def call(i):
            start.wait()
            got[i] = mb.logits(v[i:i + 1], b[i:i + 1], q[i:i + 1], a[i:i + 1])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        for i in range(8):
            np.testing.assert_allclose(got[i][0], want[i], atol=1e-5)
        assert mb.rows_served == 8
        assert mb.batches_run <= 4, mb.batches_run
        assert mb.answer(v[:2], b[:2], q[:2], a[:2]) == port.answer(
            v[:2], b[:2], q[:2], a[:2])
    finally:
        mb.close()
    assert not mb._thread.is_alive()


def test_micro_batcher_groups_and_errors(sessions, rng):
    """Requests of other question widths run as their own group; a request
    that fails in the forward fails only its own caller."""
    port, _ = sessions
    mb = MicroBatcher(port, max_batch=8, max_wait_ms=100.0)
    try:
        v, b, q, a = reqs(rng, 4)
        q_short = q[2:4, :9]
        want_12 = port.logits(v[:2], b[:2], q[:2], a[:2])
        want_9 = port.logits(v[2:4], b[2:4], q_short, a[2:4])
        results = {}
        start = threading.Barrier(3)

        def wide():
            start.wait()
            results["w"] = mb.logits(v[:2], b[:2], q[:2], a[:2])

        def narrow():
            start.wait()
            results["n"] = mb.logits(v[2:4], b[2:4], q_short, a[2:4])

        def bad():
            start.wait()
            try:
                mb.logits(rng.randn(1, 6, V_DIM + 3).astype(np.float32),
                          b[:1], q[:1], a[:1])
                results["bad"] = "no error"
            except Exception as e:
                results["bad"] = type(e).__name__

        threads = [threading.Thread(target=f) for f in (wide, narrow, bad)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        np.testing.assert_allclose(results["w"], want_12, atol=1e-5)
        np.testing.assert_allclose(results["n"], want_9, atol=1e-5)
        assert results["bad"] != "no error"
    finally:
        mb.close()


def test_micro_batcher_survives_malformed_requests(sessions, rng):
    """A request that breaks group assembly (a 1-D q) fails only its own
    caller; the worker stays alive and serves what follows."""
    port, _ = sessions
    mb = MicroBatcher(port, max_batch=8, max_wait_ms=20.0)
    try:
        v, b, q, a = reqs(rng, 2)
        done = threading.Event()
        slot: dict = {}
        mb._q.put((v[:1], b[:1], q[0], a[:1], done, slot))
        assert done.wait(timeout=60), "the worker died without failing its caller"
        assert "err" in slot and mb._thread.is_alive()
        np.testing.assert_allclose(mb.logits(v, b, q, a),
                                   port.logits(v, b, q, a), atol=1e-5)
    finally:
        mb.close()


def test_micro_batcher_empty_oversized_and_by_id(sessions, dataroot, rng):
    """An empty request, boxes beyond max_boxes (cut as the direct path
    cuts them), by-id requests (which bypass coalescing) and MC scoring
    through the batcher."""
    port, _ = sessions
    rf = ResidentFeatures.from_dataroot(dataroot, "val", max_boxes=10)
    sess = by_id_sessions(port.model, rf, "device", True)
    mb = MicroBatcher(sess, max_batch=8, max_wait_ms=5.0)
    try:
        v, b, q, a = reqs(rng, 3)
        assert mb.logits(v[:0], b[:0], q[:0], a[:0]).shape == (0, NUM_ANS)
        v_big = np.concatenate([v, rng.randn(3, 8, V_DIM).astype(np.float32)], 1)
        np.testing.assert_allclose(mb.logits(v_big, None, q, a),
                                   sess.logits(v_big[:, :10], None, q, a),
                                   atol=1e-6)
        ids = sorted(rf.img_id2idx)[:3]
        runs = mb.batches_run
        np.testing.assert_array_equal(mb.logits_by_id(ids, q, a),
                                      sess.logits_by_id(ids, q, a))
        assert mb.answer_by_id(ids, q, a) == sess.answer_by_id(ids, q, a)
        assert mb.batches_run == runs and mb.features is rf
        np.testing.assert_allclose(mb.mc_scores(v, b, q, a[:, None]),
                                   sess.mc_scores(v, b, q, a[:, None]),
                                   atol=1e-6)
    finally:
        mb.close()


# -- the serving flags over HTTP -------------------------------------------------

def post_by_id(port, path, ids, q, a):
    return post(port, path, {"image_ids": list(ids), "question_tokens": q.tolist(),
                             "answer_tokens": a.tolist()})


@pytest.mark.parametrize("flags", [
    ["--micro_batch", "8", "--micro_batch_wait_ms", "20"],
    ["--feature_f32"], ["--feature_placement", "host", "--quantize_store"],
    ["--transfer_dtype", "int8", "--compute_dtype", "bfloat16"]],
    ids=["micro_batch", "feature_f32", "host_quantized", "int8_bf16"])
def test_cli_serving_flags_over_http(dataroot, tmp_path, rng, flags):
    """The CLI with ``--feature_split val`` and each further flag: by-id
    requests against JAX's by-id session on the same checkpoint and store
    (1e-5 with float32 compute; the bf16 budget of JAX's own error
    otherwise), upload requests against by-id ones, and errors as 400."""
    d = JaxDictionary.load_from_file(os.path.join(dataroot, "dictionary.pkl"))
    cfg = dict(CFG, ntoken=d.ntoken, num_ans_candidates=len(ANSWERS))
    state = make_train_state(jax_build_model(JaxModelConfig(**cfg)),
                             jax.random.PRNGKey(2))
    save_checkpoint(str(tmp_path / "sm" / "model_epoch1.ckpt"), state, 1)
    args = cli.build_parser().parse_args([
        "--dataroot", dataroot, "--input", str(tmp_path / "sm"), "--epoch",
        "1", "--v_dim", str(V_DIM), "--num_hid", "16", "--h_mm", "8",
        "--rank", "2", "--max_boxes", "10", "--device", "cpu", "--port", "0",
        "--feature_split", "val", *flags])
    session, server = cli.build_server(args)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    f32_tables = "--feature_f32" in flags
    bf16 = "bfloat16" in flags

    def jax_by_id(compute_dtype, backend):
        sess = JaxSession(jax_build_model(JaxModelConfig(
            **cfg, kernel_backend=backend)), state.params, list(ANSWERS),
            max_boxes=10, compute_dtype=compute_dtype)
        sess.attach_features(JaxResidentFeatures.from_dataroot(
            dataroot, "val", max_boxes=10), quantize=not f32_tables)
        with pltpu.force_tpu_interpret_mode():
            return sess.logits_by_id(ids, q, a)
    try:
        assert isinstance(session, MicroBatcher) == ("--micro_batch" in flags)
        rf = session.features
        ids = sorted(rf.img_id2idx)[:5]
        q = rng.randint(0, d.ntoken, (5, 12))
        a = rng.randint(0, d.ntoken, (5, 3))
        got = np.asarray(post_by_id(port, "/logits_by_id", ids, q, a)["logits"])
        want = jax_by_id("float32", "xla")
        if bf16:
            want16 = jax_by_id("bfloat16", "pallas")
            own = np.abs(want16 - want).max()
            assert np.abs(got - want).max() <= 2.0 * own + 1e-4
            assert np.abs(got - want16).max() <= 1e-2 * np.abs(want).max()
        else:
            np.testing.assert_allclose(got, want, atol=1e-5)
        out = post_by_id(port, "/answer_by_id", ids, q, a)
        assert out["answers"] == [ANSWERS[i] for i in got.argmax(1)]
        assert out["latency_ms"] >= 0
        v, _ = rf.gather(ids)
        up = np.asarray(post(port, "/logits", {
            "features": v, "question_tokens": q, "answer_tokens": a},
            npz=True)["logits"])
        if f32_tables or "host" in flags or "int8" in flags:
            # the same rows on both paths: float32, host-gathered, or the
            # int8 wire's (quantization is idempotent)
            np.testing.assert_array_equal(up, got)
        code, err = post_error(port, "/logits_by_id", {
            "image_ids": [12345], "question_tokens": q[:1].tolist(),
            "answer_tokens": a[:1].tolist()})
        assert code == 400 and "unknown image_id" in err
        code, err = post_error(port, "/answer_mc", {"features": [[[0.0]]]})
        assert code == 400 and "--task mc" in err
    finally:
        server.shutdown()
        server.server_close()
        if isinstance(session, MicroBatcher):
            session.close()
