"""HTTP serving front end over :class:`vqatpu_torch.serve.InferenceSession`
(``vqatpu/cli/serve.py``).

Endpoints:
- ``GET  /healthz``  -> {"status": "ok", "model": ...}
- ``POST /answer``   body: {"features": [[[f]]], "spatials": [[[s]]]?,
                            "question_tokens": [[q]] | "questions": [str],
                            "answer_tokens": [[a]]?} (answer tokens for
                     CTI, spatials for BAN with ``--use_counter``)
                     -> {"answers": [...], "latency_ms": ...}
- ``POST /logits``   same body -> raw logits
- ``POST /answer_mc`` (``--task mc``, a Visual7W checkpoint): the same
                     body without answer tokens, with each question's
                     candidates as ``mc_tokens`` [N, C, 6] or
                     ``mc_answers`` [N][C] strings (tokenized to 6)
                     -> {"scores": [N][C] match probabilities, "picks":
                     [N], "answers": the picked strings with
                     ``mc_answers``, "latency_ms"}
- ``POST /answer_by_id`` / ``/logits_by_id`` (``--feature_split``): body
                     {"image_ids": [N], "question_tokens" | "questions",
                     "answer_tokens"}; the features stay with the server
                     (on the card by default), so a request carries no
                     feature payload

``/answer`` and ``/logits`` also take ``Content-Type: application/x-npz``
(``np.savez`` bytes with the same keys); an npz ``/logits`` request gets an
npz response (key ``logits``).  ``--transfer_dtype`` narrows the feature
copy to the card, ``--compute_dtype bfloat16`` runs the forward in bf16,
and ``--micro_batch N`` coalesces concurrent requests into forwards of up
to N rows.  ``/answer_mc`` answers 400 on a server not started with
``--task mc``, as the JAX server does; the by-id endpoints answer 400
without ``--feature_split``.

The flags are the train and test CLIs' (``--model`` defaults to ``ban``, as
in JAX) with serving's own; the weights come from ``{--input}/model_epoch
{--epoch}.ckpt``, else ``.orbax`` (JAX's orbax directory), else the
reference's ``.pth``.  CTI's
``--v_block_size``, ``--remat`` and ``--fused_v_tucker`` select its
blockwise, rematerialized and fused forwards.

Run: ``python -m vqatpu_torch.cli.serve --input saved_models/cti --epoch 12
     --dataroot data_vqa --model cti --port 8399 --device cuda
     [--feature_split val --micro_batch 32]`` (``--model ban --use_counter``,
     ``--model san``: the flags of the checkpoint's training run; ``--task
     mc --dataroot data_v7w`` for an ``mc_train`` checkpoint).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import pickle
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from vqatpu_torch.cli.common import (add_common_args, model_config_of,
                                     validate_args)
from vqatpu_torch.data import Dictionary
from vqatpu_torch.data.mc_dataset import MC_ANS_LEN


def build_session(args):
    from vqatpu_torch.models import build_model
    from vqatpu_torch.serve import InferenceSession
    from vqatpu_torch.train.checkpoints import load_params_any
    from vqatpu_torch.weights import load_jax_params

    dictionary = Dictionary.load_from_file(
        os.path.join(args.dataroot, "dictionary.pkl"))
    if args.task == "mc":
        # the 2-class match / non-match head: the candidates come with each
        # request, there is no answer vocabulary (vqatpu/cli/serve.py:57-60)
        label2ans = ["match", "nonmatch"]
    else:
        with open(os.path.join(args.dataroot, "cache",
                               "trainval_label2ans.pkl"), "rb") as f:
            label2ans = pickle.load(f)
    model = build_model(model_config_of(args, dictionary.ntoken, args.v_dim,
                                        len(label2ans), task=args.task))
    load_jax_params(model, load_params_any(args.input, args.epoch, model))
    wire = None if args.transfer_dtype == "float32" else args.transfer_dtype
    return InferenceSession(
        model, label2ans, max_boxes=args.max_boxes, transfer_dtype=wire,
        compute_dtype=args.compute_dtype, device=args.device), dictionary


def make_handler(session, dictionary, model_name: str, task: str = "ffoe"):
    """``session`` is an InferenceSession or a MicroBatcher over one (the
    same answer/logits surface); ``task="mc"`` enables ``/answer_mc``."""
    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _npz(self, arrays: dict):
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            body = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "application/x-npz")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "model": model_name})
            else:
                self._json(404, {"error": "unknown path"})

        def _read_request(self, binary: bool, body: bytes):
            """-> (v, b, q, a, the request: its npz arrays or JSON)."""
            if binary:
                with np.load(io.BytesIO(body), allow_pickle=False) as z:
                    req = {k: z[k] for k in z.files}
                v = np.asarray(req["features"], np.float32)
                b = (np.asarray(req["spatials"], np.float32)
                     if "spatials" in req else None)
                q = np.asarray(req["question_tokens"], np.int32)
                a = (np.asarray(req["answer_tokens"], np.int32)
                     if "answer_tokens" in req else None)
                return v, b, q, a, req
            req = json.loads(body)
            v = np.asarray(req["features"], np.float32)
            b = req.get("spatials")
            b = None if b is None else np.asarray(b, np.float32)
            if "question_tokens" in req:
                q = np.asarray(req["question_tokens"], np.int32)
            else:
                q = np.asarray([dictionary.tokenize_padded(s, 12)
                                for s in req["questions"]], np.int32)
            a = req.get("answer_tokens")
            a = None if a is None else np.asarray(a, np.int32)
            return v, b, q, a, req

        def _answer_mc(self, v, b, q, req) -> dict:
            """The candidates as ``mc_tokens`` [N, C, 6] (JSON or npz) or
            ``mc_answers`` [N][C] strings, tokenized here (answers are 6
            tokens, ``MC/dataset.py``)."""
            cands = None
            if "mc_tokens" in req:
                mc = np.asarray(req["mc_tokens"], np.int32)
            else:
                cands = req["mc_answers"]
                mc = np.asarray(
                    [[dictionary.tokenize_padded(s, MC_ANS_LEN) for s in row]
                     for row in cands], np.int32)
            scores = session.mc_scores(v, b, q, mc)
            pick = scores.argmax(1)
            out = {"scores": scores.tolist(), "picks": pick.tolist()}
            if cands is not None:
                out["answers"] = [cands[i][j] for i, j in enumerate(pick)]
            return out

        def _by_id(self):
            """``/answer_by_id`` and ``/logits_by_id``: image ids and tokens,
            no features (``vqatpu/cli/serve.py:113-138``)."""
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length))
                ids = req["image_ids"]
                if "question_tokens" in req:
                    q = np.asarray(req["question_tokens"], np.int32)
                else:
                    q = np.asarray([dictionary.tokenize_padded(s, 12)
                                    for s in req["questions"]], np.int32)
                a = req.get("answer_tokens")
                a = None if a is None else np.asarray(a, np.int32)
                t0 = time.perf_counter()
                if self.path == "/answer_by_id":
                    out = {"answers": session.answer_by_id(ids, q, a)}
                else:
                    out = {"logits": session.logits_by_id(ids, q, a).tolist()}
                out["latency_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
                self._json(200, out)
            except Exception as e:  # surface errors as JSON, keep serving
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

        def do_POST(self):
            if self.path not in ("/answer", "/logits", "/answer_mc",
                                 "/answer_by_id", "/logits_by_id"):
                self._json(404, {"error": "unknown path"})
                return
            if self.path.endswith("_by_id"):
                if getattr(session, "features", None) is None:
                    self._json(400, {"error": "server not started with "
                                              "--feature_split"})
                    return
                self._by_id()
                return
            if self.path == "/answer_mc" and task != "mc":
                # against a free-form checkpoint the class-0 softmax over
                # the answer vocabulary would mean nothing
                self._json(400, {"error": "server not started with "
                                          "--task mc"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                binary = self.headers.get(
                    "Content-Type", "").startswith("application/x-npz")
                v, b, q, a, req = self._read_request(
                    binary, self.rfile.read(length))
                t0 = time.perf_counter()
                if self.path == "/answer_mc":
                    out = self._answer_mc(v, b, q, req)
                elif self.path == "/answer":
                    out = {"answers": session.answer(v, b, q, a)}
                elif binary:
                    self._npz({"logits": session.logits(v, b, q, a)})
                    return
                else:
                    out = {"logits": session.logits(v, b, q, a).tolist()}
                out["latency_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
                self._json(200, out)
            except Exception as e:  # surface errors as JSON, keep serving
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class _Server(ThreadingHTTPServer):
    # the default listen backlog (5) resets connections under a burst
    request_queue_size = 128


def make_server(session, dictionary, model_name: str, port: int,
                host: str = "127.0.0.1",
                task: str = "ffoe") -> ThreadingHTTPServer:
    return _Server((host, port),
                   make_handler(session, dictionary, model_name, task))


def serve_in_thread(session, dictionary, model_name: str, port: int,
                    host: str = "127.0.0.1",
                    task: str = "ffoe") -> ThreadingHTTPServer:
    """Start the server on a daemon thread; ``port=0`` picks a free port
    (``server.server_address[1]``).  Stop it with ``server.shutdown()``."""
    server = make_server(session, dictionary, model_name, port, host, task)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def build_parser() -> argparse.ArgumentParser:
    """The flags of the train and test CLIs (:func:`~vqatpu_torch.cli.
    common.add_common_args`: the model's, ``--device``, the wire and
    compute dtypes, CTI's ``--v_block_size``, ``--remat`` and
    ``--fused_v_tucker``) and serving's own, as JAX's serve parser
    (``vqatpu/cli/serve.py:262-306``)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_common_args(p)
    p.add_argument("--epoch", type=str, default="12")
    p.add_argument("--port", type=int, default=8399)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--v_dim", type=int, default=2048)
    p.add_argument("--task", type=str, default="ffoe", choices=("ffoe", "mc"),
                   help="mc serves a Visual7W 2-class checkpoint: POST "
                        "/answer_mc with each question's candidates")
    p.add_argument("--feature_split", type=str, default=None,
                   help="serve POST /answer_by_id and /logits_by_id from a "
                        "server-resident feature store: the split "
                        "({split}_imgid2idx.pkl with {split}.npz, or "
                        "{split}.hdf5 where h5py is installed, under "
                        "--dataroot) whose images requests name by id")
    p.add_argument("--feature_placement", type=str, default="device",
                   choices=("device", "host"),
                   help="device: the store's box rows live on the card "
                        "(int8 with their scales unless --feature_f32) and "
                        "each request's boxes are gathered there; host: "
                        "gathered on the host and copied per request")
    p.add_argument("--feature_f32", action="store_true", default=False,
                   help="keep card-resident features float32 (4x the memory "
                        "of int8; the upload path's logits exactly)")
    p.add_argument("--micro_batch", type=int, default=0,
                   help="coalesce concurrent requests into one forward of up "
                        "to this many rows (0: off); adds at most "
                        "--micro_batch_wait_ms of latency")
    p.add_argument("--micro_batch_wait_ms", type=float, default=3.0,
                   help="the longest wait after the first queued request "
                        "before the coalesced forward runs")
    return p


def build_server(args):
    """The session of ``args``, with its features attached and behind a
    MicroBatcher as the flags ask, and its HTTP server (not started)."""
    from vqatpu_torch.serve import MicroBatcher, ResidentFeatures

    session, dictionary = build_session(args)
    if args.feature_split:
        rf = ResidentFeatures.from_dataroot(
            args.dataroot, args.feature_split, max_boxes=args.max_boxes,
            quantize=args.quantize_store)
        session.attach_features(rf, placement=args.feature_placement,
                                quantize=not args.feature_f32)
        print(f"by-id serving: {args.feature_split} features "
              f"({len(rf.img_id2idx)} images) resident on "
              f"{args.feature_placement}")
    if args.micro_batch > 0:
        session = MicroBatcher(session, max_batch=args.micro_batch,
                               max_wait_ms=args.micro_batch_wait_ms)
    return session, make_server(session, dictionary, args.model, args.port,
                                args.host, args.task)


def main(argv=None):
    args = build_parser().parse_args(argv)
    validate_args(args)
    session, server = build_server(args)
    print(f"serving {args.model} on http://{args.host}:{args.port} "
          f"({args.device})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()
        if hasattr(session, "close"):
            session.close()


if __name__ == "__main__":
    main()
