"""HTTP serving front end over :class:`vqatpu_torch.serve.InferenceSession`
(``vqatpu/cli/serve.py``).

Endpoints:
- ``GET  /healthz``  -> {"status": "ok", "model": ...}
- ``POST /answer``   body: {"features": [[[f]]], "spatials": [[[s]]]?,
                            "question_tokens": [[q]] | "questions": [str],
                            "answer_tokens": [[a]]}
                     -> {"answers": [...], "latency_ms": ...}
- ``POST /logits``   same body -> raw logits

Both POST endpoints also take ``Content-Type: application/x-npz`` (``np.savez``
bytes with the same keys); an npz ``/logits`` request gets an npz response
(key ``logits``).  ``/answer_mc`` and the by-id endpoints answer 400, as the
JAX server does when it was not started for them; ``--feature_split`` and
``--micro_batch`` are refused (ROADMAP queue A items 3 and 7).

Run: ``python -m vqatpu_torch.cli.serve --input saved_models/cti --epoch 12
     --dataroot data_vqa --model cti --port 8399 --device cuda``
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

from vqatpu_torch.config import ModelConfig
from vqatpu_torch.data import Dictionary


def model_config_from_args(args, ntoken: int, num_ans: int) -> ModelConfig:
    return ModelConfig(
        ntoken=ntoken, v_dim=args.v_dim, num_ans_candidates=num_ans,
        model="san" if args.model == "stacked_attention" else args.model,
        num_hid=args.num_hid, op=args.op, gamma=args.gamma,
        activation=args.activation, dropout=args.dropout,
        num_layers=args.num_layers, h_mm=args.h_mm, h_out=args.h_out,
        rank=args.rank, k=args.k)


def build_session(args):
    from vqatpu_torch.serve import InferenceSession

    dictionary = Dictionary.load_from_file(
        os.path.join(args.dataroot, "dictionary.pkl"))
    with open(os.path.join(args.dataroot, "cache",
                           "trainval_label2ans.pkl"), "rb") as f:
        label2ans = pickle.load(f)
    cfg = model_config_from_args(args, dictionary.ntoken, len(label2ans))
    ckpt = os.path.join(args.input, f"model_epoch{args.epoch}.ckpt")
    wire = None if args.transfer_dtype == "float32" else args.transfer_dtype
    return InferenceSession.from_checkpoint(
        ckpt, cfg, label2ans, max_boxes=args.max_boxes, transfer_dtype=wire,
        compute_dtype=args.compute_dtype, device=args.device), dictionary


def make_handler(session, dictionary, model_name: str):
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
            if binary:
                with np.load(io.BytesIO(body), allow_pickle=False) as z:
                    v = np.asarray(z["features"], np.float32)
                    b = (np.asarray(z["spatials"], np.float32)
                         if "spatials" in z.files else None)
                    q = np.asarray(z["question_tokens"], np.int32)
                    a = (np.asarray(z["answer_tokens"], np.int32)
                         if "answer_tokens" in z.files else None)
                return v, b, q, a
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
            return v, b, q, a

        def do_POST(self):
            if self.path not in ("/answer", "/logits", "/answer_mc",
                                 "/answer_by_id", "/logits_by_id"):
                self._json(404, {"error": "unknown path"})
                return
            if self.path.endswith("_by_id"):
                self._json(400, {"error": "server not started with "
                                          "--feature_split"})
                return
            if self.path == "/answer_mc":
                self._json(400, {"error": "server not started with "
                                          "--task mc"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                binary = self.headers.get(
                    "Content-Type", "").startswith("application/x-npz")
                v, b, q, a = self._read_request(binary, self.rfile.read(length))
                t0 = time.perf_counter()
                if self.path == "/answer":
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
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    return _Server((host, port), make_handler(session, dictionary, model_name))


def serve_in_thread(session, dictionary, model_name: str, port: int,
                    host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Start the server on a daemon thread; ``port=0`` picks a free port
    (``server.server_address[1]``).  Stop it with ``server.shutdown()``."""
    server = make_server(session, dictionary, model_name, port, host)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataroot", type=str, default="data_vqa")
    p.add_argument("--input", type=str, default=None)
    p.add_argument("--epoch", type=str, default="12")
    p.add_argument("--port", type=int, default=8399)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to serve on; cpu runs the kernels' plain "
                        "PyTorch versions")
    p.add_argument("--model", type=str, default="cti",
                   choices=["ban", "san", "cti", "stacked_attention"])
    p.add_argument("--v_dim", type=int, default=2048)
    p.add_argument("--num_hid", type=int, default=1024)
    p.add_argument("--op", type=str, default="c")
    p.add_argument("--gamma", type=int, default=2, help="glimpse")
    p.add_argument("--activation", type=str, default="relu",
                   choices=["relu", "swish"])
    p.add_argument("--dropout", default=0.5, type=float)
    p.add_argument("--num_layers", default=1, type=int)
    p.add_argument("--rank", default=32, type=int)
    p.add_argument("--h_out", default=1, type=int)
    p.add_argument("--h_mm", default=512, type=int)
    p.add_argument("--k", default=1, type=int)
    p.add_argument("--max_boxes", default=50, type=int)
    p.add_argument("--kernel_backend", type=str, default="xla",
                   choices=["xla", "pallas"],
                   help="accepted for the JAX CLI's sake; the port has one "
                        "path, its CUDA kernels")
    p.add_argument("--transfer_dtype", type=str, default="float32",
                   choices=["float32", "float16", "bfloat16", "int8"])
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--feature_split", type=str, default=None,
                   help="by-id serving (not ported yet)")
    p.add_argument("--micro_batch", type=int, default=0,
                   help="request coalescing (not ported yet)")
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.feature_split:
        parser.error("--feature_split: by-id serving is not ported to "
                     "vqatpu_torch yet (ROADMAP queue A item 3)")
    if args.micro_batch > 0:
        parser.error("--micro_batch: the MicroBatcher is not ported to "
                     "vqatpu_torch yet (ROADMAP queue A item 3)")
    session, dictionary = build_session(args)
    server = make_server(session, dictionary, args.model, args.port, args.host)
    print(f"serving {args.model} on http://{args.host}:{args.port} "
          f"({session.device})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
