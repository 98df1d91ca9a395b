#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``vqatpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, none of
them caught, so any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build the CUDA kernels from ``vqatpu_torch/kernels/csrc`` (``nvcc``);
3. hold each kernel against its plain PyTorch version on the card, at the
   inputs the full-width CTI model gives it at batch 1 and 128 (V=50, 44
   real boxes, the last row fully masked), and on ragged large-V inputs;
4. time each kernel, its plain version and one PyTorch yardstick with CUDA
   events (median of 30 runs, L2 flushed before each), beside the card's
   bound for the same work;
5. serve the full-width CTI model (bench.py's config, seeded weights) over
   HTTP on the card: JSON and npz ``/answer`` and ``/logits`` requests of
   1, 5 and 40 rows; check the answers against the logits, the logits
   against the CPU path and against the JAX golden
   ``tests/data/torch_cti_golden.npz``, and that every forward launched
   each kernel (once for the attention, once per glimpse for the pool);
6. time each serving bucket end to end (``session.logits``, host clock) and
   on the card (feature upload, forward), and the kernels' share of it.

Prints the kernels' JSON line and, last, ``{"ok": true, "device": ...}``.
Without CUDA, or outside the repository, it exits non-zero with no result.
"""

from __future__ import annotations

import io
import json
import statistics
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# full width of bench.py:50-52 and the serving shapes of data/datasets.py
CFG = dict(ntoken=20000, v_dim=2048, num_ans_candidates=3129, model="cti",
           num_hid=1024, h_mm=512, rank=32, gamma=2)
V, REAL_BOXES, Q, A = 50, 44, 12, 3
K1_TOL = 1e-5       # attention weights are <= 1; f32 sums in another order
K2_REL_TOL = 2e-4   # pool: error relative to the output's largest magnitude
SERVE_TOL = 1e-3    # logit-parity target (BASELINE.md)

# published peaks (NVIDIA data sheets): HBM bytes/s, f32 CUDA-core FLOP/s
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H200": (4.8e12, 67e12),
         "H100": (3.35e12, 67e12)}


def peaks_for(name: str):
    for key, peak in PEAKS.items():
        if key in name:
            return key, peak
    raise SystemExit(f"no published peaks for {name!r} in chip_smoke.PEAKS")


def time_ms(fn, flush: torch.Tensor, runs: int = 30) -> float:
    """Median device time of ``fn`` in ms, cold L2: each run flushes the L2
    and parks the card in a short sleep, so the launch is queued before the
    start event and host overhead stays out of the window."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def post(port: int, path: str, payload, npz: bool = False):
    if npz:
        buf = io.BytesIO()
        np.savez(buf, **payload)
        data, ctype = buf.getvalue(), "application/x-npz"
    else:
        data, ctype = json.dumps(payload).encode(), "application/json"
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=300) as r:
        body = r.read()
        if r.headers.get("Content-Type") == "application/x-npz":
            with np.load(io.BytesIO(body)) as z:
                return {"logits": z["logits"]}
        return json.loads(body)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from vqatpu_torch.config import ModelConfig
    from vqatpu_torch.data import Dictionary
    from vqatpu_torch.kernels import build
    from vqatpu_torch.kernels import trilinear as K
    from vqatpu_torch.models import build_model
    from vqatpu_torch.serve import InferenceSession, require_f32_math
    from vqatpu_torch.cli.serve import serve_in_thread
    from vqatpu_torch.weights import load_jax_params, numpy_batch, numpy_params

    # -- 1. the card ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    peak_name, (peak_bw, peak_f32) = peaks_for(kind)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}; "
          f"peaks used: {peak_name} {peak_bw / 1e12} TB/s, "
          f"{peak_f32 / 1e12} TFLOP/s f32")
    require_f32_math()
    dev = torch.device("cuda")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    outputs = build.build(build.SOURCES, ptxas_info=True)
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(outputs)}")
    for name, out in outputs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # -- 3. kernels against their plain versions --------------------------
    cfg = ModelConfig(**CFG)
    params = numpy_params(cfg, seed=0)
    model = load_jax_params(build_model(cfg), params).to(dev).eval()

    def path_inputs(n: int, seed: int, pad_row: bool):
        """The kernels' inputs as the full-width model forms them for n
        rows; with ``pad_row`` the last row is fully masked, as the padded
        rows of a serving bucket are."""
        batch = numpy_batch(cfg, n, seed=seed, boxes=V, real_boxes=REAL_BOXES)
        v = torch.from_numpy(batch["v"]).to(dev)
        mask = v.abs().sum(-1) != 0
        mask[-1] &= not pad_row
        with torch.inference_mode():
            q_s = model.q_emb(model.w_emb(torch.from_numpy(batch["q"]).to(dev)))
            a_s = model.ans_emb(model.wa_emb(torch.from_numpy(batch["a"]).to(dev)))
            v_r, q_r, a_r, T = model.t_att.tc.rank_projections(v, q_s, a_s)
            tqa = K.precontract_qa(q_r, a_r, T)
            att = K.fused_rank_softmax_ref(v_r, tqa, mask)
            tn = model.t_net0
            pool = (tn.v_tucker(v), tn.q_tucker(q_s), tn.a_tucker(a_s),
                    att[..., 0])
        return (v_r, tqa, mask), pool

    def ragged_inputs(b: int, v_len: int, seed: int):
        g = torch.Generator().manual_seed(seed)
        R, X, G, D = 32, 16, 2, 1024
        lens = torch.randint(1, v_len + 1, (b,), generator=g)
        mask = torch.arange(v_len)[None] < lens[:, None]
        mask[-1] = False
        v_r = torch.randn(b, v_len, R, X, generator=g)
        tqa = torch.randn(b, Q, A, R, X, G, generator=g) / (R * X) ** 0.5
        att = torch.rand(b, v_len, Q, A, G, generator=g)
        pool = [t.to(dev) for t in (torch.randn(b, v_len, D, generator=g),
                                    torch.randn(b, Q, D, generator=g),
                                    torch.randn(b, A, D, generator=g))]
        # one glimpse of the attention, strided, as the model passes it
        pool.append(att.to(dev)[..., 1])
        return [t.to(dev) for t in (v_r, tqa, mask)], pool

    def check(label, k1_args, k2_args):
        got = K.fused_rank_softmax(*k1_args)
        want = K.fused_rank_softmax_ref(*k1_args)
        torch.cuda.synchronize()
        e1 = (got - want).abs().max().item()
        masked = ~k1_args[2].any(1)
        masked_max = got[masked].abs().max().item() if masked.any() else 0.0
        ok1 = e1 <= K1_TOL and masked_max == 0.0 and bool(got.isfinite().all())
        print(f"K1 {label}: max_abs_err {e1:.3e} (tol {K1_TOL:.0e}), "
              f"{int(masked.sum())} fully masked rows, max there {masked_max}")
        got2 = K.trilinear_pool(*k2_args)
        want2 = K.trilinear_pool_ref(*k2_args)
        torch.cuda.synchronize()
        e2 = (got2 - want2).abs().max().item()
        tol2 = K2_REL_TOL * want2.abs().max().item()
        print(f"K2 {label}: max_abs_err {e2:.3e} (tol {tol2:.3e} = "
              f"{K2_REL_TOL:.0e} x max|ref|)")
        if not (ok1 and e2 <= tol2):
            raise SystemExit(f"kernel disagrees with its plain version: {label}")
        return e1, e2

    errs = {}
    with torch.inference_mode():
        for n in (1, 128):
            k1_args, k2_args = path_inputs(n, seed=10 + n, pad_row=n > 1)
            errs[n] = check(f"B={n} V={V}", k1_args, k2_args)
        k1_big, _ = ragged_inputs(4, 2048, seed=1)
        _, k2_big = ragged_inputs(4, 293, seed=2)
        check("ragged V=2048 (K1) / V=293 (K2)", k1_big, k2_big)

        # -- 4. times at the serving bucket B=128 --------------------------
        k1_args, k2_args = path_inputs(128, seed=138, pad_row=True)
        flush = torch.empty(128 * 2**20 // 4, device=dev)
        v_r, tqa, mask = k1_args
        B, G = v_r.shape[0], tqa.shape[-1]
        RX, QA = v_r.shape[2] * v_r.shape[3], Q * A
        vt, qt, at, w = k2_args
        D = vt.shape[-1]

        def k1_library():
            # one bmm, then a masked softmax over the flattened (V, Q, A)
            lg = torch.bmm(v_r.reshape(B, V, RX),
                           tqa.permute(0, 3, 4, 1, 2, 5).reshape(B, RX, QA * G))
            lg = lg.reshape(B, V * QA, G).masked_fill(
                ~mask.repeat_interleave(QA, 1)[..., None], float("-inf"))
            return torch.softmax(lg, dim=1)

        f32 = 4
        k1_bytes = (v_r.numel() + tqa.numel() + B * V * QA * G) * f32 + mask.numel()
        k1_flops = 2 * B * G * V * RX * QA
        k2_bytes = (vt.numel() + qt.numel() + at.numel() + B * V * QA + B * D) * f32
        k2_flops = 2 * B * V * A * (Q + 1) * D + 2 * B * A * D
        rows = []
        for name, src, line, fn, plain, lib, nbytes, flops, err in (
                ("fused_rank_softmax", "vqatpu_torch/kernels/csrc/rank_softmax.cu",
                 "vqatpu/kernels/trilinear.py:303",
                 lambda: K.fused_rank_softmax(*k1_args),
                 lambda: K.fused_rank_softmax_ref(*k1_args), k1_library,
                 k1_bytes, k1_flops, max(errs[1][0], errs[128][0])),
                ("trilinear_pool", "vqatpu_torch/kernels/csrc/tri_pool.cu",
                 "vqatpu/kernels/trilinear.py:369",
                 lambda: K.trilinear_pool(*k2_args),
                 lambda: K.trilinear_pool_ref(*k2_args),
                 lambda: K.trilinear_pool_ref(*k2_args),
                 k2_bytes, k2_flops, max(errs[1][1], errs[128][1]))):
            t_bytes, t_flops = nbytes / peak_bw * 1e3, flops / peak_f32 * 1e3
            rows.append({
                "name": name, "route": "cuda", "source": src, "replaces": line,
                "launches": 0, "max_abs_err": err,
                "ms": time_ms(fn, flush), "plain_ms": time_ms(plain, flush),
                "bound_ms": max(t_bytes, t_flops),
                "bound_by": "bytes" if t_bytes >= t_flops else "operations",
                "library_ms": time_ms(lib, flush)})
            r = rows[-1]
            print(f"{name} B={B}: {r['ms'] * 1e3:.1f} us, plain "
                  f"{r['plain_ms'] * 1e3:.1f} us, library "
                  f"{r['library_ms'] * 1e3:.1f} us, bound "
                  f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}: "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
        del flush, k1_args, k2_args, v_r, tqa, mask, vt, qt, at, w

    # -- 5. the main path: HTTP serving at full width ---------------------
    labels = [f"ans{i}" for i in range(cfg.num_ans_candidates)]
    session = InferenceSession(model, labels, device="cuda")
    cpu = InferenceSession(load_jax_params(build_model(cfg), params), labels,
                           device="cpu")
    words = "what color is the cat dog on the table how many people"
    dictionary = Dictionary()
    dictionary.tokenize(words, add_word=True)
    golden = np.load(ROOT / "tests" / "data" / "torch_cti_golden.npz")
    assert int(golden["param_seed"]) == 0, "golden made from other weights"
    K.reset_launches()
    server = serve_in_thread(session, dictionary, "cti", 0)
    port = server.server_address[1]
    try:
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=30).read())
        assert health == {"status": "ok", "model": "cti"}, health
        worst = 0.0
        for n in (1, 5, 40):
            batch = numpy_batch(cfg, n, seed=100 + n, boxes=V,
                                real_boxes=REAL_BOXES)
            arrays = {"features": batch["v"], "question_tokens": batch["q"],
                      "answer_tokens": batch["a"]}
            as_json = {k: x.tolist() for k, x in arrays.items()}
            direct = session.logits(batch["v"], None, batch["q"], batch["a"])
            want = cpu.logits(batch["v"], None, batch["q"], batch["a"])
            served = [np.asarray(post(port, "/logits", arrays, npz=True)["logits"]),
                      np.asarray(post(port, "/logits", as_json)["logits"])]
            answers = [post(port, "/answer", arrays, npz=True)["answers"],
                       post(port, "/answer", as_json)["answers"]]
            expect = [labels[i] for i in direct.argmax(1)]
            assert all(a == expect for a in answers), (n, answers, expect)
            for got in served + [direct]:
                assert got.shape == (n, cfg.num_ans_candidates) and \
                    np.isfinite(got).all(), got.shape
                err = float(np.abs(got - want).max())
                worst = max(worst, err)
                assert err <= SERVE_TOL, f"n={n}: CUDA vs CPU logits {err}"
            print(f"serve n={n}: {len(answers[0])} answers agree; CUDA vs "
                  f"CPU logits max_abs_err {float(np.abs(direct - want).max()):.3e}")
        string_q = post(port, "/answer", {
            "features": batch["v"][:2].tolist(),
            "questions": ["what color is the cat?", "how many people?"],
            "answer_tokens": batch["a"][:2].tolist()})
        assert len(string_q["answers"]) == 2, string_q
        gb = numpy_batch(cfg, int(golden["n"]), seed=int(golden["batch_seed"]),
                         boxes=V, real_boxes=REAL_BOXES)
        g_err = float(np.abs(session.logits(gb["v"], None, gb["q"], gb["a"])
                             - golden["logits"]).max())
        print(f"golden: CUDA vs JAX logits max_abs_err {g_err:.3e} "
              f"(tol {SERVE_TOL:.0e})")
        assert g_err <= SERVE_TOL, g_err
    finally:
        server.shutdown()
        server.server_close()
    torch.cuda.synchronize()
    fwd = session.forwards
    counts = dict(K.launches)
    print(f"main path: {fwd} forwards, buckets {session.bucket_calls}, "
          f"launches {counts}; worst served-vs-CPU logit err {worst:.3e}")
    assert session.bucket_calls.get(128), session.bucket_calls
    assert counts["fused_rank_softmax"] == fwd > 0, counts
    assert counts["trilinear_pool"] == cfg.gamma * fwd, counts
    for r in rows:
        r["launches"] = counts[r["name"]]

    # -- 6. where the time goes, per bucket -------------------------------
    # session.logits on the host clock (it returns numpy, so the card is
    # done); the feature upload and the forward alone between CUDA events
    def median_ms(fn, on_card: bool, runs: int = 10) -> float:
        fn()
        fn()
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    for n in session.batch_buckets:
        b = numpy_batch(cfg, n, seed=300 + n, boxes=V, real_boxes=REAL_BOXES)
        e2e = median_ms(lambda: session.logits(b["v"], None, b["q"], b["a"]),
                        on_card=False)
        h2d = median_ms(lambda: torch.from_numpy(b["v"]).to(dev), on_card=True)
        v_d, q_d, a_d = (torch.from_numpy(b[k]).to(dev) for k in "vqa")
        with torch.inference_mode():
            fwd = median_ms(lambda: model(v_d, q_d, a_d, v_d.abs().sum(-1) != 0),
                            on_card=True)
        print(f"bucket {n}: session.logits {e2e:.3f} ms ({n / e2e * 1e3:.0f} "
              f"rows/s); on the card: feature upload {h2d:.3f} ms, forward "
              f"{fwd:.3f} ms")
    kernel_ms = rows[0]["ms"] + cfg.gamma * rows[1]["ms"]
    print(f"bucket {n}: the CUDA kernels take {kernel_ms:.3f} ms of the "
          f"{fwd:.3f} ms forward ({kernel_ms / fwd:.1%}, cold-L2 times)")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
