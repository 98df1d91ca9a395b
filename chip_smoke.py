#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``vqatpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, none of
them caught, so any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build the CUDA kernels from ``vqatpu_torch/kernels/csrc`` (``nvcc``);
3. hold each kernel against its plain PyTorch version on the card, at the
   inputs the full-width CTI model gives it at batch 1 and 128 (V=50, 44
   real boxes, the last row fully masked), on ragged large-V inputs, and
   at the edges of K1's and K2's tiles (V one past a tile, 1 and 3
   glimpses, D not a multiple of K2's d span) and of K3's and the softmax
   backward's (1 and 3 glimpses, slices of no whole number of 16-byte
   units, V at the register-resident limit and one past it, one sample
   with every box real, inputs off a 16-byte boundary); then the forwards and
   gradients of the three ``autograd.Function``s (K1, K2, K3) against
   their plain versions and autograd through them, at the model's inputs
   for batch 256 and on ragged large-V inputs;
4. time each kernel, its plain version and one PyTorch yardstick with CUDA
   events (median of 30 runs, L2 flushed before each, the card asleep
   while the host enqueues the call), beside the card's bound for the same
   work: K1 and K2 forward at the serving bucket B=128 and at the training
   batch B=256; K3, the softmax backward, and K1 and K2 forward+backward
   at B=256.  The kernel and the yardstick are timed a second way too,
   without the launch and event floor of a single call: many calls back
   to back between two events, rotating through input copies that exceed
   the L2 (``b2b``); a launch with no work is timed both ways;
5. serve the full-width CTI model (bench.py's config, seeded weights) over
   HTTP on the card: JSON and npz ``/answer`` and ``/logits`` requests of
   1, 5 and 40 rows; check the answers against the logits, the logits
   against the CPU path and against the JAX golden
   ``tests/data/torch_cti_golden.npz``, and that every forward launched
   each kernel (once for the attention, once per glimpse for the pool);
6. time each serving bucket end to end (``session.logits``, host clock) and
   on the card (feature upload, forward), and the kernels' share of it;
   the host time to enqueue K1 and K2 through their ``autograd.Function``s
   at B=1, against the bare launch;
7. the logits path: the full-width model's ``t_att`` with
   ``return_logits=True`` forward and backward through K3 and the softmax
   backward kernel, against the fused path and against the CPU;
8. training (bench.py's configuration): (a) three deterministic steps at
   B=4 from ``numpy_params(cfg, 0)`` against JAX's golden trajectory
   ``tests/data/torch_cti_train_golden.npz`` and against the port's CPU
   path; (b) samples/s at B=256 with dropout on, the median step time on
   CUDA events, the kernels' launches per step and share of the step, and
   a ``torch.profiler`` table of the ten costliest CUDA ops of a step.

The bf16 compute mode, the narrowed wires and by-id serving add to these
phases:

3b. the bf16-operand instances of K1 and K2 against their plain versions:
    the full-width bf16 model's inputs at batch 1, 128 and 256 (K2 at
    glimpse 0, all bf16, and at glimpse 1, bf16 ``vt`` with float32 ``qt``
    and ``at``), the tiles' edges, misaligned operands (refused), and the
    ``autograd.Function``s' forwards and gradients, which come back in the
    primals' dtypes;
4d. their times at B=128 and 256, single call and back to back, beside
    the bound for bf16 operands and bf16 yardsticks (``bmm`` + masked
    softmax, the einsum chain);
5b. serving at ``compute_dtype="bfloat16"``, held to JAX's Pallas-backend
    bf16 golden ``tests/data/torch_cti_golden_bf16.npz`` and to the budget
    against the float32 golden; serving on the float16, bfloat16 and int8
    wires with float32 compute, held to the float32 golden;
6.  the per-bucket times for every wire and compute dtype (host packing,
    upload, forward);
7b. by-id serving from a seeded store of 2,000 images (10-100 boxes of
    2048-d) resident on the card as int8 rows and as float32 rows, against
    the upload paths; a ``.npz`` round trip through
    ``ResidentFeatures.from_dataroot``; by-id times per bucket; 32
    concurrent requests through ``MicroBatcher``; and the HTTP server
    started by the CLI with ``--feature_split`` and ``--micro_batch``;
8c. bf16 training: three steps against JAX's float32 and bf16 trajectories
    (``tests/data/torch_cti_train_golden_bf16.npz``) within their budget;
    samples/s at B=256 for bf16 compute and for the float32 and int8 wires
    from host batches, each with a ``torch.profiler`` table.

K3's bf16-logits instance adds to 3b (the full-width bf16 model's logits at
batch 1, 128 and 256, 1 and 3 glimpses, V at the register-resident limit
and one past it, slices of no whole number of 16-byte units and logits off
a 16-byte boundary, and its gradient, which comes back bf16), to 4d (its
times at B=256 beside bf16-in ``torch.softmax``) and to 7 (the logits path
at ``compute_dtype="bfloat16"``).  Then:

9.  the free-form entry points on the card (:func:`phase9`): a synthetic
    dataroot (1,024 train and 512 val questions, 256 images of 2048-d
    ``.npz`` features, 3,129 answers), ``vqatpu_torch.cli.ffoe_train.main``
    at full width and B=256 for 10 epochs (``log.txt``, checkpoints,
    launches per step), a resume for an 11th, ``ffoe_test.main`` on epoch 9
    (EvalAI JSON, teacher logits, the swept logits against
    ``InferenceSession`` on the same checkpoint and rows) and 2 epochs at
    bf16 compute; seconds per epoch, the loop's samples/s and the share of
    an epoch spent waiting on the loader.

Each path (serving at each wire and compute dtype, the logits path in
float32 and bf16, by-id serving, training in float32 and bf16, each entry
point call of phase 9) is driven with the launch counts set to 0 just
before it and read just after; the kernels' ``launches`` in the JSON line
are their sums.

Prints the kernels' JSON line and, last, ``{"ok": true, "device": ...}``.
Without CUDA, or outside the repository, it exits non-zero with no result.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import os
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
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
K3_TOL = 1e-5       # as K1; the softmax backward is held to it too
GRAD_REL_TOL = 1e-4  # gradients, relative to the plain gradient's largest
                     # magnitude: the plain softmax gradient goes through
                     # autograd of exp, sum and divide, which cancels
                     # g - sum(g*att) in another order (8.5e-6 seen at B=256)
CPU_REL_TOL = 1e-4  # card vs CPU through the full-width layers, relative
TRAIN_TOL = 1e-4    # training trajectories, relative (ROADMAP parity contract)
SERVE_TOL = 1e-3    # logit-parity target (BASELINE.md)
TRAIN_B, WARMUP, WINDOWS, ITERS = 256, 3, 5, 20  # bench.py:50-90, fewer windows
# bf16 compute (tests/test_torch_model.py, tests/test_torch_train.py): the
# port within BF16_BUDGET x JAX's own bf16 error (+1e-4) of JAX's float32
# logits, and within BF16_DIRECT of the largest logit of JAX's bf16 ones; a
# bf16 trajectory within 2 x JAX's bf16 error + BF16_FLOOR of each value
BF16_BUDGET, BF16_DIRECT, BF16_FLOOR = 2.0, 1e-2, 2.0 ** -10
BF16_GRAD_REL_TOL = 2.0 ** -7  # bf16 gradients: a rounding on each side
BYID_TOL = 1e-5     # by-id vs the upload path on the same rows
BATCHER_TOL = 1e-4  # coalesced rows vs one call of all rows: other buckets
                    # choose other GEMM kernels, which sum in another order
N_IMAGES = 2000     # the by-id store: 10-100 boxes an image

# published peaks (NVIDIA data sheets): HBM bytes/s, f32 CUDA-core FLOP/s,
# bf16 tensor-core FLOP/s (dense)
PEAKS = {"H100 PCIe": (2.0e12, 51e12, 756e12), "H200": (4.8e12, 67e12, 989e12),
         "H100": (3.35e12, 67e12, 989e12)}


def peaks_for(name: str):
    for key, peak in PEAKS.items():
        if key in name:
            return key, peak
    raise SystemExit(f"no published peaks for {name!r} in chip_smoke.PEAKS")


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


def loop_timers(train_loop, record):
    """Wrap the epoch loop's step, loader and eval (``vqatpu_torch.train.
    loop``'s module functions) with host clocks: per epoch, ``record``
    gains the seconds spent waiting on the loader, inside step calls and in
    the eval, and the training part's wall time (to the card's last step,
    synchronised).  Returns a function that undoes the wrapping."""
    originals = (train_loop.make_train_step, train_loop._make_loader,
                 train_loop.evaluate_ffoe)
    make_step, make_loader, evaluate = originals

    def timed_make_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def timed_step(*a, **kw):
            t = time.perf_counter()
            out = step(*a, **kw)
            record[-1]["step"] += time.perf_counter() - t
            return out
        return timed_step

    class TimedLoader:
        def __init__(self, inner):
            self.inner = inner

        def __len__(self):
            return len(self.inner)

        def __iter__(self):
            rec = {"wait": 0.0, "step": 0.0, "eval": 0.0}
            record.append(rec)
            t0 = time.perf_counter()
            it = iter(self.inner)
            while True:
                t = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                rec["wait"] += time.perf_counter() - t
                yield batch
            torch.cuda.synchronize()
            rec["train"] = time.perf_counter() - t0

    def timed_evaluate(*args, **kwargs):
        t = time.perf_counter()
        out = evaluate(*args, **kwargs)
        record[-1]["eval"] += time.perf_counter() - t
        return out

    train_loop.make_train_step = timed_make_step
    train_loop._make_loader = lambda *a, **kw: TimedLoader(make_loader(*a, **kw))
    train_loop.evaluate_ffoe = timed_evaluate

    def undo():
        (train_loop.make_train_step, train_loop._make_loader,
         train_loop.evaluate_ffoe) = originals
    return undo


def phase9(cfg, path_counts, wire_step_ms, card_step_ms) -> None:
    """The free-form entry points on the card: a dataroot of 1,024 train and
    512 val questions over 256 images (2048-d ``.npz`` features, 10-20
    boxes), 3,129 answers (targets on the first 12); ``ffoe_train`` for 10
    epochs at full width and B=256, a resume for an 11th, ``ffoe_test`` on
    epoch 9 against ``InferenceSession`` on the same checkpoint and rows,
    and 2 epochs at bf16 compute.  Each call runs with the launch counts
    set to 0 just before it and read just after."""
    from vqatpu_torch.cli import ffoe_test, ffoe_train
    from vqatpu_torch.data import Dictionary, VQAFeatureDataset
    from vqatpu_torch.data.synthetic import ANSWERS, make_vqa_fixture
    from vqatpu_torch.kernels import trilinear as K
    from vqatpu_torch.serve import InferenceSession
    from vqatpu_torch.train import loop as train_loop
    from vqatpu_torch.train.checkpoints import load_checkpoint

    n_train, n_val, epochs = 1024, 512, 10
    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = os.path.join(tmp.name, "data_vqa")
    make_vqa_fixture(root, n_train=n_train, n_val=n_val, n_images=256,
                     v_dim=cfg.v_dim)
    labels = list(ANSWERS) + [f"ans{i}" for i in range(
        len(ANSWERS), cfg.num_ans_candidates)]
    with open(os.path.join(root, "cache", "trainval_ans2label.pkl"), "wb") as f:
        pickle.dump({a: i for i, a in enumerate(labels)}, f)
    with open(os.path.join(root, "cache", "trainval_label2ans.pkl"), "wb") as f:
        pickle.dump(labels, f)
    print(f"phase 9 dataroot: {n_train} train and {n_val} val questions over "
          f"256 images, {len(labels)} answers, features "
          f"{sorted(x for x in os.listdir(root) if x[:4] in ('trai', 'val.'))}, "
          f"made in {time.perf_counter() - t0:.1f} s")
    args = ["--model", "cti", "--dataroot", root, "--num_hid", str(cfg.num_hid),
            "--h_mm", str(cfg.h_mm), "--rank", str(cfg.rank), "--gamma",
            str(cfg.gamma), "--batch_size", str(TRAIN_B), "--max_boxes", str(V),
            "--device", "cuda", "--print_interval", "1000"]
    out = os.path.join(tmp.name, "saved_models", "cti")
    steps = n_train // TRAIN_B
    evals = -(-n_val // (2 * TRAIN_B))

    def run(label, argv):
        record = []
        undo = loop_timers(train_loop, record)
        K.reset_launches()
        t = time.perf_counter()
        try:
            ffoe_train.main(argv)
        finally:
            undo()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        path_counts[label] = counts = dict(K.launches)
        return counts, record, wall

    def log_of(path):
        text = open(path).read()
        losses = [float(x) for x in re.findall(r"train_loss: (\S+),", text)]
        scores = [float(x) / 100 for x in re.findall(r"eval score: (\S+) ", text)]
        secs = [float(x) for x in re.findall(r"epoch \d+, time: (\S+)", text)]
        return text, losses, scores, secs

    counts, record, wall = run("ffoe_train", args + [
        "--output", out, "--epochs", str(epochs)])
    text, losses, scores, secs = log_of(os.path.join(out, "log.txt"))
    files = sorted(os.listdir(out))
    print(f"ffoe_train, {epochs} epochs of {steps} steps at B={TRAIN_B} "
          f"(float32) in {wall:.1f} s: losses {losses}; eval scores "
          f"{scores}; files {files}; launches {counts}")
    assert len(losses) == epochs and all(np.isfinite(losses)), losses
    assert {"model_epoch9.ckpt", "model_epoch_best.ckpt"} <= set(files), files
    assert "native loader OFF (not ported" in text
    n_fwd = epochs * (steps + evals)
    assert counts["fused_rank_softmax"] == n_fwd, counts
    assert counts["trilinear_pool"] == cfg.gamma * n_fwd, counts
    assert counts["softmax_vqa_backward"] == epochs * steps, counts
    assert counts["masked_softmax_vqa"] == 0, counts
    # where an epoch's time goes: epoch 0 pays the first calls' set-up
    rest = record[1:]
    train_s = statistics.mean(r["train"] for r in rest)
    wait_s = statistics.mean(r["wait"] for r in rest)
    step_s = statistics.mean(r["step"] for r in rest)
    eval_s = statistics.mean(r["eval"] for r in rest)
    rate = n_train // TRAIN_B * TRAIN_B / train_s
    print(f"ffoe_train epochs 1-{epochs - 1} (mean): {statistics.mean(secs[1:]):.3f} s "
          f"an epoch by log.txt; training {train_s:.3f} s ({rate:.1f} samples/s), "
          f"of which the loader {wait_s:.3f} s ({wait_s / train_s:.1%}) and the "
          f"host inside step calls {step_s:.3f} s ({step_s / train_s:.1%}); "
          f"eval of {n_val} questions {eval_s:.3f} s; epoch 0 "
          f"{record[0]['train']:.3f} s training, {record[0]['eval']:.3f} s eval")
    print(f"ffoe_train samples/s {rate:.1f} against phase 8b's step alone: "
          f"{TRAIN_B / wire_step_ms * 1e3:.1f} from a host batch (float32 "
          f"wire), {TRAIN_B / card_step_ms * 1e3:.1f} with the batch on the card "
          f"(median steps on CUDA events)")

    best9 = load_checkpoint(os.path.join(out, "model_epoch9.ckpt"))["extra"]
    counts, _, wall = run("ffoe_train resume", args + [
        "--output", out, "--epochs", str(epochs + 1), "--input",
        os.path.join(out, "model_epoch9.ckpt")])
    text, losses, scores, _ = log_of(os.path.join(out, "log.txt"))
    ck10 = load_checkpoint(os.path.join(out, f"model_epoch{epochs}.ckpt"))
    best = load_checkpoint(os.path.join(out, "model_epoch_best.ckpt"))
    print(f"resume from model_epoch9.ckpt (best_eval {best9['best_eval']:.4f}): "
          f"epoch {ck10['epoch']} in {wall:.1f} s, loss {losses[-1]}, eval "
          f"{scores[-1]:.4f}; best_eval now {ck10['extra']['best_eval']:.4f}, "
          f"model_epoch_best from epoch {best['epoch']}; launches {counts}")
    assert len(losses) == epochs + 1 and f"epoch {epochs}, time" in text
    assert ck10["epoch"] == epochs and np.isfinite(losses[-1])
    # eval scores print as percents with 2 decimals
    assert abs(ck10["extra"]["best_eval"]
               - max(best9["best_eval"], scores[-1])) <= 1e-4, ck10["extra"]
    assert best["epoch"] == (epochs if ck10["extra"]["best_eval"] >
                             best9["best_eval"] else 9), best["epoch"]
    assert counts["fused_rank_softmax"] == steps + evals, counts

    results = os.path.join(tmp.name, "results")
    K.reset_launches()
    paths = ffoe_test.main(args + ["--split", "val", "--input", out, "--epoch",
                                   "9", "--results", results, "--logits", "1"])
    torch.cuda.synchronize()
    path_counts["ffoe_test"] = counts = dict(K.launches)
    with open(paths["json"]) as f:
        answers = json.load(f)
    with open(paths["teacher_logits"], "rb") as f:
        teacher = pickle.load(f)
    with np.load(paths["raw_logits"]) as z:
        swept = z["logits"]
    dictionary = Dictionary.load_from_file(os.path.join(root, "dictionary.pkl"))
    val = VQAFeatureDataset("val", dictionary, dataroot=root, max_boxes=V)
    rows8 = [val.sample(i) for i in range(8)]
    mcfg = dataclasses.replace(cfg, ntoken=dictionary.ntoken,
                               num_ans_candidates=len(labels))
    session = InferenceSession.from_checkpoint(
        os.path.join(out, "model_epoch9.ckpt"), mcfg, labels, device="cuda")
    want = session.logits(*(np.stack([r[k] for r in rows8])
                            for k in ("v", "b", "q", "a")))
    e_sess = float(np.abs(swept[:8] - want).max())
    print(f"ffoe_test --split val --epoch 9: {len(answers)} EvalAI answers, "
          f"{len(teacher)} teacher logits ({next(iter(teacher.values())).dtype}), "
          f"raw logits {swept.shape}; first 8 rows vs InferenceSession on the "
          f"checkpoint: max_abs_err {e_sess:.3e} (tol {SERVE_TOL:.0e}); "
          f"launches {counts}")
    assert len(answers) == len(teacher) == n_val == swept.shape[0]
    assert e_sess <= SERVE_TOL and np.isfinite(swept).all(), e_sess
    assert counts["fused_rank_softmax"] == -(-n_val // TRAIN_B), counts
    del session

    counts, record, wall = run("ffoe_train bf16", args + [
        "--output", os.path.join(tmp.name, "bf16"), "--epochs", "2",
        "--compute_dtype", "bfloat16"])
    _, losses, scores, secs = log_of(os.path.join(tmp.name, "bf16", "log.txt"))
    print(f"ffoe_train --compute_dtype bfloat16, 2 epochs in {wall:.1f} s "
          f"(log.txt {secs} s; epoch 1: training {record[1]['train']:.3f} s, "
          f"loader {record[1]['wait']:.3f} s, host in step calls "
          f"{record[1]['step']:.3f} s): losses {losses}, eval {scores}; "
          f"launches {counts}")
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    assert counts["fused_rank_softmax_bf16"] == 2 * (steps + evals), counts
    assert counts["trilinear_pool_bf16"] == 2 * cfg.gamma * (steps + evals)
    assert counts["softmax_vqa_backward"] == 2 * steps, counts
    assert counts["fused_rank_softmax"] == counts["trilinear_pool"] == 0, counts
    tmp.cleanup()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from vqatpu_torch.config import ModelConfig
    from vqatpu_torch.data import Dictionary
    from vqatpu_torch.kernels import build
    from vqatpu_torch.kernels import trilinear as K
    from vqatpu_torch.kernels.timing import (copies_for, sleep_cycles_per_ms,
                                             time_back_to_back_ms, time_ms)
    from vqatpu_torch.models import build_model
    from vqatpu_torch.numerics import require_f32_math
    from vqatpu_torch.serve import (InferenceSession, MicroBatcher,
                                    ResidentFeatures)
    from vqatpu_torch.cli import serve as cli
    from vqatpu_torch.cli.serve import serve_in_thread
    from vqatpu_torch.config import TrainConfig
    from vqatpu_torch.data.features import FeatureStore
    from vqatpu_torch.train import make_train_state, make_train_step, wire_cast
    from vqatpu_torch.weights import (jax_params_from_torch, load_jax_params,
                                      numpy_batch, numpy_params, param_stats)

    # -- 1. the card ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    peak_name, (peak_bw, peak_f32, peak_bf16) = peaks_for(kind)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}; "
          f"peaks used: {peak_name} {peak_bw / 1e12} TB/s, "
          f"{peak_f32 / 1e12} TFLOP/s f32, {peak_bf16 / 1e12} TFLOP/s bf16")
    require_f32_math()
    dev = torch.device("cuda")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    outputs = build.build(build.SOURCES, ptxas_info=True)
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(outputs)}")
    for name, out in outputs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
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
            logits = K.attention_logits_ref(v_r, q_r, a_r, T)
            att = K.masked_softmax_vqa_ref(logits, mask)
            tn = model.t_net0
            d = dict(v_r=v_r, tqa=tqa, mask=mask, logits=logits, att=att,
                     vt=tn.v_tucker(v), qt=tn.q_tucker(q_s), at=tn.a_tucker(a_s))
        # plain tensors (not inference tensors), so autograd can take them
        return {k: x.clone() for k, x in d.items()}

    def k1_of(d):
        return d["v_r"], d["tqa"], d["mask"]

    def k2_of(d):
        return d["vt"], d["qt"], d["at"], d["att"][..., 0]

    def ragged_inputs(b: int, v_len: int, seed: int, G: int = 2, D: int = 1024):
        """Random inputs of K1, K2 and K3 with ragged box counts; with b > 1
        the last sample is fully masked, with b = 1 all its boxes are real."""
        g = torch.Generator().manual_seed(seed)
        R, X = 32, 16
        lens = torch.randint(1, v_len + 1, (b,), generator=g)
        if b == 1:
            lens[0] = v_len
        mask = torch.arange(v_len)[None] < lens[:, None]
        mask[-1] &= b == 1
        v_r = torch.randn(b, v_len, R, X, generator=g)
        tqa = torch.randn(b, Q, A, R, X, G, generator=g) / (R * X) ** 0.5
        att = torch.rand(b, v_len, Q, A, G, generator=g)
        pool = [t.to(dev) for t in (torch.randn(b, v_len, D, generator=g),
                                    torch.randn(b, Q, D, generator=g),
                                    torch.randn(b, A, D, generator=g))]
        # one glimpse of the attention, strided, as the model passes it
        att = att.to(dev)
        pool.append(att[..., -1])
        logits = 3 * torch.randn(b, v_len, Q, A, G, generator=g)
        return ([t.to(dev) for t in (v_r, tqa, mask)], pool,
                (logits.to(dev), mask.to(dev)), att)

    def check_k1(label, k1_args):
        got = K.fused_rank_softmax(*k1_args)
        want = K.fused_rank_softmax_ref(*k1_args)
        torch.cuda.synchronize()
        e1 = (got - want).abs().max().item()
        masked = ~k1_args[2].any(1)
        masked_max = got[masked].abs().max().item() if masked.any() else 0.0
        ok1 = e1 <= K1_TOL and masked_max == 0.0 and bool(got.isfinite().all())
        print(f"K1 {label}: max_abs_err {e1:.3e} (tol {K1_TOL:.0e}), "
              f"{int(masked.sum())} fully masked rows, max there {masked_max}")
        if not ok1:
            raise SystemExit(f"K1 disagrees with its plain version: {label}")
        return e1

    def check_k2(label, k2_args):
        got2 = K.trilinear_pool(*k2_args)
        want2 = K.trilinear_pool_ref(*k2_args)
        torch.cuda.synchronize()
        e2 = (got2 - want2).abs().max().item()
        tol2 = K2_REL_TOL * want2.abs().max().item()
        print(f"K2 {label}: max_abs_err {e2:.3e} (tol {tol2:.3e} = "
              f"{K2_REL_TOL:.0e} x max|ref|)")
        if not (e2 <= tol2 and bool(got2.isfinite().all())):
            raise SystemExit(f"K2 disagrees with its plain version: {label}")
        return e2

    def check(label, k1_args, k2_args):
        return check_k1(label, k1_args), check_k2(label, k2_args)

    def offset_copy(x, floats):
        """A contiguous copy of ``x`` starting ``floats`` floats past a
        16-byte boundary."""
        buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
        out = buf[floats:floats + x.numel()].view(x.shape)
        out.copy_(x)
        return out

    def softmax_edge(b, v_len, q_, a_, G_, shift, seed):
        """K3's logits [b, v_len, q_, a_, G_] (``shift`` floats off a
        16-byte boundary) and a ragged mask: with b > 1 the last sample is
        fully masked, with b = 1 every box is real."""
        g = torch.Generator().manual_seed(seed)
        lens = torch.randint(1, v_len + 1, (b,), generator=g)
        if b == 1:
            lens[0] = v_len
        mask = torch.arange(v_len)[None] < lens[:, None]
        mask[-1] &= b == 1
        logits = (3 * torch.randn(b, v_len, q_, a_, G_, generator=g)).to(dev)
        return (offset_copy(logits, shift) if shift else logits), mask.to(dev)

    def check3(label, logits, mask):
        """K3 and the softmax backward kernel against their plain versions;
        fully masked rows must be exact zeros in both.  Where the logits
        are off a 16-byte boundary, so are att and the cotangent that the
        backward takes."""
        got = K.masked_softmax_vqa(logits, mask)
        want = K.masked_softmax_vqa_ref(logits, mask)
        cot = torch.randn(logits.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(logits.shape[0]))
        shift = logits.data_ptr() % 16 // 4
        if shift:
            want, cot = offset_copy(want, shift), offset_copy(cot, shift)
        dl = K.softmax_vqa_backward(want, cot)
        dl_want = K.softmax_vqa_backward_ref(want, cot)
        torch.cuda.synchronize()
        e3 = (got - want).abs().max().item()
        eb = (dl - dl_want).abs().max().item()
        masked = ~mask.any(1)
        masked_max = max(got[masked].abs().max().item(),
                         dl[masked].abs().max().item()) if masked.any() else 0.0
        print(f"K3 {label}: max_abs_err {e3:.3e}, softmax backward "
              f"{eb:.3e} (tol {K3_TOL:.0e} both), {int(masked.sum())} fully "
              f"masked rows, max there {masked_max}")
        if not (e3 <= K3_TOL and eb <= K3_TOL and masked_max == 0.0
                and bool(got.isfinite().all()) and bool(dl.isfinite().all())):
            raise SystemExit(f"K3 disagrees with its plain version: {label}")
        return e3, eb

    errs, errs3 = {}, {}
    k1_big, _, k3_big, _ = ragged_inputs(4, 2048, seed=1)
    _, k2_big, _, att_big = ragged_inputs(4, 293, seed=2)
    with torch.inference_mode():
        for n in (1, 128):
            d = path_inputs(n, seed=10 + n, pad_row=n > 1)
            errs[n] = check(f"B={n} V={V}", k1_of(d), k2_of(d))
            errs3[n] = check3(f"B={n} V={V}", d["logits"], d["mask"])
        check("ragged V=2048 (K1) / V=293 (K2)", k1_big, k2_big)
        errs3["big"] = check3("ragged V=2048", *k3_big)
        # the tiles' edges (tests/test_torch_kernels.py holds the plain
        # versions to JAX at the same shapes): one row past K1's V tile,
        # 56 rows at Q*A=36 and 2 glimpses, 64 at 1 or 3 (its 1-glimpse
        # instances); one box row past K2's 4-row ring stages, D off its
        # 256-d span
        for n, v_edge, G_ in ((1, 57, 2), (2, 65, 1), (2, 65, 3)):
            k1_edge = ragged_inputs(n, v_edge, seed=20 + G_, G=G_)[0]
            check_k1(f"edge B={n} V={v_edge} G={G_}", k1_edge)
        for n, v_edge, d_edge in ((1, 65, 96), (2, 9, 352)):
            k2_edge = ragged_inputs(n, v_edge, seed=30 + n, D=d_edge)[1]
            check_k2(f"edge B={n} V={v_edge} D={d_edge}", k2_edge)
        # softmax_vqa.cu holds 8 floats of each input a thread in registers
        # with up to 1024 threads (960 at 3 glimpses): 113 boxes of Q*A=36
        # are resident at G=2, 227 at G=1, 71 at G=3, one more box is not;
        # 7*5*3 floats are no whole number of 16-byte units; a shift puts
        # the inputs off a 16-byte boundary, out of phase with the outputs
        for n, v_edge, q_, a_, G_, shift in (
                (2, 65, Q, A, 1, 0), (2, 65, Q, A, 3, 0), (3, 7, 5, 3, 1, 0),
                (2, 113, Q, A, 2, 0), (2, 114, Q, A, 2, 0), (2, 227, Q, A, 1, 0),
                (2, 228, Q, A, 1, 0), (2, 71, Q, A, 3, 0), (2, 72, Q, A, 3, 0),
                (1, V, Q, A, 2, 0), (2, 10, Q, A, 2, 1), (4, 293, Q, A, 2, 3)):
            errs3[("edge", n, v_edge, q_, G_, shift)] = check3(
                f"edge B={n} V={v_edge} Q*A={q_ * a_} G={G_} shift={shift}",
                *softmax_edge(n, v_edge, q_, a_, G_, shift, seed=40 + v_edge))

    def grad_check(label, names, fn, ref, args, cot, fwd_tol,
                   grad_rel=GRAD_REL_TOL):
        """The forward and the gradients of ``fn`` (the kernel's
        autograd.Function) against ``ref`` (the plain version) and autograd
        through it, on the same inputs; ``fwd_tol(want)`` is the forward's
        tolerance, ``grad_rel`` the gradients' relative to their largest
        magnitude.  Each gradient must come back in its input's dtype."""
        xs = [a.detach().clone().requires_grad_() for a in args]
        out = fn(*xs)
        got = torch.autograd.grad(out, xs, cot)
        xs = [a.detach().clone().requires_grad_() for a in args]
        out_want = ref(*xs)
        want = torch.autograd.grad(out_want, xs, cot)
        torch.cuda.synchronize()
        err, tol = (out - out_want).abs().max().item(), fwd_tol(out_want)
        ok = err <= tol and bool(out.isfinite().all())
        parts = [f"forward {err:.3e} (tol {tol:.3e})"]
        for name, g, w, x in zip(names, got, want, args):
            err = (g.float() - w.float()).abs().max().item()
            tol = grad_rel * w.float().abs().max().item()
            ok &= err <= tol and bool(g.isfinite().all()) and g.dtype == x.dtype
            parts.append(f"{name} {err:.3e} (tol {tol:.3e}, {g.dtype})")
        print(f"{label}: " + ", ".join(parts))
        if not ok:
            raise SystemExit(f"forward or gradient disagrees with its plain "
                             f"version: {label}")

    def cotangent(shape, seed):
        return torch.randn(shape, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))

    def grad_checks(label, v_r, tqa, mask, vt, qt, at, att, glimpse, logits,
                    logits_mask):
        B_, V_ = v_r.shape[:2]
        grad_check(f"K1 {label}", ["dv", "dtqa"],
                   lambda x, y: K.fused_rank_softmax(x, y, mask),
                   lambda x, y: K.fused_rank_softmax_ref(x, y, mask),
                   (v_r, tqa), cotangent((B_, V_, Q, A, tqa.shape[-1]), 1),
                   lambda want: K1_TOL)
        grad_check(f"K2 {label}", ["dvt", "dqt", "dat", "datt"],
                   lambda x, y, z, w: K.trilinear_pool(x, y, z, w[..., glimpse]),
                   lambda x, y, z, w: K.trilinear_pool_ref(x, y, z, w[..., glimpse]),
                   (vt, qt, at, att), cotangent(vt.shape[:1] + vt.shape[2:], 2),
                   lambda want: K2_REL_TOL * want.abs().max().item())
        grad_check(f"K3 {label}", ["dlogits"],
                   lambda x: K.masked_softmax_vqa(x, logits_mask),
                   lambda x: K.masked_softmax_vqa_ref(x, logits_mask),
                   (logits,), cotangent(logits.shape, 3), lambda want: K3_TOL)

    d = path_inputs(TRAIN_B, seed=256, pad_row=True)
    grad_checks(f"B={TRAIN_B} V={V}", *k1_of(d), d["vt"], d["qt"], d["at"],
                d["att"], 0, d["logits"], d["mask"])
    grad_checks("ragged V=2048 (K1, K3) / V=293 (K2)", *k1_big, *k2_big[:3],
                att_big, 1, *k3_big)
    del d, k1_big, k2_big, k3_big, att_big

    # -- 3b. the bf16-operand instances of K1 and K2 ----------------------
    bf16 = torch.bfloat16
    model16 = copy.deepcopy(model).to(bf16)

    def path_inputs_bf16(n: int, seed: int, pad_row: bool):
        """K1's and K2's inputs as the full-width model forms them at
        compute_dtype="bfloat16": v_r, tqa and vt bf16; qt and at bf16 at
        glimpse 0, float32 at glimpse 1 (``qt1``, ``at1``), after the
        first glimpse's float32 joint embedding and residual."""
        batch = numpy_batch(cfg, n, seed=seed, boxes=V, real_boxes=REAL_BOXES)
        v = torch.from_numpy(batch["v"]).to(dev, bf16)
        mask = v.abs().sum(-1) != 0
        mask[-1] &= not pad_row
        with torch.inference_mode():
            q_s = model16.q_emb(model16.w_emb(torch.from_numpy(batch["q"]).to(dev)))
            a_s = model16.ans_emb(model16.wa_emb(torch.from_numpy(batch["a"]).to(dev)))
            v_r, q_r, a_r, T = model16.t_att.tc.rank_projections(v, q_s, a_s)
            tqa = K.precontract_qa(q_r, a_r, T)
            att = K.fused_rank_softmax_ref(v_r, tqa, mask)
            tn0, tn1 = model16.t_net0, model16.t_net1
            vt, qt, at = tn0.v_tucker(v), tn0.q_tucker(q_s), tn0.a_tucker(a_s)
            joint = K.trilinear_pool_ref(vt, qt, at, att[..., 0])[:, None]
            q1 = model16.q_prj0(joint) + q_s
            a1 = model16.a_prj0(joint) + a_s
            d = dict(v_r=v_r, tqa=tqa, mask=mask, att=att, vt=vt, qt=qt, at=at,
                     vt1=tn1.v_tucker(v), qt1=tn1.q_tucker(q1),
                     at1=tn1.a_tucker(a1),
                     logits=K.attention_logits_ref(v_r, q_r, a_r, T))
        assert [d[k].dtype for k in ("v_r", "tqa", "vt", "qt", "vt1", "qt1",
                                     "logits")] == [bf16] * 5 + [
            torch.float32, bf16], {k: x.dtype for k, x in d.items()}
        return {k: x.clone() for k, x in d.items()}

    def k2_glimpse1(d):
        return d["vt1"], d["qt1"], d["at1"], d["att"][..., 1]

    def to_bf16(xs, n=2):
        """The first ``n`` tensors of ``xs`` in bf16."""
        return [x.to(bf16) if i < n else x for i, x in enumerate(xs)]

    def refused(label, fn, *args):
        try:
            fn(*args)
        except ValueError as e:
            print(f"{label}: refused ({e})")
            return
        raise SystemExit(f"a misaligned or ragged bf16 operand was accepted: {label}")

    def check3_bf16(label, logits, mask):
        """K3's bf16 instance against its plain version (float32 out);
        fully masked rows exact zeros."""
        got = K.masked_softmax_vqa(logits, mask)
        want = K.masked_softmax_vqa_ref(logits, mask)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        masked = ~mask.any(1)
        masked_max = got[masked].abs().max().item() if masked.any() else 0.0
        print(f"K3 bf16 {label}: max_abs_err {e:.3e} (tol {K3_TOL:.0e}), "
              f"{int(masked.sum())} fully masked rows, max there {masked_max}")
        if not (e <= K3_TOL and masked_max == 0.0 and got.dtype == torch.float32
                and bool(got.isfinite().all())):
            raise SystemExit(f"K3 bf16 disagrees with its plain version: {label}")
        return e

    # plain tensors, made outside inference mode: the gradients below take them
    errs16, errs3_16 = {}, {}
    for n in (1, 128, TRAIN_B):
        d = path_inputs_bf16(n, seed=30 + n, pad_row=n > 1)
        errs16[n] = (check_k1(f"bf16 B={n} V={V}", k1_of(d)),
                     max(check_k2(f"bf16 B={n} V={V} glimpse 0", k2_of(d)),
                         check_k2(f"bf16 B={n} V={V} glimpse 1 (qt, at f32)",
                                  k2_glimpse1(d))))
        errs3_16[n] = check3_bf16(f"B={n} V={V} (the bf16 model's logits)",
                                  d["logits"], d["mask"])
    for n, v_edge, G_ in ((1, 57, 2), (2, 65, 1), (2, 65, 3)):
        k1_edge = to_bf16(ragged_inputs(n, v_edge, seed=50 + G_, G=G_)[0])
        check_k1(f"bf16 edge B={n} V={v_edge} G={G_}", k1_edge)
    for n, v_edge, d_edge in ((1, 65, 96), (2, 9, 352)):
        k2_edge = ragged_inputs(n, v_edge, seed=60 + n, D=d_edge)[1]
        check_k2(f"bf16 edge B={n} V={v_edge} D={d_edge}", to_bf16(k2_edge, 3))
        check_k2(f"bf16 edge B={n} V={v_edge} D={d_edge} (qt, at f32)",
                 to_bf16(k2_edge, 1))
    # 8 bf16 a thread in one 16-byte load: the resident limits are the
    # float32 kernel's (113 boxes at G=2, 227 at G=1, 71 at G=3); 7*5*3
    # bf16 are no whole number of 16-byte units; a shift of 1 or 3 bf16
    # puts the logits out of phase with att (units of 1), 4 in phase after
    # a head of 4
    for n, v_edge, q_, a_, G_, shift in (
            (2, 65, Q, A, 1, 0), (2, 65, Q, A, 3, 0), (3, 7, 5, 3, 1, 0),
            (2, 113, Q, A, 2, 0), (2, 114, Q, A, 2, 0), (2, 227, Q, A, 1, 0),
            (2, 228, Q, A, 1, 0), (2, 71, Q, A, 3, 0), (2, 72, Q, A, 3, 0),
            (1, V, Q, A, 2, 0), (2, 10, Q, A, 2, 1), (4, 293, Q, A, 2, 3),
            (4, 293, Q, A, 2, 4), (3, 7, 5, 3, 1, 2)):
        lg, mk = softmax_edge(n, v_edge, q_, a_, G_, 0, seed=80 + v_edge)
        lg = lg.to(bf16)
        errs3_16[("edge", n, v_edge, q_, G_, shift)] = check3_bf16(
            f"edge B={n} V={v_edge} Q*A={q_ * a_} G={G_} shift={shift} bf16",
            offset_copy(lg, shift) if shift else lg, mk)
    grad_check(f"K3 bf16 B={TRAIN_B}", ["dlogits"],
               lambda x: K.masked_softmax_vqa(x, d["mask"]),
               lambda x: K.masked_softmax_vqa_ref(x, d["mask"]),
               (d["logits"],), cotangent(d["logits"].shape, 13),
               lambda want: K3_TOL, grad_rel=BF16_GRAD_REL_TOL)

    v_r, tqa, mask = k1_of(d)
    refused("K1 bf16 v_r 2 bytes off a 16-byte boundary", K.fused_rank_softmax,
            offset_copy(v_r, 1), tqa, mask)
    refused("K2 bf16 vt 8 bytes off a 16-byte boundary", K.trilinear_pool,
            offset_copy(d["vt"], 4), d["qt"], d["at"], d["att"][..., 0])
    refused("K2 bf16 D=1020 (not a multiple of 8)", K.trilinear_pool,
            d["vt"][..., :1020].contiguous(), d["qt"][..., :1020].contiguous(),
            d["at"][..., :1020].contiguous(), d["att"][..., 0])
    grad_check(f"K1 bf16 B={TRAIN_B}", ["dv", "dtqa"],
               lambda x, y: K.fused_rank_softmax(x, y, mask),
               lambda x, y: K.fused_rank_softmax_ref(x, y, mask),
               (v_r, tqa), cotangent(d["att"].shape, 11), lambda want: K1_TOL,
               grad_rel=BF16_GRAD_REL_TOL)
    for g_, args in ((0, (d["vt"], d["qt"], d["at"])),
                     (1, (d["vt1"], d["qt1"], d["at1"]))):
        grad_check(f"K2 bf16 B={TRAIN_B} glimpse {g_}", ["dvt", "dqt", "dat", "datt"],
                   lambda x, y, z, w: K.trilinear_pool(x, y, z, w[..., g_]),
                   lambda x, y, z, w: K.trilinear_pool_ref(x, y, z, w[..., g_]),
                   args + (d["att"],), cotangent((TRAIN_B, d["vt"].shape[-1]), 12),
                   lambda want: K2_REL_TOL * want.abs().max().item(),
                   grad_rel=BF16_GRAD_REL_TOL)
    del d, v_r, tqa, mask

    def clone_args(args):
        return tuple(x.detach().clone().requires_grad_(x.requires_grad)
                     for x in args)

    def timed(name, label, fns, args, nbytes, flops, row=None, peak_ops=None):
        """Times of the kernel, its plain version and the library yardstick
        (``fns``, each called on ``args``) beside the card's bound: each as
        a single call, and the kernel and the yardstick back to back over
        rotating copies of ``args`` (``b2b``, no launch or event floor);
        with ``row`` = (source, replaces, err), the kernel's row of the
        JSON line.  ``peak_ops`` is the peak of the operations' type (f32
        CUDA cores by default)."""
        t_bytes = nbytes / peak_bw * 1e3
        t_flops = flops / (peak_ops or peak_f32) * 1e3
        (ms, host), (plain_ms, plain_host), (lib_ms, lib_host) = (
            time_ms(lambda f=f: f(*args), flush, cycles_per_ms) for f in fns)
        n_copies = copies_for(nbytes)
        copies = [args] + [clone_args(args) for _ in range(n_copies - 1)]
        calls = copies * -(-20 // n_copies)
        b2b, lib_b2b = (time_back_to_back_ms(
            [lambda f=f, c=c: f(*c) for c in calls], cycles_per_ms)
            for f in (fns[0], fns[2]))
        del copies, calls
        r = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_flops),
             "bound_by": "bytes" if t_bytes >= t_flops else "operations",
             "library_ms": lib_ms, "b2b_ms": b2b, "library_b2b_ms": lib_b2b}
        print(f"{name} {label}: {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} "
              f"us, library {lib_ms * 1e3:.1f} us, bound "
              f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}: "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP); host enqueue "
              f"{host * 1e3:.1f} / {plain_host * 1e3:.1f} / "
              f"{lib_host * 1e3:.1f} us; b2b {b2b * 1e3:.2f} us, library b2b "
              f"{lib_b2b * 1e3:.2f} us ({n_copies} input copies)")
        if row is None:
            return r
        src, line, err = row
        return {"name": name, "route": "cuda",
                "source": f"vqatpu_torch/kernels/csrc/{src}", "replaces": line,
                "launches": 0, "max_abs_err": err, **r}

    # phase 4's inputs at the training batch, made outside inference mode
    # for the backward timings of 4c
    d = path_inputs(TRAIN_B, seed=266, pad_row=True)
    mask_flat = d["mask"].repeat_interleave(Q * A, 1)[..., None]
    cot = cotangent(d["att"].shape, 4)
    flush = torch.empty(128 * 2**20 // 4, device=dev)  # > the 50 MB L2
    cycles_per_ms = sleep_cycles_per_ms()
    f32, QA = 4, Q * A
    tiny = [torch.zeros(1, device=dev) for _ in range(20)]
    floor_ms, _ = time_ms(tiny[0].zero_, flush, cycles_per_ms)
    floor_b2b = time_back_to_back_ms([x.zero_ for x in tiny], cycles_per_ms)
    print(f"a launch with no work (4-byte zero_): {floor_ms * 1e3:.1f} us as "
          f"a single call, {floor_b2b * 1e3:.2f} us back to back")
    del tiny

    def nbytes_of(*xs):
        return sum(x.numel() * x.element_size() for x in xs)

    def k1_cost(v_r, tqa, mask, keep=None):
        """Bytes (inputs read once, att written once, in their dtypes) and
        FLOP of K1."""
        B_, V_, R_, X_ = v_r.shape
        G_ = tqa.shape[-1]
        return (nbytes_of(v_r, tqa) + B_ * V_ * QA * G_ * f32 + mask.numel(),
                2 * B_ * G_ * V_ * R_ * X_ * QA)

    def k2_cost(vt, qt, at, w):
        """Bytes and FLOP of K2, in its order: V first, then Q, then A."""
        B_, V_, D_ = vt.shape
        return (nbytes_of(vt, qt, at) + (B_ * V_ * QA + B_ * D_) * f32,
                2 * B_ * D_ * (V_ * QA + QA + A))

    def k1_library(v_r, tqa, mask, keep):
        """One bmm, then a masked softmax over the flattened (V, Q, A) in
        float32; ``keep`` is the mask repeated over (Q, A)."""
        B_, V_, R_, X_ = v_r.shape
        G_ = tqa.shape[-1]
        lg = torch.bmm(v_r.reshape(B_, V_, R_ * X_), tqa.permute(
            0, 3, 4, 1, 2, 5).reshape(B_, R_ * X_, QA * G_))
        return torch.softmax(lg.reshape(B_, V_ * QA, G_).masked_fill(
            ~keep, float("-inf")), dim=1, dtype=torch.float32)

    def k2_einsum_in(dtype):
        """The plain version's einsum chain with every operand in ``dtype``:
        K2's yardstick for bf16 operands."""
        def chain(vt, qt, at, w):
            vt, qt, at, w = (x.to(dtype) for x in (vt, qt, at, w))
            wv = torch.einsum("bvqa,bvd->bqad", w, vt)
            m = torch.einsum("bqad,bqd->bad", wv, qt)
            return torch.einsum("bad,bad->bd", m, at)
        return chain

    def time_forwards(d_, label, rows=None):
        """K1 and K2 forward on path inputs ``d_`` beside their plain
        versions, their library yardsticks (for K2 the einsum chain of its
        plain version) and their bounds; with ``rows``, as the kernels'
        rows of the JSON line.  K2 reads glimpse 0 of the attention in
        place, as the model does."""
        k1_args = k1_of(d_) + (d_["mask"].repeat_interleave(QA, 1)[..., None],)
        k2_args = (d_["vt"], d_["qt"], d_["at"], d_["att"])

        def on_glimpse0(f):
            return lambda vt, qt, at, a: f(vt, qt, at, a[..., 0])
        return (
            timed("fused_rank_softmax", label,
                  (lambda v, t, m, k: K.fused_rank_softmax(v, t, m),
                   lambda v, t, m, k: K.fused_rank_softmax_ref(v, t, m),
                   k1_library), k1_args, *k1_cost(*k1_args),
                  row=None if rows is None else rows[0]),
            timed("trilinear_pool", label,
                  (on_glimpse0(K.trilinear_pool),
                   on_glimpse0(K.trilinear_pool_ref),
                   on_glimpse0(K.trilinear_pool_ref)), k2_args,
                  *k2_cost(*k2_of(d_)),
                  row=None if rows is None else rows[1]))

    with torch.inference_mode():
        # -- 4. K1 and K2 at the serving bucket B=128 and at B=256 ---------
        d128 = path_inputs(128, seed=138, pad_row=True)
        rows = list(time_forwards(d128, "B=128", rows=(
            ("rank_softmax.cu", "vqatpu/kernels/trilinear.py:303",
             max(errs[1][0], errs[128][0])),
            ("tri_pool.cu", "vqatpu/kernels/trilinear.py:369",
             max(errs[1][1], errs[128][1])))))
        del d128
        time_forwards(d, f"B={TRAIN_B}")
        G = d["tqa"].shape[-1]

        # -- 4b. K3 and the softmax backward at the training batch ---------
        logits, mask, att = d["logits"], d["mask"], d["att"]
        B = TRAIN_B
        n_el = att.numel()
        rows.append(timed(
            "masked_softmax_vqa", f"B={B}",
            (lambda lg, m, mf: K.masked_softmax_vqa(lg, m),
             lambda lg, m, mf: K.masked_softmax_vqa_ref(lg, m),
             lambda lg, m, mf: torch.softmax(lg.reshape(
                 B, V * QA, G).masked_fill(~mf, float("-inf")), dim=1)),
            (logits, mask, mask_flat), 2 * n_el * f32 + mask.numel(),
            5 * n_el,
            row=("softmax_vqa.cu", "vqatpu/kernels/trilinear.py:207",
                 max(e[0] for e in errs3.values()))))
        rows.append(timed(
            "softmax_vqa_backward", f"B={B}",
            (K.softmax_vqa_backward, K.softmax_vqa_backward_ref,
             lambda a, c: torch.ops.aten._softmax_backward_data(
                 c.reshape(B, V * QA, G), a.reshape(B, V * QA, G), 1,
                 torch.float32)),
            (att, cot), 3 * n_el * f32, 4 * n_el,
            row=("softmax_vqa.cu", "vqatpu/kernels/trilinear.py:237",
                 max(e[1] for e in errs3.values()))))

        # -- 4d. the bf16 instances at B=128 and B=256 --------------------
        def time_forwards_bf16(d_, label, rows=None):
            """As time_forwards, for the bf16 instances: bounds with bf16
            bytes and the bf16 tensor cores' peak (the least time the card
            could take for the same work; the kernels run f32 FMAs on the
            CUDA cores), bf16 yardsticks; K2 at both glimpses."""
            k1_args = k1_of(d_) + (d_["mask"].repeat_interleave(QA, 1)[..., None],)
            out = [timed("fused_rank_softmax_bf16", label,
                         (lambda v, t, m, k: K.fused_rank_softmax(v, t, m),
                          lambda v, t, m, k: K.fused_rank_softmax_ref(v, t, m),
                          k1_library), k1_args, *k1_cost(*k1_args),
                         row=None if rows is None else rows[0],
                         peak_ops=peak_bf16)]
            for g_, args, row in ((0, k2_of(d_), None if rows is None else rows[1]),
                                  (1, k2_glimpse1(d_), None)):
                out.append(timed(
                    "trilinear_pool_bf16", f"{label} glimpse {g_}",
                    (K.trilinear_pool, K.trilinear_pool_ref, k2_einsum_in(bf16)),
                    args, *k2_cost(*args), row=row, peak_ops=peak_bf16))
            return out

        d16 = path_inputs_bf16(128, seed=148, pad_row=True)
        rows += time_forwards_bf16(d16, "B=128", rows=(
            ("rank_softmax.cu", "vqatpu/kernels/trilinear.py:303",
             max(e[0] for e in errs16.values())),
            ("tri_pool.cu", "vqatpu/kernels/trilinear.py:369",
             max(e[1] for e in errs16.values()))))[:2]
        d16 = path_inputs_bf16(TRAIN_B, seed=276, pad_row=True)
        time_forwards_bf16(d16, f"B={TRAIN_B}")
        # K3 on the bf16 model's logits: bf16 in, float32 out; the
        # yardstick is torch.softmax reading bf16 and writing float32
        lg16, m16 = d16["logits"], d16["mask"]
        mf16 = m16.repeat_interleave(QA, 1)[..., None]
        n16 = lg16.numel()
        rows.append(timed(
            "masked_softmax_vqa_bf16", f"B={B}",
            (lambda lg, m, mf: K.masked_softmax_vqa(lg, m),
             lambda lg, m, mf: K.masked_softmax_vqa_ref(lg, m),
             lambda lg, m, mf: torch.softmax(lg.reshape(
                 B, V * QA, G).masked_fill(~mf, float("-inf")), dim=1,
                 dtype=torch.float32)),
            (lg16, m16, mf16), n16 * (2 + f32) + m16.numel(), 5 * n16,
            row=("softmax_vqa.cu", "vqatpu/kernels/trilinear.py:207",
                 max(errs3_16.values()))))
        del d16, lg16, m16, mf16

    # -- 4c. K1 and K2 forward + backward at the training batch -----------
    v_r, tqa = (d[k].requires_grad_() for k in ("v_r", "tqa"))
    vt, qt, at, att = (d[k].requires_grad_() for k in ("vt", "qt", "at", "att"))
    RX, D = v_r.shape[2] * v_r.shape[3], vt.shape[-1]
    g1, g2 = cotangent(att.shape, 5), cotangent((B, D), 6)

    def k1_fb(fn):
        return lambda v, t, m, g: torch.autograd.grad(fn(v, t, m), (v, t), g)

    def k1_bmm_softmax(v_r, tqa, mask):
        lg = torch.bmm(v_r.reshape(B, V, RX),
                       tqa.permute(0, 3, 4, 1, 2, 5).reshape(B, RX, QA * G))
        lg = lg.reshape(B, V * QA, G).masked_fill(~mask_flat, float("-inf"))
        return torch.softmax(lg, dim=1).reshape(att.shape)

    def k2_fb(fn):
        return lambda vt, qt, at, a, g: torch.autograd.grad(
            fn(vt, qt, at, a[..., 0]), (vt, qt, at, a), g)

    # inputs read once and outputs written once: K1 (v_r, tqa, mask, g) ->
    # (att, dv, dtqa); K2 (vt, qt, at, w, g) -> (out, gvt, gqt, gat, gw)
    k1_fb_bytes = 2 * (v_r.numel() + tqa.numel() + n_el) * f32 + mask.numel()
    k1_fb_flops = 3 * 2 * B * G * V * RX * QA
    k2_fb_bytes = 2 * (vt.numel() + qt.numel() + at.numel() + B * V * QA
                       + B * D) * f32
    k2_fb_flops = (k2_cost(vt, qt, at, att[..., 0])[1] + 3 * 2 * B * V * QA * D
                   + 6 * B * QA * D)
    fwd_bwd = {
        "fused_rank_softmax": timed(
            "fused_rank_softmax forward+backward", f"B={B}",
            (k1_fb(K.fused_rank_softmax), k1_fb(K.fused_rank_softmax_ref),
             k1_fb(k1_bmm_softmax)), (v_r, tqa, mask, g1),
            k1_fb_bytes, k1_fb_flops),
        "trilinear_pool": timed(
            "trilinear_pool forward+backward", f"B={B} (one glimpse)",
            (k2_fb(K.trilinear_pool), k2_fb(K.trilinear_pool_ref),
             k2_fb(K.trilinear_pool_ref)), (vt, qt, at, att, g2),
            k2_fb_bytes, k2_fb_flops)}
    del flush, d, logits, mask, att, cot, v_r, tqa, vt, qt, at, g1, g2

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
    path_counts = {"serving": counts}

    # -- 5b. serving at bf16 compute, and on each narrowed wire -----------
    golden16 = np.load(ROOT / "tests" / "data" / "torch_cti_golden_bf16.npz")
    assert all(int(golden16[k]) == int(golden[k])
               for k in ("n", "param_seed", "batch_seed")), "golden seeds differ"
    scale = float(np.abs(golden["logits"]).max())
    own16 = float(np.abs(golden16["logits"] - golden["logits"]).max())
    sessions = {("float32", "float32"): session}
    for wire, compute in (("float32", "bfloat16"), ("float16", "float32"),
                          ("bfloat16", "float32"), ("int8", "float32")):
        sess = InferenceSession(model, labels, transfer_dtype=wire,
                                compute_dtype=compute, device="cuda")
        sessions[(wire, compute)] = sess
        K.reset_launches()
        logits_g = sess.logits(gb["v"], None, gb["q"], gb["a"])
        for n in (1, 40):  # buckets 1 and 128
            b_ = numpy_batch(cfg, n, seed=500 + n, boxes=V, real_boxes=REAL_BOXES)
            out = sess.logits(b_["v"], None, b_["q"], b_["a"])
            assert out.shape == (n, cfg.num_ans_candidates) and np.isfinite(out).all()
        torch.cuda.synchronize()
        counts = dict(K.launches)
        sfx = "_bf16" if compute == "bfloat16" else ""
        assert counts["fused_rank_softmax" + sfx] == sess.forwards == 3, counts
        assert counts["trilinear_pool" + sfx] == cfg.gamma * sess.forwards, counts
        assert sum(counts.values()) == (1 + cfg.gamma) * sess.forwards, counts
        path_counts[f"serving wire={wire} compute={compute}"] = counts
        err32 = float(np.abs(logits_g - golden["logits"]).max())
        if compute == "bfloat16":
            err16 = float(np.abs(logits_g - golden16["logits"]).max())
            print(f"serve compute=bfloat16: vs JAX's float32 golden {err32:.3e} "
                  f"(budget {BF16_BUDGET:g} x JAX's own {own16:.3e} + 1e-4 = "
                  f"{BF16_BUDGET * own16 + 1e-4:.3e}); vs JAX's Pallas-backend "
                  f"bf16 golden {err16:.3e} (bound {BF16_DIRECT:g} x "
                  f"{scale:.3f}); launches {counts}")
            assert err32 <= BF16_BUDGET * own16 + 1e-4, (err32, own16)
            assert err16 <= BF16_DIRECT * scale, err16
        else:
            print(f"serve wire={wire}: vs JAX's float32 golden {err32:.3e} "
                  f"(tol {SERVE_TOL:.0e}); launches {counts}")
            assert err32 <= SERVE_TOL, err32

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

    # per wire and compute dtype: the host's packing of the bucket (pad,
    # mask, cast or quantize; host clock), its upload and the forward
    # (CUDA events)
    phase6 = {}
    for (wire, compute), sess in sessions.items():
        for n in sess.batch_buckets:
            b = numpy_batch(cfg, n, seed=300 + n, boxes=V, real_boxes=REAL_BOXES)
            e2e = median_ms(lambda: sess.logits(b["v"], None, b["q"], b["a"]),
                            on_card=False)
            pack = median_ms(lambda: sess.pack(b["v"], b["q"], b["a"]),
                             on_card=False)
            host, _ = sess.pack(b["v"], b["q"], b["a"])
            h2d = median_ms(lambda: sess.upload(host), on_card=True)
            dev_b = sess.upload(host)
            fwd = median_ms(lambda: sess.forward(dev_b), on_card=True)
            wire_mb = sum(x.numel() * x.element_size() if torch.is_tensor(x)
                          else x.nbytes for x in host.values()) / 1e6
            phase6[(wire, compute, n)] = fwd
            print(f"bucket {n} wire={wire} compute={compute}: session.logits "
                  f"{e2e:.3f} ms ({n / e2e * 1e3:.0f} rows/s); host packing "
                  f"{pack:.3f} ms; on the card: upload of {wire_mb:.1f} MB "
                  f"{h2d:.3f} ms, forward {fwd:.3f} ms")
    n = session.batch_buckets[-1]
    fwd = phase6[("float32", "float32", n)]
    kernel_ms = rows[0]["ms"] + cfg.gamma * rows[1]["ms"]
    print(f"bucket {n}: the CUDA kernels take {kernel_ms:.3f} ms of the "
          f"{fwd:.3f} ms forward ({kernel_ms / fwd:.1%}, cold-L2 times)")
    kernel16 = rows[4]["ms"] + cfg.gamma * rows[5]["ms"]
    fwd16 = phase6[("float32", "bfloat16", n)]
    print(f"bucket {n} at bf16: the bf16 instances take {kernel16:.3f} ms of "
          f"the {fwd16:.3f} ms forward ({kernel16 / fwd16:.1%}, cold-L2 times)")
    del sessions, dev_b, host

    # the host cost of the autograd.Function that serving's launches go
    # through under inference_mode, against the bare launch, at B=1: the
    # host's time to enqueue 200 calls (the card is not waited for)
    def host_us(fn, calls: int = 200) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / calls * 1e6

    d1 = path_inputs(1, seed=601, pad_row=False)
    with torch.inference_mode():
        for name, function, bare, args in (
                ("fused_rank_softmax", K._FusedRankSoftmax,
                 K._rank_softmax_kernel, k1_of(d1)),
                ("trilinear_pool", K._TrilinearPool, K._tri_pool_kernel,
                 k2_of(d1))):
            print(f"{name} at B=1, host time to enqueue one call (200 "
                  f"calls): through its autograd.Function "
                  f"{host_us(lambda: function.apply(*args)):.1f} us, bare "
                  f"launch {host_us(lambda: bare(*args)):.1f} us")
    del d1

    # -- 7. the logits path: t_att(return_logits=True) through K3 --------
    b7 = numpy_batch(cfg, 8, seed=700, boxes=V, real_boxes=REAL_BOXES)
    cpu_model = cpu.model
    with torch.no_grad():
        q7 = cpu_model.q_emb(cpu_model.w_emb(torch.from_numpy(b7["q"])))
        a7 = cpu_model.ans_emb(cpu_model.wa_emb(torch.from_numpy(b7["a"])))
    v7 = torch.from_numpy(b7["v"])
    mask7 = v7.abs().sum(-1) != 0
    mask7[-1] = False
    cot7 = torch.randn(8, V, Q, A, cfg.gamma,
                       generator=torch.Generator().manual_seed(7))

    def logits_path(t_att, device):
        v, q, a, m, c = (x.to(device) for x in (v7, q7, a7, mask7, cot7))
        q, a = q.requires_grad_(), a.requires_grad_()
        att, logits = t_att(v, q, a, m, return_logits=True)
        wrt = [q, a] + list(t_att.parameters())
        return att, logits, torch.autograd.grad(att, wrt, c)

    with torch.no_grad():
        fused, _ = model.t_att(*(x.to(dev) for x in (v7, q7, a7, mask7)))
    K.reset_launches()
    att7, logits7, grads7 = logits_path(model.t_att, dev)
    torch.cuda.synchronize()
    path_counts["logits"] = counts = dict(K.launches)
    att_c, logits_c, grads_c = logits_path(cpu_model.t_att, "cpu")
    e_fused = (att7 - fused).abs().max().item()
    e_att = (att7.cpu() - att_c).abs().max().item()
    finite = torch.isfinite(logits_c)
    same_inf = bool((torch.isfinite(logits7.cpu()) == finite).all())
    e_logits = ((logits7.cpu() - logits_c)[finite].abs().max()
                / logits_c[finite].abs().max()).item()
    e_grads = max(((g.cpu() - w).abs().max() / w.abs().max()).item()
                  for g, w in zip(grads7, grads_c))
    print(f"logits path (B=8, last row fully masked): att vs the fused path "
          f"{e_fused:.3e} (tol {K3_TOL:.0e}); vs the CPU path: att {e_att:.3e} "
          f"(tol {K3_TOL:.0e}), logits {e_logits:.3e} and gradients of "
          f"{len(grads7)} tensors {e_grads:.3e} relative (tol "
          f"{CPU_REL_TOL:.0e}); -inf at the same places: {same_inf}; "
          f"launches {counts}")
    assert e_fused <= K3_TOL and e_att <= K3_TOL, (e_fused, e_att)
    assert e_logits <= CPU_REL_TOL and e_grads <= CPU_REL_TOL and same_inf
    assert counts["masked_softmax_vqa"] == 1, counts
    assert counts["softmax_vqa_backward"] == 1, counts
    assert counts["fused_rank_softmax"] == 0, counts

    # the logits path at compute_dtype="bfloat16": bf16 weights and inputs
    # give K3 bf16 logits; att stays float32, the gradients come back bf16
    v16, q16, a16 = (x.to(dev, bf16) for x in (v7, q7, a7))
    q16, a16 = q16.requires_grad_(), a16.requires_grad_()
    K.reset_launches()
    att16, logits16 = model16.t_att(v16, q16, a16, mask7.to(dev),
                                    return_logits=True)
    wrt16 = [q16, a16] + list(model16.t_att.parameters())
    grads16 = torch.autograd.grad(att16, wrt16, cot7.to(dev))
    torch.cuda.synchronize()
    path_counts["logits bf16"] = counts = dict(K.launches)
    e_own = (att16 - K.masked_softmax_vqa_ref(logits16, mask7.to(dev))
             ).abs().max().item()
    e_f32 = (att16 - att7).abs().max().item()
    bound16 = BF16_DIRECT * att7.abs().max().item()
    print(f"logits path at bf16 (B=8): att {att16.dtype} from {logits16.dtype} "
          f"logits; vs the plain softmax of those logits {e_own:.3e} (tol "
          f"{K3_TOL:.0e}); vs the float32 path {e_f32:.3e} (bound "
          f"{BF16_DIRECT:g} x max att = {bound16:.3e}); gradients "
          f"{sorted({str(g.dtype) for g in grads16})}; launches {counts}")
    assert att16.dtype == torch.float32 and logits16.dtype == bf16
    assert e_own <= K3_TOL and e_f32 <= bound16, (e_own, e_f32)
    assert all(g.dtype == bf16 and bool(g.isfinite().all()) for g in grads16)
    assert counts["masked_softmax_vqa_bf16"] == 1, counts
    assert counts["softmax_vqa_backward"] == 1, counts
    assert counts["masked_softmax_vqa"] == counts["fused_rank_softmax_bf16"] == 0
    del fused, att7, logits7, grads7, att_c, logits_c, grads_c, cpu, session
    del att16, logits16, grads16, v16, q16, a16, wrt16, model16

    # -- 7b. by-id serving from a card-resident store; MicroBatcher; HTTP --
    t0 = time.perf_counter()
    gen = np.random.default_rng(9)
    n_boxes = gen.integers(10, 101, N_IMAGES)
    ends = np.cumsum(n_boxes)
    feats = gen.standard_normal((int(ends[-1]), cfg.v_dim), dtype=np.float32)
    store = FeatureStore(feats, gen.random((int(ends[-1]), 6), dtype=np.float32),
                         np.stack([ends - n_boxes, ends], 1))
    img_ids = 100_000 + np.arange(N_IMAGES)
    rf = ResidentFeatures(store, {int(i): k for k, i in enumerate(img_ids)},
                          max_boxes=V)
    print(f"by-id store: {N_IMAGES} images, {int(ends[-1])} boxes of "
          f"{cfg.v_dim}-d ({feats.nbytes / 1e6:.0f} MB float32), made in "
          f"{time.perf_counter() - t0:.1f} s")
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    n_small = 40
    e_small = int(ends[n_small - 1])
    np.savez(root / "small.npz", image_features=feats[:e_small],
             spatial_features=store.spatials[:e_small],
             pos_boxes=store.pos_boxes[:n_small])
    with open(root / "small_imgid2idx.pkl", "wb") as f:
        pickle.dump({int(i): k for k, i in enumerate(img_ids[:n_small])}, f)
    rf_small = ResidentFeatures.from_dataroot(str(root), "small", max_boxes=V)
    for x, y in zip(rf_small.gather(img_ids[:n_small]), rf.gather(img_ids[:n_small])):
        assert np.array_equal(x, y), ".npz round trip changed the features"
    print(f"by-id: {n_small} images through small.npz and "
          "ResidentFeatures.from_dataroot gather as the in-memory store does")

    sess = InferenceSession(model, labels, device="cuda")
    sess8 = InferenceSession(model, labels, transfer_dtype="int8", device="cuda")
    tok = numpy_batch(cfg, 128, seed=800, boxes=1, real_boxes=1)
    q_id, a_id = tok["q"], tok["a"]
    ids = gen.choice(img_ids, 128, replace=False)
    K.reset_launches()
    for quantize in (False, True):
        t0 = time.perf_counter()
        sess.attach_features(rf, placement="device", quantize=quantize)
        torch.cuda.synchronize()
        t_attach = time.perf_counter() - t0
        table_mb = sum(x.numel() * x.element_size() for x in sess._tables
                       if x is not None) / 1e6
        worst = 0.0
        for n in (1, 5, 40, 128):
            got = sess.logits_by_id(ids[:n], q_id[:n], a_id[:n])
            v_g, _ = rf.gather(ids[:n])
            want = (sess8 if quantize else sess).logits(v_g, None, q_id[:n], a_id[:n])
            assert got.shape == want.shape and np.isfinite(got).all()
            worst = max(worst, float(np.abs(got - want).max()))
        kind_ = "int8" if quantize else "float32"
        print(f"by-id, {kind_} tables on the card ({table_mb:.0f} MB, attached in "
              f"{t_attach:.1f} s): vs the {'int8-wire ' if quantize else ''}"
              f"upload path on the same rows, max_abs_err {worst:.3e} (tol "
              f"{BYID_TOL:.0e})")
        assert worst <= BYID_TOL, worst
    for n in sess.batch_buckets:  # int8 tables
        e2e = median_ms(lambda: sess.logits_by_id(ids[:n], q_id[:n], a_id[:n]),
                        on_card=False)
        rows_d, q_d, a_d = (torch.from_numpy(x).to(dev) for x in (
            sess._rows_table[rf.image_index(ids[:n])], q_id[:n], a_id[:n]))
        on_card = median_ms(lambda: sess.forward_by_id(rows_d, q_d, a_d),
                            on_card=True)
        print(f"by-id bucket {n} (int8 tables): logits_by_id {e2e:.3f} ms "
              f"({n / e2e * 1e3:.0f} rows/s); on the card: gather, dequantize "
              f"and forward {on_card:.3f} ms; request wire "
              f"{rows_d.numel() * 4 + (q_d.numel() + a_d.numel()) * 8} bytes")
    torch.cuda.synchronize()
    path_counts["by-id"] = dict(K.launches)
    assert path_counts["by-id"]["fused_rank_softmax"] > 0, path_counts

    # 32 concurrent single-row requests through the MicroBatcher
    b32 = numpy_batch(cfg, 32, seed=900, boxes=V, real_boxes=REAL_BOXES)
    want = sess.logits(b32["v"], None, b32["q"], b32["a"])
    K.reset_launches()
    mb = MicroBatcher(sess, max_batch=32, max_wait_ms=20.0)
    got = [None] * 32
    barrier = threading.Barrier(32)

    def call(i):
        barrier.wait()
        got[i] = mb.logits(b32["v"][i:i + 1], None, b32["q"][i:i + 1],
                           b32["a"][i:i + 1])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(32)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    wall = (time.perf_counter() - t0) * 1e3
    assert not any(th.is_alive() for th in threads), "a batcher caller hung"
    mb.close()
    err = max(float(np.abs(got[i][0] - want[i]).max()) for i in range(32))
    torch.cuda.synchronize()
    path_counts["micro-batcher"] = dict(K.launches)
    print(f"MicroBatcher: 32 concurrent single-row requests in {wall:.1f} ms, "
          f"{mb.batches_run} forwards ({mb.rows_served} rows); vs one call of "
          f"the 32 rows max_abs_err {err:.3e} (tol {BATCHER_TOL:.0e})")
    assert mb.rows_served == 32 and mb.batches_run < 32 and err <= BATCHER_TOL

    # the CLI with --feature_split and --micro_batch, over HTTP
    words = Dictionary()
    for i in range(cfg.ntoken):
        words.add_word(f"w{i}")
    words.dump_to_file(str(root / "dictionary.pkl"))
    (root / "cache").mkdir()
    with open(root / "cache" / "trainval_label2ans.pkl", "wb") as f:
        pickle.dump(labels, f)
    (root / "ckpt").mkdir()
    with open(root / "ckpt" / "model_epoch0.ckpt", "wb") as f:
        pickle.dump({"params": params}, f)  # a save_params file
    args = cli.build_parser().parse_args([
        "--dataroot", str(root), "--input", str(root / "ckpt"), "--epoch", "0",
        "--port", "0", "--device", "cuda", "--feature_split", "small",
        "--micro_batch", "32", "--micro_batch_wait_ms", "5"])
    K.reset_launches()
    served, server = cli.build_server(args)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    sess.attach_features(rf_small, placement="device", quantize=True)
    try:
        port = server.server_address[1]
        ids5 = img_ids[:5]
        body = {"image_ids": ids5.tolist(), "question_tokens": q_id[:5].tolist(),
                "answer_tokens": a_id[:5].tolist()}
        got = np.asarray(post(port, "/logits_by_id", body)["logits"])
        want = sess.logits_by_id(ids5, q_id[:5], a_id[:5])
        e_id = float(np.abs(got - want).max())
        answers = post(port, "/answer_by_id", body)["answers"]
        assert answers == [labels[i] for i in got.argmax(1)], answers
        v5, _ = rf_small.gather(ids5)
        up = np.asarray(post(port, "/logits", {
            "features": v5, "question_tokens": q_id[:5],
            "answer_tokens": a_id[:5]}, npz=True)["logits"])
        e_up = float(np.abs(up - sess.logits(v5, None, q_id[:5], a_id[:5])).max())
        print(f"HTTP (--feature_split small --micro_batch 32): /logits_by_id vs "
              f"the session {e_id:.3e} (tol {BYID_TOL:.0e}), /answer_by_id "
              f"agrees; /logits through the batcher ({served.batches_run} "
              f"forward) vs the session {e_up:.3e} (tol {BATCHER_TOL:.0e})")
        assert e_id <= BYID_TOL and e_up <= BATCHER_TOL and served.batches_run == 1
    finally:
        server.shutdown()
        server.server_close()
        served.close()
    torch.cuda.synchronize()
    path_counts["by-id HTTP"] = dict(K.launches)
    del sess, sess8, store, rf, rf_small, feats, served, server
    tmp.cleanup()

    # -- 8a. training: the full-width trajectory against JAX's golden -----
    tg = np.load(ROOT / "tests" / "data" / "torch_cti_train_golden.npz")
    n8, steps8, lr8 = int(tg["n"]), int(tg["steps"]), float(tg["lr"])
    batches = [numpy_batch(cfg, n8, seed=int(tg["batch_seed"]) + i, target=True)
               for i in range(steps8)]
    golden_stats = {k: tg[f"param_{k}"] for k in ("names", "l2", "sum", "l1")}
    traj = {}
    K.reset_launches()
    for device in ("cuda", "cpu"):
        state = make_train_state(build_model(cfg), seed=int(tg["param_seed"]),
                                 device=device)
        step = make_train_step(state.model,
                               TrainConfig(update_freq=1, deterministic=True))
        metrics = [step(state, b, lr8) for b in batches]
        if device == "cuda":
            torch.cuda.synchronize()
            path_counts["training"] = dict(K.launches)
        traj[device] = ({k: np.array([float(m[k]) for m in metrics])
                         for k in ("loss", "grad_norm", "batch_score")},
                        param_stats(jax_params_from_torch(state.model.state_dict())))
        del state, step, metrics

    def traj_err(got, want):
        """Largest relative difference of the per-step metrics and of the
        per-leaf param norms; a leaf's sum relative to its l1 norm."""
        (m, st), (m_w, st_w) = got, want
        assert (st["names"] == st_w["names"]).all()
        e_m = max(float(np.max(np.abs(m[k] - m_w[k]) / np.abs(m_w[k])))
                  for k in m)
        e_p = max(float(np.max(np.abs(st[k] - st_w[k]) / st_w[k]))
                  for k in ("l2", "l1"))
        e_s = float(np.max(np.abs(st["sum"] - st_w["sum"]) / st_w["l1"]))
        return max(e_m, e_p, e_s)

    golden_traj = ({k: tg[k] for k in ("loss", "grad_norm", "batch_score")},
                   golden_stats)
    e_golden = traj_err(traj["cuda"], golden_traj)
    e_cpu = traj_err(traj["cuda"], traj["cpu"])
    print(f"training trajectory ({steps8} steps, B={n8}, lr {lr8}): loss "
          f"{traj['cuda'][0]['loss'].tolist()}, grad_norm "
          f"{traj['cuda'][0]['grad_norm'].tolist()}; largest relative error "
          f"vs JAX's golden {e_golden:.3e}, vs the CPU path {e_cpu:.3e} (tol "
          f"{TRAIN_TOL:.0e}; per-step metrics, per-leaf norms and sums of "
          f"{len(golden_stats['names'])} leaves)")
    assert e_golden <= TRAIN_TOL and e_cpu <= TRAIN_TOL, (e_golden, e_cpu)

    # -- 8a'. bf16 training: the trajectory within its budget ------------
    tg16 = np.load(ROOT / "tests" / "data" / "torch_cti_train_golden_bf16.npz")
    assert all(tg16[k] == tg[k] for k in ("n", "steps", "param_seed",
                                          "batch_seed", "lr"))
    K.reset_launches()
    state = make_train_state(build_model(cfg), seed=int(tg["param_seed"]),
                             device="cuda")
    step = make_train_step(state.model, TrainConfig(
        update_freq=1, deterministic=True, compute_dtype="bfloat16"))
    metrics = [step(state, b, lr8) for b in batches]
    torch.cuda.synchronize()
    path_counts["training bf16"] = dict(K.launches)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    stats = param_stats(jax_params_from_torch(state.model.state_dict()))
    assert (stats["names"] == tg16["names"]).all()
    got16 = {"loss": np.array([float(m["loss"]) for m in metrics]),
             "grad_norm": np.array([float(m["grad_norm"]) for m in metrics]),
             "param_l2": stats["l2"]}
    worst = {}
    for k, x in got16.items():
        f32_, b16_ = tg16[f"f32_{k}"], tg16[f"bf16_{k}"]
        bound = BF16_BUDGET * np.abs(b16_ - f32_) + BF16_FLOOR * np.abs(f32_)
        worst[k] = float(np.max(np.abs(x - f32_) / bound))
    print(f"bf16 training trajectory ({steps8} steps, B={n8}): loss "
          f"{got16['loss'].tolist()}, grad_norm {got16['grad_norm'].tolist()}; "
          f"error against JAX's float32 over its budget ({BF16_BUDGET:g} x JAX "
          f"xla bf16's own + {BF16_FLOOR:.2e} x |value|), worst ratio per "
          f"metric (<= 1 passes): {worst}; launches {path_counts['training bf16']}")
    assert all(v <= 1.0 for v in worst.values()), worst
    del state, step, metrics

    # -- 8b. training throughput at B=256, dropout on (bench.py) -----------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def train_throughput(label, batch, windows=WINDOWS, **tcfg):
        """samples/s of the train step at B=256 with dropout on (bench.py's
        loop: windows of ITERS steps, each ending in a value readback), the
        median step on CUDA events, the host's time inside a step call
        (near the step time, the host sets the pace), the calls in one
        step that wait for the card (``torch.cuda.set_sync_debug_mode``),
        the launches per step, and a ``torch.profiler`` table of 3 steps
        with the card's busy share.
        -> (launch counts, steps, median step ms, the port's kernels' ms a
        step)."""
        state = make_train_state(build_model(cfg), seed=0, device="cuda")
        step = make_train_step(state.model, TrainConfig(
            update_freq=1, batch_size=TRAIN_B, **tcfg))
        gen = torch.Generator(device=dev).manual_seed(1)
        for _ in range(WARMUP):
            m = step(state, batch, 1e-3, gen)
        float(m["loss"])
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as waits:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                m = step(state, batch, 1e-3, gen)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        waits = [str(w.message).splitlines()[0] for w in waits
                 if "called a synchronizing" in str(w.message)]
        print(f"training {label}: {len(waits)} calls in one step wait for "
              f"the card ({sorted(set(waits))})")
        K.reset_launches()
        thr, events, enqueue = [], [], []
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(ITERS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t1 = time.perf_counter()
                m = step(state, batch, 1e-3, gen)
                enqueue.append(time.perf_counter() - t1)
                end.record()
                events.append((start, end))
            loss = float(m["loss"])  # a value readback ends the window
            thr.append(TRAIN_B * ITERS / (time.perf_counter() - t0))
        torch.cuda.synchronize()
        counts = dict(K.launches)
        n_steps = windows * ITERS
        step_ms = statistics.median(s.elapsed_time(e) for s, e in events)
        thr.sort()
        print(f"training {label}: {thr[-1]:.1f} samples/s best window, "
              f"{statistics.median(thr):.1f} median ({windows} windows of "
              f"{ITERS} steps); median step on CUDA events {step_ms:.3f} ms; "
              f"the host's time in a step call {statistics.median(enqueue) * 1e3:.3f} "
              f"ms (median); last loss {loss:.3f}; launches per step "
              f"{ {k: v / n_steps for k, v in counts.items() if v} }")
        assert np.isfinite(loss), loss
        prof_steps = 3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(prof_steps):
                m = step(state, batch, 1e-3, gen)
            torch.cuda.synchronize()
        averages = prof.key_averages()
        print(f"torch.profiler, {prof_steps} training steps, {label} (times "
              f"summed over them):")
        print(averages.table(sort_by="self_device_time_total", row_limit=10))
        on_card = [e for e in averages if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3 / prof_steps
        own = {name: sum(e.self_device_time_total for e in on_card
                         if name in e.key) / 1e3 / prof_steps
               for name in ("rank_softmax_kernel", "tri_pool_kernel",
                            "softmax_backward_kernel")}
        print(f"profiled step, {label}: {busy_ms:.3f} ms of kernels on the "
              f"card, {busy_ms / step_ms:.1%} of the {step_ms:.3f} ms median "
              f"step (idle {1 - busy_ms / step_ms:.1%}); the port's CUDA "
              f"kernels per step (L2 warm): "
              + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in own.items()))
        assert all(v > 0 for v in own.values()), own
        return counts, n_steps, step_ms

    batch = numpy_batch(cfg, TRAIN_B, seed=0, target=True)
    batch["v_mask"] = np.abs(batch["v"]).sum(-1) != 0
    db = {k: torch.from_numpy(x).to(dev) for k, x in batch.items()}
    counts, n_steps, step_ms = train_throughput(
        f"B={TRAIN_B}, batch on the card", db)
    for k, v in counts.items():
        path_counts["training"][k] += v
    assert counts["fused_rank_softmax"] == n_steps, counts
    assert counts["softmax_vqa_backward"] == n_steps, counts
    assert counts["trilinear_pool"] == cfg.gamma * n_steps, counts
    assert counts["masked_softmax_vqa"] == 0, counts
    k_ms = (fwd_bwd["fused_rank_softmax"]["ms"]
            + cfg.gamma * fwd_bwd["trilinear_pool"]["ms"])
    print(f"training B={TRAIN_B}: K1 and K2 forward+backward (1 + {cfg.gamma} "
          f"per step, phase 4c cold-L2 times) take {k_ms:.3f} ms of the "
          f"{step_ms:.3f} ms step ({k_ms / step_ms:.1%})")

    # -- 8c. bf16 compute; the float32 and int8 wires from host batches ----
    counts, n_steps, _ = train_throughput(
        f"B={TRAIN_B}, compute_dtype=bfloat16, batch on the card", db,
        windows=3, compute_dtype="bfloat16")
    for k, v in counts.items():
        path_counts["training bf16"][k] += v
    assert counts["fused_rank_softmax_bf16"] == n_steps, counts
    assert counts["trilinear_pool_bf16"] == cfg.gamma * n_steps, counts
    assert counts["softmax_vqa_backward"] == n_steps, counts
    assert counts["fused_rank_softmax"] == counts["trilinear_pool"] == 0, counts
    host8 = wire_cast(batch, "int8")  # quantized once, as a loader would
    wire_step_ms = {}
    for label, host_batch, wire in (("float32", batch, "float32"),
                                    ("int8", host8, "int8")):
        counts, n_steps, wire_step_ms[label] = train_throughput(
            f"B={TRAIN_B}, the {label} wire (a host batch copied each step)",
            host_batch, windows=3, transfer_dtype=wire)
        for k, v in counts.items():
            path_counts["training"][k] += v
        assert counts["fused_rank_softmax"] == n_steps, counts
    del db, batch, host8

    # -- 9. the entry points on the card: ffoe_train, resume, ffoe_test ---
    phase9(cfg, path_counts, wire_step_ms["float32"], step_ms)

    for r in rows:
        r["launches"] = sum(c[r["name"]] for c in path_counts.values())
    print(f"launches by path: {path_counts}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
