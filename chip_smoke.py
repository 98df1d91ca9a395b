#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``vqatpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, none of
them caught, so any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build the CUDA kernels from ``vqatpu_torch/kernels/csrc`` (``nvcc``),
   with copies of K1's and K2's sources whose bf16 entry points run the PR
   5 design (f32 FMAs on the CUDA cores; for phase 4d), all at once; check
   that ``ptxas`` spills nothing in the tensor-core kernels and that
   ``cuobjdump -sass`` finds HMMA (tensor-core) instructions in every bf16
   instance of K1 and K2, none in their float32 instances, and some in
   every instance of K2's backward;
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
    and ``at``), the tiles' edges, ragged V=2048 and R*X that ends inside
    a chunk (K1), Q=20, A=5 (K2's multi-pass instance), misaligned
    operands (refused), and the
    ``autograd.Function``s' forwards and gradients, which come back in the
    primals' dtypes;
4d. their times at B=128 and 256, single call and back to back, beside
    the bound for bf16 operands, bf16 yardsticks (``bmm`` + masked
    softmax, the einsum chain) and the CUDA-core design on the same inputs;
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
    bf16 compute, all with the Python loader and host-shipped features
    (``--no_native_loader --device_features off``); seconds per epoch, the
    loop's samples/s and the share of an epoch spent waiting on the loader.
10. the host runtime and the card-resident store: (a) build the C++ host
    runtime (``vqatpu_torch/native/vqadata.cc``) with the host compiler
    and check that the process loaded the port's own library; (b) its
    quantizer against the numpy plain version, bit for bit, at [128, 50,
    2048] and [256, 50, 2048] with all-zero rows and .5 ties, both timed;
    (c) int8-wire serving at every bucket through it, against JAX's
    float32 golden and the float32 wire, the host packing beside numpy's;
    (d) card-resident stores of 8,000 images (float32 rows, built for every
    wire) and 40,000 (int8-resident, ~2.2M box rows, the int8 and float32
    wires), each's estimate against its bytes, the ``auto`` decision and
    20 batches at B=256 gathered on the card bit-equal to the wire path
    (the C++ loader, ``wire_cast``, the upload); (e) full-width training at
    B=256 from the float32 and the int8 store; (f) ``ffoe_train`` on phase
    9's dataroot three ways (the defaults: the C++ loader and the store;
    the C++ loader with page-locked uploads; the Python loader), their
    per-step losses against each other, ``ffoe_test`` with
    ``--device_features on`` and ``off`` and the ensemble CLI on two
    exports; (g) the same three ways at depth: 16,384 train questions over
    2,048 images, 3 epochs of 64 steps.
11. BAN (with the counter, 10 objects) and SAN (2 stacks) at the same full
    width, which launch none of the three CUDA kernels (their launch counts
    are recorded and checked to be zero): (a) logits at B=4 from
    ``numpy_params(cfg, 0)`` (BAN also without the counter) on every wire
    against the CPU path on the same wire and, on the float32 wire,
    JAX's goldens ``tests/data/torch_{ban,san}_golden.npz`` (1e-3); at
    bf16 compute within 2x JAX's own largest bf16 error + 1e-4 (BAN
    without the counter and SAN on ``torch_{ban,san}_golden*.npz``; BAN
    with the counter, served and through the eval step, on the B=32 golden
    ``torch_ban_golden_bf16_n32.npz``, a sample over it printed with its
    soft counts);
    (b) BAN over HTTP (JSON and npz ``/answer`` and ``/logits`` of 1, 5
    and 40 rows with spatials and no answer tokens), by id from a store of
    300 images on the card (float32 and int8 tables, spatials gathered
    there), and every bucket of BAN and SAN at float32 and bf16 timed end
    to end and on the card; (c) three deterministic BAN steps (counter and
    distillation) at B=4 against JAX's golden trajectory
    ``torch_ban_train_golden.npz`` and the CPU path (1e-4), then samples/s
    at B=256 with dropout on for BAN and SAN at float32 and bf16, the
    median step on CUDA events, the card's idle share from a
    ``torch.profiler`` trace and its table of the ten costliest CUDA ops of
    a BAN step; (d) the distillation loop through the CLIs on phase 9's
    dataroot: phase 9's CTI checkpoint is the teacher, ``ffoe_test --split
    train`` writes its logits, ``ffoe_train --model ban --use_counter
    --distillation`` trains 10 epochs three ways (Python loader, C++
    loader, card-resident store; per-step losses within 1e-5) and
    ``ffoe_test --model ban`` writes the EvalAI JSON.

12. the Visual7W multiple-choice models at the same full width
    (``task="mc"``: a 2-class head, Q=12, A=6, 4 candidates a question,
    expanded x4 into candidate rows): (a) TanModel (CTI for MC; K1 and K2
    at Q*A=72), BanModelMC (counter) and SAN-MC (2 stacks) from
    ``numpy_params(cfg, 0)`` on 8 questions (32 rows) against JAX's
    goldens ``tests/data/torch_{tan,ban_mc,san_mc}_golden.npz`` on every
    wire and at bf16 compute, TanModel also on the grid path (V=196, zero
    spatials); TanModel's launches checked (K1 and K2, no K3 forward),
    BAN-MC's and SAN-MC's checked to be 0; (b) K1, K2 (float32 ``<4, 8>``
    in 3 passes, bf16 ``<6, 8>`` in 2, at both glimpses) and the softmax
    backward at TanModel's training shapes (64 questions, 256 rows, V=50
    and V=196) against their plain versions, forward and backward, timed
    beside their bounds and library calls (rows of the JSON line with a
    ``shape``); (c) ``mc_scores`` / ``answer_mc`` for
    1, 8, 32 and 40 questions through the session, the ``MicroBatcher``
    and HTTP ``/answer_mc`` (``mc_tokens`` as JSON and npz,
    ``mc_answers``), the picks against the CPU path's, BAN-MC with
    spatials, every bucket timed; (d) TanModel's three deterministic
    steps against JAX's golden trajectory
    ``tests/data/torch_tan_train_golden.npz`` and the CPU path, and at
    bf16 within the budget of ``torch_tan_train_golden_bf16.npz``, then 64
    questions a step with dropout on for TanModel, BAN-MC and SAN-MC at
    float32 and bf16; (e) ``mc_train`` on a Visual7W fixture three ways
    (per-step losses within 1e-5), ``mc_test`` with the store on and off
    (equal accuracy) and one epoch on the grid path.

13. CTI's large-V path, its v-side knobs and the interop tools at the same
    full width: (a) logits at B=8 and V=2048 boxes (90% real) through the
    blockwise branch (block 256; no kernel launched, no attention) against
    the standard branch (K1 and K2 at V=2048), within 1e-4; (b) a training
    step at B=64, V=2048, dropout on, in four configurations (standard,
    blockwise, ``remat_glimpse``, ``fused_v_tucker``), and standard and
    ``remat_glimpse`` at bf16 compute, and the standard model with
    ``mask_replay`` (dropout masks drawn again in the backward, none kept)
    at float32 and bf16: the peak memory allocated, the median step on
    CUDA events and the launches a step (0 for blockwise; K2 twice a
    glimpse under remat, its recompute; replay as standard), each remat
    and replay step's first loss equal to its dtype's standard one's (grad
    norm within 1e-5) and the blockwise one's within 1e-4; (c) one fused
    and one remat step at V=50, B=4 on the card against the CPU with the
    same injected masks (1e-4); (d) seeded CTI and
    BAN weights written by the port's exporter to ``model_epoch0.pth``
    and served (CTI in-process through the CLI's parser, BAN by ``python -m
    vqatpu_torch.cli.serve`` with no ``--model``), their logits equal to
    the bit to those served from a ``.ckpt``; (e) a bidirectional 2-layer
    GRU and an LSTM at num_hid 1024, B=128, on cuDNN against the CPU; (f)
    ``ffoe_train --profile_dir`` on phase 9's dataroot, whose trace names
    K1's and K2's kernels and the ``train_step`` ranges.

14. the offline preprocessing tools and several processes, at the same
    full width: (a) a seeded bottom-up TSV of 200 images (10-100 boxes of
    2048-d) and VQA question and annotation JSONs through
    ``create_dictionary``, ``compute_softscore`` and ``feature_converter``
    (without ``h5py`` its named ``ImportError`` asserted and the splits
    written as ``.npz`` from its arrays), then ``ffoe_train`` for 2 epochs
    from that dataroot; (b) ``ffoe_train --coordinator`` at world size 1
    over NCCL against the same run without it (per-step losses within
    1e-6) and an NCCL all-reduce on the card; in two processes on the one
    card joined by gloo over CUDA tensors (NCCL refuses two ranks on one
    device): (c) DDP, 3 deterministic steps of B=256 (128 rows a rank) and
    (d) tp=2 (``d / 2`` = 512 columns a rank for K2, the attention through
    the logits path and K3), each against one process (loss, pre-clip grad
    norm and params within 1e-5), launches per rank, under tp the leaves
    split and those ``fits`` leaves replicated, K2, K3 and the softmax
    backward on the tp path's own inputs against their plain versions, and
    K2 at ``d / 2`` timed (a row of the JSON line with a ``shape``); the
    relative loss and grad-norm differences of 14c-d printed at each step;
    tp=2 on CTI's blockwise path (``v_block_size`` 16, the rank-split
    operands gathered whole, no kernel launched) against one process's
    blockwise steps (1e-5) and its standard ones (1e-4); (e) the
    row-sharded store at 2 ranks, its gathers bit-equal to the replicated
    store's.  Two processes on one card check correctness, not scaling.

15. JAX's ``.orbax`` checkpoints without JAX, orbax or tensorstore
    (:func:`phase15_orbax`): the system's ``libzstd.so.1``; the JAX-written
    goldens of ``tests/torch_orbax_goldens.py`` (a tiny CTI and TanModel,
    orbax's OCDBT layout) served on the card through ``load_params_any``
    and ``InferenceSession`` within 1e-3 (MC 1e-4) of JAX's logits, K1 and
    K2 launched, and a two-process save's split weight bit for bit; two
    full-width CTI steps at B=256, then ``save_checkpoint_orbax`` and
    ``restore_train_state_orbax`` into a fresh state on the card, bit-equal,
    with the bytes and the write and read seconds.

16. the split-bf16 GEMM (``csrc/linear_f32.cu``, :func:`phase16_linear`):
    through ``routed_linear`` and autograd at every cell product the route
    takes (the v-, q- and a-side tuckers, M from 1,024 to 51,200) and
    through ``linear_f32`` at ragged M, N and K: the output, the input
    gradient and the weight gradient each within twice cuBLAS float32's
    largest error against float64 (``F.linear``'s autograd, TF32 off) and
    within twice cuBLAS's distance from the plain version
    (``split_bf16x6_mm``) on the same inputs, one launch of each instance
    counted; the weight gradient bitwise the same over two calls; then
    each instance timed (L2 flushed) beside cuBLAS float32, the plain
    version and the bound (six bf16 products at 989 TFLOP/s; float32 at
    67), and the route's sweep over every float32 product shape of the two
    cells, from which ``ROUTE_MIN_TILES`` is read.  Its own JSON line
    ``{"linear_f32": [...]}``.  Alone: ``import chip_smoke as cs;
    cs.phase16_linear(smi)`` (about 45 s of command time).

K2's backward kernel (``csrc/tri_pool_backward.cu``, on the tensor cores)
adds to the phases: 3c holds it to
``trilinear_pool_grads`` (the four ``torch.bmm`` it replaces) at the
training batch's inputs, ragged V=293, one box, V=2048, D=512 and 1016,
B=0, Q*A=72 and 256, with a sample whose ``w`` is all zero, in float32 and
in both bf16 instances (3b), two calls giving the same bits and a
sample's cotangents the same bits at B=3 as at B=256; at the model's
inputs and wherever it is timed, each float32 cotangent's error against a
float64 ``trilinear_pool_grads`` must be no more than twice the float32
plain version's (cuBLAS in full float32); 4c times it alone (float32, bf16 at both glimpses) and beside the
forward+backward rows puts the forward kernel followed by the four
``torch.bmm`` (``bmm_ms``); 12b does both at Visual7W's shapes and 14 at
tp's D=512 (rows of the JSON line); every training path checks its
launches, one a glimpse a step (BAN and SAN none; the split-bf16 GEMM's
launches are recorded beside them and left out of these checks).

Each path (serving at each wire and compute dtype, the logits path in
float32 and bf16, by-id serving, training in float32 and bf16, each entry
point call of phases 9 to 14 and each rank's steps of 14c-d, the
blockwise tp steps too) is driven with the launch counts set
to 0 just before it and read just after; the kernels' ``launches`` in the
JSON line are their sums.

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
import shutil
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
    the eval, the training part's wall time (to the card's last step,
    synchronised) and the steps' loss tensors.  Returns a function that
    undoes the wrapping."""
    originals = (train_loop.make_train_step, train_loop._make_loader,
                 train_loop.evaluate_ffoe, train_loop.evaluate_mc)
    make_step, make_loader, evaluate, evaluate_mc = originals

    def timed_make_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def timed_step(*a, **kw):
            t = time.perf_counter()
            out = step(*a, **kw)
            record[-1]["step"] += time.perf_counter() - t
            record[-1]["losses"].append(out["loss"])  # read after the run
            return out
        return timed_step

    class TimedLoader:
        def __init__(self, inner):
            self.inner = inner

        def __len__(self):
            return len(self.inner)

        def close(self):
            if hasattr(self.inner, "close"):
                self.inner.close()

        def __iter__(self):
            rec = {"wait": 0.0, "step": 0.0, "eval": 0.0, "losses": []}
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

    def timed(fn):
        def timed_evaluate(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            record[-1]["eval"] += time.perf_counter() - t
            return out
        return timed_evaluate

    train_loop.make_train_step = timed_make_step
    train_loop._make_loader = lambda *a, **kw: TimedLoader(make_loader(*a, **kw))
    train_loop.evaluate_ffoe = timed(evaluate)
    train_loop.evaluate_mc = timed(evaluate_mc)

    def undo():
        (train_loop.make_train_step, train_loop._make_loader,
         train_loop.evaluate_ffoe, train_loop.evaluate_mc) = originals
    return undo


def run_train(label, argv, path_counts, cli=None):
    """``cli.main(argv)`` (``ffoe_train`` by default) with the loop's timers
    on and the launch counts set to 0 just before it; -> (launch counts,
    per-epoch record, wall seconds to the card's last step)."""
    from vqatpu_torch.cli import ffoe_train
    from vqatpu_torch.kernels import trilinear as K
    from vqatpu_torch.train import loop as train_loop

    record = []
    undo = loop_timers(train_loop, record)
    K.reset_launches()
    t = time.perf_counter()
    try:
        (cli or ffoe_train).main(argv)
    finally:
        undo()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    path_counts[label] = counts = dict(K.launches)
    return counts, record, wall


def log_of(path):
    """log.txt's text, train losses, eval scores and seconds an epoch."""
    text = open(path).read()
    losses = [float(x) for x in re.findall(r"train_loss: (\S+),", text)]
    scores = [float(x) / 100 for x in re.findall(r"eval score: (\S+) ", text)]
    secs = [float(x) for x in re.findall(r"epoch \d+, time: (\S+)", text)]
    return text, losses, scores, secs


def phase9(cfg, path_counts, wire_step_ms, card_step_ms) -> dict:
    """The free-form entry points on the card: a dataroot of 1,024 train and
    512 val questions over 256 images (2048-d ``.npz`` features, 10-20
    boxes), 3,129 answers (targets on the first 12); ``ffoe_train`` for 10
    epochs at full width and B=256, a resume for an 11th, ``ffoe_test`` on
    epoch 9 against ``InferenceSession`` on the same checkpoint and rows,
    and 2 epochs at bf16 compute, all with the Python loader and the
    features shipped from the host (``--no_native_loader --device_features
    off``: the Python loader's path, beside phase 10's).  Each call runs with the launch
    counts set to 0 just before it and read just after.  -> what phase 10
    reuses: the dataroot (its ``tmp`` to clean up), the CLI's arguments,
    the checkpoints' directory and the loop's numbers."""
    from vqatpu_torch.cli import ffoe_test
    from vqatpu_torch.data import Dictionary, VQAFeatureDataset
    from vqatpu_torch.data.synthetic import ANSWERS, make_vqa_fixture
    from vqatpu_torch.kernels import trilinear as K
    from vqatpu_torch.serve import InferenceSession
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
    pr6_path = ["--no_native_loader", "--device_features", "off"]
    out = os.path.join(tmp.name, "saved_models", "cti")
    steps = n_train // TRAIN_B
    evals = -(-n_val // (2 * TRAIN_B))

    def run(label, argv):
        return run_train(label, argv + pr6_path, path_counts)

    counts, record, wall = run("ffoe_train", args + [
        "--output", out, "--epochs", str(epochs)])
    text, losses, scores, secs = log_of(os.path.join(out, "log.txt"))
    files = sorted(os.listdir(out))
    print(f"ffoe_train, {epochs} epochs of {steps} steps at B={TRAIN_B} "
          f"(float32) in {wall:.1f} s: losses {losses}; eval scores "
          f"{scores}; files {files}; launches {counts}")
    assert len(losses) == epochs and all(np.isfinite(losses)), losses
    assert {"model_epoch9.ckpt", "model_epoch_best.ckpt"} <= set(files), files
    assert "native loader" not in text and "feature store" not in text
    n_fwd = epochs * (steps + evals)
    assert counts["fused_rank_softmax"] == n_fwd, counts
    assert counts["trilinear_pool"] == cfg.gamma * n_fwd, counts
    assert counts["softmax_vqa_backward"] == epochs * steps, counts
    assert counts["trilinear_pool_backward"] == cfg.gamma * epochs * steps
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
    assert counts["trilinear_pool_backward"] == cfg.gamma * steps, counts

    results = os.path.join(tmp.name, "results")
    K.reset_launches()
    paths = ffoe_test.main(args + pr6_path + [
        "--split", "val", "--input", out, "--epoch", "9", "--results",
        results, "--logits", "1"])
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
    assert counts["trilinear_pool_backward_bf16"] == 2 * cfg.gamma * steps
    assert counts["fused_rank_softmax"] == counts["trilinear_pool"] == 0, counts
    assert counts["trilinear_pool_backward"] == 0, counts
    return {"tmp": tmp, "root": root, "args": args, "out": out,
            "n_train": n_train, "n_val": n_val, "labels": labels}


# host packing of an int8-wire bucket with the numpy quantizer, ms at
# buckets 1 / 8 / 32 / 128: PERF.md section 5's serving table (phase 6,
# H100 80GB HBM3, 700 W), printed beside phase 10c's
NUMPY_INT8_PACK_MS = {1: 0.23, 8: 2.57, 32: 12.83, 128: 118.68}
BIG_STORE_IMAGES = 40_000  # phase 10d, int8-resident: ~2.2M box rows
F32_STORE_IMAGES = 8_000   # phase 10d, float32: ~0.44M box rows
GATHER_BATCHES = 20
LOOP_TOL = 1e-5            # phase 10f: per-step losses, relative
EXPORT_TOL = 1e-6          # phase 10f: ffoe_test logits, store on / off
LOOP_EPOCHS = 4
DEEP_TRAIN, DEEP_VAL, DEEP_IMAGES = 16_384, 512, 2_048  # phase 10g
DEEP_EPOCHS = 3


def host_ms(fn, runs: int = 5) -> float:
    """Median host-clock ms of ``fn`` after one warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase10_host_runtime(cfg) -> None:
    """(a) build the port's C++ host runtime from its source (a fresh build
    into a temporary directory, to show the compiler and its time) and check
    that the library this process loaded is the port's own; (b) the C++
    quantizer against the numpy plain version, bit for bit, with all-zero
    rows (padded boxes) and rows of exact .5 ties, and both times."""
    from vqatpu_torch.data import native
    from vqatpu_torch.data.quantize import quantize_rows as plain_quantize

    cxx = native.compiler()
    version = subprocess.run([cxx, "--version"], check=True,
                             capture_output=True, text=True).stdout
    saved = native.BUILD_DIR
    with tempfile.TemporaryDirectory() as d:
        native.BUILD_DIR = Path(d)
        try:
            t0 = time.perf_counter()
            _, out = native.build()
            t_build = time.perf_counter() - t0
        finally:
            native.BUILD_DIR = saved
    native.load()
    with open("/proc/self/maps") as f:
        libs = sorted({ln.split()[-1] for ln in f if "libvqadata" in ln})
    print(f"phase 10a: host runtime {native.SOURCE.relative_to(ROOT)} built by "
          f"{cxx} ({version.splitlines()[0]}) with {' '.join(native.CXX_FLAGS)} "
          f"in {t_build:.1f} s (compiler output: {out.strip() or 'none'}); "
          f"loaded: {libs}")
    assert libs and all(Path(x).is_relative_to(ROOT / "vqatpu_torch" / "_build")
                        for x in libs), libs

    rng = np.random.default_rng(11)
    for b in (128, 256):
        shape = (b, V, cfg.v_dim)
        v = (rng.standard_normal(shape, dtype=np.float32)
             * rng.random((b, V, 1), dtype=np.float32) * 30)
        v[:, REAL_BOXES:] = 0.0  # padded boxes: all-zero rows, scale 1
        # box 0: odd integers with absmax 254, so the scale is exactly 2 and
        # every element lands on k + .5 (round half to even)
        ties = 2 * rng.integers(-126, 127, (b, cfg.v_dim)) + 1
        ties[:, 0] = 254
        v[:, 0] = ties
        q, sc = native.quantize_rows(v)
        q_p, sc_p = plain_quantize(v)
        same = np.array_equal(q, q_p) and np.array_equal(sc, sc_p)
        n_ties = int((ties[:, 1:] % 2 == 1).sum())
        assert (sc[:, REAL_BOXES:] == 1).all() and not q[:, REAL_BOXES:].any()
        assert (sc[:, 0] == 2).all()
        t_c = host_ms(lambda: native.quantize_rows(v))
        t_np = host_ms(lambda: plain_quantize(v), runs=3)
        print(f"phase 10b: quantize_rows [{b}, {V}, {cfg.v_dim}] "
              f"({b * (V - REAL_BOXES)} all-zero rows, {n_ties} ties at .5): "
              f"C++ {t_c:.3f} ms (threads for its rows: "
              f"{native.quantize_threads(b * V)}), numpy {t_np:.3f} ms, "
              f"bit-equal {same}")
        assert same, "the C++ quantizer left the numpy plain version"
    # the threads' cost at the serving buckets' sizes: host clock, median
    for b in (1, 8, 32, 128, 256):
        v = rng.standard_normal((b, V, cfg.v_dim), dtype=np.float32)
        cells = ", ".join(
            f"{n} {host_ms(lambda: native.quantize_rows(v, num_threads=n)):.3f}"
            for n in (1, 2, 4, 8))
        print(f"phase 10b: quantize_rows [{b}, {V}, {cfg.v_dim}] ms by "
              f"threads: {cells}; numpy {host_ms(lambda: plain_quantize(v)):.3f}")


def phase10_int8_serving(cfg, model, labels, golden, gb, path_counts) -> None:
    """(c) int8-wire serving at every bucket through the C++ quantizer: the
    golden rows against JAX's float32 logits, each bucket against the
    float32 wire on the same rows, and the host packing with the C++ and
    the numpy quantizer, beside PERF.md's serving table."""
    from vqatpu_torch.data.quantize import quantize_rows as plain_quantize
    from vqatpu_torch.kernels import trilinear as K
    from vqatpu_torch.serve import InferenceSession
    from vqatpu_torch.train import steps as steps_mod
    from vqatpu_torch.weights import numpy_batch

    sess8 = InferenceSession(model, labels, transfer_dtype="int8",
                             device="cuda")
    sess32 = InferenceSession(model, labels, device="cuda")
    K.reset_launches()
    g_err = float(np.abs(sess8.logits(gb["v"], None, gb["q"], gb["a"])
                         - golden["logits"]).max())
    print(f"phase 10c: int8 wire (C++ quantizer) vs JAX's float32 golden "
          f"{g_err:.3e} (tol {SERVE_TOL:.0e})")
    assert g_err <= SERVE_TOL, g_err
    for n in sess8.batch_buckets:
        b = numpy_batch(cfg, n, seed=300 + n, boxes=V, real_boxes=REAL_BOXES)
        got = sess8.logits(b["v"], None, b["q"], b["a"])
        err = float(np.abs(got - sess32.logits(b["v"], None, b["q"],
                                               b["a"])).max())
        assert got.shape == (n, cfg.num_ans_candidates) and err <= SERVE_TOL
        pack_c = host_ms(lambda: sess8.pack(b["v"], b["q"], b["a"]), runs=10)
        cxx_quantize, steps_mod.quantize_rows = (steps_mod.quantize_rows,
                                                 plain_quantize)
        try:
            pack_np = host_ms(lambda: sess8.pack(b["v"], b["q"], b["a"]),
                              runs=10)
        finally:
            steps_mod.quantize_rows = cxx_quantize
        e2e = host_ms(lambda: sess8.logits(b["v"], None, b["q"], b["a"]),
                      runs=10)
        print(f"phase 10c bucket {n}: int8 host packing {pack_c:.3f} ms with "
              f"the C++ quantizer, {pack_np:.3f} ms with numpy in this run "
              f"(PERF.md section 5's table: {NUMPY_INT8_PACK_MS[n]} ms); "
              f"session.logits {e2e:.3f} ms; vs the float32 wire on the same "
              f"rows {err:.3e}")
    torch.cuda.synchronize()
    path_counts["serving int8 (C++ quantizer)"] = dict(K.launches)


class StoreSet:
    """A dataset over a FeatureStore alone, for the loaders and the store:
    sample i is image ``images[i]``, with its index as its one field."""

    def __init__(self, store, images, max_boxes):
        self.store = store
        self.entries = [{"image": int(i)} for i in images]
        self.max_boxes = max_boxes

    def __len__(self):
        return len(self.entries)

    def sample_fields(self, index):
        return {"qid": np.int64(index)}


def seeded_store(n_images, v_dim, seed, int8):
    """A FeatureStore of ``n_images`` images of 10-100 boxes, made on the
    card from ``seed`` and copied to the host a chunk at a time: int8 rows
    with float32 scales (``--quantize_store``), or float32 rows."""
    from vqatpu_torch.data.features import FeatureStore

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_boxes = rng.integers(10, 101, n_images)
    ends = np.cumsum(n_boxes)
    rows = int(ends[-1])
    feats = np.empty((rows, v_dim), np.int8 if int8 else np.float32)
    for lo in range(0, rows, 1 << 16):
        hi = min(rows, lo + (1 << 16))
        if int8:
            x = torch.randint(-127, 128, (hi - lo, v_dim), generator=gen,
                              device="cuda", dtype=torch.int8)
        else:
            x = (torch.randn((hi - lo, v_dim), generator=gen, device="cuda")
                 * torch.rand((hi - lo, 1), generator=gen, device="cuda") * 10)
        feats[lo:hi] = x.cpu().numpy()
    spats = rng.random((rows, 6), dtype=np.float32)
    pos = np.stack([ends - n_boxes, ends], 1)
    scales = (rng.random(rows, dtype=np.float32) * 0.05 + 1e-3) if int8 else None
    return FeatureStore(feats, spats, pos, feat_scales=scales)


def check_gather(ds, store, wire, dev):
    """``GATHER_BATCHES`` shuffled batches at B=256: ``store.gather`` of the
    fields-only loader's ``ds_idx`` against the wire path's batch (the C++
    loader, quantized on assembly on the int8 wire, then ``wire_cast``)
    uploaded to the card, bit for bit; int8 rows under the float32 wire
    are compared dequantized, as the step sees them.  -> medians on CUDA
    events of the gather and of the wire batch's upload, blocking from a
    pageable copy and through the ``PinnedUploader`` (from the C++
    loader's page-locked ring; what it stages, a cast ``b`` and the mask,
    is copied on the host first), and the bytes it staged a batch."""
    from vqatpu_torch.data import BatchLoader
    from vqatpu_torch.data.native import NativeBatchLoader
    from vqatpu_torch.data.upload import PinnedUploader
    from vqatpu_torch.train import wire_cast

    kw = dict(shuffle=True, seed=5, drop_last=True)
    wire_loader = NativeBatchLoader(ds, TRAIN_B, quantize=wire == "int8",
                                    **kw)
    fields = iter(BatchLoader(ds, TRAIN_B, fields_only=True, **kw))
    upload = PinnedUploader(dev)
    dequantize = store.scales is not None and wire != "int8"
    times = {"gather": [], "pageable": [], "pinned": [], "staged": []}

    def timed(key, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times[key].append(start.elapsed_time(end))
        return out

    try:
        for i, wb in enumerate(wire_loader):
            if i == GATHER_BATCHES:
                break
            fb = next(fields)
            assert np.array_equal(wb["qid"], fb["qid"]), "orders differ"
            host = wire_cast({k: wb[k] for k in ("v", "v_scale", "b", "v_mask")
                              if k in wb}, wire)
            pageable = {k: (x.clone() if torch.is_tensor(x) else np.array(x))
                        for k, x in host.items()}
            timed("pageable", lambda: {k: torch.as_tensor(x).to(dev)
                                       for k, x in pageable.items()})
            staged = upload.staged_bytes
            want = timed("pinned", lambda: upload(host))
            times["staged"].append(upload.staged_bytes - staged)
            got = timed("gather", lambda: store.gather(fb["ds_idx"]))
            if dequantize:
                v = got["v"].float() * got["v_scale"][..., None]
                assert torch.equal(v, want["v"]), (wire, i, "v")
                keys = ("b", "v_mask")
            else:
                keys = tuple(want)
            for k in keys:
                assert got[k].dtype == want[k].dtype and torch.equal(
                    got[k], want[k]), (wire, i, k)
    finally:
        wire_loader.close()
    return {k: statistics.median(x) for k, x in times.items()}


def phase10_store(cfg, dev, train_throughput, path_counts, card_step_ms,
                  wire_step_ms) -> None:
    """(d) the card-resident store at a realistic size: a float32 store of
    ``F32_STORE_IMAGES`` images built for every wire and an int8-resident
    store of ``BIG_STORE_IMAGES`` images for the int8 and float32 wires,
    each against the estimate, the ``auto`` decision and 20 batches of the
    wire path; (e) full-width training steps at B=256, dropout on, from
    the float32 store (float32 wire) and from the int8 one (int8 wire)."""
    from vqatpu_torch.data.device_store import (DeviceFeatureStore,
                                                devstore_decision,
                                                estimate_hbm_bytes,
                                                hbm_budget_bytes)
    from vqatpu_torch.data.upload import PinnedUploader
    from vqatpu_torch.weights import numpy_batch

    kept = {}
    for n_images, int8, wires in (
            (F32_STORE_IMAGES, False, ("float32", "float16", "bfloat16",
                                       "int8")),
            (BIG_STORE_IMAGES, True, ("int8", "float32"))):
        t0 = time.perf_counter()
        fs = seeded_store(n_images, cfg.v_dim, seed=21 + int8, int8=int8)
        rng = np.random.default_rng(n_images)
        ds = StoreSet(fs, rng.integers(0, n_images, n_images), V)
        print(f"phase 10d: {'int8-resident' if int8 else 'float32'} store of "
              f"{n_images} images, {fs.features.shape[0]} box rows of "
              f"{cfg.v_dim}-d ({fs.features.nbytes / 2**30:.2f} GiB on the "
              f"host), made in {time.perf_counter() - t0:.1f} s")
        for wire in wires:
            est = estimate_hbm_bytes(ds, wire)
            budget, src = hbm_budget_bytes(dev)
            build, why = devstore_decision(ds, "auto", wire, device=dev)
            t0 = time.perf_counter()
            store = DeviceFeatureStore.build(ds, transfer_dtype=wire,
                                             device=dev)
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t0
            row = sum(t[0].numel() * t.element_size() for t in
                      (store.feats, store.scales, store.spats) if t is not None)
            t = check_gather(ds, store, wire, dev)
            print(f"phase 10d {'int8' if int8 else 'f32'} store, {wire} wire: "
                  f"{store.describe()}, built in {t_build:.1f} s; "
                  f"estimate_hbm_bytes {est} vs hbm_bytes {store.hbm_bytes} "
                  f"(the sentinel row {row}); auto: build={build} {why} "
                  f"(budget {budget / 2**30:.2f} GiB, {src}); "
                  f"{GATHER_BATCHES} batches of {TRAIN_B} bit-equal to the "
                  f"wire path; gather {t['gather']:.3f} ms, the wire batch's "
                  f"upload {t['pageable']:.3f} ms blocking from pageable "
                  f"memory, {t['pinned']:.3f} ms through the PinnedUploader "
                  f"({t['staged'] / 1e6:.3f} MB staged a batch) (CUDA "
                  f"events, medians)")
            assert build and store.hbm_bytes == est + row
            if (int8, wire) in ((False, "float32"), (True, "int8")):
                kept[(int8, wire)] = (ds, store)
            else:
                del store
        del fs
    torch.cuda.empty_cache()

    fields = [{k: x for k, x in numpy_batch(cfg, TRAIN_B, seed=1000 + i,
                                            boxes=1, real_boxes=1,
                                            target=True).items() if k != "v"}
              for i in range(ITERS)]
    rng = np.random.default_rng(7)
    for (int8, wire), (ds, store) in kept.items():
        upload = PinnedUploader(dev)
        order = [rng.integers(0, len(ds), TRAIN_B) for _ in range(ITERS)]
        calls = iter(range(10 ** 9))

        def next_batch():
            i = next(calls) % ITERS
            db = upload(fields[i])
            db.update(store.gather(order[i]))
            return db

        label = (f"B={TRAIN_B}, from the {'int8' if int8 else 'float32'} "
                 f"store ({wire} wire)")
        print(f"phase 10e {label}: the host's time to enqueue a batch (medians "
              f"of 20): the fields' upload (q, a, target [{TRAIN_B}, "
              f"{cfg.num_ans_candidates}] float32, staged) "
              f"{host_ms(lambda: upload(fields[0]), runs=20):.3f} ms, the "
              f"gather {host_ms(lambda: store.gather(order[0]), runs=20):.3f} ms")
        counts, n_steps, step_ms = train_throughput(
            label, next_batch, windows=3, transfer_dtype=wire)
        path_counts[f"training from the store ({wire})"] = counts
        assert counts["fused_rank_softmax"] == n_steps, counts
        assert counts["softmax_vqa_backward"] == n_steps, counts
        assert counts["trilinear_pool_backward"] == cfg.gamma * n_steps, counts
        print(f"phase 10e {label}: {TRAIN_B / step_ms * 1e3:.1f} samples/s at "
              f"the median step, against phase 8b's {TRAIN_B / card_step_ms * 1e3:.1f} "
              f"with the batch on the card and 8c's "
              f"{TRAIN_B / wire_step_ms[wire] * 1e3:.1f} from a host batch "
              f"({wire} wire)")
    del kept


def three_loaders(tag, path_counts, args, out_root, n_train, n_val,
                  epochs) -> None:
    """``ffoe_train`` for ``epochs`` epochs three ways: (i) the defaults
    (the C++ loader and the card-resident store, ``auto``), (ii) the C++
    loader with ``--device_features off`` (page-locked uploads), (iii)
    phase 9's Python loader; seconds an epoch, samples/s and the loader's
    share of the training part (means of the epochs after the first), and
    the per-step losses of (i) and (ii) against (iii)'s."""
    steps, evals = n_train // TRAIN_B, -(-n_val // (2 * TRAIN_B))
    runs = {"(iii) Python loader": ["--no_native_loader", "--device_features",
                                    "off"],
            "(ii) C++ loader, --device_features off": ["--device_features",
                                                       "off"],
            "(i) C++ loader and the store (defaults)": []}
    losses = {}
    for label, extra in runs.items():
        out = os.path.join(out_root, label[1:label.index(")")])
        counts, record, wall = run_train(
            f"ffoe_train {label} ({tag})", args + extra + [
                "--output", out, "--epochs", str(epochs)], path_counts)
        text, _, _, secs = log_of(os.path.join(out, "log.txt"))
        losses[label] = np.array([float(x) for r in record
                                  for x in r["losses"]])
        rest = record[1:]
        train_s = statistics.mean(r["train"] for r in rest)
        wait_s = statistics.mean(r["wait"] for r in rest)
        step_s = statistics.mean(r["step"] for r in rest)
        decided = [ln for ln in text.splitlines()
                   if "feature store" in ln or "native loader" in ln]
        print(f"phase {tag} {label}: {statistics.mean(secs[1:]):.3f} s an "
              f"epoch (log.txt, epochs 1-{epochs - 1}, {steps} steps each); "
              f"training "
              f"{train_s:.3f} s ({steps * TRAIN_B / train_s:.1f} samples/s), "
              f"the loader {wait_s:.3f} s ({wait_s / train_s:.1%}), the host "
              f"in step calls {step_s:.3f} s ({step_s / train_s:.1%}); "
              f"{wall:.1f} s in all; log: {decided}; launches {counts}")
        assert counts["fused_rank_softmax"] == epochs * (steps + evals)
        assert counts["trilinear_pool_backward"] == CFG["gamma"] * epochs * steps
        assert len(losses[label]) == epochs * steps
        if label.startswith("(i)"):
            assert any(ln.startswith("device feature store: ")
                       for ln in decided), decided
            assert any(ln.startswith("eval device feature store: ")
                       for ln in decided), decided
        else:
            assert not decided, decided
    want = losses["(iii) Python loader"]
    for label in list(runs)[1:]:
        err = float(np.max(np.abs(losses[label] - want) / np.abs(want)))
        print(f"phase {tag} per-step losses, {label} vs (iii): largest "
              f"relative difference {err:.3e} over {len(want)} steps (tol "
              f"{LOOP_TOL:.0e})")
        assert err <= LOOP_TOL, (label, err)


def phase10_loop(cfg, path_counts, p9) -> None:
    """(f) ``ffoe_train`` on phase 9's dataroot and widths for
    ``LOOP_EPOCHS`` epochs three ways (:func:`three_loaders`).  Then
    ``ffoe_test`` on phase 9's epoch-9 checkpoint with
    ``--device_features on`` and ``off`` (and epoch 10 with it on), and
    ``vqatpu_torch.cli.ensemble`` on two of the exported logit files."""
    from vqatpu_torch.cli import ensemble, ffoe_test

    n_val = p9["n_val"]
    three_loaders("10f", path_counts, p9["args"],
                  os.path.join(p9["tmp"].name, "loop"), p9["n_train"], n_val,
                  LOOP_EPOCHS)
    exported = {}
    for name, epoch, mode in (("on", "9", "on"), ("off", "9", "off"),
                              ("on10", "10", "on")):
        results = os.path.join(p9["tmp"].name, f"results_{name}")
        paths = ffoe_test.main(p9["args"] + [
            "--split", "val", "--input", p9["out"], "--epoch", epoch,
            "--results", results, "--logits", "1", "--device_features",
            mode])
        with np.load(paths["raw_logits"]) as z:
            exported[name] = (paths["raw_logits"], z["logits"],
                              z["question_ids"])
    e_dev = float(np.abs(exported["on"][1] - exported["off"][1]).max())
    print(f"phase 10f ffoe_test --device_features on vs off (epoch 9): "
          f"{exported['on'][1].shape} logits, max_abs_err {e_dev:.3e} (tol "
          f"{EXPORT_TOL:.0e})")
    assert e_dev <= EXPORT_TOL and np.array_equal(exported["on"][2],
                                                  exported["off"][2])
    results = os.path.join(p9["tmp"].name, "results_ensemble")
    paths = ensemble.main(["--inputs", exported["on"][0], exported["on10"][0],
                           "--dataroot", p9["root"], "--split", "val",
                           "--results", results, "--name", "epochs9_10",
                           "--teacher_pkl"])
    with open(paths["json"]) as f:
        answers = json.load(f)
    mean = (exported["on"][1] + exported["on10"][1]) / 2
    qids = exported["on"][2]
    expect = {int(q): p9["labels"][int(x.argmax())] for q, x in zip(qids, mean)}
    agree = sum(expect[a["question_id"]] == a["answer"] for a in answers)
    print(f"phase 10f ensemble of epochs 9 and 10: {len(answers)} answers in "
          f"{os.path.basename(paths['json'])}, {agree} equal to the argmax of "
          f"the mean logits; teacher pkl {os.path.basename(paths['teacher_logits'])}")
    assert len(answers) == n_val and agree == n_val


def phase10_depth(cfg, path_counts, p9) -> None:
    """(g) The loop's loader wait at depth: :func:`three_loaders` on a
    dataroot of ``DEEP_TRAIN`` train questions over ``DEEP_IMAGES`` images
    (phase 9's widths and box counts), ``DEEP_EPOCHS`` epochs of 64 steps,
    where phase 10f's 4 steps an epoch are dominated by each epoch's start."""
    from vqatpu_torch.data.synthetic import make_vqa_fixture

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    try:
        root = os.path.join(tmp.name, "data_vqa")
        make_vqa_fixture(root, n_train=DEEP_TRAIN, n_val=DEEP_VAL,
                         n_images=DEEP_IMAGES, v_dim=cfg.v_dim, seed=1)
        for name in ("trainval_ans2label.pkl", "trainval_label2ans.pkl"):
            shutil.copy(os.path.join(p9["root"], "cache", name),
                        os.path.join(root, "cache", name))
        print(f"phase 10g dataroot: {DEEP_TRAIN} train and {DEEP_VAL} val "
              f"questions over {DEEP_IMAGES} images, made in "
              f"{time.perf_counter() - t0:.1f} s")
        args = list(p9["args"])
        args[args.index("--dataroot") + 1] = root
        three_loaders("10g", path_counts, args, os.path.join(tmp.name, "loop"),
                      DEEP_TRAIN, DEEP_VAL, DEEP_EPOCHS)
    finally:
        tmp.cleanup()


# phase 11: BAN (with the counter) and SAN at the full width of bench.py
BAN_CFG = dict(CFG, model="ban", use_counter=True)  # objects=10, gamma=2
SAN_CFG = dict(CFG, model="san", num_stacks=2)
BYID_IMAGES = 300   # phase 11b's by-id store
KD_EPOCHS = 10      # phase 11d: epoch 9 is the first checkpoint (saving_epoch)


def bf16_error(got, golden16, golden32):
    """-> (each sample's largest error of ``got`` against JAX's float32
    logits, the budget: 2x JAX's own largest bf16 error plus 1e-4)."""
    err = np.abs(got - golden32).max(1)
    return err, BF16_BUDGET * float(np.abs(golden16 - golden32).max()) + 1e-4


def counter_counts(model, fn):
    """Run ``fn`` and return the soft count of each of ``model``'s counter
    calls (one per glimpse), [G, B] float64: its output is the confidence
    times the one-hot interpolated between the count's two bins, so the
    count is the output's mean bin."""
    counts = []

    def hook(module, args, out):
        o = out.detach().double().cpu()
        k = torch.arange(o.shape[1], dtype=torch.float64)
        counts.append(((o * k).sum(1) / o.sum(1)).numpy())

    handle = model.counter.register_forward_hook(hook)
    try:
        fn()
    finally:
        handle.remove()
    return np.stack(counts)


def check_ban_counter_bf16(mcfg, cpu_model, labels, sess16, z) -> None:
    """BAN with the counter at bf16 on the B=32 golden ``z``, served (``b``
    bf16) and through the eval step (``b`` float32), every sample within
    the budget.  The soft count is ill-conditioned at bf16 in both
    packages (tests/test_torch_ban.py): B=4 gives too few samples of
    JAX's own error to set the budget.  A sample over it is printed with
    its count per glimpse on the card and, alone, on the CPU at bf16 and
    at float32 (``cpu_model``, float32 on the CPU)."""
    from vqatpu_torch.serve import InferenceSession
    from vqatpu_torch.train import make_eval_step
    from vqatpu_torch.weights import numpy_batch

    assert (int(z["n"]), int(z["param_seed"])) == (32, 0), "other golden"
    gb = numpy_batch(mcfg, 32, seed=int(z["batch_seed"]), boxes=V,
                     real_boxes=REAL_BOXES)
    dev_model = copy.deepcopy(cpu_model).to("cuda").eval()
    cpu16 = InferenceSession(cpu_model, labels, compute_dtype="bfloat16",
                             device="cpu")
    cpu32 = InferenceSession(cpu_model, labels, device="cpu")

    def served(sess, rows):
        return sess.logits(gb["v"][rows], gb["b"][rows], gb["q"][rows])

    def evaluated(model, rows):
        batch = {k: x[rows] for k, x in gb.items()}
        return make_eval_step(model, compute_dtype="bfloat16")(batch)[
            "logits"].float().cpu().numpy()

    paths = (  # label, card model, card run, CPU bf16 model, CPU bf16 run
        ("served", sess16.model, lambda r: served(sess16, r), cpu16.model,
         lambda r: served(cpu16, r), z["logits_bf16"]),
        ("eval step", dev_model, lambda r: evaluated(dev_model, r),
         cpu_model, lambda r: evaluated(cpu_model, r), z["logits_eval"]))
    everything = slice(None)
    for label, card, run, cpu_card, cpu_run, golden16 in paths:
        got = []
        counts = counter_counts(card, lambda: got.append(run(everything)))
        err, bound = bf16_error(got[0], golden16, z["logits"])
        over = np.flatnonzero(err > bound)
        print(f"phase 11a ban {label} at bf16 (B=32): vs JAX's float32 "
              f"golden largest {err.max():.3e}, median {np.median(err):.3e}; "
              f"samples over the budget {bound:.3e} (2 x JAX's own largest "
              f"bf16 error + 1e-4): {over.tolist()}")
        for i in over:
            rows = slice(i, i + 1)
            c16 = counter_counts(cpu_card, lambda: cpu_run(rows))[:, 0]
            c32 = counter_counts(cpu_model, lambda: served(cpu32, rows))[:, 0]
            print(f"phase 11a ban {label} sample {i}: error {err[i]:.3e}; "
                  f"soft count per glimpse: card bf16 "
                  f"{np.round(counts[:, i], 4).tolist()}, CPU bf16 "
                  f"{np.round(c16, 4).tolist()}, CPU float32 "
                  f"{np.round(c32, 4).tolist()}")
        assert np.isfinite(got[0]).all() and over.size == 0, (
            label, over, err[over], bound)
    del dev_model


# the split-bf16 GEMM's instances in the launch counts
GEMM_KERNELS = ("linear_f32", "linear_f32_wgrad", "linear_f32_dgrad")


def cti_kernels(counts: dict) -> dict:
    """``counts`` without the split-bf16 GEMM's launches, which any model's
    large float32 products make (BAN's v-projection among them)."""
    return {k: v for k, v in counts.items() if k not in GEMM_KERNELS}


def zero_launches(label, path_counts):
    """The launch counts of a phase-11 path, which runs none of the CTI
    kernels: recorded beside the other paths (the split-bf16 GEMM's
    included) and checked to be zero for the CTI kernels."""
    from vqatpu_torch.kernels import trilinear as K
    torch.cuda.synchronize()
    path_counts[label] = counts = dict(K.launches)
    assert sum(cti_kernels(counts).values()) == 0, (label, counts)


def phase11_logits(path_counts) -> dict:
    """(a) Full-width BAN (with the counter, and without it) and SAN from
    ``numpy_params(cfg, 0)`` at B=4 on the card: every wire at float32
    compute against the port's CPU path on the same wire and the float32
    wire against JAX's float32 golden (``SERVE_TOL``); bf16 compute within
    the budget of JAX's bf16 golden (served: ``b`` bf16), BAN with the
    counter on the B=32 golden (:func:`check_ban_counter_bf16`).  -> the
    served models' config, model, labels and float32 and bf16 sessions."""
    from vqatpu_torch.config import ModelConfig
    from vqatpu_torch.kernels import trilinear as K
    from vqatpu_torch.models import build_model
    from vqatpu_torch.serve import InferenceSession
    from vqatpu_torch.weights import load_jax_params, numpy_batch, numpy_params

    data = ROOT / "tests" / "data"
    ban, ban16 = np.load(data / "torch_ban_golden.npz"), np.load(
        data / "torch_ban_golden_bf16.npz")
    z32 = np.load(data / "torch_ban_golden_bf16_n32.npz")
    san = np.load(data / "torch_san_golden.npz")
    cases = (  # name, config, float32 golden, bf16 golden, seeds' file
        ("ban", BAN_CFG, ban["logits"], ban16["logits"], ban),
        ("ban without the counter", dict(BAN_CFG, use_counter=False),
         ban["logits_nocounter"], ban16["logits_nocounter"], ban),
        ("san", SAN_CFG, san["logits"], san["logits_bf16"], san))
    out = {}
    for name, kw, golden32, golden16, z in cases:
        mcfg = ModelConfig(**kw)
        assert int(z["param_seed"]) == 0, "golden made from other weights"
        params = numpy_params(mcfg, 0)
        model = load_jax_params(build_model(mcfg), params)
        labels = [f"ans{i}" for i in range(mcfg.num_ans_candidates)]
        gb = numpy_batch(mcfg, int(z["n"]), seed=int(z["batch_seed"]),
                         boxes=V, real_boxes=REAL_BOXES)
        args = (gb["v"], gb["b"], gb["q"])
        cpu_model = load_jax_params(build_model(mcfg), params)
        K.reset_launches()
        sessions = {}
        for wire in ("float32", "float16", "bfloat16", "int8"):
            sess = InferenceSession(model, labels, transfer_dtype=wire,
                                    device="cuda")
            sessions[wire] = sess
            got = sess.logits(*args)
            cpu = InferenceSession(cpu_model, labels, transfer_dtype=wire,
                                   device="cpu").logits(*args)
            assert got.shape == cpu.shape and np.isfinite(got).all()
            e_gold = float(np.abs(got - golden32).max())
            e_cpu = float(np.abs(got - cpu).max())
            # a narrowed wire changes the inputs: held to the CPU path on the
            # same wire, the float32 wire to JAX's golden as well
            print(f"phase 11a {name} wire={wire}: vs the CPU path on the same "
                  f"wire {e_cpu:.3e} (tol {SERVE_TOL:.0e}); vs JAX's float32 "
                  f"golden {e_gold:.3e}"
                  + (f" (tol {SERVE_TOL:.0e})" if wire == "float32" else
                     " (the wire's rounding of v and b)"))
            assert e_cpu <= SERVE_TOL, e_cpu
            assert wire != "float32" or e_gold <= SERVE_TOL, e_gold
        sess16 = InferenceSession(model, labels, compute_dtype="bfloat16",
                                  device="cuda")
        if name == "ban":
            check_ban_counter_bf16(mcfg, cpu_model, labels, sess16, z32)
        else:
            got16 = sess16.logits(*args)
            err, bound = bf16_error(got16, golden16, golden32)
            print(f"phase 11a {name} served at bf16: vs JAX's float32 golden "
                  f"{err.max():.3e} (budget {bound:.3e}: 2 x JAX's own "
                  f"largest bf16 error + 1e-4)")
            assert np.isfinite(got16).all() and err.max() <= bound, (
                err.max(), bound)
        zero_launches(f"phase 11a {name}", path_counts)
        if name in ("ban", "san"):
            out[name] = (mcfg, model, labels, sessions["float32"], sess16)
    return out


def phase11_serving(models, path_counts, median_ms) -> None:
    """(b) BAN over HTTP (JSON and npz ``/answer`` and ``/logits`` of 1, 5
    and 40 rows with spatials and no answer tokens) against the session and
    the CPU path; by-id serving from a card-resident store of
    ``BYID_IMAGES`` images (float32 and int8 tables, the spatials gathered
    on the card); every bucket of BAN and SAN at float32 and bf16 timed end
    to end (host clock) and on the card (CUDA events)."""
    from vqatpu_torch.cli.serve import serve_in_thread
    from vqatpu_torch.data import Dictionary
    from vqatpu_torch.data.features import FeatureStore
    from vqatpu_torch.data.quantize import quantize_rows
    from vqatpu_torch.kernels import trilinear as K
    from vqatpu_torch.serve import InferenceSession, ResidentFeatures
    from vqatpu_torch.weights import numpy_batch

    mcfg, model, labels, session, _ = models["ban"]
    cpu = InferenceSession(copy.deepcopy(model).cpu(), labels, device="cpu")
    dictionary = Dictionary()
    dictionary.tokenize("what color is the cat how many people", add_word=True)
    K.reset_launches()
    server = serve_in_thread(session, dictionary, "ban", 0)
    port = server.server_address[1]
    try:
        for n in (1, 5, 40):
            b = numpy_batch(mcfg, n, seed=1100 + n, boxes=V,
                            real_boxes=REAL_BOXES)
            arrays = {"features": b["v"], "spatials": b["b"],
                      "question_tokens": b["q"]}
            as_json = {k: x.tolist() for k, x in arrays.items()}
            direct = session.logits(b["v"], b["b"], b["q"])
            want = cpu.logits(b["v"], b["b"], b["q"])
            served = [np.asarray(post(port, "/logits", arrays, npz=True)["logits"]),
                      np.asarray(post(port, "/logits", as_json)["logits"])]
            answers = [post(port, "/answer", arrays, npz=True)["answers"],
                       post(port, "/answer", as_json)["answers"]]
            expect = [labels[i] for i in direct.argmax(1)]
            assert all(a == expect for a in answers), (n, answers, expect)
            err = max(float(np.abs(x - want).max()) for x in served + [direct])
            print(f"phase 11b BAN over HTTP, n={n}: {len(expect)} answers "
                  f"agree; served vs CPU logits max_abs_err {err:.3e} (tol "
                  f"{SERVE_TOL:.0e})")
            assert err <= SERVE_TOL, err
    finally:
        server.shutdown()
        server.server_close()
    zero_launches("phase 11b BAN over HTTP", path_counts)

    gen = np.random.default_rng(11)
    n_boxes = gen.integers(10, 101, BYID_IMAGES)
    ends = np.cumsum(n_boxes)
    corners = np.sort(gen.random((int(ends[-1]), 2, 2), dtype=np.float32), -1)
    spats = np.concatenate([corners[..., 0], corners[..., 1],
                            corners[..., 1] - corners[..., 0]], 1)
    store = FeatureStore(gen.standard_normal((int(ends[-1]), mcfg.v_dim),
                                             dtype=np.float32), spats,
                         np.stack([ends - n_boxes, ends], 1))
    img_ids = 200_000 + np.arange(BYID_IMAGES)
    rf = ResidentFeatures(store, {int(i): k for k, i in enumerate(img_ids)},
                          max_boxes=V)
    ids = gen.choice(img_ids, 128, replace=False)
    q_id = numpy_batch(mcfg, 128, seed=1200, boxes=1, real_boxes=1)["q"]
    byid = InferenceSession(model, labels, device="cuda")
    K.reset_launches()
    for quantize in (False, True):
        byid.attach_features(rf, placement="device", quantize=quantize)
        worst = 0.0
        for n in (1, 5, 40, 128):
            got = byid.logits_by_id(ids[:n], q_id[:n])
            v_g, b_g = rf.gather(ids[:n])
            if quantize:  # the rows as the int8 tables hold them
                q8, scale = quantize_rows(v_g)
                v_g = q8.astype(np.float32) * scale[..., None]
            want = session.logits(v_g, b_g, q_id[:n])
            worst = max(worst, float(np.abs(got - want).max()))
        print(f"phase 11b BAN by id, {'int8' if quantize else 'float32'} tables "
              f"on the card: vs the upload path on the same rows and spatials, "
              f"max_abs_err {worst:.3e} (tol {BYID_TOL:.0e})")
        assert worst <= BYID_TOL, worst
    for n in byid.batch_buckets:  # int8 tables
        e2e = median_ms(lambda: byid.logits_by_id(ids[:n], q_id[:n]),
                        on_card=False)
        rows_d, q_d = (torch.from_numpy(x).cuda() for x in (
            byid._rows_table[rf.image_index(ids[:n])], q_id[:n]))
        on_card = median_ms(lambda: byid.forward_by_id(rows_d, q_d),
                            on_card=True)
        print(f"phase 11b BAN by-id bucket {n} (int8 tables): logits_by_id "
              f"{e2e:.3f} ms ({n / e2e * 1e3:.0f} rows/s); on the card: "
              f"gather, dequantize and forward {on_card:.3f} ms")
    zero_launches("phase 11b BAN by id", path_counts)
    del byid, rf, store

    K.reset_launches()
    for name, (mcfg, _, _, sess32, sess16) in models.items():
        for compute, sess in (("float32", sess32), ("bfloat16", sess16)):
            for n in sess.batch_buckets:
                b = numpy_batch(mcfg, n, seed=1300 + n, boxes=V,
                                real_boxes=REAL_BOXES)
                e2e = median_ms(lambda: sess.logits(b["v"], b["b"], b["q"]),
                                on_card=False)
                host, _ = sess.pack(b["v"], b["q"], b=b["b"])
                dev_b = sess.upload(host)
                fwd = median_ms(lambda: sess.forward(dev_b), on_card=True)
                print(f"phase 11b {name} bucket {n} compute={compute}: "
                      f"session.logits {e2e:.3f} ms ({n / e2e * 1e3:.0f} "
                      f"rows/s); forward on the card {fwd:.3f} ms")
    zero_launches("phase 11b serving buckets", path_counts)


def phase11_train_step_rate(label, mcfg, db, compute_dtype, profile_table,
                            distillation=True, mc_scoring=False):
    """Samples/s of the train step at B=256 with dropout on (windows of
    ITERS steps, each ending in a value readback), the median step on CUDA
    events, and from a ``torch.profiler`` trace of 3 steps the card's busy
    and idle share; with ``profile_table`` the ten costliest CUDA ops.
    -> (median step ms, idle share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vqatpu_torch.config import TrainConfig
    from vqatpu_torch.models import build_model
    from vqatpu_torch.train import make_train_state, make_train_step

    state = make_train_state(build_model(mcfg), seed=0, device="cuda")
    step = make_train_step(state.model, TrainConfig(
        update_freq=1, batch_size=TRAIN_B, distillation=distillation,
        compute_dtype=compute_dtype), mc_scoring=mc_scoring)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for _ in range(WARMUP):
        m = step(state, db, 1e-3, gen)
    float(m["loss"])
    thr, events = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = step(state, db, 1e-3, gen)
            end.record()
            events.append((start, end))
        loss = float(m["loss"])
        thr.append(TRAIN_B * ITERS / (time.perf_counter() - t0))
    torch.cuda.synchronize()
    step_ms = statistics.median(s.elapsed_time(e) for s, e in events)
    assert np.isfinite(loss), loss
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(state, db, 1e-3, gen)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    busy = sum(e.self_device_time_total for e in averages
               if e.device_type == DeviceType.CUDA) / 1e3 / 3
    print(f"{label}: {statistics.median(thr):.1f} samples/s "
          f"(median of 3 windows of {ITERS} steps, best {max(thr):.1f}); median "
          f"step on CUDA events {step_ms:.3f} ms; kernels on the card "
          f"{busy:.3f} ms a step ({busy / step_ms:.1%}, idle "
          f"{1 - busy / step_ms:.1%}); last loss {loss:.3f}")
    if profile_table:
        print(f"torch.profiler, 3 training steps, {label} (times summed over "
              "them):")
        print(averages.table(sort_by="self_device_time_total", row_limit=10))
    return step_ms, 1 - busy / step_ms


def phase11_training(models, path_counts) -> None:
    """(c) Three deterministic steps at B=4 for BAN with the counter and
    distillation against JAX's golden trajectory
    ``tests/data/torch_ban_train_golden.npz`` and the CPU path (TRAIN_TOL);
    then B=256 with dropout on for BAN and SAN, float32 and bf16."""
    from vqatpu_torch.config import TrainConfig
    from vqatpu_torch.kernels import trilinear as K
    from vqatpu_torch.models import build_model
    from vqatpu_torch.train import make_train_state, make_train_step
    from vqatpu_torch.weights import (jax_params_from_torch, numpy_batch,
                                      param_stats)

    mcfg = models["ban"][0]
    tg = np.load(ROOT / "tests" / "data" / "torch_ban_train_golden.npz")
    n, steps, lr = int(tg["n"]), int(tg["steps"]), float(tg["lr"])
    batches = [numpy_batch(mcfg, n, seed=int(tg["batch_seed"]) + i,
                           target=True, teacher=True) for i in range(steps)]
    K.reset_launches()
    traj = {}
    for device in ("cuda", "cpu"):
        state = make_train_state(build_model(mcfg), seed=int(tg["param_seed"]),
                                 device=device)
        step = make_train_step(state.model, TrainConfig(
            update_freq=1, deterministic=True, distillation=True))
        metrics = [step(state, b, lr) for b in batches]
        rec = {k: np.array([float(m[k]) for m in metrics])
               for k in ("loss", "grad_norm", "batch_score")}
        stats = param_stats(jax_params_from_torch(state.model.state_dict()))
        rec.update({f"param_{k}": v for k, v in stats.items()})
        traj[device] = rec
        if device == "cuda":
            zero_launches("phase 11c BAN trajectory", path_counts)
        del state, step, metrics

    def err(got, want):
        assert (got["param_names"] == want["param_names"]).all()
        e = max(float(np.max(np.abs(got[k] - want[k]) / np.abs(want[k])))
                for k in ("loss", "grad_norm", "param_l2", "param_l1"))
        return max(e, float(np.max(np.abs(got["param_sum"] - want["param_sum"])
                                   / want["param_l1"])))

    golden = {k: tg[k] for k in tg.files}
    e_gold, e_cpu = err(traj["cuda"], golden), err(traj["cuda"], traj["cpu"])
    print(f"phase 11c BAN (counter, distillation) trajectory, {steps} steps at "
          f"B={n}, lr {lr}: loss {traj['cuda']['loss'].tolist()}, grad_norm "
          f"{traj['cuda']['grad_norm'].tolist()}; largest relative error vs "
          f"JAX's golden {e_gold:.3e}, vs the CPU path {e_cpu:.3e} (tol "
          f"{TRAIN_TOL:.0e}; per-step metrics, per-leaf norms and sums of "
          f"{len(golden['param_names'])} leaves)")
    assert e_gold <= TRAIN_TOL and e_cpu <= TRAIN_TOL, (e_gold, e_cpu)

    for name, (mcfg, *_rest) in models.items():
        batch = numpy_batch(mcfg, TRAIN_B, seed=0, target=True, teacher=True)
        batch["v_mask"] = np.abs(batch["v"]).sum(-1) != 0
        db = {k: torch.from_numpy(x).cuda() for k, x in batch.items()}
        K.reset_launches()
        for compute in ("float32", "bfloat16"):
            phase11_train_step_rate(
                f"phase 11c training {name.upper()} B={TRAIN_B}, "
                f"compute_dtype={compute}, "
                "distillation, batch on the card", mcfg, db, compute,
                profile_table=(name == "ban" and compute == "float32"))
        zero_launches(f"phase 11c {name} training", path_counts)
        del db


def phase11_kd_loop(path_counts, p9) -> None:
    """(d) The distillation loop through the CLIs on phase 9's dataroot and
    widths: phase 9's CTI run (``ffoe_train --model cti``, 10 epochs) is
    the teacher; ``ffoe_test --split train`` writes its logits, which
    ``ffoe_train --model ban --use_counter --distillation`` reads from the
    dataroot three ways (the Python loader, the C++ loader, the store;
    per-step losses within LOOP_TOL); ``ffoe_test --model ban`` on epoch 9
    writes the EvalAI JSON."""
    from vqatpu_torch.cli import ffoe_test
    from vqatpu_torch.kernels import trilinear as K

    root, tmp = p9["root"], p9["tmp"].name
    K.reset_launches()
    t0 = time.perf_counter()
    paths = ffoe_test.main(p9["args"] + [
        "--split", "train", "--input", p9["out"], "--epoch", "9",
        "--results", os.path.join(tmp, "teacher")])
    torch.cuda.synchronize()
    path_counts["phase 11d ffoe_test cti --split train"] = dict(K.launches)
    with open(paths["teacher_logits"], "rb") as f:
        teacher = pickle.load(f)
    shutil.copy(paths["teacher_logits"],
                os.path.join(root, "train_teacher_logits.pkl"))
    print(f"phase 11d teacher: ffoe_test --model cti --split train wrote "
          f"{len(teacher)} logits in {time.perf_counter() - t0:.1f} s")
    assert len(teacher) == p9["n_train"]

    args = list(p9["args"])
    args[args.index("--model") + 1] = "ban"
    args += ["--use_counter", "--distillation"]
    steps = p9["n_train"] // TRAIN_B
    runs = {"(iii) Python loader": ["--no_native_loader", "--device_features",
                                    "off"],
            "(ii) C++ loader": ["--device_features", "off"],
            "(i) C++ loader and the store (defaults)": []}
    losses = {}
    for label, extra in runs.items():
        out = os.path.join(tmp, "ban_kd", label[1:label.index(")")])
        counts, record, wall = run_train(
            f"phase 11d ffoe_train ban {label}", args + extra + [
                "--output", out, "--epochs", str(KD_EPOCHS)], path_counts)
        text, log_losses, scores, secs = log_of(os.path.join(out, "log.txt"))
        losses[label] = np.array([float(x) for r in record
                                  for x in r["losses"]])
        rest = record[1:]
        train_s = statistics.mean(r["train"] for r in rest)
        wait_s = statistics.mean(r["wait"] for r in rest)
        print(f"phase 11d ffoe_train --model ban --use_counter --distillation "
              f"{label}: {KD_EPOCHS} epochs of {steps} steps in {wall:.1f} s, "
              f"{statistics.mean(secs[1:]):.3f} s an epoch (log.txt); training "
              f"{steps * TRAIN_B / train_s:.1f} samples/s, the loader "
              f"{wait_s / train_s:.1%}; losses {log_losses}; eval {scores}")
        assert sum(cti_kernels(counts).values()) == 0, counts
        assert len(losses[label]) == KD_EPOCHS * steps
        assert all(np.isfinite(losses[label]))
        assert ("device feature store: " in text) == label.startswith("(i)")
    want = losses["(iii) Python loader"]
    for label in list(runs)[1:]:
        e = float(np.max(np.abs(losses[label] - want) / np.abs(want)))
        print(f"phase 11d per-step losses, {label} vs (iii): largest relative "
              f"difference {e:.3e} over {len(want)} steps (tol {LOOP_TOL:.0e})")
        assert e <= LOOP_TOL, (label, e)

    K.reset_launches()
    paths = ffoe_test.main(args[:-1] + [
        "--split", "val", "--input", os.path.join(tmp, "ban_kd", "i"),
        "--epoch", "9", "--results", os.path.join(tmp, "results_ban")])
    zero_launches("phase 11d ffoe_test ban", path_counts)
    with open(paths["json"]) as f:
        answers = json.load(f)
    print(f"phase 11d ffoe_test --model ban --use_counter: {len(answers)} "
          f"EvalAI answers in {os.path.basename(paths['json'])}; no teacher "
          f"pkl ({sorted(paths)})")
    assert len(answers) == p9["n_val"] and set(paths) == {"json"}


# phase 12: the Visual7W multiple-choice models at the full width of bench.py
TAN_CFG = dict(CFG, task="mc", model="tan")
BAN_MC_CFG = dict(CFG, task="mc", model="ban", use_counter=True)
SAN_MC_CFG = dict(CFG, task="mc", model="san", num_stacks=2)
MC_A, MC_CANDIDATES, GRID_V = 6, 4, 196  # vqatpu/data/mc_dataset.py:21-23
MC_BATCH = TRAIN_B // MC_CANDIDATES      # 64 questions, 256 rows (SURVEY.md)
MC_GOLDEN_TOL = 1e-4   # float32 logits vs JAX's goldens (the hard limit is
                       # SERVE_TOL)
MC_TIE = 1e-5          # a pick whose two best CPU scores are this close is
                       # a tie: reported, not required to agree
MC_TRAIN, MC_VAL, MC_IMAGES, MC_EPOCHS = 512, 128, 32, 2  # phase 12e


def mc_rows(mcfg, n, seed, grid=False):
    """``n`` seeded questions (``numpy_batch`` of the MC config) and their
    ``x4`` candidate rows (``expand_mc_batch``): -> (questions, rows).  On
    the grid path all 196 cells are real and the spatials zero, as
    ``tests/torch_mc_goldens.py`` makes them."""
    from vqatpu_torch.data.mc_dataset import expand_mc_batch
    from vqatpu_torch.weights import numpy_batch

    boxes = GRID_V if grid else V
    qb = numpy_batch(mcfg, n, seed=seed, boxes=boxes,
                     real_boxes=boxes if grid else REAL_BOXES)
    if grid:
        qb["b"] = np.zeros_like(qb["b"])
    return qb, expand_mc_batch(qb)


def mc_launches(label, path_counts, forwards, dtype, backwards=0):
    """The launch counts of a TanModel path: K1 once and K2 once per
    glimpse a forward (float32 or bf16 instances), the softmax backward
    once and K2's backward once per glimpse a backward, and never K3's
    forward."""
    from vqatpu_torch.kernels import trilinear as K
    torch.cuda.synchronize()
    path_counts[label] = counts = dict(K.launches)
    sfx = "_bf16" if dtype == "bfloat16" else ""
    want = {f"fused_rank_softmax{sfx}": forwards,
            f"trilinear_pool{sfx}": CFG["gamma"] * forwards,
            "softmax_vqa_backward": backwards,
            f"trilinear_pool_backward{sfx}": CFG["gamma"] * backwards}
    assert {k: v for k, v in cti_kernels(counts).items() if v} == {
        k: v for k, v in want.items() if v}, (label, counts, want)
    return counts


def phase12_logits(path_counts) -> dict:
    """(a) TanModel, BanModelMC (with the counter) and SAN-MC at full width
    from ``numpy_params(cfg, 0)`` on JAX's goldens (8 questions, 32 rows;
    BAN-MC 32 questions, its counter being ill-conditioned at bf16): every
    wire at float32 compute against the CPU path on the same wire and the
    float32 wire against JAX's float32 golden; bf16 compute within 2x
    JAX's own largest bf16 error + 1e-4 (BAN-MC served, ``b`` bf16, and
    through the eval step, ``b`` float32, each against JAX's own); TanModel
    on the grid path (V=196, zero spatials).  TanModel launches K1 and K2 (no K3 forward),
    BAN-MC and SAN-MC none.  -> each model's config, model, float32 and
    bf16 sessions."""
    from vqatpu_torch.config import ModelConfig
    from vqatpu_torch.kernels import trilinear as K
    from vqatpu_torch.models import build_model
    from vqatpu_torch.serve import InferenceSession
    from vqatpu_torch.train import make_eval_step
    from vqatpu_torch.weights import load_jax_params, numpy_params

    data = ROOT / "tests" / "data"
    labels = ["match", "nonmatch"]
    out = {}
    for name, kw, file in (("tan", TAN_CFG, "torch_tan_golden.npz"),
                           ("ban_mc", BAN_MC_CFG, "torch_ban_mc_golden.npz"),
                           ("san_mc", SAN_MC_CFG, "torch_san_mc_golden.npz")):
        z = np.load(data / file)
        assert int(z["param_seed"]) == 0, "golden made from other weights"
        mcfg = ModelConfig(**kw)
        params = numpy_params(mcfg, 0)
        model = load_jax_params(build_model(mcfg), params)
        cpu_model = load_jax_params(build_model(mcfg), params)
        _, rows_ = mc_rows(mcfg, int(z["n"]), int(z["batch_seed"]))
        args = (rows_["v"], rows_["b"], rows_["q"], rows_["a"])
        K.reset_launches()
        sessions, n_fwd = {}, 0
        for wire in ("float32", "float16", "bfloat16", "int8"):
            sess = InferenceSession(model, labels, transfer_dtype=wire,
                                    device="cuda")
            sessions[wire] = sess
            # every row on the float32 wire, the narrowed wires on the
            # first 2 questions; the CPU path on at most 8 questions
            rows_w = slice(None) if wire == "float32" else slice(0, 8)
            got = sess.logits(*(x[rows_w] for x in args))
            n_fwd += sess.forwards
            rows_c = slice(0, min(32, got.shape[0]))
            cpu = InferenceSession(cpu_model, labels, transfer_dtype=wire,
                                   device="cpu").logits(
                *(x[rows_c] for x in args))
            e_gold = float(np.abs(got - z["logits"][rows_w]).max())
            e_cpu = float(np.abs(got[rows_c] - cpu).max())
            print(f"phase 12a {name} wire={wire} ({got.shape[0]} rows, "
                  f"{cpu.shape[0]} on the CPU): vs "
                  f"the CPU path on the same wire {e_cpu:.3e} (tol "
                  f"{SERVE_TOL:.0e}); vs JAX's float32 golden {e_gold:.3e}"
                  + (f" (target {MC_GOLDEN_TOL:.0e}, tol {SERVE_TOL:.0e})"
                     if wire == "float32" else " (the wire's rounding)"))
            assert got.shape == (rows_["q"][rows_w].shape[0], 2)
            assert np.isfinite(got).all() and e_cpu <= SERVE_TOL, e_cpu
            assert wire != "float32" or e_gold <= SERVE_TOL, e_gold
        if name == "tan":
            mc_launches("phase 12a tan, every wire", path_counts, n_fwd,
                        "float32")
        else:
            zero_launches(f"phase 12a {name}, every wire", path_counts)
        sess16 = InferenceSession(model, labels, compute_dtype="bfloat16",
                                  device="cuda")
        K.reset_launches()
        got16 = sess16.logits(*args)
        err, bound = bf16_error(got16, z["logits_bf16"], z["logits"])
        print(f"phase 12a {name} served at bf16: vs JAX's float32 golden "
              f"{err.max():.3e} (budget {bound:.3e}: 2 x JAX's own largest "
              f"bf16 error + 1e-4)")
        assert np.isfinite(got16).all() and err.max() <= bound, (
            err.max(), bound)
        if "logits_eval" in z.files:
            # the counter reads b, which the session casts to bf16 and the
            # eval step leaves float32: each path against JAX's own
            ev = make_eval_step(model, compute_dtype="bfloat16")(
                {k: rows_[k] for k in ("v", "b", "q", "a")})
            got_e = ev["logits"].cpu().numpy()
            err, bound = bf16_error(got_e, z["logits_eval"], z["logits"])
            print(f"phase 12a {name} eval step at bf16 (b float32): vs JAX's "
                  f"float32 golden {err.max():.3e} (budget {bound:.3e})")
            assert np.isfinite(got_e).all() and err.max() <= bound, (
                err.max(), bound)
        if name == "tan":
            mc_launches("phase 12a tan bf16", path_counts, sess16.forwards,
                        "bfloat16")
            # the grid path: 196 cells, zero spatials
            _, g = mc_rows(mcfg, int(z["n"]), int(z["grid_seed"]), grid=True)
            grid = InferenceSession(model, labels, max_boxes=GRID_V,
                                    device="cuda")
            K.reset_launches()
            got = grid.logits(g["v"], g["b"], g["q"], g["a"])
            e = float(np.abs(got - z["logits_grid"]).max())
            print(f"phase 12a tan on the grid path (V={GRID_V}, zero "
                  f"spatials): vs JAX's float32 golden {e:.3e} (target "
                  f"{MC_GOLDEN_TOL:.0e}, tol {SERVE_TOL:.0e})")
            assert np.isfinite(got).all() and e <= SERVE_TOL, e
            mc_launches("phase 12a tan grid", path_counts, grid.forwards,
                        "float32")
        else:
            zero_launches(f"phase 12a {name} bf16", path_counts)
        out[name] = (mcfg, model, sessions["float32"], sess16, cpu_model)
    return out


def phase12_serving(models, path_counts, median_ms) -> None:
    """(c) ``mc_scores`` / ``answer_mc`` of TanModel for 1, 8, 32 and 40
    questions (4, 32, 128 and 160 rows: 40 splits past bucket 128) through
    the session, the ``MicroBatcher`` and HTTP ``/answer_mc`` (``mc_tokens``
    as JSON and npz, ``mc_answers`` strings), the picks against the CPU
    path's; BAN-MC's ``mc_scores`` with spatials; every bucket timed
    (host clock end to end, the forward on CUDA events) at float32 and
    bf16."""
    from vqatpu_torch.cli.serve import serve_in_thread
    from vqatpu_torch.data import Dictionary
    from vqatpu_torch.kernels import trilinear as K
    from vqatpu_torch.serve import InferenceSession, MicroBatcher

    mcfg, model, session, sess16, cpu_model = models["tan"]
    labels = session.label2ans
    cpu = InferenceSession(cpu_model, labels, device="cpu")
    words = "what color is the cat dog red blue green on the table two three"
    dictionary = Dictionary()
    dictionary.tokenize(words, add_word=True)
    answers = ["red", "blue", "green", "two", "three", "the cat", "on table"]
    mb = MicroBatcher(session, max_batch=128)
    K.reset_launches()
    fwd0 = session.forwards
    server = serve_in_thread(mb, dictionary, "cti", 0, task="mc")
    port = server.server_address[1]
    ties = 0
    try:
        for n in (1, 8, 32, 40):
            qb, _ = mc_rows(mcfg, n, seed=1400 + n)
            v, q, mc = qb["v"], qb["q"], qb["ans_mc"]
            t0 = time.perf_counter()
            scores = session.mc_scores(v, None, q, mc)
            ms = (time.perf_counter() - t0) * 1e3
            want = cpu.mc_scores(v, None, q, mc)
            picks = session.answer_mc(v, None, q, mc)
            top2 = np.sort(want, 1)[:, -2:]
            tie = (top2[:, 1] - top2[:, 0]) <= MC_TIE
            ties += int(tie.sum())
            want_picks = want.argmax(1)
            batched = mb.mc_scores(v, None, q, mc)
            served = [post(port, "/answer_mc", {"features": v, "question_tokens": q,
                                                "mc_tokens": mc}, npz=True),
                      post(port, "/answer_mc", {
                          "features": v.tolist(), "question_tokens": q.tolist(),
                          "mc_tokens": mc.tolist()})]
            e_cpu = float(np.abs(scores - want).max())
            e_mb = float(np.abs(batched - scores).max())
            e_http = max(float(np.abs(np.asarray(s["scores"]) - scores).max())
                         for s in served)
            print(f"phase 12c tan mc_scores, {n} questions ({4 * n} rows): "
                  f"{ms:.2f} ms; vs the CPU path {e_cpu:.3e} (tol "
                  f"{CPU_REL_TOL:.0e}); MicroBatcher {e_mb:.3e}, HTTP "
                  f"/answer_mc {e_http:.3e} (tol {BATCHER_TOL:.0e}); picks "
                  f"{picks[:8]}...; ties (CPU scores within {MC_TIE:.0e}) "
                  f"{int(tie.sum())}")
            assert scores.shape == (n, MC_CANDIDATES) and np.isfinite(scores).all()
            assert e_cpu <= CPU_REL_TOL, e_cpu
            assert e_mb <= BATCHER_TOL and e_http <= BATCHER_TOL, (e_mb, e_http)
            for got_picks in (np.asarray(picks), scores.argmax(1),
                              batched.argmax(1), *(np.asarray(s["picks"])
                                                   for s in served)):
                assert (got_picks == want_picks)[~tie].all(), (got_picks,
                                                               want_picks)
            if n > 8:
                continue
            # candidates as strings, tokenized to 6 by the server
            cands = [[answers[(i + j) % len(answers)] for j in range(4)]
                     for i in range(n)]
            out = post(port, "/answer_mc", {"features": v.tolist(),
                                            "question_tokens": q.tolist(),
                                            "mc_answers": cands})
            toks = np.asarray([[dictionary.tokenize_padded(s, MC_A) for s in r]
                               for r in cands])
            want_s = cpu.mc_scores(v, None, q, toks)
            top2 = np.sort(want_s, 1)[:, -2:]
            ok = (top2[:, 1] - top2[:, 0]) > MC_TIE
            assert [a for a, k in zip(out["answers"], ok) if k] == [
                cands[i][j] for i, j in enumerate(want_s.argmax(1)) if ok[i]]
    finally:
        server.shutdown()
        server.server_close()
        mb.close()
    mc_launches("phase 12c tan serving (session, MicroBatcher, HTTP)",
                path_counts, session.forwards - fwd0, "float32")
    print(f"phase 12c: picks equal to the CPU path's in every case but {ties} "
          f"ties; the MicroBatcher ran {mb.batches_run} forwards for "
          f"{mb.rows_served} rows")

    # BAN-MC: the spatials expand with the candidates
    bcfg, _, bsess, _, bcpu_model = models["ban_mc"]
    qb, _ = mc_rows(bcfg, 8, seed=1450)
    K.reset_launches()
    got = bsess.mc_scores(qb["v"], qb["b"], qb["q"], qb["ans_mc"])
    zero_launches("phase 12c ban_mc mc_scores", path_counts)
    want = InferenceSession(bcpu_model, labels, device="cpu").mc_scores(
        qb["v"], qb["b"], qb["q"], qb["ans_mc"])
    e = float(np.abs(got - want).max())
    print(f"phase 12c ban_mc mc_scores with spatials, 8 questions: vs the "
          f"CPU path {e:.3e} (tol {CPU_REL_TOL:.0e})")
    assert e <= CPU_REL_TOL, e

    K.reset_launches()
    fwd32, fwd16 = session.forwards, sess16.forwards
    for compute, sess in (("float32", session), ("bfloat16", sess16)):
        for n in sess.batch_buckets:  # rows: n / 4 questions
            _, r = mc_rows(mcfg, max(1, n // MC_CANDIDATES), seed=1500 + n)
            r = {k: x[:n] for k, x in r.items()}
            e2e = median_ms(lambda: sess.logits(r["v"], None, r["q"], r["a"]),
                            on_card=False)
            host, _ = sess.pack(r["v"], r["q"], r["a"])
            dev_b = sess.upload(host)
            fwd = median_ms(lambda: sess.forward(dev_b), on_card=True)
            print(f"phase 12c tan bucket {n} ({n} candidate rows) compute="
                  f"{compute}: session.logits {e2e:.3f} ms ({n / e2e * 1e3:.0f} "
                  f"rows/s); forward on the card {fwd:.3f} ms")
    torch.cuda.synchronize()
    path_counts["phase 12c tan serving buckets"] = counts = dict(K.launches)
    assert counts["fused_rank_softmax"] == session.forwards - fwd32, counts
    assert counts["fused_rank_softmax_bf16"] == sess16.forwards - fwd16, counts
    assert counts["masked_softmax_vqa"] == 0, counts


def phase12_training(models, path_counts, train_throughput) -> None:
    """(d) TanModel's three deterministic steps (4 questions, 16 rows, lr
    1e-3, ``mc_scoring``) against JAX's golden trajectory
    ``tests/data/torch_tan_train_golden.npz`` and the CPU path
    (TRAIN_TOL), and at bf16 within the budget of
    ``torch_tan_train_golden_bf16.npz``; then 64 questions (256 rows) a
    step with dropout on:
    TanModel at float32 and bf16 (``train_throughput``, 3 windows),
    BAN-MC (counter) and SAN-MC at float32 and bf16
    (``phase11_train_step_rate``)."""
    from vqatpu_torch.config import TrainConfig
    from vqatpu_torch.kernels import trilinear as K
    from vqatpu_torch.models import build_model
    from vqatpu_torch.train import make_train_state, make_train_step
    from vqatpu_torch.weights import jax_params_from_torch, param_stats

    mcfg = models["tan"][0]
    tg = np.load(ROOT / "tests" / "data" / "torch_tan_train_golden.npz")
    n, steps, lr = int(tg["n"]), int(tg["steps"]), float(tg["lr"])
    batches = [mc_rows(mcfg, n, int(tg["batch_seed"]) + i)[1]
               for i in range(steps)]
    batches = [{k: b[k] for k in ("v", "b", "q", "a", "target")}
               for b in batches]
    traj = {}
    K.reset_launches()
    for device in ("cuda", "cpu"):
        state = make_train_state(build_model(mcfg), seed=int(tg["param_seed"]),
                                 device=device)
        step = make_train_step(state.model, TrainConfig(
            update_freq=1, deterministic=True), mc_scoring=True)
        metrics = [step(state, b, lr) for b in batches]
        rec = {k: np.array([float(m[k]) for m in metrics])
               for k in ("loss", "grad_norm", "batch_score")}
        stats = param_stats(jax_params_from_torch(state.model.state_dict()))
        rec.update({f"param_{k}": v for k, v in stats.items()})
        traj[device] = rec
        if device == "cuda":
            mc_launches("phase 12d tan trajectory", path_counts, steps,
                        "float32", backwards=steps)
        del state, step, metrics

    def err(got, want):
        assert (got["param_names"] == want["param_names"]).all()
        e = max(float(np.max(np.abs(got[k] - want[k]) / np.abs(want[k])))
                for k in ("loss", "grad_norm", "param_l2", "param_l1"))
        # a group's score is 0 or 1: exact
        assert (got["batch_score"] == want["batch_score"]).all(), (
            got["batch_score"], want["batch_score"])
        return max(e, float(np.max(np.abs(got["param_sum"] - want["param_sum"])
                                   / want["param_l1"])))

    golden = {k: tg[k] for k in tg.files}
    e_gold, e_cpu = err(traj["cuda"], golden), err(traj["cuda"], traj["cpu"])
    print(f"phase 12d TanModel trajectory, {steps} steps of {n} questions "
          f"({4 * n} rows), lr {lr}: loss {traj['cuda']['loss'].tolist()}, "
          f"grad_norm {traj['cuda']['grad_norm'].tolist()}, batch_score "
          f"{traj['cuda']['batch_score'].tolist()}; largest relative error vs "
          f"JAX's golden {e_gold:.3e}, vs the CPU path {e_cpu:.3e} (tol "
          f"{TRAIN_TOL:.0e}; {len(golden['param_names'])} leaves)")
    assert e_gold <= TRAIN_TOL and e_cpu <= TRAIN_TOL, (e_gold, e_cpu)

    # bf16: within the budget of JAX's float32 and xla-backend bf16 steps
    # (its Pallas backend takes no bf16 step), as phase 8a'
    tg16 = np.load(ROOT / "tests" / "data"
                   / "torch_tan_train_golden_bf16.npz")
    assert all(tg16[k] == tg[k] for k in ("n", "steps", "param_seed",
                                          "batch_seed", "lr"))
    assert float(tg16["floor"]) == BF16_FLOOR
    K.reset_launches()
    state = make_train_state(build_model(mcfg), seed=int(tg["param_seed"]),
                             device="cuda")
    step = make_train_step(state.model, TrainConfig(
        update_freq=1, deterministic=True, compute_dtype="bfloat16"),
        mc_scoring=True)
    metrics = [step(state, b, lr) for b in batches]
    mc_launches("phase 12d tan bf16 trajectory", path_counts, steps,
                "bfloat16", backwards=steps)
    got16 = {"loss": np.array([float(m["loss"]) for m in metrics]),
             "grad_norm": np.array([float(m["grad_norm"]) for m in metrics]),
             "param_l2": param_stats(jax_params_from_torch(
                 state.model.state_dict()))["l2"]}
    worst = {}
    for k, x in got16.items():
        f32_, b16_ = tg16[f"f32_{k}"], tg16[f"bf16_{k}"]
        bound = BF16_BUDGET * np.abs(b16_ - f32_) + BF16_FLOOR * np.abs(f32_)
        worst[k] = float(np.max(np.abs(x - f32_) / bound))
    print(f"phase 12d TanModel bf16 trajectory, {steps} steps: loss "
          f"{got16['loss'].tolist()}; error against JAX's float32 over its "
          f"budget ({BF16_BUDGET:g} x JAX xla bf16's own + {BF16_FLOOR:.2e} x "
          f"|value|), worst ratio per metric (<= 1 passes): {worst}")
    assert all(v <= 1.0 for v in worst.values()), worst
    del state, step, metrics

    qb, rows_ = mc_rows(mcfg, MC_BATCH, seed=0)
    batch = {k: rows_[k] for k in ("v", "b", "q", "a", "target")}
    batch["v_mask"] = np.abs(batch["v"]).sum(-1) != 0
    db = {k: torch.from_numpy(x).cuda() for k, x in batch.items()}
    for compute in ("float32", "bfloat16"):
        counts, n_steps, step_ms = train_throughput(
            f"MC TanModel {MC_BATCH} questions ({TRAIN_B} rows), "
            f"compute_dtype={compute}, batch on the card", db, windows=3,
            mcfg=mcfg, mc_scoring=True, compute_dtype=compute)
        sfx = "_bf16" if compute == "bfloat16" else ""
        path_counts[f"phase 12d tan training {compute}"] = counts
        assert counts["fused_rank_softmax" + sfx] == n_steps, counts
        assert counts["trilinear_pool" + sfx] == CFG["gamma"] * n_steps, counts
        assert counts["softmax_vqa_backward"] == n_steps, counts
        assert (counts["trilinear_pool_backward" + sfx]
                == CFG["gamma"] * n_steps), counts
        assert counts["masked_softmax_vqa"] == 0, counts
        print(f"phase 12d TanModel {compute}: {MC_BATCH / step_ms * 1e3:.1f} "
              f"questions/s ({TRAIN_B / step_ms * 1e3:.1f} candidate rows/s) "
              f"at the median step {step_ms:.3f} ms")
    for name in ("ban_mc", "san_mc"):
        bcfg = models[name][0]
        _, r = mc_rows(bcfg, MC_BATCH, seed=0)
        db = {k: torch.from_numpy(r[k]).cuda()
              for k in ("v", "b", "q", "a", "target")}
        K.reset_launches()
        for compute in ("float32", "bfloat16"):
            step_ms, _ = phase11_train_step_rate(
                f"phase 12d training {name} {MC_BATCH} questions "
                f"({TRAIN_B} rows), compute_dtype={compute}, batch on the "
                "card", bcfg, db,
                compute, profile_table=False, distillation=False,
                mc_scoring=True)
            print(f"phase 12d {name} {compute}: "
                  f"{MC_BATCH / step_ms * 1e3:.1f} questions/s")
        zero_launches(f"phase 12d {name} training", path_counts)
        del db


def phase12_cli(path_counts) -> None:
    """(e) ``mc_train`` then ``mc_test`` at full width on a
    ``make_v7w_fixture`` dataroot (512 train and 128 val and test
    questions over 32 images of 2048-d ``.npz`` features, with the grid
    path's 196-cell features beside them): ``mc_train --model cti`` for 2
    epochs of 8 steps three ways (the Python loader, the C++ loader, the
    card-resident store; per-step losses within LOOP_TOL), ``mc_test`` on
    epoch 1 with the store on and off (equal accuracy), and one epoch on
    the grid path (``--use_feature grid --max_boxes 196``)."""
    from vqatpu_torch.cli import mc_test, mc_train
    from vqatpu_torch.data.synthetic import (add_v7w_grid_fixture,
                                             make_v7w_fixture)
    from vqatpu_torch.kernels import trilinear as K

    tmp = tempfile.TemporaryDirectory()
    root = os.path.join(tmp.name, "data_v7w")
    t0 = time.perf_counter()
    make_v7w_fixture(root, n_train=MC_TRAIN, n_val=MC_VAL,
                     n_images=MC_IMAGES, v_dim=CFG["v_dim"])
    add_v7w_grid_fixture(root, n_images=MC_IMAGES, v_dim=CFG["v_dim"])
    print(f"phase 12e dataroot: {MC_TRAIN} train, {MC_VAL} val and test "
          f"questions over {MC_IMAGES} images, bottom-up and grid features, "
          f"made in {time.perf_counter() - t0:.1f} s")
    args = ["--model", "cti", "--dataroot", root, "--num_hid",
            str(CFG["num_hid"]), "--h_mm", str(CFG["h_mm"]), "--rank",
            str(CFG["rank"]), "--gamma", str(CFG["gamma"]), "--device", "cuda",
            "--print_interval", "1000"]
    steps, evals = MC_TRAIN // MC_BATCH, -(-MC_VAL // (2 * MC_BATCH))
    runs = {"(iii) Python loader": ["--no_native_loader", "--device_features",
                                    "off"],
            "(ii) C++ loader": ["--device_features", "off"],
            "(i) C++ loader and the store (defaults)": []}
    losses = {}
    try:
        for label, extra in runs.items():
            out = os.path.join(tmp.name, "v7w", label[1:label.index(")")])
            counts, record, wall = run_train(
                f"phase 12e mc_train {label}", args + extra + [
                    "--output", out, "--epochs", str(MC_EPOCHS)], path_counts,
                cli=mc_train)
            text, log_losses, scores, secs = log_of(os.path.join(out, "log.txt"))
            losses[label] = np.array([float(x) for r in record
                                      for x in r["losses"]])
            train_s = record[-1]["train"]
            print(f"phase 12e mc_train {label}: {MC_EPOCHS} epochs of {steps} "
                  f"steps ({MC_BATCH} questions, {TRAIN_B} rows) in {wall:.1f} "
                  f"s; last epoch {secs[-1]:.3f} s (log.txt), training "
                  f"{steps * MC_BATCH / train_s:.1f} questions/s, the loader "
                  f"{record[-1]['wait'] / train_s:.1%}, eval "
                  f"{record[-1]['eval']:.3f} s; losses {log_losses}; eval "
                  f"{scores}; launches {counts}")
            assert counts["fused_rank_softmax"] == MC_EPOCHS * (steps + evals)
            assert counts["softmax_vqa_backward"] == MC_EPOCHS * steps
            assert (counts["trilinear_pool_backward"]
                    == CFG["gamma"] * MC_EPOCHS * steps), counts
            assert len(losses[label]) == MC_EPOCHS * steps
            assert all(np.isfinite(losses[label]))
            assert ("device feature store: " in text) == label.startswith("(i)")
            assert "model_epoch0.ckpt" in os.listdir(out)  # saving_epoch 0
        want = losses["(iii) Python loader"]
        for label in list(runs)[1:]:
            e = float(np.max(np.abs(losses[label] - want) / np.abs(want)))
            print(f"phase 12e per-step losses, {label} vs (iii): largest "
                  f"relative difference {e:.3e} over {len(want)} steps (tol "
                  f"{LOOP_TOL:.0e})")
            assert e <= LOOP_TOL, (label, e)

        ckpt = os.path.join(tmp.name, "v7w", "i")
        acc = {}
        for flag in ("on", "off"):
            K.reset_launches()
            acc[flag] = mc_test.main(args + [
                "--split", "val", "--input", ckpt, "--epoch",
                str(MC_EPOCHS - 1), "--device_features", flag])
            mc_launches(f"phase 12e mc_test --device_features {flag}",
                        path_counts, -(-MC_VAL // MC_BATCH), "float32")
        print(f"phase 12e mc_test --split val: accuracy {acc['on']:.4f} with "
              f"the store, {acc['off']:.4f} without")
        assert acc["on"] == acc["off"], acc

        out = os.path.join(tmp.name, "v7w", "grid")
        counts, record, wall = run_train(
            "phase 12e mc_train --use_feature grid", args + [
                "--use_feature", "grid", "--max_boxes", str(GRID_V),
                "--output", out, "--epochs", "1"], path_counts, cli=mc_train)
        text, log_losses, scores, _ = log_of(os.path.join(out, "log.txt"))
        decided = [ln for ln in text.splitlines() if "feature store" in ln]
        print(f"phase 12e mc_train --use_feature grid (V={GRID_V}): 1 epoch "
              f"in {wall:.1f} s, training {record[0]['train']:.3f} s; loss "
              f"{log_losses}, eval {scores}; {decided}; launches {counts}")
        assert counts["fused_rank_softmax"] == steps + evals, counts
        assert counts["trilinear_pool_backward"] == CFG["gamma"] * steps, counts
        assert np.isfinite(log_losses).all()
    finally:
        tmp.cleanup()


# phase 13: CTI's large-V path and v-side knobs, reference .pth interop, the
# LSTM and bidirectional encoders and --profile_dir, at bench.py's width
BIG_V, BIG_REAL, BIG_BLOCK = 2048, 1843, 256  # boxes (90% real), v_block_size
BIG_LOGITS_B, BIG_TRAIN_B, BIG_STEPS = 8, 64, 3
BLOCKWISE_TOL = 1e-4  # blockwise vs the kernels at V=2048: sums in another order
ENCODER_TOL = 1e-4    # cuDNN vs the CPU's GRU / LSTM, num_hid 1024
KNOBS = {"standard": {}, "blockwise": dict(v_block_size=BIG_BLOCK),
         "remat": dict(remat_glimpse=True), "fused": dict(fused_v_tucker=True)}


def big_v_batch(cfg, n, seed):
    """``n`` rows of V=2048 boxes (the last 10% padding) made on the card,
    tokens, and soft targets."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    v = torch.randn(n, BIG_V, cfg.v_dim, generator=g, device="cuda")
    v[:, BIG_REAL:] = 0.0
    return {"v": v,
            "q": torch.randint(0, cfg.ntoken + 1, (n, Q), generator=g,
                               device="cuda"),
            "a": torch.randint(0, cfg.ntoken + 1, (n, A), generator=g,
                               device="cuda"),
            "target": torch.rand(n, cfg.num_ans_candidates, generator=g,
                                 device="cuda")}


def phase13_large_v(cfg, params, path_counts, smi) -> dict:
    """(a) logits at B=8 and V=2048: the blockwise branch (block 256) against
    the standard one (K1 and K2 at V=2048); (b) a training step at B=64 in
    the four configurations, standard and remat at bf16 compute, and the
    standard model with ``mask_replay`` at float32 and bf16, dropout on, the
    generator seeded alike: peak memory (``max_memory_allocated`` after
    ``reset_peak_memory_stats``), step time on CUDA events, launches a
    step; each remat and replay step's first loss equal to its dtype's
    standard step's and its grad norm within 1e-5 (the recompute and the
    replay draw the same masks, and the remat recompute at bf16 runs on the
    forward's bf16 weights), the blockwise step's within 1e-4; the bytes
    autograd keeps for the backward of a float32 forward, with and without
    ``mask_replay``."""
    from vqatpu_torch.config import TrainConfig
    from vqatpu_torch.kernels import trilinear as K
    from vqatpu_torch.models import build_model
    from vqatpu_torch.ops.module import Ctx
    from vqatpu_torch.train import make_train_state, make_train_step
    from vqatpu_torch.weights import load_jax_params

    def model_of(knob):
        return load_jax_params(build_model(dataclasses.replace(
            cfg, **KNOBS[knob])), params).to("cuda")

    batch = big_v_batch(cfg, BIG_LOGITS_B, seed=131)
    logits = {}
    for knob in ("standard", "blockwise"):
        model = model_of(knob).eval()
        K.reset_launches()
        with torch.inference_mode():
            logits[knob], att = model(batch["v"], batch["q"], batch["a"])
        torch.cuda.synchronize()
        path_counts[f"phase 13a {knob} logits V={BIG_V}"] = counts = dict(
            K.launches)
        assert (att is None) == (knob == "blockwise")
        want = ({"fused_rank_softmax": 1, "trilinear_pool": cfg.gamma}
                if knob == "standard" else {})
        assert {k: c for k, c in cti_kernels(counts).items() if c} == want, (
            knob, counts)
        del model
    err = float((logits["blockwise"] - logits["standard"]).abs().max())
    print(f"phase 13a logits at B={BIG_LOGITS_B}, V={BIG_V} ({BIG_REAL} real "
          f"boxes): blockwise (block {BIG_BLOCK}, no kernel launched) vs the "
          f"standard branch (K1 and K2 at V={BIG_V}) max_abs_err {err:.3e} "
          f"(tol {BLOCKWISE_TOL:.0e}; logits up to "
          f"{float(logits['standard'].abs().max()):.3f})")
    assert err <= BLOCKWISE_TOL and torch.isfinite(logits["blockwise"]).all()
    del batch, logits

    batch = big_v_batch(cfg, BIG_TRAIN_B, seed=132)

    def kernels(sfx="", remat=False):
        return {"fused_rank_softmax" + sfx: 1,
                "trilinear_pool" + sfx: (2 if remat else 1) * cfg.gamma,
                "softmax_vqa_backward": 1,
                "trilinear_pool_backward" + sfx: cfg.gamma}

    per_step = {"standard": kernels(), "blockwise": {},
                "remat": kernels(remat=True), "fused": kernels(),
                "standard bf16": kernels("_bf16"),
                "remat bf16": kernels("_bf16", remat=True),
                "replay": kernels(), "replay bf16": kernels("_bf16")}
    out = {}
    for run in per_step:
        knob, _, half = run.partition(" ")
        replay = knob == "replay"
        state = make_train_state(model_of("standard" if replay else knob),
                                 device="cuda")
        step = make_train_step(state.model, TrainConfig(
            update_freq=1, batch_size=BIG_TRAIN_B, mask_replay=replay,
            compute_dtype="bfloat16" if half else "float32"))
        gen = torch.Generator(device="cuda").manual_seed(7)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        K.reset_launches()
        first = step(state, batch, 1e-3, gen)
        times = []
        for _ in range(BIG_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = step(state, batch, 1e-3, gen)
            end.record()
            times.append((start, end))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        path_counts[f"phase 13b {run} training V={BIG_V}"] = counts = dict(
            K.launches)
        n = BIG_STEPS + 1
        assert {k: c for k, c in cti_kernels(counts).items() if c} == {
            k: n * c for k, c in per_step[run].items()}, (run, counts)
        ms = statistics.median(s.elapsed_time(e) for s, e in times)
        out[run] = dict(loss=float(first["loss"]),
                        grad_norm=float(first["grad_norm"]), peak=peak,
                        base=base, ms=ms, counts=counts)
        assert np.isfinite(float(m["loss"])), run
        print(f"phase 13b {run} step, B={BIG_TRAIN_B}, V={BIG_V}, dropout on "
              f"({smi}): peak {peak / 2**30:.3f} GiB allocated "
              f"({(peak - base) / 2**30:.3f} GiB above the weights, Adamax "
              f"state and batch), median step {ms:.3f} ms of {BIG_STEPS} (CUDA "
              f"events), {BIG_TRAIN_B / ms * 1e3:.1f} samples/s; first loss "
              f"{out[run]['loss']:.6f}, grad norm {out[run]['grad_norm']:.6f}; "
              f"launches per step {per_step[run]}")
        del state, step, first, m
        torch.cuda.empty_cache()
    for run, base_run in (("blockwise", "standard"), ("remat", "standard"),
                          ("fused", "standard"),
                          ("remat bf16", "standard bf16"),
                          ("replay", "standard"),
                          ("replay bf16", "standard bf16")):
        d_peak = (out[run]["peak"] - out[base_run]["peak"]) / 2**20
        print(f"phase 13b {run} vs {base_run}: peak {d_peak:+.1f} MiB, step "
              f"{out[run]['ms'] - out[base_run]['ms']:+.3f} ms")
    # the same masks in the same order: remat and replay equal (at bf16 too,
    # where the remat recompute runs on the forward's bf16 weights),
    # blockwise to its sums
    for run, base_run in (("remat", "standard"),
                          ("remat bf16", "standard bf16"),
                          ("replay", "standard"),
                          ("replay bf16", "standard bf16")):
        got, want = out[run], out[base_run]
        assert got["loss"] == want["loss"], (run, got, want)
        assert (abs(got["grad_norm"] - want["grad_norm"])
                <= 1e-5 * want["grad_norm"]), (run, got, want)
    std = out["standard"]
    for k in ("loss", "grad_norm"):
        assert abs(out["blockwise"][k] - std[k]) <= TRAIN_TOL * abs(std[k]), k
    # what autograd keeps for the backward of one float32 forward, with and
    # without mask_replay: a dropout on a tensor that needs no gradient (the
    # v-tucker inputs: ``v`` is data) keeps no mask either way
    model = model_of("standard").train()
    kept = {}
    for replay in (False, True):
        storages = {}

        def pack(t):
            st = t.untyped_storage()
            storages[st.data_ptr()] = (st.nbytes(), t.dtype)
            return t

        gen = torch.Generator(device="cuda").manual_seed(7)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            logits, _ = model(batch["v"], batch["q"], batch["a"],
                              ctx=Ctx(train=True, generator=gen,
                                      mask_replay=replay))
        del logits
        kept[replay] = (sum(n for n, _ in storages.values()),
                        sum(n for n, d in storages.values()
                            if d == torch.bool))
        del storages
        torch.cuda.empty_cache()
    print(f"phase 13b autograd keeps for the backward of a float32 forward "
          f"(B={BIG_TRAIN_B}, V={BIG_V}, dropout on; weights included): "
          f"{kept[False][0] / 2**30:.3f} GiB, {kept[False][1] / 2**20:.1f} "
          f"MiB of it bool masks; with mask_replay "
          f"{kept[True][0] / 2**30:.3f} GiB, {kept[True][1] / 2**20:.1f} "
          f"MiB bool")
    assert kept[True][0] < kept[False][0] and kept[True][1] < kept[False][1]
    del model
    torch.cuda.empty_cache()
    return out


class _RecordingMasks:
    """A mask source drawing each 0/1 mask with numpy as it is asked for (keep
    0.7), keeping them for a replay."""

    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)
        self.masks = []

    def next_mask(self, shape):
        m = (self.rs.rand(*shape) < 0.7).astype(np.float32)
        self.masks.append(m)
        return m


def phase13_knobs_vs_cpu(cfg, params, path_counts) -> None:
    """(c) one training step of ``fused_v_tucker`` and of ``remat_glimpse``
    at V=50, B=4, dropout on, on the CPU with numpy-drawn masks and then on
    the card with the same masks: the loss and the pre-clip grad norm
    within 1e-4 relative, every mask used once."""
    from vqatpu_torch.config import TrainConfig
    from vqatpu_torch.kernels import trilinear as K
    from vqatpu_torch.models import build_model
    from vqatpu_torch.ops.module import Ctx, MaskSource
    from vqatpu_torch.train import make_train_state, make_train_step
    from vqatpu_torch.weights import load_jax_params, numpy_batch

    batch = numpy_batch(cfg, 4, seed=133, boxes=V, real_boxes=REAL_BOXES,
                        target=True)
    for knob in ("fused", "remat"):
        got = {}
        for device in ("cpu", "cuda"):
            model = load_jax_params(build_model(dataclasses.replace(
                cfg, **KNOBS[knob])), params)
            state = make_train_state(model, device=device)
            if device == "cpu":
                source = _RecordingMasks(134)
            else:
                source = MaskSource(recorded)
            step = make_train_step(model, TrainConfig(update_freq=1),
                                   ctx_factory=lambda: Ctx(train=True,
                                                           mask_source=source))
            K.reset_launches()
            m = step(state, batch, 1e-3)
            got[device] = (float(m["loss"]), float(m["grad_norm"]))
            if device == "cpu":
                recorded = source.masks
            else:
                source.assert_exhausted()
                torch.cuda.synchronize()
                path_counts[f"phase 13c {knob} step vs the CPU"] = c = dict(
                    K.launches)
                assert c["trilinear_pool_backward"] == cfg.gamma, (knob, c)
            del state, model
        err = max(abs(c - w) / abs(w) for c, w in zip(got["cuda"], got["cpu"]))
        print(f"phase 13c {knob} step (B=4, V={V}, {len(recorded)} injected "
              f"masks): card loss {got['cuda'][0]:.6f}, grad norm "
              f"{got['cuda'][1]:.6f} vs the CPU's {got['cpu'][0]:.6f}, "
              f"{got['cpu'][1]:.6f}: largest relative error {err:.3e} "
              f"(tol {TRAIN_TOL:.0e})")
        assert err <= TRAIN_TOL, (knob, got)


def phase13_pth_serving(cfg, path_counts, smi) -> None:
    """(d) the phase's seeded CTI and BAN weights exported by the port's
    exporter to ``model_epoch0.pth`` and saved as ``model_epoch0.ckpt``:
    CTI served in-process by the CLI's parser from each (``--model cti``),
    BAN by ``python -m vqatpu_torch.cli.serve`` with no ``--model`` (JAX's
    default, BAN) from the ``.pth``, against an in-process session on the
    ``.ckpt``; the logits equal to the bit."""
    import socket

    from vqatpu_torch.cli import serve as cli
    from vqatpu_torch.data import Dictionary
    from vqatpu_torch.kernels import trilinear as K
    from vqatpu_torch.models import build_model
    from vqatpu_torch.tools.export_torch import export_checkpoint
    from vqatpu_torch.train.checkpoints import save_params
    from vqatpu_torch.weights import load_jax_params, numpy_batch, numpy_params

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    words = Dictionary()
    for i in range(cfg.ntoken):
        words.add_word(f"w{i}")
    words.dump_to_file(str(root / "dictionary.pkl"))
    (root / "cache").mkdir()
    labels = [f"ans{i}" for i in range(cfg.num_ans_candidates)]
    with open(root / "cache" / "trainval_label2ans.pkl", "wb") as f:
        pickle.dump(labels, f)
    b = numpy_batch(cfg, 5, seed=135, boxes=V, real_boxes=REAL_BOXES)
    rows = {"features": b["v"], "question_tokens": b["q"].astype(np.int32)}
    proc = None
    try:
        for name in ("cti", "ban"):
            mcfg = dataclasses.replace(cfg, model=name)
            params = numpy_params(mcfg, seed=0)
            for kind in ("pth", "ckpt"):
                (root / f"{name}_{kind}").mkdir()
            export_checkpoint(str(root / f"{name}_pth" / "model_epoch0.pth"),
                              load_jax_params(build_model(mcfg), params))
            save_params(str(root / f"{name}_ckpt" / "model_epoch0.ckpt"),
                        params)
            flags = ["--dataroot", str(root), "--epoch", "0", "--device",
                     "cuda"] + (["--model", "cti"] if name == "cti" else [])
            K.reset_launches()
            sess, _ = cli.build_session(cli.build_parser().parse_args(
                flags + ["--input", str(root / f"{name}_ckpt")]))
            want = sess.logits(b["v"], None, b["q"], b["a"])
            if name == "cti":
                sess_pth, _ = cli.build_session(cli.build_parser().parse_args(
                    flags + ["--input", str(root / f"{name}_pth")]))
                got = sess_pth.logits(b["v"], None, b["q"], b["a"])
                how = "in-process, cli.build_session --model cti"
                del sess_pth
            else:
                with socket.socket() as s:
                    s.bind(("127.0.0.1", 0))
                    port = s.getsockname()[1]
                proc = subprocess.Popen(
                    [sys.executable, "-m", "vqatpu_torch.cli.serve"] + flags
                    + ["--input", str(root / f"{name}_pth"), "--port",
                       str(port)], cwd=ROOT, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
                t0 = time.perf_counter()
                while True:
                    assert proc.poll() is None, proc.stdout.read()
                    try:
                        with urllib.request.urlopen(
                                f"http://127.0.0.1:{port}/healthz",
                                timeout=5) as r:
                            health = json.loads(r.read())
                        break
                    except OSError:
                        assert time.perf_counter() - t0 < 240, "no server"
                        time.sleep(0.5)
                got = post(port, "/logits", rows, npz=True)["logits"]
                how = (f"python -m vqatpu_torch.cli.serve, no --model "
                       f"(/healthz: {health}), up in "
                       f"{time.perf_counter() - t0:.1f} s")
                assert health["model"] == "ban", health
                proc.terminate()
                proc.wait(timeout=60)
                proc = None
            torch.cuda.synchronize()
            path_counts[f"phase 13d {name} .ckpt and .pth serving"] = dict(
                K.launches)
            equal = bool(np.array_equal(got, want))
            print(f"phase 13d {name} served from model_epoch0.pth ({how}) vs "
                  f"model_epoch0.ckpt in-process: {got.shape} logits equal to "
                  f"the bit: {equal} (max_abs_err "
                  f"{float(np.abs(got - want).max()):.3e}); {smi}")
            assert equal, name
            del sess
    finally:
        if proc is not None:
            proc.kill()
            proc.wait()
        tmp.cleanup()


def phase13_encoders(cfg) -> None:
    """(e) a bidirectional 2-layer GRU and an LSTM at num_hid 1024 over Q=12,
    B=128 (600-d words), on cuDNN against the CPU path, every state and the
    last."""
    from vqatpu_torch.ops.rnn import QuestionEmbedding

    x = torch.randn(128, Q, cfg.word_dim, generator=torch.Generator()
                    .manual_seed(136))
    for kw in (dict(nlayers=2, bidirect=True), dict(rnn_type="LSTM")):
        torch.manual_seed(137)
        enc = QuestionEmbedding(cfg.word_dim, cfg.num_hid, **kw).eval()
        with torch.inference_mode():
            want, want_last = enc(x), enc.forward_last(x)
            enc = enc.to("cuda")
            xc = x.to("cuda")
            got, got_last = enc(xc), enc.forward_last(xc)
            t = time_events(lambda: enc(xc))
        err = max(float((got.cpu() - want).abs().max()),
                  float((got_last.cpu() - want_last).abs().max()))
        print(f"phase 13e QuestionEmbedding({kw}) on cuDNN, B=128, Q={Q}, "
              f"num_hid {cfg.num_hid}: out {tuple(got.shape)}, max_abs_err vs "
              f"the CPU {err:.3e} (tol {ENCODER_TOL:.0e}); forward "
              f"{t:.3f} ms (CUDA events, median of 10)")
        assert err <= ENCODER_TOL, (kw, err)


def time_events(fn, runs: int = 10) -> float:
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def phase13_profile(path_counts, p9) -> None:
    """(f) ``ffoe_train --profile_dir`` for one epoch on phase 9's dataroot
    (4 steps: the window is steps 1-3): the trace names K1's and K2's CUDA
    kernels and the ``train_step`` range."""
    out = os.path.join(p9["tmp"].name, "profiled")
    trace_dir = os.path.join(p9["tmp"].name, "trace")
    counts, _, wall = run_train("phase 13f ffoe_train --profile_dir",
                                p9["args"] + ["--output", out, "--epochs", "1",
                                              "--profile_dir", trace_dir],
                                path_counts)
    files = sorted(Path(trace_dir).glob("*.pt.trace.json"))
    assert len(files) == 1, files
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = sorted(n for n in names if "rank_softmax" in n or "tri_pool" in n)
    steps = [e for e in events if e.get("name") == "train_step"
             and e.get("cat") == "user_annotation"]  # the host's ranges
    on_card = [e for e in events if e.get("cat") == "kernel"]
    log = open(os.path.join(out, "log.txt")).read()
    print(f"phase 13f ffoe_train --profile_dir, 1 epoch in {wall:.1f} s: "
          f"{files[0].name} ({files[0].stat().st_size / 2**20:.1f} MiB), "
          f"{len(steps)} train_step ranges on the host (and "
          f"{sum(e.get('cat') == 'gpu_user_annotation' and e.get('name') == 'train_step' for e in events)}"
          f" on the card), {len(on_card)} CUDA kernel "
          f"events, K1/K2 kernels named {kernels}; log: "
          f"{[l for l in log.splitlines() if 'profile of' in l]}; launches "
          f"{counts}")
    assert len(steps) == 3 and on_card
    assert any("rank_softmax" in k for k in kernels)
    assert any("tri_pool_kernel" in k for k in kernels)
    assert any("tri_pool_backward_mma_kernel" in k for k in kernels)


# -- 14. the preprocessing tools and several processes -----------------------

P14_TRAIN_IMAGES, P14_VAL_IMAGES = 150, 50  # 14a: about 200 images
P14_TRAIN, P14_VAL, P14_EPOCHS = 1024, 256, 2
NCCL_TOL = 1e-6        # 14b: per-step losses, NCCL at world size 1 vs none
P14_STEPS = 3          # 14c-d: deterministic steps at B=256
P14_TOL = 1e-5         # 14c-d: loss, pre-clip grad norm, params vs one process
P14_BLOCK = 16         # 14d: CTI's blockwise path at tp=2, 4 blocks of V=50
P14_STORE_IMAGES, P14_GATHERS = 2000, 10  # 14e
P14_TIMEOUT = 900      # seconds for the two worker processes


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase14_tools(path_counts) -> dict:
    """(a) Item 11 end to end: a seeded bottom-up TSV of about 200 images
    (10-100 boxes of 2048-d) and VQA question and annotation JSONs through
    ``create_dictionary``, ``compute_softscore`` and ``feature_converter``
    (where ``h5py`` is absent, its named ``ImportError`` is asserted and the
    split written as ``.npz`` from the converter's own arrays), then
    ``ffoe_train`` at full width, B=256, for 2 epochs from that dataroot
    (the defaults: the C++ loader and the card-resident store).  -> the
    dataroot and the CLI's arguments, for 14b."""
    from vqatpu_torch.data.synthetic import write_bottomup_tsv, write_raw_vqa
    from vqatpu_torch.tools import (compute_softscore, create_dictionary,
                                    feature_converter)

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = os.path.join(tmp.name, "data_vqa")
    os.makedirs(root)
    rng = np.random.RandomState(14)
    images = {"train": range(1, 1 + P14_TRAIN_IMAGES),
              "val": range(5001, 5001 + P14_VAL_IMAGES)}
    write_raw_vqa(root, images["train"], images["val"], P14_TRAIN, P14_VAL,
                  seed=14)
    tsvs = {}
    for i, (split, ids) in enumerate(images.items()):
        tsvs[split] = os.path.join(tmp.name, f"{split}.tsv")
        write_bottomup_tsv(tsvs[split], [(im, int(rng.randint(10, 101)))
                                         for im in ids], v_dim=2048, seed=i)
    t_inputs = time.perf_counter() - t0
    t0 = time.perf_counter()
    create_dictionary.main(["--dataroot", root])
    compute_softscore.main(["--dataroot", root])
    try:
        import h5py  # noqa: F401
        has_h5py = True
    except ImportError:
        has_h5py = False
    for split, tsv in tsvs.items():
        if has_h5py:
            feature_converter.main(["--split", split, "--tsv", tsv, "--out",
                                    root])
            continue
        try:
            feature_converter.main(["--split", split, "--tsv", tsv, "--out",
                                    root])
        except ImportError as e:
            assert "feature_converter writes .hdf5 files and needs h5py" in str(
                e), e
        else:
            raise AssertionError("feature_converter ran without h5py")
        arrays, img_id2idx = feature_converter.adaptive_arrays([tsv])
        np.savez(os.path.join(root, f"{split}.npz"),
                 image_features=arrays["image_features"],
                 spatial_features=arrays["spatial_features"],
                 pos_boxes=arrays["pos_boxes"])
        with open(os.path.join(root, f"{split}_imgid2idx.pkl"), "wb") as f:
            pickle.dump(img_id2idx, f)
    if not has_h5py:
        print("phase 14a: h5py is absent on this machine: feature_converter "
              "raised its named ImportError (asserted); the splits were "
              "written as .npz from feature_converter.adaptive_arrays")
    with open(os.path.join(root, "cache", "trainval_label2ans.pkl"), "rb") as f:
        n_ans = len(pickle.load(f))
    made = sorted(os.listdir(root)) + sorted(
        os.path.join("cache", x) for x in os.listdir(os.path.join(root, "cache")))
    print(f"phase 14a tools: inputs written in {t_inputs:.1f} s "
          f"({sum(os.path.getsize(t) for t in tsvs.values()) / 2**20:.1f} MiB "
          f"of TSV), the three tools ran in {time.perf_counter() - t0:.1f} s: "
          f"{n_ans} answers kept; files {made}")
    args = ["--model", "cti", "--dataroot", root, "--num_hid", "1024",
            "--h_mm", "512", "--rank", "32", "--gamma", "2", "--batch_size",
            str(TRAIN_B), "--max_boxes", str(V), "--device", "cuda",
            "--print_interval", "1000"]
    out = os.path.join(tmp.name, "saved_models", "tools")
    counts, record, wall = run_train(
        "phase 14a ffoe_train on the tools' dataroot",
        args + ["--output", out, "--epochs", str(P14_EPOCHS)], path_counts)
    text, losses, scores, secs = log_of(os.path.join(out, "log.txt"))
    steps = P14_TRAIN // TRAIN_B
    step_losses = [float(x) for r in record for x in r["losses"]]
    print(f"phase 14a ffoe_train, {P14_EPOCHS} epochs of {steps} steps in "
          f"{wall:.1f} s: train losses {losses}, eval scores {scores}, "
          f"seconds an epoch {secs}; launches {counts}; log: "
          f"{[ln for ln in text.splitlines() if 'feature store' in ln]}")
    assert len(losses) == P14_EPOCHS and np.isfinite(step_losses).all()
    assert len(step_losses) == P14_EPOCHS * steps
    assert counts["fused_rank_softmax"] >= P14_EPOCHS * steps
    assert counts["trilinear_pool"] >= 2 * P14_EPOCHS * steps
    assert counts["trilinear_pool_backward"] == 2 * P14_EPOCHS * steps, counts
    return {"tmp": tmp, "args": args}


def phase14_nccl(p14, path_counts) -> None:
    """(b) NCCL at world size 1: one epoch of ``ffoe_train`` on 14a's
    dataroot with ``--coordinator 127.0.0.1:<free port> --num_processes 1
    --process_id 0`` against the same run without it (per-step losses
    within NCCL_TOL), then an all-reduce and a barrier through NCCL on the
    card."""
    import torch.distributed as dist

    losses = {}
    for label, extra in (("without --coordinator", []),
                         ("NCCL, world size 1", [
                             "--coordinator", f"127.0.0.1:{free_port()}",
                             "--num_processes", "1", "--process_id", "0"])):
        out = os.path.join(p14["tmp"].name, "nccl" if extra else "single")
        counts, record, wall = run_train(
            f"phase 14b ffoe_train {label}", p14["args"] + extra + [
                "--output", out, "--epochs", "1"], path_counts)
        losses[label] = np.array([float(x) for r in record
                                  for x in r["losses"]])
        assert not dist.is_initialized()  # the CLI ended its group
        print(f"phase 14b ffoe_train {label}: {wall:.1f} s, per-step losses "
              f"{losses[label].tolist()}; launches {counts}")
        assert counts["trilinear_pool_backward"] == 2 * len(losses[label])
    a, b = losses.values()
    err = float(np.max(np.abs(a - b) / np.abs(a)))
    print(f"phase 14b per-step losses, NCCL world size 1 vs one process: "
          f"largest relative difference {err:.3e} (tol {NCCL_TOL:.0e})")
    assert len(a) == len(b) and err <= NCCL_TOL
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        x = torch.arange(4.0, device="cuda")
        dist.all_reduce(x)
        dist.barrier()
        assert x.tolist() == [0.0, 1.0, 2.0, 3.0], x
        print(f"phase 14b NCCL {torch.cuda.nccl.version()}: all_reduce and "
              "barrier on the card at world size 1")
    finally:
        dist.destroy_process_group()


def p14_batches(cfg):
    from vqatpu_torch.weights import numpy_batch

    return [numpy_batch(cfg, TRAIN_B, seed=1400 + i, boxes=V,
                        real_boxes=REAL_BOXES, target=True)
            for i in range(P14_STEPS)]


def p14_run(state, mesh, batches):
    """P14_STEPS deterministic steps (lr 1e-3) of this rank's share of each
    global batch; -> per step (loss, pre-clip grad norm)."""
    from vqatpu_torch.config import TrainConfig
    from vqatpu_torch.parallel import shard_batch
    from vqatpu_torch.train import make_train_step

    step = make_train_step(state.model, TrainConfig(
        update_freq=1, deterministic=True), mesh=mesh)
    out = []
    for b in batches:
        local = shard_batch(b, mesh) if mesh is not None else b
        m = step(state, local, 1e-3)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    torch.cuda.synchronize()
    return out


def p14_param_diffs(full: dict, ref: dict) -> dict:
    """Params against the one-process run's, leaf by leaf on the card:
    ``stats``, the largest relative difference of the per-leaf l2 and l1
    norms and of the sum relative to the l1 norm (phase 8's trajectory
    measure, :func:`vqatpu_torch.weights.param_stats`), and the
    elementwise largest difference, where it is and how many elements
    differ by more than P14_TOL."""
    stats, worst, n_over, n = 0.0, (0.0, ""), 0, 0
    for k, r in ref.items():
        g, w = full[k].double(), r.to(full[k].device).double()
        d = (g - w).abs()
        worst = max(worst, (float(d.max()), k))
        n_over += int((d > P14_TOL).sum())
        n += d.numel()
        l1w = float(w.abs().sum())
        for a, b in ((g.norm(), w.norm()), (g.abs().sum(), l1w)):
            if float(b) > 0:
                stats = max(stats, abs(float(a) - float(b)) / float(b))
        if l1w > 0:
            stats = max(stats, abs(float(g.sum() - w.sum())) / l1w)
    return {"stats": stats, "max_abs": worst[0], "worst_leaf": worst[1],
            "n_over": n_over, "n": n}


def p14_state(cfg):
    from vqatpu_torch.models import build_model
    from vqatpu_torch.train import make_train_state
    from vqatpu_torch.weights import load_jax_params, numpy_params

    model = load_jax_params(build_model(cfg), numpy_params(cfg, seed=0))
    return make_train_state(model, device="cuda")


def phase14_worker(rank, world, port, out_dir):
    """One of 14c-e's two processes on the one card, joined by gloo over
    CUDA tensors (NCCL refuses two ranks on one device): writes
    ``rank{rank}.json`` (and rank 0 the K2 inputs of the tp path).  It runs
    DDP, tp=2 and tp=2 on CTI's blockwise path (``v_block_size``
    P14_BLOCK)."""
    import torch.distributed as dist

    from vqatpu_torch.config import ModelConfig, TrainConfig
    from vqatpu_torch.data.device_store import DeviceFeatureStore
    from vqatpu_torch.kernels import trilinear as K
    from vqatpu_torch.ops import attention as ops_attention
    from vqatpu_torch.ops import trilinear as ops_trilinear
    from vqatpu_torch.parallel import make_mesh, make_mesh_2d, shard_batch
    from vqatpu_torch.train.loop import put_on_mesh
    from vqatpu_torch.train.steps import upcast_wire
    from vqatpu_torch.weights import gather_state

    res = {}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        # gloo with CUDA tensors: all_reduce and broadcast, the two the
        # port's gloo collectives are built from
        x = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        y = torch.arange(4.0, device="cuda") * (rank + 1)
        dist.broadcast(y, 0)
        res["gloo_cuda"] = {"all_reduce": x.tolist(), "broadcast": y.tolist()}
        if x.tolist() != [3.0] * 4 or y.tolist() != [0.0, 1.0, 2.0, 3.0]:
            raise RuntimeError(f"gloo over CUDA tensors gave {res['gloo_cuda']}")
        cfg = ModelConfig(**CFG)
        batches = p14_batches(cfg)
        ref = torch.load(os.path.join(out_dir, "ref.pt"))
        control = torch.load(os.path.join(out_dir, "control.pt"))
        captured = {}

        def capture(name, fn):
            def wrapped(*args):
                captured.setdefault(name, [a.detach().clone() for a in args])
                return fn(*args)
            return wrapped

        for label, make in (("ddp", make_mesh),
                            ("tp", lambda: make_mesh_2d(1, 2)),
                            ("tp_blockwise", lambda: make_mesh_2d(1, 2))):
            state = p14_state(dataclasses.replace(cfg, v_block_size=P14_BLOCK)
                              if label == "tp_blockwise" else cfg)
            mesh = make()
            specs = put_on_mesh(state, mesh, TrainConfig())
            if label == "tp":
                ops_trilinear.trilinear_pool = capture(
                    "k2", K.trilinear_pool)
                ops_attention.masked_softmax_vqa = capture(
                    "k3", K.masked_softmax_vqa)
            K.reset_launches()
            t = time.perf_counter()
            metrics = p14_run(state, mesh, batches)
            wall = time.perf_counter() - t
            counts = dict(K.launches)
            ops_trilinear.trilinear_pool = K.trilinear_pool
            ops_attention.masked_softmax_vqa = K.masked_softmax_vqa
            full = gather_state({n: p.detach() for n, p in
                                 state.model.named_parameters()}, mesh, specs)
            res[label] = {"metrics": metrics, "launches": counts,
                          "params": p14_param_diffs(full, ref),
                          "vs_control": p14_param_diffs(full, control),
                          "seconds": wall,
                          "split": sorted(k for k, d in specs.items()
                                          if d is not None),
                          "local_rows": int(shard_batch(batches[0], mesh)[
                              "v"].shape[0])}
            del state, full
            torch.cuda.empty_cache()
        # the tp path's kernels against their plain versions, on its inputs
        vt, qt, at, w = captured["k2"]
        got, want = K.trilinear_pool(vt, qt, at, w), K.trilinear_pool_ref(
            vt, qt, at, w)
        logits, mask = captured["k3"]
        att, att_ref = (K.masked_softmax_vqa(logits, mask),
                        K.masked_softmax_vqa_ref(logits, mask))
        g = torch.randn(att.shape, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(14))
        res["tp_kernels"] = {
            "k2_shape": list(vt.shape), "k3_shape": list(logits.shape),
            "k2_err": float((got - want).abs().max()),
            "k2_scale": float(want.abs().max()),
            "k3_err": float((att - att_ref).abs().max()),
            "bwd_err": float((K.softmax_vqa_backward(att_ref, g)
                              - K.softmax_vqa_backward_ref(att_ref, g)).abs().max())}
        if rank == 0:
            torch.save({"vt": vt, "qt": qt, "at": at, "w": w},
                       os.path.join(out_dir, "k2_tp_inputs.pt"))
        del captured, vt, qt, at, w, logits, att, att_ref, got, want, g
        torch.cuda.empty_cache()
        # 14e: the row-sharded store against the replicated one
        from vqatpu_torch.data.features import FeatureStore  # noqa: F401

        mesh = make_mesh()
        ds = StoreSet(seeded_store(P14_STORE_IMAGES, 2048, 1414, int8=False),
                      np.arange(P14_STORE_IMAGES), V)
        rs = np.random.RandomState(1415)
        store_res = {}
        for wire in ("float32", "int8"):
            rep = DeviceFeatureStore.build(ds, transfer_dtype=wire)
            sh = DeviceFeatureStore.build(ds, transfer_dtype=wire, shard=True,
                                          mesh=mesh)
            equal, t_sh = 0, 0.0
            for _ in range(P14_GATHERS):
                idx = rs.randint(0, len(ds), TRAIN_B)
                local = shard_batch({"i": idx}, mesh)["i"]
                want = upcast_wire(rep.gather(local))
                torch.cuda.synchronize()
                t = time.perf_counter()
                got = sh.gather(local)
                torch.cuda.synchronize()
                t_sh += time.perf_counter() - t
                equal += all(torch.equal(got[k], want[k])
                             for k in ("v", "b", "v_mask"))
            store_res[wire] = {"equal": equal, "rows": int(rep.feats.shape[0]),
                               "local_rows": int(sh.feats.shape[0]),
                               "describe": sh.describe(),
                               "gather_ms": t_sh / P14_GATHERS * 1e3}
            del rep, sh
            torch.cuda.empty_cache()
        res["store"] = store_res
    except BaseException:
        import traceback

        res["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()


def p14_params_line(d: dict) -> str:
    return (f"params' per-leaf norms and sums within {d['stats']:.3e}; "
            f"elementwise largest difference {d['max_abs']:.3e} "
            f"({d['worst_leaf']}), {d['n_over']} of {d['n']} elements over "
            f"{P14_TOL:.0e}")


def phase14_parallel(path_counts) -> dict:
    """(c) DDP, (d) tp=2 and (e) the row-sharded store in two processes on
    the one card (:func:`phase14_worker`), against one process: the same
    P14_STEPS deterministic steps of B=256 (c: 128 rows a rank) from
    ``numpy_params(cfg, 0)``; loss and pre-clip grad norm within P14_TOL
    relative.  The params after them: Adamax's first updates are about
    ``lr * sign(g)``, so a gradient element that a float32 sum in another
    order brings near zero from the other side moves by up to ``2 lr``.
    The control shows it: one process, each batch as two microbatches of
    128 rows.  DDP's params must equal the control's within P14_TOL
    elementwise (it sums the same halves); tp's per-leaf norms and sums
    (phase 8's measure) must be as close to the one-pass run's as the
    control's are, within twice their difference or P14_TOL; every
    difference is printed.  K1, K2, K3 launches per rank; under tp K1 none, K2 at ``d / 2`` and K3 with the softmax
    backward held to their plain versions on the path's own inputs, and the
    leaves split and left replicated by ``fits``; the sharded store's
    gathers bit-equal to the replicated one's.  (d) also runs tp=2 on
    CTI's blockwise path: loss and pre-clip grad norm within P14_TOL of
    one process's blockwise steps and TRAIN_TOL of its standard ones, no
    kernel launched.  -> the tp path's K2 inputs."""
    from vqatpu_torch.config import ModelConfig
    from vqatpu_torch.kernels import trilinear as K

    cfg = ModelConfig(**CFG)
    tmp = tempfile.TemporaryDirectory()
    state = p14_state(cfg)
    t = time.perf_counter()
    want = p14_run(state, None, p14_batches(cfg))
    one_s = time.perf_counter() - t
    ref = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    torch.save(ref, os.path.join(tmp.name, "ref.pt"))
    del state
    # CTI's blockwise path in one process, what 14d's tp=2 blockwise step
    # is held to
    state = p14_state(dataclasses.replace(cfg, v_block_size=P14_BLOCK))
    K.reset_launches()
    t = time.perf_counter()
    want_bw = p14_run(state, None, p14_batches(cfg))
    one_bw_s = time.perf_counter() - t
    assert sum(cti_kernels(K.launches).values()) == 0, dict(K.launches)
    del state
    # the control: one process, each batch as two microbatches of 128 rows
    # (update_freq 2), the gradients summed in another order as DDP's are
    from vqatpu_torch.config import TrainConfig
    from vqatpu_torch.train import make_train_step

    state = p14_state(cfg)
    step = make_train_step(state.model, TrainConfig(update_freq=2,
                                                    deterministic=True))
    for b in p14_batches(cfg):
        for i in range(2):
            step(state, {k: x[i * TRAIN_B // 2:(i + 1) * TRAIN_B // 2]
                         for k, x in b.items()}, 1e-3, None, i == 1)
    control_params = {n: p.detach() for n, p in
                      state.model.named_parameters()}
    control = p14_param_diffs(control_params, ref)
    torch.save({n: p.cpu() for n, p in control_params.items()},
               os.path.join(tmp.name, "control.pt"))
    del state, ref, control_params
    torch.cuda.empty_cache()
    print(f"phase 14c-d one process: {P14_STEPS} steps of B={TRAIN_B} in "
          f"{one_s:.2f} s, (loss, grad norm) {want}; the control (each batch "
          f"as two microbatches of {TRAIN_B // 2}, one process) against it: "
          f"{p14_params_line(control)}; blockwise (v_block_size "
          f"{P14_BLOCK}, no kernel launched) in {one_bw_s:.2f} s, (loss, grad "
          f"norm) {want_bw}")
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    t = time.perf_counter()
    procs = [ctx.Process(target=phase14_worker, args=(r, 2, port, tmp.name))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(P14_TIMEOUT)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    for r in range(2):
        path = os.path.join(tmp.name, f"rank{r}.json")
        results.append(json.load(open(path)) if os.path.exists(path) else {})
    for r, res in enumerate(results):
        if "gloo_cuda" in res:
            print(f"phase 14c rank {r}: gloo over CUDA tensors: {res['gloo_cuda']}")
        if "error" in res:
            print(f"phase 14 worker rank {r} failed:\n{res['error']}")
    assert not hung, f"phase 14 workers {hung} did not end in {P14_TIMEOUT} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    print(f"phase 14c-e: two processes on the card in "
          f"{time.perf_counter() - t:.1f} s")
    for label, tag in (("ddp", "14c DDP, 2 ranks"), ("tp", "14d tp=2")):
        for r, res in enumerate(results):
            got = res[label]
            loss_errs = [abs(g[0] - w[0]) / abs(w[0])
                         for g, w in zip(got["metrics"], want)]
            norm_errs = [abs(g[1] - w[1]) / abs(w[1])
                         for g, w in zip(got["metrics"], want)]
            loss_err, norm_err = max(loss_errs), max(norm_errs)
            c = got["launches"]
            path_counts[f"phase {tag} rank {r}"] = c
            print(f"phase {tag} rank {r}: {got['local_rows']} rows a step, "
                  f"{P14_STEPS} steps in {got['seconds']:.2f} s; relative "
                  f"difference from one process at each step: loss "
                  f"{[f'{e:.3e}' for e in loss_errs]}, pre-clip grad norm "
                  f"{[f'{e:.3e}' for e in norm_errs]}; largest: loss "
                  f"{loss_err:.3e}, "
                  f"pre-clip grad norm {norm_err:.3e} (tol {P14_TOL:.0e}); "
                  f"after {P14_STEPS} updates the "
                  f"{p14_params_line(got['params'])}; launches K1 "
                  f"{c['fused_rank_softmax']}, K2 "
                  f"{c['trilinear_pool']}, K3 {c['masked_softmax_vqa']}, "
                  f"softmax backward {c['softmax_vqa_backward']}, K2 "
                  f"backward {c['trilinear_pool_backward']}")
            assert max(loss_err, norm_err) <= P14_TOL, got
            if label == "ddp":
                # DDP sums each step's two halves as the control does
                print(f"phase {tag} rank {r} against the control: "
                      f"{p14_params_line(got['vs_control'])}")
                assert got["vs_control"]["max_abs"] <= P14_TOL, got
            else:
                # tp sums in other orders again: held to the drift that
                # the control's reordering gives on one process
                assert got["params"]["stats"] <= max(
                    P14_TOL, 2 * control["stats"]), (got, control)
            if label == "ddp":
                assert got["local_rows"] == TRAIN_B // 2 and not got["split"]
                assert (c["fused_rank_softmax"], c["trilinear_pool"],
                        c["masked_softmax_vqa"],
                        c["trilinear_pool_backward"]) == (
                    P14_STEPS, 2 * P14_STEPS, 0, 2 * P14_STEPS), c
            else:
                assert got["local_rows"] == TRAIN_B
                assert (c["fused_rank_softmax"], c["trilinear_pool"],
                        c["masked_softmax_vqa"], c["softmax_vqa_backward"],
                        c["trilinear_pool_backward"]) == (
                    0, 2 * P14_STEPS, P14_STEPS, P14_STEPS, 2 * P14_STEPS), c
    for r, res in enumerate(results):
        got = res["tp_blockwise"]
        c = got["launches"]
        path_counts[f"phase 14d tp=2 blockwise rank {r}"] = c
        errs = {}
        for ref_label, ref_run in (("blockwise", want_bw),
                                   ("standard", want)):
            errs[ref_label] = [
                max(abs(g[i] - w[i]) / abs(w[i]) for g, w in
                    zip(got["metrics"], ref_run)) for i in (0, 1)]
        print(f"phase 14d tp=2 blockwise (v_block_size {P14_BLOCK}) rank {r}: "
              f"{got['local_rows']} rows a step, {P14_STEPS} steps in "
              f"{got['seconds']:.2f} s (gloo over the host); (loss, grad "
              f"norm) {got['metrics']}; largest relative difference (loss, "
              f"pre-clip grad norm) from one process's blockwise steps "
              f"{[f'{e:.3e}' for e in errs['blockwise']]} (tol "
              f"{P14_TOL:.0e}), from its standard steps "
              f"{[f'{e:.3e}' for e in errs['standard']]} (tol "
              f"{TRAIN_TOL:.0e}); after {P14_STEPS} updates, against the "
              f"standard run's, the {p14_params_line(got['params'])}; "
              f"launches {c}")
        assert max(errs["blockwise"]) <= P14_TOL, (got, want_bw)
        assert max(errs["standard"]) <= TRAIN_TOL, (got, want)
        assert sum(cti_kernels(c).values()) == 0, c
        assert got["local_rows"] == TRAIN_B
        assert got["split"] == results[0]["tp"]["split"]
    split = results[0]["tp"]["split"]
    replicated_by_fits = [k for k in ("classifier.l2.v", "classifier.l2.b")
                          if k not in split]
    print(f"phase 14d split over the model axis ({len(split)} leaves): "
          f"{split}; left replicated by fits (3129 answers, odd): "
          f"{replicated_by_fits}")
    assert replicated_by_fits == ["classifier.l2.v", "classifier.l2.b"]
    for r, res in enumerate(results):
        k = res["tp_kernels"]
        print(f"phase 14d rank {r} kernels on the tp path's inputs against "
              f"their plain versions: K2 at {k['k2_shape']} (d / 2) "
              f"{k['k2_err']:.3e} (tol {K2_REL_TOL * k['k2_scale']:.3e}), K3 "
              f"at {k['k3_shape']} {k['k3_err']:.3e}, softmax backward "
              f"{k['bwd_err']:.3e} (tol {K3_TOL:.0e})")
        assert k["k2_shape"] == [TRAIN_B, V, CFG["h_mm"]]  # d / 2 = 512
        assert k["k2_err"] <= K2_REL_TOL * k["k2_scale"]
        assert max(k["k3_err"], k["bwd_err"]) <= K3_TOL
        for wire, s in res["store"].items():
            print(f"phase 14e rank {r}, {wire} wire: {s['describe']} of "
                  f"{s['rows']} rows; {s['equal']} of {P14_GATHERS} gathers "
                  f"of {TRAIN_B // 2} rows bit-equal to the replicated "
                  f"store's; {s['gather_ms']:.2f} ms a sharded gather (host "
                  "clock, gloo)")
            assert s["equal"] == P14_GATHERS
            assert s["local_rows"] == -(-s["rows"] // 2)
    k2 = torch.load(os.path.join(tmp.name, "k2_tp_inputs.pt"))
    tmp.cleanup()
    return {**k2, "err": max(r["tp_kernels"]["k2_err"] for r in results)}


ORBAX_STEPS = 2  # full-width CTI steps before the .orbax round trip


def phase15_orbax(path_counts, smi) -> None:
    """JAX's ``.orbax`` checkpoints without JAX, orbax or tensorstore: (a)
    the system's ``libzstd.so.1`` (``ldconfig -p``) loaded; (b) the goldens
    of ``tests/torch_orbax_goldens.py`` (written by JAX on a CPU) read by
    ``load_params_any`` and served on the card by ``InferenceSession``:
    the tiny CTI and TanModel, their logits within 1e-3 (MC 1e-4) of JAX's,
    K1 and K2 launched; the two-process save's split weight bit for bit;
    (c) ``ORBAX_STEPS`` full-width CTI steps at B=256, then
    ``save_checkpoint_orbax``, ``load_params_any`` and
    ``restore_train_state_orbax`` into a fresh state on the card: every
    parameter, Adamax moment and count bit-equal; the bytes and the write
    and read seconds (host clock)."""
    from vqatpu_torch.config import ModelConfig, TrainConfig
    from vqatpu_torch.data.mc_dataset import expand_mc_batch
    from vqatpu_torch.kernels import trilinear as K
    from vqatpu_torch.models import build_model
    from vqatpu_torch.serve import InferenceSession
    from vqatpu_torch.train import make_train_state, make_train_step, zstd
    from vqatpu_torch.train.checkpoints import (load_params_any,
                                                restore_orbax,
                                                restore_train_state_orbax,
                                                save_checkpoint_orbax)
    from vqatpu_torch.weights import load_jax_params, numpy_batch, numpy_params

    # (a)
    ldconfig = shutil.which("ldconfig") or "/sbin/ldconfig"
    found = [line.strip() for line in subprocess.run(
        [ldconfig, "-p"], capture_output=True, text=True).stdout.splitlines()
        if "zstd" in line]
    print(f"phase 15a ldconfig -p | grep zstd: {found}")
    zstd._lib()  # raises where the library is missing
    assert any(zstd.LIBRARY in line for line in found), found

    # (b)
    data = ROOT / "tests" / "data"
    for name, tol in (("cti", SERVE_TOL), ("tan", MC_GOLDEN_TOL)):
        z = np.load(data / f"torch_orbax_{name}.npz")
        mcfg = ModelConfig(**json.loads(str(z["config"])))
        epoch = int(z["epoch"])
        model = build_model(mcfg)
        t0 = time.perf_counter()
        load_jax_params(model, load_params_any(
            str(data / f"torch_orbax_{name}"), epoch, model))
        t_read = time.perf_counter() - t0
        b = numpy_batch(mcfg, int(z["n"]), seed=int(z["batch_seed"]),
                        boxes=int(z["boxes"]), real_boxes=int(z["real_boxes"]))
        if mcfg.task == "mc":
            b = expand_mc_batch(b)
        labels = (["match", "nonmatch"] if mcfg.task == "mc" else
                  [f"a{i}" for i in range(mcfg.num_ans_candidates)])
        K.reset_launches()
        got = InferenceSession(model, labels, device="cuda").logits(
            b["v"], b["b"], b["q"], b["a"])
        torch.cuda.synchronize()
        counts = path_counts[f"phase 15b {name} .orbax golden served"] = dict(
            K.launches)
        err = float(np.abs(got - z["logits"]).max())
        print(f"phase 15b JAX's {name} golden model_epoch{epoch}.orbax read "
              f"in {t_read:.3f} s, served on the card: {got.shape} logits, "
              f"max_abs_err against JAX's {err:.3e} (tol {tol:.0e}); "
              f"launches {counts}")
        assert got.shape == z["logits"].shape and err <= tol, (name, err)
        assert counts["fused_rank_softmax"] > 0, counts
        assert counts["trilinear_pool"] > 0, counts
    z = np.load(data / "torch_orbax_2proc.npz")
    golden = data / "torch_orbax_2proc" / f"model_epoch{int(z['epoch'])}.orbax"
    tree = restore_orbax(str(golden))
    split = tree["params"]["classifier"]["l1"]["v"]
    stores = sorted(p.name for p in golden.iterdir()
                    if p.name.startswith("ocdbt."))
    print(f"phase 15b the two-process golden ({stores}): "
          f"split weight {split.shape} bit-equal: "
          f"{bool(np.array_equal(split, z['v']))}, step {tree['step']}")
    assert np.array_equal(split, z["v"])
    assert int(tree["step"]) == int(z["step"])

    # (c)
    cfg = ModelConfig(**CFG)
    state = make_train_state(build_model(cfg), seed=0, device="cuda")
    step = make_train_step(state.model, TrainConfig(update_freq=1))
    gen = torch.Generator(device="cuda").manual_seed(15)
    K.reset_launches()
    for i in range(ORBAX_STEPS):
        step(state, numpy_batch(cfg, TRAIN_B, seed=1500 + i, boxes=V,
                                real_boxes=REAL_BOXES, target=True), 1e-3, gen)
    torch.cuda.synchronize()
    counts = path_counts["phase 15c full-width steps before the .orbax"] = \
        dict(K.launches)
    assert counts["fused_rank_softmax"] == ORBAX_STEPS, counts
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"model_epoch{ORBAX_STEPS - 1}.orbax")
        t0 = time.perf_counter()
        save_checkpoint_orbax(path, state, epoch=ORBAX_STEPS - 1)
        t_write = time.perf_counter() - t0
        files = [os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs]
        n_bytes = sum(os.path.getsize(f) for f in files)
        raw = sum(t.numel() * t.element_size() for t in
                  [*state.model.parameters(), *state.optimizer.m,
                   *state.optimizer.u])
        t0 = time.perf_counter()
        params = load_params_any(tmp, ORBAX_STEPS - 1, None)
        t_params = time.perf_counter() - t0
        fresh = make_train_state(build_model(cfg), seed=1, device="cuda")
        t0 = time.perf_counter()
        fresh, start = restore_train_state_orbax(path, fresh)
        torch.cuda.synchronize()
        t_state = time.perf_counter() - t0
    mine, theirs = state.model.state_dict(), fresh.model.state_dict()
    equal = all(torch.equal(mine[k], theirs[k]) for k in mine) and all(
        torch.equal(a, b) for a, b in zip(
            state.optimizer.m + state.optimizer.u,
            fresh.optimizer.m + fresh.optimizer.u))
    equal = equal and (fresh.optimizer.count, fresh.step, start) == (
        state.optimizer.count, state.step, ORBAX_STEPS)
    equal = equal and np.float32(fresh.optimizer.lr) == np.float32(
        state.optimizer.lr)  # JAX keeps the learning rate as float32
    n_leaves = len(files)
    print(f"phase 15c full-width CTI TrainState after {ORBAX_STEPS} steps at "
          f"B={TRAIN_B}: save_checkpoint_orbax {n_bytes} bytes in {n_leaves} "
          f"files ({raw} bytes of params and Adamax moments) written in "
          f"{t_write:.3f} s ({n_bytes / t_write / 1e6:.1f} MB/s); "
          f"load_params_any (every leaf, as serving does) {t_params:.3f} s; "
          f"restore_train_state_orbax onto the card {t_state:.3f} s "
          f"({n_bytes / t_state / 1e6:.1f} MB/s); bit-equal: {equal}; "
          f"{len(params)} param modules; host clock; {smi}")
    assert equal


# every float32 product shape (M, N, K) of the two cells that WNLinear can
# route (CTI B=1024 x V=50, the grid's 256 rows x 196 cells; K = v_dim or
# num_hid), then two near the rule's edge: 32 and 64 output tiles at N = 512
P16_SWEEP = [(51200, 512, 2048), (51200, 1024, 2048), (50176, 512, 2048),
             (50176, 1024, 2048), (12288, 512, 1024), (12288, 1024, 1024),
             (3072, 512, 1024), (3072, 1024, 1024), (1536, 512, 1024),
             (1536, 1024, 1024), (1024, 1024, 1024), (1024, 2048, 1024),
             (256, 1024, 1024), (256, 2048, 1024), (1024, 512, 1024),
             (2048, 512, 1024)]
# ragged M, N and K, through linear_f32 (the route leaves them to cuBLAS)
P16_RAGGED = [(1000, 196, 2048), (777, 260, 100), (130, 1024, 2048)]


def phase16_linear(smi) -> list:
    """The split-bf16 GEMM against float64, cuBLAS and its plain version,
    timed beside cuBLAS float32 and the plain version, and the route's
    sweep (module docstring, 16)."""
    from vqatpu_torch.kernels import linear as L
    from vqatpu_torch.kernels.trilinear import launches
    from vqatpu_torch.kernels.timing import sleep_cycles_per_ms, time_ms
    from vqatpu_torch.numerics import require_f32_math

    require_f32_math()
    dev = torch.device("cuda")
    _, (peak_bw, peak_f32, peak_bf16) = peaks_for(torch.cuda.get_device_name(0))

    def operands(M, N, K, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(M, K, device=dev, generator=g).relu()  # features >= 0
        w = torch.randn(N, K, device=dev, generator=g) / K ** 0.5
        dy = torch.randn(M, N, device=dev, generator=g) / M ** 0.5
        return x, w, dy

    def gemms(x, w, dy):
        M, K = x.shape
        N = w.shape[0]
        return {"forward": lambda: L._gemm("forward", x, w, M, N, K),
                "wgrad": lambda: L._gemm("wgrad", dy, x, M, N, K),
                "dgrad": lambda: L._gemm("dgrad", dy, w, M, N, K)}

    def cublas(x, w, dy):
        return {"forward": lambda: torch.nn.functional.linear(x, w),
                "wgrad": lambda: dy.t().mm(x), "dgrad": lambda: dy.mm(w)}

    def with_autograd(fn, x, w, dy):
        """fn(x, w), and its input and weight gradients for cotangent dy"""
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(xg, wg)
        dx, dw = torch.autograd.grad(y, (xg, wg), dy)
        return {"forward": y.detach(), "dgrad": dx, "wgrad": dw}

    def largest(a, b):
        return (a.double() - b.double()).abs().max().item()

    routed = [s for s in P16_SWEEP if L.fits_kernel(*s)]
    for M, N, Kd in routed + P16_RAGGED:
        x, w, dy = operands(M, N, Kd, M + N + Kd)
        fn = L.routed_linear if (M, N, Kd) in routed else L.linear_f32
        before = dict(launches)
        got = with_autograd(fn, x, w, dy)
        torch.cuda.synchronize()
        moved = {k: launches[k] - before[k] for k in GEMM_KERNELS}
        if moved != dict.fromkeys(GEMM_KERNELS, 1):
            raise SystemExit(f"{fn.__name__} at {(M, N, Kd)}: launches {moved}")
        lib = with_autograd(torch.nn.functional.linear, x, w, dy)
        plain = {"forward": L.split_bf16x6_mm(x, w),
                 "wgrad": L.split_bf16x6_mm(dy.T.contiguous(), x.T.contiguous()),
                 "dgrad": L.split_bf16x6_mm(dy, w.T.contiguous())}
        xd, wd, dyd = x.double(), w.double(), dy.double()
        refs = {"forward": xd @ wd.T, "wgrad": dyd.T @ xd, "dgrad": dyd @ wd}
        ratios, to_plain = {}, {}
        for k, ref in refs.items():
            err, err_lib = largest(got[k], ref), largest(lib[k], ref)
            gap, gap_lib = largest(got[k], plain[k]), largest(lib[k], plain[k])
            ratios[k], to_plain[k] = round(err / err_lib, 3), round(gap / gap_lib, 3)
            if err > 2 * err_lib or gap > 2 * gap_lib:
                raise SystemExit(
                    f"{fn.__name__} {k} at {(M, N, Kd)}: float64 error {err:.3e} "
                    f"(cuBLAS float32's {err_lib:.3e}), from the plain version "
                    f"{gap:.3e} (cuBLAS's {gap_lib:.3e})")
        again = with_autograd(fn, x, w, dy)["wgrad"]
        if not torch.equal(got["wgrad"], again):
            raise SystemExit(f"{fn.__name__} wgrad at {(M, N, Kd)}: two calls differ")
        print(f"16: {fn.__name__} {(M, N, Kd)} with autograd: float64 error / "
              f"cuBLAS float32's {ratios}; distance from the plain version / "
              f"cuBLAS's {to_plain}; wgrad bitwise repeatable")
        del x, w, dy, xd, wd, dyd, refs, got, lib, plain, again

    cycles = sleep_cycles_per_ms()
    flush = torch.empty(128 * 2**20 // 4, device=dev)  # > the 50 MB L2
    rows = []
    for M, N, K in P16_SWEEP:
        x, w, dy = operands(M, N, K, 16)
        ours, lib = gemms(x, w, dy), cublas(x, w, dy)
        row = {"shape": [M, N, K], "tiles": -(-M // L.TILE) * -(-N // L.TILE)}
        for k in ("forward", "wgrad", "dgrad"):
            row[f"{k}_ms"] = time_ms(ours[k], flush, cycles)[0]
            row[f"cublas_{k}_ms"] = time_ms(lib[k], flush, cycles)[0]
        flop = 2 * M * N * K
        bytes_fwd = 4 * (M * K + N * K + M * N)
        row["bound_ms"] = max(bytes_fwd / peak_bw, 6 * flop / peak_bf16) * 1e3
        row["f32_bound_ms"] = max(bytes_fwd / peak_bw, flop / peak_f32) * 1e3
        row["fwd_wgrad_over_cublas"] = (
            (row["forward_ms"] + row["wgrad_ms"])
            / (row["cublas_forward_ms"] + row["cublas_wgrad_ms"]))
        row["all_over_cublas"] = (
            sum(row[f"{k}_ms"] for k in ("forward", "wgrad", "dgrad"))
            / sum(row[f"cublas_{k}_ms"] for k in ("forward", "wgrad", "dgrad")))
        row["routed"] = L.fits_kernel(M, N, K)
        if M >= 50000:
            row["plain_forward_ms"] = time_ms(
                lambda: L.split_bf16x6_mm(x, w), flush, cycles, runs=5)[0]
        print(f"16: {(M, N, K)}: forward {row['forward_ms']:.4f} ms (cuBLAS "
              f"{row['cublas_forward_ms']:.4f}), wgrad {row['wgrad_ms']:.4f} "
              f"({row['cublas_wgrad_ms']:.4f}), dgrad {row['dgrad_ms']:.4f} "
              f"({row['cublas_dgrad_ms']:.4f}); forward + wgrad "
              f"{row['fwd_wgrad_over_cublas']:.3f}x cuBLAS's, all three "
              f"{row['all_over_cublas']:.3f}x; bound {row['bound_ms']:.4f} ms "
              f"(float32 {row['f32_bound_ms']:.4f}); routed {row['routed']}")
        rows.append(row)
        del x, w, dy
    print(f"16: {smi}")
    print(json.dumps({"linear_f32": rows}))
    return rows


def sass_hmma(lib: Path) -> dict:
    """Each kernel of the built library ``lib`` and its number of HMMA
    (tensor-core) instructions, from ``cuobjdump -sass``."""
    from vqatpu_torch.kernels import build
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(r"\bHMMA\b", line):
            counts[fn] += 1
    if not any("mma_kernel" in fn for fn in counts):
        raise SystemExit(f"cuobjdump found no tensor-core kernel in {lib}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from vqatpu_torch.config import ModelConfig
    from vqatpu_torch.data import Dictionary
    from vqatpu_torch.kernels import build, probe
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
    # the shipped sources and, for phase 4d, copies of K1's and K2's with
    # the bf16 entry points routed to the CUDA-core design, all nvcc at once
    t0 = time.perf_counter()
    cuda_core = {}
    copies = {
        "k1_cuda_core_design": probe.edited(
            (build.CSRC / "rank_softmax.cu").read_text(), probe.K1_CUDA_CORES),
        "k2_cuda_core_design": probe.edited(
            (build.CSRC / "tri_pool.cu").read_text(), probe.K2_CUDA_CORES)}
    cuda_core_build = threading.Thread(
        target=lambda: cuda_core.update(probe.build_all(copies)))
    cuda_core_build.start()
    outputs = build.build(build.SOURCES, ptxas_info=True)
    cuda_core_build.join()
    if len(cuda_core) != 2:
        raise SystemExit("the CUDA-core design's copies did not build")
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(outputs)} and "
          f"the CUDA-core design's K1 and K2")
    for name, out in outputs.items():
        fn = None
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {name}: {line.strip()}")
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                              line)
            if (spill and fn and ("mma_kernel" in fn or "tri_pool_backward" in fn
                                  or "linear_f32" in fn)
                    and spill.groups() != ("0", "0")):
                raise SystemExit(f"{fn} spills: {line.strip()}")
    # the tensor-core kernels (K1's and K2's bf16 instances, every
    # instance of K2's backward) run HMMA, the others never do
    for name in ("rank_softmax", "tri_pool", "tri_pool_backward"):
        for fn, n_hmma in sass_hmma(build.library_path(name)).items():
            on_tc = "mma_kernel" in fn
            print(f"  {name}: {n_hmma} HMMA in {fn}")
            if on_tc != (n_hmma > 0):
                raise SystemExit(f"{fn}: {n_hmma} HMMA instructions; the "
                                 "tensor-core kernels need them, the others "
                                 "must have none")

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

    def ragged_inputs(b: int, v_len: int, seed: int, G: int = 2, D: int = 1024,
                      q_: int = Q, a_: int = A, R: int = 32, X: int = 16):
        """Random inputs of K1, K2 and K3 with ragged box counts; with b > 1
        the last sample is fully masked, with b = 1 all its boxes are real."""
        g = torch.Generator().manual_seed(seed)
        lens = torch.randint(1, v_len + 1, (b,), generator=g)
        if b == 1:
            lens[0] = v_len
        mask = torch.arange(v_len)[None] < lens[:, None]
        mask[-1] &= b == 1
        v_r = torch.randn(b, v_len, R, X, generator=g)
        tqa = torch.randn(b, q_, a_, R, X, G, generator=g) / (R * X) ** 0.5
        att = torch.rand(b, v_len, q_, a_, G, generator=g)
        pool = [t.to(dev) for t in (torch.randn(b, v_len, D, generator=g),
                                    torch.randn(b, q_, D, generator=g),
                                    torch.randn(b, a_, D, generator=g))]
        # one glimpse of the attention, strided, as the model passes it
        att = att.to(dev)
        pool.append(att[..., -1])
        logits = 3 * torch.randn(b, v_len, q_, a_, G, generator=g)
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
                   (v_r, tqa), cotangent((B_, V_) + tqa.shape[1:3]
                                         + tqa.shape[-1:], 1),
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

    # -- 3c. K2's backward kernel against its plain version ---------------
    def check_k2_backward(label, args, rel=GRAD_REL_TOL, f64=False):
        """K2's backward kernel (``_tri_pool_backward_kernel``) on ``args`` =
        (g, vt, qt, at, w) against ``trilinear_pool_grads``, the four
        ``torch.bmm`` of PR 2-12: within ``rel`` of each plain cotangent's
        largest magnitude, in its primal's dtype, finite, the same bits
        from a second call, and, where sample 1's ``w`` is all zero, its
        gvt, gqt and gat exactly zero.  With ``f64``, each cotangent's
        largest error against a float64 ``trilinear_pool_grads`` is
        printed beside the float32 plain version's, and must be no more
        than twice it for every cotangent of a float32 ``vt`` and for gw."""
        got = K._tri_pool_backward_kernel(*args)
        again = K._tri_pool_backward_kernel(*args)
        want = K.trilinear_pool_grads(*args)
        ref = (K.trilinear_pool_grads(*args, dtype=torch.float64) if f64
               else (None,) * 4)
        torch.cuda.synchronize()
        parts, worst, ok = [], 0.0, True
        for name, x, y, z, p, r in zip(("gvt", "gqt", "gat", "gw"), got, want,
                                       again, args[1:], ref):
            err = (x.float() - y).abs().max().item() if y.numel() else 0.0
            tol = rel * y.abs().max().item() if y.numel() else 0.0
            same = torch.equal(x, z)
            ok &= (err <= tol and same and x.dtype == p.dtype
                   and bool(x.isfinite().all()))
            worst = max(worst, err)
            vs64 = ""
            if r is not None and y.numel():
                e64 = (x.double() - r).abs().max().item()
                p64 = (y.double() - r).abs().max().item()
                held = args[1].dtype == torch.float32 or name == "gw"
                ok &= not held or e64 <= 2 * p64
                vs64 = (f", float64 error {e64:.3e} against the plain "
                        f"version's {p64:.3e}" + (" (at most 2x)" if held else ""))
            parts.append(f"{name} {err:.3e} (tol {tol:.3e}, {x.dtype}"
                         + ("" if same else ", NOT bit-equal") + vs64 + ")")
        w = args[4]
        if w.shape[0] > 1 and not w[1].any():
            zero = all(not x[1].any() for x in got[:3])
            ok &= zero
            parts.append(f"zero-w sample's gvt, gqt, gat all zero: {zero}")
        print(f"K2 backward {label}: " + ", ".join(parts))
        if not ok:
            raise SystemExit(f"K2's backward disagrees with its plain version "
                             f"or repeats other bits: {label}")
        return worst

    def check_k2_backward_bits(label, args, rows=slice(2, 5)):
        """A sample's cotangents from K2's backward kernel are the same bits
        in a batch of 3 (``rows`` of ``args``, copied) as in the whole."""
        full = K._tri_pool_backward_kernel(*args)
        part = K._tri_pool_backward_kernel(*(x[rows].contiguous() for x in args))
        same = all(torch.equal(x[rows], y) for x, y in zip(full, part))
        print(f"K2 backward {label}: samples {rows.start}-{rows.stop - 1} "
              f"alone the same bits as in the batch: {same}")
        if not same:
            raise SystemExit(f"K2's backward depends on the batch: {label}")

    def bwd_inputs(b, v_len, seed, D=1024, q_=Q, a_=A, vt_dtype=torch.float32,
                   qa_dtype=torch.float32):
        """(g, vt, qt, at, w) of K2's backward: ``w`` one strided glimpse of
        a [b, v_len, q_, a_, 2] attention whose sample 1 is all zero."""
        g = torch.Generator().manual_seed(seed)
        vt, qt, at = (torch.randn(b, n, D, generator=g).to(dev, dt)
                      for n, dt in ((v_len, vt_dtype), (q_, qa_dtype),
                                    (a_, qa_dtype)))
        att = torch.rand(b, v_len, q_, a_, 2, generator=g).to(dev)
        if b > 1:
            att[1] = 0
        return torch.randn(b, D, generator=g).to(dev), vt, qt, at, att[..., 1]

    # the training batch's inputs, ragged V=293, and the kernel's edges:
    # one box, V=2048 (phase 13's), tp's D=512, D off the 256-d span, B=0,
    # Q*A=72 (the <6, 6> instance, 2 passes) and 256 (<4, 8>, 8 passes)
    k2_model_args = (cotangent((TRAIN_B, d["vt"].shape[-1]), 7), d["vt"],
                     d["qt"], d["at"], d["att"][..., 0])
    check_k2_backward(f"B={TRAIN_B} V={V} (the model's inputs)", k2_model_args,
                      f64=True)
    check_k2_backward_bits(f"B={TRAIN_B} V={V}", k2_model_args)
    del k2_model_args
    check_k2_backward("ragged V=293", (cotangent((4, 1024), 8), *k2_big[:3],
                                       att_big[..., 1]))
    for n, v_len, D_, q_, a_ in ((1, 1, 1024, Q, A), (3, 2048, 1024, Q, A),
                                 (3, V, 512, Q, A), (3, 65, 1016, Q, A),
                                 (0, V, 1024, Q, A), (3, V, 1024, Q, 6),
                                 (3, 293, 264, 32, 8), (3, 293, 264, 5, 2)):
        check_k2_backward(f"edge B={n} V={v_len} D={D_} Q*A={q_ * a_}",
                          bwd_inputs(n, v_len, 90 + n + v_len, D_, q_, a_))
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
    # the tensor-core instances' reach: ragged V=2048 for K1 (32 V tiles of
    # 64 rows, the logits parked in att) and R*X that ends 8 or 40 columns
    # into its last 64-column chunk (520 = 8 x 65, 104 = 8 x 13); Q=20, A=5
    # for K2 (its multi-pass instance, 6 question tokens a pass)
    k2_wide = ragged_inputs(2, V, seed=70, q_=20, a_=5)[1]
    errs16["edges"] = (
        max(check_k1("bf16 ragged V=2048", to_bf16(ragged_inputs(4, 2048, seed=1)[0])),
            check_k1("bf16 edge B=2 V=57 G=2 R*X=520",
                     to_bf16(ragged_inputs(2, 57, seed=71, R=65, X=8)[0])),
            check_k1("bf16 edge B=2 V=65 G=1 R*X=104",
                     to_bf16(ragged_inputs(2, 65, seed=72, G=1, R=13, X=8)[0]))),
        max(check_k2("bf16 edge B=2 V=50 Q=20 A=5", to_bf16(k2_wide, 3)),
            check_k2("bf16 edge B=2 V=50 Q=20 A=5 (qt, at f32)",
                     to_bf16(k2_wide, 1))))
    del k2_wide
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
    for g_, args in ((0, (d["vt"], d["qt"], d["at"])),
                     (1, (d["vt1"], d["qt1"], d["at1"]))):
        k2_args = (cotangent((TRAIN_B, d["vt"].shape[-1]), 14 + g_), *args,
                   d["att"][..., g_])
        check_k2_backward(f"bf16 B={TRAIN_B} V={V} glimpse {g_}", k2_args,
                          BF16_GRAD_REL_TOL, f64=True)
        check_k2_backward_bits(f"bf16 B={TRAIN_B} V={V} glimpse {g_}", k2_args)
        del k2_args
    for n, v_len, D_, q_, a_, qa_dtype in (
            (1, 1, 1024, Q, A, torch.float32), (3, 2048, 1024, Q, A, bf16),
            (3, 65, 1016, Q, A, torch.float32), (0, V, 1024, Q, A, bf16),
            (3, V, 1024, Q, 6, bf16), (3, V, 1024, Q, 6, torch.float32),
            (3, 293, 264, 32, 8, bf16)):
        check_k2_backward(
            f"bf16 edge B={n} V={v_len} D={D_} Q*A={q_ * a_} (qt, at "
            f"{str(qa_dtype)[6:]})", bwd_inputs(n, v_len, 190 + n + v_len, D_,
                                                q_, a_, bf16, qa_dtype),
            BF16_GRAD_REL_TOL)
    del d, v_r, tqa, mask

    def clone_args(args):
        return tuple(x.detach().clone().requires_grad_(x.requires_grad)
                     for x in args)

    def timed(name, label, fns, args, nbytes, flops, row=None, peak_ops=None,
              earlier=None, earlier_key="cuda_core",
              earlier_label="the CUDA-core design"):
        """Times of the kernel, its plain version and the library yardstick
        (``fns``, each called on ``args``) beside the card's bound: each as
        a single call, and the kernel and the yardstick back to back over
        rotating copies of ``args`` (``b2b``, no launch or event floor);
        with ``row`` = (source, replaces, err), the kernel's row of the
        JSON line.  ``peak_ops`` is the peak of the operations' type (f32
        CUDA cores by default).  ``earlier``, an earlier design of the
        kernel called on the same ``args``, is timed both ways too, beside
        it (``{earlier_key}_ms``, ``{earlier_key}_b2b_ms``; by default the
        bf16 instances' CUDA-core design)."""
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
        if earlier is not None:
            cuda_core_ms, _ = time_ms(lambda: earlier(*args), flush, cycles_per_ms)
            cuda_core_b2b = time_back_to_back_ms(
                [lambda c=c: earlier(*c) for c in calls], cycles_per_ms)
        del copies, calls
        r = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_flops),
             "bound_by": "bytes" if t_bytes >= t_flops else "operations",
             "library_ms": lib_ms, "b2b_ms": b2b, "library_b2b_ms": lib_b2b}
        if earlier is not None:
            r.update({f"{earlier_key}_ms": cuda_core_ms,
                      f"{earlier_key}_b2b_ms": cuda_core_b2b})
        print(f"{name} {label}: {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} "
              f"us, library {lib_ms * 1e3:.1f} us, bound "
              f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}: "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP); host enqueue "
              f"{host * 1e3:.1f} / {plain_host * 1e3:.1f} / "
              f"{lib_host * 1e3:.1f} us; b2b {b2b * 1e3:.2f} us, library b2b "
              f"{lib_b2b * 1e3:.2f} us ({n_copies} input copies)"
              + ("" if earlier is None else
                 f"; {earlier_label} {cuda_core_ms * 1e3:.1f} us, b2b "
                 f"{cuda_core_b2b * 1e3:.2f} us"))
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
        FLOP of K1 (Q and A from ``tqa``)."""
        B_, V_, R_, X_ = v_r.shape
        G_, QA_ = tqa.shape[-1], tqa.shape[1] * tqa.shape[2]
        return (nbytes_of(v_r, tqa) + B_ * V_ * QA_ * G_ * f32 + mask.numel(),
                2 * B_ * G_ * V_ * R_ * X_ * QA_)

    def k2_cost(vt, qt, at, w):
        """Bytes and FLOP of K2, in its order: V first, then Q, then A."""
        B_, V_, D_ = vt.shape
        A_ = at.shape[1]
        QA_ = qt.shape[1] * A_
        return (nbytes_of(vt, qt, at) + (B_ * V_ * QA_ + B_ * D_) * f32,
                2 * B_ * D_ * (V_ * QA_ + QA_ + A_))

    def k1_library(v_r, tqa, mask, keep):
        """One bmm, then a masked softmax over the flattened (V, Q, A) in
        float32; ``keep`` is the mask repeated over (Q, A)."""
        B_, V_, R_, X_ = v_r.shape
        G_, QA_ = tqa.shape[-1], tqa.shape[1] * tqa.shape[2]
        lg = torch.bmm(v_r.reshape(B_, V_, R_ * X_), tqa.permute(
            0, 3, 4, 1, 2, 5).reshape(B_, R_ * X_, QA_ * G_))
        return torch.softmax(lg.reshape(B_, V_ * QA_, G_).masked_fill(
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
        QA_ = d_["qt"].shape[1] * d_["at"].shape[1]
        k1_args = k1_of(d_) + (d_["mask"].repeat_interleave(QA_, 1)[..., None],)
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
        def k1_cuda_cores(v_r, tqa, mask, keep):
            """K1 bf16 of the CUDA-core design (f32 FMAs on the CUDA
            cores), a bare launch of its copy built in phase 2."""
            B_, V_, R_, X_ = v_r.shape
            G_ = tqa.shape[-1]
            out = torch.empty((B_, V_, Q, A, G_), device=dev)
            assert cuda_core["k1_cuda_core_design"].rank_softmax_forward_bf16(
                v_r.data_ptr(), tqa.data_ptr(), mask.data_ptr(), out.data_ptr(),
                B_, V_, R_ * X_, QA, G_, 0, K._stream(dev)) == 0
            return out

        def k2_cuda_cores(vt, qt, at, w):
            """K2 bf16 of the CUDA-core design, a bare launch of its copy."""
            out = torch.empty((vt.shape[0], vt.shape[2]), device=dev)
            assert cuda_core["k2_cuda_core_design"].tri_pool_forward_bf16(
                vt.data_ptr(), qt.data_ptr(), at.data_ptr(), w.data_ptr(),
                *w.stride(), out.data_ptr(), *vt.shape[:2], Q, A, vt.shape[2],
                int(qt.dtype == bf16), 0, K._stream(dev)) == 0
            return out

        def time_forwards_bf16(d_, label, rows=None):
            """As time_forwards, for the bf16 instances: bounds with bf16
            bytes and the bf16 tensor cores' peak (the least time the card
            could take for the same work), bf16 yardsticks, and the CUDA-core
            design on the same inputs; K2 at both glimpses."""
            k1_args = k1_of(d_) + (d_["mask"].repeat_interleave(QA, 1)[..., None],)
            out = [timed("fused_rank_softmax_bf16", label,
                         (lambda v, t, m, k: K.fused_rank_softmax(v, t, m),
                          lambda v, t, m, k: K.fused_rank_softmax_ref(v, t, m),
                          k1_library), k1_args, *k1_cost(*k1_args),
                         row=None if rows is None else rows[0],
                         peak_ops=peak_bf16, earlier=k1_cuda_cores)]
            for g_, args, row in ((0, k2_of(d_), None if rows is None else rows[1]),
                                  (1, k2_glimpse1(d_), None)):
                out.append(timed(
                    "trilinear_pool_bf16", f"{label} glimpse {g_}",
                    (K.trilinear_pool, K.trilinear_pool_ref, k2_einsum_in(bf16)),
                    args, *k2_cost(*args), row=row, peak_ops=peak_bf16,
                    earlier=k2_cuda_cores))
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

    def k2_fb_bmm(vt, qt, at, a, g):
        """K2's forward kernel, then its cotangents as PR 2-12 computed
        them: the four ``torch.bmm`` of ``trilinear_pool_grads``."""
        args = (vt.detach(), qt.detach(), at.detach(), a.detach()[..., 0])
        return K._tri_pool_kernel(*args), K.trilinear_pool_grads(g, *args)

    def k2_bwd_cost(g, vt, qt, at, w):
        """Bytes (g, vt, qt, at and w read once; gvt, gqt and gat in their
        primals' dtypes and gw in float32 written once) and FLOP (the three
        V x Q*A x D products a sample) of K2's backward."""
        B_, V_, D_ = vt.shape
        QA_ = qt.shape[1] * at.shape[1]
        return (nbytes_of(g) + 2 * (nbytes_of(vt, qt, at) + B_ * V_ * QA_ * f32),
                3 * 2 * B_ * V_ * QA_ * D_)

    def time_k2_backward(label, args, rel=GRAD_REL_TOL, peak_ops=None):
        """The JSON row of K2's backward on ``args`` = (g, vt, qt, at, w),
        held to its plain version on them first (``rel``): the kernel beside
        its plain version and PR 2-12's route, both ``trilinear_pool_grads``
        (the four ``torch.bmm``, which the port no longer calls), and its
        bound."""
        err = check_k2_backward(f"{label} (the timed inputs, w's strides "
                                f"{args[4].stride()})", args, rel, f64=True)
        with torch.no_grad():
            return timed(
                "trilinear_pool_backward" + ("_bf16" if args[1].dtype == bf16
                                             else ""), label,
                (K._tri_pool_backward_kernel, K.trilinear_pool_grads,
                 K.trilinear_pool_grads), args, *k2_bwd_cost(*args),
                row=("tri_pool_backward.cu", "vqatpu/kernels/trilinear.py:415",
                     err), peak_ops=peak_ops)

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
            k2_fb_bytes, k2_fb_flops, earlier=k2_fb_bmm, earlier_key="bmm",
            earlier_label="the forward kernel and the four torch.bmm of "
            "PR 2-12")}
    # K2's backward alone: float32, and bf16 at both glimpses
    rows.append(time_k2_backward(f"B={B} (one glimpse)", (
        g2, vt.detach(), qt.detach(), at.detach(), att.detach()[..., 0])))
    d16 = path_inputs_bf16(TRAIN_B, seed=286, pad_row=True)
    for g_, args in ((0, k2_of(d16)), (1, k2_glimpse1(d16))):
        rows.append(time_k2_backward(
            f"B={B} glimpse {g_}" + (" (qt, at f32)" if g_ else ""),
            (g2, *args), BF16_GRAD_REL_TOL, peak_ops=peak_bf16))
    del flush, d, d16, logits, mask, att, cot, v_r, tqa, vt, qt, at, g1, g2

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
        assert (sum(cti_kernels(counts).values())
                == (1 + cfg.gamma) * sess.forwards), counts
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
        "--model", "cti", "--port", "0", "--device", "cuda", "--feature_split", "small",
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

    def train_throughput(label, batch, windows=WINDOWS, mcfg=None,
                         mc_scoring=False, **tcfg):
        """samples/s of the train step at B=256 with dropout on (bench.py's
        loop: windows of ITERS steps, each ending in a value readback), the
        median step on CUDA events, the host's time inside a step call
        (near the step time, the host sets the pace), the calls in one
        step that wait for the card (``torch.cuda.set_sync_debug_mode``),
        the launches per step, and a ``torch.profiler`` table of 3 steps
        with the card's busy share.
        ``batch`` is a batch, or a function that gives each step's.
        ``mcfg`` (bench.py's CTI by default) and ``mc_scoring`` choose the
        model and its score.
        -> (launch counts, steps, median step ms)."""
        next_batch = batch if callable(batch) else (lambda: batch)
        state = make_train_state(build_model(mcfg or cfg), seed=0,
                                 device="cuda")
        step = make_train_step(state.model, TrainConfig(
            update_freq=1, batch_size=TRAIN_B, **tcfg), mc_scoring=mc_scoring)
        gen = torch.Generator(device=dev).manual_seed(1)
        for _ in range(WARMUP):
            m = step(state, next_batch(), 1e-3, gen)
        float(m["loss"])
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as waits:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                m = step(state, next_batch(), 1e-3, gen)
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
                m = step(state, next_batch(), 1e-3, gen)
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
        # the operands K2's backward kernel gets in the step: w's strides
        # and whether vt is contiguous, set by set
        seen, bwd_kernel = set(), K._tri_pool_backward_kernel

        def seeing(g_, vt_, qt_, at_, w_):
            seen.add((tuple(w_.shape), w_.stride(), vt_.is_contiguous()))
            return bwd_kernel(g_, vt_, qt_, at_, w_)

        K._tri_pool_backward_kernel = seeing
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(prof_steps):
                    m = step(state, next_batch(), 1e-3, gen)
                torch.cuda.synchronize()
        finally:
            K._tri_pool_backward_kernel = bwd_kernel
        averages = prof.key_averages()
        print(f"torch.profiler, {prof_steps} training steps, {label} (times "
              f"summed over them):")
        print(averages.table(sort_by="self_device_time_total", row_limit=10))
        on_card = [e for e in averages if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3 / prof_steps
        # K1's and K2's float32 kernels, or their tensor-core bf16 ones
        kernels = {"rank_softmax": ("rank_softmax_kernel", "rank_softmax_mma_kernel"),
                   "tri_pool": ("tri_pool_kernel", "tri_pool_mma_kernel"),
                   "softmax_backward": ("softmax_backward_kernel",),
                   "tri_pool_backward": ("tri_pool_backward",)}
        own = {label: sum(e.self_device_time_total for e in on_card
                          if any(n in e.key for n in names)) / 1e3 / prof_steps
               for label, names in kernels.items()}
        print(f"profiled step, {label}: {busy_ms:.3f} ms of kernels on the "
              f"card, {busy_ms / step_ms:.1%} of the {step_ms:.3f} ms median "
              f"step (idle {1 - busy_ms / step_ms:.1%}); the port's CUDA "
              f"kernels per step (L2 warm): "
              + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in own.items()))
        assert all(v > 0 for v in own.values()), own
        per_launch = {name: (sum(e.self_device_time_total for e in on_card if name in e.key),
                             sum(e.count for e in on_card if name in e.key))
                      for name in ("tri_pool_backward_mma_kernel",
                                   "tri_pool_backward_gw_sum_kernel")}
        print(f"profiled step, {label}: K2's backward in the step (L2 warm), "
              + ", ".join(f"{name} {n} launches, {t / max(n, 1):.1f} us a launch"
                          for name, (t, n) in per_launch.items())
              + f"; w [shape, strides] and vt contiguous as the kernel got them: "
              f"{sorted(seen)}")
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
    assert counts["trilinear_pool_backward"] == cfg.gamma * n_steps, counts
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
    assert counts["trilinear_pool_backward_bf16"] == cfg.gamma * n_steps, counts
    assert counts["fused_rank_softmax"] == counts["trilinear_pool"] == 0, counts
    assert counts["trilinear_pool_backward"] == 0, counts
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
        assert counts["trilinear_pool_backward"] == cfg.gamma * n_steps, counts
    del db, batch, host8

    # -- 9. the entry points on the card: ffoe_train, resume, ffoe_test ---
    p9 = phase9(cfg, path_counts, wire_step_ms["float32"], step_ms)

    # -- 10. the host runtime, the card-resident store, the loop 3 ways ---
    phase10_host_runtime(cfg)
    phase10_int8_serving(cfg, model, labels, golden, gb, path_counts)
    phase10_store(cfg, dev, train_throughput, path_counts, step_ms,
                  wire_step_ms)
    phase10_loop(cfg, path_counts, p9)
    phase10_depth(cfg, path_counts, p9)

    # -- 11. BAN (counter, distillation) and SAN: serve, train, evaluate --
    del model
    models = phase11_logits(path_counts)
    phase11_serving(models, path_counts, median_ms)
    phase11_training(models, path_counts)
    del models
    phase11_kd_loop(path_counts, p9)

    # -- 12. the Visual7W multiple-choice models (TanModel, BAN-MC, SAN-MC) -
    def phase12_kernels(tan) -> list:
        """(b) K1, K2 and the softmax backward at TanModel's shapes: 64
        questions, 256 candidate rows (the last fully masked), Q=12, A=6
        (Q*A=72), V=50 with 44 real boxes and the grid path's V=196, from
        the full-width model's own projections; float32 and bf16, forward
        and backward, against their plain versions; timed beside their
        bounds and library calls (the rows of the JSON line)."""
        tan16 = copy.deepcopy(tan).to(bf16)
        qa = Q * MC_A
        out_rows = []

        def mc_inputs(m, grid, dtype):
            _, r = mc_rows(m.cfg, MC_BATCH, seed=1600 + int(grid), grid=grid)
            v = torch.from_numpy(r["v"]).to(dev, dtype)
            mask = v.abs().sum(-1) != 0
            mask[-1] = False  # a padded row, as a bucket's
            with torch.inference_mode():
                q_s = m.q_emb(m.w_emb(torch.from_numpy(r["q"]).to(dev)))
                a_s = m.ans_emb(m.wa_emb(torch.from_numpy(r["a"]).to(dev)))
                v_r, q_r, a_r, T = m.v_att.tc.rank_projections(v, q_s, a_s)
                tqa = K.precontract_qa(q_r, a_r, T)
                att = K.fused_rank_softmax_ref(v_r, tqa, mask)
                tn0, tn1 = m.t_net0, m.t_net1
                vt, qt, at = tn0.v_tucker(v), tn0.q_tucker(q_s), tn0.a_tucker(a_s)
                joint = K.trilinear_pool_ref(vt, qt, at, att[..., 0])[:, None]
                q1, a1 = m.q_prj0(joint) + q_s, m.a_prj0(joint) + a_s
                d = dict(v_r=v_r, tqa=tqa, mask=mask, att=att, vt=vt, qt=qt,
                         at=at, vt1=tn1.v_tucker(v), qt1=tn1.q_tucker(q1),
                         at1=tn1.a_tucker(a1),
                         logits=K.attention_logits_ref(v_r, q_r, a_r, T))
            assert tqa.shape[1:3] == (Q, MC_A) and v_r.shape[:2] == (
                TRAIN_B, GRID_V if grid else V), (tqa.shape, v_r.shape)
            return {k: x.clone() for k, x in d.items()}

        def row(r, shape):
            r["shape"] = shape
            out_rows.append(r)

        for grid in (False, True):
            V_ = GRID_V if grid else V
            shape = f"MC B={TRAIN_B} rows V={V_} Q={Q} A={MC_A}"
            d = mc_inputs(tan, grid, torch.float32)
            with torch.inference_mode():
                e1 = check_k1(f"{shape} (Q*A={qa})", k1_of(d))
                e2 = check_k2(f"{shape} (the <4, 8> instance, 3 passes over Q)",
                              k2_of(d))
                e3 = check3(f"{shape} (Q*A={qa}: past the resident limit "
                            f"at V={V_})" if grid else shape, d["logits"],
                            d["mask"])
            grad_checks(shape, *k1_of(d), d["vt"], d["qt"], d["at"], d["att"],
                        0, d["logits"], d["mask"])
            g_mc = cotangent((TRAIN_B, d["vt"].shape[-1]), 26)
            if grid:  # V=50's is held to it as it is timed, below
                check_k2_backward(
                    f"{shape} (the <6, 6> instance, 2 passes over Q)",
                    (g_mc, d["vt"], d["qt"], d["at"], d["att"][..., 0]),
                    f64=True)
            keep = d["mask"].repeat_interleave(qa, 1)[..., None]
            k1_args = k1_of(d) + (keep,)
            att = d["att"]
            n_el = att.numel()
            G_ = att.shape[-1]
            cot = cotangent(att.shape, 21)
            with torch.inference_mode():
                row(timed("fused_rank_softmax", shape,
                          (lambda v, t, m, k: K.fused_rank_softmax(v, t, m),
                           lambda v, t, m, k: K.fused_rank_softmax_ref(v, t, m),
                           k1_library), k1_args, *k1_cost(*k1_args),
                          row=("rank_softmax.cu",
                               "vqatpu/kernels/trilinear.py:303", e1)), shape)
                row(timed(
                    "softmax_vqa_backward", shape,
                    (K.softmax_vqa_backward, K.softmax_vqa_backward_ref,
                     lambda a, c: torch.ops.aten._softmax_backward_data(
                         c.reshape(TRAIN_B, V_ * qa, G_),
                         a.reshape(TRAIN_B, V_ * qa, G_), 1, torch.float32)),
                    (att, cot), 3 * n_el * f32, 4 * n_el,
                    row=("softmax_vqa.cu", "vqatpu/kernels/trilinear.py:237",
                         e3[1])), shape)
                if not grid:
                    def glimpse0(f):
                        return lambda vt, qt, at, a: f(vt, qt, at, a[..., 0])
                    row(timed(
                        "trilinear_pool", shape,
                        (glimpse0(K.trilinear_pool),
                         glimpse0(K.trilinear_pool_ref),
                         glimpse0(K.trilinear_pool_ref)),
                        (d["vt"], d["qt"], d["at"], att), *k2_cost(*k2_of(d)),
                        row=("tri_pool.cu", "vqatpu/kernels/trilinear.py:369",
                             e2)), shape)
            if not grid:
                # forward + backward, as a training step runs them (4c)
                v_r, tqa, mask = (d[k].requires_grad_(k != "mask")
                                  for k in ("v_r", "tqa", "mask"))
                vt, qt, at, w = (d[k].requires_grad_()
                                 for k in ("vt", "qt", "at", "att"))
                g1, g2 = cotangent(att.shape, 22), cotangent(
                    (TRAIN_B, vt.shape[-1]), 23)
                RX, D_ = v_r.shape[2] * v_r.shape[3], vt.shape[-1]

                def k1_fb(fn):
                    return lambda v, t, g: torch.autograd.grad(
                        fn(v, t).reshape(g.shape), (v, t), g)

                def k2_fb(fn):
                    return lambda a, b, c, w_, g: torch.autograd.grad(
                        fn(a, b, c, w_[..., 0]), (a, b, c, w_), g)
                timed("fused_rank_softmax forward+backward", shape,
                      (k1_fb(lambda v, t: K.fused_rank_softmax(v, t, mask)),
                       k1_fb(lambda v, t: K.fused_rank_softmax_ref(v, t, mask)),
                       k1_fb(lambda v, t: k1_library(v, t, mask, keep))),
                      (v_r, tqa, g1),
                      2 * (v_r.numel() + tqa.numel() + n_el) * f32 + mask.numel(),
                      3 * 2 * TRAIN_B * G_ * V_ * RX * qa)
                timed("trilinear_pool forward+backward", f"{shape} (one glimpse)",
                      (k2_fb(K.trilinear_pool), k2_fb(K.trilinear_pool_ref),
                       k2_fb(K.trilinear_pool_ref)), (vt, qt, at, w, g2),
                      2 * (vt.numel() + qt.numel() + at.numel() + TRAIN_B * V_ * qa
                           + TRAIN_B * D_) * f32,
                      k2_cost(vt, qt, at, w[..., 0])[1] + 3 * 2 * TRAIN_B * V_ * qa
                      * D_ + 6 * TRAIN_B * qa * D_, earlier=k2_fb_bmm,
                      earlier_key="bmm", earlier_label="the forward kernel and "
                      "the four torch.bmm of PR 2-12")
                row(time_k2_backward(f"{shape} (one glimpse)", (
                    g_mc, vt.detach(), qt.detach(), at.detach(),
                    w.detach()[..., 0])), shape)
            del d, att, cot, k1_args, keep

            d16 = mc_inputs(tan16, grid, bf16)
            e1 = check_k1(f"bf16 {shape}", k1_of(d16))
            e2 = max(check_k2(f"bf16 {shape} glimpse 0 (the <6, 8> instance, "
                              "2 passes)", k2_of(d16)),
                     check_k2(f"bf16 {shape} glimpse 1 (qt, at f32)",
                              k2_glimpse1(d16)))
            v_r, tqa, mask = k1_of(d16)
            grad_check(f"K1 bf16 {shape}", ["dv", "dtqa"],
                       lambda x, y: K.fused_rank_softmax(x, y, mask),
                       lambda x, y: K.fused_rank_softmax_ref(x, y, mask),
                       (v_r, tqa), cotangent(d16["att"].shape, 24),
                       lambda want: K1_TOL, grad_rel=BF16_GRAD_REL_TOL)
            if grid:  # V=50's are held to it as they are timed, below
                for g_, args in ((0, k2_of(d16)), (1, k2_glimpse1(d16))):
                    check_k2_backward(f"bf16 {shape} glimpse {g_}",
                                      (g_mc, *args), BF16_GRAD_REL_TOL, f64=True)
            for g_, args in ((0, (d16["vt"], d16["qt"], d16["at"])),
                             (1, (d16["vt1"], d16["qt1"], d16["at1"]))):
                grad_check(f"K2 bf16 {shape} glimpse {g_}",
                           ["dvt", "dqt", "dat", "datt"],
                           lambda x, y, z, w: K.trilinear_pool(x, y, z, w[..., g_]),
                           lambda x, y, z, w: K.trilinear_pool_ref(x, y, z, w[..., g_]),
                           args + (d16["att"],),
                           cotangent((TRAIN_B, d16["vt"].shape[-1]), 25),
                           lambda want: K2_REL_TOL * want.abs().max().item(),
                           grad_rel=BF16_GRAD_REL_TOL)
            keep = d16["mask"].repeat_interleave(qa, 1)[..., None]
            k1_args = k1_of(d16) + (keep,)
            with torch.inference_mode():
                row(timed("fused_rank_softmax_bf16", shape,
                          (lambda v, t, m, k: K.fused_rank_softmax(v, t, m),
                           lambda v, t, m, k: K.fused_rank_softmax_ref(v, t, m),
                           k1_library), k1_args, *k1_cost(*k1_args),
                          row=("rank_softmax.cu",
                               "vqatpu/kernels/trilinear.py:303", e1),
                          peak_ops=peak_bf16), shape)
                if not grid:
                    for g_, args in ((0, k2_of(d16)), (1, k2_glimpse1(d16))):
                        row(timed(
                            "trilinear_pool_bf16", f"{shape} glimpse {g_}",
                            (K.trilinear_pool, K.trilinear_pool_ref,
                             k2_einsum_in(bf16)), args, *k2_cost(*args),
                            row=("tri_pool.cu",
                                 "vqatpu/kernels/trilinear.py:369", e2),
                            peak_ops=peak_bf16), f"{shape} glimpse {g_}")
            if not grid:
                for g_, args in ((0, k2_of(d16)), (1, k2_glimpse1(d16))):
                    row(time_k2_backward(f"{shape} glimpse {g_}",
                                         (g_mc, *args), BF16_GRAD_REL_TOL,
                                         peak_ops=peak_bf16),
                        f"{shape} glimpse {g_}")
            del d16, k1_args, keep, g_mc
        del tan16
        return out_rows

    models12 = phase12_logits(path_counts)
    flush = torch.empty(128 * 2**20 // 4, device=dev)  # > the 50 MB L2
    rows += phase12_kernels(models12["tan"][1])
    del flush
    phase12_serving(models12, path_counts, median_ms)
    phase12_training(models12, path_counts, train_throughput)
    del models12
    phase12_cli(path_counts)

    # -- 13. CTI's large-V path and v-side knobs, .pth, encoders, profile -
    phase13_large_v(cfg, params, path_counts, smi)
    phase13_knobs_vs_cpu(cfg, params, path_counts)
    phase13_pth_serving(cfg, path_counts, smi)
    phase13_encoders(cfg)
    phase13_profile(path_counts, p9)
    p9["tmp"].cleanup()

    # -- 14. the preprocessing tools, NCCL, DDP, tp and the sharded store --
    p14 = phase14_tools(path_counts)
    phase14_nccl(p14, path_counts)
    p14["tmp"].cleanup()
    k2 = phase14_parallel(path_counts)
    flush = torch.empty(128 * 2**20 // 4, device=dev)  # > the 50 MB L2
    shape = f"tp=2, one rank's d / 2 = {CFG['h_mm']}, B={TRAIN_B}"
    args = (k2["vt"], k2["qt"], k2["at"], k2["w"])
    with torch.inference_mode():
        rows.append(dict(timed(
            "trilinear_pool", shape,
            (K.trilinear_pool, K.trilinear_pool_ref, K.trilinear_pool_ref),
            args, *k2_cost(*args),
            row=("tri_pool.cu", "vqatpu/kernels/trilinear.py:369",
                 k2["err"])), shape=shape))
    bwd_args = (cotangent(args[0].shape[:1] + args[0].shape[2:], 27), *args)
    rows.append(dict(time_k2_backward(f"{shape} (the tp path's inputs)",
                                      bwd_args), shape=shape))
    del flush, k2, args, bwd_args

    # -- 15. JAX's .orbax checkpoints, read and written on the card's host -
    phase15_orbax(path_counts, smi)

    # -- 16. the split-bf16 GEMM of the tucker products -------------------
    phase16_linear(smi)

    for r in rows:
        r["launches"] = sum(c[r["name"]] for c in path_counts.values())
    print(f"launches by path: {path_counts}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
