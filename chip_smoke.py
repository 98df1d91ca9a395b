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

Each of the three paths (serving, logits, training) is driven with the
launch counts set to 0 just before it and read just after; the kernels'
``launches`` in the JSON line are their sums.

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
K3_TOL = 1e-5       # as K1; the softmax backward is held to it too
GRAD_REL_TOL = 1e-4  # gradients, relative to the plain gradient's largest
                     # magnitude: the plain softmax gradient goes through
                     # autograd of exp, sum and divide, which cancels
                     # g - sum(g*att) in another order (8.5e-6 seen at B=256)
CPU_REL_TOL = 1e-4  # card vs CPU through the full-width layers, relative
TRAIN_TOL = 1e-4    # training trajectories, relative (ROADMAP parity contract)
SERVE_TOL = 1e-3    # logit-parity target (BASELINE.md)
TRAIN_B, WARMUP, WINDOWS, ITERS = 256, 3, 5, 20  # bench.py:50-90, fewer windows

# published peaks (NVIDIA data sheets): HBM bytes/s, f32 CUDA-core FLOP/s
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H200": (4.8e12, 67e12),
         "H100": (3.35e12, 67e12)}


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
    from vqatpu_torch.serve import InferenceSession
    from vqatpu_torch.cli.serve import serve_in_thread
    from vqatpu_torch.config import TrainConfig
    from vqatpu_torch.train import make_train_state, make_train_step
    from vqatpu_torch.weights import (jax_params_from_torch, load_jax_params,
                                      numpy_batch, numpy_params, param_stats)

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

    def grad_check(label, names, fn, ref, args, cot, fwd_tol):
        """The forward and the gradients of ``fn`` (the kernel's
        autograd.Function) against ``ref`` (the plain version) and autograd
        through it, on the same inputs; ``fwd_tol(want)`` is the forward's
        tolerance."""
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
        for name, g, w in zip(names, got, want):
            err, tol = (g - w).abs().max().item(), GRAD_REL_TOL * w.abs().max().item()
            ok &= err <= tol and bool(g.isfinite().all())
            parts.append(f"{name} {err:.3e} (tol {tol:.3e})")
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

    def clone_args(args):
        return tuple(x.detach().clone().requires_grad_(x.requires_grad)
                     for x in args)

    def timed(name, label, fns, args, nbytes, flops, row=None):
        """Times of the kernel, its plain version and the library yardstick
        (``fns``, each called on ``args``) beside the card's bound: each as
        a single call, and the kernel and the yardstick back to back over
        rotating copies of ``args`` (``b2b``, no launch or event floor);
        with ``row`` = (source, replaces, err), the kernel's row of the
        JSON line."""
        t_bytes, t_flops = nbytes / peak_bw * 1e3, flops / peak_f32 * 1e3
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

    def k1_cost(v_r, tqa, mask, keep=None):
        """Bytes (inputs read once, att written once) and FLOP of K1."""
        B_, V_, R_, X_ = v_r.shape
        G_ = tqa.shape[-1]
        return ((v_r.numel() + tqa.numel() + B_ * V_ * QA * G_) * f32
                + mask.numel(), 2 * B_ * G_ * V_ * R_ * X_ * QA)

    def k2_cost(vt, qt, at, w):
        """Bytes and FLOP of K2, in its order: V first, then Q, then A."""
        B_, V_, D_ = vt.shape
        return ((vt.numel() + qt.numel() + at.numel() + B_ * V_ * QA + B_ * D_)
                * f32, 2 * B_ * D_ * (V_ * QA + QA + A))

    def k1_library(v_r, tqa, mask, keep):
        """One bmm, then a masked softmax over the flattened (V, Q, A);
        ``keep`` is the mask repeated over (Q, A)."""
        B_, V_, R_, X_ = v_r.shape
        G_ = tqa.shape[-1]
        lg = torch.bmm(v_r.reshape(B_, V_, R_ * X_), tqa.permute(
            0, 3, 4, 1, 2, 5).reshape(B_, R_ * X_, QA * G_))
        return torch.softmax(lg.reshape(B_, V_ * QA, G_).masked_fill(
            ~keep, float("-inf")), dim=1)

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
    del fused, att7, logits7, grads7, att_c, logits_c, grads_c, cpu, session

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

    # -- 8b. training throughput at B=256, dropout on (bench.py) -----------
    batch = numpy_batch(cfg, TRAIN_B, seed=0, target=True)
    batch["v_mask"] = np.abs(batch["v"]).sum(-1) != 0
    db = {k: torch.from_numpy(x).to(dev) for k, x in batch.items()}
    state = make_train_state(build_model(cfg), seed=0, device="cuda")
    step = make_train_step(state.model, TrainConfig(update_freq=1,
                                                    batch_size=TRAIN_B))
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(WARMUP):
        m = step(state, db, 1e-3, gen)
    float(m["loss"])
    K.reset_launches()
    thr, events = [], []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = step(state, db, 1e-3, gen)
            end.record()
            events.append((start, end))
        loss = float(m["loss"])  # a value readback ends the window
        thr.append(TRAIN_B * ITERS / (time.perf_counter() - t0))
    torch.cuda.synchronize()
    counts = dict(K.launches)
    n_steps = WINDOWS * ITERS
    for k, v in counts.items():
        path_counts["training"][k] += v
    step_ms = statistics.median(s.elapsed_time(e) for s, e in events)
    thr.sort()
    print(f"training B={TRAIN_B}: {thr[-1]:.1f} samples/s best window, "
          f"{statistics.median(thr):.1f} median ({WINDOWS} windows of {ITERS} "
          f"steps); median step on CUDA events {step_ms:.3f} ms; last loss "
          f"{loss:.3f}; launches per step "
          f"{ {k: v / n_steps for k, v in counts.items()} }")
    assert np.isfinite(loss), loss
    assert counts["fused_rank_softmax"] == n_steps, counts
    assert counts["softmax_vqa_backward"] == n_steps, counts
    assert counts["trilinear_pool"] == cfg.gamma * n_steps, counts
    assert counts["masked_softmax_vqa"] == 0, counts
    k_ms = (fwd_bwd["fused_rank_softmax"]["ms"]
            + cfg.gamma * fwd_bwd["trilinear_pool"]["ms"])
    print(f"training B={TRAIN_B}: K1 and K2 forward+backward (1 + {cfg.gamma} "
          f"per step, phase 4c cold-L2 times) take {k_ms:.3f} ms of the "
          f"{step_ms:.3f} ms step ({k_ms / step_ms:.1%})")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof_steps = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(prof_steps):
            m = step(state, db, 1e-3, gen)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    print(f"torch.profiler, {prof_steps} training steps at B={TRAIN_B} (times "
          f"summed over them):")
    print(averages.table(sort_by="self_device_time_total", row_limit=10))
    on_card = [e for e in averages if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3 / prof_steps
    own = {name: sum(e.self_device_time_total for e in on_card
                     if name in e.key) / 1e3 / prof_steps
           for name in ("rank_softmax_kernel", "tri_pool_kernel",
                        "softmax_backward_kernel")}
    print(f"profiled step: {busy_ms:.3f} ms of kernels on the card, "
          f"{busy_ms / step_ms:.1%} of the {step_ms:.3f} ms median step (idle "
          f"{1 - busy_ms / step_ms:.1%}); the port's CUDA kernels per step "
          f"(L2 warm): "
          + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in own.items()))
    assert all(v > 0 for v in own.values()), own
    del state, step, db

    for r in rows:
        r["launches"] = sum(c[r["name"]] for c in path_counts.values())
    print(f"launches by path: {path_counts}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
