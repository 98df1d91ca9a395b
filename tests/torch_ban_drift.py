"""How far float32 and bf16 carry BAN's counter from exact arithmetic, on
the CPU, at the full width of ``tests/test_torch_ban.py`` (weights
``numpy_params(cfg, 0)``).  The readings set two of that file's limits.

``train`` (the default): 3-step trajectories at B=4 with the counter and
the distillation loss, update_freq 1, no dropout, for each batch seed:
JAX's float32, the port's float32 and the port's module in float64 (the
same Adamax and clip).  Prints each float32 run's relative error against
float64: per step the loss and the pre-clip grad norm, after the steps
the per-leaf l2 and l1 norms (relative) and sums (against the leaf's l1
norm).  With ``--at_f64_params`` also the third grad norm of each
float32 package evaluated at the float64 run's own params after two
steps, which splits evaluation error from the drift of the trajectory.

``bf16``: per sample of a batch, the largest error of the logits served
at bf16 against JAX's float32 logits, JAX's and the port's, and the
counter's soft count per glimpse at float32 and at bf16 (port), with the
top-k choices that differ.

    JAX_PLATFORMS=cpu python -m tests.torch_ban_drift train --lr 1e-3 \\
        --seeds 40,50,60,70,80,90,100,110,120
    JAX_PLATFORMS=cpu python -m tests.torch_ban_drift bf16 --n 32 --seed 2
"""

import argparse

import numpy as np
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_ban import (ANS, FULL, GOLDEN_N, JaxTrainConfig,
                                  jax_apply, jax_run, torch_run, traj_record)
from vqatpu.config import ModelConfig as JaxModelConfig
from vqatpu.models import build_model as jax_build_model
from vqatpu.serve import InferenceSession as JaxSession
from vqatpu_torch.config import ModelConfig, TrainConfig
from vqatpu_torch.models import build_model
from vqatpu_torch.ops.losses import distillation_loss
from vqatpu_torch.ops.module import Ctx
from vqatpu_torch.serve import InferenceSession
from vqatpu_torch.train import make_train_state
from vqatpu_torch.train.optim import clip_flat_grads
from vqatpu_torch.train.steps import compute_score_with_logits, densify_target
from vqatpu_torch.weights import (jax_params_from_torch, load_jax_params,
                                  numpy_batch, numpy_params,
                                  torch_state_from_jax)

CFG = ModelConfig(**FULL)
TCFG = dict(update_freq=1, deterministic=True, distillation=True)


def f64_run(params, batches, lr, tcfg=TrainConfig(**TCFG)):
    """The port's module in float64, the train step's math: -> (metrics,
    params after each step)."""
    model = build_model(CFG)
    model.load_state_dict(torch_state_from_jax(params))
    state = make_train_state(model.double(), device="cpu")
    metrics, trees = [], []
    for b in batches:
        d = densify_target({k: torch.from_numpy(np.ascontiguousarray(x))
                            for k, x in b.items()}, CFG.num_ans_candidates)
        d = {k: x.double() if x.is_floating_point() else x
             for k, x in d.items()}
        logits, _ = model(d["v"], d["q"], ctx=Ctx(train=False), b=d["b"])
        loss = distillation_loss(logits, d["t_logits"], d["target"], tcfg.T,
                                 tcfg.alpha)
        grads = torch.autograd.grad(loss, state.optimizer.params)
        grads, norm = clip_flat_grads(list(grads), tcfg.clip_norm)
        state.optimizer.step(grads, lr)
        metrics.append({"loss": loss.detach(), "grad_norm": norm.detach(),
                        "batch_score": compute_score_with_logits(
                            logits.detach(), d["target"])})
        trees.append(jax_params_from_torch(
            {k: v.detach().clone() for k, v in model.state_dict().items()}))
    return metrics, trees


def drift(rec, ref):
    """Relative errors of a float32 trajectory against float64's."""
    out = {k: np.abs(rec[k] - ref[k]) / np.abs(ref[k])
           for k in ("loss", "grad_norm")}
    for k in ("param_l2", "param_l1"):
        out[k] = float(np.max(np.abs(rec[k] - ref[k]) / ref[k]))
    out["param_sum"] = float(np.max(np.abs(rec["param_sum"] -
                                           ref["param_sum"]) / ref["param_l1"]))
    return out


def train(args):
    params = numpy_params(CFG, seed=0)
    for seed in args.seeds:
        batches = [numpy_batch(CFG, GOLDEN_N, seed=seed + i, target=True,
                               teacher=True) for i in range(3)]
        m64, trees = f64_run(params, batches, args.lr)
        ref = traj_record(m64, trees[-1])
        jm, jp = jax_run(FULL, params, batches, JaxTrainConfig(**TCFG),
                         lr=args.lr)
        pm, state = torch_run(FULL, params, batches, TrainConfig(**TCFG),
                              lr=args.lr)
        runs = {"jax": traj_record(jm, jp), "port": traj_record(
            pm, jax_params_from_torch(state.model.state_dict()))}
        for name, rec in runs.items():
            d = drift(rec, ref)
            print(f"lr {args.lr:g} seed {seed} {name} float32 vs float64: "
                  f"loss {' '.join(f'{x:.2e}' for x in d['loss'])}; grad "
                  f"norm {' '.join(f'{x:.2e}' for x in d['grad_norm'])} "
                  f"(float64 {' '.join(f'{x:.6f}' for x in ref['grad_norm'])}"
                  f"); leaves l2 {d['param_l2']:.2e} l1 {d['param_l1']:.2e} "
                  f"sum {d['param_sum']:.2e}", flush=True)
        if args.at_f64_params:
            at = jax.tree.map(lambda x: np.asarray(x, np.float32), trees[1])
            n64 = float(f64_run(at, batches[2:], args.lr)[0][0]["grad_norm"])
            jn = float(jax_run(FULL, at, batches[2:], JaxTrainConfig(**TCFG),
                               lr=args.lr)[0][0]["grad_norm"])
            pn = float(torch_run(FULL, at, batches[2:], TrainConfig(**TCFG),
                                 lr=args.lr)[0][0]["grad_norm"])
            print(f"lr {args.lr:g} seed {seed}: third grad norm at float64's "
                  f"params after two steps: float64 {n64:.6f}, jax "
                  f"{abs(jn - n64) / n64:.2e} off, port "
                  f"{abs(pn - n64) / n64:.2e} off", flush=True)


def counter_record(sess):
    """Forward hook on the session's counter: per call (glimpse) the
    sorted top-k box indices and the soft count (the output's mean bin)."""
    rec = []

    def hook(module, inputs, out):
        att = inputs[1].float()
        n = min(module.objects, att.shape[1])
        idx = torch.sort(att, dim=1, descending=True, stable=True)[1][:, :n]
        o = out.float()
        k = torch.arange(o.shape[1], dtype=torch.float32)
        rec.append((idx.sort(1).values.numpy(),
                    ((o * k).sum(1) / o.sum(1)).numpy()))

    sess.model.counter.register_forward_hook(hook)
    return rec


def bf16(args):
    params = numpy_params(CFG, seed=0)
    b = numpy_batch(CFG, args.n, seed=args.seed)
    inputs = (b["v"], b["b"], b["q"])
    want32, _ = jax_apply(FULL, params, b)
    want16 = JaxSession(jax_build_model(JaxModelConfig(**FULL)),
                        jax.tree.map(jnp.asarray, params), ANS,
                        compute_dtype="bfloat16").logits(*inputs)
    model = load_jax_params(build_model(CFG), params).eval()
    s32 = InferenceSession(model, ANS, device="cpu")
    s16 = InferenceSession(model, ANS, compute_dtype="bfloat16", device="cpu")
    r32, r16 = counter_record(s32), counter_record(s16)
    s32.logits(*inputs)
    got16 = s16.logits(*inputs)
    own = np.abs(want16 - want32).max(1)
    err = np.abs(got16 - want32).max(1)
    moved = max(np.abs(a[1] - c[1]).max() for a, c in zip(r32, r16))
    print(f"B={args.n} seed {args.seed}: largest error at bf16, JAX's own "
          f"{own.max():.4f}, the port's {err.max():.4f} (budget "
          f"{2 * own.max() + 1e-4:.4f}); the port's soft count moved by up "
          f"to {moved:.4f} from float32")
    for s in range(args.n):
        counts = "; ".join(
            f"g{g} {a[1][s]:.3f} -> {c[1][s]:.3f}"
            + ("" if (a[0][s] == c[0][s]).all() else " (top-k differs)")
            for g, (a, c) in enumerate(zip(r32, r16)))
        print(f"  sample {s}: JAX's own {own[s]:.4f}, the port's "
              f"{err[s]:.4f}; count float32 -> bf16 {counts}")


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="mode")
    t = sub.add_parser("train")
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--seeds", type=lambda s: [int(x) for x in s.split(",")],
                   default=[40])
    t.add_argument("--at_f64_params", action="store_true")
    f = sub.add_parser("bf16")
    f.add_argument("--n", type=int, default=32)
    f.add_argument("--seed", type=int, default=2)
    args = p.parse_args()
    if args.mode == "bf16":
        bf16(args)
    else:
        train(args if args.mode else t.parse_args([]))


if __name__ == "__main__":
    main()
