"""Write the full-width JAX goldens of the multiple-choice models, which
``chip_smoke.py`` (phase 12) holds the card to and ``tests/test_torch_mc.py``
reads (it checks their seeds and never recomputes them).

    python -m tests.torch_mc_goldens [--only tan,ban_mc,san_mc,tan_train]

Files (``tests/data``):

- ``torch_tan_golden.npz``: TanModel (bench.py's widths, 2 classes) on
  ``N`` questions, ``x4`` expanded, V=50 with 44 real boxes: ``logits``
  (JAX's Pallas backend, interpret mode, float32), ``logits_bf16`` (its
  eval step at ``compute_dtype="bfloat16"``; TanModel and SAN-MC read no
  spatials, so their served and evaluated bf16 logits are one), and on
  the grid path (V=196, every box real, zero spatials) ``logits_grid``;
- ``torch_ban_mc_golden.npz``: BanModelMC with the counter (10 objects) on
  ``N_BAN`` questions: ``logits``, ``logits_bf16`` served at bf16 (JAX's
  ``InferenceSession``, which casts the spatials ``b`` to bf16) and
  ``logits_eval`` through its eval step at bf16 (``b`` float32).  The
  counter's soft count is ill-conditioned at bf16 (``tests/test_torch_ban.py``):
  the two paths differ by up to 0.49 on 8 questions, and JAX's own error
  wants the 32-question sample that PR 9's B=32 BAN golden uses;
- ``torch_san_mc_golden.npz``: SAN-MC (2 stacks), ``logits`` and
  ``logits_bf16``;
- ``torch_tan_train_golden.npz``: three deterministic TanModel steps
  (``mc_scoring``) at lr 1e-3 on ``TRAIN_N`` questions: per-step ``loss``,
  ``grad_norm``, ``batch_score`` and the final parameters' per-leaf
  statistics (``param_*``, :func:`vqatpu_torch.weights.param_stats`);
- ``torch_tan_train_golden_bf16.npz``: the same steps in float32
  (``f32_*``) and at ``compute_dtype="bfloat16"`` (``bf16_*``) on JAX's
  xla backend: ``loss``, ``grad_norm`` and the leaves' ``param_l2``, the
  budget's inputs (``tests/test_torch_train.py``).

Weights are ``numpy_params(cfg, PARAM_SEED)``; question batches
``numpy_batch(cfg, n, seed)`` expanded by ``expand_mc_batch``.  About a
minute on a CPU.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vqatpu.config import ModelConfig as JaxModelConfig
from vqatpu.config import TrainConfig as JaxTrainConfig
from vqatpu.models import build_model as jax_build_model
from vqatpu.serve import InferenceSession as JaxSession
from vqatpu.train import steps as jsteps
from vqatpu_torch.config import ModelConfig
from vqatpu_torch.data.mc_dataset import expand_mc_batch
from vqatpu_torch.weights import numpy_batch, numpy_params, param_stats

DATA = Path(__file__).parent / "data"
# bench.py:50-52, with the multiple-choice head
FULL = dict(ntoken=20000, v_dim=2048, num_ans_candidates=3129, num_hid=1024,
            h_mm=512, rank=32, gamma=2, task="mc")
MODELS = {"tan": dict(FULL, model="tan"),
          "ban_mc": dict(FULL, model="ban", use_counter=True),
          "san_mc": dict(FULL, model="san", num_stacks=2)}
PARAM_SEED, BATCH_SEED, GRID_SEED, N = 0, 1, 2, 8   # N questions, 4N rows
N_BAN = 32
V, REAL_BOXES, GRID_CELLS = 50, 44, 196
TRAIN_N, TRAIN_SEED, TRAIN_STEPS, TRAIN_LR = 4, 40, 3, 1e-3
BF16_FLOOR = 2.0 ** -10  # tests/test_torch_train.py's bf16 trajectory floor


def rows(kw: dict, n: int, seed: int, grid: bool = False) -> dict:
    """``n`` seeded questions expanded to their candidate rows: ``v``,
    ``b``, ``q``, ``a`` (and ``target``).  On the grid path every one of
    the 196 cells is real and the spatials are zero."""
    cfg = ModelConfig(**kw)
    boxes = GRID_CELLS if grid else V
    qb = numpy_batch(cfg, n, seed=seed, boxes=boxes,
                     real_boxes=boxes if grid else REAL_BOXES)
    if grid:
        qb["b"] = np.zeros_like(qb["b"])
    ex = expand_mc_batch(qb)
    return {k: ex[k] for k in ("v", "b", "q", "a", "target")}


def jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
            for k, x in batch.items()}


def jax_logits(kw: dict, params: dict, batch: dict,
               compute_dtype: str = "float32") -> np.ndarray:
    """JAX's eval-step logits on the Pallas backend (interpret mode)."""
    model = jax_build_model(JaxModelConfig(**kw, kernel_backend="pallas"))
    with pltpu.force_tpu_interpret_mode():
        out = jsteps.make_eval_step(model, compute_dtype=compute_dtype)(
            jax.tree.map(jnp.asarray, params), jax_batch(
                {k: batch[k] for k in ("v", "b", "q", "a")}))
    return np.asarray(out["logits"])


def jax_served_bf16(kw: dict, params: dict, batch: dict) -> np.ndarray:
    """JAX's session at ``compute_dtype="bfloat16"`` (``b`` cast to bf16)."""
    return JaxSession(jax_build_model(JaxModelConfig(**kw)),
                      jax.tree.map(jnp.asarray, params), ["match", "nonmatch"],
                      compute_dtype="bfloat16").logits(
        batch["v"], batch["b"], batch["q"], batch["a"])


def write_logits(name: str) -> None:
    kw = MODELS[name]
    n = N_BAN if name == "ban_mc" else N
    params = numpy_params(ModelConfig(**kw), PARAM_SEED)
    batch = rows(kw, n, BATCH_SEED)
    out = dict(n=n, param_seed=PARAM_SEED, batch_seed=BATCH_SEED,
               logits=jax_logits(kw, params, batch),
               logits_bf16=jax_logits(kw, params, batch, "bfloat16"))
    if name == "ban_mc":
        out.update(logits_eval=out["logits_bf16"],
                   logits_bf16=jax_served_bf16(kw, params, batch))
    if name == "tan":
        out.update(grid_seed=GRID_SEED, logits_grid=jax_logits(
            kw, params, rows(kw, N, GRID_SEED, grid=True)))
    np.savez_compressed(DATA / f"torch_{name}_golden.npz", **out)


def jax_trajectory(compute_dtype: str = "float32"):
    """TanModel's ``TRAIN_STEPS`` deterministic steps on JAX's default
    (xla) backend, as the free-form CTI trajectory's golden: its float32
    step is the Pallas backend's math in another layout, and the Pallas
    backend takes no bf16 step (ROADMAP queue C).  -> (per-step metrics,
    the final parameters' ``param_stats``)."""
    kw = MODELS["tan"]
    params = numpy_params(ModelConfig(**kw), PARAM_SEED)
    model = jax_build_model(JaxModelConfig(**kw))
    state = jsteps.make_train_state(model, jax.random.PRNGKey(0))
    state = state._replace(params=jax.tree.map(jnp.asarray, params))
    step = jsteps.make_train_step(
        model, JaxTrainConfig(update_freq=1, deterministic=True,
                              compute_dtype=compute_dtype), mc_scoring=True)
    record = {k: [] for k in ("loss", "grad_norm", "batch_score")}
    for i in range(TRAIN_STEPS):
        state, m = step(state, jax_batch(rows(kw, TRAIN_N, TRAIN_SEED + i)),
                        jnp.float32(TRAIN_LR), jax.random.PRNGKey(1))
        for k in record:
            record[k].append(float(np.asarray(m[k])))
    return ({k: np.array(v, np.float64) for k, v in record.items()},
            param_stats(jax.tree.map(np.asarray, state.params)))


def write_train() -> None:
    seeds = dict(n=TRAIN_N, steps=TRAIN_STEPS, param_seed=PARAM_SEED,
                 batch_seed=TRAIN_SEED, lr=TRAIN_LR)
    record, stats = jax_trajectory()
    np.savez_compressed(DATA / "torch_tan_train_golden.npz", **seeds,
                        **record,
                        **{f"param_{k}": v for k, v in stats.items()})
    record16, stats16 = jax_trajectory("bfloat16")
    traj = {"f32": (record, stats), "bf16": (record16, stats16)}
    np.savez_compressed(
        DATA / "torch_tan_train_golden_bf16.npz", **seeds,
        floor=BF16_FLOOR, names=stats["names"],
        **{f"{side}_{k}": r[k] for side, (r, _) in traj.items()
           for k in ("loss", "grad_norm")},
        **{f"{side}_param_l2": st["l2"] for side, (_, st) in traj.items()})


def main(argv=None) -> None:
    jax.config.update("jax_platforms", "cpu")
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--only", default="tan,ban_mc,san_mc,tan_train")
    for name in p.parse_args(argv).only.split(","):
        t0 = time.time()
        write_train() if name == "tan_train" else write_logits(name)
        print(f"{name}: {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
