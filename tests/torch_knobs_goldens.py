"""Write JAX's dropout-active CTI trajectories under ``fused_v_tucker`` and
``remat_glimpse``, which ``tests/test_torch_blockwise.py`` reads (it runs
only the port's side).

    JAX_PLATFORMS=cpu python -m tests.torch_knobs_goldens

File ``tests/data/torch_cti_knobs_golden.npz``, for each knob (``fused``,
``remat``): ``STEPS`` training steps of the small CTI (``SMALL``, the
widths of ``tests/test_models.py``) at lr 1e-3 on ``N``-sample batches
``numpy_batch(cfg, N, seed=BATCH_SEED + i, boxes=8, real_boxes=6)`` from
``numpy_params(cfg, PARAM_SEED)``, dropout on, every mask drawn with numpy
(``RandomState(MASK_SEED + i)``, keep 0.7) as JAX's step asks for it:

- ``{knob}_s{i}_m{j}``: step ``i``'s ``j``-th mask in JAX's order (uint8);
- ``{knob}_loss``, ``{knob}_grad_norm``: per step;
- ``{knob}_param_{names,l2,sum,l1}``: the final params' per-leaf
  statistics (:func:`vqatpu_torch.weights.param_stats`), and
  ``{knob}_param_head``: the first ``HEAD`` values of every leaf, in the
  names' order, concatenated.

Under ``remat_glimpse`` JAX's injected masks reach only the first
glimpse's joint embedding: ``jax.checkpoint`` reuses the trace of the
checkpointed ``joint_fn`` for the second glimpse (same function, same
shapes), masks and all, so glimpse 1 draws nothing and replays glimpse 0's
tucker masks.  The recording shows it (one set of ``t_net`` tucker masks
a step); the test feeds the port those masks twice.  With a dropout key,
JAX's real path, the key is an argument and each glimpse draws its own.
A few seconds on a CPU.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

from vqatpu.config import ModelConfig as JaxModelConfig
from vqatpu.config import TrainConfig as JaxTrainConfig
from vqatpu.models import build_model as jax_build_model
from vqatpu.ops.module import Ctx as JaxCtx
from vqatpu.train import steps as jsteps
from vqatpu_torch.config import ModelConfig
from vqatpu_torch.weights import numpy_batch, numpy_params, param_stats

GOLDEN = Path(__file__).parent / "data" / "torch_cti_knobs_golden.npz"
SMALL = dict(ntoken=50, v_dim=32, num_ans_candidates=17, model="cti",
             num_hid=32, h_mm=16, rank=4, gamma=2)
KNOBS = {"fused": dict(fused_v_tucker=True), "remat": dict(remat_glimpse=True)}
PARAM_SEED, BATCH_SEED, MASK_SEED = 3, 10, 20
N, STEPS, LR, KEEP, HEAD = 4, 3, 1e-3, 0.7, 8


class Recorder:
    """A JAX ``MaskSource`` stand-in: each mask drawn with numpy as the
    step asks for it, and kept."""

    def __init__(self, seed: int):
        self.rs = np.random.RandomState(seed)
        self.masks = []

    def next_mask(self, shape):
        m = (self.rs.rand(*shape) < KEEP).astype(np.float32)
        self.masks.append(m)
        return m


def batches(kw: dict):
    return [numpy_batch(ModelConfig(**kw), N, seed=BATCH_SEED + i, boxes=8,
                        real_boxes=6, target=True) for i in range(STEPS)]


def head(params_flat) -> np.ndarray:
    return np.concatenate([np.ravel(x)[:HEAD] for x in params_flat])


def trajectory(knob: str) -> dict:
    kw = dict(SMALL, **KNOBS[knob])
    model = jax_build_model(JaxModelConfig(**kw))
    state = jsteps.make_train_state(model, jax.random.PRNGKey(0))
    state = state._replace(params=jax.tree.map(
        jnp.asarray, numpy_params(ModelConfig(**kw), PARAM_SEED)))
    out, losses, norms = {}, [], []
    for i, b in enumerate(batches(kw)):
        rec = Recorder(MASK_SEED + i)
        step = jsteps.make_train_step(
            model, JaxTrainConfig(update_freq=1),
            ctx_factory=lambda rec=rec: JaxCtx(train=True, mask_source=rec))
        jb = {k: jnp.asarray(x.astype(np.int32) if x.dtype == np.int64
                             else x) for k, x in b.items()}
        state, m = step(state, jb, jnp.float32(LR), jax.random.PRNGKey(1),
                        False)
        losses.append(float(np.asarray(m["loss"])))
        norms.append(float(np.asarray(m["grad_norm"])))
        for j, mask in enumerate(rec.masks):
            out[f"{knob}_s{i}_m{j}"] = mask.astype(np.uint8)
    params = jax.tree.map(np.asarray, state.params)
    stats = param_stats(params)
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    by_name = {".".join(str(k.key) for k in path): v
               for path, v in flat.items()}
    out.update({f"{knob}_loss": np.array(losses),
                f"{knob}_grad_norm": np.array(norms),
                f"{knob}_param_head": head([by_name[n]
                                            for n in stats["names"]])})
    out.update({f"{knob}_param_{k}": v for k, v in stats.items()})
    return out


def main() -> None:
    out = {}
    for knob in KNOBS:
        out.update(trajectory(knob))
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
