"""Write the JAX-written ``.orbax`` goldens that ``chip_smoke.py`` (phase 15)
reads and serves on the card, where there is no JAX, and that
``tests/test_torch_orbax.py`` reads (it never recomputes them).

    JAX_PLATFORMS=cpu python -m tests.torch_orbax_goldens

Files (``tests/data``, about 0.5 MB in all):

- ``torch_orbax_cti/model_epoch3.orbax/`` (where ``load_params_any(dir,
  3, model)`` finds it): JAX's ``save_checkpoint_orbax`` (orbax's
  default OCDBT layout) of a tiny CTI free-form ``TrainState`` fresh from
  ``make_train_state(model, PRNGKey(PARAM_SEED))`` (its Adamax moments
  zero, which keeps the file small), at ``EPOCH``;
  ``torch_orbax_cti.npz``: the logits of JAX's eval step (Pallas backend,
  interpret mode) on ``numpy_batch(cfg, N, BATCH_SEED)`` with V=``V``
  boxes, ``REAL_BOXES`` of them real, with the model's config (JSON) and
  those seeds;
- ``torch_orbax_tan/model_epoch3.orbax/`` and ``torch_orbax_tan.npz``:
  the same for TanModel (Visual7W multiple choice) on the ``x4``
  candidate rows of ``N`` questions;
- ``torch_orbax_2proc/model_epoch3.orbax/``: a save by two processes (``jax.
  distributed`` over gloo, one CPU device each) of a tree whose classifier
  weight is split over the processes, so each writes its half into its
  own ``ocdbt.process_<i>/``, beside replicated leaves;
  ``torch_orbax_2proc.npz``: that weight.  (A save of
  ``tests/helpers/mp_train_worker.py``'s replicated state has process 0
  write everything, ``ocdbt.process_0/`` alone, 1.3 MB.)

About half a minute on a CPU.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

DATA = Path(__file__).parent / "data"
ROOT = Path(__file__).resolve().parents[1]
# small widths that K1's and K2's float32 CUDA instances take (R * h_mm /
# rank and D = 2 * h_mm = num_hid multiples of 4, Q <= 32, A <= 8)
TINY = dict(ntoken=10, v_dim=16, num_ans_candidates=7, num_hid=8, h_mm=4,
            rank=2, gamma=2)
MODELS = {"cti": dict(TINY, model="cti"),
          "tan": dict(TINY, model="tan", task="mc")}
PARAM_SEED, BATCH_SEED, EPOCH, N = 0, 1, 3, 4
V, REAL_BOXES = 10, 8
# the two-process golden's classifier weight: each process's half over
# orbax's 1024-byte inline limit, so the root names both processes' files
SPLIT_ROWS, SPLIT_COLS = 64, 16


def golden_dir(name: str) -> Path:
    return DATA / f"torch_orbax_{name}" / f"model_epoch{EPOCH}.orbax"


def batch(kw: dict) -> dict:
    """The seeded batch of a golden's logits: ``N`` questions (MC: their
    ``x4`` candidate rows)."""
    from vqatpu_torch.config import ModelConfig
    from vqatpu_torch.data.mc_dataset import expand_mc_batch
    from vqatpu_torch.weights import numpy_batch

    cfg = ModelConfig(**kw)
    b = numpy_batch(cfg, N, seed=BATCH_SEED, boxes=V, real_boxes=REAL_BOXES)
    if cfg.task == "mc":
        b = expand_mc_batch(b)
    return {k: b[k] for k in ("v", "b", "q", "a")}


def write_model(name: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vqatpu.config import ModelConfig as JaxModelConfig
    from vqatpu.models import build_model
    from vqatpu.train import steps as jsteps
    from vqatpu.train.checkpoints import save_checkpoint_orbax

    kw = MODELS[name]
    model = build_model(JaxModelConfig(**kw))
    state = jsteps.make_train_state(model, jax.random.PRNGKey(PARAM_SEED))
    path = golden_dir(name)
    shutil.rmtree(path, ignore_errors=True)
    save_checkpoint_orbax(str(path), state, EPOCH)
    b = batch(kw)
    pallas = build_model(JaxModelConfig(**kw, kernel_backend="pallas"))
    with pltpu.force_tpu_interpret_mode():
        out = jsteps.make_eval_step(pallas)(state.params, {
            k: jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
            for k, x in b.items()})
    np.savez_compressed(DATA / f"torch_orbax_{name}.npz",
                        logits=np.asarray(out["logits"]),
                        config=json.dumps(kw), n=N,
                        param_seed=PARAM_SEED, batch_seed=BATCH_SEED,
                        epoch=EPOCH, boxes=V, real_boxes=REAL_BOXES)


def split_weight() -> np.ndarray:
    rs = np.random.RandomState(PARAM_SEED)
    return rs.randn(SPLIT_ROWS, SPLIT_COLS).astype(np.float32)


def two_process_worker(pid: int, port: int, path: str) -> None:
    """One of the two processes of the two-process golden."""
    import jax
    import orbax.checkpoint as ocp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vqatpu.parallel.distributed import global_mesh, init_distributed

    init_distributed(f"127.0.0.1:{port}", 2, pid, cpu_gloo=True)
    mesh = global_mesh("x")
    w = split_weight()
    split = jax.make_array_from_callback(
        w.shape, NamedSharding(mesh, P("x")), lambda index: w[index])
    whole = jax.make_array_from_callback(
        (3,), NamedSharding(mesh, P()),
        lambda index: np.arange(3, dtype=np.float32)[index])
    ocp.PyTreeCheckpointer().save(path, {
        "epoch": np.asarray(EPOCH), "step": np.asarray(7),
        "params": {"classifier": {"l1": {"v": split, "b": whole}}},
        "opt_state": [None, {}]})


def write_two_process() -> None:
    path = golden_dir("2proc")
    shutil.rmtree(path, ignore_errors=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)  # one CPU device a process
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_orbax_goldens", "--worker",
         str(pid), str(port), str(path)], cwd=ROOT, env=env)
        for pid in range(2)]
    for p in procs:
        if p.wait(timeout=300):
            raise RuntimeError(f"a two-process worker exited {p.returncode}")
    assert sorted(d for d in os.listdir(path) if d.startswith("ocdbt.")) == [
        "ocdbt.process_0", "ocdbt.process_1"], os.listdir(path)
    np.savez_compressed(DATA / "torch_orbax_2proc.npz", v=split_weight(),
                        epoch=EPOCH, step=7)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        two_process_worker(int(argv[1]), int(argv[2]), argv[3])
        return
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name, write in (("cti", lambda: write_model("cti")),
                        ("tan", lambda: write_model("tan")),
                        ("2proc", write_two_process)):
        t0 = time.time()
        write()
        print(f"{name}: {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
