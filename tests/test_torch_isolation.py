"""vqatpu_torch and chip_smoke.py import neither JAX nor vqatpu: the machine
with the card has no JAX.  The run is checked in a subprocess, because this
test process has imported JAX already (tests/conftest.py)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from vqatpu.config import ModelConfig as JaxModelConfig
from vqatpu.models import build_model as jax_build_model
from vqatpu.train.checkpoints import save_checkpoint
from vqatpu.train.steps import make_train_state

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "vqatpu")
CFG = dict(ntoken=30, v_dim=16, num_ans_candidates=7, model="cti",
           num_hid=16, h_mm=8, rank=2, gamma=2)

RUN = """
import json, sys
import numpy as np
import torch
import vqatpu_torch, vqatpu_torch.cli.serve, vqatpu_torch.weights
import vqatpu_torch.train, vqatpu_torch.train.optim, vqatpu_torch.train.steps
import vqatpu_torch.ops.losses, vqatpu_torch.numerics
import vqatpu_torch.cli.ffoe_train, vqatpu_torch.cli.ffoe_test
import vqatpu_torch.data.synthetic, vqatpu_torch.data.tfidf
import vqatpu_torch.train.loop, vqatpu_torch.eval.ffoe
import vqatpu_torch.eval.tdiuc, vqatpu_torch.cli.evaluate_tdiuc
import vqatpu_torch.cli.ensemble, vqatpu_torch.data.device_store
import vqatpu_torch.data.native, vqatpu_torch.data.upload
import vqatpu_torch.ops.bilinear, vqatpu_torch.ops.counter
from vqatpu_torch.models import build_model
from vqatpu_torch.weights import load_jax_params, numpy_batch, numpy_params
from vqatpu_torch.train.checkpoints import restore_train_state
from vqatpu_torch.config import ModelConfig, TrainConfig
from vqatpu_torch.serve import InferenceSession
from vqatpu_torch.train import make_train_state, make_train_step
cfg = ModelConfig(**json.loads(sys.argv[2]))
sess = InferenceSession.from_checkpoint(sys.argv[1], cfg, list("abcdefg"),
                                        device="cpu")
rs = np.random.RandomState(0)
out = sess.logits(rs.randn(2, 5, 16).astype(np.float32), None,
                  rs.randint(0, 31, (2, 12)), rs.randint(0, 31, (2, 3)))
assert out.shape == (2, 7) and np.isfinite(out).all()
state = make_train_state(sess.model, device="cpu")
state, start, _ = restore_train_state(sys.argv[1], state)  # optax's classes
assert start == 1 and state.optimizer.count == 0
step = make_train_step(state.model, TrainConfig(update_freq=1))
m = step(state, {"v": rs.randn(2, 5, 16).astype(np.float32),
                 "q": rs.randint(0, 31, (2, 12)), "a": rs.randint(0, 31, (2, 3)),
                 "target": rs.rand(2, 7).astype(np.float32)},
         1e-3, torch.Generator().manual_seed(0))
assert np.isfinite(m["loss"].item()) and state.step == 1
for name in ("ban", "san"):  # the new models, through the port alone
    small = ModelConfig(ntoken=30, v_dim=16, num_ans_candidates=7,
                        model=name, num_hid=16, use_counter=True)
    model = load_jax_params(build_model(small), numpy_params(small, 1))
    nb = numpy_batch(small, 2, boxes=5, real_boxes=4, target=True,
                     teacher=True)
    sess = InferenceSession(model, list("abcdefg"), device="cpu")
    assert np.isfinite(sess.logits(nb["v"], nb["b"], nb["q"])).all()
    state = make_train_state(model, device="cpu")
    m = make_train_step(model, TrainConfig(update_freq=1, distillation=True))(
        state, nb, 1e-3, torch.Generator().manual_seed(0))
    assert np.isfinite(m["loss"].item())
q8, _ = vqatpu_torch.data.native.quantize_rows(rs.randn(3, 16))
assert q8.dtype == np.int8  # the port's host runtime, built and loaded
with open("/proc/self/maps") as f:
    libs = sorted({line.split()[-1] for line in f if ".so" in line})
print(json.dumps(libs))
print(json.dumps(sorted(sys.modules)))
"""


def _is_forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_port_runs_without_jax_or_vqatpu(tmp_path):
    ckpt = tmp_path / "model_epoch0.ckpt"
    state = make_train_state(jax_build_model(JaxModelConfig(**CFG)),
                             jax.random.PRNGKey(0))
    save_checkpoint(str(ckpt), state, epoch=0)
    proc = subprocess.run(
        [sys.executable, "-c", RUN, str(ckpt), json.dumps(CFG)], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    modules = json.loads(proc.stdout.splitlines()[-1])
    assert "vqatpu_torch.weights" in modules
    assert {"vqatpu_torch.ops.bilinear", "vqatpu_torch.ops.counter"} <= set(
        modules)
    assert [m for m in modules if _is_forbidden(m)] == []
    # the port's own runtime is loaded, never the JAX package's
    libs = json.loads(proc.stdout.splitlines()[-2])
    assert any(lib.startswith(str(ROOT / "vqatpu_torch" / "_build" /
                                  "libvqadata-")) for lib in libs), libs
    assert not [lib for lib in libs if "libvqadata" in lib
                and not lib.startswith(str(ROOT / "vqatpu_torch"))], libs


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py",
                                  *sorted((ROOT / "vqatpu_torch").rglob("*.py"))],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_vqatpu(path):
    """Every import statement, also those inside functions."""
    assert [m for m in _imports(path) if _is_forbidden(m)] == []


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py",
                                  *sorted((ROOT / "vqatpu_torch").rglob("*.py")),
                                  *sorted((ROOT / "vqatpu_torch").rglob("*.cc"))],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_the_jax_native_runtime(path):
    """Neither the JAX package's library nor its binding: the port builds
    and loads its own copy (``vqatpu_torch/native/vqadata.cc``)."""
    text = path.read_text()
    for name in ("native/libvqadata.so", "vqatpu.data.native"):
        assert name not in text, name


@pytest.mark.parametrize("cli", ["ffoe_train", "ffoe_test", "mc_train",
                                 "mc_test", "serve", "evaluate_tdiuc",
                                 "ensemble"])
def test_entry_points_default_to_cuda(cli):
    """The CLIs that touch a device default to ``--device cuda``, and so do
    ``train()`` and ``DeviceFeatureStore.build``; evaluate_tdiuc and
    ensemble touch no device and take no ``--device``."""
    import importlib
    import inspect

    from vqatpu_torch.data.device_store import DeviceFeatureStore
    from vqatpu_torch.train.loop import train

    mod = importlib.import_module(f"vqatpu_torch.cli.{cli}")
    source = inspect.getsource(mod)
    if cli in ("evaluate_tdiuc", "ensemble"):
        assert "--device" not in source and "import torch" not in source
        return
    parse = getattr(mod, "parse_args", None) or mod.build_parser().parse_args
    assert parse([]).device == "cuda"
    for fn in (train, DeviceFeatureStore.build):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
