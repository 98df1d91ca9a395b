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
step = make_train_step(state.model, TrainConfig(update_freq=1))
m = step(state, {"v": rs.randn(2, 5, 16).astype(np.float32),
                 "q": rs.randint(0, 31, (2, 12)), "a": rs.randint(0, 31, (2, 3)),
                 "target": rs.rand(2, 7).astype(np.float32)},
         1e-3, torch.Generator().manual_seed(0))
assert np.isfinite(m["loss"].item()) and state.step == 1
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
    assert [m for m in modules if _is_forbidden(m)] == []


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
