"""vqatpu_torch and chip_smoke.py import neither JAX nor vqatpu, nor orbax,
tensorstore or zstandard (the port reads and writes ``.orbax`` checkpoints
itself): the machine with the card has none of them.  The run is checked
in a subprocess, because this test process has imported JAX already
(tests/conftest.py)."""

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
FORBIDDEN = ("jax", "jaxlib", "vqatpu", "orbax", "tensorstore", "zstandard")
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
import vqatpu_torch.tools.import_torch, vqatpu_torch.tools.export_torch
import vqatpu_torch.tools.create_embedding, vqatpu_torch.train.profiling
import vqatpu_torch.kernels.blockwise, vqatpu_torch.ops.tensor
import vqatpu_torch.parallel, vqatpu_torch.parallel.distributed
import vqatpu_torch.tools.create_dictionary, vqatpu_torch.tools.compute_softscore
import vqatpu_torch.tools.feature_converter
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
# the .pth tools and CTI's v-side knobs, through the port alone
import dataclasses, tempfile
from vqatpu_torch.tools.export_torch import export_checkpoint
from vqatpu_torch.train.checkpoints import load_params_any
with tempfile.TemporaryDirectory() as d:
    export_checkpoint(d + "/model_epoch0.pth",
                      load_jax_params(build_model(cfg), numpy_params(cfg, 2)))
    assert load_params_any(d, 0, build_model(cfg))["t_att"]["tc"]["T_g"].shape
# .orbax through the system's libzstd alone: a round trip, JAX's golden
from vqatpu_torch.train.checkpoints import (restore_orbax,
                                            restore_train_state_orbax,
                                            save_checkpoint_orbax)
with tempfile.TemporaryDirectory() as d:
    save_checkpoint_orbax(d + "/model_epoch1.orbax", state, 1)
    assert restore_train_state_orbax(d + "/model_epoch1.orbax", state)[1] == 2
assert restore_orbax("tests/data/torch_orbax_2proc/model_epoch3.orbax"
                     )["step"] == 7
for knob in (dict(v_block_size=2), dict(fused_v_tucker=True),
             dict(remat_glimpse=True)):
    model = load_jax_params(build_model(dataclasses.replace(cfg, **knob)),
                            numpy_params(cfg, 2))
    out, _ = model(torch.from_numpy(rs.randn(2, 5, 16).astype(np.float32)),
                   torch.from_numpy(rs.randint(0, 31, (2, 12))),
                   torch.from_numpy(rs.randint(0, 31, (2, 3))))
    assert np.isfinite(out.detach().numpy()).all()
with vqatpu_torch.train.profiling.trace(None):
    pass
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
    assert {"vqatpu_torch.ops.bilinear", "vqatpu_torch.ops.counter",
            "vqatpu_torch.tools.import_torch", "vqatpu_torch.train.profiling",
            "vqatpu_torch.kernels.blockwise", "vqatpu_torch.parallel.sharding",
            "vqatpu_torch.parallel.collectives",
            "vqatpu_torch.parallel.distributed",
            "vqatpu_torch.tools.create_dictionary",
            "vqatpu_torch.tools.compute_softscore",
            "vqatpu_torch.tools.feature_converter"} <= set(modules)
    # the converter imports h5py only when it writes
    assert "h5py" not in modules
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


HOST_TOOLS = ("export_torch", "create_dictionary", "compute_softscore",
              "feature_converter")


@pytest.mark.parametrize("tool", ["create_embedding", *HOST_TOOLS])
def test_tool_entry_points_default_to_cuda(tool):
    """The answer-embedding tool encodes (GRU and BERT) on ``--device
    cuda`` unless told otherwise; the ``.pth`` exporter and the offline
    preprocessing tools are host-only file conversions and take no
    ``--device`` (the preprocessing tools import no torch either)."""
    import importlib
    import inspect

    mod = importlib.import_module(f"vqatpu_torch.tools.{tool}")
    if tool in HOST_TOOLS:
        source = inspect.getsource(mod)
        assert "--device" not in source
        if tool != "export_torch":
            assert "import torch" not in source
        return
    assert "--device" in inspect.getsource(mod.main)
    for fn in (mod.create_answer_embedding, mod.create_bert_embedding,
               mod.bert_embedding_matrix):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    parser_default = [line for line in inspect.getsource(mod.main).splitlines()
                      if '"--device"' in line]
    assert parser_default and 'default="cuda"' in parser_default[0]


@pytest.mark.parametrize("kind,fn", [("gru", "create_answer_embedding"),
                                     ("bert", "create_bert_embedding")])
@pytest.mark.parametrize("argv,device", [([], "cuda"),
                                         (["--device", "cpu"], "cpu")])
def test_create_embedding_main_passes_its_device(monkeypatch, kind, fn,
                                                 argv, device):
    """``create_embedding.main`` hands ``--device`` to the encoder of
    either kind."""
    from vqatpu_torch.tools import create_embedding

    seen = {}
    monkeypatch.setattr(create_embedding, fn,
                        lambda *a, **k: seen.update(k) or "out")
    create_embedding.main(["--kind", kind, *argv])
    assert seen["device"] == device


def test_parallel_defaults_to_cuda():
    """Several processes join over NCCL, on CUDA, unless the caller asks for
    gloo (the CPU); the train CLIs ask for it with ``--device cpu`` only."""
    import inspect

    from vqatpu_torch.cli import common
    from vqatpu_torch.parallel import distributed

    sig = inspect.signature(distributed.init_distributed)
    assert sig.parameters["cpu_gloo"].default is False
    assert 'cpu_gloo=args.device == "cpu"' in inspect.getsource(
        common.maybe_init_distributed)
    for fn in (distributed.local_batch_slice, distributed.replicate_tree_global):
        assert "device" not in inspect.signature(fn).parameters
