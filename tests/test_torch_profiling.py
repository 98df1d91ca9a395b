"""``vqatpu_torch.train.profiling`` against ``vqatpu.train.profiling`` on
the CPU: ``trace`` writes a trace file that names the ranges of ``span``
(and nothing for None), and ``ffoe_train --profile_dir`` traces JAX's
window of steps 1 to ``min(6, batches - 1)`` of the first epoch, each
step's forward, backward and optimizer ranges inside its ``train_step``."""

import glob
import json
import os

import numpy as np
import torch

from vqatpu.data.synthetic import make_vqa_fixture
from vqatpu_torch.cli import ffoe_train
from vqatpu_torch.train import profiling


def trace_events(log_dir):
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_the_annotated_ranges(tmp_path):
    out = str(tmp_path / "trace")
    with profiling.trace(out):
        with profiling.span("my_range"):
            x = torch.ones(8, 8) @ torch.ones(8, 8)
    names = [e.get("name") for e in trace_events(out)]
    assert "my_range" in names and x.sum() == 512
    with profiling.trace(None):  # no-op
        pass


def test_profile_dir_traces_jaxs_window(tmp_path):
    """4 batches an epoch: steps 1-3 are traced, each a ``train_step``
    range around one range of each of its phases, in the first epoch only;
    the log says so."""
    root = str(tmp_path / "data_vqa")
    make_vqa_fixture(root, n_train=16, n_val=4, n_images=4, v_dim=16)
    prof, out = str(tmp_path / "prof"), str(tmp_path / "out")
    ffoe_train.main(["--model", "cti", "--dataroot", root, "--output", out,
                     "--epochs", "2", "--num_hid", "16", "--h_mm", "8",
                     "--rank", "2", "--batch_size", "4", "--max_boxes", "12",
                     "--device", "cpu", "--no_native_loader",
                     "--profile_dir", prof])
    events = [e for e in trace_events(prof)
              if e.get("cat") == "user_annotation"]
    steps = [e for e in events if e["name"] == "train_step"]
    assert len(steps) == 3
    assert np.all(np.diff([e["ts"] for e in steps]) > 0)
    for phase in ("forward", "backward", "optimizer"):
        ranges = [e for e in events if e["name"] == f"train_step.{phase}"]
        inside = [[r for r in ranges if s["ts"] <= r["ts"]
                   and r["ts"] + r["dur"] <= s["ts"] + s["dur"]]
                  for s in steps]
        assert [len(r) for r in inside] == [1, 1, 1], phase
    with open(os.path.join(out, "log.txt")) as f:
        assert f"profile of steps 1-3 written to {prof}" in f.read()
