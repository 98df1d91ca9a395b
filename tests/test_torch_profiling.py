"""``vqatpu_torch.train.profiling`` against ``vqatpu.train.profiling`` on
the CPU: ``trace`` writes a trace file that names the ranges of
``annotate`` (and nothing for None), ``StepTimer`` counts the rows JAX's
counts, and ``ffoe_train --profile_dir`` traces JAX's window of steps 1 to
``min(6, batches - 1)`` of the first epoch."""

import glob
import json
import os

import numpy as np
import torch

from vqatpu.data.synthetic import make_vqa_fixture
from vqatpu.train import profiling as jprof
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
        with profiling.annotate("my_range"):
            x = torch.ones(8, 8) @ torch.ones(8, 8)
    names = [e.get("name") for e in trace_events(out)]
    assert "my_range" in names and x.sum() == 512
    with profiling.trace(None):  # no-op
        pass


def test_step_timer_counts_rows_as_jaxs():
    ours, theirs = profiling.StepTimer(warmup=2), jprof.StepTimer(warmup=2)
    x = torch.ones(3)
    assert ours.samples_per_sec() == theirs.samples_per_sec() == 0.0
    for rows in (16, 16, 8, 32, 4):
        ours.step(rows, sync_value=x)
        theirs.step(rows)
        assert (ours.count, ours.rows) == (theirs.count, theirs.rows)
    assert ours.rows == 8 + 32 + 4
    assert ours.samples_per_sec(sync_value=x) > 0


def test_profile_dir_traces_jaxs_window(tmp_path):
    """4 batches an epoch: steps 1-3 are traced, each a ``train_step``
    range, in the first epoch only; the log says so."""
    root = str(tmp_path / "data_vqa")
    make_vqa_fixture(root, n_train=16, n_val=4, n_images=4, v_dim=16)
    prof, out = str(tmp_path / "prof"), str(tmp_path / "out")
    ffoe_train.main(["--model", "cti", "--dataroot", root, "--output", out,
                     "--epochs", "2", "--num_hid", "16", "--h_mm", "8",
                     "--rank", "2", "--batch_size", "4", "--max_boxes", "12",
                     "--device", "cpu", "--no_native_loader",
                     "--profile_dir", prof])
    events = trace_events(prof)
    steps = [e for e in events if e.get("name") == "train_step"
             and e.get("cat") == "user_annotation"]
    assert len(steps) == 3
    assert np.all(np.diff([e["ts"] for e in steps]) > 0)
    with open(os.path.join(out, "log.txt")) as f:
        assert f"profile of steps 1-3 written to {prof}" in f.read()
