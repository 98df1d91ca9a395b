"""Dry runs of the harness on the CPU at tiny sizes: every cell's whole
run (set-up, the check's steps, the window, the spans, the plain
reference and the comparison) with ``correct`` true under the real limits;
no device number is reported off the card; and each fault a cell can
have, planted in the program underneath, makes ``correct`` false."""

from __future__ import annotations

import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import core
from conftest import CELLS, ROOT, SEED, tiny_cell

DEVICE_METRICS = {"gather_ms", "call_device_ms", "mfu_pct",
                  "fwd_kernels_roofline", "bwd_kernels_roofline", "idle_pct",
                  "peak_work_gib"}


@pytest.fixture(autouse=True)
def _sweep_keeps_every_batch(monkeypatch):
    """The sweep's sample keeps every batch, so that a short window on a
    loaded host still holds a kept batch for the comparison to judge."""
    from benchmark.traffic import logits

    monkeypatch.setattr(logits, "STRIDE", (1, 2))


def _run(cell, trace=False, seconds=0.3):
    return core.run(cell, SEED, seconds, trace, time.perf_counter(),
                    device="cpu")


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct_and_reports_no_device_number(
        tmp_path, name, trace):
    cell = tiny_cell(tmp_path, name)
    rec = _run(cell, trace)
    assert rec["correct"], rec["checks"]
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert set(rec["checks"]) >= set(cell.workload["limits"])
    got = core.metric_values(cell, rec)
    assert not set(got) & DEVICE_METRICS
    with pytest.raises(RuntimeError, match="not on the card"):
        core.result_line(cell, rec)


def _broken_adamax(monkeypatch):
    """A step that leaves the state unchanged."""
    from vqatpu_torch.train import optim

    monkeypatch.setattr(optim.Adamax, "step", lambda self, grads, lr: None)


def _half_batch(monkeypatch):
    """Half of each batch left out; the loss is the mean over the rest."""
    from benchmark.traffic import train as kind

    real = kind.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def half(state, batch, *rest, **kw):
            n = len(batch["q"]) // 2
            return step(state, {k: v[:n] for k, v in batch.items()}, *rest,
                        **kw)
        return half
    monkeypatch.setattr(kind, "make_train_step", make)


def _row_altered(monkeypatch):
    """One row's logits moved by 1 where they are made."""
    from vqatpu_torch.train import steps

    real = steps.forward_in

    def bumped(*args, **kwargs):
        logits = real(*args, **kwargs)
        bump = torch.zeros_like(logits)
        bump[0] = 1.0
        return logits + bump
    monkeypatch.setattr(steps, "forward_in", bumped)


TRAIN_FAULTS = {"state_unchanged": _broken_adamax, "half_batch": _half_batch,
                "row_altered": _row_altered}


@pytest.mark.parametrize("name", [c for c in CELLS if "eval" not in c])
@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_a_training_fault_is_not_correct(tmp_path, monkeypatch, name, fault):
    cell = tiny_cell(tmp_path, name)
    TRAIN_FAULTS[fault](monkeypatch)
    rec = _run(cell)
    assert not rec["correct"], rec["checks"]


def test_a_sweep_fault_is_not_correct(tmp_path, monkeypatch):
    cell = tiny_cell(tmp_path, "cti_vqa2.eval")
    _row_altered(monkeypatch)
    rec = _run(cell)
    assert not rec["correct"], rec["checks"]


def test_without_a_card_the_entry_exits_without_a_result(capsys):
    from benchmark import run

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc = run.main(["--workload", "cti_vqa2.train", "--seed", str(SEED),
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_alone_the_benchmark_exits_without_a_result(tmp_path):
    """A directory with only ``BENCHMARK.json`` and the benchmark's files:
    the entry, and a run past the look for a card, exit without a result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cmd in (
            [sys.executable, "-m", "benchmark.run", "--workload",
             "cti_vqa2.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
            [sys.executable, "-c", "import time, benchmark.core as c; "
             "c.run(c.Cell('cti_vqa2.train'), 1, 1.0, False, "
             "time.perf_counter(), device='cpu')"]):
        out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                             timeout=120, env={"PATH": "/usr/bin:/bin",
                                               "HOME": str(tmp_path)})
        assert out.returncode != 0 and out.stdout == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    for name in [n for n in sys.modules if n.split(".")[0] in core.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "vqatpu_torch_probe", object())
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert core.forbidden_modules() == ["jax"]
