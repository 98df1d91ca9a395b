"""Runs one cell: finds everything by name, times set-up and the window,
reads the metrics, checks the timed path's outputs against the plain
reference and assembles the result line.

By name (``BENCHMARK.json`` holds the names):

- a cell's workload file ``benchmark/workloads/<cell>.json`` holds its
  traffic's parameters, ``kind`` among them;
- ``benchmark/traffic/<kind>.py`` drives that kind of traffic through the
  program (``Session``);
- a configuration's file (``BENCHMARK.json``'s ``file``) holds its sizes,
  its ``architecture``, whose plain reference is
  ``benchmark/reference/<architecture>.py``, and the program's model class;
- each metric is ``benchmark/metrics/<metric>.py``, whose ``read(record)``
  gives the number or None.
"""

from __future__ import annotations

import gc
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from benchmark import compare, spans

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "vqatpu")
PROFILED_S = 3.0  # the longest profiled stretch of a traced run


class Cell:
    """A cell of ``BENCHMARK.json`` with its workload file and its
    configuration."""

    def __init__(self, name: str, bench: Optional[dict] = None,
                 root: Path = ROOT):
        bench = bench or json.loads((root / "BENCHMARK.json").read_text())
        entry = [w for w in bench["workloads"] if w["name"] == name]
        if not entry:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entry[0]
        self.bench = bench
        cfg_entry = [c for c in bench["configs"]
                     if c["name"] == self.entry["config"]][0]
        self.config = json.loads((root / cfg_entry["file"]).read_text())
        self.workload = json.loads(
            (root / "benchmark" / "workloads" / f"{name}.json").read_text())
        self.arch = importlib.import_module(
            f"benchmark.reference.{self.config['architecture']}")

    @property
    def model(self) -> dict:
        return self.config["model"]

    def metrics(self, trace: bool) -> list:
        """The metrics this cell reports with ``--trace`` ``trace``."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]


def lr_at(train: dict, epoch: int) -> float:
    """The published schedule (``FFOE/train.py``): warm-up factors on the
    first epochs, then a decay every ``lr_decay_step`` epochs."""
    warm = train["warmup_factors"]
    if epoch < len(warm):
        return train["lr"] * warm[epoch]
    lr = train["lr"] * warm[-1]
    for e in range(train["lr_decay_start"], train["lr_decay_end"],
                   train["lr_decay_step"]):
        if e <= epoch:
            lr *= train["lr_decay_rate"]
    return lr


def program_class(path: str):
    """``"package.module:Class"`` -> the class."""
    module, name = path.split(":")
    return getattr(importlib.import_module(module), name)


def forbidden_modules() -> list:
    """Top-level names of ``sys.modules`` that are JAX's or its package's."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


class Laps:
    """Set-up's stages on the host clock, each printed to standard error."""

    def __init__(self, t_start: float):
        self.t_start = self.last = t_start

    def __call__(self, stage: str) -> None:
        t = time.perf_counter()
        print(f"setup: {stage} {t - self.last:.3f} s (at "
              f"{t - self.t_start:.3f} s)", file=sys.stderr)
        self.last = t


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda") -> dict:
    """One run of ``cell``: -> the record that the metric readers take,
    with ``correct``, ``checks``, ``attempted`` and ``failed``.  Off the
    card (the tests' dry run) no device number is recorded."""
    kind = importlib.import_module(
        f"benchmark.traffic.{cell.workload['kind']}")
    cuda = torch.device(device).type == "cuda"
    laps = Laps(t_start)
    laps("imports")
    sess = kind.Session(cell, seed, device, laps)
    rec = {"trace": trace, "shape": sess.shape, "train": sess.train,
           "device_name": torch.cuda.get_device_name(0) if cuda else "",
           "compute_dtype": cell.config["train"]["compute_dtype"],
           "flop_per_sample": sess.flop_per_sample}
    setup_peak = 0
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    # what set-up made lives to the end: the collector skips it
    gc.freeze()
    rec["setup_s"] = time.perf_counter() - t_start
    if not trace:
        rec["window"] = sess.window(seconds)
    else:
        sp = spans.Spans(device)
        rec["window"] = sess.window(seconds, sp=sp)
        sp.finish()
        rec["spans"] = {"host": dict(sp.host), "device": sp.device}
        if cuda:
            rec["profiled"], rec["profile"] = spans.profiled(
                lambda marks: sess.window(min(PROFILED_S, seconds / 4),
                                          marks=marks))
    gc.unfreeze()
    if cuda:
        window_peak = torch.cuda.max_memory_allocated()
        rec["window"]["peak_work_bytes"] = window_peak - base
        rec["memory_peak_bytes"] = max(setup_peak, window_peak)
    sess.close()
    readings, failed = sess.check()
    rec["correct"], rec["checks"] = compare.judge(
        readings, cell.workload.get("limits", {}))
    rec["failed"] = failed + rec["window"]["failed"]
    rec["checks"]["failed_samples"] = {"value": rec["failed"], "limit": 0}
    rec["correct"] = rec["correct"] and rec["failed"] == 0
    rec["attempted"] = rec["window"]["samples"]
    rec["readings"] = readings
    return rec


def metric_values(cell: Cell, rec: dict) -> dict:
    """``{name: {"value", "unit"}}`` of the metrics the cell reports in this
    run that found something to read."""
    out = {}
    for m in cell.metrics(rec["trace"]):
        reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
        value = reader.read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell: Cell, rec: dict) -> dict:
    """The last line of a run on the card.  Refuses a record made off the
    card: its numbers are not the device's."""
    if "memory_peak_bytes" not in rec:
        raise RuntimeError("no device numbers: this run was not on the card")
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell.entry["chips"],
           "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": rec["correct"], "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metric_values(cell, rec),
           "device": dev}
    if rec["trace"] and rec.get("profile"):
        dev["busy_s"] = rec["profile"]["busy_s"]
        dev["window_s"] = rec["profile"]["window_s"]
        out["breakdown"] = {"device_ops": rec["profile"]["device_ops"],
                            "idle_gaps": rec["profile"]["idle_gaps"]}
    out["checks"] = rec["checks"]
    return out
