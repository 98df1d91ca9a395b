"""Fixtures of the benchmark's tests: the repository's root on the path, the
card's presence decided inside a fixture, and cells cut to a tiny size
(widths and counts) for the CPU, with the real cells' limits."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_MODEL = dict(ntoken=50, v_dim=16, num_hid=32, h_mm=16, rank=4)
SEED = 2**40 + 7  # wider than 32 bits, as the driver's are


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def tiny_cell(tmp_path: Path, name: str, tiny: bool = True, **workload):
    """``name`` cut to the CPU: tiny widths, a split of 64 questions over 10
    images of 2 to 8 boxes (or 6 grid cells), 4 questions a batch, update
    every 2nd microbatch, 2 check updates; the real limits.  ``tiny=False``
    keeps the cell's widths and batch and cuts only the split (4,096
    questions over 400 images)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = [w for w in bench["workloads"] if w["name"] == name]
    if not entry:  # a proven cell held out of BENCHMARK.json
        config, traffic = name.split(".")
        entry = [{"name": name, "config": config, "traffic": traffic,
                  "chips": 1, "why": "held out"}]
        bench["workloads"].append(entry[0])
    entry = entry[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == entry["config"]][0]
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    wl = json.loads((ROOT / "benchmark" / "workloads" / f"{name}.json")
                    .read_text())
    if not tiny:  # published widths and batch, a small split
        wl.update(questions=4096, images=400)
        wl.update(workload)
        return _write(tmp_path, name, bench, cfg_entry, cfg, wl)
    cfg["model"].update(TINY_MODEL)
    if cfg["model"]["task"] == "ffoe":
        cfg["model"]["num_ans_candidates"] = 7
    cfg["train"]["update_freq"] = 2
    wl.update(questions=64, images=10, batch=2 if "candidates" in wl else 4,
              check_updates=2)
    if "grid" in wl:
        wl.update(grid=6, max_boxes=6)
    else:
        wl.update(boxes=[2, 8], max_boxes=6)
    if "labels" in wl:
        wl["labels"] = [1, 3]
    wl.update(workload)
    return _write(tmp_path, name, bench, cfg_entry, cfg, wl)


def _write(tmp_path, name, bench, cfg_entry, cfg, wl):
    from benchmark import core

    (tmp_path / "benchmark" / "workloads").mkdir(parents=True)
    (tmp_path / "benchmark" / "workloads" / f"{name}.json").write_text(
        json.dumps(wl))
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    cfg_entry["file"] = "config.json"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return core.Cell(name, root=tmp_path)


CELLS = ("cti_vqa2.train", "tan_v7w.train_grid", "cti_vqa2.eval")
