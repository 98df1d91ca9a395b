"""``BENCHMARK.json`` against the benchmark's contract, and every name in
it against the file the harness finds by that name."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
WIDTHS = re.compile(r"(_dim|_rank|hid|h_mm|rank|hidden|intermediate|head)")


def test_top_level_and_limits():
    assert set(BENCH) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16 and BENCH["paths"] == ["benchmark"]
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert len(BENCH["command"]) <= 32
    n = len(BENCH["workloads"])
    assert 1 <= n <= 24
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, n // 4)
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_text():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(x) for x in names)
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_configurations():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        importlib.import_module(f"benchmark.reference.{cfg['architecture']}")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_has_its_files(w):
    wl = json.loads((ROOT / "benchmark" / "workloads" / f"{w['name']}.json")
                    .read_text())
    importlib.import_module(f"benchmark.traffic.{wl['kind']}")
    assert w["chips"] in (1, 4)
    assert set(wl["limits"]) >= ({"loss_gap", "grad_gap", "change_gap"}
                                 if wl["kind"] == "train"
                                 else {"logit_gap", "rows_misplaced"})


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for w in BENCH["workloads"]:
        reported = [m for m in e2e.values()
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_metric_has_its_reader(m):
    reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
    assert (reader.UNIT, reader.BETTER, reader.SOURCE) == (
        m["unit"], m["better"], m["source"])
    if "layer" in m:
        assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for cell in m.get("workloads", []):
        assert cell in {w["name"] for w in BENCH["workloads"]}
