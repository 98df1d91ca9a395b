"""``benchmark.phases``: its readers on a hand-built export (and None
without one), and a dry run of each training cell on the CPU at a tiny
size, where the program's spans are read and no device number is."""

from __future__ import annotations

import pytest

from benchmark import phases
from conftest import SEED, tiny_cell


def _span(name, micro, host, device=None, parent=None, self_host=None):
    return {"name": name, "micro": micro, "parent": parent,
            "host_ms": host, "device_ms": device,
            "host_self_ms": host if self_host is None else self_host,
            "device_self_ms": device}


def _export():
    """Two microbatches: feed (a gather with its rows upload inside), the
    step and its three phases; counters on both."""
    spans = []
    for m, k in ((0, 1.0), (1, 3.0)):
        base = len(spans)
        spans += [_span("feed.loader_wait", m, 9.0),
                  _span("feed.expand", m, 0.5 * k),
                  _span("feed.upload", m, 0.25 * k),
                  _span("feed.gather", m, 1.0 * k),
                  _span("feed.upload", m, 0.5 * k, parent=base + 3),
                  _span("train_step", m, 10.0 * k, 12.0 * k,
                        self_host=1.0 * k),
                  _span("train_step.forward", m, 5.0 * k, 4.0 * k,
                        parent=base + 5),
                  _span("train_step.backward", m, 3.0 * k, 6.0 * k,
                        parent=base + 5),
                  _span("train_step.optimizer", m, 1.0 * k, 1.0 * k,
                        parent=base + 5)]
    counters = [{"name": "launches", "span": 5, "micro": 0, "value": 4},
                {"name": "device_free", "span": 5, "micro": 0, "value": 2},
                {"name": "sync_reported", "span": 16, "micro": 1,
                 "value": 1},
                {"name": "upload_blocked", "span": 4, "micro": 0, "value": 1},
                {"name": "upload_blocked", "span": 0, "micro": 2, "value": 5}]
    return {"spans": spans, "counters": counters}


def test_the_readers_give_their_numbers_from_an_export():
    got = phases.metrics(_export())
    assert got == {"fwd_host_ms": 10.0, "fwd_device_ms": 8.0,
                   "bwd_host_ms": 6.0, "bwd_device_ms": 12.0,
                   "opt_host_ms": 2.0, "opt_device_ms": 2.0,
                   "feed_host_ms": 3.5,  # (1.75 + 5.25) / 2
                   "host_syncs": 4}  # micro 2 had no step: not counted
    totals = phases.counter_totals(_export())
    assert totals["launches"] == {"total": 4, "median_a_microbatch": 2.0}


def test_the_readers_give_none_without_an_export():
    assert set(phases.metrics(None).values()) == {None}
    assert set(phases.metrics({"spans": [], "counters": []}).values()) \
        == {None}


def test_the_phases_reconcile_with_the_step():
    class Outside:
        host = {"call": [11.0, 31.0, 21.0]}
        device = {"call": [13.0]}

    got = phases.reconcile(_export(), Outside())
    assert got["step_host_ms"] == 20.0 and got["call_host_ms"] == 21.0
    assert got["step_device_ms"] == 24.0 and got["call_device_ms"] == 13.0
    assert got["phases_gap_host_ms"] == 0.0
    # the device self times were built equal to the whole step's
    assert got["phases_gap_device_ms"] == pytest.approx(33.0)


@pytest.mark.parametrize("name", ["cti_vqa2.train", "tan_v7w.train_grid"])
def test_a_dry_run_reads_the_programs_spans(tmp_path, name):
    cell = tiny_cell(tmp_path, name)
    out = phases.measure(cell, SEED, 0.3, device="cpu")
    m = out["metrics"]
    assert all(m[k] is not None and m[k] >= 0 for k in
               ("fwd_host_ms", "bwd_host_ms", "opt_host_ms", "feed_host_ms"))
    assert all(m[k] is None for k in
               ("fwd_device_ms", "bwd_device_ms", "opt_device_ms"))
    assert m["host_syncs"] == 0
    r = out["reconcile"]
    assert 0 < r["step_host_ms"] <= r["call_host_ms"]
    assert r["phases_gap_host_ms"] < 1e-6
    assert out["microbatches"] > 0 and "idle_gaps" not in out
