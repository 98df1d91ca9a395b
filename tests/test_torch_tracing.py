"""The port's spans and counters (``vqatpu_torch.train.profiling``) on the
CPU: a disabled span is a shared no-op that calls nothing of torch; under
``tracing`` nested spans get their parents, microbatch indices and self
times, on the clock of a profiler trace; the train step's and the feed's
spans (the feed's carrying the index of the step that consumes them);
counters attributed to the innermost span, torch's sync reports counted and
never printed; and training bit for bit the same with the tracer on.  The
card-only case plants a synchronising ``.item()`` in a span."""

import contextlib
import json
import sys
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vqatpu_torch.config import ModelConfig, TrainConfig
from vqatpu_torch.data.batching import PrefetchLoader
from vqatpu_torch.data.device_store import DeviceFeatureStore
from vqatpu_torch.data.mc_dataset import expand_mc_batch
from vqatpu_torch.data.upload import PinnedUploader
from vqatpu_torch.models import build_model
from vqatpu_torch.train import make_train_state, make_train_step, profiling
from vqatpu_torch.train.profiling import count, span, tracing
from vqatpu_torch.weights import numpy_batch

SMALL = dict(ntoken=50, v_dim=16, num_ans_candidates=7, model="cti",
             num_hid=32, h_mm=16, rank=4, gamma=2)
PHASES = ("train_step.forward", "train_step.backward", "train_step.optimizer")


def no_counters():
    return {}


class TickClock:
    """``time.time_ns`` that advances 10 ns a call."""

    def __init__(self):
        self.t = 0

    def time_ns(self):
        self.t += 10
        return self.t


def by_name(export, name):
    return [s for s in export["spans"] if s["name"] == name]


def test_an_off_span_records_nothing_and_calls_no_torch_function():
    assert profiling._tracer is None and profiling._open is None
    assert span("feed.upload") is span("train_step", device=True)
    calls = []

    def watch(frame, event, arg):
        if event == "c_call" and arg is not sys.setprofile:
            calls.append(("c", getattr(arg, "__qualname__", repr(arg))))
        elif event == "call":
            calls.append((frame.f_code.co_filename, frame.f_code.co_name))

    sys.setprofile(watch)
    try:
        with span("train_step", device=True):
            with span("train_step.forward", device=True):
                count("upload_blocked")
    finally:
        sys.setprofile(None)
    assert {f for f, _ in calls} == {profiling.__file__}, calls
    assert {n for _, n in calls} == {"span", "count", "__enter__",
                                     "__exit__"}


def test_nested_spans_get_parents_microbatches_and_self_times(monkeypatch):
    monkeypatch.setattr(profiling, "time", TickClock())
    with tracing(device=False, counters=no_counters) as tr:
        with span("feed.upload"):  # 10
            with span("feed.upload_wait"):  # 20, 30
                pass
        with span("train_step", device=True):  # 40 (no card: no events)
            with span("train_step.forward", device=True):  # 50, 60
                pass
            with span("train_step.backward"):  # 70, 80
                pass
        with span("feed.gather"):  # 100, 110
            pass
        with span("train_step"):  # 120, 130
            pass
    spans = tr.export()["spans"]
    assert [s["name"] for s in spans] == [
        "feed.upload", "feed.upload_wait", "train_step",
        "train_step.forward", "train_step.backward", "feed.gather",
        "train_step"]
    assert [s["parent"] for s in spans] == [None, 0, None, 2, 2, None, None]
    assert [s["micro"] for s in spans] == [0, 0, 0, 0, 0, 1, 1]
    assert [s["end_ns"] - s["start_ns"] for s in spans] == [
        30, 10, 50, 10, 10, 10, 10]
    assert [round(s["host_self_ms"] * 1e6) for s in spans] == [
        20, 10, 30, 10, 10, 10, 10]
    assert all(s["device_ms"] is None and s["device_self_ms"] is None
               for s in spans)
    assert profiling._tracer is None and profiling._open is None


def test_span_stamps_are_on_the_profiler_traces_clock(tmp_path):
    a, b = torch.randn(256, 256), torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing(device=False, counters=no_counters) as tr:
            with span("train_step.forward"):
                torch.mm(a, b)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    (mm,) = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm"]
    (s,) = tr.export()["spans"]
    start = base + round(float(mm["ts"]) * 1e3)
    end = start + round(float(mm["dur"]) * 1e3)
    assert s["start_ns"] <= start <= end <= s["end_ns"], (s, start, end)


def _small_run(update_freq, traced):
    cfg = ModelConfig(**SMALL)
    torch.manual_seed(0)
    state = make_train_state(build_model(cfg), seed=3, device="cpu")
    step = make_train_step(state.model, TrainConfig(update_freq=update_freq))
    gen = torch.Generator().manual_seed(5)
    batches = [numpy_batch(cfg, 4, seed=20 + i, boxes=6, real_boxes=5,
                           target=True) for i in range(2)]
    losses = []
    with tracing(device=False) if traced else contextlib.nullcontext() as tr:
        for b in batches:
            losses.append(step(state, b, 1e-3, gen, False)["loss"])
    params = [p.detach().clone() for p in state.model.parameters()]
    return losses, params, tr


@pytest.mark.parametrize("update_freq", [1, 2])
def test_steps_are_bit_identical_with_the_tracer_on(update_freq):
    losses, params, _ = _small_run(update_freq, traced=False)
    losses_t, params_t, tr = _small_run(update_freq, traced=True)
    assert all(torch.equal(a, b) for a, b in zip(losses, losses_t))
    assert all(torch.equal(a, b) for a, b in zip(params, params_t))
    spans = tr.export()["spans"]
    steps = by_name({"spans": spans}, "train_step")
    assert [s["micro"] for s in steps] == [0, 1]
    for i, st in enumerate(spans):
        if st["name"] != "train_step":
            continue
        kids = [s for s in spans if s["parent"] == i]
        assert [k["name"] for k in kids] == list(PHASES)
        assert all(k["micro"] == st["micro"] for k in kids)
        total = sum(k["host_ms"] for k in kids) + st["host_self_ms"]
        assert total == pytest.approx(st["host_ms"], abs=1e-9)


def test_counters_go_to_the_innermost_span(monkeypatch):
    """The counter source's deltas over a ``train_step`` go to that step;
    ``count`` goes to the innermost open span, and nowhere outside every
    span; unchanged counts leave no entry."""
    reads = iter([{"launches": 5, "device_free": 0, "alloc_retries": 1},
                  {"launches": 9, "device_free": 2, "alloc_retries": 1},
                  {"launches": 9, "device_free": 2, "alloc_retries": 1},
                  {"launches": 12, "device_free": 2, "alloc_retries": 1}])
    with tracing(device=False, counters=lambda: next(reads)) as tr:
        count("upload_blocked")  # outside every span: not counted
        with span("train_step"):
            with span("train_step.forward"):
                count("upload_blocked")
                count("upload_blocked", 2)
        with span("feed.upload"):
            with span("feed.upload_wait"):
                count("upload_blocked")
        with span("train_step"):
            pass
    ex = tr.export()
    got = sorted((c["name"], ex["spans"][c["span"]]["name"], c["micro"],
                  c["value"]) for c in ex["counters"])
    assert got == [("device_free", "train_step", 0, 2),
                   ("launches", "train_step", 0, 4),
                   ("launches", "train_step", 1, 3),
                   ("upload_blocked", "feed.upload_wait", 1, 1),
                   ("upload_blocked", "train_step.forward", 0, 3)]


def test_sync_reports_are_counted_in_their_span_and_never_printed(recwarn):
    msg = "called a synchronizing CUDA operation"
    with tracing(device=False, counters=no_counters) as tr:
        warnings.warn(msg)  # outside every span: swallowed, not counted
        with span("train_step.optimizer"):
            for _ in range(2):  # one line twice: no once-per-line registry
                warnings.warn(msg)
            warnings.warn("another warning")
    assert [str(w.message) for w in recwarn] == ["another warning"]
    assert [(c["name"], c["value"]) for c in tr.export()["counters"]] == [
        ("sync_reported", 2)]
    warnings.warn(msg)  # the tracer is gone: shown as any warning
    assert str(recwarn[-1].message) == msg


def _mc_feed(n_batches, q=2, max_boxes=6):
    """A card-resident store on the CPU (8 images of 6 box rows, v_dim 16)
    and loader batches of ``q`` questions that ship ``ds_idx``."""
    cfg = ModelConfig(**dict(SMALL, num_ans_candidates=2, task="mc"))
    rs = np.random.RandomState(0)
    n_img = 8
    feats = torch.from_numpy(rs.randn(n_img * max_boxes + 1, 16)
                             .astype(np.float32))
    spats = torch.from_numpy(rs.rand(n_img * max_boxes + 1, 6)
                             .astype(np.float32))
    feats[-1], spats[-1] = 0.0, 0.0
    rows = np.arange(n_img * max_boxes, dtype=np.int32).reshape(n_img, -1)
    store = DeviceFeatureStore(feats, None, spats, rows,
                               np.arange(n_img, dtype=np.int64),
                               n_img * max_boxes)
    batches = []
    for i in range(n_batches):
        nb = numpy_batch(cfg, q, seed=30 + i, boxes=max_boxes)
        batches.append({"q": nb["q"], "ans_mc": nb["ans_mc"],
                        "label": nb["label"], "qid": nb["qid"],
                        "ds_idx": rs.randint(0, n_img, q)})
    return cfg, store, batches


def test_the_feed_spans_carry_the_index_of_their_step():
    """The loop's feed (loader, expansion, fields' upload, store gather)
    then the step, three microbatches: every feed span has the index of
    the step after it, and the gather's rows upload nests in the gather."""
    cfg, store, batches = _mc_feed(3)
    state = make_train_state(build_model(cfg), seed=1, device="cpu")
    step = make_train_step(state.model, TrainConfig(update_freq=2),
                           mc_scoring=True)
    upload, gen = PinnedUploader("cpu"), torch.Generator().manual_seed(0)
    with tracing(device=False) as tr:
        for batch in PrefetchLoader(batches):
            batch = expand_mc_batch(batch)
            db = upload({k: batch[k] for k in ("q", "a", "target")})
            db.update(store.gather(batch["ds_idx"]))
            step(state, db, 1e-3, gen)
    spans = tr.export()["spans"]
    assert [s["micro"] for s in by_name({"spans": spans}, "train_step")] \
        == [0, 1, 2]
    per_micro = {m: [s["name"] for s in spans if s["micro"] == m
                     and not s["name"].startswith("train_step")]
                 for m in range(3)}
    want = ["feed.loader_wait", "feed.expand", "feed.upload", "feed.gather",
            "feed.upload"]
    assert per_micro == {0: want, 1: want, 2: want}
    # the loader's last wait (for its end) comes after the third step
    assert spans[-1]["name"] == "feed.loader_wait" and spans[-1]["micro"] == 3
    for i, s in enumerate(spans):
        if s["name"] == "feed.gather":
            assert spans[i + 1]["name"] == "feed.upload"
            assert spans[i + 1]["parent"] == i


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_a_planted_item_counts_one_sync_reported(cuda):
    x = torch.ones(1024, device="cuda")
    with tracing() as tr:
        with span("train_step", device=True):
            with span("train_step.forward", device=True):
                y = (x * 2).sum()
            with span("train_step.backward", device=True):
                y.item()
    ex = tr.export()
    syncs = [(ex["spans"][c["span"]]["name"], c["value"])
             for c in ex["counters"] if c["name"] == "sync_reported"]
    assert syncs == [("train_step.backward", 1)]
    step, fwd, bwd = ex["spans"]
    assert all(s["device_ms"] is not None and s["device_ms"] >= 0
               for s in ex["spans"])
    assert step["device_self_ms"] == pytest.approx(
        step["device_ms"] - fwd["device_ms"] - bwd["device_ms"])
    assert torch.cuda.get_sync_debug_mode() == 0
