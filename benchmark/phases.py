"""The program's own spans and counters over a training cell
(``vqatpu_torch.train.profiling.tracing``), reduced to per-phase numbers:

    python3 -m benchmark.phases --workload <cell> --seed <n> --seconds <s>

After the cell's set-up (as a run's, without its check against the
reference), three stretches of the cell's feed and step:

1. a window of ``--seconds`` without the tracer;
2. a window of ``--seconds`` under the tracer with CUDA events, with the
   benchmark's own spans around each call beside it (``host_call_ms`` and
   ``call_device_ms``, which ``train_step`` should reconcile with);
3. on the card, a profiled stretch under the tracer with host stamps only,
   whose idle gaps are named by the innermost open span, the program's or
   the benchmark's (``benchmark.spans.profiled``).

The last line of standard output is one JSON object: ``metrics`` (below,
from window 2), ``reconcile``, ``tracer_rate`` (window 2's samples a
second over window 1's), ``counters`` and, on the card, ``idle_gaps``
and ``busy_share``.

- ``fwd_host_ms``, ``fwd_device_ms``, ``bwd_*``, ``opt_*``: the median
  over microbatches of ``train_step.forward``'s, ``.backward``'s and
  ``.optimizer``'s host time and time on the compute stream;
- ``feed_host_ms``: the median of a microbatch's feed on the host
  (``feed.expand``, ``feed.upload`` and ``feed.gather``, outermost only,
  so the gather's rows upload counts once);
- ``host_syncs``: ``upload_blocked + sync_reported + device_free +
  alloc_retries`` over the window's microbatches.

Each reader gives None where the export has nothing to read.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import statistics
import sys
from collections import defaultdict
from typing import Dict, Optional

PHASES = {"fwd": "train_step.forward", "bwd": "train_step.backward",
          "opt": "train_step.optimizer"}
STEP = "train_step"
FEED = ("feed.expand", "feed.upload", "feed.gather")
HOST_SYNCS = ("upload_blocked", "sync_reported", "device_free",
              "alloc_retries")
PROFILED_S = 3.0  # the longest profiled stretch, as a traced run's


def per_micro(export: dict, names, key: str,
              outermost: bool = False) -> Dict[int, float]:
    """``{microbatch: the sum of key over the spans named in names}``;
    ``outermost`` leaves out a span whose parent is also named."""
    spans = export.get("spans", [])
    out: Dict[int, float] = defaultdict(float)
    for s in spans:
        if s["name"] not in names or s.get(key) is None:
            continue
        p = s["parent"]
        if outermost and p is not None and spans[p]["name"] in names:
            continue
        out[s["micro"]] += s[key]
    return dict(out)


def _median(d: dict) -> Optional[float]:
    return statistics.median(d.values()) if d else None


def metrics(export: Optional[dict]) -> dict:
    """The eight per-phase numbers of an export (None where it has
    nothing to read)."""
    export = export or {}
    out = {}
    for short, name in PHASES.items():
        out[f"{short}_host_ms"] = _median(per_micro(export, (name,),
                                                    "host_ms"))
        out[f"{short}_device_ms"] = _median(per_micro(export, (name,),
                                                      "device_ms"))
    out["feed_host_ms"] = _median(per_micro(export, FEED, "host_ms",
                                            outermost=True))
    steps = per_micro(export, (STEP,), "host_ms")
    out["host_syncs"] = (sum(c["value"] for c in export.get("counters", [])
                             if c["name"] in HOST_SYNCS
                             and c["micro"] in steps)
                         if steps else None)
    return out


def reconcile(export: dict, sp) -> dict:
    """``train_step``'s medians beside the benchmark's spans of the same
    calls, and the worst gap a microbatch between ``train_step`` and its
    three phases plus its self time (ms)."""
    out = {}
    for side in ("host", "device"):
        step = per_micro(export, (STEP,), f"{side}_ms")
        own = per_micro(export, (STEP,), f"{side}_self_ms")
        parts = [per_micro(export, (n,), f"{side}_ms")
                 for n in PHASES.values()]
        out[f"step_{side}_ms"] = _median(step)
        outside = getattr(sp, side).get("call", []) if sp else []
        out[f"call_{side}_ms"] = (statistics.median(outside) if outside
                                  else None)
        out[f"phases_gap_{side}_ms"] = max(
            (abs(v - own[m] - sum(p.get(m, 0.0) for p in parts))
             for m, v in step.items()), default=None)
    return out


def counter_totals(export: dict) -> dict:
    """Each counter's sum over the export and its median a microbatch."""
    per = defaultdict(lambda: defaultdict(int))
    for c in export.get("counters", []):
        per[c["name"]][c["micro"]] += c["value"]
    n = len(per_micro(export, (STEP,), "host_ms"))
    return {k: {"total": sum(v.values()),
                "median_a_microbatch": statistics.median(
                    [v.get(m, 0) for m in range(n)]) if n else None}
            for k, v in per.items()}


def measure(cell, seed: int, seconds: float, device="cuda") -> dict:
    """The three stretches of the module docstring on one set-up."""
    import torch

    from benchmark import spans
    from vqatpu_torch.train import profiling

    kind = importlib.import_module(
        f"benchmark.traffic.{cell.workload['kind']}")
    cuda = torch.device(device).type == "cuda"
    sess = kind.Session(cell, seed, device)
    gc.freeze()
    out = {}
    try:
        plain = sess.window(seconds)
        sp = spans.Spans(device)
        with profiling.tracing(device=True) as tr:
            traced = sess.window(seconds, sp=sp)
        sp.finish()
        export = tr.export()
        rate = [w["samples"] / w["seconds"] for w in (plain, traced)]
        out.update(metrics=metrics(export), reconcile=reconcile(export, sp),
                   counters=counter_totals(export),
                   samples_per_s=rate, tracer_rate=rate[1] / rate[0],
                   microbatches=traced["steps"])
        if cuda:
            def stretch(marks):
                with profiling.tracing(device=False) as tr:
                    done = sess.window(min(PROFILED_S, seconds / 4),
                                       marks=marks)
                marks.spans.extend((s["name"], s["start_ns"], s["end_ns"])
                                   for s in tr.export()["spans"])
                return done
            done, prof = spans.profiled(stretch)
            if prof:
                out.update(idle_gaps=prof["idle_gaps"],
                           busy_share=prof["busy_s"] / prof["window_s"],
                           profiled_samples_per_s=(done["samples"]
                                                   / done["seconds"]))
    finally:
        gc.unfreeze()
        sess.close()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    import torch

    from benchmark import core

    cell = core.Cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = measure(cell, args.seed, args.seconds)
    out.update(workload=cell.name, seed=args.seed,
               device=torch.cuda.get_device_name(0))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
