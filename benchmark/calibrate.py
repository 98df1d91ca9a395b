"""The readings that a cell's limits (its workload file's ``limits``) are set
from, in one process on the card:

    python3 -m benchmark.calibrate --workload <cell> --seeds a,b,... \
        --control-seeds x,y,z [--seconds s]

- For each of ``--seeds``, a sound run of the program: its set-up and, for
  a sweep, a window of ``--seconds`` whose every batch is kept, then the
  comparison a benchmark run makes (the lower readings).
- For each of ``--control-seeds``, the plain reference put in the
  program's place: computed with TF32 (the nearest precision below the
  configuration's float32, the control), and with each fault the cell can
  have planted in it (training: half of each microbatch left out, the mean
  taken over the rest; one row's logits moved by 1 where they are made;
  the sweep: one row's logits moved by 1), each compared with the float32
  reference as the program is (the upper readings).

Each reading is printed as a JSON line with ``correct``, the verdict of
:func:`benchmark.compare.judge` under the cell's limits: true for the
program's runs, false for each control and fault.  The benchmark's runs
never run
this."""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from benchmark import compare, core


def _as_program(out: dict, change=None) -> dict:
    """A reference run's numbers in the form the program's are read in;
    ``change`` stands in for every leaf's change."""
    names = out["names"]
    return {"losses": out["losses"].numpy(),
            "grad": dict(zip(names, out["grad"].tolist())),
            "change": dict(zip(names, out["change"].tolist()) if change is None
                           else {n: change for n in names})}


def _bump_row0(x):
    """One row's logits moved by 1."""
    bump = torch.zeros_like(x)
    bump[0] = 1.0
    return x + bump


def _public(readings: dict) -> dict:
    return {k: v for k, v in readings.items() if not k.startswith("_")}


def _verdict(readings: dict, limits: dict) -> dict:
    return {"correct": compare.judge(readings, limits)[0], **readings}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    cell = core.Cell(args.workload)
    limits = cell.workload.get("limits", {})
    kind = importlib.import_module(
        f"benchmark.traffic.{cell.workload['kind']}")

    def session(seed):
        sess = kind.Session(cell, seed, "cuda")
        if not sess.train:
            sess.stride, sess.phase = 1, 0
            sess.window(args.seconds)
        sess.close()
        return sess

    for seed in (int(s) for s in args.seeds.split(",") if s):
        sess = session(seed)
        readings, failed = sess.check()
        print(json.dumps({"cell": cell.name, "seed": seed, "what": "program",
                          "failed": failed, **_verdict(readings, limits)}),
              flush=True)
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        sess = session(seed)
        if sess.train:
            ref = sess.reference()
            runs = {"control_tf32": sess.reference("tf32"),
                    "fault_half_batch": sess.reference(
                        rows_cut=sess.shape["B"] // 2),
                    "fault_row_altered": sess.reference(alter=_bump_row0)}
            unchanged = compare.train_readings(_as_program(ref, 0.0), ref,
                                               sess.uf)
            print(json.dumps({"cell": cell.name, "seed": seed,
                              "what": "fault_state_unchanged (change only)",
                              **_verdict({"change_gap":
                                          unchanged["change_gap"]}, limits)}),
                  flush=True)
            for what, out in runs.items():
                print(json.dumps({"cell": cell.name, "seed": seed, "what": what,
                                  **_verdict(_public(compare.train_readings(
                                      _as_program(out), ref, sess.uf)),
                                      limits)}),
                      flush=True)
        else:
            ref = sess.reference()
            ctl = sess.reference("tf32")
            bumped = [x.copy() for x in ref]
            bumped[0][0] += 1.0
            for what, out in (("control_tf32", ctl),
                              ("fault_row_altered", bumped)):
                r = compare.logit_readings(
                    out, ref, [q for _, _, q in sess.kept],
                    [a for a, _, _ in sess.kept])
                print(json.dumps({"cell": cell.name, "seed": seed,
                                  "what": what, **_verdict(r, limits)}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
