"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``vqatpu_torch``.  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer
metrics (spans over a window of ``--seconds``, then a profiled stretch).
Every run checks the steps it drove against the plain reference and
prints each compared number beside its limit as the last lines of
standard error and under ``checks`` in the result.  It exits with another
code than 0, and prints no result, without a card (or with fewer cards
than the cell asks for), and if JAX or the JAX package was loaded."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import core

    cell = core.Cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    rec = core.run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    found = core.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    line = core.result_line(cell, rec)
    print(json.dumps({k: v for k, v in rec["readings"].items()
                      if k.startswith("_")}), file=sys.stderr)
    for name, c in rec["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
