"""Logger and meters, a copy of ``vqatpu.train.logging``
(``vqatpu/train/logging.py:10-151``; reference ``src/utils.py:172-198``,
``src/meters.py``): ``log.txt`` lines in the same format."""

from __future__ import annotations

import os
import time
from typing import Optional


class Logger:
    """Tee writes to ``{dirname}/log.txt`` and stdout (``utils.py:172-198``)."""

    def __init__(self, output_name: str):
        dirname = os.path.dirname(output_name)
        if dirname and not os.path.isdir(dirname):
            os.makedirs(dirname, exist_ok=True)
        self.log_file = open(output_name, "a")
        self.infos: dict = {}

    def append(self, key, val):
        self.infos.setdefault(key, []).append(val)

    def log(self, extra_msg: str = ""):
        msgs = [extra_msg]
        for key, vals in self.infos.items():
            msgs.append(f"{key} {sum(vals) / len(vals):.6f}")
        msg = "\n".join(msgs)
        self.log_file.write(msg + "\n")
        self.log_file.flush()
        self.infos = {}
        return msg

    def write(self, msg: str):
        self.log_file.write(str(msg) + "\n")
        self.log_file.flush()
        print(msg)

    def close(self):
        self.log_file.close()


def format_params_tree(params, indent: int = 0) -> str:
    """Human-readable param-tree summary (the reference's ``print_model``
    analogue, ``utils.py:89-95``): per-branch shapes and counts."""
    import numpy as np

    lines = []

    def walk(tree, name, depth):
        if isinstance(tree, dict):
            total = sum(int(np.prod(x.shape)) for x in _leaves(tree))
            lines.append("  " * depth + f"{name}: {total:,} params")
            for k in tree:
                walk(tree[k], k, depth + 1)
        else:
            lines.append("  " * depth + f"{name}: {tuple(tree.shape)}")

    def _leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from _leaves(v)
        else:
            yield tree

    for key in params:
        walk(params[key], key, indent)
    return "\n".join(lines)


class AverageMeter:
    """Average over a sliding window or full history (``meters.py:11-31``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self):
        return self.sum / self.count if self.count > 0 else 0.0


class TimeMeter:
    """Average events per second (``meters.py:34-49``)."""

    def __init__(self, init: float = 0.0):
        self.reset(init)

    def reset(self, init: float = 0.0):
        self.init = init
        self.start = time.time()
        self.n = 0

    def update(self, val: int = 1):
        self.n += val

    @property
    def avg(self):
        return self.n / self.elapsed_time if self.elapsed_time > 0 else 0.0

    @property
    def elapsed_time(self):
        return self.init + (time.time() - self.start)


class StopwatchMeter:
    """Accumulates durations between start/stop pairs (``meters.py:52-73``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.n = 0
        self.start_time: Optional[float] = None

    def start(self):
        self.start_time = time.time()

    def stop(self, n: int = 1):
        if self.start_time is not None:
            self.sum += time.time() - self.start_time
            self.n += n
            self.start_time = None

    @property
    def avg(self):
        return self.sum / self.n if self.n > 0 else 0.0


def time_since(start: float, percent: float) -> str:
    """ETA string (``utils.py:363-374``)."""

    def as_minutes(s):
        m = int(s // 60)
        return f"{m}m {int(s - m * 60)}s"

    now = time.time()
    s = now - start
    if percent <= 0:
        return f"{as_minutes(s)} (- ?)"
    es = s / percent
    return f"{as_minutes(s)} (- {as_minutes(es - s)})"
