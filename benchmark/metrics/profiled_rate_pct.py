"""The profiled stretch's samples a second as a share of the untraced
window's: how far the profiler slowed the steps whose ``idle_pct``,
``fwd_kernels_roofline`` and ``bwd_kernels_roofline`` it reads.  Under
100%, the host's extra work under the tracer left the card idle for
longer than it is without it."""

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER, MOVES = "device", "samples_per_s"


def read(rec):
    p, w = rec.get("profiled"), rec["window"]
    if not rec.get("profile") or not p or not p["seconds"]:
        return None
    return 100.0 * (p["samples"] / p["seconds"]) / (w["samples"] / w["seconds"])
