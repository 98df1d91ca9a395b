"""Share of the profiled stretch in which no operation ran on the card:
one less the union of the trace's kernels, copies and sets over the
stretch's length."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "device", "samples_per_s"


def read(rec):
    p = rec.get("profile")
    if not p:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
