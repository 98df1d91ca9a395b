"""Device memory the timed path needs above what set-up left resident (the
store, the weights, the optimizer's state): the allocator's peak over the
window less what was allocated at its start."""

UNIT, BETTER, SOURCE = "GiB", "lower", "host_clock"


def read(rec):
    b = rec["window"].get("peak_work_bytes")
    return None if b is None else b / 2**30
