"""Device time of a batch's feed between CUDA events on the compute stream:
the fields' upload (its wait on the copy stream) and the store's gather
in training; the gather alone in the logits sweep, whose fields go up
inside the forward call.  Median over the traced window."""

from benchmark.spans import median

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "store and uploads", "samples_per_s"


def read(rec):
    return median(rec.get("spans", {}).get("device", {}).get("gather", []))
