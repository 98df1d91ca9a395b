"""Device time between CUDA events on the compute stream around each call
(the train step; the forward call of the logits sweep), the card's waits
for the host inside it included.  Median over the traced window."""

from benchmark.spans import median

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "train step and optimizer", "samples_per_s"


def read(rec):
    return median(rec.get("spans", {}).get("device", {}).get("call", []))
