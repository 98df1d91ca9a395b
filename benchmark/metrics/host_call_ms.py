"""Host time inside one call into the program (the train step, or
``get_logits`` for one batch, its readback included), median over the
traced window."""

from benchmark.spans import median

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "entry and loop", "samples_per_s"


def read(rec):
    return median(rec.get("spans", {}).get("host", {}).get("call", []))
