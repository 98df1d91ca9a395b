"""Questions whose step (or logits) completed in the window, over the whole
window: it ends with a readback after the card has finished every step.
A Visual7W question is its four candidate rows."""

UNIT, BETTER, SOURCE = "samples/s", "higher", "host_clock"


def read(rec):
    w = rec["window"]
    return w["samples"] / w["seconds"]
