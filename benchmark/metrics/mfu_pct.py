"""The model's operations of the work completed in the traced run's
unprofiled stretch (the benchmark's own count at the cell's shapes,
whatever computes them) over what the card's peak gives in that time:
the float32 CUDA cores' (TF32 is off), or bf16's at bf16 compute."""

from benchmark.counts import peaks_for

UNIT, BETTER, SOURCE = "%", "higher", "program_counter"
LAYER, MOVES = "model", "samples_per_s"


def read(rec):
    peak = peaks_for(rec.get("device_name", ""))
    if peak is None or not rec.get("trace"):
        return None
    w = rec["window"]
    rate = peak[2] if rec["compute_dtype"] == "bfloat16" else peak[1]
    return 100.0 * rec["flop_per_sample"] * w["samples"] / (w["seconds"] * rate)
