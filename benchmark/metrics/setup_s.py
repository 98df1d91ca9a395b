"""From the process's start to the window's: imports, the kernels' build
or load, the weights and the store made on the card, the check's steps
and the warm-up."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(rec):
    return rec["setup_s"]
