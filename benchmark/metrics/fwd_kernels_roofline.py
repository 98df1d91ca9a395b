"""K1's and K2's forward launches in the profiled stretch: the sum of
their least times (``benchmark.counts`` at the cell's shapes) over the
sum of their device times."""

from benchmark import roofline

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "samples_per_s"
KERNELS = ("k1", "k2")


def read(rec):
    return roofline.share(rec, KERNELS)
