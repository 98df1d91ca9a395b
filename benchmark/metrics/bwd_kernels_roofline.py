"""K2's backward and the softmax backward (the port's backward kernels;
K1's two gradient products are cuBLAS's) in the profiled stretch: the sum
of their least times over the sum of their device times."""

from benchmark import roofline

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "samples_per_s"
KERNELS = ("k2_backward", "softmax_backward")


def read(rec):
    return roofline.share(rec, KERNELS)
