"""A roofline share of named kernels from a profiled stretch: the sum over
their launches of the least time each could take, over the sum of the
device time their kernels took.  The program's kernels are known by the
names of their CUDA functions; a launch of K2's backward runs two (its
products, then the sum of ``gw``'s partials), both counted in its time and
the first counted as the launch."""

from __future__ import annotations

import re
from typing import Optional, Sequence

from benchmark import counts

# name -> (every kernel of a launch, the kernel that counts the launch)
KERNELS = {
    "k1": (r"\brank_softmax(_mma)?_kernel\b", r"\brank_softmax(_mma)?_kernel\b"),
    "k2": (r"\btri_pool(_mma)?_kernel\b", r"\btri_pool(_mma)?_kernel\b"),
    "k2_backward": (r"\btri_pool_backward_\w*kernel\b",
                    r"\btri_pool_backward_mma_kernel\b"),
    "softmax_backward": (r"\bsoftmax_backward_kernel\b",
                         r"\bsoftmax_backward_kernel\b"),
}


def cost(kernel: str, s: dict):
    B, V, Q, A, G, R, X, D = (s[k] for k in "BVQAGRXD")
    return {"k1": lambda: counts.k1(B, V, R, X, Q, A, G),
            "k2": lambda: counts.k2(B, V, Q, A, D),
            "k2_backward": lambda: counts.k2_backward(B, V, Q, A, D),
            "softmax_backward": lambda: counts.softmax_backward(B, V, Q, A, G),
            }[kernel]()


def share(rec: dict, kernels: Sequence[str]) -> Optional[float]:
    """Percent; None where the stretch has no launch of these kernels."""
    p = rec.get("profile")
    peak = counts.peaks_for(rec.get("device_name", ""))
    if not p or peak is None:
        return None
    bound = spent = 0.0
    for k in kernels:
        every, first = (re.compile(x) for x in KERNELS[k])
        n = sum(1 for name, _ in p["kernels"] if first.search(name))
        bound += n * counts.bound_s(cost(k, rec["shape"]), peak)
        spent += sum(t for name, t in p["kernels"] if every.search(name))
    return 100.0 * bound / spent if spent > 0 else None
