"""The yardstick's arithmetic: the card's published peaks, and the bytes
and operations of each of the program's kernels at given shapes.

A kernel's bytes count each input read once and each output written once
in its dtype; its operations are 2 per multiply-add of its products.  The
least time the card could take is the larger of bytes over the memory's
peak and operations over the float32 CUDA cores' peak (TF32 is off).
These are the counts behind the kernel table of ``PERF.md``: K1 at B=128
33.8 MB and 0.472 GFLOP, K2 35.5 MB and 0.482 GFLOP, K2's backward at
B=256 141.0 MB and 2.831 GFLOP."""

from __future__ import annotations

from typing import Optional, Tuple

F32 = 4

# NVIDIA's data sheet (dense): HBM bytes/s, float32 CUDA-core FLOP/s,
# bf16 tensor-core FLOP/s; a key found in the card's name gives its peaks
PEAKS = {"H100 80GB HBM3": (3.35e12, 67e12, 989e12)}


def peaks_for(name: str) -> Optional[Tuple[float, float, float]]:
    for key, peak in PEAKS.items():
        if key in name:
            return peak
    return None


def k1(B, V, R, X, Q, A, G, el=F32) -> Tuple[int, int]:
    """K1, the rank contraction fused with the masked softmax: reads
    ``v_r`` [B,V,R,X], ``tqa`` [B,Q,A,R,X,G] and the mask, writes ``att``
    [B,V,Q,A,G] float32."""
    return (el * (B * V * R * X + B * Q * A * R * X * G)
            + F32 * B * V * Q * A * G + B * V,
            2 * B * G * V * R * X * Q * A)


def k2(B, V, Q, A, D, el=F32) -> Tuple[int, int]:
    """K2, the weighted trilinear pool: reads ``vt`` [B,V,D], ``qt``
    [B,Q,D], ``at`` [B,A,D] and one glimpse's weights [B,V,Q,A], writes
    [B,D]."""
    return (el * B * D * (V + Q + A) + F32 * (B * V * Q * A + B * D),
            2 * B * D * (V * Q * A + Q * A + A))


def k2_backward(B, V, Q, A, D, el=F32) -> Tuple[int, int]:
    """K2's backward: reads the cotangent [B,D] and K2's four inputs,
    writes their four cotangents; three V x QA x D products a sample."""
    return (F32 * B * D + 2 * (el * B * D * (V + Q + A) + F32 * B * V * Q * A),
            3 * 2 * B * V * Q * A * D)


def softmax_backward(B, V, Q, A, G) -> Tuple[int, int]:
    """The masked softmax's backward: reads ``att`` and the cotangent,
    writes the logits' cotangent, all [B,V,Q,A,G] float32."""
    n = B * V * Q * A * G
    return 3 * F32 * n, 4 * n


def bound_s(cost: Tuple[int, int], peak: Tuple[float, float, float]) -> float:
    """The least seconds a launch of ``cost`` = (bytes, FLOP) takes."""
    return max(cost[0] / peak[0], cost[1] / peak[1])
