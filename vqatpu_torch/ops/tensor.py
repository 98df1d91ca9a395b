"""The PARALIND core's layout at the reference ``.pth`` boundary
(``vqatpu/ops/tensor.py:21-57``).

The reference's ``ModeProduct`` (``Tensor.py:6-9``) flattens the core's
non-contracted block in ``(z, y, g)`` order and splits it back as ``(g, z,
y)``: it computes with an element permutation of the stored ``T_g``.  The
port, as the JAX package, stores the core in the clean einsum layout, so
that ``ModeProduct(T, v, q, a) == einsum('xyzg,bvx,bqy,baz->bvqag',
paralind_core_unscramble(T), v, q, a)``; the permutation is applied only
when a ``.pth`` is read (:func:`paralind_core_unscramble`) or written
(:func:`paralind_core_scramble`).  Both take numpy arrays or torch tensors
``[..., x, y, z, g]``; leading axes (the rank) pass through; the identity
when ``g == 1``.
"""

from __future__ import annotations


def paralind_core_unscramble(core):
    """Reference layout -> clean layout."""
    *lead, x, y, z, g = core.shape
    t = core.swapaxes(-3, -2)  # (..., x, z, y, g)
    t = t.reshape(*lead, x, g, z, y)  # the reference's mismatched split
    return t.swapaxes(-1, -3)  # (..., x, y, z, g)


def paralind_core_scramble(core):
    """Clean layout -> reference layout: the inverse of
    :func:`paralind_core_unscramble`."""
    *lead, x, y, z, g = core.shape
    t = core.swapaxes(-1, -3)  # (..., x, g, z, y)
    t = t.reshape(*lead, x, z, y, g)  # flattened in the reference's order
    return t.swapaxes(-3, -2)  # (..., x, y, z, g)
