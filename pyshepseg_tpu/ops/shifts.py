"""
Masked neighbour-shift utilities.

The reference accesses 3x3 neighbourhoods with scalar loops and explicit
edge clamping (reference: pyshepseg/shepseg.py:677-736, 1044-1058). Here
the same access pattern is expressed as whole-array shifts with constant
fill at the image border, which XLA lowers to cheap pad+slice ops that fuse
into the surrounding elementwise work.
"""

import jax.numpy as jnp

# Neighbour offsets in the reference's scan order (row-major over the 3x3
# window, centre excluded). Order matters for tie-breaking parity in
# single-pixel elimination (reference: shepseg.py:721-734 scans iii rows then
# jjj cols and keeps the first strict minimum).
OFFSETS_8 = (
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1), (0, 1),
    (1, -1), (1, 0), (1, 1),
)

# 4-connected subset, in the same scan order
OFFSETS_4 = ((-1, 0), (0, -1), (0, 1), (1, 0))


def offsets_for(four_connected: bool):
    """Neighbour offsets for the requested connectedness, in scan order."""
    return OFFSETS_4 if four_connected else OFFSETS_8


def shift(a, dy: int, dx: int, fill):
    """
    Return ``b`` with ``b[y, x] = a[y + dy, x + dx]`` where the source index
    is in bounds, and ``fill`` elsewhere — i.e. "the value of my neighbour at
    offset (dy, dx)". dy/dx are compile-time constants; implemented as
    pad + static slice so XLA fuses it into surrounding elementwise ops.

    Arrays with more than 2 dims are shifted along the first two axes
    (e.g. per-pixel spectral vectors of shape (H, W, nBands)).
    """
    if dy == 0 and dx == 0:
        return a
    h, w = a.shape[:2]
    pad = ([(max(-dy, 0), max(dy, 0)), (max(-dx, 0), max(dx, 0))] +
           [(0, 0)] * (a.ndim - 2))
    padded = jnp.pad(a, pad, mode="constant", constant_values=fill)
    y0 = max(-dy, 0) + dy
    x0 = max(-dx, 0) + dx
    return padded[y0:y0 + h, x0:x0 + w]
