"""
Single-pixel elimination on the JAX device.

Replaces the reference's per-pixel scalar scan
(reference: pyshepseg/shepseg.py:572-736) with whole-image masked
neighbour-shift sweeps. The reference semantics are preserved exactly:

- a pass first *finds* all merges against a frozen snapshot of segSize,
  then applies them (mergeSinglePixels is find-all-then-apply, so one pass
  is embarrassingly parallel);
- a single pixel merges into the spectrally-nearest neighbouring *pixel*
  whose segment has size > 1, scanning the 3x3 window in row-major order
  and keeping the first strict minimum — reproduced here by stacking
  neighbour distances in the same scan order and taking the first argmin;
- passes repeat until no pixel is eliminated (a failed pixel can succeed
  later once a neighbouring singleton has grown).

Documented deviation: spectral distances are computed in float32 on device
(the reference's numba code uses int64/float64); argmin choices can differ
only when two neighbours are within float32 rounding of each other.
"""

import jax
import jax.numpy as jnp
import numpy as np

from .constants import SegIdType, MINSEGID
from .shifts import shift, offsets_for
from .segreduce import seg_sizes, relabel_subtract, band_planes


def _one_pass(d2s, offsets, seg, single, nbr_ok):
    """One find-all-then-apply merge pass. Returns
    (seg', single', nbr_ok', nElim).

    Instead of re-gathering segment sizes every pass (a 1M-pixel gather
    plus two scatter-adds), the pass carries two boolean masks that evolve
    in closed form — an exact restatement of the reference's size rules:

    - ``single`` (my segment has exactly 1 pixel): sizes never shrink and
      singletons are never merge *targets* (targets need size > 1,
      reference shepseg.py:726), so a pixel stays single until the moment
      it is itself eliminated: ``single' = single & ~elim``.
    - ``nbr_ok`` (my segment has size > 1, i.e. I am an eligible target):
      sizes only grow, and an eliminated pixel joins a size>1 segment,
      so ``nbr_ok' = nbr_ok | elim``.

    ``d2s`` are the per-offset spectral distance fields (pixel values
    never change, so the caller may hoist them out of the fixpoint loop
    — done for 4-connectivity; recomputed per pass for 8-connectivity
    to cap HBM residency). The neighbour choice is a RUNNING strict-<
    minimum (keeping the FIRST minimum in the reference's 3x3 scan
    order) over a few (H, W) buffers.
    """
    inf = jnp.float32(jnp.inf)

    best_d = jnp.full(seg.shape, inf)
    new_seg = jnp.zeros_like(seg)
    for (dy, dx), d2 in zip(offsets, d2s):
        nbr_seg = shift(seg, dy, dx, 0)
        # False fill keeps out-of-image neighbours ineligible.
        ok = shift(nbr_ok, dy, dx, False)
        d2m = jnp.where(ok, d2, inf)
        better = d2m < best_d        # strict <: first minimum wins
        best_d = jnp.where(better, d2m, best_d)
        new_seg = jnp.where(better, nbr_seg, new_seg)

    elim = single & jnp.isfinite(best_d)
    seg_out = jnp.where(elim, new_seg, seg)
    single_out = single & ~elim
    nbr_ok_out = nbr_ok | elim
    n = jnp.sum(elim.astype(jnp.uint32))
    return seg_out, single_out, nbr_ok_out, n


def _distance_fields(planes, offsets):
    """Per-offset squared spectral distance to the shifted neighbour.

    These depend only on pixel values, never on the evolving labels, so
    callers MAY reuse them across fixpoint passes (done for
    4-connectivity; 8-connectivity recomputes per pass — 8 persistent
    full-image buffers would strain HBM on large grown edge tiles).
    Built from 2D (H, W) planes, NOT a (nBands, H, W) array: with the
    3D form XLA's layout assignment can materialise a copy with the
    nBands dim as the padded lane dimension (4 -> 128 lanes = 32x
    memory), which OOM'd large grown edge tiles.
    """
    d2s = []
    for dy, dx in offsets:
        d2 = jnp.zeros(planes[0].shape, jnp.float32)
        for plane in planes:
            diff = plane - shift(plane, dy, dx, 0.0)
            d2 = d2 + diff * diff
        d2s.append(d2)
    return d2s


def _singleton_masks_from_image(seg, four_connected: bool):
    """
    The initial ``single`` (my segment has exactly 1 pixel) and ``nbr_ok``
    (my segment has size > 1) masks derived WITHOUT a segment-size
    histogram or a full-image gather, purely from neighbour shifts:
    a pixel of a labelled CONNECTED component has component size > 1 iff
    some connectivity neighbour carries the same label. Valid only when
    every non-null label is one connected component under the same
    connectivity (true for clump output — the fused pipelines' case).

    The null "segment" (label 0) is NOT a connected component — its size
    is the global null-pixel count, handled via one cheap reduction so
    the reference's quirk semantics hold exactly (a size>1 null segment
    IS an eligible merge target, and a lone null pixel IS a singleton —
    reference shepseg.py:726 checks segSize without a null test).
    """
    pad = jnp.uint32(0xFFFFFFFF)   # matches no real label
    has_same = None
    for dy, dx in offsets_for(four_connected):
        same = shift(seg, dy, dx, pad) == seg
        has_same = same if has_same is None else (has_same | same)
    is_null = seg == jnp.uint32(0)
    null_count = jnp.sum(is_null.astype(jnp.uint32))
    single = jnp.where(is_null, null_count == 1, ~has_same)
    nbr_ok = jnp.where(is_null, null_count > 1, has_same)
    return single, nbr_ok


def eliminate_single_pixels_device(img_f, seg, seg_size,
                                   four_connected: bool,
                                   return_sizes: bool = False,
                                   do_relabel: bool = True,
                                   capacity: int = None):
    """
    Device: run merge passes to fixpoint, then relabel to contiguous IDs
    (the reference's eliminateSinglePixels driver, shepseg.py:572-615).
    ``img_f`` may be a (nBands, H, W) array or a tuple of (H, W) planes
    (preferred for large tiles — see _distance_fields).

    Returns (relabelled seg, total number of pixels eliminated); with
    ``return_sizes=True`` additionally returns the relabelled segment
    sizes, letting fused callers skip a full-image histogram.

    ``do_relabel=False`` skips the contiguous relabel (one full-image
    gather), returning gappy IDs and their sizes. Callers that feed the
    result straight into small-segment elimination can do this safely:
    contiguous relabelling is a *monotone* ID remap, small-segment
    elimination only consults IDs for smallest-ID tie-breaks (order
    preserved under monotone maps), empty segments are never candidates
    nor targets, and its own final relabel composes to the identical
    contiguous result.

    ``seg_size=None`` (fused pipelines): derive the initial masks from
    neighbour shifts instead of a size histogram + full-image gather —
    sound when ``seg`` is clump output (every label one connected
    component; see _singleton_masks_from_image). ``capacity`` must then
    be given when sizes are needed for the relabel/return.
    """
    planes = band_planes(img_f)
    offsets = offsets_for(four_connected)
    # Hoist the per-offset distance fields out of the fixpoint loop when
    # the extra residency is modest (4-connected: 4 extra (H, W) f32
    # buffers). For 8-connected the 8 persistent buffers would re-tighten
    # HBM headroom on large grown edge tiles (the band-planes refactor
    # exists to protect exactly that), so recompute them per pass there.
    if four_connected:
        d2s = _distance_fields(planes, offsets)
    else:
        d2s = None

    if seg_size is None:
        single0, nbr_ok0 = _singleton_masks_from_image(seg, four_connected)
    else:
        capacity = seg_size.shape[0]
        sizes_at = seg_size[seg.astype(jnp.int32)]  # full-size gather
        single0 = sizes_at == 1
        nbr_ok0 = sizes_at > 1

    def cond(carry):
        return carry[4] > 0

    def body(carry):
        seg_c, single_c, nbr_ok_c, total, _ = carry
        d2s_pass = (d2s if d2s is not None
                    else _distance_fields(planes, offsets))
        seg_n, single_n, nbr_ok_n, n = _one_pass(
            d2s_pass, offsets, seg_c, single_c, nbr_ok_c)
        return seg_n, single_n, nbr_ok_n, total + n, n

    seg, _, _, total, _ = jax.lax.while_loop(
        cond, body, (seg, single0, nbr_ok0, jnp.uint32(0), jnp.uint32(1)))

    if not (do_relabel or return_sizes):
        return seg, total
    seg_size = seg_sizes(seg, capacity)
    if do_relabel:
        sub = relabel_subtract(seg_size, MINSEGID)
        seg = (seg - sub[seg.astype(jnp.int32)]).astype(jnp.uint32)
        if return_sizes:
            # Relabelled sizes by a capacity-sized scatter (IDs only move
            # down, never collide: new id = id - sub[id] is injective on
            # non-empty ids).
            ids = jnp.arange(capacity, dtype=jnp.uint32)
            new_ids = jnp.where(seg_size > 0, ids - sub,
                                jnp.uint32(capacity))
            seg_size = jnp.zeros(capacity + 1, seg_size.dtype).at[
                new_ids.astype(jnp.int32)].set(
                    seg_size, mode="drop")[:capacity]
    if return_sizes:
        return seg, total, seg_size
    return seg, total


_elim_single_jit = jax.jit(
    eliminate_single_pixels_device,
    static_argnames=("four_connected", "return_sizes", "do_relabel",
                     "capacity"))


def eliminateSinglePixels(img, seg, segSize, minSegId=MINSEGID,
                          maxSegId=None, fourConnected=True):
    """
    Host API matching the reference signature (reference: shepseg.py:572).
    Modifies ``seg`` (numpy) in place; ``segSize`` becomes stale, as in the
    reference. ``minSegId`` sets the base of the final relabel as in the
    reference's relabelSegments; ``maxSegId`` only sized a scratch buffer
    there and is unused here. Returns the number of pixels eliminated.
    """
    seg_j = jnp.asarray(seg)
    img_f = jnp.asarray(np.ascontiguousarray(img)).astype(jnp.float32)
    size_j = jnp.asarray(np.asarray(segSize, dtype=np.uint32))
    if int(minSegId) == MINSEGID:
        seg_out, total = _elim_single_jit(
            img_f, seg_j, size_j, four_connected=bool(fourConnected))
    else:
        # relabel outside the fused program so the caller's minSegId
        # reaches it (the device path bakes in MINSEGID)
        seg_out, total, sizes = _elim_single_jit(
            img_f, seg_j, size_j, four_connected=bool(fourConnected),
            do_relabel=False, return_sizes=True)
        sub = relabel_subtract(sizes, int(minSegId))
        seg_out = (seg_out - jnp.asarray(sub)[seg_out.astype(jnp.int32)])
    seg[...] = np.asarray(seg_out).astype(SegIdType)
    return int(total)
