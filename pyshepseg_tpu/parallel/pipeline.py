"""
Fully-fused on-device segmentation pipeline.

The host-orchestrated path (pyshepseg_tpu.shepseg.doShepherdSegmentation)
syncs between stages so it can bucket per-segment array capacities from the
observed clump count. This module instead compiles the ENTIRE per-tile
pipeline — cluster assignment -> connected-component clumping ->
single-pixel elimination -> small-segment elimination -> relabel — into one
XLA program with a static segment capacity, eliminating every host
round-trip. This is the unit of work the CONC_MESH backend runs on each
card of a device mesh, and what __graft_entry__ exposes for compile checks.

Mirrors reference behaviour end to end
(reference: pyshepseg/shepseg.py:130-249).
"""

import functools

import jax
import jax.numpy as jnp

from ..ops.constants import SEGNULLVAL
from ..ops.kmeans import assign_clusters  # noqa: F401  (re-export)
from ..ops.clump import clump_labels
from ..ops.segreduce import seg_spectral_sums_planes, band_planes
from ..ops.elim_single import eliminate_single_pixels_device
from ..ops.elim_small import eliminate_small_segments_device, round_capacity


def segment_tile(img_f, centers, img_null_val, max_spectral_diff,
                 min_seg_size: int, four_connected: bool, has_null: bool,
                 capacity: int):
    """
    Device: the full Shepherd pipeline on one tile, one XLA program.

    Parameters (static: min_seg_size, four_connected, has_null, capacity)
    ----------
    img_f : (nBands, H, W), any numeric dtype (null comparison runs in
        this dtype; spectral arithmetic casts to float32)
    centers : (K, nBands) float32 fitted cluster centres
    img_null_val : float32 scalar (ignored when has_null is False)
    max_spectral_diff : float32 scalar (resolve 'auto' on host via
        shepseg.autoMaxSpectralDiff before calling)
    capacity : static upper bound on segment count + 1 (use
        round_capacity(H*W+1) when unsure)

    Returns (seg uint32 (H, W), maxSegId uint32).
    """
    nbands, h, w = img_f.shape
    clusters = assign_clusters(img_f, centers, img_null_val, has_null)
    seg, _, _ = clump_labels(clusters.astype(jnp.int32), SEGNULLVAL,
                             four_connected=four_connected)
    # per-band planes: avoids band-minor layout copies on large tiles
    planes = band_planes(img_f.astype(jnp.float32))
    seg, _, size = eliminate_single_pixels_device(
        planes, seg, None, four_connected, return_sizes=True,
        capacity=capacity)
    spect = seg_spectral_sums_planes(seg, planes, capacity)
    # e_cap at the hard bound on unique adjacencies (one per adjacent
    # pixel pair: 2*H*W for 4-conn, 4*H*W for 8-conn) can NEVER overflow,
    # regardless of the caller-supplied segment capacity — so discarding
    # the overflow flag here is sound
    pairs_bound = (2 if four_connected else 4) * h * w
    seg, _, _ = eliminate_small_segments_device(
        seg, size, spect, min_seg_size, max_spectral_diff, four_connected,
        e_cap=round_capacity(pairs_bound + 1))
    return seg, jnp.max(seg)


segment_tile_jit = jax.jit(
    segment_tile,
    static_argnames=("min_seg_size", "four_connected", "has_null",
                     "capacity"))


def default_capacity(h: int, w: int) -> int:
    """Safe static capacity for a tile of the given shape."""
    return round_capacity(h * w + 1)


@functools.partial(
    jax.jit,
    static_argnames=("min_seg_size", "four_connected", "has_null",
                     "capacity"))
def segment_tiles_vmapped(imgs_f, centers, img_null_val, max_spectral_diff,
                          min_seg_size: int, four_connected: bool,
                          has_null: bool, capacity: int):
    """
    Device: a batch of tiles (B, nBands, H, W) through the full pipeline
    with vmap — used per device inside the mesh backend (the while-loops
    run lock-step until every tile in the batch converges).

    Returns (segs uint32 (B, H, W), maxSegIds uint32 (B,)).
    """

    def one(img_f):
        return segment_tile(img_f, centers, img_null_val,
                            max_spectral_diff, min_seg_size,
                            four_connected, has_null, capacity)

    return jax.vmap(one)(imgs_f)


# --------------------------------------------------------------------
# Three-phase batched pipeline: the CONC_MESH hot path.
#
# segment_tiles_vmapped above is fully fused but must assume the worst-
# case segment capacity (H*W), which pads every per-segment array ~500x
# beyond real segment counts. Mirroring the host-orchestrated path
# (shepseg.doShepherdSegmentation), these three dispatches sandwich two
# batch-wide scalar syncs that bucket the segment capacity (from the max
# clump count) and the edge capacity (from the max unique-adjacency
# count) — shrinking every elimination pass to the data's actual size.
# Results are bit-identical; capacity only pads.
# --------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("four_connected", "has_null"))
def cluster_clump_tiles(imgs, centers, img_null_val,
                        four_connected: bool, has_null: bool):
    """
    Batched dispatch #1: cluster assignment + clumping for a batch of
    tiles (B, nBands, H, W). Returns (segs uint32 (B, H, W),
    clump counts (B,) uint32, sweep counts (B,) int32).
    """

    def one(img):
        clusters = assign_clusters(img, centers, img_null_val, has_null)
        return clump_labels(clusters.astype(jnp.int32), SEGNULLVAL,
                            four_connected=four_connected)

    return jax.vmap(one)(imgs)


@functools.partial(
    jax.jit, static_argnames=("four_connected", "has_null"))
def cluster_clump_edges_tiles(imgs, centers, img_null_val,
                              four_connected: bool, has_null: bool):
    """
    Batched dispatch #1 for the fused flow: clustering + clumping + the
    sorted clump-adjacency edge keys, whose measured unique counts size
    the fused dispatch's edge bucket (contraction bound — see
    shepseg._cluster_and_clump_device). Returns (segs, a, b, first,
    scalars (B, 5) = [clumpCount, nUniqueEdges, nBoundaryPairs,
    nRowMax, nRunsRowMax]).
    """
    from ..ops.elim_small import edge_sort_keys, boundary_row_stats
    from ..shepseg import _run_ends

    def one(img):
        clusters = assign_clusters(img, centers, img_null_val, has_null)
        seg, count, _ = clump_labels(clusters.astype(jnp.int32),
                                     SEGNULLVAL,
                                     four_connected=four_connected)
        a, b, first, n_unique = edge_sort_keys(seg, four_connected)
        n_pairs, row_max = boundary_row_stats(seg, four_connected)
        # clump-image horizontal-run row max: bounds the post-single-
        # elim run count, sizing the rl_cap bucket (see
        # shepseg._cluster_and_clump_device)
        runs_max = jnp.max(jnp.sum(_run_ends(seg).astype(jnp.uint32),
                                   axis=1))
        return seg, a, b, first, jnp.stack(
            [count, n_unique.astype(jnp.uint32), n_pairs, row_max,
             runs_max])

    return jax.vmap(one)(imgs)


@functools.partial(
    jax.jit, static_argnames=("four_connected", "capacity"))
def eliminate_tiles_phase1(imgs, segs, four_connected: bool,
                           capacity: int):
    """
    Batched dispatch #2: single-pixel elimination + per-segment
    sizes/spectral sums + sorted adjacency edge keys, per tile.
    Returns (segs, sizes (B, cap), spects (B, cap, nB), a, b, first,
    scalars (B, 2) = [nSegsAfterSingle, nUniqueEdges]).
    """

    def one(img, seg):
        planes = band_planes(img.astype(jnp.float32))
        from ..ops.elim_small import edge_sort_keys
        from ..ops.constants import MINSEGID
        from ..ops.segreduce import seg_sizes_and_spectral_sums_planes
        seg, _ = eliminate_single_pixels_device(
            planes, seg, None, four_connected, do_relabel=False)
        size, spect = seg_sizes_and_spectral_sums_planes(
            seg, planes, capacity)
        n_after = jnp.count_nonzero(size[MINSEGID:]).astype(jnp.uint32)
        a, b, first, n_unique = edge_sort_keys(seg, four_connected)
        return (seg, size, spect, a, b, first,
                jnp.stack([n_after, n_unique.astype(jnp.uint32)]))

    return jax.vmap(one)(imgs, segs)


@functools.partial(
    jax.jit, static_argnames=("min_seg_size", "four_connected",
                              "capacity", "e_cap", "rl_cap"))
def eliminate_tiles_fused(imgs, segs, a, b, first, max_spectral_diff,
                          min_seg_size: int, four_connected: bool,
                          capacity: int, e_cap: int, rl_cap: int = 0):
    """
    Batched FUSED dispatch #2: everything after clumping in one program
    per tile batch, running the graph loop on the clump-image edges from
    cluster_clump_edges_tiles seeded with the singleton-merge remap (no
    second whole-image sort, no second sync — see
    shepseg._elim_fused_device). Returns (segs uint32 (B, H, W),
    scalars (B, 3) = [maxSegId, elimPasses, edgeOverflow]); any overflow
    flag set => re-run that batch through the measured-capacity
    phase1/phase2 pair.
    """
    from ..ops.elim_small import (compact_edges,
                                  eliminate_small_segments_graph,
                                  _remap_and_relabel)

    def one(img, seg, aa, bb, ff):
        from ..ops.segreduce import (seg_sizes_and_spectral_sums_planes,
                                     seg_reduce_and_remap_runlength)
        planes = band_planes(img.astype(jnp.float32))
        seg_clump = seg
        seg, _ = eliminate_single_pixels_device(
            planes, seg, None, four_connected, do_relabel=False)
        if rl_cap:
            # caller sized rl_cap from the clump-image run count (no
            # overflow flag needed); the run compaction also yields the
            # clump->post remap (shepseg._elim_fused_device)
            size, spect, remap0, _ = seg_reduce_and_remap_runlength(
                seg_clump, seg, planes, capacity, rl_cap)
        else:
            size, spect = seg_sizes_and_spectral_sums_planes(
                seg, planes, capacity)
            remap0 = jnp.arange(capacity, dtype=jnp.uint32).at[
                seg_clump.ravel().astype(jnp.int32)].set(seg.ravel())
        n_unique = jnp.sum(ff.astype(jnp.uint32))
        overflow = (n_unique > jnp.uint32(e_cap)).astype(jnp.uint32)
        ea, eb = compact_edges(aa, bb, ff, e_cap, id_bound=capacity)
        remap, size_out, _, passes = eliminate_small_segments_graph(
            ea, eb, size, spect, min_seg_size, max_spectral_diff,
            remap_init=remap0)
        seg = _remap_and_relabel(seg, remap, size_out)
        return seg, jnp.stack([jnp.max(seg),
                               passes.astype(jnp.uint32), overflow])

    return jax.vmap(one)(imgs, segs, a, b, first)


@functools.partial(
    jax.jit,
    static_argnames=("min_seg_size", "four_connected", "has_null",
                     "capacity", "e_cap", "b_cap", "r_cap", "rl_cap"))
def segment_tiles_one_shot(imgs, centers, img_null_val,
                           max_spectral_diff, min_seg_size: int,
                           four_connected: bool, has_null: bool,
                           capacity: int, e_cap: int, b_cap: int,
                           r_cap: int, rl_cap: int = 0):
    """
    Batched SPECULATIVE one-shot pipeline: the whole per-tile flow
    (cluster -> clump -> edges -> eliminations -> relabel) vmapped over
    a tile batch in ONE program with static capacity buckets learned
    from an earlier batch of the same scene — no per-batch host sync at
    all (the mesh backend's steady state). Returns (segs — uint16 when
    capacity allows, scalars (B, 11) as
    shepseg._segment_one_shot_device; any overflow flag set => discard
    and re-run the measured flow).
    """
    from ..shepseg import _segment_one_shot_device

    def one(img):
        return _segment_one_shot_device(
            img, centers, img_null_val, max_spectral_diff,
            has_null=has_null, four_connected=four_connected,
            min_seg_size=min_seg_size, capacity=capacity, e_cap=e_cap,
            b_cap=b_cap, r_cap=r_cap, rl_cap=rl_cap)

    return jax.vmap(one)(imgs)


@functools.partial(
    jax.jit, static_argnames=("min_seg_size", "e_cap"))
def eliminate_tiles_phase2(segs, sizes, spects, a, b, first,
                           max_spectral_diff, min_seg_size: int,
                           e_cap: int):
    """
    Batched dispatch #3 (static e_cap bucketed from the measured max
    unique-edge count): small-segment elimination + final relabel.
    Returns (segs uint32 (B, H, W), maxSegIds (B,) uint32).
    """
    from ..ops.elim_small import (compact_edges,
                                  eliminate_small_segments_graph,
                                  _remap_and_relabel)

    def one(seg, size, spect, aa, bb, ff):
        ea, eb = compact_edges(aa, bb, ff, e_cap, id_bound=size.shape[0])
        remap, size_out, _, _ = eliminate_small_segments_graph(
            ea, eb, size, spect, min_seg_size, max_spectral_diff)
        seg = _remap_and_relabel(seg, remap, size_out)
        return seg, jnp.max(seg)

    return jax.vmap(one)(segs, sizes, spects, a, b, first)
