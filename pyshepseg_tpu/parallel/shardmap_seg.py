"""
Full Shepherd segmentation of ONE row-sharded image across a device mesh.

parallel/mesh.py (CONC_MESH) scales by giving whole tiles to chips;
parallel/shardmap_clump.py clumps a single oversized image across chips.
This module completes that axis: the ENTIRE pipeline — cluster assignment
-> connected-component clumping -> single-pixel elimination ->
small-segment elimination -> contiguous relabel — on an image whose rows
are sharded over the mesh, producing output bit-identical to the
single-chip pipeline (parallel/pipeline.segment_tile). It is the
answer to "the scene does not fit one card" that needs no
overlap/stitch reconciliation at all (the reference's halo heuristics,
tiling.py:1128-1306, exist only because its tiles are segmented
independently; here the mesh IS one segmentation).

Communication layout (all over NVLink; the mesh is 1-D over
jax.devices(), with no torus shape to follow):

- image-space stages exchange ONE halo row of labels/masks per sweep
  (``ppermute``), with global fixpoints by ``psum`` of change flags;
- per-segment state (sizes, spectral sums, the id remap) is
  capacity-sized and REPLICATED: each device contributes its stripe's
  scatter and a ``psum``/``pmax`` merges them. The float32 spectral
  sums are therefore grouped per-stripe before the psum — a different
  float32 summation order than the single-chip whole-image scatter.
  Both are exact (and hence identical) while every per-segment
  per-band sum stays within float32's exact-integer range (2^24); a
  segment whose band sum exceeds ~16.7e6 (e.g. >16k pixels of a
  full-range uint16 band) may differ from the single-chip result by
  ulps, which can flip a nearest-neighbour tie the same way the
  float32-vs-float64 deviation characterized in PARITY.md can;
- the small-segment elimination graph loop runs REDUNDANTLY on every
  device over the globally gathered edge list (segment-space arrays are
  tiny next to the image; recomputing beats communicating), so no
  collectives are needed inside the hot fixpoint loop at all.

Two dispatches around one packed scalar sync, mirroring the fused
single-chip flow (shepseg._elim_fused_device): dispatch #1 clusters,
clumps, and sorts each stripe's clump-adjacency edges; the sync buckets
the segment capacity (global clump count) and the per-stripe edge
capacity; dispatch #2 runs both eliminations and the relabel.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from ..ops.constants import SegIdType, SEGNULLVAL, MINSEGID
from ..ops.kmeans import assign_clusters, null_scalar
from ..ops.shifts import shift
from ..ops.segreduce import band_planes, relabel_subtract
from ..ops.elim_small import (round_capacity, round_capacity_fine,
                              compact_edges,
                              eliminate_small_segments_graph)
from .shardmap_clump import AXIS, _clump_sharded


def _exchange_rows(arr, fill, n_dev):
    """The halo rows of ``arr`` from the stripes above and below over
    NVLink: returns (top_row, bottom_row), with ``fill`` beyond the image's
    first/last stripe."""
    my = jax.lax.axis_index(AXIS)
    up = [(i, (i - 1) % n_dev) for i in range(n_dev)]    # send to i-1
    down = [(i, (i + 1) % n_dev) for i in range(n_dev)]  # send to i+1
    from_above = jax.lax.ppermute(arr[-1], AXIS, down)
    from_below = jax.lax.ppermute(arr[0], AXIS, up)
    top = jnp.where(my == 0, jnp.full_like(from_above, fill), from_above)
    bot = jnp.where(my == n_dev - 1,
                    jnp.full_like(from_below, fill), from_below)
    return top, bot


def _edge_sort_keys_stripe(seg, four_connected: bool, n_dev: int):
    """
    Per-stripe sorted canonical (lo, hi) clump-adjacency pairs, including
    the pairs that cross into the stripe BELOW via one ppermute'd halo
    row (each cross-boundary pair is owned by the upper stripe, so the
    union over stripes covers every adjacency exactly as
    ops/elim_small.edge_sort_keys does for a whole image). Returns
    (a, b, first, n_unique_local).
    """
    _, bot = _exchange_rows(seg, SEGNULLVAL, n_dev)
    ext = jnp.concatenate([seg, bot[None]], axis=0)   # (s+1, W)
    s = seg.shape[0]
    offsets = [(0, 1), (1, 0)] + ([] if four_connected
                                  else [(1, 1), (1, -1)])
    pad = jnp.uint32(0xFFFFFFFF)
    a_parts, b_parts = [], []
    for dy, dx in offsets:
        nbr = shift(ext, dy, dx, SEGNULLVAL)[:s]
        ok = (seg != SEGNULLVAL) & (nbr != SEGNULLVAL) & (nbr != seg)
        lo = jnp.minimum(seg, nbr)
        hi = jnp.maximum(seg, nbr)
        a_parts.append(jnp.where(ok, lo, pad).ravel())
        b_parts.append(jnp.where(ok, hi, pad).ravel())
    a = jnp.concatenate(a_parts)
    b = jnp.concatenate(b_parts)
    a, b = jax.lax.sort((a, b), num_keys=2)
    first = (a != pad) & ((jnp.arange(a.shape[0]) == 0) |
                          (a != jnp.roll(a, 1)) | (b != jnp.roll(b, 1)))
    n_unique = jnp.sum(first.astype(jnp.uint32))
    return a, b, first, n_unique


def _single_pixel_sharded(planes, seg, size, four_connected: bool,
                          n_dev: int):
    """
    Single-pixel elimination on one row stripe with per-pass halo
    exchange — the frozen find-all-then-apply pass semantics of
    ops/elim_single (reference: shepseg.py:572-736) hold globally
    because every pass reads only pass-start state, on-stripe or halo'd.
    Returns (seg, sizes stale — caller recomputes).
    """
    from ..ops.shifts import offsets_for
    inf = jnp.float32(jnp.inf)
    offsets = offsets_for(four_connected)

    # Pass-invariant spectral distance fields, halo'd: garbage values at
    # out-of-image positions are masked by nbr_ok's False halo fill.
    planes_h = []
    for plane in planes:
        top, bot = _exchange_rows(plane, jnp.float32(0), n_dev)
        planes_h.append(jnp.concatenate([top[None], plane, bot[None]], 0))
    d2s = []
    for dy, dx in offsets:
        d2 = jnp.zeros(planes[0].shape, jnp.float32)
        for plane_h in planes_h:
            diff = plane_h[1:-1] - shift(plane_h, dy, dx, 0.0)[1:-1]
            d2 = d2 + diff * diff
        d2s.append(d2)

    sizes_at = size[seg.astype(jnp.int32)]
    single0 = sizes_at == 1
    nbr_ok0 = sizes_at > 1

    def body(carry):
        seg_c, single_c, nbr_ok_c, _ = carry
        seg_top, seg_bot = _exchange_rows(seg_c, SEGNULLVAL, n_dev)
        ok_top, ok_bot = _exchange_rows(nbr_ok_c, False, n_dev)
        seg_h = jnp.concatenate([seg_top[None], seg_c, seg_bot[None]], 0)
        ok_h = jnp.concatenate([ok_top[None], nbr_ok_c, ok_bot[None]], 0)

        best_d = jnp.full(seg_c.shape, inf)
        new_seg = jnp.zeros_like(seg_c)
        for (dy, dx), d2 in zip(offsets, d2s):
            nbr_seg = shift(seg_h, dy, dx, 0)[1:-1]
            ok = shift(ok_h, dy, dx, False)[1:-1]
            d2m = jnp.where(ok, d2, inf)
            better = d2m < best_d        # strict <: first minimum wins
            best_d = jnp.where(better, d2m, best_d)
            new_seg = jnp.where(better, nbr_seg, new_seg)

        elim = single_c & jnp.isfinite(best_d)
        n = jax.lax.psum(jnp.sum(elim.astype(jnp.uint32)), AXIS)
        return (jnp.where(elim, new_seg, seg_c), single_c & ~elim,
                nbr_ok_c | elim, n)

    seg, _, _, _ = jax.lax.while_loop(
        lambda c: c[3] > 0, body,
        (seg, single0, nbr_ok0, jnp.uint32(1)))
    return seg


def _size_psum(seg, capacity: int):
    """Global per-segment pixel counts: local stripe scatter + psum."""
    local = jnp.zeros(capacity, jnp.uint32).at[
        seg.ravel().astype(jnp.int32)].add(1, mode="drop")
    return jax.lax.psum(local, AXIS)


def _stage1_sharded(img, centers, img_null_val, four_connected: bool,
                    has_null: bool, n_dev: int, height: int, width: int):
    """shard_map worker #1: cluster + clump + per-stripe edge keys."""
    clusters = assign_clusters(img, centers, img_null_val, has_null)
    seg, num_clumps = _clump_sharded(
        clusters.astype(jnp.int32), SEGNULLVAL, four_connected,
        n_dev, height, width)
    a, b, first, n_unique = _edge_sort_keys_stripe(seg, four_connected,
                                                   n_dev)
    return seg, a, b, first, num_clumps, n_unique[None]


def _stage2_sharded(img, seg, a, b, first, max_spectral_diff,
                    min_seg_size: int, four_connected: bool,
                    capacity: int, e_cap_local: int, n_dev: int):
    """
    shard_map worker #2: single-pixel elimination (halo fixpoint), the
    graph small-segment elimination on the globally gathered clump-image
    edges (replicated — see module docstring), and the final relabel.
    """
    planes = band_planes(img.astype(jnp.float32))
    seg_clump = seg
    size = _size_psum(seg, capacity)
    seg = _single_pixel_sharded(planes, seg, size, four_connected, n_dev)

    # replicated per-segment state from stripe contributions
    size = _size_psum(seg, capacity)
    n_after_single = jnp.sum((size[MINSEGID:] > 0).astype(jnp.uint32))
    spect_cols = []
    for plane in planes:
        local = jnp.zeros(capacity, jnp.float32).at[
            seg.ravel().astype(jnp.int32)].add(plane.ravel(), mode="drop")
        spect_cols.append(jax.lax.psum(local, AXIS))
    spect = jnp.stack(spect_cols, axis=1)            # (capacity, nBands)

    # clump id -> post-single id; every stripe holding a clump's pixels
    # scatters the SAME value (a clump merges as one), so pmax merges
    remap_local = jnp.zeros(capacity, jnp.uint32).at[
        seg_clump.ravel().astype(jnp.int32)].set(seg.ravel(), mode="drop")
    remap0 = jax.lax.pmax(remap_local, AXIS)

    ea_l, eb_l = compact_edges(a, b, first, e_cap_local)
    ea = jax.lax.all_gather(ea_l, AXIS).reshape(-1)
    eb = jax.lax.all_gather(eb_l, AXIS).reshape(-1)

    remap, size_out, num_elim, elim_passes = (
        eliminate_small_segments_graph(
            ea, eb, size, spect, min_seg_size, max_spectral_diff,
            remap_init=remap0))

    # contiguous relabel composed into one gather (ops/elim_small
    # _remap_and_relabel, on the replicated table, applied per stripe)
    sub = relabel_subtract(size_out, MINSEGID)
    table = (remap - sub[remap.astype(jnp.int32)]).astype(jnp.uint32)
    seg = table[seg.astype(jnp.int32)]
    max_seg_id = jnp.sum((size_out[MINSEGID:] > 0).astype(jnp.uint32))
    stats = jnp.stack([max_seg_id, n_after_single, num_elim,
                       elim_passes.astype(jnp.uint32)])
    return seg, stats


def segment_image_sharded(img, centers, imgNullVal=None,
                          maxSpectralDiff=None, minSegmentSize=50,
                          fourConnected=True, mesh=None,
                          fullResult=False):
    """
    Host API: the full Shepherd pipeline on one image sharded by rows
    across ``mesh`` (default: a 1-D mesh over jax.devices()). Output is
    bit-identical to the single-chip parallel/pipeline.segment_tile on
    the same inputs (tested on the virtual CPU mesh) provided every
    per-segment per-band float32 spectral sum stays within the
    exact-integer range (2^24) — see the module docstring's summation
    -grouping caveat for larger segments.

    Parameters: ``img`` (nBands, H, W) numeric; ``centers`` (K, nBands)
    fitted cluster centres (float32); ``maxSpectralDiff`` must be a
    resolved float — use shepseg.autoMaxSpectralDiff for 'auto'
    (reference: shepseg.py:400-449); None disables the merge limit.
    Rows are padded with nulls to a multiple of the device count (null
    pixels take no part in any stage, so padding cannot change results).

    Returns (seg uint32 (H, W) with contiguous scan-order IDs from 1,
    maxSegId int); with ``fullResult=True``, additionally
    (numClumps, singlePixelsEliminated, smallSegmentsEliminated,
    elimPasses) ints.
    """
    if mesh is None:
        mesh = Mesh(np.array(jax.devices()), (AXIS,))
    elif mesh.axis_names != (AXIS,):
        mesh = Mesh(mesh.devices.reshape(-1), (AXIS,))
    n_dev = mesh.devices.size

    img = np.ascontiguousarray(img)
    nbands, h, w = img.shape
    pad = (-h) % n_dev
    hasNull = imgNullVal is not None
    if pad:
        if not hasNull:
            # padding rows must hold a recognised null value, otherwise
            # they would be segmented as data
            raise ValueError(
                "image height {} does not divide the {}-device mesh and "
                "imgNullVal is None: pad the rows yourself or supply a "
                "null value".format(h, n_dev))
        img = np.pad(img, ((0, 0), (0, pad), (0, 0)),
                     constant_values=imgNullVal)
    hp = img.shape[1]
    if maxSpectralDiff is None:
        # effectively unbounded; squaring must stay finite in float32
        maxSpectralDiff = 1e18
    nullVal = null_scalar(imgNullVal if hasNull else 0, img.dtype)

    sharding = NamedSharding(mesh, P(None, AXIS, None))
    img_dev = jax.device_put(jnp.asarray(img), sharding)
    centers_j = jnp.asarray(np.asarray(centers, dtype=np.float32))

    stage1 = shard_map(
        functools.partial(_stage1_sharded,
                          four_connected=bool(fourConnected),
                          has_null=hasNull, n_dev=n_dev, height=hp,
                          width=w),
        mesh=mesh,
        in_specs=(P(None, AXIS, None), P(), P()),
        out_specs=(P(AXIS, None), P(AXIS), P(AXIS), P(AXIS), P(),
                   P(AXIS)),
    )
    (seg, a, b, first, num_clumps, n_unique) = jax.jit(stage1)(
        img_dev, centers_j, nullVal)

    # ONE packed scalar sync buckets both static capacities
    num_clumps = int(num_clumps)
    eCapLocal = round_capacity_fine(int(np.asarray(n_unique).max()) + 1)
    capacity = round_capacity(num_clumps + 1)

    # check_vma=False: the graph elimination loop runs redundantly on
    # every device over psum/pmax/all_gather-merged (i.e. replicated by
    # construction) inputs, which the varying-manual-axes type check
    # cannot express through the shared single-chip kernel's loop carry
    # (its init constants are invariant, its data-derived outputs
    # varying). Replication is guaranteed by determinism: identical
    # program, identical inputs on every device.
    try:
        stage2 = shard_map(
            functools.partial(_stage2_sharded,
                              min_seg_size=int(minSegmentSize),
                              four_connected=bool(fourConnected),
                              capacity=capacity, e_cap_local=eCapLocal,
                              n_dev=n_dev),
            mesh=mesh,
            in_specs=(P(None, AXIS, None), P(AXIS, None), P(AXIS),
                      P(AXIS), P(AXIS), P()),
            out_specs=(P(AXIS, None), P()),
            check_vma=False,
        )
    except TypeError:  # older jax: the check was named check_rep
        stage2 = shard_map(
            functools.partial(_stage2_sharded,
                              min_seg_size=int(minSegmentSize),
                              four_connected=bool(fourConnected),
                              capacity=capacity, e_cap_local=eCapLocal,
                              n_dev=n_dev),
            mesh=mesh,
            in_specs=(P(None, AXIS, None), P(AXIS, None), P(AXIS),
                      P(AXIS), P(AXIS), P()),
            out_specs=(P(AXIS, None), P()),
            check_rep=False,
        )
    seg, stats = jax.jit(stage2)(
        img_dev, seg, a, b, first, jnp.float32(maxSpectralDiff))

    seg = np.asarray(seg)[:h]
    (maxSegId, nAfterSingle, numElimSmall, elimPasses) = (
        int(x) for x in np.asarray(stats))
    if fullResult:
        return (seg.astype(SegIdType), maxSegId, num_clumps,
                num_clumps - nAfterSingle, numElimSmall, elimPasses)
    return seg.astype(SegIdType), maxSegId


def doShepherdSegmentationSharded(img, numClusters=60,
        clusterSubsamplePcnt=1, minSegmentSize=50, maxSpectralDiff='auto',
        imgNullVal=None, fourConnected=True, verbose=False,
        fixedKMeansInit=False, kmeansObj=None, spectDistPcntile=50,
        mesh=None):
    """
    Drop-in variant of shepseg.doShepherdSegmentation (same parameters
    and SegmentationResult, reference: shepseg.py:130-249) that runs the
    whole pipeline with the image's rows sharded across the device mesh
    — for single images too large for one chip's HBM. The k-means fit
    happens on the host subsample exactly as in the single-chip driver,
    so a fitted ``kmeansObj`` is interchangeable between the two.
    """
    import time
    from .. import shepseg

    t0 = time.time()
    img = np.ascontiguousarray(img)
    km = kmeansObj
    if km is None:
        km = shepseg.fitSpectralClusters(
            img, numClusters, clusterSubsamplePcnt, imgNullVal,
            fixedKMeansInit)
    maxDiff = shepseg.autoMaxSpectralDiff(km, maxSpectralDiff,
                                          spectDistPcntile)
    (seg, maxSegId, numClumps, numSingle, numSmall, elimPasses) = (
        segment_image_sharded(
            img, np.asarray(km.cluster_centers_, dtype=np.float32),
            imgNullVal=imgNullVal, maxSpectralDiff=float(maxDiff),
            minSegmentSize=minSegmentSize, fourConnected=fourConnected,
            mesh=mesh, fullResult=True))
    if verbose:
        print("Sharded segmentation:", numClumps, "clumps ->", maxSegId,
              "segments (", numSingle, "single pixels,", numSmall,
              "small segments eliminated ) in",
              round(time.time() - t0, 1), "seconds")

    segResult = shepseg.SegmentationResult()
    segResult.segimg = seg
    segResult.kmeans = km
    segResult.maxSpectralDiff = maxDiff
    segResult.singlePixelsEliminated = numSingle
    segResult.smallSegmentsEliminated = numSmall
    segResult.clumpSweeps = None   # not tracked by the sharded clump
    segResult.elimPasses = elimPasses
    return segResult
