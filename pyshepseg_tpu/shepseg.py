"""
Core in-memory segmentation engine (public API).

JAX implementation of the Shepherd et al (2019) iterative-elimination
segmentation. Mirrors the reference module's public surface
(reference: pyshepseg/shepseg.py): ``doShepherdSegmentation`` orchestrates
k-means spectral clustering -> connected-component clumping -> single-pixel
elimination -> small-segment elimination -> relabel, but each stage is a
JAX/XLA device kernel (see pyshepseg_tpu.ops.*) instead of a numba loop.

Segment ID numbers start from 1; zero is the null segment ID.
"""

import time
import functools

import numpy as np
import jax
import jax.numpy as jnp

from .ops.constants import SegIdType, SEGNULLVAL, MINSEGID  # noqa: F401
from .ops.clump import clump, clump_labels  # noqa: F401
from .ops.segreduce import (  # noqa: F401
    makeSegSize, buildSegmentSpectra, relabelSegments,
    makeSegmentLocations, SegmentLocations, seg_sizes, seg_spectral_sums,
    seg_spectral_sums_planes, band_planes as band_planes_fn)
from .ops.elim_single import (  # noqa: F401
    eliminateSinglePixels, eliminate_single_pixels_device)
from .ops.elim_small import (  # noqa: F401
    eliminateSmallSegments, eliminate_small_segments_device, round_capacity,
    round_capacity_fine)
from .ops.kmeans import TPUKMeans, predict_labels, null_scalar


class SegmentationResult(object):
    """
    Results of the segmentation process
    (reference: pyshepseg/shepseg.py:104-127).

    Attributes
    ----------
    segimg : numpy array (nRows, nCols)
        Elements are segment ID numbers (starting from 1)
    kmeans : TPUKMeans (or any object with cluster_centers_)
        Fitted clustering object
    maxSpectralDiff : float
        The value used to limit segment merging
    singlePixelsEliminated : int
        Number of single pixels merged into adjacent segments
    smallSegmentsEliminated : int
        Number of small segments merged into adjacent segments
    clumpSweeps : int
        Perf diagnostic (not in the reference): global label-propagation
        sweeps the clump fixpoint took
    elimPasses : int
        Perf diagnostic: find+apply passes the elimination graph loop
        executed across all target sizes
    """

    def __init__(self):
        self.segimg = None
        self.kmeans = None
        self.maxSpectralDiff = None
        self.singlePixelsEliminated = None
        self.smallSegmentsEliminated = None
        self.clumpSweeps = None
        self.elimPasses = None


def _run_ends(seg):
    """Mask of each horizontal run's last pixel (uint32 labels, any 2D)."""
    h = seg.shape[0]
    nxt = jnp.concatenate(
        [seg[:, 1:], jnp.full((h, 1), ~jnp.uint32(0), seg.dtype)], axis=1)
    return seg != nxt


@functools.partial(
    jax.jit,
    static_argnames=("has_null", "four_connected"))
def _cluster_and_clump_device(img_dev, centers, img_null_val,
                              has_null: bool, four_connected: bool):
    """
    Device dispatch #1: cast image to float32, assign nearest cluster
    (reference: shepseg.py:317-361), clump connected components
    (reference: shepseg.py:452-541), and extract the sorted clump-
    adjacency edge keys. Keeps everything device-resident so the image
    crosses host->device exactly once, in its native dtype.

    Extracting edges HERE (from the clump image) rather than after
    single-pixel elimination lets the one packed scalar fetch also carry
    the measured unique-adjacency count: single-pixel merges only ever
    CONTRACT the adjacency graph (|E| never grows under contraction), so
    the clump-image count is a true bound for the whole elimination
    loop, and the fused dispatch #2 needs no second whole-image sort and
    no second sync.

    Returns (band planes, seg, a, b, first, scalars =
    [numClumps, nUniqueEdges, clumpSweeps, nBoundaryPairs, nRowMax,
    nRunsRowMax]).
    """
    from .ops.kmeans import assign_clusters
    from .ops.elim_small import edge_sort_keys, boundary_row_stats

    img_f = img_dev.astype(jnp.float32)
    clusters = assign_clusters(img_dev, centers, img_null_val, has_null)
    seg, num_clumps, sweeps = clump_labels(
        clusters.astype(jnp.int32), SEGNULLVAL,
        four_connected=four_connected)
    a, b, first, n_unique = edge_sort_keys(seg, four_connected)
    # boundary-pair count and per-row max (duplicates included): size
    # the b_cap/r_cap buckets that let the NEXT run row-compact pairs
    # before sorting (the one-shot path's edge_sort_keys_compact)
    n_pairs, row_max = boundary_row_stats(seg, four_connected)
    # horizontal-run row max of the CLUMP image: seeds the rl_cap bucket
    # for the one-shot's run-length segment reductions. A safe bound for
    # the post-single-pixel-elim image those reductions actually see:
    # the merge is a per-label remap, so equal neighbours stay equal and
    # transitions only ever decrease.
    runs_row_max = jnp.max(jnp.sum(_run_ends(seg).astype(jnp.uint32),
                                   axis=1))
    scalars = jnp.stack([num_clumps, n_unique.astype(jnp.uint32),
                         sweeps.astype(jnp.uint32), n_pairs, row_max,
                         runs_row_max])
    # Per-band 2D planes, NOT the 3D array (see segreduce.band_planes
    # for the lane-padding OOM this avoids)
    return band_planes_fn(img_f), seg, a, b, first, scalars


@functools.partial(
    jax.jit,
    static_argnames=("four_connected", "capacity"))
def _elim_single_and_edges_device(band_planes, seg, clump_sweeps,
                                  four_connected: bool, capacity: int):
    """
    Device dispatch #2 (static capacity bucketed from the clump count):
    single-pixel elimination (reference: shepseg.py:572-736) WITHOUT its
    relabel (monotone-remap argument — see eliminate_single_pixels_device),
    per-segment sizes/spectral sums, and the sorted unique-adjacency edge
    keys for small-segment elimination. The packed scalar pair
    (number of segments after single-pixel elimination, number of unique
    edges) syncs to the host in one fetch; the edge count picks the
    static edge capacity for dispatch #3, which makes edge-bucket
    overflow impossible by construction.
    """
    from .ops.elim_small import edge_sort_keys
    from .ops.segreduce import seg_sizes_and_spectral_sums_planes

    seg, _ = eliminate_single_pixels_device(
        band_planes, seg, None, four_connected, do_relabel=False)
    size, spect = seg_sizes_and_spectral_sums_planes(
        seg, band_planes, capacity)
    n_after_single = jnp.count_nonzero(size[MINSEGID:]).astype(jnp.uint32)
    a, b, first, n_unique = edge_sort_keys(seg, four_connected)
    # clump_sweeps rides along so the host reads all three diagnostics in
    # the one packed fetch
    scalars = jnp.stack([n_after_single, n_unique.astype(jnp.uint32),
                         clump_sweeps.astype(jnp.uint32)])
    return seg, size, spect, a, b, first, scalars


@functools.partial(
    jax.jit,
    static_argnames=("min_seg_size", "e_cap", "capacity"))
def _elim_small_finish_device(seg, size, spect, a, b, first,
                              max_spectral_diff, min_seg_size: int,
                              e_cap: int, capacity: int):
    """
    Device dispatch #3 (static e_cap bucketed from the measured unique
    edge count): small-segment elimination on the adjacency graph
    (reference: shepseg.py:918-1123) + the final contiguous relabel.
    With min_seg_size <= 1 the graph loop is empty and this reduces to
    the relabel the single-pixel stage deferred.
    """
    from .ops.elim_small import (compact_edges,
                                 eliminate_small_segments_graph,
                                 _remap_and_relabel)

    ea, eb = compact_edges(a, b, first, e_cap, id_bound=capacity)
    remap, size_out, n_small, passes = eliminate_small_segments_graph(
        ea, eb, size, spect, min_seg_size, max_spectral_diff)
    seg = _remap_and_relabel(seg, remap, size_out)
    # One packed scalar vector -> one host round trip instead of two
    scalars = jnp.stack([n_small.astype(jnp.uint32),
                         jnp.max(seg).astype(jnp.uint32),
                         passes.astype(jnp.uint32)])
    # Downloading uint16 halves the transfer when IDs fit (capacity is
    # the static bound on the largest ID)
    if capacity <= 0xFFFF + 1:
        seg_out = seg.astype(jnp.uint16)
    else:
        seg_out = seg
    return seg_out, scalars


def _edgeCapForCount(nUniqueEdges: int) -> int:
    """Static edge-capacity bucket from the measured clump-adjacency
    count (module-level hook so tests can force the overflow fallback).
    Quarter-step buckets: the graph loop's cost is linear in this
    capacity (see round_capacity_fine)."""
    return round_capacity_fine(int(nUniqueEdges) + 1)


def _boundaryCapForCount(nBoundaryPairs: int) -> int:
    """Static boundary-pair bucket (b_cap) from a measured pair count.
    Coarse power-of-two buckets: only ONE sort depends on b_cap (cost
    ~linear but small), while every distinct bucket is a fresh compile
    — fewer variants wins. The count varies tile-to-tile within a
    scene, so pow-2 slack also keeps the overflow-refit rate low."""
    return round_capacity(int(nBoundaryPairs) + 1)


def _rowCapForCount(nRowMax: int) -> int:
    """Static per-row boundary-pair bucket (r_cap) from the measured
    max pairs in any single image row. Power-of-two from 64: row counts
    are spiky (a row tracing along a segment boundary can hold several
    times the mean), so generous slack keeps overflow refits rare while
    the cost of slack is only the size of one intermediate sort."""
    cap = 64
    while cap < int(nRowMax) + 1:
        cap *= 2
    return cap


def _runCapForCount(nRunsRowMax: int) -> int:
    """Static per-row horizontal-run bucket (rl_cap) from the measured
    max runs in any single image row, for the run-length segment
    reductions (segreduce.seg_sizes_and_spectral_sums_runlength).
    Power-of-two from 64, same spikiness argument as _rowCapForCount.
    The bucket is recorded unconditionally (monotone: bigger = safer,
    so the grow/shrink ratchet applies); whether the run-length path is
    actually profitable/legal is decided per dispatch by
    :func:`_rlCapEffective`."""
    cap = 64
    while cap < int(nRunsRowMax) + 1:
        cap *= 2
    return cap


def _rlCapEffective(rlCap: int, img_dtype, width: int) -> int:
    """The static run-length capacity a dispatch should USE: the cached
    bucket when the path is exact for this dtype (integer imagery with
    int32-safe row cumsums — segreduce.runlength_sums_ok) and the
    compaction actually shrinks the scatter (cap <= W/2; at cap ~ W the
    run path degenerates to sort + gather + scatter over the same H*W
    elements the direct scatter handles in one op). 0 selects the plain
    per-pixel scatter path."""
    from .ops.segreduce import runlength_sums_ok
    if rlCap and runlength_sums_ok(img_dtype, width) and rlCap <= width // 2:
        return int(rlCap)
    return 0


# Speculative-capacity cache: (shape, dtype, nCentres, fourConnected) ->
# (capacity, e_cap, b_cap, r_cap, rl_cap) measured on the previous run
# of the same configuration. Lets repeat runs (every tile of a scene after the
# first, every timed repeat of a benchmark) run the WHOLE pipeline as a
# single dispatch with no mid-pipeline host sync (a host<->device round
# trip) — and with the boundary pairs row-compacted to (rows, r_cap)
# then b_cap BEFORE the dedup sort, which turns a 2-4-per-pixel-key sort
# into a batched per-row sort plus a b_cap-sized one. A run whose measured counts exceed the speculated buckets trips
# the overflow flag and falls back to the measured two-dispatch path
# (results of the speculative dispatch are discarded; gathers clamp and
# scatters drop out-of-range indices, so the wasted dispatch is
# harmless).
_SPEC_BUCKETS = {}

# Shrink bookkeeping for the decayed ratchet (see _updateSpecBuckets):
# specKey -> (consecutive runs measured strictly below the cached
# buckets, element-wise max of those runs' measured buckets).
_SPEC_SHRINK = {}
_SPEC_SHRINK_AFTER = 3


def _updateSpecBuckets(specKey, measured):
    """
    Decayed-ratchet update of the speculative capacity cache.

    Buckets GROW immediately (element-wise max against the cached entry)
    so alternating same-shape inputs of differing complexity don't
    overflow every other call — each overflow costs a discarded
    full-pipeline dispatch plus a measured re-run and possibly a fresh
    compile. They SHRINK only after _SPEC_SHRINK_AFTER consecutive
    successful runs all measured below the cached buckets, to the
    element-wise max over that streak — so one pathologically busy early
    tile doesn't tax every later dispatch of a scene (the graph loop's
    per-pass cost is linear in e_cap; see ops/elim_small.py).
    """
    cur = _SPEC_BUCKETS.get(specKey)
    if cur is None:
        _SPEC_BUCKETS[specKey] = measured
        _SPEC_SHRINK.pop(specKey, None)
        return
    grown = tuple(max(c, m) for c, m in zip(cur, measured))
    if grown != cur:
        _SPEC_BUCKETS[specKey] = grown
        _SPEC_SHRINK.pop(specKey, None)
        return
    if measured == cur:
        _SPEC_SHRINK.pop(specKey, None)
        return
    streak, runmax = _SPEC_SHRINK.get(specKey, (0, measured))
    runmax = tuple(max(r, m) for r, m in zip(runmax, measured))
    if runmax == cur:
        # the streak's own worst case needs the current buckets after all
        _SPEC_SHRINK.pop(specKey, None)
        return
    streak += 1
    if streak >= _SPEC_SHRINK_AFTER:
        _SPEC_BUCKETS[specKey] = runmax
        _SPEC_SHRINK.pop(specKey, None)
    else:
        _SPEC_SHRINK[specKey] = (streak, runmax)


def _bucketKey(img_dev, centers, fourConnected, minSegmentSize):
    return (tuple(img_dev.shape), str(img_dev.dtype),
            int(centers.shape[0]), bool(fourConnected),
            int(minSegmentSize))


@functools.partial(
    jax.jit,
    static_argnames=("has_null", "four_connected", "min_seg_size",
                     "capacity", "e_cap", "b_cap", "r_cap", "rl_cap"))
def _segment_one_shot_device(img_dev, centers, img_null_val,
                             max_spectral_diff, has_null: bool,
                             four_connected: bool, min_seg_size: int,
                             capacity: int, e_cap: int, b_cap: int,
                             r_cap: int, rl_cap: int = 0):
    """
    The ENTIRE pipeline (cluster -> clump -> edge extraction ->
    single-pixel elim -> graph small-segment elim -> relabel) as ONE
    device program with SPECULATIVE static capacity buckets (from
    _SPEC_BUCKETS). No mid-pipeline host sync: the packed scalar vector
    carries the measured clump / unique-edge / boundary-pair counts plus
    an overflow flag; the caller discards the result and re-runs the
    measured two-dispatch path when any speculation was too small. The
    b_cap/r_cap buckets row-compact the boundary pairs before the dedup
    sort (edge_sort_keys_compact), replacing the measured path's
    2-4-keys-per-pixel sort with a per-row batched one plus a
    b_cap-sized one.

    ``rl_cap`` > 0 routes the segment reductions through the horizontal
    run-length compaction (segreduce.seg_sizes_and_spectral_sums_runlength
    — exact for the dtypes _rlCapEffective gates on), shrinking the
    pipeline's largest scatter from H*W to H*rl_cap entries; a row with
    more runs than rl_cap folds into the overflow flag like every other
    bucket.

    Returns (seg_out, scalars = [numClumps, nUniqueEdges, clumpSweeps,
    nAfterSingle, nSmallEliminated, maxSegId, elimPasses, overflow,
    nBoundaryPairs, nRowMax, nRunsRowMax]).
    """
    from .ops.kmeans import assign_clusters
    from .ops.elim_small import (edge_sort_keys_compact, compact_edges,
                                 eliminate_small_segments_graph,
                                 _remap_and_relabel)
    from .ops.segreduce import (seg_sizes_and_spectral_sums_planes,
                                seg_reduce_and_remap_runlength)

    clusters = assign_clusters(img_dev, centers, img_null_val, has_null)
    seg, num_clumps, sweeps = clump_labels(
        clusters.astype(jnp.int32), SEGNULLVAL,
        four_connected=four_connected)
    a, b, first, n_unique, n_pairs, row_max = edge_sort_keys_compact(
        seg, four_connected, b_cap, r_cap, id_bound=capacity)
    overflow = ((num_clumps + 1 > jnp.uint32(capacity)) |
                (n_unique > jnp.uint32(e_cap)) |
                (n_pairs > jnp.uint32(b_cap)) |
                (row_max > jnp.uint32(r_cap)))

    planes = band_planes_fn(img_dev.astype(jnp.float32))
    seg_clump = seg
    seg, _ = eliminate_single_pixels_device(
        planes, seg, None, four_connected, do_relabel=False)
    if rl_cap:
        # one clump-run compaction yields the reductions AND the
        # clump->post remap (the full-image remap scatter was as
        # expensive as the reduction it replaced)
        size, spect, remap0, runs_max = seg_reduce_and_remap_runlength(
            seg_clump, seg, planes, capacity, rl_cap)
        overflow = overflow | (runs_max > jnp.uint32(rl_cap))
    else:
        size, spect = seg_sizes_and_spectral_sums_planes(
            seg, planes, capacity)
        remap0 = jnp.arange(capacity, dtype=jnp.uint32).at[
            seg_clump.ravel().astype(jnp.int32)].set(seg.ravel())
        runs_max = jnp.max(jnp.sum(
            _run_ends(seg_clump).astype(jnp.uint32), axis=1))
    n_after_single = jnp.count_nonzero(size[MINSEGID:]).astype(jnp.uint32)
    ea, eb = compact_edges(a, b, first, e_cap, id_bound=capacity)
    remap, size_out, n_small, passes = eliminate_small_segments_graph(
        ea, eb, size, spect, min_seg_size, max_spectral_diff,
        remap_init=remap0)
    seg = _remap_and_relabel(seg, remap, size_out)
    scalars = jnp.stack([num_clumps,
                         n_unique.astype(jnp.uint32),
                         sweeps.astype(jnp.uint32),
                         n_after_single,
                         n_small.astype(jnp.uint32),
                         jnp.max(seg).astype(jnp.uint32),
                         passes.astype(jnp.uint32),
                         overflow.astype(jnp.uint32),
                         n_pairs, row_max,
                         runs_max.astype(jnp.uint32)])
    if capacity <= 0xFFFF + 1:
        seg = seg.astype(jnp.uint16)
    return seg, scalars


@functools.partial(
    jax.jit,
    static_argnames=("four_connected", "min_seg_size", "capacity",
                     "e_cap", "rl_cap"))
def _elim_fused_device(band_planes, seg, a, b, first, max_spectral_diff,
                       min_seg_size: int, four_connected: bool,
                       capacity: int, e_cap: int, rl_cap: int = 0):
    """
    Device dispatch #2 FUSED: single-pixel elimination, segment
    reductions, graph small-segment elimination, and the final relabel
    in ONE program. ``a/b/first`` are the sorted CLUMP-image adjacency
    keys from dispatch #1, whose measured unique count sized ``e_cap``
    (contraction bound — see _cluster_and_clump_device); the graph loop
    runs on those clump edges seeded with the singleton-merge remap, so
    this dispatch needs neither its own whole-image sort nor a second
    capacity sync.

    ``rl_cap``: same run-length reduction routing as
    _segment_one_shot_device. Callers pass the bucket sized from
    dispatch #1's clump-image run count, which BOUNDS this dispatch's
    post-single-elim run count (the merge is a per-label remap: equal
    neighbours stay equal, transitions only ever decrease), so no
    overflow flag is needed here. Using the same reduction on both the
    measured and speculative paths keeps their outputs bit-identical.

    Returns (seg_out, scalars = [nAfterSingle, nSmallEliminated,
    maxSegId, elimPasses, edgeOverflow]).
    """
    from .ops.elim_small import (compact_edges,
                                 eliminate_small_segments_graph,
                                 _remap_and_relabel)
    from .ops.segreduce import (seg_sizes_and_spectral_sums_planes,
                                seg_reduce_and_remap_runlength)

    seg_clump = seg
    seg, _ = eliminate_single_pixels_device(
        band_planes, seg, None, four_connected, do_relabel=False)
    if rl_cap:
        size, spect, remap0, _ = seg_reduce_and_remap_runlength(
            seg_clump, seg, band_planes, capacity, rl_cap)
    else:
        size, spect = seg_sizes_and_spectral_sums_planes(
            seg, band_planes, capacity)
        # clump id -> post-single-elim id: every pixel of a clump
        # carries the same new id (survivors keep theirs; an absorbed
        # singleton's one pixel carries its absorber), so a full-image
        # scatter builds the map
        remap0 = jnp.arange(capacity, dtype=jnp.uint32).at[
            seg_clump.ravel().astype(jnp.int32)].set(seg.ravel())
    n_after_single = jnp.count_nonzero(size[MINSEGID:]).astype(jnp.uint32)
    n_unique = jnp.sum(first.astype(jnp.uint32))
    overflow = (n_unique > jnp.uint32(e_cap)).astype(jnp.uint32)
    ea, eb = compact_edges(a, b, first, e_cap, id_bound=capacity)
    remap, size_out, n_small, passes = eliminate_small_segments_graph(
        ea, eb, size, spect, min_seg_size, max_spectral_diff,
        remap_init=remap0)
    seg = _remap_and_relabel(seg, remap, size_out)
    scalars = jnp.stack([n_after_single, n_small.astype(jnp.uint32),
                         jnp.max(seg).astype(jnp.uint32),
                         passes.astype(jnp.uint32), overflow])
    if capacity <= 0xFFFF + 1:
        seg = seg.astype(jnp.uint16)
    return seg, scalars


def doShepherdSegmentation(img, numClusters=60, clusterSubsamplePcnt=1,
        minSegmentSize=50, maxSpectralDiff='auto', imgNullVal=None,
        fourConnected=True, verbose=False, fixedKMeansInit=False,
        kmeansObj=None, spectDistPcntile=50):
    """
    Perform Shepherd segmentation in memory on the given multi-band img
    array of shape (nBands, nRows, nCols)
    (reference: pyshepseg/shepseg.py:130-249 — same parameters, same
    semantics; compute runs on the JAX device).

    The image is uploaded to the device once (native dtype) and all stages
    run device-resident; the only mid-pipeline host sync is the scalar
    clump count, which picks the static per-segment array capacity.

    Returns a SegmentationResult. Segment IDs start from 1; 0 is null.

    ``img`` may also be a ``jax.Array`` already resident on the device
    (e.g. a tile sliced from a whole-scene device cache — see
    tiling.DeviceSceneCache); the host->device upload is then skipped
    entirely. If no fitted ``kmeansObj`` is supplied with a device-array
    image, the image is pulled back to the host once for the k-means fit.
    """
    t0 = time.time()
    if isinstance(img, jax.Array):
        img_dev = img
        if kmeansObj is None:
            img = np.asarray(img)
    else:
        img = np.ascontiguousarray(img)
        # Start the (async) host->device image transfer first so it
        # overlaps with the host-side subsampling and k-means fit below.
        img_dev = jax.device_put(img)
    if kmeansObj is not None:
        km = kmeansObj
    else:
        km = fitSpectralClusters(img, numClusters, clusterSubsamplePcnt,
                                 imgNullVal, fixedKMeansInit)
    centers = jnp.asarray(np.asarray(km.cluster_centers_, dtype=np.float32))
    hasNull = imgNullVal is not None
    nullVal = null_scalar(imgNullVal if hasNull else 0, img_dev.dtype)
    maxSpectralDiff = autoMaxSpectralDiff(km, maxSpectralDiff,
                                          spectDistPcntile)

    # Speculative ONE-dispatch path: when a previous run of this
    # configuration recorded its capacity buckets, run the whole
    # pipeline with no mid-pipeline sync and verify the speculation
    # from the returned scalars.
    specKey = _bucketKey(img_dev, centers, fourConnected, minSegmentSize)
    imgWidth = int(img_dev.shape[2])
    spec = _SPEC_BUCKETS.get(specKey)
    done = False
    if spec is not None:
        capacity, eCap, bCap, rCap, rlCap = spec
        seg_out_dev, scalars_dev = _segment_one_shot_device(
            img_dev, centers, nullVal, jnp.float32(maxSpectralDiff),
            has_null=hasNull, four_connected=bool(fourConnected),
            min_seg_size=int(minSegmentSize),
            capacity=capacity, e_cap=eCap, b_cap=bCap, r_cap=rCap,
            rl_cap=_rlCapEffective(rlCap, img_dev.dtype, imgWidth))
        (numClumps, nUniqueEdges, clumpSweeps, nAfterSingle,
         numElimSmall, finalMax, elimPasses, overflow,
         nBoundaryPairs, nRowMax,
         nRunsRowMax) = np.asarray(scalars_dev).tolist()
        if overflow:
            # speculation too small: discard and re-run measured
            _SPEC_BUCKETS.pop(specKey, None)
            _SPEC_SHRINK.pop(specKey, None)
        else:
            maxSegId = int(numClumps)
            _updateSpecBuckets(specKey, (
                round_capacity(maxSegId + 1),
                _edgeCapForCount(int(nUniqueEdges)),
                _boundaryCapForCount(int(nBoundaryPairs)),
                _rowCapForCount(int(nRowMax)),
                _runCapForCount(int(nRunsRowMax))))
            done = True
            if verbose:
                print("One-shot dispatch found", maxSegId, "clumps, in",
                      round(time.time() - t0, 1), "seconds,",
                      int(clumpSweeps), "propagation sweeps")
    if not done:
        (planes_dev, seg_dev, a_dev, b_dev, first_dev,
         scalars0_dev) = _cluster_and_clump_device(
            img_dev, centers, nullVal,
            has_null=hasNull, four_connected=bool(fourConnected))
        # The ONE mid-pipeline scalar sync: picks the segment-capacity
        # bucket (clump count) and the edge-capacity bucket (measured
        # clump-image adjacency count, a contraction bound for the loop).
        (numClumps, nUniqueEdges, clumpSweeps,
         nBoundaryPairs, nRowMax, nRunsRowMax) = np.asarray(
            scalars0_dev).tolist()
        maxSegId = int(numClumps)
        if verbose:
            print("Kmeans plus clump found", maxSegId, "clumps, in",
                  round(time.time() - t0, 1), "seconds,",
                  int(clumpSweeps), "propagation sweeps")

        t0 = time.time()
        capacity = round_capacity(maxSegId + 1)
        eCap = _edgeCapForCount(nUniqueEdges)
        rlCap = _runCapForCount(int(nRunsRowMax))
        seg_out_dev, scalars_dev = _elim_fused_device(
            planes_dev, seg_dev, a_dev, b_dev, first_dev,
            jnp.float32(maxSpectralDiff),
            min_seg_size=int(minSegmentSize),
            four_connected=bool(fourConnected),
            capacity=capacity, e_cap=eCap,
            rl_cap=_rlCapEffective(rlCap, img_dev.dtype, imgWidth))
        (nAfterSingle, numElimSmall, finalMax, elimPasses,
         overflow) = np.asarray(scalars_dev).tolist()
        if overflow:
            # Cannot trip when eCap came from the measured count (the
            # graph only contracts); guards the test hook and any future
            # caller passing a heuristic bucket. Falls back to measuring
            # edges post-elimination (one extra sync).
            sweeps_dev = jnp.uint32(int(clumpSweeps))
            (seg_dev2, size_dev, spect_dev, ea_dev, eb_dev, first_dev2,
             scalars1_dev) = _elim_single_and_edges_device(
                planes_dev, seg_dev, sweeps_dev,
                four_connected=bool(fourConnected), capacity=capacity)
            nAfterSingle, nUniqueEdges, clumpSweeps = np.asarray(
                scalars1_dev).tolist()
            eCap = round_capacity_fine(int(nUniqueEdges) + 1)
            seg_out_dev, scalars2_dev = _elim_small_finish_device(
                seg_dev2, size_dev, spect_dev, ea_dev, eb_dev, first_dev2,
                jnp.float32(maxSpectralDiff),
                min_seg_size=int(minSegmentSize),
                e_cap=eCap, capacity=capacity)
            numElimSmall, finalMax, elimPasses = np.asarray(
                scalars2_dev).tolist()
        else:
            # record the measured buckets so the NEXT run of this
            # configuration takes the one-shot path
            _updateSpecBuckets(specKey, (
                capacity, eCap, _boundaryCapForCount(int(nBoundaryPairs)),
                _rowCapForCount(int(nRowMax)), rlCap))
    # uint16 download invariant: the cast fires iff capacity bounds all
    # IDs below 2^16, so the final max must fit
    if seg_out_dev.dtype == jnp.uint16:
        assert int(finalMax) <= 0xFFFF, (finalMax, capacity)
    seg = np.asarray(seg_out_dev).astype(SegIdType)
    numElimSinglepix = maxSegId - int(nAfterSingle)
    if verbose:
        print("Eliminated", numElimSinglepix, "single pixels and",
              numElimSmall, "small segments in", int(elimPasses),
              "graph passes, in", round(time.time() - t0, 1), "seconds")
        print("Final result has", int(finalMax), "segments")

    segResult = SegmentationResult()
    segResult.segimg = seg
    segResult.kmeans = km
    segResult.maxSpectralDiff = maxSpectralDiff
    segResult.singlePixelsEliminated = numElimSinglepix
    segResult.smallSegmentsEliminated = numElimSmall
    # perf diagnostics (not in the reference result): loop-iteration
    # counts of the two on-device fixpoint loops, for roofline accounting
    segResult.clumpSweeps = int(clumpSweeps)
    segResult.elimPasses = int(elimPasses)
    return segResult


def _refitBucketsFromOneShot(vals):
    """(capacity, e_cap, b_cap, r_cap, rl_cap) refit from a one-shot
    dispatch's measured scalars after an overflow — the production path
    re-measures instead of failing, and so must every benchmark harness
    (a bench that can crash on a data-dependent count is not a benchmark
    harness). numClumps/nPairs/rowMax/runsRowMax are
    exact measures even under overflow; nUnique may UNDERCOUNT when the
    pair buffer overflowed (it is counted on the compacted slice), so it
    gets a 2x margin."""
    return (round_capacity(int(vals[0]) + 1),
            _edgeCapForCount(int(vals[1]) * 2),
            _boundaryCapForCount(int(vals[8])),
            _rowCapForCount(int(vals[9])),
            _runCapForCount(int(vals[10])))


def deviceResidentThroughput(img, kmeansObj, maxSpectralDiff,
                             minSegmentSize=50, fourConnected=True,
                             imgNullVal=None, repeats=3):
    """
    Measure compute-only throughput (Mpix/s) of the segmentation pipeline:
    the image is pre-placed on the device and the k-means model pre-fitted,
    so the measurement covers the production steady state — ONE
    speculative fused dispatch (capacity buckets learned from the priming
    run) and its single scalar sync — but excludes host<->device image
    transfers and the clustering fit.
    """
    img = np.ascontiguousarray(img)
    h, w = img.shape[1:]
    centers = jnp.asarray(np.asarray(kmeansObj.cluster_centers_,
                                     dtype=np.float32))
    hasNull = imgNullVal is not None
    nullVal = null_scalar(imgNullVal if hasNull else 0, img.dtype)
    maxDiff = jnp.float32(maxSpectralDiff)
    img_dev = jax.device_put(img)
    # settle the transfer before timing starts (device_put is async)
    img_dev.block_until_ready()

    # Priming run: measured two-dispatch path learns the capacity buckets
    planes, seg, a, b, first, sc0 = _cluster_and_clump_device(
        img_dev, centers, nullVal, has_null=hasNull,
        four_connected=bool(fourConnected))
    num, nUnique, _, nPairs, nRowMax, nRunsMax = np.asarray(sc0).tolist()
    capacity = round_capacity(int(num) + 1)
    eCap = _edgeCapForCount(nUnique)
    bCap = _boundaryCapForCount(nPairs)
    rCap = _rowCapForCount(nRowMax)
    rlCap = _runCapForCount(nRunsMax)
    _elim_fused_device(
        planes, seg, a, b, first, maxDiff,
        min_seg_size=int(minSegmentSize),
        four_connected=bool(fourConnected), capacity=capacity,
        e_cap=eCap, rl_cap=_rlCapEffective(rlCap, img.dtype, w))

    def run():
        seg_out, sc = _segment_one_shot_device(
            img_dev, centers, nullVal, maxDiff,
            has_null=hasNull, four_connected=bool(fourConnected),
            min_seg_size=int(minSegmentSize),
            capacity=capacity, e_cap=eCap, b_cap=bCap, r_cap=rCap,
            rl_cap=_rlCapEffective(rlCap, img.dtype, w))
        return np.asarray(sc)

    # warm-up (compile); refit-and-rerun on overflow instead of
    # asserting (cannot trip when the buckets came from priming on this
    # same image, but a caller-supplied kmeans/bucket combination must
    # degrade to a refit, not a crash)
    for _ in range(4):
        vals = run()
        if not vals[7]:
            break
        capacity, eCap, bCap, rCap, rlCap = _refitBucketsFromOneShot(vals)
    else:
        raise RuntimeError("speculative buckets failed to converge "
                           "after 4 refits: %s" % (vals.tolist(),))
    times = []
    for _ in range(repeats):
        t0 = time.time()
        run()
        times.append(time.time() - t0)
    return (h * w / 1e6) / min(times)


def fitSpectralClusters(img, numClusters, subsamplePcnt, imgNullVal,
        fixedKMeansInit):
    """
    Fit the k-means spectral clustering stage on a subsample of the image
    (reference: pyshepseg/shepseg.py:252-314 — same sampling rule:
    drop null pixels, then stride-subsample with skip=round(100/pcnt)).

    Returns a fitted TPUKMeans (sklearn-KMeans compatible surface).
    """
    (nBands, nRows, nCols) = img.shape
    xFull = np.transpose(img, axes=(1, 2, 0)).reshape(
        (nRows * nCols, nBands))

    if imgNullVal is not None:
        nonNull = (xFull != imgNullVal).all(axis=1)
        xNonNull = xFull[nonNull]
        del nonNull
    else:
        xNonNull = xFull
    skip = int(round(100. / subsamplePcnt))
    xSample = xNonNull[::skip]
    del xFull, xNonNull

    numKmeansTrials = 5
    init = 'k-means++'
    if fixedKMeansInit:
        init = diagonalClusterCentres(xSample, numClusters)
        numKmeansTrials = 1
    km = TPUKMeans(n_clusters=numClusters, n_init=numKmeansTrials, init=init)
    km.fit(xSample)
    return km


def applySpectralClusters(kmeansObj, img, imgNullVal):
    """
    Predict spectral clusters for every pixel
    (reference: pyshepseg/shepseg.py:317-361). Cluster IDs start from 1;
    pixels with imgNullVal in any band become SEGNULLVAL.

    Accepts any object with ``cluster_centers_`` (TPUKMeans or a fitted
    sklearn KMeans); the assignment itself always runs on device.
    """
    (nBands, nRows, nCols) = img.shape
    xFull = np.transpose(img, axes=(1, 2, 0)).reshape(
        (nRows * nCols, nBands))

    centers = getattr(kmeansObj, 'cluster_centers_', None)
    if centers is not None:
        import jax.numpy as jnp
        centers_j = jnp.asarray(np.asarray(centers, dtype=np.float32))
        clustersFull = np.empty(xFull.shape[0], dtype=np.int32)
        chunk = 1 << 22
        for start in range(0, xFull.shape[0], chunk):
            xs = jnp.asarray(xFull[start:start + chunk].astype(np.float32))
            clustersFull[start:start + xs.shape[0]] = np.asarray(
                predict_labels(xs, centers_j))
    else:
        clustersFull = kmeansObj.predict(xFull)
    del xFull
    clustersImg = clustersFull.reshape((nRows, nCols)).astype(SegIdType)

    clustersImg += 1
    if imgNullVal is not None:
        nullmask = (img == imgNullVal).any(axis=0)
        clustersImg[nullmask] = SEGNULLVAL

    return clustersImg


def diagonalClusterCentres(xSample, numClusters):
    """
    Deterministic initial cluster centres, evenly spaced along the diagonal
    of the data bounding box, end points one step in from the corners
    (reference: pyshepseg/shepseg.py:364-397 — including the reference's
    behaviour of keeping the sample's integer dtype, which truncates).
    """
    (numPoints, numBands) = xSample.shape
    bandMin = xSample.min(axis=0)
    bandMax = xSample.max(axis=0)

    centres = np.empty((numClusters, numBands), dtype=xSample.dtype)
    step = (bandMax - bandMin) / (numClusters + 1)
    for i in range(numClusters):
        centres[i] = bandMin + (i + 1) * step

    return centres


def autoMaxSpectralDiff(km, maxSpectralDiff, distPcntile):
    """
    Resolve the maxSpectralDiff setting
    (reference: pyshepseg/shepseg.py:400-449): 'auto' -> the given
    percentile of pairwise distances between cluster centres; None ->
    10x the largest distance (effectively unbounded); else pass through.
    """
    centres = np.asarray(km.cluster_centers_, dtype=np.float64)
    numClusters = centres.shape[0]
    iu = np.triu_indices(numClusters, k=1)
    diffs = centres[iu[0]] - centres[iu[1]]
    clusterDist = np.sqrt((diffs ** 2).sum(axis=1)).astype(np.float32)

    if isinstance(maxSpectralDiff, str) and maxSpectralDiff == 'auto':
        maxSpectralDiff = np.percentile(clusterDist, distPcntile)
    elif maxSpectralDiff is None:
        maxSpectralDiff = 10 * clusterDist.max()

    return maxSpectralDiff


# ---------------------------------- reference kernel compat layer
#
# The in-memory engine above runs the whole pipeline device-resident, but
# the reference also exposes its individual elimination kernels as public
# API (reference: shepseg.py:618-736, 816-877, 1003-1123). These are
# faithful host-side equivalents on numpy arrays, for callers that drove
# the reference kernels directly. They preserve the reference's scan
# order and tie-breaks exactly (sequential greedy semantics), so they
# are per-call faithful but not device-accelerated — the public
# eliminateSinglePixels / eliminateSmallSegments drivers are the fast
# path.


class RowColArray:
    """
    Fixed-capacity list of (row, col) pixel coordinates for one segment
    (reference RowColArray jitclass: shepseg.py:816-877).
    """

    __slots__ = ('rowcols', 'idx')

    def __init__(self, length):
        self.rowcols = np.empty((int(length), 2), dtype=np.uint32)
        self.idx = 0

    def append(self, row, col):
        self.rowcols[self.idx, 0] = row
        self.rowcols[self.idx, 1] = col
        self.idx += 1

    def getSegmentIndices(self):
        """(rows, cols) arrays, usable as a fancy index into the image."""
        return (self.rowcols[:self.idx, 0], self.rowcols[:self.idx, 1])


def makeSegmentLocationsDict(seg, segSize):
    """
    Reference-style dictionary of segment ID -> :class:`RowColArray`
    holding each segment's pixel coordinates in row-major scan order
    (reference: shepseg.py:880-915 — a numba typed Dict there). The
    framework's own :func:`makeSegmentLocations` builds the CSR
    equivalent; use this dict form with :func:`findMergeSegment` /
    :func:`doMerge`, which mutate it.
    """
    seg = np.asarray(seg)
    flat = seg.ravel()
    order = np.argsort(flat, kind='stable')
    sortedIds = flat[order]
    w = seg.shape[1]
    ids, startIdx = np.unique(sortedIds, return_index=True)
    startIdx = np.append(startIdx, len(flat))
    d = {}
    for i, s in enumerate(ids.tolist()):
        if s == SEGNULLVAL:
            continue
        sl = order[startIdx[i]:startIdx[i + 1]]
        rca = RowColArray(len(sl))
        rca.rowcols[:, 0] = sl // w
        rca.rowcols[:, 1] = sl % w
        rca.idx = len(sl)
        d[s] = rca
    return d


def findNearestNeighbourPixel(img, seg, i, j, segSize, fourConnected):
    """
    The (row, col) of the spectrally-nearest 3x3 neighbour of pixel
    (i, j) that belongs to a segment of size > 1, or (-1, -1)
    (reference: shepseg.py:677-736 — same scan order and strict-<
    tie-break).

    Documented deviation (PARITY.md): distances are computed in
    float64. The reference's numba kernel subtracts in the IMAGE's
    dtype, so unsigned imagery wraps (uint8 0 - 255 -> 1) and can pick
    a spectrally-distant neighbour; here the true distance is used.
    Signed or float imagery is unaffected.
    """
    (nBands, nRows, nCols) = img.shape
    minDsqr = -1.0
    ii = jj = -1
    centre = img[:, i, j].astype(np.float64)
    for iii in range(max(i - 1, 0), min(i + 1, nRows - 1) + 1):
        for jjj in range(max(j - 1, 0), min(j + 1, nCols - 1) + 1):
            connected = (not fourConnected) or (iii == i) or (jjj == j)
            if connected and segSize[seg[iii, jjj]] > 1:
                dSqr = ((centre - img[:, iii, jjj]) ** 2).sum()
                if minDsqr < 0 or dSqr < minDsqr:
                    minDsqr = dSqr
                    ii, jj = iii, jjj
    return (ii, jj)


def mergeSinglePixels(img, seg, segSize, segToElim, fourConnected):
    """
    One find-all-then-apply pass merging single-pixel segments into
    their spectrally-nearest neighbour of size > 1; modifies seg and
    segSize in place and returns the number eliminated
    (reference: shepseg.py:618-674). The public
    :func:`eliminateSinglePixels` driver runs the same pass structure
    on-device.
    """
    numEliminated = 0
    for (i, j) in np.argwhere(segSize[seg] == 1):  # row-major scan order
        (ii, jj) = findNearestNeighbourPixel(img, seg, int(i), int(j),
                                             segSize, fourConnected)
        if ii >= 0 and jj >= 0:
            segToElim[0, numEliminated] = i
            segToElim[1, numEliminated] = j
            segToElim[2, numEliminated] = seg[ii, jj]
            numEliminated += 1
    for k in range(numEliminated):
        r = segToElim[0, k]
        c = segToElim[1, k]
        newSeg = segToElim[2, k]
        oldSeg = seg[r, c]
        seg[r, c] = newSeg
        segSize[oldSeg] = 0
        segSize[newSeg] += 1
    return numEliminated


def findMergeSegment(segId, segLoc, seg, segSize, spectSum,
                     maxSpectralDiff, fourConnected):
    """
    The neighbouring segment the given segment should merge into: the
    strictly-larger neighbour with the closest mean spectrum, SEGNULLVAL
    if none within maxSpectralDiff (reference: shepseg.py:1003-1063 —
    same pixel scan order and strict-< tie-break). ``segLoc`` is the
    dict from :func:`makeSegmentLocationsDict`.
    """
    bestNbrSeg = SEGNULLVAL
    bestDistSqr = 0.0
    (nRows, nCols) = seg.shape
    segRowcols = segLoc[segId].rowcols
    numPix = len(segRowcols)
    spect = spectSum[segId] / numPix
    for k in range(numPix):
        # python ints: uint32 pixel coords would wrap at the image edge
        i = int(segRowcols[k, 0])
        j = int(segRowcols[k, 1])
        for ii in range(max(i - 1, 0), min(i + 2, nRows)):
            for jj in range(max(j - 1, 0), min(j + 2, nCols)):
                connected = (not fourConnected) or (ii == i) or (jj == j)
                nbrSegId = seg[ii, jj]
                if (connected and nbrSegId != segId and
                        nbrSegId != SEGNULLVAL and
                        segSize[nbrSegId] > segSize[segId]):
                    nbrSpect = spectSum[nbrSegId] / segSize[nbrSegId]
                    distSqr = ((spect - nbrSpect) ** 2).sum()
                    if bestNbrSeg == SEGNULLVAL or distSqr < bestDistSqr:
                        bestDistSqr = distSqr
                        bestNbrSeg = nbrSegId
    if bestDistSqr > maxSpectralDiff ** 2:
        bestNbrSeg = SEGNULLVAL
    return bestNbrSeg


def doMerge(segId, nbrSegId, seg, segSize, segLoc, spectSum):
    """
    Merge segment segId into nbrSegId: rewrite its pixels, concatenate
    the coordinate lists (neighbour's pixels first, as the reference
    appends), add the spectral sums and sizes, zero out the merged-away
    entry. Modifies everything in place
    (reference: shepseg.py:1066-1123).
    """
    segRowcols = segLoc[segId].rowcols
    numPix = len(segRowcols)
    nbrRowcols = segLoc[nbrSegId].rowcols
    nbrNumPix = len(nbrRowcols)
    merged = RowColArray(numPix + nbrNumPix)
    merged.rowcols[:nbrNumPix] = nbrRowcols
    merged.rowcols[nbrNumPix:] = segRowcols
    merged.idx = numPix + nbrNumPix
    seg[segRowcols[:, 0], segRowcols[:, 1]] = nbrSegId
    segLoc[nbrSegId] = merged
    segLoc.pop(segId)
    spectSum[nbrSegId] += spectSum[segId]
    spectSum[segId] = 0
    segSize[nbrSegId] += segSize[segId]
    segSize[segId] = 0
