"""
Segment reductions and relabelling.

Replaces the reference's histogram / spectral-sum / relabel scalar loops
(reference: pyshepseg/shepseg.py:544-569, 739-777, 780-813) with
``jax.ops.segment_sum`` reductions, and the per-segment pixel-location
typed-dict (``RowColArray`` / ``makeSegmentLocations``,
shepseg.py:816-915) with a CSR layout built from a stable sort — the
static-shape, gather-friendly equivalent on the device.

All device functions take a static ``capacity`` (= max segment ID + 1,
rounded to a bucket by callers) because XLA requires static shapes; the
entries above the true max are zero.
"""

import jax
import jax.numpy as jnp
import numpy as np

from .constants import SegIdType, MINSEGID


def seg_sizes(seg, capacity: int):
    """Device: histogram of segment IDs. seg: uint32 (H, W) -> (capacity,) uint32."""
    ones = jnp.ones(seg.size, dtype=jnp.uint32)
    return jax.ops.segment_sum(ones, seg.ravel().astype(jnp.int32),
                               num_segments=capacity)


def band_planes(img_f):
    """
    Split a (nBands, H, W) array into a tuple of 2D (H, W) planes, or pass
    a tuple through unchanged. Invariant: device loops must never see a 3D
    float image — XLA layout assignment may otherwise materialise a copy
    with the nBands dim as the padded lane dimension (4 -> 128 lanes =
    32x memory), which OOMs HBM on large tiles.
    """
    if isinstance(img_f, tuple):
        return img_f
    return tuple(img_f[b] for b in range(img_f.shape[0]))


def seg_spectral_sums(seg, img, capacity: int):
    """
    Device: per-segment per-band sums of pixel values.

    img: (nBands, H, W) numeric -> (capacity, nBands) float32.
    Row 0 (the null segment) is computed but unused, matching the reference
    layout (reference: shepseg.py:780-813).
    """
    return seg_spectral_sums_planes(seg, band_planes(img), capacity)


def seg_spectral_sums_planes(seg, band_planes, capacity: int):
    """
    Per-segment per-band sums from a tuple of 2D band planes (see
    :func:`band_planes` for why callers keep large tiles in plane form).
    """
    flat_seg = seg.ravel().astype(jnp.int32)
    # ONE multi-channel scatter instead of one scatter per band: the
    # index sequence (and so the per-segment accumulation order) is
    # identical, but the 1M-pixel scatter cost is paid once, not nBands
    # times.
    vals = jnp.stack([p.ravel().astype(jnp.float32)
                      for p in band_planes], axis=1)   # (N, nBands)
    return jax.ops.segment_sum(vals, flat_seg, num_segments=capacity)


def seg_sizes_and_spectral_sums_planes(seg, band_planes, capacity: int):
    """
    Device: per-segment pixel counts AND per-band sums in ONE scatter.

    The count rides as an extra all-ones channel of the multi-channel
    segment_sum, halving the big O(H*W) scatter traffic vs separate
    seg_sizes + seg_spectral_sums_planes calls. Safe only while counts
    stay exactly representable in float32 (pixels < 2^24); larger tiles
    fall back to the two-scatter form. The per-band accumulation order
    is identical to seg_spectral_sums_planes (same index sequence,
    channels independent), so the sums are bit-identical.

    Returns (sizes uint32 (capacity,), spect float32 (capacity, nBands)).
    """
    flat_seg = seg.ravel().astype(jnp.int32)
    n = flat_seg.shape[0]
    if n >= (1 << 24):
        return (seg_sizes(seg, capacity),
                seg_spectral_sums_planes(seg, band_planes, capacity))
    vals = jnp.stack([jnp.ones(n, jnp.float32)] +
                     [p.ravel().astype(jnp.float32) for p in band_planes],
                     axis=1)                           # (N, nBands+1)
    out = jax.ops.segment_sum(vals, flat_seg, num_segments=capacity)
    return out[:, 0].astype(jnp.uint32), out[:, 1:]


def runlength_sums_ok(img_dtype, width: int) -> bool:
    """
    Static gate for :func:`seg_sizes_and_spectral_sums_runlength`: the
    run-length path needs EXACT int32 row cumsums, so the imagery must
    be integer-valued with |value| <= 2^16 (8/16-bit ints) and a row
    total that cannot overflow int32. Called at trace time.
    """
    dt = np.dtype(img_dtype)
    return (dt.kind in "iu" and dt.itemsize <= 2 and
            width * 65536 < (1 << 31))


def seg_sizes_and_spectral_sums_runlength(seg, band_planes, capacity: int,
                                          run_cap: int):
    """
    Device: per-segment pixel counts and per-band sums via HORIZONTAL
    RUN-LENGTH compaction — the fast path replacing the big
    (H*W)-index scatter of :func:`seg_sizes_and_spectral_sums_planes`.

    The full-image scatter writes one update per pixel. Segment images
    are spatially coherent
    (clump labels come from a run scan), so almost all of those indices
    are consecutive repeats. This path aggregates each horizontal run
    first and scatters one entry PER RUN:

    1. int32 row cumsums of every band (exact: see runlength_sums_ok);
    2. run-end positions compacted to each row's front by a per-row
       ascending sort of masked column indices (the same
       sort-instead-of-scatter compaction as
       elim_small.edge_sort_keys_compact), sliced to a static
       ``run_cap``;
    3. ONE multi-channel gather of (segid, cumsums) at the run ends
       (H*run_cap indices; XLA's multi-row gather vectorizes across
       channels), run sums by differencing consecutive ends;
    4. ONE multi-channel scatter of H*run_cap run entries.

    Sums are exact integers (cast to float32 once at the end), so for
    any segment whose total fits 2^24 the result is bit-identical to
    the per-pixel float32 accumulation of the planes path; above that
    the two paths differ only in float32 rounding (correctly-rounded
    here vs accumulation-ordered there).

    ``run_cap`` (static) speculatively bounds the runs in any single
    image row. Returns (sizes uint32 (capacity,), spect float32
    (capacity, nBands), row_runs_max uint32) — row_runs_max > run_cap
    means runs were dropped and the caller MUST treat every output as
    overflowed (the one-shot dispatch folds it into its overflow flag,
    exactly like the capacity/e_cap/b_cap/r_cap buckets).
    """
    h, w = seg.shape
    nb = len(band_planes)
    seg_i = seg.astype(jnp.int32)
    nxt = jnp.concatenate(
        [seg_i[:, 1:], jnp.full((h, 1), -1, jnp.int32)], axis=1)
    end = seg_i != nxt                           # last pixel of each run
    row_runs_max = jnp.max(jnp.sum(end.astype(jnp.uint32), axis=1))

    # compact run-end column positions to each row's front (ascending;
    # the pad W sorts last), slice to the speculative per-row cap
    posk = jnp.where(end, jnp.arange(w, dtype=jnp.int32)[None, :], w)
    posk = jax.lax.sort(posk, dimension=1)[:, :run_cap]   # (H, run_cap)
    valid = posk < w
    posc = jnp.minimum(posk, w - 1)

    cums = [jnp.cumsum(p.astype(jnp.int32), axis=1).ravel()
            for p in band_planes]
    tbl = jnp.stack([seg_i.ravel()] + cums)               # (1+nb, H*W)
    flat = (jnp.arange(h, dtype=jnp.int32)[:, None] * w + posc).ravel()
    g = tbl[:, flat].reshape(1 + nb, h, run_cap)
    ids = g[0]                                            # (H, run_cap)
    cum_end = g[1:]                                       # (nb, H, run_cap)

    # consecutive-slot differences: valid slots are a contiguous prefix
    # of each row (ascending sort), so slot k-1 is the previous run end
    prev_cum = jnp.concatenate(
        [jnp.zeros((nb, h, 1), jnp.int32), cum_end[:, :, :-1]], axis=2)
    prev_pos = jnp.concatenate(
        [jnp.full((h, 1), -1, jnp.int32), posc[:, :-1]], axis=1)
    count = (posc - prev_pos).astype(jnp.float32)[None]   # (1, H, run_cap)
    sums = (cum_end - prev_cum).astype(jnp.float32)       # (nb, H, run_cap)
    vals = jnp.concatenate([count, sums]).reshape(1 + nb, -1).T

    idx = jnp.where(valid, ids, capacity).ravel()
    out = jnp.zeros((capacity + 1, 1 + nb), jnp.float32).at[idx].add(
        vals, mode="drop")[:capacity]
    return out[:, 0].astype(jnp.uint32), out[:, 1:], row_runs_max


def seg_reduce_and_remap_runlength(seg_clump, seg_post, band_planes,
                                   capacity: int, run_cap: int):
    """
    Device: the run-length segment reduction of
    :func:`seg_sizes_and_spectral_sums_runlength` PLUS the clump->post
    id remap, from ONE row compaction over the CLUMP image's runs.

    The fused pipelines need ``remap0[c] = post-single-pixel-elim id of
    clump c`` to seed the graph elimination. Building it as a full-image
    scatter (``iota.at[seg_clump.ravel()].set(seg_post.ravel())``) costs
    another H*W-index scatter. But every horizontal run of the CLUMP image is
    constant in BOTH ids (the single-pixel merge maps each clump
    wholesale: survivors keep their id, a singleton's one pixel — a
    length-1 run — carries its absorber's), so one gather at the clump
    run ends yields (clump id, post id, band cumsums) per run, and:

    - sizes/sums scatter-add keyed by the post id (grouping by clump
      runs instead of post runs only changes float accumulation order,
      and not even that below 2^24 where the sums are exact integers);
    - remap0 scatter-set keyed by the clump id (duplicates across a
      clump's runs all write the same post id, so write order is
      irrelevant).

    ``run_cap`` bounds the CLUMP image's runs per row — the very count
    dispatch #1 measures to seed the rl bucket, and an upper bound for
    the post image's (merges only remove transitions). Returns
    (sizes uint32 (capacity,), spect float32 (capacity, nBands),
    remap0 uint32 (capacity,), row_runs_max uint32) with the same
    overflow contract as seg_sizes_and_spectral_sums_runlength.
    Exactness gate: :func:`runlength_sums_ok`.
    """
    h, w = seg_clump.shape
    nb = len(band_planes)
    c_i = seg_clump.astype(jnp.int32)
    p_i = seg_post.astype(jnp.int32)
    nxt = jnp.concatenate(
        [c_i[:, 1:], jnp.full((h, 1), -1, jnp.int32)], axis=1)
    end = c_i != nxt
    row_runs_max = jnp.max(jnp.sum(end.astype(jnp.uint32), axis=1))

    posk = jnp.where(end, jnp.arange(w, dtype=jnp.int32)[None, :], w)
    posk = jax.lax.sort(posk, dimension=1)[:, :run_cap]   # (H, run_cap)
    valid = posk < w
    posc = jnp.minimum(posk, w - 1)

    cums = [jnp.cumsum(p.astype(jnp.int32), axis=1).ravel()
            for p in band_planes]
    tbl = jnp.stack([c_i.ravel(), p_i.ravel()] + cums)    # (2+nb, H*W)
    flat = (jnp.arange(h, dtype=jnp.int32)[:, None] * w + posc).ravel()
    g = tbl[:, flat].reshape(2 + nb, h, run_cap)
    cids = g[0]                                           # (H, run_cap)
    pids = g[1]
    cum_end = g[2:]                                       # (nb, H, run_cap)

    prev_cum = jnp.concatenate(
        [jnp.zeros((nb, h, 1), jnp.int32), cum_end[:, :, :-1]], axis=2)
    prev_pos = jnp.concatenate(
        [jnp.full((h, 1), -1, jnp.int32), posc[:, :-1]], axis=1)
    count = (posc - prev_pos).astype(jnp.float32)[None]   # (1, H, run_cap)
    sums = (cum_end - prev_cum).astype(jnp.float32)       # (nb, H, run_cap)
    vals = jnp.concatenate([count, sums]).reshape(1 + nb, -1).T

    idx_p = jnp.where(valid, pids, capacity).ravel()
    out = jnp.zeros((capacity + 1, 1 + nb), jnp.float32).at[idx_p].add(
        vals, mode="drop")[:capacity]
    idx_c = jnp.where(valid, cids, capacity).ravel()
    remap0 = jnp.arange(capacity + 1, dtype=jnp.uint32).at[idx_c].set(
        jnp.where(valid, pids, 0).astype(jnp.uint32).ravel(),
        mode="drop")[:capacity]
    return (out[:, 0].astype(jnp.uint32), out[:, 1:], remap0,
            row_runs_max)


def relabel_subtract(seg_size, min_seg_id: int = MINSEGID):
    """
    Device: per-ID decrement making labels contiguous. For each ID k, the
    number of unused (zero-count) IDs in [min_seg_id, k-1]
    (reference: shepseg.py:739-777).
    """
    capacity = seg_size.shape[0]
    ids = jnp.arange(capacity, dtype=jnp.uint32)
    z = ((seg_size == 0) & (ids >= min_seg_id)).astype(jnp.uint32)
    sub = jnp.cumsum(z)
    return jnp.concatenate([jnp.zeros(1, jnp.uint32), sub[:-1]])


def relabel(seg, seg_size, min_seg_id: int = MINSEGID):
    """Device: apply :func:`relabel_subtract` to a segment image."""
    subtract = relabel_subtract(seg_size, min_seg_id)
    return (seg - subtract[seg.astype(jnp.int32)]).astype(jnp.uint32)


# ---------------------------------------------------------------- host API


def makeSegSize(seg, maxSegId=None):
    """
    Host API matching the reference (reference: shepseg.py:544-569):
    array of pixel counts indexed by segment ID, length maxSegId+1.
    """
    seg = np.asarray(seg)
    if maxSegId is None:
        maxSegId = int(seg.max()) if seg.size else 0
    counts = np.bincount(seg.ravel().astype(np.int64),
                         minlength=maxSegId + 1)
    return counts.astype(np.uint32)


def buildSegmentSpectra(seg, img, maxSegId):
    """
    Host API matching the reference (reference: shepseg.py:780-813):
    (maxSegId+1, nBands) float32 per-segment band sums.
    """
    out = np.asarray(seg_spectral_sums(jnp.asarray(seg), jnp.asarray(img),
                                       int(maxSegId) + 1))
    return out.astype(np.float32)


def relabelSegments(seg, segSize, minSegId):
    """
    Host API matching the reference (reference: shepseg.py:739-777).
    Modifies ``seg`` in place (numpy array) to have contiguous labels.
    """
    sub = np.asarray(relabel_subtract(jnp.asarray(segSize), int(minSegId)))
    seg[...] = (seg - sub[seg]).astype(SegIdType)


class SegmentLocations:
    """
    CSR index of per-segment pixel locations — the static-shape
    replacement for the reference's ``RowColArray`` typed dict
    (reference: shepseg.py:816-915). Built once with a stable sort; lookup
    is O(1) slicing. Pixel order within a segment is row-major scan order,
    matching the order the reference's ``makeSegmentLocations`` appends in.
    """

    def __init__(self, seg):
        seg = np.asarray(seg)
        self.shape = seg.shape
        flat = seg.ravel()
        order = np.argsort(flat, kind="stable")
        sorted_ids = flat[order]
        self.maxSegId = int(flat.max()) if flat.size else 0
        # starts[k] .. starts[k+1] are the sorted positions of segment k
        self.starts = np.searchsorted(
            sorted_ids, np.arange(self.maxSegId + 2, dtype=np.int64))
        self.order = order

    def __contains__(self, segId):
        segId = int(segId)
        return (0 <= segId <= self.maxSegId and
                self.starts[segId + 1] > self.starts[segId])

    def getSegmentIndices(self, segId):
        """Return (rows, cols) arrays for the given segment ID."""
        segId = int(segId)
        sl = self.order[self.starts[segId]:self.starts[segId + 1]]
        w = self.shape[1]
        return (sl // w).astype(np.uint32), (sl % w).astype(np.uint32)

    def rowcols(self, segId):
        """Return an (n, 2) array of (row, col) pixel coordinates."""
        r, c = self.getSegmentIndices(segId)
        return np.stack([r, c], axis=1)


def makeSegmentLocations(seg, segSize=None):
    """
    Host API matching the reference name (reference: shepseg.py:880-915).
    ``segSize`` is accepted for signature compatibility but not needed.
    """
    return SegmentLocations(seg)
