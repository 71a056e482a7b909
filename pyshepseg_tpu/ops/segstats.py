"""
Device kernels for the per-segment statistics engine.

The stats pass's dominant per-tile cost is compacting (segment, value)
pixel pairs into sorted run-length histograms
(reference accumulateSegDict, pyshepseg/tilingstats.py:466-515 — a numba
dict-of-dicts). Here the compaction runs on the device as a two-key sort plus a
run-length scatter: sort the tile's pixel pairs by (segId, value), flag
run boundaries, and scatter the runs into fixed-capacity arrays. The
output runs are identical — same order, same counts — to the host
compactTile, so the streaming accumulator, completeness accounting, and
every statistic downstream are bit-for-bit unchanged whichever engine
produced the runs.

Shapes are static via two buckets: tiles are flattened and padded with
null pixels to a power-of-two pixel bucket, and the run arrays use a
power-of-two run bucket picked from the measured run count (one scalar
sync per tile, the same pattern as the elimination kernels). NoData
pixels are kept as ordinary runs on device and split out on the host, so
no per-segment-capacity arrays ever cross the link.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .constants import SEGNULLVAL
from .elim_small import round_capacity


# imagery dtypes whose values always fit the device's int32 compute type
_DEVICE_OK_DTYPES = (np.int8, np.uint8, np.int16, np.uint16, np.int32)


def deviceCompactSupported(dtype):
    """Can tiles of this imagery dtype be compacted on device? (int64 /
    uint32 rasters may hold values outside int32 — use the host path)."""
    return any(np.issubdtype(dtype, d) for d in _DEVICE_OK_DTYPES)


def _runs_tail(s, v, valid_s, first):
    """
    Shared tail of dispatch #1: compact the (segId, value, count) runs
    to the FRONT of full-length device arrays. Returns the state tuple
    ``(run_rank, run_seg, run_val, run_cnt, n_runs)`` — the first four
    full-length (junk past n_runs, flagged by run_rank == n), the last
    the scalar run count that picks dispatch #2's static slice bucket.

    NO SCATTERS: run lengths come from a cummax of the run-start
    positions (count at a run's LAST element = index - first-position
    + 1), and the compaction is one more single-key sort moving the
    last-of-run entries to the front in run order. (Not yet re-measured
    against a scatter formulation on a GPU.)
    """
    n = s.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    runpos = jnp.cumsum(first.astype(jnp.int32)) - 1
    n_runs = jnp.sum(first.astype(jnp.uint32))
    last = valid_s & ((idx == n - 1) |
                      (s != jnp.roll(s, -1)) | (v != jnp.roll(v, -1)))
    # position of the current run's first element, carried forward
    firstpos = jax.lax.cummax(jnp.where(first, idx, 0))
    cnt = idx - firstpos + 1
    key2 = jnp.where(last, runpos, jnp.int32(n))
    return jax.lax.sort((key2, s, v, cnt), num_keys=1) + (n_runs,)


@jax.jit
def _sort_pairs(seg_flat, val_flat):
    """
    Device dispatch #1: lexicographic sort of non-null (segId, value)
    pixel pairs (null pixels sort to the end) plus the in-dispatch run
    compaction (see _runs_tail). Returns the compacted-state tuple.
    """
    valid = seg_flat != SEGNULLVAL
    big = jnp.uint32(0xFFFFFFFF)
    s = jnp.where(valid, seg_flat, big)
    v = jnp.where(valid, val_flat, jnp.int32(0x7FFFFFFF))
    s, v = jax.lax.sort((s, v), num_keys=2)
    valid_s = s != big
    n = s.shape[0]
    first = valid_s & ((jnp.arange(n) == 0) |
                       (s != jnp.roll(s, 1)) | (v != jnp.roll(v, 1)))
    return _runs_tail(s, v, valid_s, first)


_PACK_BIAS = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 0,
              np.dtype(np.int8): 128, np.dtype(np.int16): 32768}


def packBias(dtype, numSeg):
    """Bias for the PACKED single-key sort, or None when packing does
    not apply. When the imagery dtype fits 16 bits and segment IDs fit
    below 0xFFFF (reserved for the null sentinel), the (segId, value)
    pair packs into ONE uint32 key — a single-key sort over half the
    key bytes. It also lets the scene-resident feed keep 16-bit imagery
    in its NATIVE dtype on device (half the device memory and upload). The bias maps signed values onto
    unsigned order (order-preserving), so run order matches the
    two-key sort exactly."""
    if numSeg >= 0xFFFF:
        return None
    return _PACK_BIAS.get(np.dtype(dtype))


@functools.partial(jax.jit, static_argnames=("bias",))
def _sort_pairs_packed(seg_flat, val_flat, bias: int):
    """_sort_pairs via one packed uint32 key: (segId << 16) | biased
    value. Identical outputs (same run order — the biased value keeps
    numeric order; same flags and counts) for inputs satisfying
    packBias's conditions."""
    valid = seg_flat != SEGNULLVAL
    v_u = (val_flat.astype(jnp.int32) + jnp.int32(bias)).astype(jnp.uint32)
    key = jnp.where(valid, (seg_flat << 16) | v_u,
                    jnp.uint32(0xFFFFFFFF))
    key = jax.lax.sort(key)
    valid_s = key != jnp.uint32(0xFFFFFFFF)
    s = jnp.where(valid_s, key >> 16, jnp.uint32(0xFFFFFFFF))
    v = jnp.where(valid_s,
                  (key & jnp.uint32(0xFFFF)).astype(jnp.int32) -
                  jnp.int32(bias),
                  jnp.int32(0x7FFFFFFF))
    n = key.shape[0]
    first = valid_s & ((jnp.arange(n) == 0) | (key != jnp.roll(key, 1)))
    return _runs_tail(s, v, valid_s, first)


def _sorted_state(seg_flat, val_flat, bias):
    """Dispatch to the packed single-key sort when ``bias`` is set."""
    if bias is None:
        return _sort_pairs(seg_flat, val_flat)
    return _sort_pairs_packed(seg_flat, val_flat, bias=bias)


def _compact_runs(run_rank, run_seg, run_val, run_cnt, r_cap: int):
    """
    Device dispatch #2 (static r_cap bucketed from the measured run
    count): slice the front-compacted runs (see _runs_tail) down to
    (r_cap,) arrays, zeroing the junk past the live runs. Runs come out
    in sorted (segId, value) order. Trivial — all the compaction work
    happens inside dispatch #1 now.
    """
    n = run_rank.shape[0]
    live = run_rank[:r_cap] < n
    return (jnp.where(live, run_seg[:r_cap], jnp.uint32(0)),
            jnp.where(live, run_val[:r_cap], jnp.int32(0)),
            jnp.where(live, run_cnt[:r_cap], jnp.int32(0)))


_compact_runs_jit = jax.jit(_compact_runs, static_argnames=("r_cap",))


def _finish_runs(sorted_state, imgNullVal, numSeg,
                 imageValueType=np.int64):
    """Shared tail: bucket the measured run count, slice the compacted
    runs, download, and split out the nodata runs host-side. Returns the
    compactTile-format tuple or None for an all-null window."""
    rank, seg_c, val_c, cnt_c, n_runs = sorted_state
    nRuns = int(n_runs)  # scalar sync picks the run bucket
    if nRuns == 0:
        return None
    rCap = round_capacity(nRuns)
    run_seg, run_val, run_cnt = _compact_runs_jit(
        rank, seg_c, val_c, cnt_c, r_cap=rCap)

    runSeg = np.asarray(run_seg)[:nRuns].astype(np.int64)
    runVal = np.asarray(run_val)[:nRuns].astype(imageValueType)
    runCnt = np.asarray(run_cnt)[:nRuns].astype(np.int64)

    seen = np.bincount(runSeg, weights=runCnt,
                       minlength=numSeg).astype(np.int64)[:numSeg]
    noData = None
    if imgNullVal is not None:
        isNull = runVal == imageValueType(imgNullVal)
        if isNull.any():
            noData = np.bincount(
                runSeg[isNull], weights=runCnt[isNull],
                minlength=numSeg).astype(np.int64)[:numSeg]
        keep = ~isNull
        runSeg, runVal, runCnt = runSeg[keep], runVal[keep], runCnt[keep]
    return (seen, noData, runSeg, runVal, runCnt)


def compactTileDevice(tileSegments, tileImageData, imgNullVal, numSeg,
                      imageValueType=np.int64):
    """
    Device equivalent of tilingstats.compactTile: returns
    (seenCounts, noDataCounts-or-None, runSegIds, runValues, runCounts)
    with runs sorted by (segId, value), or None for an all-null tile —
    identical output to the host path for any imagery whose dtype passes
    deviceCompactSupported.
    """
    bias = packBias(tileImageData.dtype, numSeg)
    seg_flat = np.ascontiguousarray(tileSegments).ravel().astype(np.uint32)
    val_flat = np.ascontiguousarray(tileImageData).ravel().astype(np.int32)
    # pad to a power-of-two pixel bucket with null pixels, so every tile
    # shape in the stats grid shares a handful of compiled programs
    n = seg_flat.size
    bucket = round_capacity(n)
    if bucket > n:
        seg_flat = np.pad(seg_flat, (0, bucket - n))
        val_flat = np.pad(val_flat, (0, bucket - n))

    state = _sorted_state(jnp.asarray(seg_flat), jnp.asarray(val_flat),
                          bias)
    return _finish_runs(state, imgNullVal, numSeg, imageValueType)


# ------------------------------------------ scene-resident device feed
#
# Per-tile host->device uploads dominate the device engine's cost on any
# link (and serialize against the compaction). When the whole scene fits
# HBM, upload the segmentation and the requested bands ONCE and cut each
# stats window out on device with dynamic_slice — the host then only
# receives the (small) compacted runs per window.


@functools.partial(jax.jit, static_argnames=("h", "w", "bucket", "bias"))
def _sort_pairs_window(segDev, valDev, top, left, h: int, w: int,
                       bucket: int, bias=None):
    """Slice one (h, w) window out of the device-resident scene, flatten,
    pad to the pixel bucket with null pixels, and sort its pairs. The
    scene bands stay in their NATIVE dtype on device (half the HBM and
    upload of an int32 copy for 16-bit imagery); values widen to int32
    here — or pack into one uint32 sort key when ``bias`` is set."""
    seg_t = jax.lax.dynamic_slice(segDev, (top, left), (h, w))
    val_t = jax.lax.dynamic_slice(valDev, (top, left), (h, w))
    seg_f = jnp.pad(seg_t.ravel().astype(jnp.uint32),
                    (0, bucket - h * w))
    val_f = jnp.pad(val_t.ravel().astype(jnp.int32),
                    (0, bucket - h * w))
    if bias is None:
        return _sort_pairs(seg_f, val_f)
    return _sort_pairs_packed(seg_f, val_f, bias=bias)


def compactSceneWindowDevice(segDev, valDev, window, imgNullVal, numSeg,
                             imageValueType=np.int64):
    """compactTileDevice, fed from device-resident whole-scene arrays
    (segDev uint32 (H, W), valDev native-integer-dtype (H, W));
    ``window`` is the stats grid's (xsize, ysize, leftPix, topLine)."""
    (xsize, ysize, leftPix, topLine) = window
    bucket = round_capacity(xsize * ysize)
    state = _sort_pairs_window(segDev, valDev, topLine, leftPix,
                               h=ysize, w=xsize, bucket=bucket,
                               bias=packBias(valDev.dtype, numSeg))
    return _finish_runs(state, imgNullVal, numSeg, imageValueType)


@functools.partial(jax.jit, static_argnames=("h", "w", "bucket", "bias"))
def _sort_pairs_window_batch(segDev, valsDev, top, left, h: int, w: int,
                             bucket: int, bias=None):
    """Batched window sort over the band axis of a device-resident
    (nBands, H, W) scene."""
    seg_t = jax.lax.dynamic_slice(segDev, (top, left), (h, w))
    seg_f = jnp.pad(seg_t.ravel().astype(jnp.uint32),
                    (0, bucket - h * w))

    def one(valPlane):
        val_t = jax.lax.dynamic_slice(valPlane, (top, left), (h, w))
        val_f = jnp.pad(val_t.ravel().astype(jnp.int32),
                        (0, bucket - h * w))
        if bias is None:
            return _sort_pairs(seg_f, val_f)
        return _sort_pairs_packed(seg_f, val_f, bias=bias)

    return jax.vmap(one)(valsDev)


def compactSceneWindowDeviceMultiBand(segDev, valsDev, window,
                                      imgNullVals, numSeg,
                                      imageValueType=np.int64):
    """Multi-band window compaction from device-resident scene arrays:
    one vmapped dispatch pair + ONE scalar sync for all bands. Output
    entries match compactTileDevice exactly."""
    (xsize, ysize, leftPix, topLine) = window
    bucket = round_capacity(xsize * ysize)
    rank, seg_c, val_c, cnt_c, n_runs = _sort_pairs_window_batch(
        segDev, valsDev, topLine, leftPix,
        h=ysize, w=xsize, bucket=bucket,
        bias=packBias(valsDev.dtype, numSeg))
    nRuns = np.asarray(n_runs)          # one sync for every band
    nb = valsDev.shape[0]
    if not nRuns.any():
        return [None] * nb
    rCap = round_capacity(int(nRuns.max()))
    run_seg, run_val, run_cnt = _compact_runs_batch(
        rank, seg_c, val_c, cnt_c, r_cap=rCap)
    run_seg = np.asarray(run_seg)
    run_val = np.asarray(run_val)
    run_cnt = np.asarray(run_cnt)
    return [_split_band_runs(run_seg[i], run_val[i], run_cnt[i],
                             int(nRuns[i]), imgNullVals[i], numSeg,
                             imageValueType)
            for i in range(nb)]


def _split_band_runs(run_seg, run_val, run_cnt, k, imgNullVal, numSeg,
                     imageValueType):
    """Host tail for one band of a batched compaction."""
    if k == 0:
        return None
    runSeg = run_seg[:k].astype(np.int64)
    runVal = run_val[:k].astype(imageValueType)
    runCnt = run_cnt[:k].astype(np.int64)
    seen = np.bincount(runSeg, weights=runCnt,
                       minlength=numSeg).astype(np.int64)[:numSeg]
    noData = None
    if imgNullVal is not None:
        isNull = runVal == imageValueType(imgNullVal)
        if isNull.any():
            noData = np.bincount(
                runSeg[isNull], weights=runCnt[isNull],
                minlength=numSeg).astype(np.int64)[:numSeg]
        keep = ~isNull
        runSeg, runVal, runCnt = runSeg[keep], runVal[keep], runCnt[keep]
    return (seen, noData, runSeg, runVal, runCnt)


_sort_pairs_batch = jax.jit(jax.vmap(_sort_pairs))


@functools.partial(jax.jit, static_argnames=("bias",))
def _sort_pairs_packed_batch(segB, valB, bias: int):
    return jax.vmap(
        lambda s, v: _sort_pairs_packed(s, v, bias=bias))(segB, valB)


def _compact_runs_batched_impl(rank, seg_c, val_c, cnt_c, r_cap):
    return jax.vmap(
        lambda a, b, c, d: _compact_runs(a, b, c, d, r_cap))(
            rank, seg_c, val_c, cnt_c)


_compact_runs_batch = jax.jit(_compact_runs_batched_impl,
                              static_argnames=("r_cap",))


def compactTileDeviceMultiBand(tileSegments, tileImageList, imgNullVals,
                               numSeg, imageValueType=np.int64):
    """
    One vmapped dispatch pair (+ ONE scalar sync) compacting ALL bands
    of one tile window: the (segId, value) sort runs batched over the
    band axis, with a shared run bucket from the max measured run count.
    Returns a list aligned with ``tileImageList`` whose entries match
    compactTileDevice's output exactly (including None for an all-null
    tile).
    """
    seg_flat = np.ascontiguousarray(tileSegments).ravel().astype(np.uint32)
    n = seg_flat.size
    bucket = round_capacity(n)
    if bucket > n:
        seg_flat = np.pad(seg_flat, (0, bucket - n))
    nb = len(tileImageList)
    segB = np.broadcast_to(seg_flat, (nb, bucket))
    valB = np.zeros((nb, bucket), np.int32)
    for i, tileImageData in enumerate(tileImageList):
        v = np.ascontiguousarray(tileImageData).ravel().astype(np.int32)
        valB[i, :n] = v

    # pack iff every band maps to the SAME bias (the vmapped program has
    # one static configuration)
    biases = {packBias(t.dtype, numSeg) for t in tileImageList}
    bias = biases.pop() if len(biases) == 1 else None
    if bias is None:
        rank, seg_c, val_c, cnt_c, n_runs = _sort_pairs_batch(
            jnp.asarray(segB), jnp.asarray(valB))
    else:
        rank, seg_c, val_c, cnt_c, n_runs = _sort_pairs_packed_batch(
            jnp.asarray(segB), jnp.asarray(valB), bias=bias)
    nRuns = np.asarray(n_runs)        # one sync for every band
    if not nRuns.any():
        return [None] * nb
    rCap = round_capacity(int(nRuns.max()))
    run_seg, run_val, run_cnt = _compact_runs_batch(
        rank, seg_c, val_c, cnt_c, r_cap=rCap)
    run_seg = np.asarray(run_seg)
    run_val = np.asarray(run_val)
    run_cnt = np.asarray(run_cnt)
    return [_split_band_runs(run_seg[i], run_val[i], run_cnt[i],
                             int(nRuns[i]), imgNullVals[i], numSeg,
                             imageValueType)
            for i in range(nb)]
