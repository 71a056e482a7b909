"""
CONC_MESH: tile-parallel segmentation across the cards of a device mesh.

This is the mesh-based replacement for the reference's worker-pool
concurrency (reference: pyshepseg/tiling.py CONC_THREADS/CONC_FARGATE):
instead of scheduling Python workers, tiles are batched and sharded over a
``jax.sharding.Mesh`` — one tile per chip per step — and each chip runs the
fully-fused pipeline (parallel.pipeline.segment_tile) with no host
round-trips between stages. Tiles are independent SPMD work; no collective
traffic is needed during segmentation, so scaling is linear in chips, and
the stitch/recode phase consumes results in row-major order exactly as the
reference does.
"""

import os
import tempfile
import shutil

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import tiling as _tiling
from .. import shepseg
from .pipeline import (eliminate_tiles_fused,
                       eliminate_tiles_phase1, eliminate_tiles_phase2)
from ..ops.elim_small import round_capacity


def segment_tile_batch(batch_j, centers, nullVal, maxDiff, minSegmentSize,
                       fourConnected, hasNull, segCapacity=None,
                       specBuckets=None):
    """
    Segment one sharded batch of tiles. Steady state (``specBuckets``
    from an earlier batch of this scene): the whole batch runs as ONE
    speculative fused program with NO host sync beyond the result fetch
    (parallel.pipeline.segment_tiles_one_shot); a tripped overflow flag
    discards it and re-runs the measured flow. First batch (or after an
    overflow): cluster+clump+edges dispatch, ONE batch-wide scalar sync
    to bucket the segment capacity (max clump count) and the edge
    capacity (max measured clump-adjacency count — a contraction bound),
    then the FUSED elimination dispatch.

    Returns (segs numpy (B, H, W), buckets) where ``buckets`` is the
    (capacity, eCap, bCap, rCap, rlCap) tuple to speculate with next
    batch.

    Shared by the CONC_MESH backend and the per-host shard path of the
    DCN backend.
    """
    from .pipeline import (cluster_clump_edges_tiles,
                           segment_tiles_one_shot)
    from .. import shepseg as _shepseg

    width = int(batch_j.shape[-1])
    if specBuckets is not None:
        capacity, eCap, bCap, rCap, rlCap = specBuckets
        segsS, scalars = segment_tiles_one_shot(
            batch_j, centers, nullVal, maxDiff,
            min_seg_size=minSegmentSize, four_connected=fourConnected,
            has_null=hasNull, capacity=capacity, e_cap=eCap, b_cap=bCap,
            r_cap=rCap,
            rl_cap=_shepseg._rlCapEffective(rlCap, batch_j.dtype, width))
        scalars = np.asarray(scalars)
        if not scalars[:, 7].any():
            buckets = (round_capacity(int(scalars[:, 0].max()) + 1),
                       _shepseg._edgeCapForCount(int(scalars[:, 1].max())),
                       _shepseg._boundaryCapForCount(
                           int(scalars[:, 8].max())),
                       _shepseg._rowCapForCount(int(scalars[:, 9].max())),
                       _shepseg._runCapForCount(
                           int(scalars[:, 10].max())))
            return np.asarray(segsS), buckets

    segs, a, b, first, sc0 = cluster_clump_edges_tiles(
        batch_j, centers, nullVal,
        four_connected=fourConnected, has_null=hasNull)
    sc0 = np.asarray(sc0)
    capacity = segCapacity or round_capacity(int(sc0[:, 0].max()) + 1)
    eCap = _shepseg._edgeCapForCount(int(sc0[:, 1].max()))
    bCap = _shepseg._boundaryCapForCount(int(sc0[:, 2].max()))
    rCap = _shepseg._rowCapForCount(int(sc0[:, 3].max()))
    rlCap = _shepseg._runCapForCount(int(sc0[:, 4].max()))
    buckets = (capacity, eCap, bCap, rCap, rlCap)
    segsF, scalars = eliminate_tiles_fused(
        batch_j, segs, a, b, first, maxDiff,
        min_seg_size=minSegmentSize,
        four_connected=fourConnected, capacity=capacity, e_cap=eCap,
        rl_cap=_shepseg._rlCapEffective(rlCap, batch_j.dtype, width))
    scalars = np.asarray(scalars)
    if not scalars[:, 2].any():
        return np.asarray(segsF), buckets
    # fallback: measured edge capacity (adjacency beyond the planarity
    # bound — not possible for true grid adjacency, but stay safe)
    segs2, sizes, spects, ea, eb, first, sc1 = eliminate_tiles_phase1(
        batch_j, segs, four_connected=fourConnected, capacity=capacity)
    eCap = round_capacity(int(np.asarray(sc1)[:, 1].max()) + 1)
    segs2, _ = eliminate_tiles_phase2(
        segs2, sizes, spects, ea, eb, first, maxDiff,
        min_seg_size=minSegmentSize, e_cap=eCap)
    return np.asarray(segs2), (capacity, eCap, bCap, rCap, rlCap)


class SegMeshMgr(_tiling.SegmentationConcurrencyMgr):
    """
    Segment tiles in batches across all local devices of a mesh.

    Extra knobs (set as attributes after construction, or leave defaults):
    - ``meshDevices``: devices to use (default jax.devices())
    - ``segCapacity``: static per-tile segment capacity (default:
      bucketed per batch from the measured max clump count)
    """
    concurrencyType = _tiling.CONC_MESH

    meshDevices = None
    segCapacity = None

    def specificChecks(self):
        # numWorkers is meaningless here; the device count rules
        pass

    def _resolveMaxSpectralDiff(self):
        self.maxSpectralDiff = shepseg.autoMaxSpectralDiff(
            self.kmeansObj, self.maxSpectralDiff, self.spectDistPcntile)

    def segmentAllTiles(self):
        from .. import io as rio

        devices = self.meshDevices or jax.devices()
        mesh = Mesh(np.array(devices), ("data",))
        nDev = len(devices)
        # vmap-batch several tiles per device per dispatch: amortizes the
        # capacity sync's host round trip and the fused programs' per-op
        # overheads across the batch (see SegmentationConcurrencyConfig)
        tilesPerDevice = getattr(self.concurrencyCfg, 'tilesPerDevice', 1)
        chunkSize = nDev * tilesPerDevice

        self._resolveMaxSpectralDiff()
        hasNull = self.imgNullVal is not None
        maxDiff = jnp.float32(self.maxSpectralDiff)
        centers = jnp.asarray(np.asarray(
            self.kmeansObj.cluster_centers_, dtype=np.float32))

        self.tempDir = tempfile.mkdtemp()
        self.tileFilenames = {}
        inDs = rio.open(self.infile)
        # null scalar in the imagery's native dtype (a float32 round
        # trip would alias large integer null values — ops/kmeans
        # null_scalar)
        from ..ops.kmeans import null_scalar
        imgDtype = inDs.GetRasterBand(
            self.bandNumbers[0]).ReadAsArray(0, 0, 1, 1).dtype
        nullVal = null_scalar(self.imgNullVal if hasNull else 0, imgDtype)
        # Whole-scene HBM cache: upload once, slice per-tile on device;
        # the sharded device_put below then distributes slices over NVLink
        # instead of re-uploading every overlapping tile from the host.
        self.maybeBuildSceneCache(inDs)

        colRowList = sorted(self.tileInfo.tiles.keys(),
                            key=lambda x: (x[1], x[0]))

        # Group tiles by shape so each group compiles one SPMD program
        groups = {}
        for colRow in colRowList:
            (xpos, ypos, xsize, ysize) = self.tileInfo.getTile(*colRow)
            groups.setdefault((ysize, xsize), []).append(colRow)

        for (ysize, xsize), members in groups.items():
            sharding = NamedSharding(mesh, P("data"))
            specBuckets = None   # capacity buckets are per tile shape

            for start in range(0, len(members), chunkSize):
                chunk = members[start:start + chunkSize]
                with self.timings.interval('reading'):
                    imgs = []
                    for (col, row) in chunk:
                        if self.sceneCache is not None:
                            imgs.append(self.sceneCache.getTile(
                                *self.tileInfo.getTile(col, row)))
                        else:
                            (xpos, ypos, xs, ys) = self.tileInfo.getTile(
                                col, row)
                            bands = [inDs.GetRasterBand(b).ReadAsArray(
                                xpos, ypos, xs, ys)
                                for b in self.bandNumbers]
                            imgs.append(np.array(bands))  # native dtype: exact null compare
                    # pad the batch so every device gets a full load
                    while len(imgs) < chunkSize:
                        imgs.append(imgs[-1])
                    batch = (jnp.stack(imgs) if self.sceneCache is not None
                             else np.stack(imgs))

                with self.timings.interval('segmentation'):
                    # First batch: two dispatches + ONE batch-wide
                    # capacity sync. Every later batch of the scene:
                    # ONE speculative fused program with the learned
                    # buckets and NO sync beyond the result fetch.
                    batch_j = jax.device_put(batch, sharding)
                    segs, specBuckets = segment_tile_batch(
                        batch_j, centers, nullVal, maxDiff,
                        self.minSegmentSize, self.fourConnected, hasNull,
                        self.segCapacity, specBuckets=specBuckets)

                for i, (col, row) in enumerate(chunk):
                    filename = os.path.join(
                        self.tempDir, 'tile_{}_{}.npy'.format(col, row))
                    np.save(filename,
                            segs[i].astype(shepseg.SegIdType))
                    self.tileFilenames[(col, row)] = filename

        with self.timings.interval('stitchtiles'):
            self.stitchTiles()

        shutil.rmtree(self.tempDir)

    # temp-file plumbing (same shape as the serial manager's)
    def overlapCacheFilename(self, overlapCacheKey):
        return os.path.join(self.tempDir, f"{overlapCacheKey}.npy")

    def saveOverlap(self, overlapCacheKey, overlapData):
        np.save(self.overlapCacheFilename(overlapCacheKey), overlapData)

    def loadOverlap(self, overlapCacheKey):
        return np.load(self.overlapCacheFilename(overlapCacheKey))

    def getTileSegmentation(self, col, row):
        return np.load(self.tileFilenames[(col, row)])

    def checkWorkerExceptions(self):
        """No async workers; exceptions raise inline."""
