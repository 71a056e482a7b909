"""Reference kernel compat layer (sequential host kernels) vs the
device drivers.

Split from test_shepseg.py so the process-sharded runner
(scripts/partest.py) can schedule the suite's heaviest modules on
separate workers.
"""

import numpy as np
import pytest

from pyshepseg_tpu import shepseg

from test_shepseg import _voronoi_image


def _run_reference_small_elim(seg, img, maxSegId, minSegSize,
                              maxSpectralDiff, fourConnected):
    """The reference's eliminateSmallSegments driven through the compat
    kernels, with the reference's exact loop structure
    (reference: shepseg.py:918-1000)."""
    from pyshepseg_tpu.shepseg import (
        buildSegmentSpectra, makeSegSize, makeSegmentLocationsDict,
        findMergeSegment, doMerge, relabelSegments, SEGNULLVAL, MINSEGID,
        SegIdType)
    spectSum = buildSegmentSpectra(seg, img, maxSegId)
    segSize = makeSegSize(seg, maxSegId)
    segLoc = makeSegmentLocationsDict(seg, segSize)
    mergeSeg = np.full(maxSegId + 1, SEGNULLVAL, dtype=SegIdType)
    segIdRange = np.arange(MINSEGID, maxSegId + 1, dtype=SegIdType)
    numElim = 0
    for targetSize in range(1, minSegSize):
        countTargetSize = np.count_nonzero(segSize == targetSize)
        prevCount = -1
        numPasses = 0
        while countTargetSize != prevCount and numPasses < 10:
            prevCount = countTargetSize
            for segId in segIdRange:
                if segSize[segId] == targetSize:
                    mergeSeg[segId] = findMergeSegment(
                        segId, segLoc, seg, segSize, spectSum,
                        maxSpectralDiff, fourConnected)
            for segId in segIdRange:
                if mergeSeg[segId] != SEGNULLVAL:
                    doMerge(segId, mergeSeg[segId], seg, segSize, segLoc,
                            spectSum)
                    mergeSeg[segId] = SEGNULLVAL
                    numElim += 1
            countTargetSize = np.count_nonzero(segSize == targetSize)
            numPasses += 1
    relabelSegments(seg, segSize, MINSEGID)
    return numElim


def test_compat_single_pixel_kernels_match_device_driver(rng):
    """mergeSinglePixels / findNearestNeighbourPixel (sequential compat
    kernels) run to fixpoint must match the device
    eliminateSinglePixels driver."""
    from pyshepseg_tpu.shepseg import (makeSegSize, relabelSegments,
                                       eliminateSinglePixels, MINSEGID)
    img, _ = _voronoi_image(rng, shape=(48, 48), ncentres=9, noise=0)
    res = shepseg.doShepherdSegmentation(
        img, numClusters=9, clusterSubsamplePcnt=100, minSegmentSize=1,
        maxSpectralDiff=None, fourConnected=True, fixedKMeansInit=True)
    # re-clump to get a pre-elimination label image with singles
    from pyshepseg_tpu.ops.clump import clump
    clusters = shepseg.applySpectralClusters(res.kmeans, img, None)
    segA, maxSegId = clump(clusters, 0, fourConnected=True)
    segA = segA.astype(np.uint32)
    segB = segA.copy()

    # compat path: find-all-then-apply passes to fixpoint, then relabel
    sizeA = makeSegSize(segA, maxSegId)
    segToElim = np.empty((3, maxSegId + 1), dtype=np.int64)
    while shepseg.mergeSinglePixels(img, segA, sizeA, segToElim, True):
        pass
    relabelSegments(segA, sizeA, MINSEGID)

    # device path
    sizeB = makeSegSize(segB, maxSegId)
    eliminateSinglePixels(img, segB, sizeB, fourConnected=True)
    np.testing.assert_array_equal(segA, segB)


def test_compat_merge_kernels_match_device_driver(rng):
    """findMergeSegment / doMerge driven through the reference's exact
    sequential loop must match the device eliminateSmallSegments on a
    tie-free image."""
    from pyshepseg_tpu.shepseg import (makeSegSize, eliminateSinglePixels,
                                       eliminateSmallSegments)
    img, _ = _voronoi_image(rng, shape=(48, 48), ncentres=9, noise=0)
    res = shepseg.doShepherdSegmentation(
        img, numClusters=9, clusterSubsamplePcnt=100, minSegmentSize=1,
        maxSpectralDiff=None, fourConnected=True, fixedKMeansInit=True)
    from pyshepseg_tpu.ops.clump import clump
    clusters = shepseg.applySpectralClusters(res.kmeans, img, None)
    seg0, maxSegId = clump(clusters, 0, fourConnected=True)
    seg0 = seg0.astype(np.uint32)
    size0 = makeSegSize(seg0, maxSegId)
    eliminateSinglePixels(img, seg0, size0, fourConnected=True)
    maxSegId = int(seg0.max())

    segA = seg0.copy()
    segB = seg0.copy()
    nA = _run_reference_small_elim(segA, img, maxSegId, 8, 1e9, True)
    nB = eliminateSmallSegments(segB, img, maxSegId, 8, 1e9,
                                fourConnected=True)
    assert nA == nB
    np.testing.assert_array_equal(segA, segB)


@pytest.mark.parametrize("seed,four", [(1, True), (2, False), (3, True)])
def test_compat_merge_kernels_multiseed(seed, four):
    """Multi-seed differential sweep: the compat sequential loop vs the
    device graph elimination, 4- and 8-connected."""
    from pyshepseg_tpu.shepseg import (makeSegSize, eliminateSinglePixels,
                                       eliminateSmallSegments)
    from pyshepseg_tpu.ops.clump import clump
    rng = np.random.default_rng(seed)
    img, _ = _voronoi_image(rng, shape=(40, 40), ncentres=7, noise=0)
    res = shepseg.doShepherdSegmentation(
        img, numClusters=7, clusterSubsamplePcnt=100, minSegmentSize=1,
        maxSpectralDiff=None, fourConnected=four, fixedKMeansInit=True)
    clusters = shepseg.applySpectralClusters(res.kmeans, img, None)
    seg0, maxSegId = clump(clusters, 0, fourConnected=four)
    seg0 = seg0.astype(np.uint32)
    size0 = makeSegSize(seg0, maxSegId)
    eliminateSinglePixels(img, seg0, size0, fourConnected=four)
    maxSegId = int(seg0.max())

    segA = seg0.copy()
    segB = seg0.copy()
    nA = _run_reference_small_elim(segA, img, maxSegId, 6, 1e9, four)
    nB = eliminateSmallSegments(segB, img, maxSegId, 6, 1e9,
                                fourConnected=four)
    assert nA == nB
    np.testing.assert_array_equal(segA, segB)


def test_find_merge_segment_at_image_corner():
    """Regression: segment pixels at row/col 0 are uint32 in the
    location list; the neighbourhood walk must not wrap (it silently
    skipped the whole 3x3 window before the int cast)."""
    from pyshepseg_tpu.shepseg import (makeSegSize, buildSegmentSpectra,
                                       makeSegmentLocationsDict,
                                       findMergeSegment, SEGNULLVAL)
    seg = np.full((4, 4), 2, dtype=np.uint32)
    seg[0, 0] = 1
    seg[0, 1] = 1
    img = np.full((2, 4, 4), 100, dtype=np.int64)
    segSize = makeSegSize(seg, 2)
    spectSum = buildSegmentSpectra(seg, img, 2)
    segLoc = makeSegmentLocationsDict(seg, segSize)
    got = findMergeSegment(np.uint32(1), segLoc, seg, segSize, spectSum,
                           1e9, True)
    assert got == 2 and got != SEGNULLVAL
