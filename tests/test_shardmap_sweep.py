"""Differential sweep + full-driver parity for the row-sharded
segmentation pipeline (parallel/shardmap_seg) vs the single-chip
program.

Split from test_shardmap_seg.py so the process-sharded runner
(scripts/partest.py) can schedule the suite's heaviest modules on
separate workers.
"""

import numpy as np
import pytest

from pyshepseg_tpu.parallel import shardmap_seg

from test_shardmap_seg import make_image, run_single_chip


@pytest.mark.parametrize("seed,fourconn,withnull,maxdiff", [
    (101, True, False, 1e9),
    (102, False, False, 1e9),
    (103, True, True, 1e9),
    (104, False, True, 200.0),
    (105, True, False, 120.0),
    (106, False, False, 250.0),
])
def test_sharded_differential_sweep(seed, fourconn, withnull, maxdiff):
    """Multi-seed sweep of the row-sharded pipeline against the
    single-chip program: random Voronoi content, both connectivities,
    nulls, bounded and unbounded spectral limits. The shape is held
    fixed so the sweep reuses two compiled program pairs."""
    rng = np.random.default_rng(seed)
    nullval = 7777 if withnull else None
    img, centers = make_image(96, 64, 3, 25, rng, nullval=nullval,
                              nullmargin=3 if withnull else 0)
    want, want_max = run_single_chip(img, centers, nullval, maxdiff,
                                     10, fourconn)
    got, got_max = shardmap_seg.segment_image_sharded(
        img, centers, imgNullVal=nullval, maxSpectralDiff=maxdiff,
        minSegmentSize=10, fourConnected=fourconn)
    np.testing.assert_array_equal(want, got)
    assert want_max == got_max


def test_sharded_driver_matches_single_chip_driver(rng):
    """doShepherdSegmentationSharded vs shepseg.doShepherdSegmentation:
    the full drop-in driver incl. the k-means fit (fixed init -> both
    drivers fit identical centres) and the SegmentationResult fields."""
    from pyshepseg_tpu import shepseg
    img, _ = make_image(96, 64, 3, 18, rng)
    want = shepseg.doShepherdSegmentation(
        img, numClusters=12, clusterSubsamplePcnt=100, minSegmentSize=10,
        maxSpectralDiff='auto', fourConnected=True, fixedKMeansInit=True)
    got = shardmap_seg.doShepherdSegmentationSharded(
        img, numClusters=12, clusterSubsamplePcnt=100, minSegmentSize=10,
        maxSpectralDiff='auto', fourConnected=True, fixedKMeansInit=True)
    np.testing.assert_array_equal(want.segimg, got.segimg)
    assert want.maxSpectralDiff == got.maxSpectralDiff
    assert want.singlePixelsEliminated == got.singlePixelsEliminated
    assert want.smallSegmentsEliminated == got.smallSegmentsEliminated
    assert want.elimPasses == got.elimPasses
