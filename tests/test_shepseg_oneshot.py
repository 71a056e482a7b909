"""Speculative one-shot dispatch path: bucket learning, overflow
fallbacks, and the capacity-policy unit tests.

Split from test_shepseg.py so the process-sharded runner
(scripts/partest.py) can schedule the suite's heaviest modules on
separate workers.
"""

import numpy as np

from pyshepseg_tpu import shepseg as ss

from test_shepseg import _voronoi_image


def test_one_shot_speculative_matches_measured(rng):
    """The second run of the same configuration takes the speculative
    one-dispatch path (no mid-pipeline sync) and must produce output
    identical to the measured two-dispatch first run, including with
    null pixels present."""
    img = (rng.integers(1, 40, size=(3, 96, 96)) * 8).astype(np.uint16)
    img[:, :5, :5] = 0   # null margin
    kwargs = dict(numClusters=8, minSegmentSize=6, maxSpectralDiff=None,
                  imgNullVal=0, fixedKMeansInit=True)
    assert not ss._SPEC_BUCKETS
    res1 = ss.doShepherdSegmentation(img, **kwargs)
    assert ss._SPEC_BUCKETS, "measured run did not record buckets"
    res2 = ss.doShepherdSegmentation(img, **kwargs)
    np.testing.assert_array_equal(res1.segimg, res2.segimg)
    assert res1.singlePixelsEliminated == res2.singlePixelsEliminated
    assert res1.smallSegmentsEliminated == res2.smallSegmentsEliminated
    assert res1.elimPasses == res2.elimPasses


def test_one_shot_overflow_falls_back_to_measured(rng, monkeypatch):
    """A speculative bucket too small for the data trips the one-shot
    overflow flag; the run must transparently fall back to the measured
    path and still produce the correct result."""
    img = (rng.integers(0, 30, size=(3, 128, 128)) * 8).astype(np.uint16)
    kwargs = dict(numClusters=8, minSegmentSize=5, maxSpectralDiff=None,
                  fixedKMeansInit=True)
    res1 = ss.doShepherdSegmentation(img, **kwargs)
    key = next(iter(ss._SPEC_BUCKETS))
    # plant a too-small edge bucket: the speckle image has far more than
    # 1024 unique adjacencies
    b = ss._SPEC_BUCKETS[key]
    ss._SPEC_BUCKETS[key] = b[:1] + (1024,) + b[2:]
    res2 = ss.doShepherdSegmentation(img, **kwargs)
    np.testing.assert_array_equal(res1.segimg, res2.segimg)
    assert res1.smallSegmentsEliminated == res2.smallSegmentsEliminated
    # the failed speculation must have been evicted and replaced by the
    # measured buckets
    assert ss._SPEC_BUCKETS[key][1] > 1024


def test_one_shot_boundary_bucket_overflow_falls_back(rng):
    """A too-small boundary-pair bucket (b_cap) drops adjacency pairs in
    the compacted pre-sort buffer; the overflow flag must catch it and
    the run must transparently fall back to the measured path."""
    img = (rng.integers(0, 30, size=(3, 128, 128)) * 8).astype(np.uint16)
    kwargs = dict(numClusters=8, minSegmentSize=5, maxSpectralDiff=None,
                  fixedKMeansInit=True)
    res1 = ss.doShepherdSegmentation(img, **kwargs)
    key = next(iter(ss._SPEC_BUCKETS))
    b = ss._SPEC_BUCKETS[key]
    assert b[2] > 2048, "speckle image should have >2048 boundary pairs"
    ss._SPEC_BUCKETS[key] = b[:2] + (2048,) + b[3:]
    res2 = ss.doShepherdSegmentation(img, **kwargs)
    np.testing.assert_array_equal(res1.segimg, res2.segimg)
    assert res1.smallSegmentsEliminated == res2.smallSegmentsEliminated
    assert ss._SPEC_BUCKETS[key][2] > 2048


def test_one_shot_row_bucket_overflow_falls_back(rng):
    """A too-small per-row bucket (r_cap) drops pairs in the row-compact
    slice; the overflow flag must catch it and the run must fall back to
    the measured path transparently."""
    img = (rng.integers(0, 30, size=(3, 128, 128)) * 8).astype(np.uint16)
    kwargs = dict(numClusters=8, minSegmentSize=5, maxSpectralDiff=None,
                  fixedKMeansInit=True)
    res1 = ss.doShepherdSegmentation(img, **kwargs)
    key = next(iter(ss._SPEC_BUCKETS))
    b = ss._SPEC_BUCKETS[key]
    assert b[3] > 16, "speckle rows should exceed 16 boundary pairs"
    ss._SPEC_BUCKETS[key] = b[:3] + (16,) + b[4:]
    res2 = ss.doShepherdSegmentation(img, **kwargs)
    np.testing.assert_array_equal(res1.segimg, res2.segimg)
    assert res1.smallSegmentsEliminated == res2.smallSegmentsEliminated
    assert ss._SPEC_BUCKETS[key][3] > 16


def test_one_shot_runlength_path_active_and_matches_measured(rng):
    """On coherent integer imagery wide enough for the gate (cap <= W/2),
    the one-shot dispatch must take the run-length reduction and still
    match the measured first run bit-for-bit."""
    img, _ = _voronoi_image(rng, shape=(128, 128), ncentres=8, noise=1)
    kwargs = dict(numClusters=8, clusterSubsamplePcnt=100,
                  minSegmentSize=10, maxSpectralDiff=None,
                  fixedKMeansInit=True)
    res1 = ss.doShepherdSegmentation(img, **kwargs)
    key = next(iter(ss._SPEC_BUCKETS))
    rlCap = ss._SPEC_BUCKETS[key][4]
    # smooth cells at 128 wide: few runs per row, so the gate is open
    assert ss._rlCapEffective(rlCap, img.dtype, 128) == rlCap > 0, \
        "run-length path should be active for this configuration"
    res2 = ss.doShepherdSegmentation(img, **kwargs)
    np.testing.assert_array_equal(res1.segimg, res2.segimg)
    assert res1.smallSegmentsEliminated == res2.smallSegmentsEliminated


def test_one_shot_runlength_bucket_overflow_falls_back(rng):
    """A planted too-small rl_cap drops runs in the run-length
    reduction; the overflow flag must catch it and the run must fall
    back to the measured path transparently."""
    # speckle at 128 wide: ~W runs per row, far above a 64 cap
    img = (rng.integers(0, 30, size=(3, 128, 128)) * 8).astype(np.uint16)
    kwargs = dict(numClusters=8, minSegmentSize=5, maxSpectralDiff=None,
                  fixedKMeansInit=True)
    res1 = ss.doShepherdSegmentation(img, **kwargs)
    key = next(iter(ss._SPEC_BUCKETS))
    b = ss._SPEC_BUCKETS[key]
    assert b[4] > 64, "speckle rows should exceed 64 runs"
    ss._SPEC_BUCKETS[key] = b[:4] + (64,)
    res2 = ss.doShepherdSegmentation(img, **kwargs)
    np.testing.assert_array_equal(res1.segimg, res2.segimg)
    assert res1.smallSegmentsEliminated == res2.smallSegmentsEliminated
    assert ss._SPEC_BUCKETS[key][4] > 64


def test_spec_bucket_policy_grow_only_on_alternation():
    """Alternating same-shape inputs of differing complexity must NOT
    thrash the speculative buckets: after the busy run ratchets them up,
    the quiet run leaves them in place (no overflow on the next busy
    run — each overflow costs a discarded dispatch + a measured rerun)."""
    key = ("policy-test",)
    ss._SPEC_BUCKETS.pop(key, None)
    ss._SPEC_SHRINK.pop(key, None)
    busy = (8192, 24576, 16384, 512)
    quiet = (2048, 6144, 4096, 128)
    ss._updateSpecBuckets(key, busy)
    assert ss._SPEC_BUCKETS[key] == busy
    for _ in range(2):
        ss._updateSpecBuckets(key, quiet)
        assert ss._SPEC_BUCKETS[key] == busy   # held (streak < threshold)
        ss._updateSpecBuckets(key, busy)
        assert ss._SPEC_BUCKETS[key] == busy
        assert key not in ss._SPEC_SHRINK      # busy run reset the streak


def test_spec_bucket_policy_shrinks_after_streak():
    """A sustained run of quieter tiles shrinks the buckets to the
    streak's element-wise max, so one pathologically busy first tile
    doesn't tax the whole scene's dispatches (the graph loop's cost is
    linear in e_cap)."""
    key = ("policy-test-2",)
    ss._SPEC_BUCKETS.pop(key, None)
    ss._SPEC_SHRINK.pop(key, None)
    busy = (8192, 24576, 16384, 512)
    ss._updateSpecBuckets(key, busy)
    quiets = [(2048, 6144, 4096, 128),
              (2048, 7168, 4096, 128),
              (1024, 6144, 2048, 64)]
    for q in quiets[:-1]:
        ss._updateSpecBuckets(key, q)
        assert ss._SPEC_BUCKETS[key] == busy
    ss._updateSpecBuckets(key, quiets[-1])
    # shrunk to the streak's element-wise max, not the last run's values
    assert ss._SPEC_BUCKETS[key] == (2048, 7168, 4096, 128)
    assert key not in ss._SPEC_SHRINK


def test_spec_bucket_policy_partial_growth_ratchets():
    """A run larger in ANY dimension grows that dimension immediately
    (element-wise max) and cancels any shrink streak."""
    key = ("policy-test-3",)
    ss._SPEC_BUCKETS.pop(key, None)
    ss._SPEC_SHRINK.pop(key, None)
    ss._updateSpecBuckets(key, (4096, 8192, 8192, 256))
    ss._updateSpecBuckets(key, (2048, 4096, 4096, 128))  # streak 1
    assert key in ss._SPEC_SHRINK
    ss._updateSpecBuckets(key, (4096, 12288, 4096, 128))  # grows dim 1
    assert ss._SPEC_BUCKETS[key] == (4096, 12288, 8192, 256)
    assert key not in ss._SPEC_SHRINK
