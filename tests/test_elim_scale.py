"""Scale and multi-seed differential sweeps for the elimination
kernels vs the reference-semantics oracle.

Split from test_elim.py so the process-sharded runner
(scripts/partest.py) can schedule the suite's heaviest modules on
separate workers.
"""

import numpy as np
import pytest

from pyshepseg_tpu.ops.clump import clump
from pyshepseg_tpu.ops.segreduce import makeSegSize
from pyshepseg_tpu.ops.elim_single import eliminateSinglePixels
from pyshepseg_tpu.ops.elim_small import eliminateSmallSegments
from oracle import (
    oracle_clump, oracle_seg_size, oracle_eliminate_single_pixels,
    oracle_eliminate_small_segments)

from test_elim import _make_case, _run_small_elim_case


@pytest.mark.parametrize("seed", range(8))
def test_single_pixel_elim_many_seeds(seed):
    """Multi-seed differential sweep over the mask-carried fixpoint
    rewrite (single + multi-pass chains, nulls, both connectivities)."""
    rng = np.random.default_rng(1000 + seed)
    fourConnected = bool(seed % 2)
    img, seg, maxSegId = _make_case(rng, shape=(28, 30),
                                    null_frac=0.08 if seed % 3 else 0.0)
    segSize = makeSegSize(seg)

    ref_seg = seg.copy()
    ref_n = oracle_eliminate_single_pixels(
        img, ref_seg, oracle_seg_size(ref_seg), 1, fourConnected)
    got_seg = seg.copy()
    got_n = eliminateSinglePixels(img, got_seg, segSize, 1, maxSegId,
                                  fourConnected)
    assert got_n == ref_n
    np.testing.assert_array_equal(got_seg, ref_seg)


@pytest.mark.parametrize("seed", range(4))
def test_small_elim_many_seeds(seed):
    """Multi-seed differential sweep over the graph-space elimination
    with the measured edge-capacity bucketing."""
    rng = np.random.default_rng(2000 + seed)
    _run_small_elim_case(rng, (26, 29), minSegSize=4 + seed,
                         maxSpectralDiff=(80.0 if seed % 2 else 1e9),
                         fourConnected=bool(seed % 2))


def test_elim_large_scale_matches_oracle(rng):
    """Oracle parity at 128x128 with nulls, 8-connectivity, and a tight
    maxSpectralDiff — a combination otherwise untested at scale (small shapes can mask block-boundary and capacity-bucket
    bugs)."""
    img, seg, maxSegId = _make_case(rng, shape=(128, 128), nbands=3,
                                    nclusters=4, null_frac=0.1)
    ref_seg = seg.copy()
    segSize = makeSegSize(seg)

    ref_elim = oracle_eliminate_single_pixels(
        img, ref_seg, oracle_seg_size(ref_seg), 1, True)
    numElim = eliminateSinglePixels(img, seg, segSize, 1, maxSegId, True)
    np.testing.assert_array_equal(seg, ref_seg)
    assert numElim == ref_elim

    maxSegId = int(seg.max())
    ref_seg2 = ref_seg.copy()
    ref_n = oracle_eliminate_small_segments(
        ref_seg2, img, maxSegId, 8, 30.0, fourConnected=True)
    n = eliminateSmallSegments(seg, img, maxSegId, 8, 30.0,
                               fourConnected=True)
    np.testing.assert_array_equal(seg, ref_seg2)
    assert n == ref_n


def test_elim_large_scale_8conn_matches_oracle(rng):
    img = (rng.integers(0, 40, size=(3, 128, 128)) * 4).astype(np.int32)
    clusters = rng.integers(1, 5, size=(128, 128)).astype(np.uint32)
    clusters[rng.random((128, 128)) < 0.08] = 0
    seg, nxt = clump(clusters, 0, fourConnected=False)
    ref_seg, _ = oracle_clump(clusters, 0, fourConnected=False)
    np.testing.assert_array_equal(seg, ref_seg)
    maxSegId = nxt - 1

    ref_seg = seg.copy()
    ref_n = oracle_eliminate_small_segments(
        ref_seg, img, maxSegId, 6, 25.0, fourConnected=False)
    n = eliminateSmallSegments(seg, img, maxSegId, 6, 25.0,
                               fourConnected=False)
    np.testing.assert_array_equal(seg, ref_seg)
    assert n == ref_n
