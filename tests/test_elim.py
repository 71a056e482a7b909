"""Parity tests for single-pixel and small-segment elimination vs the
reference-semantics oracle."""

import numpy as np
import pytest

from pyshepseg_tpu.ops.clump import clump
from pyshepseg_tpu.ops.segreduce import makeSegSize
from pyshepseg_tpu.ops.elim_single import eliminateSinglePixels
from pyshepseg_tpu.ops.elim_small import eliminateSmallSegments
from oracle import (
    oracle_clump, oracle_seg_size, oracle_eliminate_single_pixels,
    oracle_eliminate_small_segments, np_remap_and_relabel)


def _make_case(rng, shape=(32, 32), nbands=3, nclusters=5, null_frac=0.05):
    """Random multiband image + its cluster image + clumped segmentation."""
    # Values well separated so float32 vs float64 distances can't flip order
    img = (rng.integers(0, 40, size=(nbands,) + shape) * 4).astype(np.int32)
    clusters = rng.integers(1, nclusters + 1, size=shape).astype(np.uint32)
    nulls = rng.random(shape) < null_frac
    clusters[nulls] = 0
    seg, nxt = clump(clusters, 0, fourConnected=True)
    ref_seg, _ = oracle_clump(clusters, 0, fourConnected=True)
    np.testing.assert_array_equal(seg, ref_seg)
    return img, seg, nxt - 1


def test_single_pixel_elim_matches_oracle(rng):
    img, seg, maxSegId = _make_case(rng)
    segSize = makeSegSize(seg)

    ref_seg = seg.copy()
    ref_n = oracle_eliminate_single_pixels(
        img, ref_seg, oracle_seg_size(ref_seg), 1, True)

    got_seg = seg.copy()
    got_n = eliminateSinglePixels(img, got_seg, segSize, 1, maxSegId, True)

    assert got_n == ref_n
    np.testing.assert_array_equal(got_seg, ref_seg)


def test_single_pixel_elim_8conn(rng):
    img, seg, maxSegId = _make_case(rng, shape=(24, 24))
    segSize = makeSegSize(seg)

    ref_seg = seg.copy()
    oracle_eliminate_single_pixels(
        img, ref_seg, oracle_seg_size(ref_seg), 1, False)

    got_seg = seg.copy()
    eliminateSinglePixels(img, got_seg, segSize, 1, maxSegId, False)
    np.testing.assert_array_equal(got_seg, ref_seg)


def _run_small_elim_case(rng, shape, minSegSize, maxSpectralDiff,
                         fourConnected, nclusters=4, nbands=2):
    img = (rng.integers(0, 30, size=(nbands,) + shape) * 8).astype(np.int32)
    clusters = rng.integers(1, nclusters + 1, size=shape).astype(np.uint32)
    seg, nxt = clump(clusters, 0, fourConnected=fourConnected)
    maxSegId = nxt - 1

    ref_seg = seg.copy()
    ref_n = oracle_eliminate_small_segments(
        ref_seg, img, maxSegId, minSegSize, maxSpectralDiff, fourConnected)

    got_seg = seg.copy()
    got_n = eliminateSmallSegments(
        got_seg, img, maxSegId, minSegSize, maxSpectralDiff, fourConnected)

    assert got_n == ref_n
    np.testing.assert_array_equal(got_seg, ref_seg)


def test_small_elim_matches_oracle_4conn(rng):
    _run_small_elim_case(rng, (24, 24), minSegSize=5,
                         maxSpectralDiff=1e9, fourConnected=True)


def test_small_elim_matches_oracle_8conn(rng):
    _run_small_elim_case(rng, (24, 24), minSegSize=4,
                         maxSpectralDiff=1e9, fourConnected=False)


def test_small_elim_spectral_limit(rng):
    # A tight maxSpectralDiff must block some merges identically
    _run_small_elim_case(rng, (24, 24), minSegSize=6,
                         maxSpectralDiff=60.0, fourConnected=True)


def test_small_elim_larger_minsize(rng):
    _run_small_elim_case(rng, (32, 32), minSegSize=10,
                         maxSpectralDiff=1e9, fourConnected=True)


def test_small_elim_noop():
    seg = np.ones((8, 8), dtype=np.uint32)
    img = np.zeros((1, 8, 8), dtype=np.int32)
    n = eliminateSmallSegments(seg, img, 1, 1, 100.0, True)
    assert n == 0
    assert (seg == 1).all()


def test_small_elim_edge_overflow_flag(rng):
    """Forcing a too-small static edge capacity must raise the overflow
    flag (the fused pipeline's signal to rebucket via the host APIs)."""
    import jax.numpy as jnp
    from pyshepseg_tpu.ops.elim_small import eliminate_small_segments_device
    from pyshepseg_tpu.ops.segreduce import seg_sizes, seg_spectral_sums

    clusters = rng.integers(1, 5, size=(24, 24)).astype(np.uint32)
    seg, nxt = clump(clusters, 0, fourConnected=True)
    img = (rng.integers(0, 30, size=(2, 24, 24)) * 8).astype(np.int32)
    cap = 1024
    seg_j = jnp.asarray(seg)
    img_f = jnp.asarray(img).astype(jnp.float32)
    size = seg_sizes(seg_j, cap)
    spect = seg_spectral_sums(seg_j, img_f, cap)
    # e_cap=2 cannot hold the real adjacency set -> overflow flag
    _, _, overflow = eliminate_small_segments_device(
        seg_j, size, spect, 5, jnp.float32(1e9), True, e_cap=2)
    assert bool(overflow)
    # generous e_cap -> no overflow, and result matches the host API
    out, n, overflow = eliminate_small_segments_device(
        seg_j, size, spect, 5, jnp.float32(1e9), True, e_cap=8 * cap)
    assert not bool(overflow)
    ref = seg.copy()
    eliminateSmallSegments(ref, img, nxt - 1, 5, 1e9, True)
    np.testing.assert_array_equal(np.asarray(out), ref)


def test_eliminate_single_pixels_honours_min_seg_id():
    # the reference relabels from minSegId (shepseg.py:615); the compat
    # wrapper must not silently compact against MINSEGID=1
    import numpy as np
    from pyshepseg_tpu.ops.elim_single import eliminateSinglePixels
    from pyshepseg_tpu.ops.segreduce import makeSegSize
    rng = np.random.default_rng(7)
    img = rng.integers(0, 9, size=(2, 12, 12)).astype(np.int64)
    seg4 = oracle_clump(np.asarray(img[0] % 4, np.uint32), 0,
                        fourConnected=True)[0]
    segA = seg4.copy()
    segB = seg4.copy()
    sizeA = makeSegSize(segA)
    sizeB = makeSegSize(segB)
    eliminateSinglePixels(img, segA, sizeA, minSegId=1,
                          maxSegId=int(segA.max()), fourConnected=True)
    eliminateSinglePixels(img, segB, sizeB, minSegId=3,
                          maxSegId=int(segB.max()), fourConnected=True)
    # for this seed, segment IDs 1 and 2 are single pixels that merge
    # away: base-1 relabel compacts them out, base-3 must NOT (the
    # reference's relabelSegments only counts unused IDs >= minSegId) —
    # so the outputs must genuinely differ, with base-3 labels strictly
    # larger somewhere and a higher max ID
    assert (segA != segB).any()
    assert int(segB.max()) == int(segA.max()) + 2
    assert (segB[segB >= 3] >= segA[segB >= 3]).all()
    # merged pixel geometry identical; only labels differ
    assert ((segA == 0) == (segB == 0)).all()


def test_edge_sort_keys_compact_matches_full_sort(rng):
    """edge_sort_keys_compact (row-compact the boundary pairs via a
    batched per-row sort BEFORE the dedup sort — the one-shot pipeline's
    hot path) must produce the same unique edge set and measured counts
    as the full O(H*W)-key edge_sort_keys, in both the packed (ids fit
    16 bits) and unpacked (two-key sort) variants, 4- and 8-connected."""
    import jax.numpy as jnp
    from pyshepseg_tpu.ops.elim_small import (
        edge_sort_keys, edge_sort_keys_compact, boundary_row_stats)

    clusters = rng.integers(0, 6, size=(48, 64)).astype(np.uint32)
    seg, _ = clump(clusters, 0, fourConnected=True)
    seg_j = jnp.asarray(seg)

    for four_connected in (True, False):
        a, b, first, n_unique = edge_sort_keys(seg_j, four_connected)
        a, b, first = np.asarray(a), np.asarray(b), np.asarray(first)
        ref_pairs = int(np.sum(a != 0xFFFFFFFF))
        ref_edges = set(zip(a[first].tolist(), b[first].tolist()))
        assert ref_pairs > 0 and len(ref_edges) == int(n_unique)
        sp, sr = boundary_row_stats(seg_j, four_connected)
        assert int(sp) == ref_pairs
        ref_rowmax = int(sr)
        assert 0 < ref_rowmax <= ref_pairs

        ndirs = 2 if four_connected else 4
        for id_bound in (int(seg.max()) + 1, (1 << 16) + 1):
            b_cap = ref_pairs + 13   # loose buckets
            r_cap = ref_rowmax + 5
            ca, cb, cf, cn, cp, cr = edge_sort_keys_compact(
                seg_j, four_connected, b_cap, r_cap, id_bound=id_bound)
            ca, cb, cf = np.asarray(ca), np.asarray(cb), np.asarray(cf)
            assert int(cp) == ref_pairs
            assert int(cr) == ref_rowmax
            assert int(cn) == len(ref_edges)
            got = set(zip(ca[cf].tolist(), cb[cf].tolist()))
            assert got == ref_edges

        # exact-size buckets must also work (boundary condition), and
        # an r_cap past the candidate width must clamp harmlessly
        for (b_cap, r_cap) in ((ref_pairs, ref_rowmax),
                               (ref_pairs, seg.shape[1] * ndirs + 7)):
            ca, cb, cf, cn, cp, cr = edge_sort_keys_compact(
                seg_j, four_connected, b_cap, min(r_cap, ref_pairs),
                id_bound=int(seg.max()) + 1)
            assert int(cp) == ref_pairs and int(cn) == len(ref_edges)
            got = set(zip(np.asarray(ca)[np.asarray(cf)].tolist(),
                          np.asarray(cb)[np.asarray(cf)].tolist()))
            assert got == ref_edges

        # undersized buckets must report the true measured counts so the
        # one-shot dispatch's overflow flag catches the drop
        _, _, _, _, cp, cr = edge_sort_keys_compact(
            seg_j, four_connected, max(ref_pairs // 2, 1),
            max(ref_rowmax // 2, 1), id_bound=int(seg.max()) + 1)
        assert int(cp) == ref_pairs
        assert int(cr) == ref_rowmax


@pytest.mark.parametrize("capacity", [16, 100, 1024, 8192, 32768])
def test_remap_and_relabel_matches_numpy(rng, capacity):
    """The one full-image gather of the relabel (XLA's gather at every
    capacity) equals numpy's table[seg], with merged-away ids dropped
    from the contiguous numbering."""
    import jax
    import jax.numpy as jnp
    from pyshepseg_tpu.ops.elim_small import _remap_and_relabel
    seg = rng.integers(0, capacity, size=(48, 40)).astype(np.uint32)
    ids = np.arange(capacity, dtype=np.uint32)
    remap = (rng.random(capacity) * (ids + 1)).astype(np.uint32)
    remap[0] = 0
    size = np.bincount(remap[seg.ravel()], minlength=capacity)
    got = jax.jit(_remap_and_relabel)(jnp.asarray(seg), jnp.asarray(remap),
                                      jnp.asarray(size.astype(np.uint32)))
    np.testing.assert_array_equal(np.asarray(got),
                                  np_remap_and_relabel(seg, remap, size))
