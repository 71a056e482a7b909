"""Parity tests for the device clump kernel vs the reference-semantics oracle
and scipy.ndimage.label (component equality)."""

import numpy as np
import pytest
import scipy.ndimage as ndi

from pyshepseg_tpu.ops.clump import clump
from oracle import oracle_clump


def _random_cluster_img(rng, shape=(40, 40), nvals=4, null_frac=0.1,
                        null_val=0):
    img = rng.integers(1, nvals + 1, size=shape).astype(np.int32)
    nulls = rng.random(shape) < null_frac
    img[nulls] = null_val
    return img


def test_clump_matches_oracle_4connected(rng):
    img = _random_cluster_img(rng)
    seg, nxt = clump(img, 0, fourConnected=True, clumpId=1)
    ref, ref_nxt = oracle_clump(img, 0, fourConnected=True, clumpId=1)
    np.testing.assert_array_equal(seg, ref)
    assert nxt == ref_nxt


def test_clump_matches_oracle_8connected(rng):
    img = _random_cluster_img(rng, nvals=3)
    seg, nxt = clump(img, 0, fourConnected=False, clumpId=1)
    ref, ref_nxt = oracle_clump(img, 0, fourConnected=False, clumpId=1)
    np.testing.assert_array_equal(seg, ref)
    assert nxt == ref_nxt


def test_clump_nonzero_start_id(rng):
    img = _random_cluster_img(rng, shape=(20, 20))
    seg, nxt = clump(img, 0, fourConnected=True, clumpId=5)
    ref, ref_nxt = oracle_clump(img, 0, fourConnected=True, clumpId=5)
    np.testing.assert_array_equal(seg, ref)
    assert nxt == ref_nxt


def test_clump_components_match_scipy(rng):
    """Cross-check component structure (not label values) against scipy,
    per distinct pixel value."""
    img = _random_cluster_img(rng, shape=(64, 64), nvals=5)
    seg, _ = clump(img, 0, fourConnected=True)
    # Segments must be internally uniform in img value
    for sid in range(1, seg.max() + 1):
        vals = img[seg == sid]
        assert len(np.unique(vals)) == 1
    # Total component count per value matches scipy
    total = 0
    structure = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    for v in range(1, 6):
        _, n = ndi.label(img == v, structure=structure)
        total += n
    assert seg.max() == total


def test_clump_all_null():
    img = np.zeros((16, 16), dtype=np.int32)
    seg, nxt = clump(img, 0, fourConnected=True)
    assert seg.max() == 0
    assert nxt == 1


def test_clump_single_component():
    img = np.ones((16, 16), dtype=np.int32)
    seg, nxt = clump(img, 0, fourConnected=True)
    assert (seg == 1).all()
    assert nxt == 2


def test_clump_snake():
    """Long thin serpentine component exercises propagation depth."""
    img = np.zeros((20, 20), dtype=np.int32)
    # boustrophedon path
    for r in range(0, 20, 2):
        img[r, :] = 1
        if r + 1 < 20:
            img[r + 1, -1 if (r // 2) % 2 == 0 else 0] = 1
    seg, _ = clump(img, 0, fourConnected=True)
    ref, _ = oracle_clump(img, 0, fourConnected=True)
    np.testing.assert_array_equal(seg, ref)


def test_clump_matches_oracle_large(rng):
    """Scan-order ID parity at a scale where long runs and null speckle
    interact: 160x160, both connectivities."""
    img = _random_cluster_img(rng, shape=(160, 160), nvals=3,
                              null_frac=0.15)
    for fourConnected in (True, False):
        seg, nxt = clump(img, 0, fourConnected=fourConnected, clumpId=1)
        ref, ref_nxt = oracle_clump(img, 0, fourConnected=fourConnected,
                                    clumpId=1)
        np.testing.assert_array_equal(seg, ref)
        assert nxt == ref_nxt


def test_clump_capped_matches_oracle_on_large_uniform_region(rng):
    """The reference ALWAYS caps flood-fill growth at MAX_CLUMP_SIZE=10000
    pixels (reference shepseg.py:481 — not optional), splitting any
    uniform region larger than that in flood-fill stack order. Our
    default is the exact un-capped CCL (documented deviation,
    ops/clump.py); the maxClumpSize= path must reproduce the reference's
    split geometry exactly on a region well past the cap."""
    img = _random_cluster_img(rng, shape=(160, 160), nvals=2,
                              null_frac=0.05)
    img[20:130, 20:130] = 7   # 110x110 = 12100 px > 10000 cap
    seg, nxt = clump(img, 0, fourConnected=True, maxClumpSize=10000)
    ref, ref_nxt = oracle_clump(img, 0, fourConnected=True,
                                maxClumpSize=10000)
    np.testing.assert_array_equal(seg, ref)
    assert nxt == ref_nxt
    # the uniform region really did split
    ids_in_region = np.unique(seg[20:130, 20:130])
    assert len(ids_in_region) >= 2
    # and the exact kernel would NOT have split it
    seg_exact, _ = clump(img, 0, fourConnected=True)
    assert len(np.unique(seg_exact[25:125, 25:125])) == 1


def test_clump_jump_schedule_invariant(rng):
    """The pointer-jump hop only ACCELERATES label propagation — the
    fixpoint (and so the scan-order labels) must be identical for any
    jump schedule, including never jumping. Uses the serpentine image
    (worst-case propagation depth) plus a random one."""
    import jax
    import functools
    from pyshepseg_tpu.ops.clump import clump_labels
    snake = np.zeros((20, 20), dtype=np.int32)
    for r in range(0, 20, 2):
        snake[r, :] = 1
        if r + 1 < 20:
            snake[r + 1, -1 if (r // 2) % 2 == 0 else 0] = 1
    rand = _random_cluster_img(rng, shape=(64, 48))
    for img in (snake, rand):
        ref = None
        for je in (2, 3, 8, 10_000):
            f = jax.jit(functools.partial(
                clump_labels, ignore_val=0, four_connected=True,
                jump_every=je))
            seg, num, sweeps = f(img)
            seg = np.asarray(seg)
            if ref is None:
                ref = seg
            else:
                np.testing.assert_array_equal(seg, ref)
            assert int(sweeps) < 60


@pytest.mark.parametrize("fourConnected", [True, False])
@pytest.mark.parametrize("shape", [(32, 32), (40, 56), (264, 264),
                                   (257, 513)])
def test_clump_matches_oracle_across_block_boundaries(rng, shape,
                                                      fourConnected):
    """Scan-order parity with the oracle on shapes below one block, on
    exact multiples of nothing, and just past the BLOCK=256 boundaries
    (one-pixel and partial last blocks), both connectivities."""
    img = _random_cluster_img(rng, shape=shape, nvals=3, null_frac=0.1)
    seg, nxt = clump(img, 0, fourConnected=fourConnected)
    ref, ref_nxt = oracle_clump(img, 0, fourConnected=fourConnected)
    np.testing.assert_array_equal(seg, ref)
    assert nxt == ref_nxt


def test_clump_two_level_merge_multiblock(rng):
    """The two-level fast path (block-local solve + contracted
    boundary-root merge, ops/clump.py:_merge_boundary_roots) against the
    oracle on an image spanning block boundaries in BOTH axes, with
    components crossing them."""
    img = _random_cluster_img(rng, shape=(264, 264), nvals=2,
                              null_frac=0.02)
    # guarantee components crossing each boundary
    img[250:262, :] = 5
    img[:, 250:262] = 5
    for fourConnected in (True, False):
        seg, nxt = clump(img, 0, fourConnected=fourConnected)
        ref, ref_nxt = oracle_clump(img, 0, fourConnected=fourConnected)
        np.testing.assert_array_equal(seg, ref)
        assert nxt == ref_nxt


def test_clump_two_level_fallback_on_local_nonconvergence():
    """A serpentine spanning multiple blocks whose local solve cannot
    converge within MAX_LOCAL_ITERS: the fast path's streaming verify
    must detect the stale labels and fall back to the global loop, so
    the result stays exact."""
    h = w = 264   # BLOCK = 256: boundaries in both axes
    img = np.zeros((h, w), dtype=np.int32)
    for r in range(0, h, 2):
        img[r, :] = 1
        if r + 1 < h:
            img[r + 1, -1 if (r // 2) % 2 == 0 else 0] = 1
    seg, _ = clump(img, 0, fourConnected=True)
    ref, _ = oracle_clump(img, 0, fourConnected=True)
    np.testing.assert_array_equal(seg, ref)
