"""
Numerics of the device paths on an NVIDIA card, at the golden scene's
real widths (8000^2, 101 Voronoi centres, windows of 4096^2), each
against a plain reference. Marked ``gpu``: they skip without a card and
run with ``PYSHEPSEG_TEST_GPU=1 python -m pytest -m gpu tests/``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pyshepseg_tpu import native, shepseg
from pyshepseg_tpu.cmdline import runtests
from pyshepseg_tpu.ops.clump import clump
from pyshepseg_tpu.ops.constants import SEGNULLVAL
from pyshepseg_tpu.ops.elim_small import _remap_and_relabel, round_capacity
from pyshepseg_tpu.ops.kmeans import assign_clusters, null_scalar

from oracle import np_remap_and_relabel

pytestmark = pytest.mark.gpu

WINDOW = 4096


@pytest.fixture(scope="module")
def golden_clusters(gpu_device):
    """k-means cluster image (int32, 0 = null) of the golden scene's
    top-left WINDOW^2 window, fitted with the golden run's 101
    clusters."""
    _, img = runtests.goldenScene(8000, 101)
    win = np.ascontiguousarray(img[:, :WINDOW, :WINDOW])
    km = shepseg.fitSpectralClusters(win, 101, 1, runtests.OUTNULL, False)
    centers = jnp.asarray(km.cluster_centers_.astype(np.float32))
    clusters = assign_clusters(jnp.asarray(win), centers,
                               null_scalar(runtests.OUTNULL, win.dtype),
                               True)
    return np.asarray(clusters).astype(np.int32)


@pytest.mark.parametrize("fourConnected", [True, False])
def test_clump_equals_native_flood_fill(golden_clusters, fourConnected):
    """Integer labels: the device clump must equal the C++ scan-order
    flood fill (uncapped) exactly."""
    assert native.available()
    h, w = golden_clusters.shape
    seg, nxt = clump(golden_clusters, SEGNULLVAL,
                     fourConnected=fourConnected)
    ref, refNxt = native.flood_fill_clump(
        golden_clusters, SEGNULLVAL, fourConnected, h * w + 1, 1)
    assert nxt == refNxt
    np.testing.assert_array_equal(seg, ref)


def test_remap_and_relabel_equals_numpy(golden_clusters):
    """The relabel gather at the window's real capacity equals numpy's
    table[seg] exactly."""
    seg, nxt = clump(golden_clusters, SEGNULLVAL, fourConnected=True)
    capacity = round_capacity(nxt)
    rng = np.random.default_rng(7)
    # merge every id into a random id at or below it (0 stays null)
    ids = np.arange(capacity, dtype=np.uint32)
    remap = (rng.random(capacity) * (ids + 1)).astype(np.uint32)
    remap[0] = 0
    size = np.bincount(remap[seg.ravel()], minlength=capacity)
    size = size.astype(np.uint32)
    got = jax.jit(_remap_and_relabel)(jnp.asarray(seg), jnp.asarray(remap),
                                      jnp.asarray(size))
    np.testing.assert_array_equal(np.asarray(got),
                                  np_remap_and_relabel(seg, remap, size))


@pytest.mark.parametrize("nbands", [3, 10])
def test_assign_clusters_float32_vs_float64(gpu_device, nbands):
    """assign_clusters (float32, Precision.HIGHEST) against a float64
    argmin: exact wherever the best two scores are more than 4 float32
    ulps apart; fewer than 1e-5 of the pixels may fall inside that
    margin."""
    trueseg, _ = runtests.goldenScene(WINDOW, 101)
    rng = np.random.default_rng(nbands)
    palette = rng.integers(100, 10000, size=(101, nbands)).astype(np.float32)
    img = palette[np.maximum(trueseg, 1) - 1].transpose(2, 0, 1)
    img = img + rng.normal(0, 8.0, img.shape).astype(np.float32)
    img = np.clip(np.rint(img), 0, 65535).astype(np.uint16)
    centers = palette + rng.normal(0, 4.0, palette.shape).astype(np.float32)

    got = np.asarray(assign_clusters(jnp.asarray(img), jnp.asarray(centers),
                                     null_scalar(0, img.dtype), False))
    got = got.reshape(-1).astype(np.int64) - 1

    c64 = centers.astype(np.float64)
    cc = 0.5 * np.sum(c64 * c64, axis=1)
    x = img.reshape(nbands, -1)
    npix = x.shape[1]
    inMargin = 0
    chunk = 1 << 18
    for s in range(0, npix, chunk):
        xs = x[:, s:s + chunk].astype(np.float64)
        scores = cc[None, :] - xs.T @ c64.T              # (n, K)
        two = np.partition(scores, 1, axis=1)[:, :2]
        ulp = np.spacing(np.abs(two).max(axis=1).astype(np.float32))
        clear = (two[:, 1] - two[:, 0]) > 4 * ulp.astype(np.float64)
        inMargin += int(np.count_nonzero(~clear))
        ref = np.argmin(scores, axis=1)
        np.testing.assert_array_equal(got[s:s + chunk][clear], ref[clear])
    print(f"assign_clusters {nbands} bands: {inMargin} of {npix} pixels "
          "within 4 float32 ulps of a tie")
    assert inMargin < 1e-5 * npix
