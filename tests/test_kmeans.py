"""Tests for the JAX k-means against sklearn on identical fixed inits."""

import numpy as np
import jax.numpy as jnp
import pytest

from pyshepseg_tpu.ops.kmeans import TPUKMeans
from pyshepseg_tpu.shepseg import (
    diagonalClusterCentres, autoMaxSpectralDiff, fitSpectralClusters,
    applySpectralClusters)


def _blob_data(rng, k=4, n_per=200, nbands=3, spread=2.0, sep=50.0):
    centers = rng.uniform(0, sep * k, size=(k, nbands))
    pts = np.concatenate([
        c + rng.normal(0, spread, size=(n_per, nbands)) for c in centers])
    return pts.astype(np.float32)


def _match_cost(a, b):
    """Sum of distances matching each row of a to its nearest row of b."""
    d = np.sqrt(((a[:, None, :] - b[None]) ** 2).sum(axis=2))
    return d.min(axis=1).sum()


def _sklearnKMeans():
    """sklearn's KMeans, imported inside the test that compares with it:
    a host without sklearn still collects this module."""
    return pytest.importorskip("sklearn.cluster").KMeans


def test_fixed_init_comparable_to_sklearn(rng):
    KMeans = _sklearnKMeans()
    x = _blob_data(rng)
    init = diagonalClusterCentres(x, 4)
    ours = TPUKMeans(n_clusters=4, n_init=1, init=init).fit(x)
    theirs = KMeans(n_clusters=4, n_init=1,
                    init=init.astype(np.float64)).fit(x)
    # Same init + Lloyd's: solutions of equivalent quality (local minima can
    # differ on adversarial inits, so compare inertia, not centres)
    assert ours.inertia_ <= theirs.inertia_ * 1.05


def test_kmeanspp_recovers_blob_centres(rng):
    k = 4
    centres = np.arange(k)[:, None] * 100.0 + rng.uniform(0, 10, (k, 3))
    pts = np.concatenate([
        c + rng.normal(0, 1.0, size=(300, 3)) for c in centres]
    ).astype(np.float32)
    km = TPUKMeans(n_clusters=k, n_init=5).fit(pts)
    assert _match_cost(centres, km.cluster_centers_) < k * 1.0


def test_kmeanspp_quality(rng):
    KMeans = _sklearnKMeans()
    x = _blob_data(rng, k=5)
    ours = TPUKMeans(n_clusters=5, n_init=5).fit(x)
    theirs = KMeans(n_clusters=5, n_init=5).fit(x)
    # Inertia within 5% of sklearn
    assert ours.inertia_ <= theirs.inertia_ * 1.05


def test_predict_roundtrip(rng):
    x = _blob_data(rng)
    km = TPUKMeans(n_clusters=4, n_init=2).fit(x)
    labels = km.predict(x)
    assert labels.shape == (x.shape[0],)
    assert labels.min() >= 0 and labels.max() < 4
    # points are closest to their assigned centre
    d = ((x[:, None, :] - km.cluster_centers_[None]) ** 2).sum(axis=2)
    np.testing.assert_array_equal(labels, d.argmin(axis=1))


def test_diagonal_centres_match_reference_formula(rng):
    x = rng.integers(0, 1000, size=(500, 4)).astype(np.int32)
    c = diagonalClusterCentres(x, 10)
    assert c.shape == (10, 4)
    assert c.dtype == x.dtype  # reference keeps sample dtype (truncates)
    bandMin, bandMax = x.min(axis=0), x.max(axis=0)
    step = (bandMax - bandMin) / 11
    np.testing.assert_array_equal(c[0], (bandMin + step).astype(x.dtype))


def test_auto_max_spectral_diff():
    class FakeKM:
        cluster_centers_ = np.array([[0., 0.], [3., 4.], [6., 8.]])

    # pairwise dists: 5, 10, 5 -> median = 5
    assert abs(autoMaxSpectralDiff(FakeKM(), 'auto', 50) - 5.0) < 1e-6
    assert abs(autoMaxSpectralDiff(FakeKM(), None, 50) - 100.0) < 1e-6
    assert autoMaxSpectralDiff(FakeKM(), 42.0, 50) == 42.0


def test_fit_apply_spectral_clusters(rng):
    img = rng.integers(0, 200, size=(3, 40, 40)).astype(np.uint16)
    img[:, :3, :3] = 999  # null corner
    km = fitSpectralClusters(img, 8, 100, 999, True)
    clusters = applySpectralClusters(km, img, 999)
    assert clusters.shape == (40, 40)
    assert (clusters[:3, :3] == 0).all()
    assert clusters[5:, 5:].min() >= 1
    assert clusters.max() <= 8


def test_large_integer_null_value_survives(rng):
    # int32 imagery with a nodata value beyond float32's exact-integer
    # range (2^24): a float32 round trip of the scalar would alias it
    # onto a neighbouring value and nodata pixels would be clustered as
    # real data
    from pyshepseg_tpu.ops.kmeans import assign_clusters, null_scalar
    nullV = 999999999
    img = rng.integers(0, 1000, size=(3, 16, 16)).astype(np.int32)
    img[:, 4:8, 4:8] = nullV
    centers = jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32))
    seg = np.asarray(assign_clusters(
        jnp.asarray(img), centers, null_scalar(nullV, img.dtype),
        has_null=True))
    assert (seg[4:8, 4:8] == 0).all()
    assert (seg[:4, :] != 0).all()


def test_driver_large_integer_null(rng):
    # the same guarantee through doShepherdSegmentation's own null plumbing
    from pyshepseg_tpu import shepseg
    nullV = 999999999
    img = rng.integers(0, 50, size=(2, 32, 32)).astype(np.int32)
    img[:, :, :4] = nullV
    res = shepseg.doShepherdSegmentation(
        img, numClusters=4, minSegmentSize=1, maxSpectralDiff=None,
        imgNullVal=nullV, fixedKMeansInit=True)
    assert (res.segimg[:, :4] == 0).all()
    assert (res.segimg[:, 4:] != 0).all()
