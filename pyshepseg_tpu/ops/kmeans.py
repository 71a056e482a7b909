"""
K-means spectral clustering on the JAX device.

Replaces the reference's use of sklearn.cluster.KMeans
(reference: pyshepseg/shepseg.py:252-397) with a JAX implementation of
Lloyd's algorithm whose distance step is a matrix product: for points X (N, B)
and centres C (K, B), squared distances are computed as
|x|^2 - 2 X @ C.T + |c|^2 — one large batched matmul per iteration.

The class mimics the sklearn surface the reference relies on
(``cluster_centers_``, ``predict``, ``n_clusters``), so a fitted TPUKMeans
can be passed anywhere the reference accepts a ``kmeansObj``
(shepseg.py:175-181, tiling.py:516-517), and vice versa: any object with
``cluster_centers_`` works with :func:`applySpectralClusters` here.

Determinism: with a fixed init (``fixedKMeansInit`` / explicit array) the
algorithm is deterministic. k-means++ with ``n_init`` restarts matches the
reference statistically, not bitwise (the reference itself offers
``fixedKMeansInit`` for strict determinism, shepseg.py:168-174).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .constants import SEGNULLVAL, MINSEGID


def _assign_scores(x, centers):
    """
    (N, K) assignment scores 0.5*|c|^2 - x.c as one matrix product. These have the
    same per-point argmin as squared Euclidean distances but avoid the
    catastrophic float32 cancellation of |x|^2 - 2x.c + |c|^2 (which can
    make near-duplicate centres each appear closest to some points, hiding
    empty clusters from the repair step).

    Precision.HIGHEST is load-bearing: on a GPU it means true float32
    products, not TF32, whose ~2^-11 relative error at 16-bit imagery
    magnitudes (scores ~1e8) exceeds the inter-cluster score margins
    (~1e4) and would change cluster assignments. Float32 keeps rounding
    ~1e1 at these magnitudes.
    """
    cc = jnp.sum(centers * centers, axis=1)
    xc = jnp.dot(x, centers.T, preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST)
    return 0.5 * cc[None, :] - xc


def _assign(x, centers):
    """Labels + exact squared distance to the assigned centre."""
    labels = jnp.argmin(_assign_scores(x, centers), axis=1).astype(jnp.int32)
    diff = x - centers[labels]
    mind = jnp.sum(diff * diff, axis=1)
    return labels, mind


@functools.partial(jax.jit, static_argnames=("max_iter",))
def _lloyd(x, w, centers, tol_scaled, max_iter: int):
    """Run Lloyd's iterations to convergence. Returns (centers, inertia, n_iter).

    ``w`` are 0/1 point weights: rows with w == 0 are shape padding
    (see TPUKMeans.fit) and contribute exact 0.0 to every sum, making
    the result bitwise identical to an unpadded run while the array
    shape stays in a small set of power-of-two buckets (one XLA compile
    per bucket instead of one per distinct sample count — compiling
    this loop at ~1e6 points is slow).
    """
    k = centers.shape[0]

    def assign(c):
        return _assign(x, c)

    def body(carry):
        c, _, it, _ = carry
        labels, mind = assign(c)
        sums = jax.ops.segment_sum(x * w[:, None], labels, num_segments=k)
        counts = jax.ops.segment_sum(w, labels, num_segments=k)
        new_c = sums / jnp.maximum(counts, 1.0)[:, None]
        # Empty-cluster repair, fully vectorized: the j-th empty cluster
        # re-seeds at the j-th farthest point from any centre. top_k
        # returns DISTINCT point indices, so several empty clusters never
        # receive the same pixel (the ping-pong failure of a naive
        # repeated argmax); and since the loop below never accepts
        # convergence while clusters are empty, any residual duplicates
        # from equal-valued pixels get re-repaired next iteration. An
        # earlier sequential farthest-point sweep (fori of lax.cond over
        # k clusters) was equivalent in spirit but catastrophically slow
        # to compile and run at ~1e6 points.
        empty = counts == 0
        any_empty = jnp.any(empty)

        def repair(args):
            nc, mind_r = args
            # padding rows must never donate: mask to -1 (< any real
            # squared distance)
            _, donor_idx = jax.lax.top_k(jnp.where(w > 0, mind_r, -1.0), k)
            donors = x[donor_idx]            # (k, B) distinct points
            # Distinct indices can still carry bitwise-identical VALUES; a
            # per-rank nudge keeps re-seeded centres distinct so argmin
            # can't collapse two repairs back onto one cluster (which
            # would force a re-repair every iteration until max_iter on
            # degenerate data). The nudge is far below any data scale
            # that matters and only touches re-seeded clusters.
            j = jnp.arange(k, dtype=jnp.float32)
            donors = donors + (1e-4 * j)[:, None]
            rank = jnp.cumsum(empty.astype(jnp.int32)) - 1
            return jnp.where(empty[:, None], donors[rank], nc)

        # gate behind cond: the common no-empties iteration skips the
        # O(n log k) top_k and gathers entirely
        new_c = jax.lax.cond(any_empty, repair, lambda args: args[0],
                             (new_c, mind))
        shift = jnp.sum((new_c - c) ** 2)
        return new_c, shift, it + 1, any_empty

    def cond(carry):
        _, shift, it, had_empty = carry
        # Never accept convergence while clusters are empty: a relocated
        # donor can coincide with its previous position (shift == 0) even
        # though the partition is still in repair.
        return ((shift > tol_scaled) | had_empty) & (it < max_iter)

    init = (centers, jnp.float32(jnp.inf), jnp.int32(0), jnp.bool_(False))
    centers, _, n_iter, _ = jax.lax.while_loop(cond, body, init)
    # Final inertia with the converged centres
    _, mind = assign(centers)
    return centers, jnp.sum(mind * w), n_iter


@jax.jit
def _kmeanspp_init(x, w, n_real, key, k_arr):
    """k-means++ seeding. k is static via k_arr shape (k, B) scratch.

    ``w`` masks shape-padding rows (see _lloyd); ``n_real`` is the true
    point count so the uniform first draw never lands on padding.
    """
    n = x.shape[0]
    k = k_arr.shape[0]
    key, sub = jax.random.split(key)
    first = x[jax.random.randint(sub, (), 0, n_real)]
    centers = k_arr.at[0].set(first)

    def body(i, carry):
        centers, key, mind = carry
        d = jnp.sum((x - centers[i - 1]) ** 2, axis=1)
        mind = jnp.minimum(mind, d)
        key, sub = jax.random.split(key)
        mind_w = jnp.where(w > 0, mind, 0.0)
        total = jnp.sum(mind_w)
        probs = jnp.where(total > 0, mind_w / jnp.maximum(total, 1e-30),
                          w / jnp.maximum(jnp.sum(w), 1.0))
        # padding rows get -inf logits: zero probability even against
        # real points whose own probability underflowed
        logits = jnp.where(w > 0, jnp.log(probs + 1e-30), -jnp.inf)
        idx = jax.random.categorical(sub, logits)
        return centers.at[i].set(x[idx]), key, mind

    mind0 = jnp.full(n, jnp.inf, jnp.float32)
    centers, _, _ = jax.lax.fori_loop(1, k, body, (centers, key, mind0))
    return centers


def null_scalar(img_null_val, img_dtype):
    """
    The null value as a device scalar in the image's NATIVE dtype, for
    the drivers to pass into assign_clusters. A float32 round trip
    would alias large integers (|v| > 2^24) onto neighbouring values
    and silently unmask nodata pixels of int32/int64 imagery;
    integer-to-integer casts wrap exactly as the in-kernel astype does.
    """
    return jnp.asarray(np.asarray(img_null_val).astype(img_dtype))


def assign_clusters(img, centers, img_null_val, has_null: bool):
    """
    Device: per-pixel nearest-centre cluster IDs starting at 1; pixels
    equal to the null value in any band become SEGNULLVAL
    (reference: shepseg.py:317-361).

    ``img`` is (nBands, H, W) in its NATIVE dtype: the null comparison
    runs in that dtype (a float32 cast can alias distinct large integers
    onto the null value and silently drop valid pixels); scoring casts to
    float32 internally.
    """
    nbands, h, w = img.shape
    # Band-MAJOR matmul: scores as (K, H*W) = centers (K, B) @ x (B, H*W),
    # with no transpose to a band-minor (H*W, B) copy. Same arithmetic,
    # same lowest-index argmin tie-break as the reference's predict.
    # HIGHEST: true float32 on a GPU, not TF32 (see _assign_scores).
    x_bm = img.reshape(nbands, h * w).astype(jnp.float32)
    cc = jnp.sum(centers * centers, axis=1)
    xc = jnp.dot(centers, x_bm, preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST)   # (K, H*W)
    scores = 0.5 * cc[:, None] - xc
    labels = jnp.argmin(scores, axis=0).astype(jnp.uint32) + MINSEGID
    clusters = labels.reshape(h, w)
    if has_null:
        null = jnp.asarray(img_null_val).astype(img.dtype)
        nullmask = jnp.any(img == null, axis=0)
        clusters = jnp.where(nullmask, jnp.uint32(SEGNULLVAL), clusters)
    return clusters


@jax.jit
def predict_labels(x, centers):
    """Device: nearest-centre labels for points x (N, B)."""
    return jnp.argmin(_assign_scores(x, centers), axis=1).astype(jnp.int32)


class TPUKMeans:
    """
    Drop-in stand-in for the slice of sklearn.cluster.KMeans that the
    reference uses: ``fit``, ``predict``, ``cluster_centers_``,
    ``n_clusters``, ``inertia_``. Pickleable (state is numpy arrays), so it
    travels across worker channels exactly like the reference's kmeansObj.
    """

    def __init__(self, n_clusters=8, n_init=5, init="k-means++",
                 max_iter=300, tol=1e-4, random_state=0):
        self.n_clusters = int(n_clusters)
        self.n_init = int(n_init)
        self.init = init
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.random_state = int(random_state)
        self.cluster_centers_ = None
        self.inertia_ = None
        self.n_iter_ = None

    def fit(self, X):
        X_np = np.asarray(X, dtype=np.float32)
        n_real = X_np.shape[0]
        # Pad the sample to a power-of-two bucket with zero-WEIGHT rows:
        # results are bitwise identical (zero-weight terms contribute
        # exact 0.0 and padding rows are masked out of every draw), but
        # XLA compiles one program per bucket instead of one per distinct
        # sample count — compiling the Lloyd loop at ~1e6 points is
        # slow, and whole-file subsample counts differ for every scene
        # size.
        m = 1024
        while m < n_real:
            m *= 2
        if m > n_real:
            X_np = np.concatenate(
                [X_np, np.zeros((m - n_real, X_np.shape[1]), np.float32)])
        w_np = np.zeros(m, np.float32)
        w_np[:n_real] = 1.0
        x = jnp.asarray(X_np)
        w = jnp.asarray(w_np)
        tol_scaled = jnp.float32(
            self.tol * float(np.mean(np.var(X_np[:n_real], axis=0))))
        k = self.n_clusters
        if isinstance(self.init, str) and self.init == "k-means++":
            key = jax.random.PRNGKey(self.random_state)
            scratch = jnp.zeros((k, x.shape[1]), jnp.float32)
            # Dispatch every trial WITHOUT syncing between them (JAX
            # async dispatch pipelines the programs on-device); fetch
            # all inertias in one blocking transfer at the end.
            # np.argmin keeps the first of tied
            # minima — identical selection to the sequential
            # strictly-smaller update this replaces.
            trials = []
            for trial in range(self.n_init):
                key, sub = jax.random.split(key)
                c0 = _kmeanspp_init(x, w, jnp.int32(n_real), sub, scratch)
                trials.append(_lloyd(x, w, c0, tol_scaled,
                                     max_iter=self.max_iter))
            inertias = np.asarray(jnp.stack([t[1] for t in trials]))
            bestIdx = int(np.argmin(inertias))
            c, _, n_iter = trials[bestIdx]
            self.cluster_centers_ = np.asarray(c)
            self.inertia_ = float(inertias[bestIdx])
            self.n_iter_ = int(n_iter)
        else:
            c0 = jnp.asarray(np.asarray(self.init, dtype=np.float32))
            if c0.shape[0] != k:
                raise ValueError("init centres shape mismatch")
            c, inertia, n_iter = _lloyd(x, w, c0, tol_scaled,
                                        max_iter=self.max_iter)
            self.cluster_centers_ = np.asarray(c)
            self.inertia_ = float(inertia)
            self.n_iter_ = int(n_iter)
        return self

    def predict(self, X, chunk=1 << 20):
        """Nearest-centre labels, chunked to bound device memory."""
        X = np.asarray(X, dtype=np.float32)
        centers = jnp.asarray(self.cluster_centers_.astype(np.float32))
        out = np.empty(X.shape[0], dtype=np.int32)
        for start in range(0, X.shape[0], chunk):
            xs = jnp.asarray(X[start:start + chunk])
            out[start:start + xs.shape[0]] = np.asarray(
                predict_labels(xs, centers))
        return out
