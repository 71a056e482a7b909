"""
Randomized kernel-parity campaign vs the reference-semantics oracle,
with float32-deviation triage.

For each seed: random Voronoi-ish cluster field (random shape 96-160 px,
3 bands, nulls, salt), then clump -> single-pixel elimination ->
small-segment elimination run BOTH through the device kernels and the
pure-Python oracle (tests/oracle.py, a transcription of the reference
numba kernels, reference: pyshepseg/shepseg.py:452-541, 918-1000).

Exact mismatches are triaged by a dual-precision sequential replay of
the reference algorithm: if the first divergent merge decision is
precision-sensitive — two candidate distances within one float32 ulp,
or a distance landing exactly on maxSpectralDiff^2 — the case is the
DOCUMENTED float32 deviation (PARITY.md deviation 3), not a bug.

Usage:  python scripts/parity_campaign.py [numSeeds] [firstSeed]
Exit status 1 only for mismatches that are NOT the documented deviation.
"""

import os
import sys

import numpy as np
import jax

# Differential parity work runs on CPU regardless of the session's
# JAX_PLATFORMS (a site customisation may override the env var anyway):
# override via PYSHEPSEG_CAMPAIGN_PLATFORM to run the kernels on a
# device.
jax.config.update("jax_platforms",
                  os.environ.get("PYSHEPSEG_CAMPAIGN_PLATFORM", "cpu"))

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))

# NO persistent compile cache: the campaign's random shapes make cache
# hits near-zero within a run, and XLA:CPU cache entries are
# host-specific AOT machine code — a dir carried across boxes (or VM
# migrations with an identical cpuinfo flags line but different
# XLA-detected tuning) loads with "machine type doesn't match"
# warnings and can SIGILL. Observed live against tests/.jax_cache AND
# the cpu-fingerprint-keyed dir; fresh compiles are the safe default.

from oracle import (oracle_clump, oracle_eliminate_single_pixels,  # noqa: E402
                    oracle_eliminate_small_segments)
from pyshepseg_tpu.ops.clump import clump  # noqa: E402
from pyshepseg_tpu.ops.elim_single import eliminateSinglePixels  # noqa: E402
from pyshepseg_tpu.ops.elim_small import eliminateSmallSegments  # noqa: E402
from pyshepseg_tpu.ops.segreduce import makeSegSize  # noqa: E402


def make_case(seed):
    rng = np.random.default_rng(7000 + seed)
    h = int(rng.integers(96, 161))
    w = int(rng.integers(96, 161))
    nclusters = int(rng.integers(3, 7))
    fourConnected = bool(seed % 2)
    null_frac = [0.0, 0.05, 0.15][seed % 3]
    minSegSize = int(rng.integers(3, 12))
    maxDiff = [1e9, 60.0, 25.0][seed % 3]
    img = (rng.integers(0, 50, size=(3, h, w)) * 4).astype(np.int32)
    clusters = rng.integers(1, nclusters + 1, size=(h, w)).astype(np.uint32)
    if null_frac:
        clusters[rng.random((h, w)) < null_frac] = 0
    salt = rng.random((h, w)) < 0.04
    clusters = np.where(salt & (clusters > 0),
                        rng.integers(1, nclusters + 1, (h, w)),
                        clusters).astype(np.uint32)
    return img, clusters, fourConnected, minSegSize, maxDiff


def image_edges(seg, four_connected):
    """Unique undirected adjacency pairs of a label image (host)."""
    offs = [(0, 1), (1, 0)] + ([] if four_connected else [(1, 1), (1, -1)])
    pairs = set()
    H, W = seg.shape
    for dy, dx in offs:
        a = seg[max(0, -dy):H - max(0, dy), max(0, -dx):W - max(0, dx)]
        b = seg[max(0, dy):H - max(0, -dy), max(0, dx):W - max(0, -dx)]
        ok = (a != 0) & (b != 0) & (a != b)
        lo = np.minimum(a[ok], b[ok]).astype(np.int64)
        hi = np.maximum(a[ok], b[ok]).astype(np.int64)
        pairs.update(zip(lo.tolist(), hi.tolist()))
    return sorted(pairs)


def first_precision_sensitive_decision(seg, img, minSegSize, maxDiff,
                                       four_connected):
    """Sequentially replay the reference elimination on ``seg`` while
    measuring every merge decision in BOTH float64 and float32. Returns
    a description of the first decision where the two precisions
    disagree (different argmin neighbour, or opposite side of the
    maxSpectralDiff^2 threshold), or None."""
    cap = int(seg.max()) + 1
    segSize = np.bincount(seg.ravel(), minlength=cap).astype(np.int64)
    segSize[0] = 0
    spect = np.zeros((cap, img.shape[0]), dtype=np.float64)
    for b in range(img.shape[0]):
        np.add.at(spect[:, b], seg.ravel(), img[b].ravel())
    edges = image_edges(seg, four_connected)
    remap = np.arange(cap, dtype=np.int64)
    md2_64 = np.float64(maxDiff) ** 2
    md2_32 = np.float32(np.float32(maxDiff) * np.float32(maxDiff))

    for target in range(1, minSegSize):
        for _pass in range(10):
            cands = np.nonzero(segSize == target)[0]
            cands = cands[cands >= 1]
            if len(cands) == 0:
                break
            merges = []
            for s in cands:
                nbrs = set()
                for a, b in edges:
                    ra, rb = remap[a], remap[b]
                    if ra == s and rb not in (s, 0):
                        nbrs.add(rb)
                    elif rb == s and ra not in (s, 0):
                        nbrs.add(ra)
                best64 = best32 = None
                d64b = np.inf
                d32b = np.float32(np.inf)
                for t in sorted(nbrs):
                    if segSize[t] <= segSize[s]:
                        continue
                    m64 = spect[s] / segSize[s] - spect[t] / segSize[t]
                    d64 = float((m64 * m64).sum())
                    ms32 = spect[s].astype(np.float32) / np.float32(
                        segSize[s])
                    mt32 = spect[t].astype(np.float32) / np.float32(
                        segSize[t])
                    df = ms32 - mt32
                    d32 = np.float32((df * df).sum(dtype=np.float32))
                    if d64 < d64b:
                        d64b, best64 = d64, t
                    if d32 < d32b:
                        d32b, best32 = d32, t
                ok64 = best64 is not None and d64b <= md2_64
                ok32 = best32 is not None and d32b <= md2_32
                if ok64 != ok32 or (ok64 and best64 != best32):
                    return dict(target=target, seg=int(s),
                                to64=best64, to32=best32,
                                d64=d64b, d32=float(d32b))
                if ok64:
                    merges.append((s, best64))
            if not merges:
                break
            for s, t in merges:
                spect[t] += spect[s]
                spect[s] = 0
                segSize[t] += segSize[s]
                segSize[s] = 0
                remap[remap == s] = t
    return None


def run_seed(seed):
    img, clusters, fourConnected, minSegSize, maxDiff = make_case(seed)
    seg, nxt = clump(clusters, 0, fourConnected=fourConnected)
    ref_seg, ref_nxt = oracle_clump(clusters, 0,
                                    fourConnected=fourConnected)
    if not np.array_equal(seg, ref_seg) or nxt != ref_nxt:
        return "BUG", f"clump mismatch seed={seed}"
    maxSegId = nxt - 1

    # Capped-clump parity (the reference's DEFAULT MAX_CLUMP_SIZE
    # behaviour, shepseg.py:481): the C++ scan-order flood fill must
    # reproduce the oracle's split geometry exactly. A small cap so
    # splits actually trigger at these image scales.
    cap = int(40 + (seed % 3) * 37)
    segC, nxtC = clump(clusters, 0, fourConnected=fourConnected,
                       maxClumpSize=cap)
    refC, refNxtC = oracle_clump(clusters, 0, fourConnected=fourConnected,
                                 maxClumpSize=cap)
    if not np.array_equal(segC, refC) or nxtC != refNxtC:
        return "BUG", f"capped-clump mismatch seed={seed} cap={cap}"

    ref = np.asarray(ref_seg).copy()
    ref_n1 = oracle_eliminate_single_pixels(
        img, ref, np.bincount(ref.ravel().astype(np.int64)), 1,
        fourConnected)
    got = np.asarray(seg).copy()
    got_n1 = eliminateSinglePixels(img, got, makeSegSize(got), 1,
                                   maxSegId, fourConnected)
    if got_n1 != ref_n1 or not np.array_equal(got, ref):
        return "BUG", f"single-pixel mismatch seed={seed}"

    post_single = got.copy()
    maxSegId = int(got.max())
    ref2 = ref.copy()
    ref_n2 = oracle_eliminate_small_segments(
        ref2, img, maxSegId, minSegSize, maxDiff,
        fourConnected=fourConnected)
    n2 = eliminateSmallSegments(got, img, maxSegId, minSegSize, maxDiff,
                                fourConnected=fourConnected)
    if n2 == ref_n2 and np.array_equal(got, ref2):
        return "ok", None

    hit = first_precision_sensitive_decision(
        post_single, img, minSegSize, maxDiff, fourConnected)
    if hit is not None:
        return "deviation", (f"seed={seed} documented float32 class: "
                             f"{hit}")
    return "BUG", f"small-segment mismatch seed={seed} (NOT the " \
                  f"documented deviation)"


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    first = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    bugs = 0
    for i, seed in enumerate(range(first, first + n)):
        kind, msg = run_seed(seed)
        print(f"{kind} seed={seed}" + (f": {msg}" if msg else ""),
              flush=True)
        bugs += (kind == "BUG")
        if (i + 1) % 10 == 0:
            # every random shape compiles fresh XLA:CPU programs; a
            # long-lived process accumulates gigabytes of live JIT code
            # until LLVM dies with "Cannot allocate memory" (observed
            # at ~60 seeds). Same mitigation as tests/conftest.py.
            jax.clear_caches()
    print("CAMPAIGN", "FAILED" if bugs else "PASSED", f"bugs={bugs}")
    sys.exit(1 if bugs else 0)


if __name__ == "__main__":
    main()
