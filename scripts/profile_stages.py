"""
Stage-level device profile of the one-shot pipeline (bench config 1
shape by default; PROFILE_SIZE / PROFILE_BANDS / PROFILE_EIGHTCONN=1
select other shapes, e.g. SIZE=2048 BANDS=6 EIGHTCONN=1 for config 2).

Times each stage of _segment_one_shot_device as its OWN jitted program
with device-resident inputs: k dispatches back to back, one
block_until_ready, best of 3. Also derives the graph-elimination loop's
PER-PASS cost by differencing min_seg_size=50 vs min_seg_size=2 runs.

Prints one JSON object of stage -> milliseconds. The per-stage total
exceeds the fused one-shot time (XLA fuses across stage boundaries and
overlaps per-dispatch host work inside a single program); it is the
RATIO between stages that directs optimization work.
"""

import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pyshepseg_tpu import shepseg, utils  # noqa: E402
from pyshepseg_tpu.ops.constants import SEGNULLVAL, MINSEGID  # noqa: E402

utils.setupCompilationCache()


def timeit_pipelined(fn, k=8, repeats=3):
    """Min time per dispatch: k enqueued back-to-back, one
    block_until_ready."""
    outs = fn()  # warm/compile
    jax.block_until_ready(outs)
    best = None
    for _ in range(repeats):
        t0 = time.time()
        res = [fn() for _ in range(k)]
        jax.block_until_ready(res)
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
    return best / k


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bench import make_image

    size = int(os.environ.get("PROFILE_SIZE", "1024"))
    nbands = int(os.environ.get("PROFILE_BANDS", "4"))
    fourConn = os.environ.get("PROFILE_EIGHTCONN", "0") != "1"
    img = make_image(size, size, nbands)
    km = shepseg.fitSpectralClusters(img, 60, 1, None, True)
    centers = jnp.asarray(np.asarray(km.cluster_centers_, np.float32))
    nullVal = shepseg.null_scalar(0, img.dtype)
    img_dev = jax.device_put(np.ascontiguousarray(img)).block_until_ready()

    from pyshepseg_tpu.ops.kmeans import assign_clusters
    from pyshepseg_tpu.ops.clump import clump_labels
    from pyshepseg_tpu.ops.elim_small import (
        edge_sort_keys_compact, compact_edges,
        eliminate_small_segments_graph, _remap_and_relabel)
    from pyshepseg_tpu.ops.segreduce import (
        seg_sizes_and_spectral_sums_planes)
    from pyshepseg_tpu.shepseg import (
        band_planes_fn, eliminate_single_pixels_device,
        _cluster_and_clump_device, _segment_one_shot_device,
        round_capacity, _edgeCapForCount, _boundaryCapForCount)

    # measured buckets (priming dispatch)
    planes, seg0, a0, b0, f0, sc0 = _cluster_and_clump_device(
        img_dev, centers, nullVal, has_null=False,
        four_connected=fourConn)
    num, nUnique, _, nPairs, nRowMax, nRunsMax = np.asarray(sc0).tolist()
    capacity = round_capacity(int(num) + 1)
    eCap = _edgeCapForCount(nUnique)
    bCap = _boundaryCapForCount(nPairs)
    rCap = shepseg._rowCapForCount(nRowMax)
    rlCap = shepseg._runCapForCount(nRunsMax)

    dev = jax.devices()[0]
    out = {"device": [dev.platform, dev.device_kind],
           "shape": [size, size, nbands], "four_connected": fourConn,
           "capacity": capacity, "e_cap": eCap, "b_cap": bCap}

    # ---- stage jits ----
    # Every stage takes its inputs as ARGUMENTS (not closures): a
    # closed-over device array is a constant in the jaxpr and XLA can
    # fold the whole stage away at compile time.
    j_assign = jax.jit(lambda im, c: assign_clusters(im, c, nullVal,
                                                     False))
    clusters = jax.block_until_ready(
        j_assign(img_dev, centers)).astype(jnp.int32)

    j_clump = jax.jit(lambda cl: clump_labels(
        cl, SEGNULLVAL, four_connected=fourConn))
    seg, _, _ = j_clump(clusters)
    seg = jax.block_until_ready(seg)

    j_edges = jax.jit(lambda s: edge_sort_keys_compact(
        s, fourConn, bCap, rCap, id_bound=capacity))
    a, b, first, _, _, _ = j_edges(seg)

    planes_j = jax.jit(lambda im: band_planes_fn(im.astype(jnp.float32)))
    planes = jax.block_until_ready(planes_j(img_dev))

    j_single = jax.jit(lambda p, s: eliminate_single_pixels_device(
        p, s, None, fourConn, do_relabel=False))
    seg1, _ = j_single(planes, seg)
    seg1 = jax.block_until_ready(seg1)

    j_reduce = jax.jit(lambda s, p: seg_sizes_and_spectral_sums_planes(
        s, p, capacity))
    size, spect = jax.block_until_ready(j_reduce(seg1, planes))

    rlEff = shepseg._rlCapEffective(rlCap, img_dev.dtype,
                                    int(img_dev.shape[2]))
    j_reduce_rl = None
    if rlEff:
        from pyshepseg_tpu.ops.segreduce import (
            seg_sizes_and_spectral_sums_runlength)
        j_reduce_rl = jax.jit(
            lambda s, p: seg_sizes_and_spectral_sums_runlength(
                s, p, capacity, rlEff))
        jax.block_until_ready(j_reduce_rl(seg1, planes))

    j_compact = jax.jit(lambda aa, bb, ff: compact_edges(
        aa, bb, ff, eCap, id_bound=capacity))
    ea, eb = jax.block_until_ready(j_compact(a, b, first))

    def graph(mss):
        return jax.jit(
            lambda ca, cb, sz, sp: eliminate_small_segments_graph(
                ca, cb, sz, sp, mss, jnp.float32(1e9)))

    j_graph50 = graph(50)
    remap, size_out, _, passes50 = j_graph50(ea, eb, size, spect)
    remap, size_out = jax.block_until_ready((remap, size_out))
    j_graph2 = graph(2)
    _, _, _, passes2 = j_graph2(ea, eb, size, spect)

    j_relabel = jax.jit(_remap_and_relabel)
    jax.block_until_ready(j_relabel(seg1, remap, size_out))

    stages = {
        "assign_clusters": lambda: j_assign(img_dev, centers),
        "clump_labels": lambda: j_clump(clusters),
        "edge_sort_compact": lambda: j_edges(seg),
        "band_planes": lambda: planes_j(img_dev),
        "single_pixel_elim": lambda: j_single(planes, seg),
        "seg_reductions": lambda: j_reduce(seg1, planes),
        **({"seg_reductions_runlength": lambda: j_reduce_rl(seg1, planes)}
           if j_reduce_rl else {}),
        "compact_edges": lambda: j_compact(a, b, first),
        "graph_elim_mss50": lambda: j_graph50(ea, eb, size, spect),
        "graph_elim_mss2": lambda: j_graph2(ea, eb, size, spect),
        "remap_relabel": lambda: j_relabel(seg1, remap, size_out),
    }
    for name, fn in stages.items():
        out[name + "_ms"] = timeit_pipelined(fn) * 1000

    p50, p2 = int(passes50), int(passes2)
    out["graph_passes_mss50"] = p50
    out["graph_passes_mss2"] = p2
    if p50 > p2:
        out["per_pass_ms"] = (
            (out["graph_elim_mss50_ms"] - out["graph_elim_mss2_ms"]) /
            (p50 - p2))

    # the fused one-shot, for the same-window reference point
    j_oneshot = (lambda: _segment_one_shot_device(
        img_dev, centers, nullVal, jnp.float32(1e9), has_null=False,
        four_connected=fourConn, min_seg_size=50, capacity=capacity,
        e_cap=eCap, b_cap=bCap, r_cap=rCap, rl_cap=rlEff))
    out["one_shot_fused_ms"] = timeit_pipelined(j_oneshot) * 1000
    out["clump_share_of_one_shot"] = (out["clump_labels_ms"] /
                                      out["one_shot_fused_ms"])

    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
