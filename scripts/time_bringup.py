"""
Device timings behind the bring-up choices, on the golden scene
(8000^2, 101 Voronoi centres, 3 bands):

- clump at 1024^2 and 4096^2 windows of the k-means cluster image, 4-
  and 8-connected, and its share of the whole one-shot per-tile program
  at 4096^2;
- the relabel gather of _remap_and_relabel at the window's capacity;
- the stats engines (host and device) on the golden segmentation at the
  default tiling.

Every device time is the median of REPEATS runs after a warm-up run,
each ending in block_until_ready (the one-shot program: the best of
shepseg.deviceResidentThroughput's repeats). Stats times are wall clock
around the whole call, each engine run twice (cold, then warm). Run on
the card:

    python scripts/time_bringup.py [--out build/time_bringup.json]
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REPEATS = 5


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def median_s(fn, *args):
    """(median seconds of REPEATS timed runs after one warm-up, warm-up
    seconds, last result)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    warm = time.perf_counter() - t0
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), warm, out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="build/time_bringup.json")
    p.add_argument("--scene", type=int, default=8000,
                   help="scene edge (small values rehearse on the CPU)")
    p.add_argument("--sizes", default="1024,4096",
                   help="clump window edges")
    p.add_argument("--tile", type=int, default=4096,
                   help="tileSize of the stats run (overlap = tile / 4)")
    args = p.parse_args()

    import functools
    import numpy as np
    import jax
    import jax.numpy as jnp
    from pyshepseg_tpu import io as rio, shepseg, tiling, tilingstats, utils
    from pyshepseg_tpu.cmdline import runtests
    from pyshepseg_tpu.ops.clump import clump_labels
    from pyshepseg_tpu.ops.constants import SEGNULLVAL
    from pyshepseg_tpu.ops.elim_small import (_remap_and_relabel,
                                              round_capacity)
    from pyshepseg_tpu.ops.kmeans import assign_clusters, null_scalar

    utils.setupCompilationCache()
    dev = jax.devices()[0]
    rec = {"card": card() if dev.platform == "gpu" else "none",
           "device_kind": dev.device_kind,
           "platform": dev.platform, "repeats": REPEATS,
           "clump": [], "gather": [], "stats": []}
    print("card (name, power limit):", rec["card"], flush=True)

    sizes = [int(x) for x in args.sizes.split(",")]
    n = args.scene
    _, img = runtests.goldenScene(n, 101)
    win = np.ascontiguousarray(img[:, :max(sizes), :max(sizes)])
    km = shepseg.fitSpectralClusters(win, 101, 1, runtests.OUTNULL, False)
    clusters4k = assign_clusters(
        jnp.asarray(win), jnp.asarray(km.cluster_centers_.astype(np.float32)),
        null_scalar(runtests.OUTNULL, win.dtype), True).astype(jnp.int32)

    for size in sizes:
        cl = jax.block_until_ready(clusters4k[:size, :size])
        for four in (True, False):
            f = jax.jit(functools.partial(
                clump_labels, ignore_val=SEGNULLVAL, four_connected=four))
            med, warm, (seg, num, sweeps) = median_s(f, cl)
            r = {"size": size, "four_connected": four,
                 "median_ms": med * 1e3, "first_call_s": warm,
                 "clumps": int(num), "sweeps": int(sweeps)}
            rec["clump"].append(r)
            print(json.dumps(r), flush=True)

        seg, num, _ = jax.jit(functools.partial(
            clump_labels, ignore_val=SEGNULLVAL, four_connected=True))(cl)
        capacity = round_capacity(int(num) + 1)
        rng = np.random.default_rng(7)
        ids = np.arange(capacity, dtype=np.uint32)
        remap = (rng.random(capacity) * (ids + 1)).astype(np.uint32)
        remap[0] = 0
        size_out = np.bincount(remap[np.asarray(seg).ravel()],
                               minlength=capacity).astype(np.uint32)
        med, warm, _ = median_s(jax.jit(_remap_and_relabel), seg,
                                jnp.asarray(remap), jnp.asarray(size_out))
        r = {"size": size, "capacity": capacity, "median_ms": med * 1e3,
             "first_call_s": warm}
        rec["gather"].append(r)
        print(json.dumps(r), flush=True)
    del clusters4k

    # the whole one-shot per-tile program on the largest window, 4-conn
    # (doShepherdSegmentation's default), beside clump's median there
    big = max(sizes)
    rate = shepseg.deviceResidentThroughput(
        win, km, shepseg.autoMaxSpectralDiff(km, 'auto', 50),
        minSegmentSize=50, fourConnected=True,
        imgNullVal=runtests.OUTNULL, repeats=REPEATS)
    tileMs = (big * big / 1e6) / rate * 1e3
    clumpMs = [r["median_ms"] for r in rec["clump"]
               if r["size"] == big and r["four_connected"]][0]
    rec["one_shot"] = {"size": big, "best_ms": tileMs,
                       "clump_share": clumpMs / tileMs}
    print(json.dumps(rec["one_shot"]), flush=True)

    # stats engines on the golden segmentation at the default tiling
    work = tempfile.mkdtemp(prefix="time_bringup_")
    try:
        imgfile = os.path.join(work, "multispec.npseg")
        ds = rio.create(imgfile, n, n, runtests.NBANDS, np.uint16)
        ds.SetGeoTransform((0, 1, 0, 0, 0, -1))
        for i in range(runtests.NBANDS):
            b = ds.GetRasterBand(i + 1)
            b.SetNoDataValue(runtests.OUTNULL)
            b.WriteArray(img[i])
        ds.FlushCache()
        del ds
        segfile = os.path.join(work, "seg.npseg")
        t0 = time.perf_counter()
        res = tiling.doTiledShepherdSegmentation(
            imgfile, segfile, numClusters=101, fourConnected=False,
            outputDriver="NPSEG", tileSize=args.tile, overlapSize=args.tile // 4)
        print(f"golden segmentation: {time.perf_counter() - t0:.2f} s, "
              f"maxSegId {res.maxSegId}", flush=True)
        for engine in ("host", "device", "host", "device"):
            t0 = time.perf_counter()
            tilingstats.calcPerSegmentStatsTiled(
                imgfile, 1, segfile,
                [(f"m_{engine}", "mean"), (f"s_{engine}", "stddev")],
                engine=engine)
            r = {"engine": engine, "wall_s": time.perf_counter() - t0}
            rec["stats"].append(r)
            print(json.dumps(r), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    rec["peak_bytes_in_use"] = (dev.memory_stats() or {}).get(
        "peak_bytes_in_use")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print("wrote", args.out, flush=True)


if __name__ == "__main__":
    main()
