#!/usr/bin/env python3
"""
Bring-up check of pyshepseg_tpu on NVIDIA cards, through the entry points
a user calls, at the reference's golden scale.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the multi-card paths, vs one card

One card (default), in one process:

1. Before JAX is imported: print the card's name and power limit, then
   run ``python -m pytest -m gpu tests/`` as a child process, which is
   the only process on the card while it runs.
2. Open the card; any platform other than "gpu" is a failure.
3. The golden end-to-end run (cmdline/runtests.py) on an 8000^2,
   101-centre, 3-band scene through doTiledShepherdSegmentation at its
   default tileSize 4096 / overlap 1024, then per-band stats, spatial
   stats, the streaming-vs-point-list check, subsetImage and the colour
   table, each against its oracle. Prints wall and compile seconds per
   step, the tile count, maxSegId, peak device memory and whether the
   native C++ library loaded.

``--four-cards`` runs only CONC_MESH over four cards, CONC_THREADS with
four workers on all cards, and segment_image_sharded over four cards,
each compared bit for bit with its one-card result.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``,
printed only when every phase passed. Any failure exits non-zero.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def cardNameAndPower():
    """nvidia-smi's name and power limit of each card (no JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi found no card: {e}")
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        fail("nvidia-smi listed no card")
    return lines


def runGpuTests():
    """Phase 1: the gpu-marked tests in a child process; the parent has
    not imported JAX, so the child is alone on the card."""
    env = dict(os.environ, PYSHEPSEG_TEST_GPU="1", JAX_PLATFORMS="cuda")
    t0 = time.perf_counter()
    rc = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "tests/", "-q",
         "-rA", "-s", "-p", "no:cacheprovider"],
        cwd=HERE, env=env).returncode
    say(f"phase gpu-tests: rc {rc}, wall {time.perf_counter() - t0:.2f} s")
    if rc != 0:
        fail(f"pytest -m gpu exited {rc}")


def openCards(count):
    import jax
    from pyshepseg_tpu import utils
    cacheDir = utils.setupCompilationCache()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        fail(f"JAX's device is {devices[0].platform!r}, not a GPU")
    if len(devices) < count:
        fail(f"need {count} cards, JAX sees {len(devices)}")
    say(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}"
        f", compile cache {cacheDir}")
    return devices


def memStats(dev):
    try:
        return dev.memory_stats() or {}
    except Exception:
        return {}


def goldenOneCard():
    """Phase 3: the golden run at the reference's scale, in-process."""
    from pyshepseg_tpu import native
    from pyshepseg_tpu.cmdline import runtests
    import jax

    timer = runtests.StepTimer(report=say)
    info = {}
    workDir = tempfile.mkdtemp(prefix="chip_smoke_")
    t0 = time.perf_counter()
    try:
        ok = runtests.runGoldenTests(directory=workDir, size=8000,
                                     ncentres=101, timer=timer, info=info)
    finally:
        timer.close()
        shutil.rmtree(workDir, ignore_errors=True)
    stats = memStats(jax.devices()[0])
    say(f"golden 8000^2/101 centres, tileSize 4096/overlap 1024: "
        f"{'passed' if ok else 'FAILED'} in "
        f"{time.perf_counter() - t0:.2f} s; tiles {info.get('numTiles')}, "
        f"maxSegId {info.get('maxSegId')}, peak_bytes_in_use "
        f"{stats.get('peak_bytes_in_use')}, native library loaded "
        f"{native.available()}")
    if not ok:
        fail("golden oracle")


def _allocCounts(devices):
    """Allocation count of each device (peak bytes where the backend
    reports no count)."""
    return [memStats(d).get("num_allocs",
                            memStats(d).get("peak_bytes_in_use", 0))
            for d in devices]


def _checkAllCardsWorked(label, devices, before):
    """Every card must have allocated device memory during the run, so
    tiles were computed there and not only on card 0."""
    after = _allocCounts(devices)
    deltas = [a - b for a, b in zip(after, before)]
    say(f"{label}: device allocations per card {deltas}, kinds "
        f"{[d.device_kind for d in devices]}")
    if not all(x > 0 for x in deltas):
        fail(f"{label}: some card did no work ({deltas})")


def fourCards(size=8000, window=4096, tileSize=None, overlapSize=None):
    """CONC_MESH, CONC_THREADS over all cards and the row-sharded
    pipeline, each bit-identical to its one-card result. The sizes
    default to the golden scale and the default tiling; smaller ones
    rehearse the logic on virtual CPU devices."""
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from pyshepseg_tpu import io as rio, shepseg, tiling
    from pyshepseg_tpu.cmdline import runtests
    from pyshepseg_tpu.parallel.shardmap_seg import segment_image_sharded

    devices = jax.devices()[:4]
    workDir = tempfile.mkdtemp(prefix="chip_smoke4_")
    try:
        _, img = runtests.goldenScene(size, 101)
        imgfile = os.path.join(workDir, "multispec.npseg")
        ds = rio.create(imgfile, size, size, runtests.NBANDS, np.uint16)
        ds.SetGeoTransform((0, 1, 0, 0, 0, -1))
        for i in range(runtests.NBANDS):
            b = ds.GetRasterBand(i + 1)
            b.SetNoDataValue(runtests.OUTNULL)
            b.WriteArray(img[i])
        ds.FlushCache()
        del ds

        def tiled(name, cfg, kmeansObj=None):
            out = os.path.join(workDir, name + ".npseg")
            t0 = time.perf_counter()
            res = tiling.doTiledShepherdSegmentation(
                imgfile, out, tileSize=tileSize or tiling.DFLT_TILESIZE,
                overlapSize=overlapSize or tiling.DFLT_OVERLAPSIZE,
                numClusters=101, fourConnected=False, kmeansObj=kmeansObj,
                outputDriver="NPSEG", concurrencyCfg=cfg)
            seg = rio.open(out).GetRasterBand(1).ReadAsArray()
            say(f"{name}: {time.perf_counter() - t0:.2f} s, maxSegId "
                f"{res.maxSegId}, tiles {res.numTileRows * res.numTileCols}")
            return res, seg

        res1, seg1 = tiled("conc_none_1card", None)
        km = res1.kmeans
        for name, cfg in (
                ("conc_mesh_4cards", tiling.SegmentationConcurrencyConfig(
                    concurrencyType=tiling.CONC_MESH,
                    tileCompletionTimeout=1200)),
                ("conc_threads_4cards", tiling.SegmentationConcurrencyConfig(
                    concurrencyType=tiling.CONC_THREADS, numWorkers=4,
                    workerDevices="all", tileCompletionTimeout=1200))):
            before = _allocCounts(devices)
            res, seg = tiled(name, cfg, km)
            _checkAllCardsWorked(name, devices, before)
            if res.maxSegId != res1.maxSegId or not np.array_equal(seg, seg1):
                fail(f"{name} differs from the one-card result")
            say(f"{name}: bit-identical to one card")

        win = np.ascontiguousarray(img[:, :window, :window])
        centers = np.asarray(km.cluster_centers_, dtype=np.float32)
        ref = shepseg.doShepherdSegmentation(
            win, kmeansObj=km, imgNullVal=runtests.OUTNULL,
            minSegmentSize=50, fourConnected=False)
        mesh = Mesh(np.array(devices), ("data",))
        before = _allocCounts(devices)
        t0 = time.perf_counter()
        segSh, maxSh = segment_image_sharded(
            win, centers, imgNullVal=runtests.OUTNULL,
            maxSpectralDiff=float(ref.maxSpectralDiff), minSegmentSize=50,
            fourConnected=False, mesh=mesh)
        say(f"segment_image_sharded {window}^2 over 4 cards: "
            f"{time.perf_counter() - t0:.2f} s, maxSegId {maxSh}")
        _checkAllCardsWorked("segment_image_sharded", devices, before)
        if maxSh != int(ref.segimg.max()) or not np.array_equal(
                np.asarray(segSh), ref.segimg):
            fail("segment_image_sharded differs from doShepherdSegmentation")
        say("segment_image_sharded: bit-identical to one card")
    finally:
        shutil.rmtree(workDir, ignore_errors=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the multi-card paths and their one-card "
                        "comparison (needs four cards)")
    args = p.parse_args()

    if not os.path.isdir(os.path.join(HERE, "pyshepseg_tpu")):
        fail("the pyshepseg_tpu package is not beside chip_smoke.py")
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and not {"cuda", "gpu"} & set(platforms.split(",")):
        fail(f"JAX_PLATFORMS={platforms} leaves JAX no GPU")
    sys.path.insert(0, HERE)
    for line in cardNameAndPower():
        say(f"card (name, power limit): {line}")

    count = 4 if args.four_cards else 1
    if not args.four_cards:
        runGpuTests()
    devices = openCards(count)
    if args.four_cards:
        fourCards()
    else:
        goldenOneCard()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
