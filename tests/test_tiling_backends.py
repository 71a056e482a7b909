"""Concurrency-backend tests for the tiled driver: CONC_THREADS,
CONC_SUBPROC, CONC_MESH (incl. tilesPerDevice batching and the grown
grid), worker-device routing, and worker-failure surfacing.

Split from test_tiling.py so the process-sharded runner
(scripts/partest.py) can schedule the suite's heaviest modules on
separate workers.
"""

import numpy as np
import pytest

from pyshepseg_tpu import tiling
from pyshepseg_tpu import io as rio

from test_tiling import (make_voronoi_raster, run_tiled, check_output,
                         paths, serial_case)  # noqa: F401


def test_tiled_threads_matches_serial(serial_case, tmp_path):
    out2 = str(tmp_path / "out2.npseg")
    cfg = tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_THREADS, numWorkers=2,
        tileCompletionTimeout=600)
    res2 = run_tiled(serial_case["inpath"], out2, concurrencyCfg=cfg)
    seg2 = rio.open(out2).GetRasterBand(1).ReadAsArray()
    np.testing.assert_array_equal(serial_case["seg"], seg2)
    assert serial_case["res"].maxSegId == res2.maxSegId


def test_tiled_subproc_matches_serial(serial_case, tmp_path, monkeypatch):
    """CONC_SUBPROC drives the full remote-worker protocol — TCP channel,
    pickled tiles/results, barrier, queues, timing merge — with local
    subprocesses (the reference's fake-distributed-backend pattern,
    tiling.py:1773-1796)."""
    # Workers are fresh processes; pin them to the CPU backend (site
    # customizations can override the JAX_PLATFORMS env var).
    monkeypatch.setenv("PYSHEPSEG_TPU_PLATFORM", "cpu")
    monkeypatch.setenv(
        "JAX_COMPILATION_CACHE_DIR",
        str(tmp_path.parent / "subproc_jax_cache"))
    outpath = str(tmp_path / "out_subproc.npseg")
    cfg = tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_SUBPROC, numWorkers=2,
        tileCompletionTimeout=600, barrierTimeout=600)
    res = run_tiled(serial_case["inpath"], outpath, concurrencyCfg=cfg)
    seg = check_output(outpath, res, serial_case["img"],
                       serial_case["true_seg"])
    np.testing.assert_array_equal(seg, serial_case["seg"])
    # worker timings merged back over the channel
    summary = res.timings.makeSummaryDict()
    assert "segmentation" in summary


def test_tiles_per_device_validation():
    with pytest.raises(tiling.PyShepSegTilingError):
        tiling.SegmentationConcurrencyConfig(tilesPerDevice=0)
    with pytest.raises(tiling.PyShepSegTilingError):
        tiling.SegmentationConcurrencyConfig(workerDevices='some')


def test_tiled_threads_all_devices_matches_serial(serial_case, tmp_path):
    """workerDevices='all' routes each worker thread's tiles to a
    different local device (round-robin over the virtual 8-CPU mesh
    here, GPUs in production); output must stay bit-identical."""
    import jax
    assert len(jax.local_devices()) == 8
    out2 = str(tmp_path / "out_threads_alldev.npseg")
    # each worker's device needs its own fresh XLA:CPU compile of the
    # per-tile program (executables are cached per device set); without
    # the opt-in persistent cache the first tile can take minutes
    # 2 workers exercise the round-robin device routing across >1
    # device at half the per-device XLA:CPU compile cost of 4 (each
    # device set compiles its own executable; this test was the
    # suite's second-largest CPU sink at numWorkers=4)
    cfg = tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_THREADS, numWorkers=2,
        workerDevices='all', tileCompletionTimeout=900)
    res2 = run_tiled(serial_case["inpath"], out2, concurrencyCfg=cfg)
    seg2 = rio.open(out2).GetRasterBand(1).ReadAsArray()
    np.testing.assert_array_equal(serial_case["seg"], seg2)
    assert serial_case["res"].maxSegId == res2.maxSegId


def test_threads_worker_exception_surfaces(paths, rng, monkeypatch):
    """A worker failure must ship a WorkerErrorRecord through the
    exception queue and fail the stitch with PyShepSegTilingError
    (reference failure-detection semantics, tiling.py:918-928)."""
    inpath, outpath = paths
    make_voronoi_raster(inpath, rng)

    def boom(*args, **kwargs):
        raise RuntimeError("injected worker failure")

    monkeypatch.setattr(tiling.shepseg, "doShepherdSegmentation", boom)
    # short timeout: the workers die instantly, so the stitcher's wait
    # for the first tile is pure timeout before the exception check
    cfg = tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_THREADS, numWorkers=2,
        tileCompletionTimeout=5)
    with pytest.raises(tiling.PyShepSegTilingError):
        run_tiled(inpath, outpath, concurrencyCfg=cfg)

