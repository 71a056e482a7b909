"""
Multi-host (DCN) backend, CI-faked with local CPU processes.

Each subprocess runs the REAL multi-controller code path — JAX
distributed coordination service (barriers, KV broadcast of the k-means
model and tile grid, status/error/timing records), round-robin tile
shards, shared-storage tile hand-off, stitch on process 0 — exactly as a
multi-host GPU cluster would, just with one CPU device per process. This mirrors the
role of the reference's CONC_SUBPROC test bed
(reference: pyshepseg/tiling.py:1773-1796).
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from pyshepseg_tpu import tiling
from pyshepseg_tpu import io as rio

from test_tiling import make_voronoi_raster, run_tiled, perfect_kmeans  # noqa: F401


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


DRIVER = textwrap.dedent("""
    import os, sys, pickle
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = os.environ.get("DCN_TEST_XLA_FLAGS", "")
    import jax
    jax.config.update("jax_platforms", "cpu")
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", sys.argv[6])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    sys.path.insert(0, sys.argv[7])                    # tests/ dir
    sys.path.insert(0, os.path.dirname(sys.argv[7]))   # repo root
    from pyshepseg_tpu.parallel.dcn import (
        doTiledShepherdSegmentationDistributed)
    from test_tiling import perfect_kmeans
    (coord, pid, nproc, inpath, outpath) = sys.argv[1:6]
    res = doTiledShepherdSegmentationDistributed(
        inpath, outpath, os.path.dirname(outpath),
        tileSize=64, overlapSize=16, minSegmentSize=10, numClusters=20,
        kmeansObj=perfect_kmeans(), fourConnected=True,
        maxSpectralDiff=30.0, coordinatorAddress=coord,
        numProcesses=int(nproc), processId=int(pid), barrierTimeout=600,
        tilesPerDevice=int(os.environ.get("DCN_TEST_TPD", "1")))
    if int(pid) == 0:
        assert res is not None and res.maxSegId > 0
        print("MAXSEGID", res.maxSegId)
    else:
        assert res is None
""")


@pytest.mark.parametrize("nproc,localdev,tpd",
                         [(2, 1, 1), (3, 1, 1)])
def test_dcn_matches_serial(tmp_path, rng, nproc, localdev, tpd):
    inpath = str(tmp_path / "in.npseg")
    out_serial = str(tmp_path / "out_serial.npseg")
    img, true_seg = make_voronoi_raster(inpath, rng)
    res = run_tiled(inpath, out_serial)
    seg_serial = rio.open(out_serial).GetRasterBand(1).ReadAsArray()

    workdir = tmp_path / f"work{nproc}"
    workdir.mkdir()
    out_dcn = str(workdir / "out_dcn.npseg")
    coord = f"127.0.0.1:{_free_port()}"
    driver = tmp_path / "driver.py"
    driver.write_text(DRIVER)
    cache = str(tmp_path.parent / "dcn_jax_cache")

    env = dict(os.environ)
    env["DCN_TEST_TPD"] = str(tpd)
    if localdev > 1:
        # each fake host gets several local CPU devices, exercising the
        # per-host mesh-batch shard path (segment_tile_batch)
        env["DCN_TEST_XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={localdev}")
    procs = [subprocess.Popen(
        [sys.executable, str(driver), coord, str(pid), str(nproc),
         inpath, out_dcn, cache, os.path.dirname(
             os.path.abspath(__file__))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        universal_newlines=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for pid in range(nproc)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        # a hung fake host (e.g. a barrier bug) must not leak workers
        # that hold the coordinator port for the rest of the suite
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"proc failed:\n{out}\n{err}"

    seg_dcn = rio.open(out_dcn).GetRasterBand(1).ReadAsArray()
    np.testing.assert_array_equal(seg_serial, seg_dcn)
    assert res.maxSegId == int(
        [ln for ln in outs[0][0].splitlines()
         if ln.startswith("MAXSEGID")][0].split()[1])


def test_dcn_worker_error_surfaces(tmp_path, rng):
    """A worker failure must ship its traceback through the KV store and
    fail process 0 with PyShepSegDCNError."""
    inpath = str(tmp_path / "in.npseg")
    make_voronoi_raster(inpath, rng)
    workdir = tmp_path / "work"
    workdir.mkdir()
    out_dcn = str(workdir / "out.npseg")
    coord = f"127.0.0.1:{_free_port()}"
    sabotage = DRIVER.replace(
        "from test_tiling import perfect_kmeans",
        "from test_tiling import perfect_kmeans\n"
        "import pyshepseg_tpu.parallel.dcn as dcnmod\n"
        "if int(sys.argv[2]) == 1:\n"
        "    def boom(*a, **k):\n"
        "        raise RuntimeError('injected shard failure')\n"
        "    dcnmod._segmentTileShard = boom\n")
    driver = tmp_path / "driver.py"
    driver.write_text(sabotage)
    cache = str(tmp_path.parent / "dcn_jax_cache")

    procs = [subprocess.Popen(
        [sys.executable, str(driver), coord, str(pid), "2",
         inpath, out_dcn, cache,
         os.path.dirname(os.path.abspath(__file__))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        universal_newlines=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for pid in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    # process 0 must fail, reporting the injected error
    assert procs[0].returncode != 0
    assert "injected shard failure" in outs[0][1]
    assert "PyShepSegDCNError" in outs[0][1]
