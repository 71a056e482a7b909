"""CONC_MESH backend tests for the tiled driver (tile batches
sharded over the virtual 8-device mesh, tilesPerDevice batching, nodata
propagation, grown grids).

Split from test_tiling_backends.py: each tilesPerDevice value compiles
its own batched mesh programs, making this the suite's heaviest
single module — its own worker slot halves the longest pole.
"""

import numpy as np
import pytest

from pyshepseg_tpu import tiling
from pyshepseg_tpu import io as rio

from test_tiling import (make_voronoi_raster, run_tiled, check_output,
                         paths, serial_case)  # noqa: F401


def test_tiled_mesh_matches_serial(serial_case, tmp_path):
    """CONC_MESH shards tile batches over the (virtual, 8-device) mesh and
    runs the fused per-tile pipeline on each device; the stitched result
    must be identical to the serial backend."""
    import jax
    assert len(jax.devices()) == 8  # conftest's virtual CPU mesh
    outpath = str(tmp_path / "out_mesh.npseg")
    cfg = tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_MESH, numWorkers=0)
    res = run_tiled(serial_case["inpath"], outpath, concurrencyCfg=cfg)
    seg = check_output(outpath, res, serial_case["img"],
                       serial_case["true_seg"])
    np.testing.assert_array_equal(seg, serial_case["seg"])


@pytest.mark.parametrize("tpd", [2, 3])
def test_tiled_mesh_tiles_per_device_matches_serial(serial_case, tmp_path,
                                                    tpd):
    """tilesPerDevice>1 vmap-batches several tiles into each per-device
    dispatch; the batched fixpoint loops run until the slowest batch
    member converges, but every tile's result must stay bit-identical.
    tpd=2 divides the tile count exactly; tpd=3 exercises the
    pad-to-full-chunk path."""
    import jax
    assert len(jax.devices()) == 8
    outpath = str(tmp_path / "out_mesh_tpd.npseg")
    cfg = tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_MESH, numWorkers=0, tilesPerDevice=tpd)
    res = run_tiled(serial_case["inpath"], outpath, concurrencyCfg=cfg)
    seg = check_output(outpath, res, serial_case["img"],
                       serial_case["true_seg"])
    np.testing.assert_array_equal(seg, serial_case["seg"])


def test_tiled_mesh_with_nodata(paths, rng, tmp_path):
    """CONC_MESH must propagate nodata through the native-dtype batch
    (null comparison runs in the image dtype inside the fused pipeline)."""
    inpath, outpath = paths
    img, true_seg = make_voronoi_raster(inpath, rng, nodata=0)
    # punch a null hole through the scene
    ds = rio.open(inpath, rio.GA_Update)
    for b in range(1, 4):
        band = ds.GetRasterBand(b)
        arr = band.ReadAsArray()
        arr[10:30, 40:70] = 0
        band.WriteArray(arr)
    ds.FlushCache()
    cfg = tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_MESH, numWorkers=0)
    res = run_tiled(inpath, outpath, concurrencyCfg=cfg, imgNullVal=0)
    seg = rio.open(outpath).GetRasterBand(1).ReadAsArray()
    assert (seg[10:30, 40:70] == 0).all()          # hole stays null
    assert not res.hasEmptySegments
    assert seg.max() == res.maxSegId


def test_tiled_mesh_grow_grid_matches_serial(paths, rng, tmp_path):
    """CONC_MESH with the grown-edge grid: multiple tile shapes means
    multiple compiled SPMD groups per scene; batched (tilesPerDevice=2)
    output must still be bit-identical to serial."""
    inpath, outpath = paths
    img, true_seg = make_voronoi_raster(inpath, rng, shape=(150, 170))
    res_s = run_tiled(inpath, outpath, tileGrid='grow')
    seg_s = rio.open(outpath).GetRasterBand(1).ReadAsArray()

    out_m = str(tmp_path / "out_mesh_grow.npseg")
    cfg = tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_MESH, tilesPerDevice=2)
    res_m = run_tiled(inpath, out_m, tileGrid='grow', concurrencyCfg=cfg)
    seg_m = rio.open(out_m).GetRasterBand(1).ReadAsArray()
    np.testing.assert_array_equal(seg_s, seg_m)
    assert res_s.maxSegId == res_m.maxSegId
