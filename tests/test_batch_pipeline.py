"""End-to-end drive of parallel_examples/tpubatch with the local backend
and a file:// object store (the CI-testable fake of the multi-node
pipeline, mirroring the role of CONC_SUBPROC for the in-driver backends)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from pyshepseg_tpu import io as rio

EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir,
                        "parallel_examples", "tpubatch")


@pytest.fixture
def scene(tmp_path, rng):
    """Small 3-band scene of coloured Voronoi-ish blobs."""
    h = w = 96
    ncells = 12
    centres = rng.uniform(0, [h, w], size=(ncells, 2)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = ((yy[..., None] - centres[:, 0]) ** 2 +
         (xx[..., None] - centres[:, 1]) ** 2)
    cells = d.argmin(axis=-1)
    palette = rng.integers(200, 9000, size=(ncells, 3)).astype(np.uint16)
    path = str(tmp_path / "scene.npseg")
    ds = rio.create(path, w, h, 3, np.uint16)
    ds.SetGeoTransform((0, 1, 0, 0, 0, -1))
    for b in range(3):
        band = ds.GetRasterBand(b + 1)
        band.SetNoDataValue(0)
        band.WriteArray(palette[cells, b])
    ds.FlushCache()
    return path


def test_local_batch_pipeline(scene, tmp_path):
    store = "file://" + str(tmp_path / "store")
    env = dict(os.environ,
               XLA_FLAGS=os.environ.get("XLA_FLAGS", ""),
               # the package-level knob as well as JAX_PLATFORMS: a site
               # customisation may override the plain env var
               PYSHEPSEG_TPU_PLATFORM="cpu",
               JAX_PLATFORMS="cpu")
    cmd = [sys.executable,
           os.path.join(EXAMPLES, "submit_pyshepseg_job.py"),
           "--backend", "local", "--infile", scene, "--store", store,
           "--tilesize", "64", "--overlapsize", "32",
           "--nclusters", "12", "--statsbands", "1", "--workers", "2"]
    # generous timeout: worker subprocesses recompile after any kernel
    # change and may contend with other suite processes for the device
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=1800)
    assert res.returncode == 0, res.stdout + res.stderr

    outpath = str(tmp_path / "store" / "segmentation.npseg")
    ds = rio.open(outpath)
    seg = ds.GetRasterBand(1).ReadAsArray()
    assert seg.shape == (96, 96)
    assert seg.max() >= 1
    # contiguous IDs and a histogram RAT present
    rat = ds.GetRasterBand(1).GetDefaultRAT()
    names = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    assert "Histogram" in names and "Band_1_mean" in names
    hist = rat.ReadAsArray(names.index("Histogram"))
    assert len(hist) > int(seg.max())   # a row for every ID
    np.testing.assert_array_equal(
        np.unique(seg[seg > 0]), np.arange(1, seg.max() + 1))
    counts = np.bincount(seg.ravel(), minlength=len(hist))
    np.testing.assert_array_equal(hist[1:].astype(np.int64),
                                  counts[1:len(hist)])
    # tiles cleaned from the store after stitch
    leftover = [f for f in os.listdir(str(tmp_path / "store"))
                if f.startswith("tile_")]
    assert leftover == []


def test_slurm_emit(scene, tmp_path):
    emit = str(tmp_path / "jobs")
    cmd = [sys.executable,
           os.path.join(EXAMPLES, "submit_pyshepseg_job.py"),
           "--backend", "slurm", "--infile", scene,
           "--store", "file:///x", "--emit-dir", emit]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    files = sorted(os.listdir(emit))
    assert files == ["psseg_prepare.sbatch", "psseg_stitch.sbatch",
                     "psseg_tiles.sbatch", "submit_all.sh"]
    # array size and job-id dependencies are wired at submission time by
    # the orchestrator (sbatch CLI options override in-file directives)
    orch = open(os.path.join(emit, "submit_all.sh")).read()
    assert "--array=0-$((numtiles - 1))" in orch
    assert "--dependency=afterok:${tiles_id}" in orch
    assert "--parsable --wait" in orch
    import subprocess as sp
    assert sp.run(["bash", "-n", os.path.join(emit, "submit_all.sh")],
                  capture_output=True).returncode == 0


def test_objectstore_cloud_backend_handles_directories(tmp_path):
    # .npseg artifacts are DIRECTORIES; the cloud backends must store
    # one object per contained file and reassemble on download. Exercise
    # the walk/list/reassemble logic through a stubbed per-object layer.
    sys.path.insert(0, EXAMPLES)
    try:
        from objstore import ObjectStore
    finally:
        sys.path.pop(0)

    class FakeCloudStore(ObjectStore):
        def __init__(self):
            self.kind = "s3"
            self.prefix = "pfx"
            self.objects = {}

        def _uploadFile(self, localPath, key):
            with open(localPath, "rb") as f:
                self.objects[self._key(key)] = f.read()

        def _downloadFile(self, key, localPath):
            with open(localPath, "wb") as f:
                f.write(self.objects[self._key(key)])

        def _deleteObject(self, key):
            self.objects.pop(self._key(key), None)

        def _listSubKeys(self, key):
            pfx = self._key(key) + "/"
            return [k[len(pfx):] for k in self.objects if k.startswith(pfx)]

    store = FakeCloudStore()
    src = tmp_path / "tile.npseg"
    (src / "sub").mkdir(parents=True)
    (src / "meta.json").write_text("{}")
    (src / "band_1.npy").write_bytes(b"\x01\x02")
    (src / "sub" / "col_0.npy").write_bytes(b"\x03")

    store.upload(str(src), "tiles/tile_0_0.npseg")
    assert set(store.objects) == {
        "pfx/tiles/tile_0_0.npseg/meta.json",
        "pfx/tiles/tile_0_0.npseg/band_1.npy",
        "pfx/tiles/tile_0_0.npseg/sub/col_0.npy"}

    dst = tmp_path / "back.npseg"
    store.download("tiles/tile_0_0.npseg", str(dst))
    assert (dst / "meta.json").read_text() == "{}"
    assert (dst / "band_1.npy").read_bytes() == b"\x01\x02"
    assert (dst / "sub" / "col_0.npy").read_bytes() == b"\x03"

    # plain single files still round-trip
    one = tmp_path / "prepare.pkl"
    one.write_bytes(b"pickle")
    store.upload(str(one), "prepare.pkl")
    got = tmp_path / "prepare_back.pkl"
    store.download("prepare.pkl", str(got))
    assert got.read_bytes() == b"pickle"

    store.delete("tiles/tile_0_0.npseg")
    store.delete("prepare.pkl")
    assert store.objects == {}
