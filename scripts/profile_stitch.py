"""
Host-side profile of the stitch WORK path (tiling.stitchTiles minus the
waits), the host leg that races the device tile loop in a pipelined
tiled run (ROADMAP S5; not yet measured on a GPU host).

Builds a synthetic 64-tile segmentation equivalent in shape to config 3
(6400^2 scene, 1024 px tiles, 256 px overlap, a few hundred segments per
tile), then times each stitchwork component separately over all tiles:

  - recode.crossing   _segsCrossingMidline (top + left strips)
  - recode.modematch  _modeMatch
  - recode.relabel    relabelSegments (bincount + mapping gather)
  - write             outBand.WriteArray of the trimmed tile (npseg)
  - overviews         writeOverviews decimated writes
  - hist              HistogramAccumulator.doHistAccum
  - overlapsave       right/bottom strip copies

Prints one JSON object of component -> seconds (total over all tiles),
plus the reconstructed stitchwork total. Run on an otherwise idle host;
numpy only (no device work).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pyshepseg_tpu import tiling, shepseg  # noqa: E402
from pyshepseg_tpu.io import raster as rio  # noqa: E402


def make_tile_seg(rng, h, w, nseg):
    """Blocky segment labels 1..~nseg: a coarse random grid upsampled to
    (h, w). Segment count and size distribution approximate a real tile;
    generation is O(h*w) with no distance tensors."""
    g = int(np.ceil(np.sqrt(nseg)))
    coarse = rng.permutation(g * g).reshape(g, g) + 1
    ys = (np.arange(h) * g) // h
    xs = (np.arange(w) * g) // w
    return coarse[np.ix_(ys, xs)].astype(shepseg.SegIdType)


class T:
    def __init__(self):
        self.acc = {}

    def add(self, key, t0):
        self.acc[key] = self.acc.get(key, 0.0) + (time.monotonic() - t0)


def main():
    rng = np.random.default_rng(11)
    scene, tile, ov = 6400, 1024, 256
    nseg = 400

    tmp = "/tmp/profile_stitch"
    os.makedirs(tmp, exist_ok=True)
    outfile = os.path.join(tmp, "stitched.npseg")
    if os.path.exists(outfile):
        import shutil
        shutil.rmtree(outfile, ignore_errors=True)

    # tile grid identical to config 3 (uniform grid, like the bench)
    ti = tiling.TileInfo()
    positions = tiling._axisTilePositions(scene, tile, ov, grow=False)
    for r, (ypos, ysize) in enumerate(positions):
        for c, (xpos, xsize) in enumerate(positions):
            ti.addTile(xpos, ypos, xsize, ysize, c, r)
    ti.ncols = ti.nrows = len(positions)

    mgr = tiling.SegmentationConcurrencyMgr.__new__(
        tiling.SegmentationConcurrencyMgr)
    mgr.tileInfo = ti
    mgr.inXsize = mgr.inYsize = scene

    outDs = rio.create(outfile, scene, scene, 1, shepseg.SegIdType)
    mgr.setupOverviews(outDs)
    outBand = outDs.GetRasterBand(1)
    outBand.SetNoDataValue(int(shepseg.SEGNULLVAL))

    # pre-generate every tile's segmentation once (excluded from timing)
    tile_segs = {}
    for (c, r), (xpos, ypos, xsize, ysize) in ti.tiles.items():
        tile_segs[(c, r)] = make_tile_seg(rng, ysize, xsize, nseg)

    overlapCache = {}
    t = T()
    maxSegId = 0
    hist = tiling.HistogramAccumulator()
    t_all = time.monotonic()
    for (col, row) in sorted(ti.tiles.keys(), key=lambda x: (x[1], x[0])):
        tileData = tile_segs[(col, row)].copy()
        (top, bottom, left, right, xout, yout, rightOv, bottomOv) = (
            mgr.tileStitchGeometry(col, row))

        recodeDict = {}
        if row > 0:
            topOv = ti.pairOverlap(col, row, 'top')
            t0 = time.monotonic()
            crossing = tiling._segsCrossingMidline(
                tileData[:topOv, :], tiling.HORIZONTAL)
            t.add("recode.crossing", t0)
            t0 = time.monotonic()
            recodeDict.update(tiling._modeMatch(
                tileData[:topOv, :],
                overlapCache[(col, row - 1, "bottom")], crossing))
            t.add("recode.modematch", t0)
        if col > 0:
            leftOv = ti.pairOverlap(col, row, 'left')
            t0 = time.monotonic()
            crossing = tiling._segsCrossingMidline(
                tileData[:, :leftOv], tiling.VERTICAL)
            t.add("recode.crossing", t0)
            t0 = time.monotonic()
            recodeDict.update(tiling._modeMatch(
                tileData[:, :leftOv],
                overlapCache[(col - 1, row, "right")], crossing))
            t.add("recode.modematch", t0)

        t0 = time.monotonic()
        mapping, maxSegId, winHist = mgr.relabelMapping(
            tileData, recodeDict, maxSegId, top, bottom, left, right)
        t.add("recode.mapping", t0)
        t0 = time.monotonic()
        trimmed = mapping[tileData[top:bottom, left:right]]
        t.add("recode.gather", t0)
        t0 = time.monotonic()
        outBand.WriteArray(trimmed, xout, yout)
        t.add("write", t0)
        # NOTE: an np.take straight into the band memmap window was
        # A/B'd here and LOST (0.55 s vs 0.24 s for gather+write over
        # the 64 tiles): numpy's unbuffered take into a strided target
        # runs element-wise, while the two-step path is two vectorized
        # row-copy loops.
        t0 = time.monotonic()
        mgr.writeOverviews(outBand, trimmed, xout, yout)
        t.add("overviews", t0)
        t0 = time.monotonic()
        hist.updateHist(winHist)
        t.add("hist", t0)

        t0 = time.monotonic()
        if rightOv > 0:
            overlapCache[(col, row, "right")] = mapping[
                tileData[:, -rightOv:]]
        if bottomOv > 0:
            overlapCache[(col, row, "bottom")] = mapping[
                tileData[-bottomOv:, :]]
        t.add("overlapsave", t0)

    total = time.monotonic() - t_all
    out = {k: round(v, 4) for k, v in sorted(t.acc.items())}
    out["TOTAL"] = round(total, 4)
    out["maxSegId"] = maxSegId
    out["mpix_per_s_stitchwork"] = round(scene * scene / 1e6 / total, 2)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
