"""Tests for per-segment statistics (tilingstats) against brute-force
oracles implementing the reference semantics."""

import numpy as np
import pytest

from pyshepseg_tpu import tilingstats, tiling
from pyshepseg_tpu import io as rio


NODATA = 255


def make_seg_and_img(tmp_path, rng, shape=(120, 130), nseg=40,
                     img_nodata=NODATA):
    """Random segmentation + image rasters with Histogram RAT column."""
    h, w = shape
    # random blobs: nearest of nseg random centres (so segments are compact)
    centres = rng.uniform(0, [h, w], size=(nseg, 2))
    yy, xx = np.mgrid[0:h, 0:w]
    d = ((yy[..., None] - centres[:, 0]) ** 2 +
         (xx[..., None] - centres[:, 1]) ** 2)
    seg = (d.argmin(axis=-1) + 1).astype(np.uint32)
    # some null segment area
    seg[:3, :] = 0

    img = rng.integers(0, 100, size=shape).astype(np.uint16)
    # scatter nodata pixels
    nd = rng.random(shape) < 0.05
    img[nd] = img_nodata

    segpath = str(tmp_path / "seg.npseg")
    imgpath = str(tmp_path / "img.npseg")
    segds = rio.create(segpath, w, h, 1, np.uint32)
    segds.GetRasterBand(1).WriteArray(seg)
    hist = np.bincount(seg.ravel(), minlength=int(seg.max()) + 1
                       ).astype(np.float64)
    hist[0] = 0
    rat = segds.GetRasterBand(1).GetDefaultRAT()
    rat.CreateColumn("Histogram", rio.GFT_Real, rio.GFU_PixelCount)
    rat.WriteArray(hist, 0)

    imgds = rio.create(imgpath, w, h, 1, np.uint16)
    band = imgds.GetRasterBand(1)
    band.WriteArray(img)
    if img_nodata is not None:
        band.SetNoDataValue(img_nodata)
    return segpath, imgpath, seg, img


def ref_stats(seg, img, sid, nodata):
    """Reference-semantics per-segment stats, brute force."""
    vals = img[seg == sid].astype(np.int64)
    vals = np.sort(vals[vals != nodata])
    out = {}
    pc = len(vals)
    out['pixcount'] = pc
    if pc == 0:
        return out
    out['min'] = vals[0]
    out['max'] = vals[-1]
    mean32 = np.float32(vals.sum() / pc)
    out['mean'] = mean32
    out['stddev'] = np.float32(np.sqrt(((vals - mean32) ** 2).sum() / pc))
    uniq, counts = np.unique(vals, return_counts=True)
    out['mode'] = uniq[np.argmax(counts)]

    def pcntile(p):
        target = pc * (p / 100)
        cum = 0
        i = 0
        while cum < target:
            cum += counts[i]
            i += 1
        return uniq[i - 1]

    out['median'] = pcntile(50)
    out['p25'] = pcntile(25)
    out['p75'] = pcntile(75)
    return out


@pytest.fixture
def small_tiles(monkeypatch):
    """Force small internal stats tiles so streaming is exercised."""
    monkeypatch.setattr(tiling, "TILESIZE", 48)


def test_per_segment_stats(tmp_path, rng, small_tiles):
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)
    sel = [("b1_min", "min"), ("b1_max", "max"), ("b1_mean", "mean"),
           ("b1_std", "stddev"), ("b1_med", "median"), ("b1_mode", "mode"),
           ("b1_p25", "percentile", 25), ("b1_p75", "percentile", 75),
           ("b1_n", "pixcount")]
    res = tilingstats.calcPerSegmentStatsTiled(imgpath, 1, segpath, sel)
    assert res.timings is not None

    rat = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    names = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    cols = {n: rat.ReadAsArray(names.index(n)) for n in
            ("b1_min", "b1_max", "b1_mean", "b1_std", "b1_med", "b1_mode",
             "b1_p25", "b1_p75", "b1_n")}

    for sid in range(1, int(seg.max()) + 1):
        want = ref_stats(seg, img, sid, NODATA)
        assert cols["b1_n"][sid] == want['pixcount']
        if want['pixcount'] == 0:
            assert cols["b1_min"][sid] == -9999
            continue
        assert cols["b1_min"][sid] == want['min']
        assert cols["b1_max"][sid] == want['max']
        np.testing.assert_allclose(cols["b1_mean"][sid], want['mean'],
                                   rtol=1e-6)
        np.testing.assert_allclose(cols["b1_std"][sid], want['stddev'],
                                   rtol=1e-5, atol=1e-5)
        assert cols["b1_med"][sid] == want['median']
        assert cols["b1_mode"][sid] == want['mode']
        assert cols["b1_p25"][sid] == want['p25']
        assert cols["b1_p75"][sid] == want['p75']


def test_all_nodata_segment(tmp_path, rng, small_tiles):
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng,
                                                  shape=(60, 60), nseg=6)
    # make one whole segment nodata
    imgds = rio.open(imgpath, rio.GA_Update)
    band = imgds.GetRasterBand(1)
    data = band.ReadAsArray()
    data[seg == 3] = NODATA
    band.WriteArray(data)

    sel = [("m", "mean"), ("n", "pixcount")]
    tilingstats.calcPerSegmentStatsTiled(imgpath, 1, segpath, sel,
                                         missingStatsValue=-42)
    rat = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    names = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    assert rat.ReadAsArray(names.index("m"))[3] == -42
    assert rat.ReadAsArray(names.index("n"))[3] == 0


def test_every_segment_all_nodata(tmp_path, rng, small_tiles):
    """Whole image nodata: every finalization round completes only
    zero-run segments — regression for the empty-cumsum crash in the
    median/percentile walk."""
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng,
                                                  shape=(60, 60), nseg=6)
    imgds = rio.open(imgpath, rio.GA_Update)
    band = imgds.GetRasterBand(1)
    band.WriteArray(np.full_like(img, NODATA))

    sel = [("md", "median"), ("p9", "percentile", 90), ("n", "pixcount")]
    tilingstats.calcPerSegmentStatsTiled(imgpath, 1, segpath, sel,
                                         missingStatsValue=-42)
    rat = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    names = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    for sid in range(1, int(seg.max()) + 1):
        assert rat.ReadAsArray(names.index("md"))[sid] == -42
        assert rat.ReadAsArray(names.index("p9"))[sid] == -42
        assert rat.ReadAsArray(names.index("n"))[sid] == 0


def test_float_image_rejected(tmp_path, rng):
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng,
                                                  shape=(40, 40), nseg=4)
    fpath = str(tmp_path / "f.npseg")
    ds = rio.create(fpath, 40, 40, 1, np.float32)
    ds.GetRasterBand(1).WriteArray(np.zeros((40, 40), np.float32))
    with pytest.raises(tilingstats.PyShepSegStatsError,
                       match="Float image"):
        tilingstats.calcPerSegmentStatsTiled(fpath, 1, segpath,
                                             [("m", "mean")])


def test_missing_histogram_column(tmp_path, rng):
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng,
                                                  shape=(40, 40), nseg=4)
    seg2 = str(tmp_path / "seg2.npseg")
    ds = rio.create(seg2, 40, 40, 1, np.uint32)
    ds.GetRasterBand(1).WriteArray(seg[:40, :40])
    with pytest.raises(tilingstats.PyShepSegStatsError,
                       match="Histogram"):
        tilingstats.calcPerSegmentStatsTiled(imgpath, 1, seg2,
                                             [("m", "mean")])


def test_size_mismatch_rejected(tmp_path, rng):
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng,
                                                  shape=(40, 40), nseg=4)
    other = str(tmp_path / "other.npseg")
    ds = rio.create(other, 30, 30, 1, np.uint16)
    ds.GetRasterBand(1).WriteArray(np.zeros((30, 30), np.uint16))
    with pytest.raises(tilingstats.PyShepSegStatsError, match="same size"):
        tilingstats.calcPerSegmentStatsTiled(other, 1, segpath,
                                             [("m", "mean")])


# ------------------------------------------------------------ spatial


def test_spatial_mean_coord(tmp_path, rng, small_tiles):
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)
    transform = np.array([0.0, 1.0, 0.0, 0.0, 0.0, 1.0])
    cols = [("easting", rio.GFT_Real), ("northing", rio.GFT_Real)]
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath, cols, tilingstats.userFuncMeanCoord,
        transform)
    rat = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    names = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    e = rat.ReadAsArray(names.index("easting"))
    n = rat.ReadAsArray(names.index("northing"))
    for sid in range(1, int(seg.max()) + 1):
        inseg = (seg == sid) & (img != NODATA)
        if inseg.sum() == 0:
            continue
        rows, colsIdx = np.nonzero(inseg)
        np.testing.assert_allclose(e[sid], colsIdx.mean(), atol=3e-4)
        np.testing.assert_allclose(n[sid], rows.mean(), atol=3e-4)


def test_spatial_edge_pixels(tmp_path, rng, small_tiles):
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng,
                                                  shape=(80, 80), nseg=8)
    cols = [("edgepix", rio.GFT_Integer)]
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath, cols, tilingstats.userFuncNumEdgePixels, True)
    rat = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    names = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    edgecol = rat.ReadAsArray(names.index("edgepix"))

    # brute-force oracle following the reference definition: mask of valid
    # (non-nodata) segment pixels over the segment's bounding box; edge =
    # mask pixel with any missing 4-neighbour (bbox border counts)
    for sid in range(1, int(seg.max()) + 1):
        inseg = (seg == sid) & (img != NODATA)
        if inseg.sum() == 0:
            continue
        rows, colsIdx = np.nonzero(inseg)
        mask = np.zeros((rows.max() - rows.min() + 1,
                         colsIdx.max() - colsIdx.min() + 1), np.uint8)
        mask[rows - rows.min(), colsIdx - colsIdx.min()] = 1
        want = 0
        for (r, c) in zip(*np.nonzero(mask)):
            if (r == 0 or c == 0 or r == mask.shape[0] - 1 or
                    c == mask.shape[1] - 1):
                want += 1
            elif (mask[r - 1, c] + mask[r + 1, c] + mask[r, c - 1] +
                  mask[r, c + 1]) < 4:
                want += 1
        assert edgecol[sid] == want, f"segment {sid}"


def _edge_oracle(seg, img, fourConnected):
    """Brute-force reference-semantics edge counts: bbox mask of valid
    segment pixels, edge = any missing neighbour (bbox border counts)."""
    if fourConnected:
        offs = ((-1, 0), (1, 0), (0, -1), (0, 1))
    else:
        offs = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1),
                (1, -1), (1, 0), (1, 1))
    out = {}
    for sid in range(1, int(seg.max()) + 1):
        inseg = (seg == sid) & (img != NODATA)
        if inseg.sum() == 0:
            continue
        rows, colsIdx = np.nonzero(inseg)
        mask = np.zeros((rows.max() - rows.min() + 3,
                         colsIdx.max() - colsIdx.min() + 3), bool)
        mask[rows - rows.min() + 1, colsIdx - colsIdx.min() + 1] = True
        want = 0
        for (r, c) in zip(*np.nonzero(mask)):
            if not all(mask[r + dr, c + dc] for (dr, dc) in offs):
                want += 1
        out[sid] = want
    return out


@pytest.mark.parametrize("fourConnected", [True, False])
def test_spatial_edge_pixels_streaming_vs_point_route(tmp_path, rng,
                                                      small_tiles,
                                                      fourConnected):
    """The streaming halo route (auto-substituted for
    userFuncNumEdgePixels on the host engine) must agree bit-for-bit
    with the point-list accumulator route AND the brute-force oracle,
    for both connectivities, across tile boundaries and nodata."""
    import shutil
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng,
                                                  shape=(100, 110),
                                                  nseg=12)
    segpath2 = str(tmp_path / "segpt.npseg")
    shutil.copytree(segpath, segpath2)
    cols = [("edgepix", rio.GFT_Integer)]

    # streaming route (identity-substituted)
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath, cols, tilingstats.userFuncNumEdgePixels,
        fourConnected)

    # point-list route: a wrapper defeats the identity substitution
    def pointRoute(pts, imgNullVal, intArr, floatArr, param):
        return tilingstats.userFuncNumEdgePixels(pts, imgNullVal,
                                                 intArr, floatArr, param)
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath2, cols, pointRoute, fourConnected)

    want = _edge_oracle(seg, img, fourConnected)
    for path in (segpath, segpath2):
        rat = rio.open(path).GetRasterBand(1).GetDefaultRAT()
        names = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
        got = rat.ReadAsArray(names.index("edgepix"))
        for sid, w in want.items():
            assert got[sid] == w, (path, sid)


def test_spatial_edge_pixels_streaming_threaded_reads(tmp_path, rng,
                                                      small_tiles):
    """Halo reads on worker threads give the identical result as serial
    (the expanded clamped windows are pure per-tile reads)."""
    import shutil
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng,
                                                  shape=(100, 110),
                                                  nseg=10)
    segpath2 = str(tmp_path / "segser.npseg")
    shutil.copytree(segpath, segpath2)
    cols = [("edgepix", rio.GFT_Integer)]
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath, cols, tilingstats.userFuncNumEdgePixels,
        True, numReadWorkers=2)
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath2, cols, tilingstats.userFuncNumEdgePixels,
        True, numReadWorkers=0)
    a = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    b = rio.open(segpath2).GetRasterBand(1).GetDefaultRAT()
    na = [a.GetNameOfCol(i) for i in range(a.GetColumnCount())]
    nb = [b.GetNameOfCol(i) for i in range(b.GetColumnCount())]
    np.testing.assert_array_equal(a.ReadAsArray(na.index("edgepix")),
                                  b.ReadAsArray(nb.index("edgepix")))


def test_spatial_variogram(tmp_path, rng, small_tiles):
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng,
                                                  shape=(60, 60), nseg=5)
    maxDist = 2
    cols = [("vario1", rio.GFT_Real), ("vario2", rio.GFT_Real)]
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath, cols, tilingstats.userFuncVariogram, maxDist)
    rat = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    names = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    v1 = rat.ReadAsArray(names.index("vario1"))
    v2 = rat.ReadAsArray(names.index("vario2"))

    # brute force from the reference's loop definition
    for sid in range(1, int(seg.max()) + 1):
        inseg = (seg == sid) & (img != NODATA)
        if inseg.sum() == 0:
            continue
        rows, colsIdx = np.nonzero(inseg)
        tile = np.full((rows.max() - rows.min() + 1,
                        colsIdx.max() - colsIdx.min() + 1), NODATA,
                       np.int64)
        tile[rows - rows.min(), colsIdx - colsIdx.min()] = (
            img[inseg].astype(np.int64))
        counts = np.zeros(maxDist)
        sums = np.zeros(maxDist)
        ys, xs = tile.shape
        for y in range(ys):
            for x in range(xs):
                if tile[y, x] == NODATA:
                    continue
                for yo in range(1, maxDist + 1):
                    for xo in range(1, maxDist + 1):
                        if y + yo < ys and x + xo < xs:
                            val2 = tile[y + yo, x + xo]
                            if val2 == NODATA:
                                continue
                            dist = int(np.sqrt(yo * yo + xo * xo))
                            if 0 < dist <= maxDist:
                                counts[dist - 1] += 1
                                sums[dist - 1] += (tile[y, x] - val2) ** 2
        for n, col in ((0, v1), (1, v2)):
            if counts[n] > 0:
                np.testing.assert_allclose(
                    col[sid], np.sqrt(sums[n] / counts[n]), rtol=1e-6)


def test_spatial_variogram_streaming_vs_point_route(tmp_path, rng,
                                                    small_tiles):
    """The streaming maxDist-halo variogram route (auto-substituted on
    the host engine) must agree with the point-list route to float64
    summation-order tolerance, across tile boundaries and nodata,
    including the missing-value bins."""
    import shutil
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng,
                                                  shape=(100, 110),
                                                  nseg=14)
    segpath2 = str(tmp_path / "segpt.npseg")
    shutil.copytree(segpath, segpath2)
    maxDist = 3
    cols = [(f"vario{d}", rio.GFT_Real) for d in range(1, maxDist + 1)]

    # streaming route (identity-substituted)
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath, cols, tilingstats.userFuncVariogram, maxDist)

    # point-list route: a wrapper defeats the identity substitution
    def pointRoute(pts, imgNullVal, intArr, floatArr, param):
        return tilingstats.userFuncVariogram(pts, imgNullVal, intArr,
                                             floatArr, param)
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath2, cols, pointRoute, maxDist)

    ratS = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    ratP = rio.open(segpath2).GetRasterBand(1).GetDefaultRAT()
    nS = [ratS.GetNameOfCol(i) for i in range(ratS.GetColumnCount())]
    nP = [ratP.GetNameOfCol(i) for i in range(ratP.GetColumnCount())]
    for (c, _t) in cols:
        a = ratS.ReadAsArray(nS.index(c))
        b = ratP.ReadAsArray(nP.index(c))
        # missing bins (-9999) must agree exactly; live bins to fp
        # summation-order tolerance
        np.testing.assert_array_equal(a == -9999, b == -9999, err_msg=c)
        np.testing.assert_allclose(a, b, rtol=1e-9, err_msg=c)


def test_spatial_variogram_large_maxdist_uses_point_route(tmp_path, rng,
                                                          small_tiles):
    """maxDist past the streaming cutoff still runs (point route)."""
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng,
                                                  shape=(60, 60), nseg=4)
    maxDist = 9   # > the streaming cutoff of 8
    cols = [(f"vbig{d}", rio.GFT_Real) for d in range(1, maxDist + 1)]
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath, cols, tilingstats.userFuncVariogram, maxDist)
    rat = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    names = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    assert "vbig1" in names


def test_threaded_read_workers_match_serial(tmp_path, rng):
    """numReadWorkers pipelining must be bit-identical to serial."""
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)
    tilingstats.calcPerSegmentStatsTiled(
        imgpath, 1, segpath,
        [("m0", "mean"), ("p0", "percentile", 30)], numReadWorkers=0)
    tilingstats.calcPerSegmentStatsTiled(
        imgpath, 1, segpath,
        [("m3", "mean"), ("p3", "percentile", 30)], numReadWorkers=3)
    rat = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    names = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    for a, b in (("m0", "m3"), ("p0", "p3")):
        va = rat.ReadAsArray(names.index(a))
        vb = rat.ReadAsArray(names.index(b))
        assert (va == vb).all()


def test_wide_value_range_falls_back_to_lexsort(tmp_path, rng):
    """int64 imagery whose (segments x value-range) exceeds the dense
    bincount budget must take the lexsort path, same results."""
    from pyshepseg_tpu.tilingstats import compactTile
    seg = rng.integers(1, 50, (64, 64)).astype(np.uint32)
    # huge spread: guarantees nbins > 1<<25
    img = rng.integers(-2**40, 2**40, (64, 64)).astype(np.int64)
    seen, noData, rs, rv, rc = compactTile(seg, img, None, 64)
    # brute-force RLE oracle
    pairs = {}
    for s, v in zip(seg.ravel(), img.ravel()):
        pairs[(int(s), int(v))] = pairs.get((int(s), int(v)), 0) + 1
    want = sorted(pairs.items())
    got = list(zip(zip(rs.tolist(), rv.tolist()), rc.tolist()))
    assert got == [((s, v), c) for (s, v), c in want]
    assert seen.sum() == seg.size


def test_spatial_threaded_read_workers_match_serial(tmp_path, rng):
    """Spatial stats with threaded read workers must be identical to
    serial (including per-segment point order feeding user funcs)."""
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)
    transform = (0.0, 10.0, 0.0, 0.0, 0.0, -10.0)
    for path in (segpath, imgpath):
        ds = rio.open(path, rio.GA_Update)
        ds.SetGeoTransform(transform)
        ds.FlushCache()
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath, [("x0", rio.GFT_Real), ("y0", rio.GFT_Real)],
        tilingstats.userFuncMeanCoord, transform, numReadWorkers=0)
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath, [("x3", rio.GFT_Real), ("y3", rio.GFT_Real)],
        tilingstats.userFuncMeanCoord, transform, numReadWorkers=3)
    rat = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    names = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    for a, b in (("x0", "x3"), ("y0", "y3")):
        va = rat.ReadAsArray(names.index(a))
        vb = rat.ReadAsArray(names.index(b))
        assert (va == vb).all()


def test_vectorized_stats_from_runs_matches_reference_loop(rng):
    """Differential check: the grouped-vector _segmentStatsFromRuns must
    reproduce the reference SegmentStats walk (tilingstats.py:906-1008)
    per segment, including ties, empty groups, and the p<=0 quirk."""
    nseg = 200
    vals_l, counts_l, start, end = [], [], [], []
    pos = 0
    for i in range(nseg):
        nruns = int(rng.integers(0, 12))
        v = np.unique(rng.integers(-50, 50, size=nruns))
        c = rng.integers(1, 9, size=len(v))
        vals_l.append(v.astype(np.int64))
        counts_l.append(c.astype(np.int64))
        start.append(pos)
        pos += len(v)
        end.append(pos)
    vals = np.concatenate(vals_l) if vals_l else np.empty(0, np.int64)
    counts = np.concatenate(counts_l) if counts_l else np.empty(0, np.int64)
    start = np.array(start, dtype=np.int64)
    end = np.array(end, dtype=np.int64)

    def ref_loop(statID, param):
        out = np.empty(nseg, dtype=np.float64)
        for i in range(nseg):
            v = vals[start[i]:end[i]]
            c = counts[start[i]:end[i]]
            pc = int(c.sum())
            if statID == tilingstats.STATID_PIXCOUNT:
                out[i] = pc
                continue
            if pc == 0:
                out[i] = -9999
                continue
            if statID == tilingstats.STATID_MIN:
                out[i] = v[0]
            elif statID == tilingstats.STATID_MAX:
                out[i] = v[-1]
            elif statID == tilingstats.STATID_MEAN:
                out[i] = np.float32((v * c).sum() / pc)
            elif statID == tilingstats.STATID_STDDEV:
                m = np.float32((v * c).sum() / pc)
                out[i] = np.float32(np.sqrt((c * (v - m) ** 2).sum() / pc))
            elif statID == tilingstats.STATID_MODE:
                out[i] = v[np.argmax(c)]
            else:
                p = 50 if statID == tilingstats.STATID_MEDIAN else param
                target = pc * (p / 100)
                cum = np.cumsum(c)
                if target <= 0:
                    out[i] = v[-1]
                else:
                    k = int(np.searchsorted(cum, target, side='left'))
                    out[i] = v[min(k, len(v) - 1)]
        return out

    cases = [(tilingstats.STATID_MIN, 0), (tilingstats.STATID_MAX, 0),
             (tilingstats.STATID_MEAN, 0), (tilingstats.STATID_STDDEV, 0),
             (tilingstats.STATID_MODE, 0), (tilingstats.STATID_MEDIAN, 0),
             (tilingstats.STATID_PERCENTILE, 0),
             (tilingstats.STATID_PERCENTILE, 25),
             (tilingstats.STATID_PERCENTILE, 100),
             (tilingstats.STATID_PIXCOUNT, 0)]
    for statID, param in cases:
        got = tilingstats._segmentStatsFromRuns(
            vals, counts, start, end, statID, param, -9999)
        want = ref_loop(statID, param)
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"statID={statID} p={param}")


def test_stats_from_runs_all_segments_empty():
    """Regression: a finalization round where EVERY completing segment is
    all-nodata (zero runs) must emit missingStatsValue, not crash on the
    empty cumsum in the percentile walk."""
    empty = np.empty(0, np.int64)
    start = np.zeros(3, np.int64)
    end = np.zeros(3, np.int64)
    for statID, param, want in [
            (tilingstats.STATID_MEDIAN, 0, -9999),
            (tilingstats.STATID_PERCENTILE, 75, -9999),
            (tilingstats.STATID_MIN, 0, -9999),
            (tilingstats.STATID_PIXCOUNT, 0, 0)]:
        got = tilingstats._segmentStatsFromRuns(
            empty, empty, start, end, statID, param, -9999)
        np.testing.assert_array_equal(got, np.full(3, want, np.float64),
                                      err_msg=f"statID={statID}")


def test_device_compaction_matches_host(rng):
    """compactTileDevice must emit exactly the runs compactTile does —
    same (segId, value) order, same counts, same seen/nodata tallies."""
    from pyshepseg_tpu.ops import segstats

    h, w = 100, 90
    seg = rng.integers(0, 30, size=(h, w)).astype(np.uint32)
    img = rng.integers(0, 60, size=(h, w)).astype(np.uint16)
    img[rng.random((h, w)) < 0.05] = NODATA
    numSeg = 30
    for nullVal in (NODATA, None):
        host = tilingstats.compactTile(seg, img, nullVal, numSeg)
        dev = segstats.compactTileDevice(seg, img, nullVal, numSeg)
        for a, b in zip(host, dev):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # all-null tile
    assert segstats.compactTileDevice(
        np.zeros((8, 8), np.uint32), img[:8, :8], NODATA, numSeg) is None
    # dtype gate
    assert not segstats.deviceCompactSupported(np.uint32)
    assert segstats.deviceCompactSupported(np.uint16)


def test_packed_sort_matches_unpacked(rng):
    """The packed single-key sort (16-bit imagery, segIds < 0xFFFF)
    must emit exactly the runs of the two-key sort, for unsigned AND
    signed (biased) dtypes; ineligible inputs must decline to pack."""
    from pyshepseg_tpu.ops import segstats

    h, w = 64, 48
    seg = rng.integers(0, 20, size=(h, w)).astype(np.uint32)
    for dtype, lo, hi in ((np.uint16, 0, 60000), (np.int16, -30000, 30000),
                          (np.uint8, 0, 255), (np.int8, -128, 127)):
        bias = segstats.packBias(dtype, numSeg=20)
        assert bias is not None
        img = rng.integers(lo, hi, size=(h, w)).astype(dtype)
        host = tilingstats.compactTile(seg, img.astype(np.int64), None, 20)
        dev = segstats.compactTileDevice(seg, img, None, 20)
        for a, b in zip(host, dev):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # ineligible: wide dtypes, or too many segments for the 16-bit key
    assert segstats.packBias(np.int32, numSeg=20) is None
    assert segstats.packBias(np.int64, numSeg=20) is None
    assert segstats.packBias(np.uint16, numSeg=0xFFFF) is None
    # int32 imagery still compacts (two-key path), identically
    img32 = rng.integers(-100000, 100000, size=(h, w)).astype(np.int32)
    host = tilingstats.compactTile(seg, img32.astype(np.int64), None, 20)
    dev = segstats.compactTileDevice(seg, img32, None, 20)
    for a, b in zip(host, dev):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_stats_device_engine_matches_host(tmp_path, rng, small_tiles):
    """engine='device' must write bit-identical RAT columns."""
    import shutil
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)
    segpath2 = str(tmp_path / "seg2.npseg")
    shutil.copytree(segpath, segpath2)  # .npseg datasets are directories
    sel = [("b1_mean", "mean"), ("b1_std", "stddev"),
           ("b1_med", "median"), ("b1_p75", "percentile", 75)]
    tilingstats.calcPerSegmentStatsTiled(imgpath, 1, segpath, sel,
                                         engine='host')
    tilingstats.calcPerSegmentStatsTiled(imgpath, 1, segpath2, sel,
                                         engine='device')
    ratH = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    ratD = rio.open(segpath2).GetRasterBand(1).GetDefaultRAT()
    namesH = [ratH.GetNameOfCol(i) for i in range(ratH.GetColumnCount())]
    namesD = [ratD.GetNameOfCol(i) for i in range(ratD.GetColumnCount())]
    for (col, _, *_p) in sel:
        a = ratH.ReadAsArray(namesH.index(col))
        b = ratD.ReadAsArray(namesD.index(col))
        np.testing.assert_array_equal(a, b)


def test_stats_device_per_tile_feed_matches_host(tmp_path, rng,
                                                 small_tiles,
                                                 monkeypatch):
    """With the scene-resident feed gated off (scene 'too big'), the
    per-tile device path must still write bit-identical columns."""
    import shutil
    monkeypatch.setattr(tilingstats, "_sceneFitsDeviceStats",
                        lambda *a, **k: False)
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)
    segpath2 = str(tmp_path / "seg2.npseg")
    shutil.copytree(segpath, segpath2)
    sel = [("b1_mean", "mean"), ("b1_med", "median")]
    tilingstats.calcPerSegmentStatsTiled(imgpath, 1, segpath, sel,
                                         engine='host')
    tilingstats.calcPerSegmentStatsTiled(imgpath, 1, segpath2, sel,
                                         engine='device')
    ratH = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    ratD = rio.open(segpath2).GetRasterBand(1).GetDefaultRAT()
    namesH = [ratH.GetNameOfCol(i) for i in range(ratH.GetColumnCount())]
    namesD = [ratD.GetNameOfCol(i) for i in range(ratD.GetColumnCount())]
    for (col, *_r) in sel:
        np.testing.assert_array_equal(
            ratH.ReadAsArray(namesH.index(col)),
            ratD.ReadAsArray(namesD.index(col)))


def test_stats_device_scene_resident_multiband(tmp_path, rng,
                                               small_tiles):
    """The scene-resident multi-band device feed (one HBM upload, window
    slicing on device) matches per-band host passes bit-for-bit."""
    import shutil
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)
    # rewrite the image as a two-band file (second band derived)
    img2 = (img // 2 + 1).astype(img.dtype)
    imgpath = str(tmp_path / "img2band.npseg")
    h, w = img.shape
    ds = rio.create(imgpath, w, h, 2, img.dtype)
    for bi, arr in ((1, img), (2, img2)):
        b = ds.GetRasterBand(bi)
        b.WriteArray(arr)
        b.SetNoDataValue(NODATA)
    ds.FlushCache()
    del ds
    segpath2 = str(tmp_path / "seg2.npseg")
    shutil.copytree(segpath, segpath2)
    selList = [[("b1_mean", "mean"), ("b1_p75", "percentile", 75)],
               [("b2_mean", "mean"), ("b2_med", "median")]]
    assert tilingstats._sceneFitsDeviceStats(img.shape[0], img.shape[1],
                                             2)
    tilingstats.calcPerSegmentStatsTiledMultiBand(
        imgpath, [1, 2], segpath, selList, engine='device')
    for band, sel in zip((1, 2), selList):
        tilingstats.calcPerSegmentStatsTiled(imgpath, band, segpath2,
                                             sel, engine='host')
    ratD = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    ratH = rio.open(segpath2).GetRasterBand(1).GetDefaultRAT()
    nD = [ratD.GetNameOfCol(i) for i in range(ratD.GetColumnCount())]
    nH = [ratH.GetNameOfCol(i) for i in range(ratH.GetColumnCount())]
    for col in ("b1_mean", "b1_p75", "b2_mean", "b2_med"):
        np.testing.assert_array_equal(ratD.ReadAsArray(nD.index(col)),
                                      ratH.ReadAsArray(nH.index(col)))


@pytest.fixture
def fake_rios(monkeypatch):
    """Put the in-repo fake rios package on sys.path so the real RIOS
    applier drivers run without RIOS installed."""
    import os
    import sys
    import importlib
    fakedir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fakerios")
    monkeypatch.syspath_prepend(fakedir)
    for mod in list(sys.modules):
        if mod == "rios" or mod.startswith("rios."):
            del sys.modules[mod]
    yield
    for mod in list(sys.modules):
        if mod == "rios" or mod.startswith("rios."):
            del sys.modules[mod]
    importlib.invalidate_caches()


def test_rios_stats_driver_matches_tiled(tmp_path, rng, small_tiles,
                                         fake_rios):
    """The real RIOS applier driver (temp-RAT + copyRAT write-back) must
    produce the same columns as the tiled path."""
    import shutil
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)
    segpath2 = str(tmp_path / "seg_rios.npseg")
    shutil.copytree(segpath, segpath2)
    sel = [("b1_mean", "mean"), ("b1_med", "median"),
           ("b1_p75", "percentile", 75)]
    tilingstats.calcPerSegmentStatsTiled(imgpath, 1, segpath, sel,
                                         engine='host')
    from rios import applier
    style = applier.ConcurrencyStyle(numReadWorkers=2)
    tilingstats.calcPerSegmentStatsRIOS(imgpath, 1, segpath2, sel,
                                        concurrencyStyle=style)
    ratT = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    ratR = rio.open(segpath2).GetRasterBand(1).GetDefaultRAT()
    namesT = [ratT.GetNameOfCol(i) for i in range(ratT.GetColumnCount())]
    namesR = [ratR.GetNameOfCol(i) for i in range(ratR.GetColumnCount())]
    for (col, *_rest) in sel:
        np.testing.assert_array_equal(
            ratT.ReadAsArray(namesT.index(col)),
            ratR.ReadAsArray(namesR.index(col)))

    # compute workers are forbidden, matching the reference
    bad = applier.ConcurrencyStyle(numComputeWorkers=2,
                                   computeWorkerKind="CW_THREADS")
    with pytest.raises(tilingstats.PyShepSegStatsError):
        tilingstats.calcPerSegmentStatsRIOS(imgpath, 1, segpath2, sel,
                                            concurrencyStyle=bad)


def test_rios_spatial_driver_matches_tiled(tmp_path, rng, small_tiles,
                                           fake_rios):
    import shutil
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)
    segpath2 = str(tmp_path / "seg_rios.npseg")
    shutil.copytree(segpath, segpath2)
    transform = np.array([0, 1, 0, 0, 0, -1], dtype=np.float64)
    cols = [("east", rio.GFT_Real), ("north", rio.GFT_Real)]
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath, cols, tilingstats.userFuncMeanCoord,
        transform)
    tilingstats.calcPerSegmentSpatialStatsRIOS(
        imgpath, 1, segpath2, cols, tilingstats.userFuncMeanCoord,
        transform)
    ratT = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    ratR = rio.open(segpath2).GetRasterBand(1).GetDefaultRAT()
    namesT = [ratT.GetNameOfCol(i) for i in range(ratT.GetColumnCount())]
    namesR = [ratR.GetNameOfCol(i) for i in range(ratR.GetColumnCount())]
    for (col, _t) in cols:
        np.testing.assert_array_equal(
            ratT.ReadAsArray(namesT.index(col)),
            ratR.ReadAsArray(namesR.index(col)))


def test_rios_missing_package_raises(tmp_path, rng):
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)
    with pytest.raises(tilingstats.PyShepSegStatsError):
        tilingstats.calcPerSegmentStatsRIOS(imgpath, 1, segpath,
                                            [("m", "mean")])


def test_spatial_device_edge_pixels_matches_host(tmp_path, rng,
                                                 small_tiles):
    """Batched device edge-pixel counts must equal the host callback's
    exactly (integer kernel)."""
    import shutil
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)
    segpath2 = str(tmp_path / "seg2.npseg")
    shutil.copytree(segpath, segpath2)
    cols = [("edges", rio.GFT_Integer)]
    for path, engine in ((segpath, 'host'), (segpath2, 'device')):
        tilingstats.calcPerSegmentSpatialStatsTiled(
            imgpath, 1, path, cols, tilingstats.userFuncNumEdgePixels,
            True, engine=engine)
    ratH = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    ratD = rio.open(segpath2).GetRasterBand(1).GetDefaultRAT()
    nH = [ratH.GetNameOfCol(i) for i in range(ratH.GetColumnCount())]
    nD = [ratD.GetNameOfCol(i) for i in range(ratD.GetColumnCount())]
    np.testing.assert_array_equal(ratH.ReadAsArray(nH.index("edges")),
                                  ratD.ReadAsArray(nD.index("edges")))


def test_spatial_device_variogram_matches_host(tmp_path, rng,
                                               small_tiles):
    """Batched device variograms match the host callback to float32
    accumulation tolerance."""
    import shutil
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)
    segpath2 = str(tmp_path / "seg2.npseg")
    shutil.copytree(segpath, segpath2)
    maxDist = 3
    cols = [(f"vario{d}", rio.GFT_Real) for d in range(1, maxDist + 1)]
    for path, engine in ((segpath, 'host'), (segpath2, 'device')):
        tilingstats.calcPerSegmentSpatialStatsTiled(
            imgpath, 1, path, cols, tilingstats.userFuncVariogram,
            maxDist, engine=engine)
    ratH = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    ratD = rio.open(segpath2).GetRasterBand(1).GetDefaultRAT()
    nH = [ratH.GetNameOfCol(i) for i in range(ratH.GetColumnCount())]
    nD = [ratD.GetNameOfCol(i) for i in range(ratD.GetColumnCount())]
    for (c, _t) in cols:
        a = ratH.ReadAsArray(nH.index(c))
        b = ratD.ReadAsArray(nD.index(c))
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-4)


def test_custom_device_spatial_callback(tmp_path, rng, small_tiles):
    """A CUSTOM JAX-traceable spatial callback routed through the public
    DeviceSpatialUserFunc contract: masked
    pixel count (int column) + masked mean (float column), device engine
    vs a plain host callback computing the same thing."""
    import shutil
    import jax.numpy as jnp
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)
    segpath2 = str(tmp_path / "seg2.npseg")
    shutil.copytree(segpath, segpath2)

    def fn(vals, mask, scale):
        m = mask.astype(jnp.float32)
        n = jnp.sum(m)
        mean = jnp.where(n > 0, jnp.sum(vals * m) / jnp.maximum(n, 1),
                         jnp.nan)
        return (jnp.stack([n.astype(jnp.int32)]),
                jnp.stack([mean * scale]))

    devFunc = tilingstats.DeviceSpatialUserFunc(fn)

    def hostFunc(pts, imgNullVal, intArr, floatArr, scale):
        intArr[0] = len(pts)
        if len(pts) > 0:
            floatArr[0] = np.float32(
                pts['val'].astype(np.float32).sum() /
                np.float32(len(pts))) * scale

    cols = [("npx", rio.GFT_Integer), ("smean", rio.GFT_Real)]
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath, cols, devFunc, 2.0, engine='device')
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath2, cols, hostFunc, 2.0, engine='host')
    ratD = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    ratH = rio.open(segpath2).GetRasterBand(1).GetDefaultRAT()
    nD = [ratD.GetNameOfCol(i) for i in range(ratD.GetColumnCount())]
    nH = [ratH.GetNameOfCol(i) for i in range(ratH.GetColumnCount())]
    np.testing.assert_array_equal(ratD.ReadAsArray(nD.index("npx")),
                                  ratH.ReadAsArray(nH.index("npx")))
    np.testing.assert_allclose(ratD.ReadAsArray(nD.index("smean")),
                               ratH.ReadAsArray(nH.index("smean")),
                               rtol=1e-5, atol=1e-4)


def test_custom_device_callback_works_on_host_engine(tmp_path, rng,
                                                     small_tiles):
    """A DeviceSpatialUserFunc with no hostFallback is still usable
    under engine='host' (single-box evaluation path), and with
    wantsOrigin the box origin arrives in whole-image coords."""
    import jax.numpy as jnp
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)

    def fn(vals, mask, origin, _param):
        # centroid y in whole-image coords
        m = mask.astype(jnp.float32)
        n = jnp.maximum(jnp.sum(m), 1.0)
        yy = jnp.arange(mask.shape[0], dtype=jnp.float32)[:, None]
        return None, jnp.stack([jnp.sum(m * yy) / n + origin[0]])

    devFunc = tilingstats.DeviceSpatialUserFunc(fn, wantsOrigin=True)
    cols = [("ymean", rio.GFT_Real)]
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath, cols, devFunc, None, engine='host')
    rat = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    names = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    got = rat.ReadAsArray(names.index("ymean"))
    for sid in range(1, int(seg.max()) + 1):
        # point lists exclude nodata pixels (reference semantics)
        ys, _ = np.nonzero((seg == sid) & (img != NODATA))
        if len(ys):
            np.testing.assert_allclose(got[sid], ys.mean(), atol=1e-3)


def test_device_mean_coord_contract(tmp_path, rng, small_tiles):
    """deviceFuncMeanCoord (the contract instance) matches the default
    host userFuncMeanCoord route to float32 tolerance."""
    import shutil
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)
    segpath2 = str(tmp_path / "seg2.npseg")
    shutil.copytree(segpath, segpath2)
    transform = np.array([1000.0, 2.0, 0.0, 500.0, 0.0, -2.0])
    cols = [("east", rio.GFT_Real), ("north", rio.GFT_Real)]
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath, cols, tilingstats.deviceFuncMeanCoord,
        transform, engine='device')
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath2, cols, tilingstats.userFuncMeanCoord,
        transform, engine='host')
    ratD = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    ratH = rio.open(segpath2).GetRasterBand(1).GetDefaultRAT()
    nD = [ratD.GetNameOfCol(i) for i in range(ratD.GetColumnCount())]
    nH = [ratH.GetNameOfCol(i) for i in range(ratH.GetColumnCount())]
    for c, _t in cols:
        np.testing.assert_allclose(ratD.ReadAsArray(nD.index(c)),
                                   ratH.ReadAsArray(nH.index(c)),
                                   rtol=1e-5, atol=1e-2)


# ------------------- reference dict-kernel compatibility layer


def test_dict_compat_stats_pipeline(rng):
    """Drive the reference-style dict kernels (accumulateSegDict ->
    checkSegComplete -> calcStatsForCompletedSegs) over a two-tile split
    and check the paged RAT against direct numpy statistics."""
    h, w = 40, 60
    seg = (rng.integers(1, 9, size=(h, w))).astype(np.uint32)
    seg[0, :5] = 0
    img = rng.integers(0, 50, size=(h, w)).astype(np.int64)
    img[seg == 3] = 7            # all-nodata segment
    imgNullVal = 7
    segSize = np.bincount(seg.ravel(), minlength=10)
    segSize[0] = 0

    segDict = tilingstats.createSegDict()
    noDataDict = tilingstats.createNoDataDict()
    pagedRat = tilingstats.createPagedRat()
    statsSelection = [("mn", "mean"), ("p0", "percentile", 0),
                      ("md", "median"), ("cnt", "pixcount")]
    sel, nInt, nFloat = tilingstats.makeFastStatsSelection(
        list(range(len(statsSelection))), statsSelection)

    # feed in two half-tiles: nothing completes after the first
    tilingstats.accumulateSegDict(segDict, noDataDict, imgNullVal,
                                  seg[:, :30], img[:, :30])
    complete1 = [s for s in segDict
                 if tilingstats.checkSegComplete(segDict, noDataDict,
                                                 segSize, s)]
    assert complete1 == []
    tilingstats.accumulateSegDict(segDict, noDataDict, imgNullVal,
                                  seg[:, 30:], img[:, 30:])
    tilingstats.calcStatsForCompletedSegs(
        segDict, noDataDict, -9999, pagedRat, sel, segSize, nInt, nFloat)
    assert segDict == {} and noDataDict == {}

    page = pagedRat[0]
    for s in range(1, 9):
        vals = img[(seg == s) & (img != imgNullVal)]
        if len(vals) == 0:
            assert page.getRatVal(s, tilingstats.STAT_DTYPE_FLOAT, 0) == -9999
            assert page.getRatVal(s, tilingstats.STAT_DTYPE_INT, 0) == -9999
            continue
        mean = page.getRatVal(s, tilingstats.STAT_DTYPE_FLOAT, 0)
        assert mean == pytest.approx(np.float32(vals.mean()), abs=1e-5)
        # reference p=0 quirk: percentile 0 returns the MAX value
        assert page.getRatVal(s, tilingstats.STAT_DTYPE_INT, 0) == vals.max()
        sv = np.sort(vals)
        cum = np.cumsum(np.ones_like(sv))
        med = sv[int(np.searchsorted(cum, len(sv) * 0.5, side='left'))]
        assert page.getRatVal(s, tilingstats.STAT_DTYPE_INT, 1) == med
        assert page.getRatVal(s, tilingstats.STAT_DTYPE_INT, 2) == len(vals)


def test_segment_stats_class(rng):
    """SegmentStats matches the reference jitclass semantics."""
    hist = {10: 3, 5: 2, 20: 1}
    st = tilingstats.SegmentStats(hist, -9999)
    assert st.pixCount == 6
    assert st.min == 5 and st.max == 20
    assert st.mean == pytest.approx(np.float32((5 * 2 + 10 * 3 + 20) / 6))
    assert st.mode == 10
    assert st.getPercentile(0) == 20       # the reference's p=0 quirk
    assert st.getPercentile(100) == 20
    assert st.median == 10
    assert st.getStat(tilingstats.STATID_PIXCOUNT, 0) == 6
    empty = tilingstats.SegmentStats({}, -9999)
    assert empty.mean == -9999 and empty.getPercentile(50) == -9999

    keys, counts = tilingstats.getSortedKeysAndValuesForDict(hist)
    assert keys.tolist() == [5, 10, 20]
    assert counts.tolist() == [2, 3, 1]


def test_dict_compat_spatial_pipeline(rng):
    """accumulateSegSpatial -> calcStatsForCompletedSegsSpatial with the
    built-in mean-coord user function."""
    h, w = 30, 40
    seg = (rng.integers(1, 5, size=(h, w))).astype(np.uint32)
    img = rng.integers(1, 50, size=(h, w)).astype(np.int64)
    segSize = np.bincount(seg.ravel(), minlength=6)
    segSize[0] = 0

    segDict = tilingstats.createSegSpatialDataDict()
    noDataDict = tilingstats.createNoDataDict()
    pagedRat = tilingstats.createPagedRat()
    colNames = [("x_mean", rio.GFT_Real), ("y_mean", rio.GFT_Real)]
    sel = np.array([[0, 0, tilingstats.STAT_DTYPE_FLOAT, 0, 0],
                    [1, 0, tilingstats.STAT_DTYPE_FLOAT, 1, 0]],
                   dtype=np.uint32)
    intArr = np.zeros(0, dtype=np.int64)
    floatArr = np.zeros(2, dtype=np.float64)
    transform = np.array([0, 1, 0, 0, 0, -1], dtype=np.float64)

    # two horizontal strips (whole-image coordinates via topLine)
    tilingstats.accumulateSegSpatial(segDict, noDataDict, None,
                                     seg[:15], img[:15], 0, 0)
    tilingstats.accumulateSegSpatial(segDict, noDataDict, None,
                                     seg[15:], img[15:], 15, 0)
    tilingstats.calcStatsForCompletedSegsSpatial(
        segDict, noDataDict, -9999, pagedRat, segSize,
        tilingstats.userFuncMeanCoord, transform, sel, intArr, floatArr,
        None)
    assert segDict == {}

    yy, xx = np.mgrid[0:h, 0:w]
    page = pagedRat[0]
    for s in range(1, 5):
        # geotransform (0,1,0,0,0,-1), pixel top-left corner convention
        wantE = xx[seg == s].astype(float).mean()
        wantN = (-yy[seg == s].astype(float)).mean()
        gotE = page.getRatVal(s, tilingstats.STAT_DTYPE_FLOAT, 0)
        gotN = page.getRatVal(s, tilingstats.STAT_DTYPE_FLOAT, 1)
        assert gotE == pytest.approx(wantE, abs=1e-3)
        assert gotN == pytest.approx(wantN, abs=1e-3)


def test_multiband_one_pass_matches_single_band_calls(tmp_path, rng):
    # calcPerSegmentStatsTiledMultiBand reads each seg tile once and
    # accumulates every band; columns must equal N single-band calls,
    # with per-band nodata honoured individually
    h, w = 90, 110
    segpath, imgpath, seg, img1 = make_seg_and_img(
        tmp_path, rng, shape=(h, w))
    # grow the image to 3 bands with distinct content + nodata values
    imgds = rio.open(imgpath, rio.GA_Update)
    img2 = rng.integers(0, 500, size=(h, w)).astype(np.uint16)
    img3 = rng.integers(0, 50, size=(h, w)).astype(np.uint16)
    img3[rng.random((h, w)) < 0.1] = 49  # second band nodata value
    import numpy
    multipath = str(tmp_path / "multi.npseg")
    mds = rio.create(multipath, w, h, 3, numpy.uint16)
    for i, (arr, nd) in enumerate(
            [(img1, NODATA), (img2, None), (img3, 49)], start=1):
        b = mds.GetRasterBand(i)
        b.WriteArray(arr)
        if nd is not None:
            b.SetNoDataValue(nd)
    mds.FlushCache()

    sel = [[("b1_mean", "mean"), ("b1_p75", "percentile", 75)],
           [("b2_mean", "mean"), ("b2_max", "max")],
           [("b3_mode", "mode"), ("b3_std", "stddev")]]

    segpath2 = str(tmp_path / "seg2.npseg")
    import shutil
    shutil.copytree(segpath, segpath2)

    tilingstats.calcPerSegmentStatsTiledMultiBand(
        multipath, [1, 2, 3], segpath, sel, engine='host')
    for band, s in zip([1, 2, 3], sel):
        tilingstats.calcPerSegmentStatsTiled(
            multipath, band, segpath2, s, engine='host')

    ratA = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    ratB = rio.open(segpath2).GetRasterBand(1).GetDefaultRAT()
    for s in sel:
        for colName in [t[0] for t in s]:
            ia = [ratA.GetNameOfCol(i) for i in
                  range(ratA.GetColumnCount())].index(colName)
            ib = [ratB.GetNameOfCol(i) for i in
                  range(ratB.GetColumnCount())].index(colName)
            np.testing.assert_array_equal(
                ratA.ReadAsArray(ia), ratB.ReadAsArray(ib), err_msg=colName)


def test_multiband_validation(tmp_path, rng):
    segpath, imgpath, _, _ = make_seg_and_img(tmp_path, rng)
    with pytest.raises(tilingstats.PyShepSegStatsError):
        tilingstats.calcPerSegmentStatsTiledMultiBand(
            imgpath, [1, 2], segpath, [[("m", "mean")]])
    with pytest.raises(tilingstats.PyShepSegStatsError):
        tilingstats.calcPerSegmentStatsTiledMultiBand(
            imgpath, [], segpath, [])


def test_multiband_device_engine_matches_host(tmp_path, rng):
    # all-bands-on-device batches the compaction into ONE vmapped
    # dispatch pair per window; columns must equal the host engine's
    h, w = 80, 100
    segpath, imgpath, seg, img1 = make_seg_and_img(
        tmp_path, rng, shape=(h, w))
    img2 = rng.integers(0, 300, size=(h, w)).astype(np.uint16)
    multipath = str(tmp_path / "multi.npseg")
    mds = rio.create(multipath, w, h, 2, np.uint16)
    for i, (arr, nd) in enumerate([(img1, NODATA), (img2, None)], start=1):
        b = mds.GetRasterBand(i)
        b.WriteArray(arr)
        if nd is not None:
            b.SetNoDataValue(nd)
    mds.FlushCache()

    import shutil
    segpath2 = str(tmp_path / "seg2.npseg")
    shutil.copytree(segpath, segpath2)

    sel = [[("d1_mean", "mean"), ("d1_med", "median")],
           [("d2_min", "min"), ("d2_p25", "percentile", 25)]]
    tilingstats.calcPerSegmentStatsTiledMultiBand(
        multipath, [1, 2], segpath, sel, engine='device')
    tilingstats.calcPerSegmentStatsTiledMultiBand(
        multipath, [1, 2], segpath2, sel, engine='host')

    ratA = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    ratB = rio.open(segpath2).GetRasterBand(1).GetDefaultRAT()
    namesA = [ratA.GetNameOfCol(i) for i in range(ratA.GetColumnCount())]
    namesB = [ratB.GetNameOfCol(i) for i in range(ratB.GetColumnCount())]
    for s in sel:
        for colName in [t[0] for t in s]:
            np.testing.assert_array_equal(
                ratA.ReadAsArray(namesA.index(colName)),
                ratB.ReadAsArray(namesB.index(colName)), err_msg=colName)


def test_streaming_spatial_custom_userfunc(tmp_path, rng, small_tiles):
    """A custom StreamingSpatialUserFunc (per-segment value sum + pixel
    count via running bincounts) must match brute force, including
    nodata exclusion and missingStatsValue for all-nodata segments."""
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)
    state0 = {}

    def initState(numSeg):
        state0['n'] = numSeg
        return {'sum': np.zeros(numSeg, np.float64),
                'cnt': np.zeros(numSeg, np.int64)}

    def tileContrib(segIds, xx, yy, vals):
        hi = int(segIds.max()) + 1
        return (np.bincount(segIds, weights=vals.astype(np.float64),
                            minlength=hi),
                np.bincount(segIds, minlength=hi))

    def mergeContrib(state, contrib):
        s, c = contrib
        k = min(len(c), len(state['cnt']))
        state['sum'][:k] += s[:k]
        state['cnt'][:k] += c[:k]

    def finalizeRows(state, segIds):
        intRows = np.stack([state['cnt'][segIds]], axis=1)
        floatRows = np.stack([state['sum'][segIds]], axis=1)
        return intRows, floatRows

    fn = tilingstats.StreamingSpatialUserFunc(
        initState, tileContrib, mergeContrib, finalizeRows)
    cols = [("st_cnt", rio.GFT_Integer), ("st_sum", rio.GFT_Real)]
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath, cols, fn, None)

    rat = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    names = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    cnt = rat.ReadAsArray(names.index("st_cnt"))
    tot = rat.ReadAsArray(names.index("st_sum"))
    for sid in range(1, int(seg.max()) + 1):
        inseg = (seg == sid)
        if inseg.sum() == 0:
            continue
        vals = img[inseg]
        vals = vals[vals != NODATA]
        if len(vals) == 0:
            assert cnt[sid] == -9999 and tot[sid] == -9999
        else:
            assert cnt[sid] == len(vals)
            np.testing.assert_allclose(tot[sid], vals.sum(), rtol=1e-12)


def test_mean_coord_substitutes_streaming(tmp_path, rng, small_tiles,
                                          monkeypatch):
    """Passing userFuncMeanCoord must take the streaming route: the
    point-list accumulator (compactTileSpatial) is never called."""
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)

    def boom(*a, **k):
        raise AssertionError("point-list path used for userFuncMeanCoord")

    monkeypatch.setattr(tilingstats, "compactTileSpatial", boom)
    transform = np.array([0.0, 1.0, 0.0, 0.0, 0.0, 1.0])
    cols = [("se", rio.GFT_Real), ("sn", rio.GFT_Real)]
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath, cols, tilingstats.userFuncMeanCoord,
        transform)
    rat = rio.open(segpath).GetRasterBand(1).GetDefaultRAT()
    names = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    e = rat.ReadAsArray(names.index("se"))
    for sid in range(1, int(seg.max()) + 1):
        inseg = (seg == sid) & (img != NODATA)
        if inseg.sum():
            np.testing.assert_allclose(
                e[sid], np.nonzero(inseg)[1].mean(), atol=3e-4)
