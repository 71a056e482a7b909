"""
Pure-Python oracle implementing the *reference semantics* of
ubarsc/pyshepseg's numba kernels, written from the algorithm specification
(see SURVEY.md section 2.1 and reference file:line citations below). Slow —
only for small test images. This is the ground truth the device kernels are
checked against, since numba is not available in this environment.
"""

import numpy as np

SEGNULLVAL = 0
MINSEGID = 1
SegIdType = np.uint32


def oracle_clump(img, ignoreVal, fourConnected=True, clumpId=1,
                 maxClumpSize=None):
    """
    Scan-order flood-fill clumping with optional clump-size cap
    (semantics of reference: pyshepseg/shepseg.py:452-541).
    """
    ysize, xsize = img.shape
    output = np.zeros((ysize, xsize), dtype=SegIdType)
    cap = maxClumpSize if maxClumpSize is not None else np.inf

    for y in range(ysize):
        for x in range(xsize):
            if img[y, x] != ignoreVal and output[y, x] == 0:
                val = img[y, x]
                clumpSize = 0
                stack = [(y, x)]
                output[y, x] = clumpId
                while stack and clumpSize < cap:
                    sy, sx = stack.pop()
                    tlx, tly = max(sx - 1, 0), max(sy - 1, 0)
                    brx, bry = min(sx + 1, xsize - 1), min(sy + 1, ysize - 1)
                    for cx in range(tlx, brx + 1):
                        for cy in range(tly, bry + 1):
                            connected = (not fourConnected or
                                         (cy == sy or cx == sx))
                            if (connected and img[cy, cx] != ignoreVal and
                                    output[cy, cx] == 0 and
                                    img[cy, cx] == val):
                                output[cy, cx] = clumpId
                                clumpSize += 1
                                stack.append((cy, cx))
                clumpId += 1
    return output, clumpId


def oracle_seg_size(seg):
    """Histogram of segment IDs (reference: shepseg.py:544-569)."""
    return np.bincount(seg.ravel().astype(np.int64),
                       minlength=int(seg.max()) + 1).astype(np.uint32)


def oracle_relabel(seg, segSize, minSegId):
    """Contiguous relabel (reference: shepseg.py:739-777). In place."""
    oldNumSeg = len(segSize)
    subtract = np.zeros(oldNumSeg, dtype=SegIdType)
    for k in range(minSegId + 1, oldNumSeg):
        subtract[k] = subtract[k - 1]
        if segSize[k - 1] == 0:
            subtract[k] += 1
    seg[...] = seg - subtract[seg]


def _find_nearest_neighbour_pixel(img, seg, i, j, segSize, fourConnected):
    """(reference: shepseg.py:677-736). Distances in exact int arithmetic."""
    nBands, nRows, nCols = img.shape
    minDsqr = -1
    ii = jj = -1
    for iii in range(max(i - 1, 0), min(i + 1, nRows - 1) + 1):
        for jjj in range(max(j - 1, 0), min(j + 1, nCols - 1) + 1):
            connected = (not fourConnected) or (iii == i) or (jjj == j)
            if connected and segSize[seg[iii, jjj]] > 1:
                d = (img[:, i, j].astype(np.int64) -
                     img[:, iii, jjj].astype(np.int64))
                dSqr = int((d * d).sum())
                if minDsqr < 0 or dSqr < minDsqr:
                    minDsqr = dSqr
                    ii, jj = iii, jjj
    return ii, jj


def oracle_eliminate_single_pixels(img, seg, segSize, minSegId,
                                   fourConnected):
    """
    Repeated find-all-then-apply single-pixel merge passes to fixpoint,
    then relabel (reference: shepseg.py:572-674). Modifies seg in place.
    Returns total eliminated.
    """
    nRows, nCols = seg.shape
    total = 0
    while True:
        merges = []
        for i in range(nRows):
            for j in range(nCols):
                if segSize[seg[i, j]] == 1:
                    ii, jj = _find_nearest_neighbour_pixel(
                        img, seg, i, j, segSize, fourConnected)
                    if ii >= 0 and jj >= 0:
                        merges.append((i, j, seg[ii, jj]))
        for (r, c, newSeg) in merges:
            oldSeg = seg[r, c]
            seg[r, c] = newSeg
            segSize[oldSeg] = 0
            segSize[newSeg] += 1
        if not merges:
            break
        total += len(merges)
    oracle_relabel(seg, segSize, minSegId)
    return total


def oracle_eliminate_small_segments(seg, img, maxSegId, minSegSize,
                                    maxSpectralDiff, fourConnected,
                                    minSegId=MINSEGID):
    """
    Sequential small-segment elimination
    (reference: shepseg.py:918-1123). Modifies seg in place; returns count.
    """
    nBands = img.shape[0]
    spectSum = np.zeros((maxSegId + 1, nBands), dtype=np.float32)
    nRows, nCols = seg.shape
    for i in range(nRows):
        for j in range(nCols):
            spectSum[seg[i, j]] += img[:, i, j]
    segSize = np.bincount(seg.ravel().astype(np.int64),
                          minlength=maxSegId + 1).astype(np.uint32)
    # segment locations as python lists (order = scan order, as the
    # reference's makeSegmentLocations builds them)
    segLoc = {s: [] for s in range(minSegId, maxSegId + 1)}
    for i in range(nRows):
        for j in range(nCols):
            if seg[i, j] != SEGNULLVAL:
                segLoc[int(seg[i, j])].append((i, j))

    def findMergeSegment(segId):
        bestNbrSeg = SEGNULLVAL
        bestDistSqr = 0.0
        # numba promotes float32/int to float64 — match that
        spect = spectSum[segId].astype(np.float64) / len(segLoc[segId])
        for (i, j) in segLoc[segId]:
            for ii in range(max(i - 1, 0), min(i + 2, nRows)):
                for jj in range(max(j - 1, 0), min(j + 2, nCols)):
                    connected = (not fourConnected) or (ii == i or jj == j)
                    nbr = seg[ii, jj]
                    if (connected and nbr != segId and nbr != SEGNULLVAL and
                            segSize[nbr] > segSize[segId]):
                        nbrSpect = (spectSum[nbr].astype(np.float64) /
                                    segSize[nbr])
                        distSqr = float(((spect - nbrSpect) ** 2).sum())
                        if bestNbrSeg == SEGNULLVAL or distSqr < bestDistSqr:
                            bestDistSqr = distSqr
                            bestNbrSeg = nbr
        if bestDistSqr > maxSpectralDiff ** 2:
            bestNbrSeg = SEGNULLVAL
        return bestNbrSeg

    def doMerge(segId, nbrSegId):
        merged = segLoc[nbrSegId] + segLoc[segId]
        for (r, c) in segLoc[segId]:
            seg[r, c] = nbrSegId
        segLoc[nbrSegId] = merged
        del segLoc[segId]
        spectSum[nbrSegId] += spectSum[segId]
        spectSum[segId] = 0
        segSize[nbrSegId] += segSize[segId]
        segSize[segId] = 0

    numElim = 0
    mergeSeg = np.zeros(maxSegId + 1, dtype=SegIdType)
    for targetSize in range(1, minSegSize):
        countTargetSize = int(np.count_nonzero(segSize == targetSize))
        prevCount = -1
        numPasses = 0
        while countTargetSize != prevCount and numPasses < 10:
            prevCount = countTargetSize
            for segId in range(minSegId, maxSegId + 1):
                if segSize[segId] == targetSize:
                    mergeSeg[segId] = findMergeSegment(segId)
            for segId in range(minSegId, maxSegId + 1):
                if mergeSeg[segId] != SEGNULLVAL:
                    doMerge(segId, mergeSeg[segId])
                    mergeSeg[segId] = SEGNULLVAL
                    numElim += 1
            countTargetSize = int(np.count_nonzero(segSize == targetSize))
            numPasses += 1

    oracle_relabel(seg, segSize, minSegId)
    return numElim


def np_remap_and_relabel(seg, remap, size_out, min_seg_id=1):
    """numpy ``table[seg]`` for the relabel gather: the orig->current id
    remap composed with the contiguous relabel that drops ids of size 0
    (reference: shepseg.py:739-777)."""
    size_out = np.asarray(size_out)
    ids = np.arange(size_out.shape[0])
    unused = ((size_out == 0) & (ids >= min_seg_id)).astype(np.int64)
    sub = np.concatenate([[0], np.cumsum(unused)[:-1]])
    remap = np.asarray(remap).astype(np.int64)
    table = (remap - sub[remap]).astype(np.uint32)
    return table[np.asarray(seg).astype(np.int64)]
