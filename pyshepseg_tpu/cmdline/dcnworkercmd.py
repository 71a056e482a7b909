"""
Multi-controller (DCN) tiled-segmentation job entry point.

Launch this SAME command on every host of a multi-host job (one process
per host), giving each its process id; the processes coordinate through
the JAX distributed service, segment their tile shards on local cards,
and process 0 stitches the result (see pyshepseg_tpu.parallel.dcn). Under
a cluster runtime that jax.distributed can discover (e.g. Slurm), the
coordinator/process arguments can be omitted.

A single-host test drive:
    pyshepseg_tpu_dcnworkercmd -i in.tif -o out.kea -w /shared/work \\
        --coordinator host0:8476 --numprocesses 4 --procid $ID
"""

import argparse

from pyshepseg_tpu import tiling, utils
from pyshepseg_tpu.parallel.dcn import (
    doTiledShepherdSegmentationDistributed)


def getCmdargs():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--infile", required=True,
        help="Input raster")
    p.add_argument("-o", "--outfile", required=True,
        help="Output segmentation raster (written by process 0)")
    p.add_argument("-w", "--workdir", required=True,
        help="SHARED work directory visible to every host")
    p.add_argument("--coordinator",
        help="coordinator host:port (omit under cluster runtimes that "
             "jax.distributed auto-discovers)")
    p.add_argument("--numprocesses", type=int,
        help="Total process count (omit to auto-discover)")
    p.add_argument("--procid", type=int,
        help="This process's id (omit to auto-discover)")
    p.add_argument("-t", "--tilesize", type=int,
        default=tiling.DFLT_TILESIZE,
        help="Tile size (default=%(default)s)")
    p.add_argument("-l", "--overlapsize", type=int,
        default=tiling.DFLT_OVERLAPSIZE,
        help="Tile overlap (default=%(default)s)")
    p.add_argument("-m", "--minsegmentsize", type=int, default=50,
        help="Minimum segment size in pixels (default=%(default)s)")
    p.add_argument("-n", "--numclusters", type=int, default=60,
        help="Number of spectral clusters (default=%(default)s)")
    p.add_argument("-b", "--bands",
        help="Comma-separated list of bands to use (default: all)")
    p.add_argument("--maxspectraldiff", default='auto',
        help="Maximum spectral difference for merges (default=auto)")
    p.add_argument("--nullvalue", type=int,
        help="Image null value (default: from the file)")
    p.add_argument("--eightway", default=False, action="store_true",
        help="8-connected clumping (default: 4-connected)")
    p.add_argument("--fixedkmeansinit", default=False, action="store_true",
        help="Deterministic diagonal k-means init")
    p.add_argument("--tilegrid", default='uniform',
        choices=('uniform', 'grow'),
        help="Tile decomposition style (default=%(default)s)")
    p.add_argument("--format", default='KEA', dest="outformat",
        help="Output raster format (default=%(default)s)")
    p.add_argument("--tilesperdevice", type=int, default=1,
        help="Tiles vmap-batched into each per-chip dispatch "
             "(default=%(default)s)")
    p.add_argument("-v", "--verbose", default=False, action="store_true",
        help="Print progress")
    return p.parse_args()


def mainCmd():
    args = getCmdargs()
    utils.honourJaxPlatformsEnv()
    utils.setupCompilationCache()
    bandNumbers = None
    if args.bands is not None:
        bandNumbers = [int(b) for b in args.bands.split(",")]
    maxSpectralDiff = args.maxspectraldiff
    if maxSpectralDiff == 'none':
        # unbounded merging, as the sibling CLIs spell it
        maxSpectralDiff = None
    elif maxSpectralDiff not in ('auto', None):
        maxSpectralDiff = float(maxSpectralDiff)

    res = doTiledShepherdSegmentationDistributed(
        args.infile, args.outfile, args.workdir,
        tileSize=args.tilesize, overlapSize=args.overlapsize,
        minSegmentSize=args.minsegmentsize, numClusters=args.numclusters,
        bandNumbers=bandNumbers, maxSpectralDiff=maxSpectralDiff,
        imgNullVal=args.nullvalue, fixedKMeansInit=args.fixedkmeansinit,
        fourConnected=not args.eightway, verbose=args.verbose,
        outputDriver=args.outformat, tileGrid=args.tilegrid,
        coordinatorAddress=args.coordinator,
        numProcesses=args.numprocesses, processId=args.procid,
        tilesPerDevice=args.tilesperdevice)
    if res is not None and args.verbose:
        print("Found", res.maxSegId, "segments; empty-segments =",
              res.hasEmptySegments)


if __name__ == "__main__":
    mainCmd()
