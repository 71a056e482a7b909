#!/usr/bin/env python
"""
Batch pipeline phase 2 (one job per tile, array-indexed): segment a
single tile on this node's GPU and upload the labelled tile to the
object store. Analogue of the reference's
parallel_examples/awsbatch/do_tile.py (indexed by
AWS_BATCH_JOB_ARRAY_INDEX there; any of the common array-index env vars
or --index here).

Tile jobs are independent and idempotent: a failed/preempted job can
simply be re-run, which is what gives the batch pipeline its coarse
elastic recovery (the reference gets the same from Batch job retries).
"""

import argparse
import os
import pickle
import sys
import tempfile

# Allow running straight from a repo checkout without an installed
# package: if pyshepseg_tpu is not importable, add the repo root
# (two levels up from this script) to sys.path.
import sys as _sys
import os as _os
try:
    import pyshepseg_tpu  # noqa: F401
except ImportError:
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(
        _os.path.dirname(_os.path.abspath(__file__)))))

from pyshepseg_tpu import tiling, utils

# Persistent XLA compile cache shared across job invocations, so a
# fresh process does not recompile the pipeline for every tile:
# JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache.
utils.setupCompilationCache()

from objstore import ObjectStore

# Array-index environment variables of common schedulers, in priority
# order: AWS Batch, GCP Batch, Slurm
INDEX_ENV_VARS = ["AWS_BATCH_JOB_ARRAY_INDEX", "BATCH_TASK_INDEX",
                  "SLURM_ARRAY_TASK_ID"]


def getCmdargs():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--store", required=True, help="Object store URL")
    p.add_argument("--index", type=int, default=None,
                   help="Tile index (default: scheduler array-index env)")
    p.add_argument("--minsegmentsize", type=int, default=50)
    p.add_argument("--maxspectraldiff", default="auto")
    p.add_argument("--eightway", action="store_true", default=False)
    p.add_argument("--spectdistpcntile", type=int, default=50)
    return p.parse_args()


def resolveIndex(cmdargs):
    if cmdargs.index is not None:
        return cmdargs.index
    for var in INDEX_ENV_VARS:
        if var in os.environ:
            return int(os.environ[var])
    raise SystemExit("No --index and no scheduler array-index env var set")


def main():
    cmdargs = getCmdargs()
    store = ObjectStore(cmdargs.store)
    idx = resolveIndex(cmdargs)

    with tempfile.TemporaryDirectory() as tmpDir:
        prepFile = store.download("prepare.pkl",
                                  os.path.join(tmpDir, "prepare.pkl"))
        with open(prepFile, "rb") as f:
            prep = pickle.load(f)

        col, row = prep["colRowList"][idx]
        maxSpectralDiff = cmdargs.maxspectraldiff
        if maxSpectralDiff != "auto":
            maxSpectralDiff = float(maxSpectralDiff)

        ext = ".npseg"
        tileName = "tile_{}_{}{}".format(col, row, ext)
        localTile = os.path.join(tmpDir, tileName)
        tiling.doTiledShepherdSegmentation_doOne(
            prep["infile"], localTile, prep["tileInfo"], col, row,
            prep["bandNumbers"], prep["imgNullVal"], prep["kmeansObj"],
            minSegmentSize=cmdargs.minsegmentsize,
            maxSpectralDiff=maxSpectralDiff,
            fourConnected=not cmdargs.eightway,
            spectDistPcntile=cmdargs.spectdistpcntile, verbose=True)
        store.upload(localTile, tileName)

    print("Tile ({}, {}) [index {}] uploaded".format(col, row, idx))
    return 0


if __name__ == "__main__":
    sys.exit(main())
