#!/usr/bin/env python
"""
Submit the three-phase decoupled segmentation pipeline
(prepare -> array of tile jobs -> stitch) to an execution backend.
Analogue of the reference's
parallel_examples/awsbatch/submit-pyshepseg-job.py (which wires the same
DAG through AWS Batch job dependencies).

Backends:

- ``local``   — run every phase as local subprocesses. With NVIDIA cards
  (found by ``nvidia-smi -L``) tile jobs run one process per card at a
  time, each pinned to its card through CUDA_VISIBLE_DEVICES, because a
  JAX process reserves most of a card's memory. Without cards they run
  on the CPU in a pool of ``--workers`` processes. Exercises the exact
  pipeline end-to-end on one machine (the batch analogue of tiling's
  CONC_SUBPROC test backend).
- ``slurm``   — emit sbatch scripts: one prepare job, one array job of
  tiles (--array=0-N-1, one GPU per task), one dependent stitch job.

For slurm the emitted artifacts are written to --emit-dir for
review/submission; this script does not submit them itself.
"""

import argparse
import os
import queue
import re
import subprocess
import sys
from concurrent import futures

HERE = os.path.dirname(os.path.abspath(__file__))


def getCmdargs():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--backend", default="local",
                   choices=["local", "slurm"])
    p.add_argument("--infile", required=True)
    p.add_argument("--store", required=True, help="Object store URL")
    p.add_argument("--outname", default="segmentation.npseg")
    p.add_argument("--tilesize", type=int, default=4096)
    p.add_argument("--overlapsize", type=int, default=1024)
    p.add_argument("--nclusters", type=int, default=60)
    p.add_argument("--bands")
    p.add_argument("--statsbands")
    p.add_argument("--workers", type=int, default=4,
                   help="local backend without cards: concurrent tile "
                        "subprocesses")
    p.add_argument("--emit-dir", default="batch_jobs",
                   help="slurm: where to write job artifacts")
    return p.parse_args()


def _run(cmd, env=None):
    print("+", " ".join(cmd), flush=True)
    res = subprocess.run(cmd, check=True, capture_output=True, text=True,
                         env=env)
    print(res.stdout)
    return res.stdout


def localCards():
    """Indices of this machine's NVIDIA cards, as CUDA_VISIBLE_DEVICES
    names them: its entries when it is set, else nvidia-smi's list.
    Empty without cards."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return [c for c in visible.split(",") if c.strip()]
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [str(i) for i, ln in enumerate(out.splitlines())
            if ln.startswith("GPU ")]


def submit_local(cmdargs):
    py = sys.executable
    prepCmd = [py, os.path.join(HERE, "do_prepare.py"),
               "--infile", cmdargs.infile, "--store", cmdargs.store,
               "--tilesize", str(cmdargs.tilesize),
               "--overlapsize", str(cmdargs.overlapsize),
               "--nclusters", str(cmdargs.nclusters)]
    if cmdargs.bands:
        prepCmd += ["--bands", cmdargs.bands]
    out = _run(prepCmd)
    numTiles = int(re.search(r"NUMTILES=(\d+)", out).group(1))

    # one tile process per card at a time; CPU processes otherwise
    cards = localCards()
    freeCards = queue.Queue()
    for c in cards:
        freeCards.put(c)

    def tileJob(i):
        cmd = [py, os.path.join(HERE, "do_tile.py"),
               "--store", cmdargs.store, "--index", str(i)]
        if not cards:
            return _run(cmd)
        card = freeCards.get()
        try:
            _run(cmd, env=dict(os.environ, CUDA_VISIBLE_DEVICES=card))
        finally:
            freeCards.put(card)

    with futures.ThreadPoolExecutor(len(cards) or cmdargs.workers) as pool:
        list(pool.map(tileJob, range(numTiles)))

    stitchCmd = [py, os.path.join(HERE, "do_stitch.py"),
                 "--store", cmdargs.store, "--outname", cmdargs.outname]
    if cmdargs.statsbands:
        stitchCmd += ["--statsbands", cmdargs.statsbands]
    _run(stitchCmd)
    print("pipeline complete:", cmdargs.store + "/" + cmdargs.outname)


SLURM_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --output={name}_%A_%a.log
#SBATCH --gres=gpu:1

python {script} {args}
"""

# Array size and dependencies are only known at submission time (the
# prepare job computes NUMTILES), so they are passed as sbatch
# command-line options — which override in-file directives — by this
# orchestrator rather than baked into the scripts.
SLURM_SUBMIT_ALL = """#!/bin/bash
# Submit the three-phase pipeline with real job-id dependencies.
set -euo pipefail
cd "$(dirname "$0")"

# Phase 1: prepare (run synchronously so we learn the tile count)
prep_id=$(sbatch --parsable --wait psseg_prepare.sbatch)
# || true: under pipefail a missing log operand (only one of the two
# name shapes exists, array vs non-array %a expansion) or a no-match
# grep would abort the script before the diagnostic below
numtiles=$(cat psseg_prepare_${{prep_id}}_*.log \\
               psseg_prepare_${{prep_id}}.log 2>/dev/null \\
           | grep -oP 'NUMTILES=\\K\\d+' | head -1 || true)
if [ -z "${{numtiles}}" ]; then
    echo "could not find NUMTILES in the prepare job log" >&2
    exit 1
fi

# Phase 2: one array task per tile
tiles_id=$(sbatch --parsable --array=0-$((numtiles - 1)) \\
           psseg_tiles.sbatch)

# Phase 3: stitch after every tile job succeeded
sbatch --dependency=afterok:${{tiles_id}} psseg_stitch.sbatch
"""


def _phaseArgs(cmdargs):
    """(prepareArgs, tileArgs, stitchArgs) — every user option the local
    backend honours, so the emitted specs behave identically."""
    common = "--store {}".format(cmdargs.store)
    prep = ("--infile {} {} --tilesize {} --overlapsize {} --nclusters {}"
            .format(cmdargs.infile, common, cmdargs.tilesize,
                    cmdargs.overlapsize, cmdargs.nclusters))
    if cmdargs.bands:
        prep += " --bands {}".format(cmdargs.bands)
    stitch = "{} --outname {}".format(common, cmdargs.outname)
    if cmdargs.statsbands:
        stitch += " --statsbands {}".format(cmdargs.statsbands)
    return prep, common, stitch


def submit_slurm(cmdargs):
    os.makedirs(cmdargs.emit_dir, exist_ok=True)
    prep, tiles, stitch = _phaseArgs(cmdargs)
    jobs = [
        ("psseg_prepare", "do_prepare.py", prep),
        ("psseg_tiles", "do_tile.py", tiles),
        ("psseg_stitch", "do_stitch.py", stitch),
    ]
    for name, script, args in jobs:
        body = SLURM_TEMPLATE.format(
            name=name, script=os.path.join(HERE, script), args=args)
        path = os.path.join(cmdargs.emit_dir, name + ".sbatch")
        with open(path, "w") as f:
            f.write(body)
        print("wrote", path)
    submitAll = os.path.join(cmdargs.emit_dir, "submit_all.sh")
    with open(submitAll, "w") as f:
        f.write(SLURM_SUBMIT_ALL.format())
    os.chmod(submitAll, 0o755)
    print("wrote", submitAll)
    print("Run submit_all.sh to submit the DAG (array size and job-id "
          "dependencies are wired at submission time).")


def main():
    cmdargs = getCmdargs()
    if cmdargs.backend == "local":
        submit_local(cmdargs)
    else:
        submit_slurm(cmdargs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
