"""
Command-line tool: per-segment variograms via the spatial-stats user
function (reference: pyshepseg/cmdline/variograms.py).
"""

import argparse

from pyshepseg_tpu import tilingstats, utils
from pyshepseg_tpu import io as rio


def getCmdargs():
    p = argparse.ArgumentParser()
    p.add_argument("-i", "--infile", required=True,
        help="Input file to collect stats from")
    p.add_argument("-s", "--segfile", required=True,
        help="File from segmentation. Note: stats are written into the "
             "RAT in this file")
    p.add_argument("-n", "--numvariograms", required=True,
        choices=list(range(1, 10)), type=int,
        help="Number of variograms to calculate")
    return p.parse_args()


def mainCmd():
    cmdargs = getCmdargs()
    utils.honourJaxPlatformsEnv()
    utils.setupCompilationCache()
    cols = [("variogram{}".format(n + 1), rio.GFT_Real)
            for n in range(cmdargs.numvariograms)]
    tilingstats.calcPerSegmentSpatialStatsTiled(
        cmdargs.infile, 1, cmdargs.segfile, cols,
        tilingstats.userFuncVariogram, cmdargs.numvariograms)


if __name__ == '__main__':
    mainCmd()
