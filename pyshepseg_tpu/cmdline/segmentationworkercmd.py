"""
Remote segmentation worker main program
(reference: pyshepseg/cmdline/pyshepseg_segmentationworkercmd.py).

Connects back to the coordinator's NetworkDataChannel, waits at the start
barrier, then pulls (col, row) tile jobs from the work queue, reads the
tile (bounded by the shared read semaphore), segments it on the local
accelerator, and pushes the result into the coordinator's tile cache.
Local timings are merged into the central Timers at the end; any exception
is shipped back as a WorkerErrorRecord.
"""

import queue
import argparse

import numpy

from pyshepseg_tpu import shepseg
from pyshepseg_tpu import io as rio
from pyshepseg_tpu.tiling import NetworkDataChannel
from pyshepseg_tpu.timinghooks import Timers
from pyshepseg_tpu.utils import (WorkerErrorRecord, honourJaxPlatformsEnv,
                                 setupCompilationCache)


def getCmdargs():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--idnum", type=int, help="Worker ID number")
    p.add_argument("--channaddr",
                   help="Address of NetworkDataChannel as 'host,port,authkey'")
    p.add_argument("--channaddrfile",
                   help="File containing the channel address string")
    return p.parse_args()


def mainCmd():
    cmdargs = getCmdargs()
    honourJaxPlatformsEnv()
    setupCompilationCache()
    if cmdargs.channaddrfile is not None:
        addrStr = open(cmdargs.channaddrfile).readline().strip()
    else:
        addrStr = cmdargs.channaddr

    (host, port, authkey) = tuple(addrStr.split(','))
    remoteSegmentationWorker(cmdargs.idnum, host, int(port),
                             bytes(authkey, 'utf-8'))


def popFromQue(que):
    """Non-blocking pop; None when empty."""
    try:
        return que.get(block=False)
    except queue.Empty:
        return None


def remoteSegmentationWorker(workerID, host, port, authkey):
    """Run the worker loop against the coordinator at (host, port)."""
    dataChan = NetworkDataChannel(hostname=host, portnum=port,
                                  authkey=authkey)
    try:
        d = dataChan.segDataDict
        infile = d.get('infile')
        tileInfo = d.get('tileInfo')
        minSegmentSize = d.get('minSegmentSize')
        maxSpectralDiff = d.get('maxSpectralDiff')
        imgNullVal = d.get('imgNullVal')
        fourConnected = d.get('fourConnected')
        kmeansObj = d.get('kmeansObj')
        verbose = d.get('verbose')
        spectDistPcntile = d.get('spectDistPcntile')
        bandNumbers = d.get('bandNumbers')
        barrierTimeout = d.get('barrierTimeout')

        workerBarrier = dataChan.workerBarrier
        if hasattr(workerBarrier, 'wait'):
            workerBarrier.wait(timeout=barrierTimeout)

        # Local timings (the proxy object lacks context-manager support)
        timings = Timers()
        inDs = rio.open(infile)

        colRow = popFromQue(dataChan.inQue)
        while colRow is not None:
            (col, row) = colRow
            xpos, ypos, xsize, ysize = tileInfo.getTile(col, row)

            with timings.interval('reading'):
                lyrDataList = []
                for bandNum in bandNumbers:
                    # proxy semaphore lacks context-manager support
                    dataChan.readSemaphore.acquire()
                    lyr = inDs.GetRasterBand(bandNum)
                    lyrDataList.append(
                        lyr.ReadAsArray(xpos, ypos, xsize, ysize))
                    dataChan.readSemaphore.release()
            img = numpy.array(lyrDataList)

            with timings.interval('segmentation'):
                segResult = shepseg.doShepherdSegmentation(
                    img, minSegmentSize=minSegmentSize,
                    maxSpectralDiff=maxSpectralDiff,
                    imgNullVal=imgNullVal, fourConnected=fourConnected,
                    kmeansObj=kmeansObj, verbose=verbose,
                    spectDistPcntile=spectDistPcntile)

            dataChan.segResultCache.addResult(col, row, segResult)
            colRow = popFromQue(dataChan.inQue)

        dataChan.timings.merge(timings)
    except Exception as e:
        dataChan.exceptionQue.put(WorkerErrorRecord(e, 'compute'))


if __name__ == "__main__":
    mainCmd()
