"""
pyshepseg_tpu — a JAX segmentation framework with the capabilities of
ubarsc/pyshepseg (Shepherd et al 2019 iterative-elimination segmentation of
multi-band rasters). It runs on NVIDIA GPUs and, for tests, on the CPU.

This is a data-parallel re-design, not a port: the reference's numba
flood-fill / dict-based kernels (reference: pyshepseg/shepseg.py) are
replaced with label propagation, segment reductions and sort-based CSR
layouts that XLA compiles, while preserving the reference's public API
surface and output semantics.

Public modules (mirroring the reference package layout):

- :mod:`pyshepseg_tpu.shepseg` — in-memory core engine
  (``doShepherdSegmentation``)
- :mod:`pyshepseg_tpu.tiling` — tiled driver for arbitrarily large rasters
  (``doTiledShepherdSegmentation`` + 3-phase prepare/doOne/finalize API)
- :mod:`pyshepseg_tpu.tilingstats` — per-segment statistics into a RAT
- :mod:`pyshepseg_tpu.subset` — subset/relabel tool
- :mod:`pyshepseg_tpu.utils` — colour tables, histogram stats, reports
- :mod:`pyshepseg_tpu.timinghooks` — named-interval timing collector
"""

import os as _os

# Explicit platform pin for worker subprocesses: a site customisation can
# override the JAX_PLATFORMS environment variable, so spawned workers that
# must run on a specific backend (CI, tests) may set PYSHEPSEG_TPU_PLATFORM
# as well — the config API wins over site defaults.
if _os.environ.get("PYSHEPSEG_TPU_PLATFORM"):
    import jax as _jax
    _jax.config.update("jax_platforms",
                       _os.environ["PYSHEPSEG_TPU_PLATFORM"])

SHEPSEG_TPU_VERSION = "0.5.0"
__version__ = SHEPSEG_TPU_VERSION
# reference-compatible alias (reference: __init__.py:31-32)
SHEPSEG_VERSION = SHEPSEG_TPU_VERSION
