"""
Host-side raster / RAT I/O.

The reference is hard-wired to GDAL (reference: pyshepseg/tiling.py:69,
tilingstats.py:39-40). This framework routes all raster access through a
small driver abstraction (:mod:`.raster`) with two backends:

- a GDAL pass-through (used when ``osgeo`` is importable), so real
  KEA/GTiff workflows behave exactly like the reference;
- a pure-numpy directory format (``.npseg``), memmap-backed for windowed
  reads/writes, so the full pipeline (including RATs, overviews, colour
  tables and metadata) runs and is testable in GDAL-less environments
  like GPU clusters with minimal images.

Framework code is written against the GDAL method names (ReadAsArray,
WriteArray, GetDefaultRAT, ...), so objects from either backend are
interchangeable.
"""

from .raster import (  # noqa: F401
    open, create, createCopyStructure, isNumpyDriverPath,
    GDT_Byte, GDT_UInt16, GDT_Int16, GDT_UInt32, GDT_Int32,
    GDT_Float32, GDT_Float64,
    GFT_Integer, GFT_Real, GFT_String,
    GFU_Generic, GFU_PixelCount, GFU_Name, GFU_Red, GFU_Green, GFU_Blue,
    GFU_Alpha,
    GA_ReadOnly, GA_Update,
    gdalTypeFromNumpy, numpyTypeFromGdal, HAVE_GDAL)
