"""Raster input: AAGrid (.asc) and NPY, with transparent gzip.

Counterpart of circuitscape_tpu/io/raster.py, reduced to the readers
that load_raster_data needs and the ASC writer of the maps.  Parity
reference: src/io.jl:113-157 (file sniffing), :517-555 (read_raster:
nodata -> -9999 normalization, NaN -> -9999), src/out.jl:485-531
(write_raster).  GeoTIFF, ENVI and EHdr inputs and GeoTIFF output are
not carried yet (ROADMAP queue 1 item 10) and raise
NotImplementedError.  The ASC body is written by the native formatter
(io/fastio.py), as in the JAX package.
"""

from __future__ import annotations

import gzip
import io as _io
import os
from dataclasses import dataclass

import numpy as np

from .. import consts


@dataclass
class RasterMeta:
    """Raster georeferencing metadata (src/io.jl:22-35)."""

    ncols: int = 0
    nrows: int = 0
    xllcorner: float = 0.0
    yllcorner: float = 0.0
    cellsize: float = 0.0
    nodata: float = 0.0
    transform: tuple = (0.0,)
    wkt: str = ""


def open_maybe_gzip(path: str, mode: str = "rt"):
    """Transparent gzip open (src/io.jl:3)."""
    if path.lower().endswith("gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _read_bytes(path: str) -> bytes:
    with open_maybe_gzip(path, "rb") as f:
        return f.read()


def _is_tiff(data: bytes) -> bool:
    return len(data) >= 4 and data[2:4] in (b"\x2a\x00", b"\x00\x2a")


def guess_file_type(path: str) -> int:
    """Sniff file type from magic bytes / first line (src/io.jl:135-157)."""
    data = _read_bytes(path)
    hdr_line = data.split(b"\n", 1)[0].decode("latin-1")
    if _is_tiff(data):
        return consts.FILE_TYPE_GEOTIFF
    if hdr_line.startswith(consts.FILE_HDR_NPY):
        return consts.FILE_TYPE_NPY
    if hdr_line.lower().startswith(consts.FILE_HDR_AAGRID):
        return consts.FILE_TYPE_AAGRID
    if hdr_line.startswith(consts.FILE_HDR_INCL_PAIRS_AAGRID):
        return consts.FILE_TYPE_INCL_PAIRS_AAGRID
    if hdr_line.startswith(consts.FILE_HDR_INCL_PAIRS):
        return consts.FILE_TYPE_INCL_PAIRS
    return consts.FILE_TYPE_TXTLIST


_ASC_KEYS = ("ncols", "nrows", "xllcorner", "yllcorner", "xllcenter",
             "yllcenter", "cellsize", "nodata_value", "dx", "dy")


def _read_aagrid(data: bytes):
    text = data.decode("latin-1")
    hdr = {}
    lines = text.splitlines()
    i = 0
    for i, line in enumerate(lines):
        parts = line.split()
        if len(parts) >= 2 and parts[0].lower() in _ASC_KEYS:
            hdr[parts[0].lower()] = float(parts[1])
        else:
            break
    body = "\n".join(lines[i:])
    arr = np.loadtxt(_io.StringIO(body), dtype=np.float64, ndmin=2)
    ncols = int(hdr["ncols"])
    nrows = int(hdr["nrows"])
    cellsize = hdr.get("cellsize", hdr.get("dx", 1.0))
    nodata = hdr.get("nodata_value", consts.NODATA)
    # xllcenter variant: corner = center - cellsize/2 (GDAL behavior)
    if "xllcorner" in hdr:
        xll = hdr["xllcorner"]
    else:
        xll = hdr.get("xllcenter", 0.0) - cellsize / 2
    if "yllcorner" in hdr:
        yll = hdr["yllcorner"]
    else:
        yll = hdr.get("yllcenter", 0.0) - cellsize / 2
    if arr.shape != (nrows, ncols):
        arr = arr.reshape(nrows, ncols)
    transform = (xll, cellsize, 0.0, yll + nrows * cellsize, 0.0, -cellsize)
    return arr, nodata, transform, ""


def read_raster(path: str, dtype=np.float64):
    """Read an AAGrid or NPY raster; normalize nodata/NaN to -9999.

    Returns (array, wkt, transform) like the reference (src/io.jl:517-555).
    """
    check_path = path[:-3] if path.endswith(".gz") else path
    if not os.path.isfile(path) and not os.path.isfile(check_path):
        raise FileNotFoundError(f'the file "{check_path}" does not exist')
    if not os.path.isfile(path):
        path = check_path

    data = _read_bytes(path)
    ftype_hdr = data.split(b"\n", 1)[0].decode("latin-1")
    if ftype_hdr.startswith(consts.FILE_HDR_NPY):
        arr = np.load(_io.BytesIO(data))
        nodata, transform, wkt = (consts.NODATA,
                                  (0.0, 1.0, 0.0, 0.0, 0.0, -1.0), "")
    elif (ftype_hdr.split() or [""])[0].lower() in _ASC_KEYS:
        arr, nodata, transform, wkt = _read_aagrid(data)
    else:
        raise NotImplementedError(
            f"{path}: only AAGrid (.asc) and NPY rasters are read by "
            "circuitscape_tpu_torch so far (GeoTIFF/ENVI/EHdr: ROADMAP "
            "queue 1 item 10)")

    arr = np.asarray(arr, dtype=dtype).copy()
    if nodata is not None:
        arr[arr == float(nodata)] = consts.NODATA
    arr[np.isnan(arr)] = consts.NODATA
    return arr, wkt, transform


def get_raster_meta(arr, wkt, transform) -> RasterMeta:
    """Derive RasterMeta from array + geotransform (src/io.jl:124-133)."""
    nrows, ncols = arr.shape
    xll = transform[0]
    yll = transform[3] - nrows * transform[1]
    cellsize = transform[1]
    return RasterMeta(ncols=ncols, nrows=nrows, xllcorner=xll, yllcorner=yll,
                      cellsize=cellsize, nodata=consts.NODATA,
                      transform=tuple(transform), wkt=wkt)


def grid_reader(path: str, dtype=np.float64):
    arr, wkt, transform = read_raster(path, dtype)
    return arr, get_raster_meta(arr, wkt, transform)


def write_aagrid(path: str, arr: np.ndarray, meta_transform, nodata=-9999.0):
    """Write an ESRI ASCII grid in the GDAL AAIGrid layout: the header,
    then one "%.12g" value per cell (12 significant digits, ~1e-12
    relative round-trip), the body formatted by the native writer
    (io/fastio.py; C printf, the same text as Python's "%.12g")."""
    from . import fastio
    nrows, ncols = arr.shape
    xll = meta_transform[0]
    yll = meta_transform[3] - nrows * meta_transform[1]
    cellsize = meta_transform[1]

    def fmt_hdr(v):
        fv = float(v)
        return str(int(fv)) if fv == int(fv) else repr(fv)

    with open(path, "w") as f:
        f.write(f"ncols        {ncols}\n")
        f.write(f"nrows        {nrows}\n")
        f.write(f"xllcorner    {fmt_hdr(xll)}\n")
        f.write(f"yllcorner    {fmt_hdr(yll)}\n")
        f.write(f"cellsize     {fmt_hdr(cellsize)}\n")
        f.write(f"NODATA_value  {fmt_hdr(nodata)}\n")
    fastio.write_asc_body(path, arr)


def write_raster(fn_prefix: str, array: np.ndarray, wkt: str, transform,
                 file_format: str):
    """Write a single-band raster as .asc (src/out.jl:485-531)."""
    if file_format == "tif":
        raise NotImplementedError(
            "GeoTIFF output is not carried by circuitscape_tpu_torch yet "
            "(ROADMAP queue 1 item 10); set write_as_tif = False")
    write_aagrid(fn_prefix + ".asc", array, transform)
