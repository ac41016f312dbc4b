"""Raster IO: AAGrid (.asc), GeoTIFF/BigTIFF (.tif), ESRI EHdr and ENVI
binary grids, NPY, with transparent gzip.

Counterpart of circuitscape_tpu/io/raster.py, whose readers and GeoTIFF
writer are copied here.  Parity reference: src/io.jl:113-157 (file
sniffing), :517-555 (read_raster: nodata -> -9999 normalization,
NaN -> -9999), src/out.jl:485-531 (write_raster).  The reference reads
through GDAL; here the formats are parsed natively: TIFF by a
self-contained binary reader covering the GeoTIFF profile GDAL emits
(single band, strips or tiles; none/LZW/Deflate/PackBits; horizontal
and floating-point predictors).  The ASC body is written by the native
formatter (io/fastio.py), as in the JAX package.
"""

from __future__ import annotations

import gzip
import io as _io
import os
import struct
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
    if _find_sidecar_hdr(path) is not None:
        # binary grid with a sidecar header (ESRI EHdr/BIL/FLT, ENVI):
        # a raster, not a text list (read_raster dispatches on the hdr)
        return consts.FILE_TYPE_GEOTIFF
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


# ---------------------------------------------------------------------------
# TIFF (GeoTIFF profile: single band; strip or tile organized; compression
# none/LZW/Deflate/PackBits; horizontal + floating-point predictors) —
# covers what GDAL itself emits, including the reference's COMPRESS=LZW
# outputs (src/out.jl:499)
# ---------------------------------------------------------------------------


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW (MSB-first bit packing, early code-width change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    bitpos = 0
    nbits = len(data) * 8
    width = 9
    table = []
    prev = b""

    def read_code(w):
        nonlocal bitpos
        if bitpos + w > nbits:
            return EOI
        byte0 = bitpos >> 3
        window = data[byte0:byte0 + 4].ljust(4, b"\x00")
        val = int.from_bytes(window, "big")
        val >>= 32 - (bitpos & 7) - w
        bitpos += w
        return val & ((1 << w) - 1)

    while True:
        code = read_code(width)
        if code == EOI:
            break
        if code == CLEAR:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            width = 9
            code = read_code(width)
            if code == EOI:
                break
            entry = table[code]
            out += entry
            prev = entry
            continue
        if code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("corrupt LZW stream")
        out += entry
        prev = entry
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        c = data[i]
        i += 1
        if c < 128:
            out += data[i:i + c + 1]
            i += c + 1
        elif c > 128:
            out += data[i:i + 1] * (257 - c)
            i += 1
    return bytes(out)


def _decompress(raw: bytes, comp: int) -> bytes:
    if comp == 1:
        return raw
    if comp == 5:
        return _lzw_decode(raw)
    if comp in (8, 32946):  # Adobe Deflate / legacy Deflate
        import zlib
        return zlib.decompress(raw)
    if comp == 32773:
        return _packbits_decode(raw)
    raise ValueError(f"Unsupported TIFF compression {comp}")


def _decode_block(raw: bytes, rows: int, cols: int, dtype: np.dtype,
                  predictor: int) -> np.ndarray:
    """Raw (decompressed) block bytes -> (rows, cols) array, undoing the
    TIFF predictor.  Predictor 2 = horizontal differencing on samples;
    predictor 3 = floating-point predictor (byte deltas, then MSB-first
    byte planes deinterleaved per row)."""
    bpp = dtype.itemsize
    want = rows * cols * bpp
    if len(raw) < want:
        raw = raw + b"\x00" * (want - len(raw))
    if predictor == 3:
        rowbytes = np.frombuffer(raw[:want], np.uint8).reshape(
            rows, cols * bpp)
        rowbytes = np.cumsum(rowbytes, axis=1, dtype=np.uint8)
        planes = rowbytes.reshape(rows, bpp, cols)
        interleaved = np.ascontiguousarray(planes.transpose(0, 2, 1))
        be = np.dtype(f">{dtype.kind}{bpp}")
        return interleaved.reshape(rows, cols * bpp).view(be).astype(
            dtype.newbyteorder("="))
    block = np.frombuffer(raw[:want], dtype).reshape(rows, cols)
    if predictor == 2:
        block = np.cumsum(block, axis=1, dtype=block.dtype)
    return block

_TIFF_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
                   10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TIFF_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i",
                  11: "f", 12: "d", 16: "Q", 17: "q", 18: "Q"}


def _tiff_tag_values(bo, data, typ, cnt, val_bytes, big=False):
    """Tag payload decode; `big` selects BigTIFF conventions (8-byte
    inline value slot, 8-byte external offsets, LONG8 types 16-18)."""
    size = _TIFF_TYPE_SIZE[typ] * cnt
    inline = 8 if big else 4
    if size > inline:
        off = struct.unpack(bo + ("Q" if big else "I"), val_bytes)[0]
        raw = data[off:off + size]
    else:
        raw = val_bytes[:size]
    if typ == 2:  # ASCII
        return raw.split(b"\x00")[0].decode("latin-1")
    if typ == 5:  # RATIONAL
        vals = struct.unpack(bo + "%dI" % (2 * cnt), raw)
        return [vals[2 * k] / vals[2 * k + 1] for k in range(cnt)]
    fmt = _TIFF_TYPE_FMT[typ]
    return list(struct.unpack(bo + "%d%s" % (cnt, fmt), raw))


def _read_tiff(data: bytes):
    if data[:2] == b"II":
        bo = "<"
    elif data[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError("Not a TIFF file")
    version = struct.unpack(bo + "H", data[2:4])[0]
    tags = {}
    if version == 43:
        # BigTIFF (GDAL writes it for >4 GB rasters; src/io.jl:517-555
        # reads any GDAL driver): 8-byte offsets, 20-byte IFD entries
        off_size, zero = struct.unpack(bo + "HH", data[4:8])
        if off_size != 8 or zero != 0:
            raise ValueError("Unsupported BigTIFF header")
        ifd_off = struct.unpack(bo + "Q", data[8:16])[0]
        n = struct.unpack(bo + "Q", data[ifd_off:ifd_off + 8])[0]
        for k in range(int(n)):
            e = ifd_off + 8 + 20 * k
            tag, typ, cnt = struct.unpack(bo + "HHQ", data[e:e + 12])
            tags[tag] = _tiff_tag_values(bo, data, typ, int(cnt),
                                         data[e + 12:e + 20], big=True)
    else:
        ifd_off = struct.unpack(bo + "I", data[4:8])[0]
        n = struct.unpack(bo + "H", data[ifd_off:ifd_off + 2])[0]
        for k in range(n):
            e = ifd_off + 2 + 12 * k
            tag, typ, cnt = struct.unpack(bo + "HHI", data[e:e + 8])
            tags[tag] = _tiff_tag_values(bo, data, typ, cnt,
                                         data[e + 8:e + 12])

    width = int(tags[256][0])
    height = int(tags[257][0])
    bits = int(tags.get(258, [8])[0])
    comp = int(tags.get(259, [1])[0])
    sfmt = int(tags.get(339, [1])[0])
    samples = int(tags.get(277, [1])[0])
    predictor = int(tags.get(317, [1])[0])
    if samples != 1:
        raise ValueError("Only single-band rasters are supported")

    kind = {1: "u", 2: "i", 3: "f"}[sfmt]
    dtype = np.dtype(f"{bo}{kind}{bits // 8}")

    if 322 in tags:  # tile-organized
        tw = int(tags[322][0])
        th = int(tags[323][0])
        offsets = tags[324]
        counts = tags[325]
        arr = np.zeros((height, width), dtype.newbyteorder("="))
        tiles_across = -(-width // tw)
        for k, (o, c) in enumerate(zip(offsets, counts)):
            raw = _decompress(data[int(o):int(o) + int(c)], comp)
            tile = _decode_block(raw, th, tw, dtype, predictor)
            ti, tj = divmod(k, tiles_across)
            r0, c0 = ti * th, tj * tw
            arr[r0:r0 + th, c0:c0 + tw] = tile[:height - r0, :width - c0]
    else:            # strip-organized
        rps = int(tags.get(278, [height])[0])
        offsets = tags[273]
        counts = tags[279]
        parts = []
        row = 0
        for o, c in zip(offsets, counts):
            rows = min(rps, height - row)
            raw = _decompress(data[int(o):int(o) + int(c)], comp)
            parts.append(_decode_block(raw, rows, width, dtype, predictor))
            row += rows
        arr = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]

    nodata = None
    if 42113 in tags:
        try:
            nodata = float(str(tags[42113]).strip())
        except ValueError:
            nodata = None

    transform = (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)
    if 33550 in tags and 33922 in tags:
        sx, sy = float(tags[33550][0]), float(tags[33550][1])
        tp = tags[33922]
        i0, j0, x0, y0 = float(tp[0]), float(tp[1]), float(tp[3]), float(tp[4])
        transform = (x0 - i0 * sx, sx, 0.0, y0 + j0 * sy, 0.0, -sy)
    wkt = tags.get(34737, "")
    if not isinstance(wkt, str):
        wkt = ""
    return arr, nodata, transform, wkt


# ---------------------------------------------------------------------------
# Sidecar-header binary rasters: ESRI EHdr (.bil/.bip/.bsq/.flt + .hdr)
# and ENVI (.dat/.img/.envi + ENVI .hdr).  The reference reads these
# through GDAL's EHdr/ENVI drivers (src/io.jl:517-555 reads *any* GDAL
# format); these two cover the binary-grid formats real Circuitscape
# corpora actually ship alongside .asc/.tif.
# ---------------------------------------------------------------------------

def _find_sidecar_hdr(path: str):
    base, ext = os.path.splitext(path)
    if ext.lower() == ".hdr":
        return None
    for cand in (base + ".hdr", base + ".HDR", path + ".hdr"):
        if os.path.isfile(cand):
            return cand
    return None


_ENVI_DTYPES = {1: np.uint8, 2: np.int16, 3: np.int32, 4: np.float32,
                5: np.float64, 12: np.uint16, 13: np.uint32,
                14: np.int64, 15: np.uint64}


def _deinterleave(raw, nrows, ncols, nbands, interleave, dt):
    n1 = nrows * ncols
    arr = np.frombuffer(raw, dtype=dt, count=n1 * nbands)
    if nbands == 1:
        return arr.reshape(nrows, ncols)
    il = interleave.lower()
    if il == "bsq":   # band-sequential: first band is the raster
        return arr[:n1].reshape(nrows, ncols)
    if il == "bip":   # pixel-interleaved
        return arr.reshape(nrows, ncols, nbands)[:, :, 0]
    # bil: row-interleaved by band
    return arr.reshape(nrows, nbands, ncols)[:, 0, :]


def _read_envi(path: str, hdr_text: str):
    """ENVI raster: `key = value` header, binary body."""
    fields = {}
    key = None
    for line in hdr_text.splitlines()[1:]:
        if "=" in line:
            key, _, val = line.partition("=")
            fields[key.strip().lower()] = val.strip()
        elif key and fields.get(key.strip().lower(), "").startswith("{"):
            fields[key.strip().lower()] += " " + line.strip()
    nrows = int(fields["lines"])
    ncols = int(fields["samples"])
    nbands = int(fields.get("bands", "1"))
    dcode = int(fields.get("data type", "4"))
    if dcode not in _ENVI_DTYPES:
        raise ValueError(f"unsupported ENVI data type {dcode}")
    order = ">" if fields.get("byte order", "0").strip() == "1" else "<"
    dt = np.dtype(_ENVI_DTYPES[dcode]).newbyteorder(order)
    skip = int(fields.get("header offset", "0"))
    arr = _deinterleave(_read_bytes(path)[skip:], nrows, ncols, nbands,
                        fields.get("interleave", "bsq"), dt)
    nodata = float(fields["data ignore value"]) \
        if "data ignore value" in fields else None
    transform = (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)
    mi = fields.get("map info", "")
    if mi.startswith("{"):
        parts = [p.strip() for p in mi.strip("{} ").split(",")]
        if len(parts) >= 7:
            # parts: proj, ref_col, ref_row, ulx, uly, xdim, ydim, ...
            # (ref pixel is 1-based and addresses the pixel's UL corner)
            rc, rr = float(parts[1]), float(parts[2])
            ulx, uly = float(parts[3]), float(parts[4])
            xdim, ydim = float(parts[5]), float(parts[6])
            x0 = ulx - (rc - 1) * xdim
            y0 = uly + (rr - 1) * ydim
            transform = (x0, xdim, 0.0, y0, 0.0, -ydim)
    return arr, nodata, transform, ""


def _read_ehdr(path: str, hdr_text: str):
    """ESRI EHdr/BIL/FLT raster: whitespace `KEY value` header."""
    fields = {}
    for line in hdr_text.splitlines():
        parts = line.split()
        if len(parts) >= 2:
            fields[parts[0].lower()] = parts[1]
    nrows = int(float(fields["nrows"]))
    ncols = int(float(fields["ncols"]))
    nbands = int(float(fields.get("nbands", "1")))
    nbits = int(float(fields.get("nbits", "32")))
    pixeltype = fields.get("pixeltype", "").upper()
    if not pixeltype and "byteorder" in fields and \
            fields["byteorder"].upper() in ("LSBFIRST", "MSBFIRST"):
        pixeltype = "FLOAT"     # .flt dialect is always float32
    if pixeltype == "FLOAT":
        base = {32: np.float32, 64: np.float64}[nbits]
    elif pixeltype == "SIGNEDINT":
        base = {8: np.int8, 16: np.int16, 32: np.int32}[nbits]
    else:
        base = {1: np.uint8, 8: np.uint8, 16: np.uint16,
                32: np.uint32}[nbits]
    bo = fields.get("byteorder", "I").upper()
    order = ">" if bo in ("M", "MSBFIRST") else "<"
    dt = np.dtype(base).newbyteorder(order)
    skip = int(float(fields.get("skipbytes", "0")))
    arr = _deinterleave(_read_bytes(path)[skip:], nrows, ncols, nbands,
                        fields.get("layout", "bil"), dt)
    nodata = None
    for k in ("nodata_value", "nodata"):
        if k in fields:
            nodata = float(fields[k])
    cellsize = float(fields.get("cellsize", fields.get("xdim", "1")))
    ydim = float(fields.get("ydim", cellsize))
    if "ulxmap" in fields:          # ULXMAP = center of UL pixel
        x0 = float(fields["ulxmap"]) - cellsize / 2
        y0 = float(fields["ulymap"]) + ydim / 2
    else:                           # .flt dialect: corner registration
        x0 = float(fields.get("xllcorner", "0"))
        y0 = float(fields.get("yllcorner", "0")) + nrows * ydim
    transform = (x0, cellsize, 0.0, y0, 0.0, -ydim)
    return arr, nodata, transform, ""


def _read_hdr_raster(path: str, hdr_path: str):
    with open(hdr_path) as f:
        hdr_text = f.read()
    if hdr_text.lstrip()[:4].upper() == "ENVI":
        return _read_envi(path, hdr_text)
    return _read_ehdr(path, hdr_text)


# ---------------------------------------------------------------------------
# Unified read / write
# ---------------------------------------------------------------------------

def read_raster(path: str, dtype=np.float64):
    """Read any supported raster; normalize nodata/NaN to -9999.

    Returns (array, wkt, transform) like the reference (src/io.jl:517-555).
    """
    check_path = path[:-3] if path.endswith(".gz") else path
    if not os.path.isfile(path) and not os.path.isfile(check_path):
        raise FileNotFoundError(f'the file "{check_path}" does not exist')
    if not os.path.isfile(path):
        path = check_path

    data = _read_bytes(path)
    ftype_hdr = data.split(b"\n", 1)[0].decode("latin-1")
    hdr_sidecar = _find_sidecar_hdr(path)

    if len(data) >= 4 and data[:2] in (b"II", b"MM"):
        arr, nodata, transform, wkt = _read_tiff(data)
        # UInt rasters can still carry negative nodata (src/io.jl:530-541)
        if np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.int64)
    elif ftype_hdr.startswith(consts.FILE_HDR_NPY):
        arr = np.load(_io.BytesIO(data))
        nodata, transform, wkt = (consts.NODATA,
                                  (0.0, 1.0, 0.0, 0.0, 0.0, -1.0), "")
    elif hdr_sidecar is not None and (
            (ftype_hdr.split() or [""])[0].lower() not in _ASC_KEYS):
        # binary grid with a sidecar header (ESRI EHdr/BIL/FLT or ENVI);
        # a text AAGrid wins over a stray .hdr next to it
        arr, nodata, transform, wkt = _read_hdr_raster(path, hdr_sidecar)
    else:
        arr, nodata, transform, wkt = _read_aagrid(data)

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


def write_tiff(path: str, arr: np.ndarray, transform, wkt: str = "",
               nodata=-9999.0, compress: str = "deflate", level: int = 0):
    """Write a single-band float GeoTIFF (one strip; Deflate-compressed
    by default, mirroring the reference's compressed outputs,
    src/out.jl:499).  float32 input stays 32-bit (half the bytes — the
    per-pair device maps are f32 by construction) and compresses at
    zlib level 1: the maps-on pairwise path writes hundreds of these
    and level 6 costs ~5x the CPU for ~15% smaller files."""
    if arr.dtype == np.float32:
        arr = np.ascontiguousarray(arr, dtype="<f4")
        bits = 32
        level = level or 1
    else:
        arr = np.ascontiguousarray(arr, dtype="<f8")
        bits = 64
        level = level or 6
    nrows, ncols = arr.shape
    pix = arr.tobytes()
    comp_tag = 1
    if compress == "deflate":
        import zlib
        pix = zlib.compress(pix, level)
        comp_tag = 8

    nodata_ascii = (repr(float(nodata)) + "\x00").encode()
    scale = struct.pack("<3d", transform[1], -transform[5], 0.0)
    tiepoint = struct.pack("<6d", 0, 0, 0, transform[0], transform[3], 0.0)

    entries = []  # (tag, type, count, value_bytes or data blob marker)
    blobs = []

    def add(tag, typ, cnt, packed):
        entries.append((tag, typ, cnt, packed))

    header_size = 8
    n_entries_guess = 13
    ifd_size = 2 + 12 * n_entries_guess + 4
    blob_cursor = header_size + ifd_size

    def add_blob(tag, typ, cnt, blob):
        nonlocal blob_cursor
        if len(blob) <= 4:
            add(tag, typ, cnt, blob.ljust(4, b"\x00"))
        else:
            add(tag, typ, cnt, struct.pack("<I", blob_cursor))
            blobs.append(blob)
            blob_cursor += len(blob)

    add(256, 3, 1, struct.pack("<HH", ncols, 0))
    add(257, 3, 1, struct.pack("<HH", nrows, 0))
    add(258, 3, 1, struct.pack("<HH", bits, 0))
    add(259, 3, 1, struct.pack("<HH", comp_tag, 0))
    add(262, 3, 1, struct.pack("<HH", 1, 0))       # BlackIsZero
    # strip offsets resolved after blobs are placed
    add(273, 4, 1, b"\x00\x00\x00\x00")
    add(277, 3, 1, struct.pack("<HH", 1, 0))
    add(278, 3, 1, struct.pack("<HH", nrows, 0))
    add(279, 4, 1, struct.pack("<I", len(pix)))
    add(339, 3, 1, struct.pack("<HH", 3, 0))       # IEEE float
    add_blob(33550, 12, 3, scale)
    add_blob(33922, 12, 6, tiepoint)
    add_blob(42113, 2, len(nodata_ascii), nodata_ascii)

    assert len(entries) == n_entries_guess
    pix_offset = blob_cursor
    entries = [(t, ty, c, struct.pack("<I", pix_offset)) if t == 273
               else (t, ty, c, v) for (t, ty, c, v) in entries]
    entries.sort(key=lambda e: e[0])

    out = bytearray()
    out += b"II*\x00" + struct.pack("<I", header_size)
    out += struct.pack("<H", len(entries))
    for tag, typ, cnt, val in entries:
        out += struct.pack("<HHI", tag, typ, cnt) + val
    out += struct.pack("<I", 0)  # next IFD
    for blob in blobs:
        out += blob
    assert len(out) == pix_offset
    out += pix
    with open(path, "wb") as f:
        f.write(bytes(out))



def write_raster(fn_prefix: str, array: np.ndarray, wkt: str, transform,
                 file_format: str):
    """Write a single-band raster as .asc or .tif (src/out.jl:485-531)."""
    if file_format == "tif":
        write_tiff(fn_prefix + ".tif", array, transform, wkt)
    else:
        write_aagrid(fn_prefix + ".asc", array, transform)
