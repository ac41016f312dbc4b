"""circuitscape_tpu_torch raster IO against the JAX package on the CPU:
every GeoTIFF of tests/data/input, TIFFs of every codec the reader
covers (LZW, Deflate, PackBits, the horizontal predictor, BigTIFF),
ENVI and ESRI EHdr binary grids, and the GeoTIFF writer, byte for byte.
Both packages read the same file; arrays, transforms, WKT and nodata
must be equal, and the files the writers produce identical."""

import glob
import os
import struct

import numpy as np
import pytest
import torch

from circuitscape_tpu.io import raster as jraster
from circuitscape_tpu_torch.io import raster as traster
from golden_utils import DATA_DIR

# one intra-op thread: the suite runs in several pytest-xdist workers at
# once, and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)

CORPUS_TIFFS = sorted(
    os.path.relpath(p, DATA_DIR) for p in
    glob.glob(os.path.join(DATA_DIR, "input", "**", "*.tif*"),
              recursive=True))


def _same_read(path):
    """read_raster and guess_file_type of both packages on path: equal
    arrays (values and dtype), WKT and transforms.  Returns the array."""
    a, wkt_a, tr_a = traster.read_raster(str(path))
    b, wkt_b, tr_b = jraster.read_raster(str(path))
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    assert wkt_a == wkt_b
    assert tuple(tr_a) == tuple(tr_b)
    assert traster.guess_file_type(str(path)) == \
        jraster.guess_file_type(str(path))
    return a


def test_corpus_has_tiffs():
    """The GeoTIFF inputs the corpus INIs name (sgVerify1, sgVerify10's
    folder, mgVerify3) are all found."""
    assert len(CORPUS_TIFFS) == 7


@pytest.mark.parametrize("rel", CORPUS_TIFFS)
def test_corpus_tiff_reads_as_jax(rel):
    """The raw TIFF decode (array, nodata, transform, WKT before the
    nodata normalisation) and read_raster, both packages."""
    path = os.path.join(DATA_DIR, rel)
    data = traster._read_bytes(path)
    assert data == jraster._read_bytes(path)
    at, nt, trt, wt = traster._read_tiff(data)
    aj, nj, trj, wj = jraster._read_tiff(data)
    assert at.dtype == aj.dtype
    np.testing.assert_array_equal(at, aj)
    assert (nt, tuple(trt), wt) == (nj, tuple(trj), wj)
    arr = _same_read(path)
    assert arr.shape in ((10, 10), (5, 5))


@pytest.mark.parametrize("dtype,compress", [
    (np.float32, "deflate"), (np.float64, "deflate"),
    (np.float64, "none")])
def test_write_tiff_matches_jax(tmp_path, dtype, compress):
    """write_tiff gives the JAX package's bytes, and the file reads back
    as written (nodata cells included)."""
    rng = np.random.default_rng(41)
    a = (rng.standard_normal((9, 13)) * 100).astype(dtype)
    a[2, 5] = -9999.0
    transform = (350.0, 30.0, 0.0, 9000.0, 0.0, -30.0)
    traster.write_tiff(str(tmp_path / "t.tif"), a, transform, "",
                       compress=compress)
    jraster.write_tiff(str(tmp_path / "j.tif"), a, transform, "",
                       compress=compress)
    assert (tmp_path / "t.tif").read_bytes() == \
        (tmp_path / "j.tif").read_bytes()
    back = _same_read(tmp_path / "t.tif")
    np.testing.assert_array_equal(back, a.astype(np.float64))
    _, _, tr = traster.read_raster(str(tmp_path / "t.tif"))
    assert tuple(tr) == transform


def test_write_raster_tif_matches_jax(tmp_path):
    """write_raster's tif branch (the maps writer with write_as_tif)."""
    rng = np.random.default_rng(42)
    a = rng.uniform(0, 5, (6, 4))
    transform = (0.0, 1.0, 0.0, 6.0, 0.0, -1.0)
    traster.write_raster(str(tmp_path / "t"), a, "", transform, "tif")
    jraster.write_raster(str(tmp_path / "j"), a, "", transform, "tif")
    assert (tmp_path / "t.tif").read_bytes() == \
        (tmp_path / "j.tif").read_bytes()


@pytest.mark.parametrize("compression", ["tiff_lzw", "tiff_adobe_deflate",
                                         "packbits"])
def test_compressed_tiff_reads_as_jax(tmp_path, compression):
    """Strips written by an independent encoder (Pillow) in each codec."""
    from PIL import Image
    rng = np.random.default_rng(7)
    arr = rng.uniform(0.0, 100.0, (37, 23)).astype(np.float32)
    arr[3, 4] = -9999.0
    p = tmp_path / f"{compression}.tif"
    Image.fromarray(arr).save(str(p), compression=compression)
    back = _same_read(p)
    expect = arr.astype(np.float64)
    np.testing.assert_array_equal(back, expect)


def test_multistrip_predictor2_reads_as_jax(tmp_path):
    """Multi-strip LZW with horizontal differencing (predictor 2)."""
    from PIL import Image, TiffImagePlugin
    arr = (np.arange(64 * 48).reshape(64, 48) % 251).astype(np.uint8)
    p = tmp_path / "pred2.tif"
    with TiffImagePlugin.AppendingTiffWriter(str(p), True) as tf:
        im = Image.fromarray(arr)
        im.encoderinfo = {}
        im.save(tf, format="TIFF", compression="tiff_lzw",
                tiffinfo={317: 2})
    back = _same_read(p)
    np.testing.assert_array_equal(back.astype(np.uint8), arr)


def _bigtiff(path, arr):
    """A BigTIFF (version 43: 8-byte offsets, 20-byte IFD entries, LONG8
    strip offset) of one float64 strip, nodata -9999."""
    H, W = arr.shape
    pix = arr.astype("<f8").tobytes()
    blobs = {42113: b"-9999.0\x00".ljust(18, b"\x00"),
             33550: struct.pack("<3d", 2.0, 2.0, 0.0),
             33922: struct.pack("<6d", 0, 0, 0, 100.0, 50.0, 0)}
    entries = [
        (256, 3, 1, struct.pack("<H", W)),
        (257, 3, 1, struct.pack("<H", H)),
        (258, 3, 1, struct.pack("<H", 64)),
        (259, 3, 1, struct.pack("<H", 1)),
        (273, 16, 1, None),
        (277, 3, 1, struct.pack("<H", 1)),
        (278, 3, 1, struct.pack("<H", H)),
        (279, 16, 1, struct.pack("<Q", len(pix))),
        (33550, 12, 3, None),
        (33922, 12, 6, None),
        (339, 3, 1, struct.pack("<H", 3)),
        (42113, 2, 18, None),
    ]
    cursor = 16 + 8 + 20 * len(entries) + 8
    offs = {}
    for tag in (33550, 33922, 42113):
        offs[tag] = cursor
        cursor += len(blobs[tag])
    out = bytearray(b"II" + struct.pack("<HHH", 43, 8, 0) +
                    struct.pack("<Q", 16) + struct.pack("<Q", len(entries)))
    for tag, typ, cnt, val in entries:
        if tag == 273:
            val = struct.pack("<Q", cursor)
        elif val is None:
            val = struct.pack("<Q", offs[tag])
        out += struct.pack("<HHQ", tag, typ, cnt) + val.ljust(8, b"\x00")
    out += struct.pack("<Q", 0)
    for tag in (33550, 33922, 42113):
        out += blobs[tag]
    out += pix
    path.write_bytes(bytes(out))


def test_bigtiff_reads_as_jax(tmp_path):
    rng = np.random.default_rng(8)
    arr = rng.uniform(0.0, 5.0, (7, 11))
    arr[1, 2] = -9999.0
    _bigtiff(tmp_path / "big.tif", arr)
    back = _same_read(tmp_path / "big.tif")
    np.testing.assert_array_equal(back, arr)
    _, _, tr = traster.read_raster(str(tmp_path / "big.tif"))
    assert tuple(tr) == (100.0, 2.0, 0.0, 50.0, 0.0, -2.0)


def _ref_grid():
    rng = np.random.default_rng(11)
    a = rng.uniform(0.5, 3.0, (7, 9)).astype(np.float32)
    a[2, 3] = -9999.0
    return a


# (name, file, writer of the body, header text): EHdr BIL with a
# pixel-centre origin, the .flt dialect (corner origin), ENVI BSQ
# big-endian with map info, ENVI BIL with two int16 bands
_SIDECAR = {
    "ehdr_bil": ("g.bil", lambda p: _ref_grid().tofile(p),
                 "NROWS 7\nNCOLS 9\nNBANDS 1\nNBITS 32\nPIXELTYPE FLOAT\n"
                 "BYTEORDER I\nLAYOUT BIL\nULXMAP 100.5\nULYMAP 49.5\n"
                 "XDIM 1\nYDIM 1\nNODATA_VALUE -9999\n"),
    "ehdr_flt": ("g.flt", lambda p: _ref_grid().tofile(p),
                 "ncols 9\nnrows 7\nxllcorner 10\nyllcorner 20\n"
                 "cellsize 2\nNODATA_value -9999\nbyteorder LSBFIRST\n"),
    "envi_bsq_be": ("g.dat", lambda p: _ref_grid().astype(">f4").tofile(p),
                    "ENVI\nsamples = 9\nlines = 7\nbands = 1\n"
                    "data type = 4\ninterleave = bsq\nbyte order = 1\n"
                    "header offset = 0\nmap info = {UTM, 1, 1, 300.0, "
                    "700.0, 30.0, 30.0, 12, North}\n"
                    "data ignore value = -9999\n"),
    "envi_bil_int16": ("g.img", lambda p: np.stack(
        [np.arange(24, dtype=np.int16).reshape(4, 6) + 1,
         np.arange(24, dtype=np.int16).reshape(4, 6) + 50],
        axis=1).tofile(p),
        "ENVI\nsamples = 6\nlines = 4\nbands = 2\ndata type = 2\n"
        "interleave = bil\nbyte order = 0\n"),
}


@pytest.mark.parametrize("case", sorted(_SIDECAR))
def test_sidecar_raster_reads_as_jax(tmp_path, case):
    """ENVI and EHdr binary grids (a body and a .hdr beside it), built
    here: both packages read the same array and transform, and sniff
    the body as a raster."""
    name, write, hdr = _SIDECAR[case]
    write(tmp_path / name)
    (tmp_path / "g.hdr").write_text(hdr)
    arr = _same_read(tmp_path / name)
    if case.startswith("envi_bil"):
        np.testing.assert_array_equal(
            arr, np.arange(24, dtype=np.float64).reshape(4, 6) + 1)
    else:
        ref = _ref_grid()
        assert arr.shape == (7, 9) and arr[2, 3] == -9999.0
        np.testing.assert_allclose(arr[ref != -9999], ref[ref != -9999],
                                   rtol=1e-7)


def test_asc_wins_over_stray_hdr_as_jax(tmp_path):
    p = tmp_path / "g.asc"
    p.write_text("ncols 2\nnrows 2\nxllcorner 0\nyllcorner 0\n"
                 "cellsize 1\nNODATA_value -9999\n1 2\n3 4\n")
    (tmp_path / "g.hdr").write_text("NROWS 2\nNCOLS 2\n")
    np.testing.assert_array_equal(_same_read(p), [[1, 2], [3, 4]])
