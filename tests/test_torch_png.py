"""The port's PNG reader (openobj_torch.utils.png) against OpenCV's: every
byte, shape and dtype of ``decode_png`` equal to ``cv2.imdecode`` with
``IMREAD_UNCHANGED`` (-1) and with ``IMREAD_COLOR`` (channels reversed) on
files that a small encoder here writes: every colour type at every bit
depth it allows, non-interlaced and Adam7-interlaced, with and without a
``tRNS`` chunk, each row with one of the five filters in turn; and the
files OpenCV refuses or reads leniently (a critical chunk's CRC, an
ancillary one's, a ``tRNS`` that does not fit, a palette index past the
palette); and the committed fixtures under tests/data/png/ (written by
``python tests/test_torch_png.py --write-fixtures``) equal to their stored
digests of cv2's decode."""

import hashlib
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from torch_threads import one_torch_thread  # noqa: E402,F401

from openobj_torch.utils import png  # noqa: E402

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, c] samples -> [h, stride] bytes, sub-byte samples packed most
    significant bits first, 16-bit ones big-endian."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    flat = samples.reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat
    per = 8 // depth
    flat = np.pad(flat, ((0, 0), (0, -flat.shape[1] % per))).reshape(h, -1, per)
    shifts = 8 - depth * (np.arange(per) + 1)
    return (flat << shifts).sum(-1).astype(np.uint8)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter(rows: np.ndarray, bpp: int, first: int) -> bytes:
    """Each row filtered with type (first + row) % 5."""
    out = bytearray()
    prior = [0] * rows.shape[1]
    for y, row in enumerate(rows.tolist()):
        ftype = (first + y) % 5
        out.append(ftype)
        for x, v in enumerate(row):
            a = row[x - bpp] if x >= bpp else 0
            c = prior[x - bpp] if x >= bpp else 0
            pred = (0, a, prior[x], (a + prior[x]) // 2, _paeth(a, prior[x], c))[ftype]
            out.append((v - pred) & 0xFF)
        prior = row
    return bytes(out)


def encode(samples, depth: int, ctype: int, interlace: int = 0, plte=None,
           trns: bytes | None = None) -> bytes:
    """PNG bytes of [h, w, c] samples (palette indices for colour type 3)
    at ``depth`` bits, Adam7-interlaced when ``interlace``, the image data
    split over two IDAT chunks."""
    s = np.asarray(samples)
    s = s[..., None] if s.ndim == 2 else s
    h, w, c = s.shape
    bpp = max(1, c * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b"".join(_filter(_pack(s[y0::dy, x0::dx], depth), bpp, i)
                   for i, (x0, y0, dx, dy) in enumerate(passes)
                   if s[y0::dy, x0::dx].size)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                                             0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", bytes(np.asarray(plte, np.uint8).reshape(-1)))
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    z = zlib.compress(raw, 6)
    return (out + _chunk(b"IDAT", z[:len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:])
            + _chunk(b"IEND", b""))


def _cv2(data: bytes, colour: bool) -> np.ndarray | None:
    """cv2's decode with its channels in RGB(A) order."""
    im = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR if colour else -1)
    if im is not None and im.ndim == 3:
        im = im[..., [2, 1, 0, 3][:im.shape[2]]]
    return im


def _assert_reads_like_cv2(data: bytes):
    for colour in (False, True):
        want = _cv2(data, colour)
        got = png.decode_png(data, colour)
        assert got.dtype == want.dtype and got.shape == want.shape, (colour, got.shape, want.shape)
        np.testing.assert_array_equal(got, want)


def _case(ctype: int, depth: int, with_trns: bool, h: int, w: int, seed: int):
    """(samples, PLTE, tRNS) of a random image; the tRNS colour key is the
    first pixel's, so that some pixels match it."""
    rng = np.random.default_rng(seed)
    top = 1 << depth
    plte = trns = None
    if ctype == 3:
        n = int(rng.integers(2, min(top, 256) + 1))
        plte = rng.integers(0, 256, (n, 3))
        s = rng.integers(0, n, (h, w, 1))
        if with_trns:
            trns = bytes(rng.integers(0, 256, int(rng.integers(1, n + 1))).astype(np.uint8))
        return s, plte, trns
    s = rng.integers(0, top, (h, w, CHANNELS[ctype]))
    s[h // 2, w // 2] = s[0, 0]
    if with_trns:
        trns = struct.pack(">" + "H" * CHANNELS[ctype], *map(int, s[0, 0]))
    return s, plte, trns


# (colour type, depth, tRNS): PNG allows no tRNS chunk with an alpha channel
FORMATS = [(c, d, t) for c, ds in DEPTHS.items() for d in ds for t in (False, True)
           if not (t and c in (4, 6))]


@pytest.mark.parametrize("interlace", [0, 1], ids=["noninterlaced", "adam7"])
@pytest.mark.parametrize("ctype,depth,with_trns", FORMATS,
                         ids=[f"type{c}_{d}bit{'_tRNS' if t else ''}" for c, d, t in FORMATS])
def test_every_format_reads_as_cv2(ctype, depth, with_trns, interlace):
    """Each colour type at each depth, both interlace methods, with a tRNS
    chunk where the type allows one, at sizes where Adam7's first passes
    are empty and where a row ends inside a byte."""
    for i, (h, w) in enumerate([(1, 1), (3, 5), (9, 13), (17, 10)]):
        s, plte, trns = _case(ctype, depth, with_trns, h, w, seed=depth * 10 + ctype + i)
        _assert_reads_like_cv2(encode(s, depth, ctype, interlace, plte, trns))


def test_low_bit_grey_is_scaled():
    """libpng scales 1-, 2- and 4-bit grey to 8 bits (2-bit: 0, 85, 170, 255)."""
    levels = np.arange(4).reshape(1, 4)
    got = png.decode_png(encode(levels, 2, 0))
    np.testing.assert_array_equal(got, [[0, 85, 170, 255]])
    np.testing.assert_array_equal(got, _cv2(encode(levels, 2, 0), False))
    np.testing.assert_array_equal(png.decode_png(encode(np.arange(16).reshape(1, 16), 4, 0)),
                                  np.arange(16).reshape(1, 16) * 17)


def test_colour_keys_add_alpha_only_to_rgb_and_palettes():
    """Unchanged, a tRNS colour key gives RGB an alpha channel (0 on the
    key) and a palette its tRNS alphas; grey stays grey. The colour read
    drops them all."""
    rgb = np.array([[[1, 2, 3], [4, 5, 6]]])
    got = png.decode_png(encode(rgb, 8, 2, trns=struct.pack(">HHH", 1, 2, 3)))
    np.testing.assert_array_equal(got, [[[1, 2, 3, 0], [4, 5, 6, 255]]])
    grey = png.decode_png(encode(np.array([[7, 9]]), 8, 0, trns=struct.pack(">H", 7)))
    assert grey.shape == (1, 2)
    pal = encode(np.array([[0, 1, 2]]), 2, 3, plte=[[9, 8, 7], [6, 5, 4], [3, 2, 1]],
                 trns=bytes([10, 20]))
    np.testing.assert_array_equal(png.decode_png(pal)[..., 3], [[10, 20, 255]])
    assert png.decode_png(pal, colour=True).shape == (1, 3, 3)
    _assert_reads_like_cv2(pal)


def _corrupt(data: bytes, kind: bytes) -> bytes:
    """``data`` with one bit of chunk ``kind``'s body flipped (its CRC kept)."""
    b = bytearray(data)
    b[data.index(kind) + 4] ^= 1
    return bytes(b)


def test_crc_and_lenient_chunks_as_libpng():
    """A critical chunk that fails its CRC is refused (cv2 returns None);
    an ancillary one that does, a tRNS longer than the palette, a PLTE in
    an RGB file and a palette index past the palette (black) are read as
    libpng reads them."""
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (4, 5, 3))
    bad_idat = _corrupt(encode(rgb, 8, 2), b"IDAT")
    assert _cv2(bad_idat, False) is None
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bad_idat)
    keyed = encode(rgb, 8, 2, trns=struct.pack(">HHH", *map(int, rgb[0, 0])))
    _assert_reads_like_cv2(_corrupt(keyed, b"tRNS"))
    plte = rng.integers(0, 256, (4, 3))
    idx = rng.integers(0, 8, (4, 5))                   # 4..7 lie past the palette
    _assert_reads_like_cv2(encode(idx, 4, 3, plte=plte))
    _assert_reads_like_cv2(encode(idx % 4, 4, 3, plte=plte, trns=bytes(5)))
    _assert_reads_like_cv2(encode(rgb, 8, 2, plte=plte))
    with pytest.raises(ValueError, match="PLTE"):
        png.decode_png(encode(idx % 4, 4, 3))


def test_read_png_reads_paths_both_ways(tmp_path):
    """read_png(path) is cv2.imread(path, -1); read_png(path, colour=True)
    is cv2.imread(path), channels reversed."""
    rng = np.random.default_rng(4)
    path = tmp_path / "f.png"
    path.write_bytes(encode(rng.integers(0, 65536, (6, 7, 4)), 16, 6, interlace=1))
    for colour, flag in ((False, -1), (True, cv2.IMREAD_COLOR)):
        want = cv2.imread(str(path), flag)
        np.testing.assert_array_equal(png.read_png(str(path), colour),
                                      want[..., [2, 1, 0, 3][:want.shape[2]]])


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "png")
# name -> (colour type, depth, Adam7, tRNS, height, width, seed)
FIXTURE_CASES = {"palette4_trns_adam7_13x17.png": (3, 4, 1, True, 13, 17, 1),
                 "palette8_31x45.png": (3, 8, 0, False, 31, 45, 2),
                 "grey2_adam7_9x13.png": (0, 2, 1, False, 9, 13, 3),
                 "rgb16_trns_11x7.png": (2, 16, 0, True, 11, 7, 4),
                 "grey_alpha8_adam7_10x6.png": (4, 8, 1, False, 10, 6, 5)}


def _digest(im: np.ndarray) -> dict:
    return {"shape": list(im.shape), "dtype": str(im.dtype),
            "sha256": hashlib.sha256(np.ascontiguousarray(im).tobytes()).hexdigest()}


def test_fixtures_equal_their_digests():
    """The committed fixtures (chip_smoke.py phase 4g reads them on the
    card's machine, which has no cv2) read to the stored digests of cv2's
    decode in both modes, here by cv2 and by the port."""
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        want = json.load(f)
    assert sorted(want) == sorted(FIXTURE_CASES)
    for name, modes in want.items():
        path = os.path.join(FIXTURES, name)
        for mode, flag in (("unchanged", -1), ("colour", cv2.IMREAD_COLOR)):
            ref = cv2.imread(path, flag)
            ref = ref[..., [2, 1, 0, 3][:ref.shape[2]]] if ref.ndim == 3 else ref
            assert _digest(ref) == modes[mode], (name, mode)
            assert _digest(png.read_png(path, mode == "colour")) == modes[mode], (name, mode)


def write_fixtures() -> None:
    """Write tests/data/png/: the FIXTURE_CASES files by ``encode``, and
    digests.json (shape, dtype and SHA-256 of cv2's decode of each, RGB(A)
    order, unchanged and colour)."""
    os.makedirs(FIXTURES, exist_ok=True)
    digests = {}
    for name, (ctype, depth, interlace, with_trns, h, w, seed) in FIXTURE_CASES.items():
        samples, plte, trns = _case(ctype, depth, with_trns, h, w, seed)
        data = encode(samples, depth, ctype, interlace, plte, trns)
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
        digests[name] = {"unchanged": _digest(_cv2(data, False)),
                         "colour": _digest(_cv2(data, True))}
    with open(os.path.join(FIXTURES, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1)


if __name__ == "__main__" and "--write-fixtures" in sys.argv:
    write_fixtures()
