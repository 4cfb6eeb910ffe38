"""The port's image reads where cv2.imread decides by a file's content, not
its name (openobj_torch.data.loaders: read_image, imread, _read_rgb).

The committed fixtures (tests/data/png, tests/data/jpeg) are written under
swapped names (a JPEG as .png, a PNG as .jpg) and as .jpe; broken PNGs
(cut at every byte, a critical chunk failing its CRC, corrupt image data),
empty files and files of no image format beside them. Each read is held
against cv2.imread on the same file where this environment has OpenCV;
without it, against the outcome written in the test: the fixtures' stored
digests of OpenCV's colour decode, and None for every broken file.
"""

import hashlib
import json
import os
import shutil
import struct
import zlib

import numpy as np
import pytest

from openobj_torch.data import loaders
from openobj_torch.utils import jpeg, png

try:
    import cv2
except ImportError:   # the expected outcomes below stand in for it
    cv2 = None

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
JPEGS = sorted(f for f in os.listdir(os.path.join(DATA, "jpeg")) if f.endswith(".jpg"))
PNGS = sorted(f for f in os.listdir(os.path.join(DATA, "png")) if f.endswith(".png"))


def _digests(kind):
    with open(os.path.join(DATA, kind, "digests.json")) as f:
        return json.load(f)


def _sha(im):
    return hashlib.sha256(np.ascontiguousarray(im).tobytes()).hexdigest()


def _cv2_read(path, colour):
    """cv2.imread's answer, channels in RGB(A) order as the port's."""
    im = cv2.imread(str(path), cv2.IMREAD_COLOR if colour else cv2.IMREAD_UNCHANGED)
    if im is not None and im.ndim == 3:
        im = im[..., [2, 1, 0, 3][:im.shape[2]]]
    return im


@pytest.mark.parametrize("ext", [".png", ".jpe"])
@pytest.mark.parametrize("name", JPEGS)
def test_jpeg_under_another_name(tmp_path, name, ext):
    """A JPEG named .png or .jpe reads as cv2.imread reads it: colour (turned
    by its EXIF orientation) and unchanged (as stored, grey as [H, W])."""
    path = tmp_path / (name[:-4] + ext)
    shutil.copy(os.path.join(DATA, "jpeg", name), path)
    colour, unchanged = loaders._read_rgb(str(path)), loaders.read_image(str(path))
    np.testing.assert_array_equal(loaders.imread(str(path), colour=True), colour)
    if cv2 is not None:
        np.testing.assert_array_equal(colour, _cv2_read(path, True))
        np.testing.assert_array_equal(unchanged, _cv2_read(path, False))
    entry = _digests("jpeg")[name]
    assert list(colour.shape) == entry["shape"] and _sha(colour) == entry["sha256"]
    frame = jpeg.parse(path.read_bytes())
    if len(frame.components) == 1:
        np.testing.assert_array_equal(np.repeat(unchanged[..., None], 3, axis=2), colour)
    else:
        np.testing.assert_array_equal(jpeg.orient(unchanged, frame.orientation), colour)


@pytest.mark.parametrize("ext", [".jpg", ".jpe"])
@pytest.mark.parametrize("name", PNGS)
def test_png_under_another_name(tmp_path, name, ext):
    """A PNG named .jpg or .jpe reads as cv2.imread reads it, both reads."""
    path = tmp_path / (name[:-4] + ext)
    shutil.copy(os.path.join(DATA, "png", name), path)
    entry = _digests("png")[name]
    for colour, key in ((True, "colour"), (False, "unchanged")):
        got = loaders.read_image(str(path), colour)
        np.testing.assert_array_equal(loaders.imread(str(path), colour), got)
        if cv2 is not None:
            want = _cv2_read(path, colour)
            assert want.dtype == got.dtype
            np.testing.assert_array_equal(got, want)
        assert list(got.shape) == entry[key]["shape"] and str(got.dtype) == entry[key]["dtype"]
        assert _sha(got) == entry[key]["sha256"], key


def _broken_pngs():
    """(name, bytes, whether cv2.imread reads it) of broken and odd files."""
    rng = np.random.default_rng(5)
    data = png.encode_png(rng.integers(0, 256, (3, 4, 3)).astype(np.uint8))
    idat = data.index(b"IDAT") - 4
    (n,) = struct.unpack(">I", data[idat:idat + 4])

    def flip(at):
        b = bytearray(data)
        b[at] ^= 0x5A
        return bytes(b)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    text = chunk(b"tEXt", b"Comment\x00hello")
    bad_text = text[:-1] + bytes([text[-1] ^ 1])
    cases = [("empty", b"", False), ("text", b"not an image at all\n", False),
             ("signature only", data[:8], False),
             ("IDAT fails its CRC", flip(idat + 8 + n), False),
             ("IHDR fails its CRC", flip(8 + 8 + 13), False),
             ("corrupt image data", flip(idat + 8 + 3), False),
             ("no IEND", data[:-12], False),
             # libpng leaves out an ancillary chunk whose CRC fails
             ("tEXt fails its CRC", data[:idat] + bad_text + data[idat:], True),
             ("whole", data, True)]
    cases += [(f"cut at {k}", data[:k], False) for k in range(9, len(data))]
    return cases


@pytest.mark.parametrize("ext", [".png", ".jpg"])
def test_broken_files_read_as_none(tmp_path, ext):
    """eval's and the preflight's imread return None wherever cv2.imread
    does: an empty file, a PNG cut at any byte, a critical chunk failing its
    CRC, corrupt image data, a file of no image format, a missing file; the
    loaders' colour read raises on each, as it raised before."""
    assert loaders.imread(str(tmp_path / f"missing{ext}")) is None
    for what, data, readable in _broken_pngs():
        path = tmp_path / f"f{ext}"
        path.write_bytes(data)
        if cv2 is not None:
            assert (_cv2_read(path, True) is not None) == readable, what
            assert (_cv2_read(path, False) is not None) == readable, what
        for colour in (True, False):
            got = loaders.imread(str(path), colour)
            assert (got is not None) == readable, what
            if readable and cv2 is not None:
                np.testing.assert_array_equal(got, _cv2_read(path, colour))
        if not readable:
            with pytest.raises((ValueError, NotImplementedError)):
                loaders._read_rgb(str(path))


def test_imread_passes_other_errors_on(tmp_path, monkeypatch):
    """Only a read that fails maps to None: another error in a decoder
    reaches the caller."""
    path = tmp_path / "a.png"
    path.write_bytes(png.encode_png(np.zeros((2, 2, 3), np.uint8)))

    def broken(data, colour=False):
        raise TypeError("a fault of the program, not of the file")

    monkeypatch.setattr(loaders, "decode_png", broken)
    with pytest.raises(TypeError):
        loaders.imread(str(path))
