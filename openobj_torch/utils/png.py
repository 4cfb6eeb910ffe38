"""A PNG writer and reader on the standard library (``zlib``, ``struct``).

The run's outputs are PNG files: ``train.render_dataset`` writes 8-bit RGB
colour renders and 16-bit grey depth / class-id / instance-id images, and
``eval.evaluate_run`` reads them back beside the ground truth. The JAX
package writes and reads them with OpenCV, which the port does without; the
files are the same format (PNG, non-interlaced, RGB in file order, 16-bit
samples big-endian), so either package's files load in the other.

``write_png`` writes 8-bit RGB ([H, W, 3] uint8) or 16-bit grey ([H, W]
uint16), every row with filter type 0. ``read_png`` reads grey, grey +
alpha, RGB and RGBA at 8 or 16 bits with any of the five row filters (as
other writers choose them), and returns what ``cv2.imread(path, -1)``
returns, with channels in RGB(A) order instead of BGR(A).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of an [H, W, 3] uint8 RGB or [H, W] uint16 grey image."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        colour, depth = 2, 8
    elif img.ndim == 2 and img.dtype == np.uint16:
        colour, depth = 0, 16
    else:
        raise ValueError(
            f"encode_png: expected [H, W, 3] uint8 or [H, W] uint16, got "
            f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img, dtype=img.dtype.newbyteorder(">")).view(np.uint8)
    raw = np.zeros((h, 1 + rows.size // h), np.uint8)   # filter byte 0 per row
    raw[:, 1:] = rows.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of decompressed scanlines -> [H, stride] bytes."""
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(raw[y, 0])
        line = raw[y, 1:].astype(np.int32)
        if ftype == 0:
            rec = line
        elif ftype == 1:     # Sub: running sum per byte position of a pixel
            rec = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:     # Up
            rec = (line + prior) & 0xFF
        elif ftype in (3, 4):   # Average, Paeth: each pixel needs its left one
            rec = np.zeros(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prior[x:x + bpp]
                pred = (left + up) // 2 if ftype == 3 else _paeth(left, up, up_left)
                left = (line[x:x + bpp] + pred) & 0xFF
                rec[x:x + bpp] = left
                up_left = up
        else:
            raise ValueError(f"PNG: unknown row filter {ftype}")
        out[y] = rec
        prior = rec
    return out


def decode_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes (grey, grey + alpha, RGB, RGBA; 8 or 16 bits;
    non-interlaced) -> [H, W] or [H, W, C] uint8/uint16, RGB(A) order."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = hdr
    if colour not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(
            f"PNG: colour type {colour}, bit depth {depth}, interlace {interlace} "
            "not supported (grey/RGB(A) at 8 or 16 bits, non-interlaced)")
    ch = _CHANNELS[colour]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw, h, w * bpp, bpp)
    dtype = np.uint8 if depth == 8 else np.dtype(">u2")
    img = px.reshape(-1).view(dtype).astype(np.uint8 if depth == 8 else np.uint16)
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
