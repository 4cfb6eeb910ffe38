"""A PNG writer and reader on the standard library (``zlib``, ``struct``).

The run's outputs are PNG files: ``train.render_dataset`` writes 8-bit RGB
colour renders and 16-bit grey depth / class-id / instance-id images, and
``eval.evaluate_run`` reads them back beside the ground truth. The JAX
package writes and reads them with OpenCV, which the port does without; the
files are the same format (PNG, non-interlaced, RGB in file order, 16-bit
samples big-endian), so either package's files load in the other.

``write_png`` writes 8-bit RGB ([H, W, 3] uint8) or 16-bit grey ([H, W]
uint16), every row with filter type 0. ``read_png`` reads every PNG that
OpenCV's libpng reads: grey at 1, 2, 4, 8 or 16 bits, grey + alpha, RGB and
RGBA at 8 or 16 bits, palette at 1, 2, 4 or 8 bits, with or without Adam7
interlacing, any of the five row filters and a ``tRNS`` chunk. It returns
what ``cv2.imread(path, flags)`` returns, with channels in RGB(A) order
instead of BGR(A), for the two reads the JAX package makes:

  * ``colour=False``, ``cv2.IMREAD_UNCHANGED`` (-1): grey as [H, W] (low-bit
    grey scaled to 8 bits, a ``tRNS`` grey level ignored), grey + alpha as
    [H, W, 4] (grey repeated), RGB as [H, W, 3] or, with a ``tRNS`` colour
    key, [H, W, 4] (alpha 0 on the key, full elsewhere), RGBA as [H, W, 4],
    palette as [H, W, 3] uint8 or, with ``tRNS``, [H, W, 4]; 16-bit files
    stay uint16;
  * ``colour=True``, ``cv2.IMREAD_COLOR``: [H, W, 3] uint8, grey repeated,
    alpha and ``tRNS`` dropped, 16-bit samples reduced to their high byte.

As libpng, it refuses a file whose critical chunks (IHDR, PLTE, IDAT,
IEND) fail their CRC and ignores an ancillary one that does, or a ``tRNS``
chunk that does not fit the image; a palette index past the palette reads
as black.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


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


_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples per pixel
# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_CRITICAL = (b"IHDR", b"PLTE", b"IDAT", b"IEND")


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """[h, stride] unfiltered bytes -> [h, w, ch] samples (uint8, or uint16
    at 16 bits), sub-byte samples unpacked most significant bits first."""
    h = rows.shape[0]
    n = w * ch
    if depth == 16:
        return rows.view(">u2")[:, :n].astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return rows[:, :n].reshape(h, w, ch)
    bits = np.unpackbits(rows, axis=1)[:, :n * depth].reshape(h, n, depth)
    return (bits @ (1 << np.arange(depth - 1, -1, -1))).astype(np.uint8).reshape(h, w, ch)


def _pixels(raw: np.ndarray, w: int, h: int, ch: int, depth: int, interlace: int) -> np.ndarray:
    """[H, W, ch] samples of the decompressed image data: one filtered
    image, or Adam7's seven filtered sub-images (a pass with no column or
    no row has no data at all)."""
    bpp = max(1, ch * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    out = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    off = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = -(-pw * ch * depth // 8)
        n = ph * (stride + 1)
        if off + n > len(raw):
            raise ValueError("PNG: not enough image data")
        out[y0::dy, x0::dx] = _samples(_unfilter(raw[off:off + n], ph, stride, bpp), pw, ch,
                                       depth)
        off += n
    return out


def _chunks(data: bytes):
    """(kind, body) of each chunk up to IEND; a critical chunk that fails
    its CRC raises, an ancillary one is left out (libpng's defaults), and
    so does a file cut before IEND, as OpenCV refuses it."""
    pos = 8
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        pos += 12 + n
        if len(body) < n or len(crc) < 4:
            raise ValueError(f"PNG: chunk {kind!r} truncated")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            if kind in _CRITICAL:
                raise ValueError(f"PNG: chunk {kind!r} fails its CRC")
            continue
        yield kind, body
        if kind == b"IEND":
            return
    raise ValueError("PNG: the file ends before its IEND chunk")


def decode_png(data: bytes, colour: bool = False) -> np.ndarray:
    """Decode PNG bytes as ``cv2.imdecode`` does with ``IMREAD_COLOR``
    (``colour``) or ``IMREAD_UNCHANGED``, channels in RGB(A) order: see the
    module's docstring."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    idat, hdr, plte, trns = [], None, None, None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("PNG: corrupt IHDR")
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS" and trns is None:
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if hdr is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth not in _DEPTHS.get(ctype, ()) or interlace > 1 or not w or not h:
        raise ValueError(f"PNG: colour type {ctype}, bit depth {depth}, interlace {interlace}, "
                         f"size {w}x{h} is not a valid image")
    if ctype == 3 and (plte is None or not plte or len(plte) % 3 or len(plte) > 768):
        raise ValueError("PNG: a palette image without a valid PLTE chunk")
    ch = _CHANNELS[ctype]
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"PNG: corrupt image data ({e})") from None
    px = _pixels(raw, w, h, ch, depth, interlace)
    alpha = None
    if ctype == 3:
        table = np.zeros((256, 3), np.uint8)        # past the palette: black
        table[:len(plte) // 3] = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        idx = px[..., 0]
        px = table[idx]
        if trns is not None and 0 < len(trns) <= len(plte) // 3 and not colour:
            a = np.full(256, 255, np.uint8)
            a[:len(trns)] = np.frombuffer(trns, np.uint8)
            alpha = a[idx]
    elif ctype == 0 and depth < 8:
        px = (px * (255 // ((1 << depth) - 1))).astype(np.uint8)   # libpng's 1/2/4 -> 8 bits
    elif ctype == 2 and trns is not None and len(trns) == 6 and not colour:
        key = np.array(struct.unpack(">HHH", trns), np.int64)
        alpha = np.where((px.astype(np.int64) == key).all(-1), 0,
                         (1 << depth) - 1).astype(px.dtype)
    if colour:
        if px.dtype == np.uint16:
            px = (px >> 8).astype(np.uint8)
        if ctype in (0, 4):
            return np.repeat(px[..., :1], 3, axis=2)
        return np.ascontiguousarray(px[..., :3])
    if ctype == 0:
        return px[..., 0]
    if ctype == 4:
        return np.concatenate([np.repeat(px[..., :1], 3, axis=2), px[..., 1:]], axis=2)
    if alpha is not None:
        return np.concatenate([px, alpha[..., None]], axis=2)
    return px


def read_png(path: str, colour: bool = False) -> np.ndarray:
    """The image of a PNG file as ``cv2.imread(path, cv2.IMREAD_COLOR if
    colour else -1)`` returns it, channels in RGB(A) order."""
    with open(path, "rb") as f:
        return decode_png(f.read(), colour)
