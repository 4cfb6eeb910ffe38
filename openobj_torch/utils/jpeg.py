"""Baseline JPEG decoding for ScanNet's colour frames (``color/<i>.jpg``).

The JAX package reads these frames with ``cv2.imread``; the card's machine
has neither OpenCV nor PIL, so the port decodes them itself. ``read_jpeg``
returns, byte for byte, what ``cv2.imread(path)[..., ::-1]`` returns with
OpenCV's bundled libjpeg-turbo at its defaults:

  * the marker parser reads SOI, APPn and COM (skipped, except JFIF, Adobe
    APP14 and EXIF orientation), DQT (8- and 16-bit tables), DHT, SOF0/SOF1
    with 8-bit samples, DRI, one or more SOS and EOI;
  * the entropy decode runs natively (``native/jpeg.cc``, through ctypes,
    which drops the GIL: the loader decodes on its prefetch thread while
    the trainer runs); ``entropy_decode_plain`` is the same decode as a
    Python loop, kept for the tests;
  * dequantisation and libjpeg's integer IDCT (``jidctint.c``'s ISLOW:
    CONST_BITS 13, PASS1_BITS 2, the post-IDCT range-limit table indexed
    with ``& RANGE_MASK``), in numpy over every block at once;
  * fancy upsampling as ``jdsample.c`` does it (``h2v1``, ``h2v2``,
    ``h1v2``; replication for a component at most 2 samples wide and for
    other integral factors), the rows above the first and below the last
    being that row repeated (``jdmainct.c``'s context pointers);
  * YCbCr -> RGB with ``jdcolor.c``'s fixed-point tables (SCALEBITS 16), and
    ``jdapimin.c``'s guess of the colour space (JFIF, then Adobe's
    transform, then the component ids). Grey is replicated to 3 channels
    as OpenCV's colour read does.

Progressive, lossless, arithmetic-coded and 12-bit files, 4-component
(CMYK/YCCK) files and an EXIF orientation other than 1 raise
``NotImplementedError`` (ROADMAP A14c). Corrupt or truncated data raises
``JpegError``: nothing is padded with zeros, unlike libjpeg.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

ROADMAP_ITEM = "A14c"

# jpeg_natural_order: zigzag index -> natural (row-major) index in a block
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

_SOF_NAMES = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
              0xC6: "differential progressive", 0xC7: "differential lossless",
              0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
              0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded differential",
              0xCE: "arithmetic-coded differential progressive",
              0xCF: "arithmetic-coded differential lossless"}


class JpegError(ValueError):
    """Corrupt or truncated JPEG data."""


def _refuse(what: str):
    raise NotImplementedError(
        f"{what}: the port decodes baseline 8-bit grey or 3-component JPEG with "
        f"orientation 1 only (ROADMAP {ROADMAP_ITEM})")


@dataclass
class Component:
    cid: int
    h: int
    v: int
    tq: int
    width: int = 0       # samples across (ceil(W * h / hmax))
    height: int = 0
    bw: int = 0          # block buffer, padded to whole MCUs of an interleaved scan
    bh: int = 0
    qt: np.ndarray | None = None    # [64] natural order, latched at its first scan


@dataclass
class Scan:
    comps: list[int]                # indices into Frame.components
    tables: list[tuple[int, int]]   # (DC slot, AC slot) per component
    huff: dict                      # (class, slot) -> (bits [16], vals [256]) as latched
    start: int                      # offset of the entropy-coded data
    end: int                        # offset of the marker that ends it
    restart: int


@dataclass
class Frame:
    width: int
    height: int
    components: list[Component]
    scans: list[Scan] = field(default_factory=list)
    jfif: bool = False
    adobe_transform: int | None = None

    @property
    def hmax(self) -> int:
        return max(c.h for c in self.components)

    @property
    def vmax(self) -> int:
        return max(c.v for c in self.components)


def _marker_positions(buf: np.ndarray) -> np.ndarray:
    """Offsets of every 0xFF that starts a marker other than RSTn (the
    first of a run of fill bytes), ascending."""
    ff = np.flatnonzero(buf[:-1] == 0xFF)
    nxt = buf[ff + 1]
    real = (nxt != 0x00) & (nxt != 0xFF) & ~((nxt >= 0xD0) & (nxt <= 0xD7))
    pos = ff[real]
    # back up over fill bytes
    out = pos.copy()
    for i, p in enumerate(pos):
        while p > 0 and buf[p - 1] == 0xFF:
            p -= 1
        out[i] = p
    return out


def _orientation(payload: bytes) -> int:
    """EXIF orientation from an APP1 payload, 1 when absent or unreadable."""
    if not payload.startswith(b"Exif\x00\x00") or len(payload) < 14:
        return 1
    tiff = payload[6:]
    end = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if end is None:
        return 1
    try:
        (ifd,) = struct.unpack(end + "I", tiff[4:8])
        (n,) = struct.unpack(end + "H", tiff[ifd:ifd + 2])
        for i in range(n):
            e = tiff[ifd + 2 + 12 * i: ifd + 14 + 12 * i]
            tag, typ = struct.unpack(end + "HH", e[:4])
            if tag == 0x0112 and typ == 3:
                return struct.unpack(end + "H", e[8:10])[0]
    except struct.error:
        return 1
    return 1


def parse(data: bytes) -> Frame:
    """Walk the markers of a baseline JPEG: the frame, its tables and the
    byte range of each scan's entropy-coded data."""
    buf = np.frombuffer(data, np.uint8)
    if len(data) < 4 or data[:2] != b"\xff\xd8":
        raise JpegError("not a JPEG file (no SOI marker)")
    markers = _marker_positions(buf)
    qts: dict[int, np.ndarray] = {}
    huff: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}
    frame: Frame | None = None
    restart = 0
    jfif, adobe = False, None
    pos = 2
    while True:
        at = pos
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data) or pos == at:
            raise JpegError(f"truncated or corrupt: no marker at offset {at}")
        m = data[pos]
        pos += 1
        if m == 0xD9:                                   # EOI
            break
        if m in (0x01,) or 0xD0 <= m <= 0xD7:
            continue
        if pos + 2 > len(data):
            raise JpegError("truncated marker segment")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + length]
        if length < 2 or len(seg) != length - 2:
            raise JpegError(f"truncated marker segment 0xFF{m:02X}")
        pos += length
        if m in _SOF_NAMES or m == 0xCC:
            _refuse(f"{_SOF_NAMES.get(m, 'arithmetic-coded')} JPEG (SOF 0xFF{m:02X})")
        if m in (0xC0, 0xC1):
            if frame is not None or len(seg) < 6:
                raise JpegError("corrupt or second frame header")
            p, hgt, wid, nc = struct.unpack(">BHHB", seg[:6])
            if p != 8:
                _refuse(f"{p}-bit samples")
            if hgt == 0:
                _refuse("a frame height given by a DNL marker")
            if nc not in (1, 3):
                _refuse(f"{nc}-component JPEG")
            if wid == 0 or len(seg) < 6 + 3 * nc:
                raise JpegError("corrupt frame header")
            comps = []
            for i in range(nc):
                cid, hv, tq = seg[6 + 3 * i: 9 + 3 * i]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                    raise JpegError("corrupt sampling factors or table slot")
                comps.append(Component(cid, h, v, tq))
            frame = Frame(wid, hgt, comps)
            hmax, vmax = frame.hmax, frame.vmax
            mx, my = -(-wid // (8 * hmax)), -(-hgt // (8 * vmax))
            for c in comps:
                if hmax % c.h or vmax % c.v:
                    _refuse("non-integral sampling ratios")
                c.width, c.height = -(-wid * c.h // hmax), -(-hgt * c.v // vmax)
                c.bw, c.bh = mx * c.h, my * c.v
        elif m == 0xC4:                                 # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = np.frombuffer(seg[i + 1:i + 17], np.uint8)
                n = int(bits.sum()) if len(bits) == 16 else -1
                if tc > 1 or th > 3 or n < 0 or n > 256 or i + 17 + n > len(seg):
                    raise JpegError("corrupt Huffman table")
                vals = np.zeros(256, np.uint8)
                vals[:n] = np.frombuffer(seg[i + 17:i + 17 + n], np.uint8)
                huff[(tc, th)] = (bits.copy(), vals)
                i += 17 + n
        elif m == 0xDB:                                 # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 64 * (1 + pq)
                if pq > 1 or tq > 3 or i + 1 + size > len(seg):
                    raise JpegError("corrupt quantisation table")
                zz = np.frombuffer(seg[i + 1:i + 1 + size], ">u2" if pq else np.uint8)
                q = np.zeros(64, np.int64)
                q[NATURAL] = zz
                qts[tq] = q
                i += 1 + size
        elif m == 0xDD:                                 # DRI
            if len(seg) < 2:
                raise JpegError("corrupt restart interval")
            (restart,) = struct.unpack(">H", seg[:2])
        elif m == 0xDA:                                 # SOS
            if frame is None:
                raise JpegError("scan before the frame header")
            ns = seg[0] if seg else 0
            if not 1 <= ns <= 4 or len(seg) < 4 + 2 * ns:
                raise JpegError("corrupt scan header")
            ids = [c.cid for c in frame.components]
            comps, tables = [], []
            for i in range(ns):
                cs, tt = seg[1 + 2 * i], seg[2 + 2 * i]
                if cs not in ids:
                    raise JpegError(f"scan names component {cs}, not in the frame")
                comps.append(ids.index(cs))
                tables.append((tt >> 4, tt & 15))
            ss, se, ahl = seg[1 + 2 * ns: 4 + 2 * ns]
            if (ss, se, ahl) != (0, 63, 0):
                raise JpegError(f"sequential scan with Ss={ss} Se={se} Ah/Al={ahl}")
            used = {}
            for (td, ta) in tables:
                for key in ((0, td), (1, ta)):
                    if key not in huff:
                        raise JpegError(f"scan uses Huffman table {key}, never defined")
                    used[key] = huff[key]
            for ci in comps:
                c = frame.components[ci]
                if c.qt is None:
                    if c.tq not in qts:
                        raise JpegError(f"component {c.cid} uses quantisation table "
                                        f"{c.tq}, never defined")
                    c.qt = qts[c.tq].copy()
            k = np.searchsorted(markers, pos)
            if k >= len(markers):
                raise JpegError("truncated: the entropy-coded data has no end marker")
            end = int(markers[k])
            frame.scans.append(Scan(comps, tables, used, pos, end, restart))
            pos = end
        elif m == 0xE0 and seg.startswith(b"JFIF\x00") and len(seg) >= 14:
            jfif = True
        elif m == 0xE1:
            o = _orientation(seg)
            if o not in (0, 1):
                _refuse(f"EXIF orientation {o}")
        elif m == 0xEE and seg.startswith(b"Adobe") and len(seg) >= 12:
            adobe = seg[11]
        # other APPn, COM and unknown segments are skipped
    if frame is None or not frame.scans:
        raise JpegError("no frame or no scan before EOI")
    frame.jfif, frame.adobe_transform = jfif, adobe
    for c in frame.components:
        if c.qt is None:
            raise JpegError(f"component {c.cid} appears in no scan")
    return frame


# --------------------------------------------------------------------------- #
# entropy decoding
# --------------------------------------------------------------------------- #


def _scan_layout(frame: Frame, scan: Scan):
    """(MCUs across, MCUs down, [(blocks across, blocks down) per MCU]) of a
    scan: whole MCUs of every component's h x v blocks when interleaved,
    one block of the component's own grid otherwise (T.81 A.2)."""
    if len(scan.comps) == 1:
        c = frame.components[scan.comps[0]]
        return -(-c.width // 8), -(-c.height // 8), [(1, 1)]
    mx = -(-frame.width // (8 * frame.hmax))
    my = -(-frame.height // (8 * frame.vmax))
    return mx, my, [(frame.components[i].h, frame.components[i].v) for i in scan.comps]


def _empty_coefs(frame: Frame) -> list[np.ndarray]:
    return [np.zeros((c.bh, c.bw, 64), np.int16) for c in frame.components]


_ERRORS = {-1: "truncated: bits needed past a marker or the end of the data",
           -2: "corrupt Huffman code", -3: "an AC run past coefficient 63",
           -4: "restart marker missing or out of order",
           -5: "corrupt Huffman table", -6: "bad scan arguments",
           -7: "extraneous bytes after the last MCU"}


def entropy_decode(frame: Frame, data: bytes) -> list[np.ndarray]:
    """Every scan's coefficients, by the native decoder: per component an
    int16 [bh, bw, 64] array of blocks in natural order, not dequantised.
    Raises when ``native/jpeg.cc`` cannot be built (no fallback)."""
    from openobj_torch import native

    buf = np.frombuffer(data, np.uint8)
    coefs = _empty_coefs(frame)
    for scan in frame.scans:
        mx, my, per_mcu = _scan_layout(frame, scan)
        params, bits, vals = _scan_tables(frame, scan, per_mcu)
        r, end = native.jpeg_decode_scan(buf, scan.start, params, bits, vals, mx, my,
                                         scan.restart, [coefs[i] for i in scan.comps])
        if r != 0:
            raise JpegError(_ERRORS.get(r, f"entropy decode error {r}"))
        if end != scan.end:
            raise JpegError(f"scan ended at offset {end}, its marker is at {scan.end}")
    return coefs


def _scan_tables(frame: Frame, scan: Scan, per_mcu):
    """The native decoder's arguments: [ncomp, 5] int32 {mcu_h, mcu_v,
    blocks_w, dc slot, ac slot}; [8, 16] BITS and [8, 256] HUFFVAL, DC
    tables in rows 0-3 and AC tables in rows 4-7."""
    bits = np.zeros((8, 16), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    for (tc, th), (b, v) in scan.huff.items():
        bits[4 * tc + th], vals[4 * tc + th] = b, v
    params = np.array([[mh, mv, frame.components[ci].bw, td, ta]
                       for ci, (mh, mv), (td, ta) in zip(scan.comps, per_mcu, scan.tables)],
                      np.int32)
    return params, bits, vals


class _PlainBits:
    """T.81's bit reader over entropy-coded data, one bit at a time."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos, self.byte, self.left = data, pos, 0, 0

    def bit(self) -> int:
        if self.left == 0:
            d = self.data
            if self.pos >= len(d) or (d[self.pos] == 0xFF and (
                    self.pos + 1 >= len(d) or d[self.pos + 1] != 0x00)):
                raise JpegError(_ERRORS[-1])
            self.byte = d[self.pos]
            self.pos += 2 if self.byte == 0xFF else 1
            self.left = 8
        self.left -= 1
        return (self.byte >> self.left) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v


def _plain_table(bits: np.ndarray, vals: np.ndarray) -> dict:
    """{(length, code): symbol} of a canonical Huffman table (T.81 C.2)."""
    table, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(int(bits[length - 1])):
            table[(length, code)] = int(vals[k])
            code += 1
            k += 1
        if bits[length - 1] and code >= (1 << length):
            raise JpegError(_ERRORS[-5])
        code <<= 1
    return table


def _plain_symbol(br: _PlainBits, table: dict) -> int:
    code = 0
    for length in range(1, 17):
        code = (code << 1) | br.bit()
        sym = table.get((length, code))
        if sym is not None:
            return sym
    raise JpegError(_ERRORS[-2])


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def entropy_decode_plain(frame: Frame, data: bytes) -> list[np.ndarray]:
    """The same decode as ``entropy_decode``, as a Python loop over bits
    (T.81 F.2.2): the plain version the tests hold the native one to."""
    coefs = _empty_coefs(frame)
    for scan in frame.scans:
        mx, my, per_mcu = _scan_layout(frame, scan)
        tabs = {k: _plain_table(*bv) for k, bv in scan.huff.items()}
        br = _PlainBits(data, scan.start)
        pred = [0] * len(scan.comps)
        rst = 0
        for m in range(mx * my):
            if scan.restart and m and m % scan.restart == 0:
                br.left = 0
                p = br.pos
                while p < len(data) and data[p] == 0xFF:
                    p += 1
                if p == br.pos or p >= len(data) or data[p] != 0xD0 + rst:
                    raise JpegError(_ERRORS[-4])
                rst = (rst + 1) & 7
                br.pos = p + 1
                pred = [0] * len(scan.comps)
            y, x = divmod(m, mx)
            for j, (ci, (mh, mv), (td, ta)) in enumerate(zip(scan.comps, per_mcu, scan.tables)):
                for v in range(mv):
                    for h in range(mh):
                        blk = coefs[ci][y * mv + v, x * mh + h]
                        s = _plain_symbol(br, tabs[(0, td)])
                        pred[j] += _extend(br.bits(s), s) if s else 0
                        blk[0] = ((pred[j] + 0x8000) & 0xFFFF) - 0x8000   # C's (int16) cast
                        k = 1
                        while k < 64:
                            rs = _plain_symbol(br, tabs[(1, ta)])
                            r, s = rs >> 4, rs & 15
                            if s:
                                k += r
                                if k > 63:
                                    raise JpegError(_ERRORS[-3])
                                blk[NATURAL[k]] = _extend(br.bits(s), s)
                            elif r != 15:
                                break
                            else:
                                k += 15
                            k += 1
        br.left = 0
        if br.pos != scan.end:
            raise JpegError(_ERRORS[-7])
    return coefs


# --------------------------------------------------------------------------- #
# dequantisation, IDCT, upsampling, colour
# --------------------------------------------------------------------------- #

CONST_BITS, PASS1_BITS = 13, 2
(FIX_0_298631336, FIX_0_390180644, FIX_0_541196100, FIX_0_765366865, FIX_0_899976223,
 FIX_1_175875602, FIX_1_501321110, FIX_1_847759065, FIX_1_961570560, FIX_2_053119869,
 FIX_2_562915447, FIX_3_072711026) = (2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137,
                                      16069, 16819, 20995, 25172)


def _idct_range_limit() -> np.ndarray:
    """``jdmaster.c``'s post-IDCT table read at ``x & RANGE_MASK`` (1023):
    x + 128 clamped to [0, 255] for x in [-512, 511], the wrap beyond it."""
    x = np.arange(1024)
    x = np.where(x >= 512, x - 1024, x)
    return np.clip(x + 128, 0, 255).astype(np.uint8)


_RANGE_LIMIT = _idct_range_limit()


def _islow_1d(i0, i1, i2, i3, i4, i5, i6, i7):
    """One 8-point pass of ``jpeg_idct_islow`` before its descale: the
    outputs 0..7 scaled by 2**CONST_BITS (JLONG arithmetic)."""
    z1 = (i2 + i6) * FIX_0_541196100
    tmp2 = z1 - i6 * FIX_1_847759065
    tmp3 = z1 + i2 * FIX_0_765366865
    tmp0 = (i0 + i4) << CONST_BITS
    tmp1 = (i0 - i4) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = i7, i5, i3, i1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _islow_matrix() -> np.ndarray:
    """[8 in, 8 out] int64: one pass of ``_islow_1d`` as a matrix. A pass
    is linear with integer constants and rounds only at its descale."""
    eye = np.eye(8, dtype=np.int64)
    return np.stack(_islow_1d(*eye), axis=1)


_ISLOW = _islow_matrix().astype(np.float64)


def idct_islow(coefs: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """Dequantise and inverse-DCT blocks [..., 64] (natural order) into
    uint8 samples [..., 8, 8], as libjpeg's ``jpeg_idct_islow``: columns
    first into a work array descaled by CONST_BITS - PASS1_BITS, then rows,
    descaled by CONST_BITS + PASS1_BITS + 3 and read through the range-limit
    table (the all-zero-AC short cuts of the C code give the same values).
    Each pass is one product with ``_islow_1d``'s matrix in float64, exact
    because every term is an integer below 2**53 (|coefficient x quantiser|
    < 2**27, matrix entries < 2**18)."""
    lead = coefs.shape[:-1]
    # [block, column, row in]: pass 1 contracts the rows of each column
    x = coefs.reshape(-1, 8, 8).astype(np.int64) * qt.reshape(8, 8)
    x = x.transpose(0, 2, 1).astype(np.float64)
    d1 = CONST_BITS - PASS1_BITS
    ws = (x.reshape(-1, 8) @ _ISLOW).astype(np.int64)          # [block * column, row]
    ws = (ws + (1 << (d1 - 1))) >> d1
    # [block, row, column]: pass 2 contracts the columns of each row
    ws = ws.reshape(-1, 8, 8).transpose(0, 2, 1).astype(np.float64)
    d2 = CONST_BITS + PASS1_BITS + 3
    out = (ws.reshape(-1, 8) @ _ISLOW).astype(np.int64)
    out = (out + (1 << (d2 - 1))) >> d2
    return _RANGE_LIMIT[out & 1023].reshape(*lead, 8, 8)


def component_samples(comp: Component, coefs: np.ndarray) -> np.ndarray:
    """A component's uint8 plane [height, width] from its blocks."""
    px = idct_islow(coefs, comp.qt)                            # [bh, bw, 8, 8]
    plane = px.transpose(0, 2, 1, 3).reshape(comp.bh * 8, comp.bw * 8)
    return plane[:comp.height, :comp.width]


def _vertical_sums(x: np.ndarray) -> np.ndarray:
    """3 x[i] + x[i-1] for output row 2i, 3 x[i] + x[i+1] for 2i+1, the
    rows above the first and below the last being that row repeated."""
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
    out[0::2] = 3 * x + up
    out[1::2] = 3 * x + down
    return out


def upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A component's plane brought up by (fh, fv) as libjpeg-turbo's
    ``jinit_upsampler`` chooses: fancy ``h2v1``/``h2v2`` when the plane is
    more than 2 samples wide, fancy ``h1v2``, else replication."""
    x = plane.astype(np.int32)
    w = plane.shape[1]
    if (fh, fv) == (1, 1):
        out = x
    elif (fh, fv) == (2, 1) and w > 2:
        left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
        out = np.empty((x.shape[0], 2 * w), np.int32)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
    elif (fh, fv) == (2, 2) and w > 2:
        s = _vertical_sums(x)
        left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
        out = np.empty((s.shape[0], 2 * w), np.int32)
        out[:, 0::2] = (3 * s + left + 8) >> 4
        out[:, 1::2] = (3 * s + right + 7) >> 4
    elif (fh, fv) == (1, 2):
        s = _vertical_sums(x)
        out = np.empty_like(s)
        out[0::2] = (s[0::2] + 1) >> 2
        out[1::2] = (s[1::2] + 2) >> 2
    else:
        out = np.repeat(np.repeat(x, fv, axis=0), fh, axis=1)
    return out.astype(np.uint8)


def _ycc_tables():
    """``jdcolor.c``'s build_ycc_rgb_table (SCALEBITS 16, the rounding
    folded into the Cb->G table) as int32 lookups offset by 512 into
    ``_LIMIT``: Cr->R and Cb->B by sample, the G term by (cb << 8) | cr."""
    one_half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    g = (-fix(0.34414) * x[:, None] + one_half - fix(0.71414) * x[None, :]) >> 16
    return [(t + 512).astype(np.int32).reshape(-1) for t in (cr_r, cb_b, g)]


_CR_R, _CB_B, _G = _ycc_tables()
_LIMIT = np.clip(np.arange(-512, 768), 0, 255).astype(np.uint8)   # range_limit, offset 512


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] RGB from full-size Y, Cb, Cr planes (``ycc_rgb_convert``)."""
    y = y.astype(np.int32)
    cr = cr.astype(np.int32)
    out = np.empty((*y.shape, 3), np.uint8)
    out[..., 0] = np.take(_LIMIT, y + np.take(_CR_R, cr))
    out[..., 1] = np.take(_LIMIT, y + np.take(_G, (cb.astype(np.int32) << 8) | cr))
    out[..., 2] = np.take(_LIMIT, y + np.take(_CB_B, cb))
    return out


def reconstruct(frame: Frame, coefs: list[np.ndarray]) -> np.ndarray:
    """uint8 [H, W, 3] RGB from the coefficients: IDCT, upsampling, colour."""
    hmax, vmax = frame.hmax, frame.vmax
    planes = []
    for c, k in zip(frame.components, coefs):
        full = upsample(component_samples(c, k), hmax // c.h, vmax // c.v)
        planes.append(full[:frame.height, :frame.width])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    ids = tuple(c.cid for c in frame.components)
    if frame.jfif:
        rgb = False
    elif frame.adobe_transform is not None:
        rgb = frame.adobe_transform == 0
    else:
        rgb = ids == (82, 71, 66)
    if rgb:
        return np.ascontiguousarray(np.stack(planes, axis=-1))
    return ycc_to_rgb(*planes)


def decode_jpeg(data: bytes) -> np.ndarray:
    """uint8 [H, W, 3] RGB of a baseline JPEG held in memory."""
    frame = parse(data)
    return reconstruct(frame, entropy_decode(frame, data))


def read_jpeg(path: str) -> np.ndarray:
    """uint8 [H, W, 3] RGB of a baseline JPEG file: what
    ``cv2.imread(path)[..., ::-1]`` gives."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read())
