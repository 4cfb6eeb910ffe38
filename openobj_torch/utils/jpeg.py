"""JPEG decoding for ScanNet's colour frames (``color/<i>.jpg``).

The JAX package reads these frames with ``cv2.imread``; the card's machine
has neither OpenCV nor PIL, so the port decodes them itself. ``read_jpeg``
returns, byte for byte, what ``cv2.imread(path)[..., ::-1]`` returns with
OpenCV's bundled libjpeg-turbo at its defaults:

  * the marker parser reads SOI, APPn and COM (skipped, except JFIF, Adobe
    APP14 and the EXIF APP1 segments), DQT (8- and 16-bit tables),
    DHT, SOF0/SOF1 (sequential) and SOF2 (progressive) with 8-bit samples,
    DRI, one or more SOS and EOI;
  * the entropy decode runs natively (``native/jpeg.cc``, through ctypes,
    which drops the GIL: the loader decodes on its prefetch thread while
    the trainer runs): sequential scans, and progressive ones as
    libjpeg-turbo's ``jdphuff.c`` decodes them (DC and AC first and
    refinement scans, spectral selection, successive approximation, EOB
    runs), each adding into the same coefficient blocks;
    ``entropy_decode_plain`` is the same decode as a Python loop, kept for
    the tests;
  * dequantisation and libjpeg's integer IDCT (``jidctint.c``'s ISLOW:
    CONST_BITS 13, PASS1_BITS 2, the post-IDCT range-limit table indexed
    with ``& RANGE_MASK``), in numpy over every block at once;
  * fancy upsampling as ``jdsample.c`` does it (``h2v1``, ``h2v2``,
    ``h1v2``; replication for a component at most 2 samples wide and for
    other integral factors), the rows above the first and below the last
    being that row repeated (``jdmainct.c``'s context rows);
  * YCbCr -> RGB with ``jdcolor.c``'s fixed-point tables (SCALEBITS 16), and
    ``jdapimin.c``'s guess of the colour space (JFIF, then Adobe's
    transform, then the component ids). Grey is replicated to 3 channels
    as OpenCV's colour read does. A 4-component file is CMYK (Adobe
    transform 0, or no Adobe marker) or YCCK (any other transform), which
    libjpeg brings to CMYK (``ycck_cmyk_convert``) and OpenCV to BGR with
    its integer formula (``icvCvt_CMYK2BGR_8u_C4C3R``);
  * the EXIF orientation of the APP1 segments ahead of the first scan, as
    OpenCV's ``ExifReader`` reads it (a malformed segment is ignored),
    applied as its ``ExifTransform``: flips, transposes and rotations for
    2-8.

A progressive file whose scans leave some of the first 9 AC coefficients
short of bits is refused: libjpeg smooths such blocks
(``jdcoefct.c``'s ``decompress_smooth_data``), which the port does not. So
are lossless, arithmetic-coded and 12-bit files and a height given by a
DNL marker: each raises ``NotImplementedError`` naming ROADMAP A14d.
Corrupt or truncated data raises ``JpegError``: nothing is padded with
zeros, unlike libjpeg.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

ROADMAP_ITEM = "A14d"

# jpeg_natural_order: zigzag index -> natural (row-major) index in a block
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

_SOF_NAMES = {0xC3: "lossless", 0xC5: "differential sequential",
              0xC6: "differential progressive", 0xC7: "differential lossless",
              0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
              0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded differential",
              0xCE: "arithmetic-coded differential progressive",
              0xCF: "arithmetic-coded differential lossless"}


class JpegError(ValueError):
    """Corrupt or truncated JPEG data."""


def _refuse(what: str):
    raise NotImplementedError(
        f"{what}: the port decodes sequential and progressive Huffman-coded 8-bit "
        f"JPEG of 1, 3 or 4 components only (ROADMAP {ROADMAP_ITEM})")


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
    spectral: tuple[int, int, int, int] = (0, 63, 0, 0)   # Ss, Se, Ah, Al


@dataclass
class Frame:
    width: int
    height: int
    components: list[Component]
    scans: list[Scan] = field(default_factory=list)
    jfif: bool = False
    adobe_transform: int | None = None
    progressive: bool = False
    smoothed: bool = False          # libjpeg would smooth its blocks (progressive)
    orientation: int = 1            # EXIF, as OpenCV reads it (1 when absent)

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


class _ExifEnd(Exception):
    """A read past the end of the EXIF data (OpenCV's ExifParsingError)."""


# IFD0 tags that OpenCV's ExifReader::parseExifEntry reads, by what it reads
_EXIF_STRINGS = {0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298}
_EXIF_RATIONALS = {0x011A: 1, 0x011B: 1, 0x013E: 2, 0x013F: 6, 0x0211: 3, 0x0214: 6}
_EXIF_U16 = {0x0112, 0x0128, 0x0213}
_EXIF_OFFSET, _ORIENTATION = 0x8769, 0x0112


def _orientation(payload: bytes) -> int | None:
    """The EXIF orientation of an APP1 payload as OpenCV's ``ExifReader``
    reads it, None when absent: only a payload that starts with
    ``Exif\\0\\0``, the TIFF header after it, little-endian only for
    ``II``; IFD0's entries are read in order until one reads past the end,
    and the entries read before it stand; a tag's first entry wins, and the
    value is read whatever the entry's type."""
    if len(payload) <= 6 or not payload.startswith(b"Exif\x00\x00"):
        return None
    d = payload[6:]
    order = "little" if d[:2] == b"II" else "big"

    def u(o: int, n: int) -> int:
        if o + n - 1 >= len(d):
            raise _ExifEnd
        return int.from_bytes(d[o:o + n], order)

    tags: dict[int, int] = {}
    try:
        if u(2, 2) != 0x2A:
            return None
        off = u(4, 4)
        n = u(off, 2)
        off = (off + 2) & 0xFFFFFFFF
        for _ in range(n):
            tag, value = u(off, 2), None
            if tag in _EXIF_U16:
                value = u(off + 8, 2)
            elif tag in _EXIF_STRINGS:
                size = u(off + 4, 4)
                start = u(off + 8, 4) if size > 4 else 8
                if start > len(d) or start + size > len(d):
                    raise _ExifEnd
            elif tag in _EXIF_RATIONALS:
                ro = u(off + 8, 4)
                for _r in range(_EXIF_RATIONALS[tag]):
                    u(ro, 4)
                    u(ro + 4, 4)
                    ro = (ro + 8) & 0xFFFFFFFF
            elif tag != _EXIF_OFFSET:
                tag = 0xFFFF                # INVALID_TAG
            tags.setdefault(tag, value)
            off = (off + 12) & 0xFFFFFFFF
    except _ExifEnd:
        pass
    return tags.get(_ORIENTATION)


def orient(rgb: np.ndarray, orientation: int) -> np.ndarray:
    """The image turned as OpenCV's ``ExifTransform`` turns it: 2 flips
    left-right, 3 turns half way, 4 flips upside down, 5 transposes, 6
    transposes and flips left-right (a quarter turn clockwise), 7
    transposes and turns half way, 8 transposes and flips upside down;
    any other value leaves it as it is."""
    if orientation in (5, 6, 7, 8):
        rgb = rgb.transpose(1, 0, 2)
    flip = {2: (slice(None), slice(None, None, -1)), 3: (slice(None, None, -1),) * 2,
            4: (slice(None, None, -1),), 6: (slice(None), slice(None, None, -1)),
            7: (slice(None, None, -1),) * 2, 8: (slice(None, None, -1),)}.get(orientation, ())
    return np.ascontiguousarray(rgb[flip])


def parse(data: bytes) -> Frame:
    """Walk the markers of a JPEG file: the frame, its tables, each scan's
    parameters and the byte range of its entropy-coded data, and the EXIF
    orientation."""
    buf = np.frombuffer(data, np.uint8)
    if len(data) < 4 or data[:2] != b"\xff\xd8":
        raise JpegError("not a JPEG file (no SOI marker)")
    markers = _marker_positions(buf)
    qts: dict[int, np.ndarray] = {}
    huff: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}
    frame: Frame | None = None
    coef_bits = None                    # jdphuff.c's, per component and zigzag index
    restart = 0
    jfif, adobe, orientation = False, None, None
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
        if m in (0xC0, 0xC1, 0xC2):
            if frame is not None or len(seg) < 6:
                raise JpegError("corrupt or second frame header")
            p, hgt, wid, nc = struct.unpack(">BHHB", seg[:6])
            if p != 8:
                _refuse(f"{p}-bit samples")
            if hgt == 0:
                _refuse("a frame height given by a DNL marker")
            if nc not in (1, 3, 4):
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
            frame = Frame(wid, hgt, comps, progressive=m == 0xC2)
            coef_bits = np.full((nc, 64), -1, np.int64)
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
                if ids.index(cs) in comps:
                    raise JpegError(f"scan names component {cs} twice")
                comps.append(ids.index(cs))
                tables.append((tt >> 4, tt & 15))
            ss, se, ahl = seg[1 + 2 * ns: 4 + 2 * ns]
            ah, al = ahl >> 4, ahl & 15
            if ns > 1 and sum(frame.components[i].h * frame.components[i].v
                              for i in comps) > 10:
                raise JpegError("an interleaved scan of more than 10 blocks an MCU")
            if not frame.progressive:
                if (ss, se, ahl) != (0, 63, 0):
                    raise JpegError(f"sequential scan with Ss={ss} Se={se} Ah/Al={ahl}")
                need = [(0, td) for td, _ in tables] + [(1, ta) for _, ta in tables]
            else:
                # jdphuff.c's start_pass_phuff_decoder (JERR_BAD_PROGRESSION):
                # a DC scan (Ss 0) is Se 0, an AC scan one component of
                # Ss..Se <= 63; a refinement Al = Ah - 1; Al <= 13
                bad = se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1)
                if bad or (ah and al != ah - 1) or al > 13:
                    raise JpegError(f"bad progression: Ss={ss} Se={se} Ah={ah} Al={al}")
                need = ([(0, td) for td, _ in tables] if ah == 0 else []) if ss == 0 \
                    else [(1, ta) for _, ta in tables]
                coef_bits[comps, ss:se + 1] = al
            used = {}
            for key in need:
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
            frame.scans.append(Scan(comps, tables, used, pos, end, restart, (ss, se, ah, al)))
            pos = end
        elif m == 0xE0 and seg.startswith(b"JFIF\x00") and len(seg) >= 14:
            jfif = True
        elif m == 0xE1 and orientation is None and (frame is None or not frame.scans):
            # OpenCV reads every EXIF APP1 ahead of the first scan into one
            # table, where the first orientation found stands
            orientation = _orientation(seg)
        elif m == 0xEE and seg.startswith(b"Adobe") and len(seg) >= 12:
            adobe = seg[11]
        # other APPn, COM and unknown segments are skipped
    if frame is None or not frame.scans:
        raise JpegError("no frame or no scan before EOI")
    frame.jfif, frame.adobe_transform = jfif, adobe
    frame.orientation = 1 if orientation is None else orientation
    for c in frame.components:
        if c.qt is None:
            raise JpegError(f"component {c.cid} appears in no scan")
    frame.smoothed = frame.progressive and _smoothed(frame, coef_bits)
    return frame


# jdcoefct.c's Q00_POS .. Q30_POS: the natural positions of zigzag 0..9
_SMOOTH_POS = NATURAL[:10]


def _smoothed(frame: Frame, coef_bits: np.ndarray) -> bool:
    """Whether libjpeg would smooth the blocks of this progressive file
    (``jdcoefct.c``'s ``smoothing_ok``, read at the first output pass,
    after every scan): every component's DC partly known and its first 10
    quantisers nonzero, and some component's AC coefficient 1..9 missing
    bits (never sent, or not refined down to bit 0)."""
    for c, bits in zip(frame.components, coef_bits):
        if not c.qt[_SMOOTH_POS].all() or bits[0] < 0:
            return False
    return bool((coef_bits[:, 1:10] != 0).any())


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
           -2: "corrupt Huffman code", -3: "an AC run past the scan's last coefficient",
           -4: "restart marker missing or out of order",
           -5: "corrupt Huffman table", -6: "bad scan arguments",
           -7: "extraneous bytes after the last MCU",
           -8: "a DC value out of range"}


def entropy_decode(frame: Frame, data: bytes) -> list[np.ndarray]:
    """Every scan's coefficients, by the native decoder, in file order: per
    component an int16 [bh, bw, 64] array of blocks in natural order, not
    dequantised. Refuses a file libjpeg would smooth (``Frame.smoothed``)
    once its scans are decoded. Raises when ``native/jpeg.cc`` cannot be
    built (no fallback)."""
    from openobj_torch import native

    buf = np.frombuffer(data, np.uint8)
    coefs = _empty_coefs(frame)
    for scan in frame.scans:
        mx, my, per_mcu = _scan_layout(frame, scan)
        params, bits, vals = _scan_tables(frame, scan, per_mcu)
        r, end = native.jpeg_decode_scan(buf, scan.start, params, bits, vals, mx, my,
                                         scan.restart, [coefs[i] for i in scan.comps],
                                         scan.spectral if frame.progressive else None)
        if r != 0:
            raise JpegError(_ERRORS.get(r, f"entropy decode error {r}"))
        if end != scan.end:
            raise JpegError(f"scan ended at offset {end}, its marker is at {scan.end}")
    if frame.smoothed:      # after the scans, so that a cut or corrupt file raises JpegError
        _refuse("a progressive JPEG whose scans leave some of AC coefficients 1-9 short of "
                "bits, whose blocks libjpeg smooths")
    return coefs


def _scan_tables(frame: Frame, scan: Scan, per_mcu):
    """The native decoder's arguments: [ncomp, 5] int32 {mcu_h, mcu_v,
    blocks_w, dc slot, ac slot}; [8, 16] BITS and [8, 256] HUFFVAL, DC
    tables in rows 0-3 and AC tables in rows 4-7. A slot the scan does not
    use (a progressive scan's other class) is given as 0."""
    bits = np.zeros((8, 16), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    for (tc, th), (b, v) in scan.huff.items():
        bits[4 * tc + th], vals[4 * tc + th] = b, v
    params = np.array([[mh, mv, frame.components[ci].bw, td if (0, td) in scan.huff else 0,
                        ta if (1, ta) in scan.huff else 0]
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


def _plain_restart(br: _PlainBits, data: bytes, rst: int) -> int:
    """Past the RSTn marker that must follow a restart interval; the next n."""
    br.left = 0
    p = br.pos
    while p < len(data) and data[p] == 0xFF:
        p += 1
    if p == br.pos or p >= len(data) or data[p] != 0xD0 + rst:
        raise JpegError(_ERRORS[-4])
    br.pos = p + 1
    return (rst + 1) & 7


def _int16(v: int) -> int:
    """C's (int16) cast."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _add_dc(state: list, j: int, diff: int) -> None:
    """state[j] += diff, refused past int32 as the native decoder refuses it."""
    state[j] += diff
    if not -(1 << 31) <= state[j] < (1 << 31):
        raise JpegError(_ERRORS[-8])


def _plain_sequential(br, tabs, blk, state: list, j: int, td: int, ta: int, spectral):
    """One block of a sequential scan (T.81 F.2.2); ``state[j]`` is its
    component's DC predictor."""
    s = _plain_symbol(br, tabs[(0, td)])
    _add_dc(state, j, _extend(br.bits(s), s) if s else 0)
    blk[0] = _int16(state[j])
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


def _plain_progressive(br, tabs, blk, state: list, j: int, td: int, ta: int, spectral):
    """One block of a progressive scan, as jdphuff.c's decode_mcu_DC_first,
    _DC_refine, _AC_first and _AC_refine; ``state`` holds the scan's DC
    predictors and, last, its EOB run."""
    ss, se, ah, al = spectral
    p1, m1 = 1 << al, -(1 << al)
    if ss == 0 and ah == 0:
        s = _plain_symbol(br, tabs[(0, td)])
        if s > 15:
            raise JpegError(_ERRORS[-2])
        _add_dc(state, j, _extend(br.bits(s), s) if s else 0)
        blk[0] = _int16(state[j] << al)
        return
    if ss == 0:
        if br.bit():
            blk[0] = _int16(int(blk[0]) | p1)
        return

    def correct(pos):   # |coefficient| grows by p1 unless that bit is set already
        v = int(blk[pos])
        if br.bit() and (v & p1) == 0:
            blk[pos] = _int16(v + (p1 if v >= 0 else m1))

    k = ss
    if ah == 0:
        if state[-1] > 0:
            state[-1] -= 1
            return
        while k <= se:
            rs = _plain_symbol(br, tabs[(1, ta)])
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                if k > se:
                    raise JpegError(_ERRORS[-3])
                blk[NATURAL[k]] = _int16(_extend(br.bits(s), s) << al)
            elif r == 15:
                k += 15
            else:
                state[-1] = (1 << r) + (br.bits(r) if r else 0) - 1
                break
            k += 1
        return
    if state[-1] == 0:
        while k <= se:
            rs = _plain_symbol(br, tabs[(1, ta)])
            r, s = rs >> 4, rs & 15
            if s:
                s = p1 if br.bit() else m1
            elif r != 15:
                state[-1] = (1 << r) + (br.bits(r) if r else 0)
                break
            while k <= se:
                if blk[NATURAL[k]]:
                    correct(NATURAL[k])
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                if k > se:
                    raise JpegError(_ERRORS[-3])
                blk[NATURAL[k]] = s
            k += 1
    if state[-1] > 0:
        for kk in range(k, se + 1):
            if blk[NATURAL[kk]]:
                correct(NATURAL[kk])
        state[-1] -= 1


def entropy_decode_plain(frame: Frame, data: bytes) -> list[np.ndarray]:
    """The same decode as ``entropy_decode``, as a Python loop over bits
    (T.81 F.2.2 and G.1.2): the plain version the tests hold the native one
    to."""
    coefs = _empty_coefs(frame)
    block = _plain_progressive if frame.progressive else _plain_sequential
    for scan in frame.scans:
        mx, my, per_mcu = _scan_layout(frame, scan)
        tabs = {k: _plain_table(*bv) for k, bv in scan.huff.items()}
        br = _PlainBits(data, scan.start)
        state = [0] * (len(scan.comps) + 1)        # DC predictors, then the EOB run
        rst = 0
        for m in range(mx * my):
            if scan.restart and m and m % scan.restart == 0:
                rst = _plain_restart(br, data, rst)
                state = [0] * (len(scan.comps) + 1)
            y, x = divmod(m, mx)
            for j, (ci, (mh, mv), (td, ta)) in enumerate(zip(scan.comps, per_mcu, scan.tables)):
                for v in range(mv):
                    for h in range(mh):
                        block(br, tabs, coefs[ci][y * mv + v, x * mh + h], state, j, td, ta,
                              scan.spectral)
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


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] RGB from libjpeg's CMYK output [H, W, 4] by OpenCV's
    ``icvCvt_CMYK2BGR_8u_C4C3R``: each of C, M, Y becomes
    k - ((255 - x) * k >> 8), in that order R, G, B."""
    x = cmyk.astype(np.int32)
    k = x[..., 3:]
    return (k - (((255 - x[..., :3]) * k) >> 8)).astype(np.uint8)


def reconstruct(frame: Frame, coefs: list[np.ndarray]) -> np.ndarray:
    """uint8 [H, W, 3] RGB from the coefficients: IDCT, upsampling, colour
    (the file as stored: ``decode_jpeg`` turns it by its orientation)."""
    hmax, vmax = frame.hmax, frame.vmax
    planes = []
    for c, k in zip(frame.components, coefs):
        full = upsample(component_samples(c, k), hmax // c.h, vmax // c.v)
        planes.append(full[:frame.height, :frame.width])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    if len(planes) == 4:
        # jdapimin.c: CMYK unless an Adobe marker gives a transform other
        # than 0, which is YCCK; ycck_cmyk_convert keeps K and makes C, M, Y
        # 255 less the YCC -> RGB conversion's R, G, B
        if frame.adobe_transform in (None, 0):
            cmy = np.stack(planes[:3], axis=-1)
        else:
            cmy = 255 - ycc_to_rgb(*planes[:3])
        return cmyk_to_rgb(np.concatenate([cmy, planes[3][..., None]], axis=-1))
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
    """uint8 [H, W, 3] RGB of a JPEG held in memory, turned by its EXIF
    orientation: what ``cv2.imdecode`` gives, channels reversed."""
    frame = parse(data)
    return orient(reconstruct(frame, entropy_decode(frame, data)), frame.orientation)


def read_jpeg(path: str) -> np.ndarray:
    """uint8 [H, W, 3] RGB of a JPEG file: what
    ``cv2.imread(path)[..., ::-1]`` gives."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read())
