"""The port's JPEG decoder (openobj_torch.utils.jpeg) against OpenCV's:
every byte of ``read_jpeg`` equal to ``cv2.imread(path)[..., ::-1]`` on
files that ``cv2.imencode`` writes here, sequential and progressive
(qualities, chroma subsamplings, grey, restart intervals, optimised tables,
sizes from 1x1 to ScanNet's 968x1296), on EXIF orientations 1-8 in both
byte orders and on malformed EXIF segments, on CMYK files that PIL writes
(with and without the Adobe marker) and YCCK files from a small encoder
here; on arithmetic-coded files (sequential and progressive, restarts, DAC
conditioning) that the transcoder tests/data/jpeg/jpeg_arith.c writes from
them with libjpeg; on lossless files (predictors 1-7, point transforms,
restarts) from GDCM's IJG writer (tests/data/jpeg/jpeg_lossless.c) and
from a small lossless encoder here (subsampling, CMYK, low precisions);
on progressive files whose dropped scans make libjpeg smooth their
blocks; the native entropy decodes equal to the Python loops; refusals,
each of a file cv2 reads as None too, and of truncated or corrupt files;
chip_smoke.py's encoder; and the committed fixtures under tests/data/jpeg/
(written by ``python tests/test_torch_jpeg.py --write-fixtures``) equal
to their stored digests of cv2's decode.

The C writers are built with gcc once per module into a temporary
directory; the tests that need them skip, saying why, where gcc, libjpeg
or GDCM's libraries are missing."""

import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from openobj_torch.utils import jpeg  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg")
# where Debian's libgdcm-dev installs GDCM's IJG headers, one folder a precision
GDCM_JPEG = "/usr/include/gdcm-3.0/gdcmjpeg"
WRITERS = {"arith": ("jpeg_arith.c", [], ["-l:libjpeg.a"]),
           "lossless8": ("jpeg_lossless.c", [f"-I{GDCM_JPEG}/8"], ["-lgdcmjpeg8"]),
           "lossless12": ("jpeg_lossless.c", [f"-I{GDCM_JPEG}/12"], ["-lgdcmjpeg12"])}
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,     # h1v2 fancy upsampling
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}     # 4x1: replication


def _image(h, w, seed=0, grey=False):
    """Gradients, a diagonal pattern and noise: every frequency band busy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 255.0 / max(w - 1, 1), yy * 255.0 / max(h - 1, 1),
                     ((xx + 2 * yy) % 48) * 5.0], axis=-1)
    im = np.clip(base + rng.normal(0, 18, (h, w, 3)), 0, 255).astype(np.uint8)
    return im[..., 1] if grey else im


def _encode(im, **params) -> bytes:
    flags = []
    for k, v in params.items():
        flags += [getattr(cv2, f"IMWRITE_JPEG_{k.upper()}"), v]
    ok, buf = cv2.imencode(".jpg", im if im.ndim == 2 else im[..., ::-1], flags)
    assert ok
    return buf.tobytes()


def _cv2_rgb(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]


def _assert_decodes_like_cv2(data: bytes, tmp_path=None):
    want = _cv2_rgb(data)
    got = jpeg.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if tmp_path is not None:
        path = tmp_path / "f.jpg"
        path.write_bytes(data)
        np.testing.assert_array_equal(jpeg.read_jpeg(str(path)),
                                      cv2.imread(str(path))[..., ::-1])


def build_writers(out_dir: str) -> dict:
    """Compile the C writers beside the fixtures into ``out_dir``: {name:
    the executable, or the reason it could not be built}."""
    gcc = shutil.which("gcc")
    built = {}
    for name, (src, cflags, libs) in WRITERS.items():
        exe = os.path.join(out_dir, name)
        if gcc is None:
            built[name] = "gcc is missing"
            continue
        r = subprocess.run([gcc, "-O2", *cflags, os.path.join(FIXTURES, src), "-o", exe, *libs],
                           capture_output=True, text=True)
        built[name] = exe if r.returncode == 0 else f"{src} does not build: {r.stderr[-300:]}"
    return built


@pytest.fixture(scope="module")
def writers():
    with tempfile.TemporaryDirectory(prefix="jpeg_writers_") as d:
        yield build_writers(d)


def _writer(writers, name: str) -> str:
    exe = writers[name]
    if not os.path.isfile(exe):
        pytest.skip(f"the {name} writer: {exe}")
    return exe


def transcode(exe: str, data: bytes, *args: str) -> bytes:
    """``data`` through jpeg_arith.c (``args``: -progressive, -restart N,
    -dac L U K, -huffman): the same coefficients, coded anew."""
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in.jpg"), os.path.join(d, "out.jpg")
        with open(src, "wb") as f:
            f.write(data)
        subprocess.run([exe, src, dst, *args], check=True, capture_output=True)
        with open(dst, "rb") as f:
            return f.read()


def gdcm_write(exe: str, samples: np.ndarray, *args: str) -> bytes:
    """uint8 (8-bit) or uint16 (12-bit) samples [H, W] or [H, W, C] written
    by jpeg_lossless.c (``args``: -predictor P, -pt N, -restart-rows N,
    -dct)."""
    h, w = samples.shape[:2]
    nc = 1 if samples.ndim == 2 else samples.shape[2]
    raw = np.array([w, h, nc], "<i4").tobytes() + samples.astype(
        "<u2" if samples.dtype == np.uint16 else np.uint8).tobytes()
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in.raw"), os.path.join(d, "out.jpg")
        with open(src, "wb") as f:
            f.write(raw)
        subprocess.run([exe, src, dst, *args], check=True, capture_output=True)
        with open(dst, "rb") as f:
            return f.read()


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


_PREDICT = {1: lambda a, b, c: a, 2: lambda a, b, c: b, 3: lambda a, b, c: c,
            4: lambda a, b, c: a + b - c, 5: lambda a, b, c: a + ((b - c) >> 1),
            6: lambda a, b, c: b + ((a - c) >> 1), 7: lambda a, b, c: (a + b) >> 1}


def encode_lossless(planes, sampling, psv=1, pt=0, restart=0, ids=None, adobe=None,
                    jfif=False, precision=8) -> bytes:
    """A lossless (SOF3) JPEG of uint8 planes (each at its component's own
    size, sampled by ``sampling`` [(h, v)]) in one scan, interleaved when
    there are several; one Huffman table codes every difference category
    0..16 on 5 bits. ``restart`` is in MCUs, a multiple of the MCUs in a
    row."""
    nc = len(planes)
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    width = max(p.shape[1] * hmax // h for p, (h, _) in zip(planes, sampling))
    height = max(p.shape[0] * vmax // v for p, (_, v) in zip(planes, sampling))
    mcu = [(1, 1)] if nc == 1 else sampling
    mx = planes[0].shape[1] if nc == 1 else -(-width // hmax)
    my = planes[0].shape[0] if nc == 1 else -(-height // vmax)
    rows_per_restart = restart // mx
    diffs = []
    for x, (h, v) in zip((p.astype(np.int64) >> pt for p in planes), mcu):
        d = np.zeros((my * v, mx * h), np.int64)
        for r in range(x.shape[0]):
            first = r == 0 or (rows_per_restart and r % v == 0
                               and (r // v) % rows_per_restart == 0)
            for col in range(x.shape[1]):
                if first:
                    pred = (1 << (precision - pt - 1)) if col == 0 else x[r, col - 1]
                elif col == 0:
                    pred = x[r - 1, 0]
                else:
                    pred = _PREDICT[psv](x[r, col - 1], x[r - 1, col], x[r - 1, col - 1])
                d[r, col] = (x[r, col] - pred + 32768) % 65536 - 32768
        diffs.append(d)
    bits: list[int] = []
    body = bytearray()

    def put(value: int, n: int):
        bits.extend((value >> (n - 1 - i)) & 1 for i in range(n))

    def flush():
        bits.extend([1] * (-len(bits) % 8))
        body.extend(np.packbits(np.array(bits, np.uint8)).tobytes().replace(b"\xff", b"\xff\x00"))
        bits.clear()

    for y in range(my):
        if rows_per_restart and y and y % rows_per_restart == 0:
            flush()
            body.extend(bytes([0xFF, 0xD0 + (y // rows_per_restart - 1) % 8]))
        for xx in range(mx):
            for d, (h, v) in zip(diffs, mcu):
                for dv in d[y * v:(y + 1) * v, xx * h:(xx + 1) * h].reshape(-1).tolist():
                    s = 16 if dv == 32768 else abs(dv).bit_length()
                    put(s, 5)
                    if 0 < s < 16:
                        put(dv if dv > 0 else dv + (1 << s) - 1, s)
    flush()
    ids = ids or list(range(1, nc + 1))
    head = b"\xff\xd8"
    if jfif:
        head += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        head += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    head += _segment(0xC3, bytes([precision]) + height.to_bytes(2, "big")
                     + width.to_bytes(2, "big") + bytes([nc])
                     + b"".join(bytes([i, h << 4 | v, 0]) for i, (h, v) in zip(ids, sampling)))
    head += _segment(0xC4, bytes([0, 0, 0, 0, 0, 17]) + bytes(11) + bytes(range(17)))
    if restart:
        head += _segment(0xDD, restart.to_bytes(2, "big"))
    head += _segment(0xDA, bytes([nc]) + b"".join(bytes([i, 0]) for i in ids) + bytes([psv, 0, pt]))
    return head + bytes(body) + b"\xff\xd9"


@pytest.mark.parametrize("size", [(1, 1), (7, 13), (17, 33)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_colour_equal_to_cv2(quality, sampling, size):
    h, w = size
    _assert_decodes_like_cv2(_encode(_image(h, w, seed=quality), quality=quality,
                                     sampling_factor=SAMPLING[sampling]))


@pytest.mark.parametrize("size", [(1, 1), (7, 13), (17, 33)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 95])
def test_grey_equal_to_cv2(quality, size):
    _assert_decodes_like_cv2(_encode(_image(*size, grey=True), quality=quality))


@pytest.mark.parametrize("sampling", ["444", "422", "420"])
@pytest.mark.parametrize("interval", [1, 3])
def test_restart_interval_equal_to_cv2(interval, sampling):
    data = _encode(_image(40, 56, seed=3), quality=90, rst_interval=interval,
                   sampling_factor=SAMPLING[sampling])
    assert b"\xff\xd0" in data and b"\xff\xdd" in data     # RST0 and DRI written
    _assert_decodes_like_cv2(data)


@pytest.mark.parametrize("sampling", ["444", "420"])
def test_optimised_tables_equal_to_cv2(sampling):
    im = _image(33, 47, seed=4)
    data = _encode(im, quality=85, optimize=1, sampling_factor=SAMPLING[sampling])
    assert data != _encode(im, quality=85, sampling_factor=SAMPLING[sampling])
    _assert_decodes_like_cv2(data)


def test_scannet_size_equal_to_cv2(tmp_path):
    """968x1296 at 4:2:0: 60.5 MCU rows, so the chroma's last row is
    repeated below it (jdmainct.c's context rows)."""
    data = _encode(_image(968, 1296, seed=5), quality=95, sampling_factor=SAMPLING["420"])
    _assert_decodes_like_cv2(data, tmp_path)


@pytest.mark.parametrize("size", [(1, 1), (7, 13), (17, 33)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_progressive_colour_equal_to_cv2(quality, sampling, size):
    """libjpeg's progression (jpeg_simple_progression): DC interleaved in
    two scans, AC bands by successive approximation, every coefficient
    refined to bit 0, so libjpeg smooths no block."""
    data = _encode(_image(*size, seed=quality + 1), quality=quality, progressive=1,
                   sampling_factor=SAMPLING[sampling])
    frame = jpeg.parse(data)
    assert frame.progressive and len(frame.scans) == 10
    _assert_decodes_like_cv2(data)


@pytest.mark.parametrize("size", [(1, 1), (7, 13), (31, 45)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 95])
def test_progressive_grey_equal_to_cv2(quality, size):
    data = _encode(_image(*size, grey=True), quality=quality, progressive=1)
    assert jpeg.parse(data).progressive
    _assert_decodes_like_cv2(data)


@pytest.mark.parametrize("sampling", ["444", "420", "grey"])
@pytest.mark.parametrize("interval", [1, 3])
def test_progressive_restart_interval_equal_to_cv2(interval, sampling):
    """Restarts in every scan: EOB runs end at each interval; a
    non-interleaved scan counts blocks of its component's own grid."""
    im = _image(40, 56, seed=11, grey=sampling == "grey")
    params = dict(quality=90, rst_interval=interval, progressive=1)
    if sampling != "grey":
        params["sampling_factor"] = SAMPLING[sampling]
    data = _encode(im, **params)
    assert b"\xff\xd0" in data and jpeg.parse(data).scans[-1].restart == interval
    _assert_decodes_like_cv2(data)


def test_progressive_scannet_size_equal_to_cv2(tmp_path):
    """A ScanNet colour frame re-saved as progressive 4:2:0 at q95."""
    data = _encode(_image(968, 1296, seed=12), quality=95, progressive=1,
                   sampling_factor=SAMPLING["420"])
    _assert_decodes_like_cv2(data, tmp_path)


def _drop_scans(data: bytes, which) -> bytes:
    """``data`` without the scans (SOS segment and entropy-coded data) at
    the indices ``which``."""
    scans = jpeg.parse(data).scans
    for i in sorted(which, reverse=True):
        sos = data.rindex(b"\xff\xda", 0, scans[i].start)
        data = data[:sos] + data[scans[i].end:]
    return data


@pytest.mark.parametrize("case", ["420_rst", "444_q100", "422_opt", "grey_rst", "411"])
def test_native_progressive_decode_equals_plain(case):
    """jpeg_decode_prog_scan against the Python loop of jdphuff.c's four
    decoders, coefficient for coefficient, after every scan of the file
    (each scan adds into what the scans before it left)."""
    sampling, extra = {"420_rst": ("420", dict(rst_interval=2)),
                       "444_q100": ("444", dict(quality=100)),
                       "422_opt": ("422", dict(optimize=1)),
                       "grey_rst": (None, dict(rst_interval=1)),
                       "411": ("411", {})}[case]
    im = _image(27, 41, seed=13, grey=sampling is None)
    params = dict(quality=80, progressive=1)
    params.update(extra)
    if sampling:
        params["sampling_factor"] = SAMPLING[sampling]
    data = _encode(im, **params)
    frame = jpeg.parse(data)
    for n in range(1, len(frame.scans) + 1):
        part = jpeg.parse(data)
        part.scans = part.scans[:n]
        native = jpeg.entropy_decode(part, data)
        plain = jpeg.entropy_decode_plain(part, data)
        for a, b in zip(native, plain):
            assert a.dtype == b.dtype == np.int16
            np.testing.assert_array_equal(a, b)
    assert any(np.count_nonzero(a[..., 1:] & 1) for a in native)     # refined to bit 0


def test_progressive_smoothing_refused():
    """A progressive file whose scans leave AC coefficients 1-9 short of
    bits (here the last refinement scan is gone) is smoothed by libjpeg
    (jdcoefct.c's decompress_smooth_data): no longer refused, the port
    smooths it as libjpeg-turbo does and decodes it as cv2 does; unsmoothed,
    its decode is not cv2's."""
    data = _encode(_image(40, 56, seed=14), quality=90, progressive=1,
                   sampling_factor=SAMPLING["420"])
    short = _drop_scans(data, [9])
    frame = jpeg.parse(short)
    assert frame.smoothed
    _assert_decodes_like_cv2(short)
    frame.smoothed = False
    unsmoothed = jpeg.reconstruct(frame, jpeg.entropy_decode_plain(frame, short))
    assert not np.array_equal(unsmoothed, _cv2_rgb(short))


def _consistent_drops(data: bytes) -> list[list[int]]:
    """Scan sets whose removal leaves a consistent progression: the last
    scan, the last two, the second half, every scan but the first DC one
    (DC only: libjpeg then also interpolates DC), every refinement scan."""
    scans = jpeg.parse(data).scans
    n = len(scans)
    return [[n - 1], [n - 2, n - 1], list(range(n // 2, n)), list(range(1, n)),
            [i for i, s in enumerate(scans) if s.spectral[2] > 0]]


@pytest.mark.parametrize("size", [(9, 17), (17, 33), (24, 24), (40, 56), (65, 90)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "411", "grey"])
def test_smoothing_equal_to_cv2(sampling, size):
    """Block smoothing as libjpeg-turbo does it, byte for byte: files cut
    by dropped scans at every sampling, at sizes with one block column or
    row of a component, a last iMCU row of one block row (v = 2), and
    MCU padding below the image, at two qualities."""
    for q in (50, 90):
        im = _image(*size, seed=size[1] + q, grey=sampling == "grey")
        params = dict(quality=q, progressive=1)
        if sampling != "grey":
            params["sampling_factor"] = SAMPLING[sampling]
        data = _encode(im, **params)
        for drop in _consistent_drops(data):
            short = _drop_scans(data, drop)
            assert jpeg.parse(short).smoothed
            _assert_decodes_like_cv2(short)


@pytest.mark.parametrize("cut", ["half", "mid_scan", "restart", "bad_band", "bad_al",
                                 "ac_interleaved"])
def test_progressive_truncated_or_corrupt_raises(cut):
    """A progressive file cut short (at its middle; inside a scan, with EOI
    after it), a restart marker out of order, and scan headers libjpeg
    refuses (Se past 63, Al not Ah - 1, an AC scan of two components)."""
    data = _encode(_image(40, 56, seed=15), quality=90, rst_interval=2, progressive=1,
                   sampling_factor=SAMPLING["420"])
    scans = jpeg.parse(data).scans
    sos = [data.rindex(b"\xff\xda", 0, s.start) for s in scans]
    if cut == "half":
        bad = data[:len(data) // 2]
    elif cut == "mid_scan":
        bad = data[:(scans[4].start + scans[4].end) // 2] + b"\xff\xd9"
    elif cut == "restart":
        i = data.index(b"\xff\xd1", scans[4].start)
        bad = data[:i + 1] + b"\xd3" + data[i + 2:]
    else:
        k = {"bad_band": 1, "bad_al": 1, "ac_interleaved": 0}[cut]
        hdr = bytearray(data[sos[k]:scans[k].start])
        ns = hdr[4]
        if cut == "bad_band":
            hdr[6 + 2 * ns] = 64                            # Se
        elif cut == "bad_al":
            hdr[7 + 2 * ns] = 0x20                          # Ah 2, Al 0
        else:
            hdr[5 + 2 * ns] = 1                             # Ss 1 on the interleaved DC scan
            hdr[6 + 2 * ns] = 5
        bad = data[:sos[k]] + bytes(hdr) + data[scans[k].start:]
    with pytest.raises(jpeg.JpegError):
        jpeg.decode_jpeg(bad)


@pytest.mark.parametrize("case", ["420_rst", "444_q100", "422_opt", "grey_rst"])
def test_native_entropy_decode_equals_plain(case):
    sampling, extra = {"420_rst": ("420", dict(rst_interval=2)),
                       "444_q100": ("444", dict(quality=100)),
                       "422_opt": ("422", dict(optimize=1)),
                       "grey_rst": (None, dict(rst_interval=1))}[case]
    im = _image(27, 41, seed=6, grey=sampling is None)
    params = dict(quality=80)
    params.update(extra)
    if sampling:
        params["sampling_factor"] = SAMPLING[sampling]
    data = _encode(im, **params)
    frame = jpeg.parse(data)
    native = jpeg.entropy_decode(frame, data)
    plain = jpeg.entropy_decode_plain(frame, data)
    assert len(native) == len(plain) == len(frame.components)
    for a, b in zip(native, plain):
        assert a.dtype == b.dtype == np.int16
        np.testing.assert_array_equal(a, b)
    assert any(np.count_nonzero(a[..., 1:]) for a in native)


def _assert_refused_like_cv2(data: bytes, match: str, error=NotImplementedError):
    """cv2 reads no image from ``data``, and the port raises."""
    assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(error, match=match):
        jpeg.decode_jpeg(data)


def test_progressive_and_other_codings_refused():
    """A progressive file decodes as cv2 decodes it; hierarchical and
    differential frames (SOF5-7, SOF13-15), arithmetic-coded lossless ones
    (SOF11), 12-bit samples and a height left to a DNL marker raise, each
    on bytes that cv2 reads as None too."""
    _assert_decodes_like_cv2(_encode(_image(24, 32), quality=90, progressive=1))
    base = _encode(_image(24, 32), quality=90)
    i = base.index(b"\xff\xc0")
    for sof, what in ((0xC5, "differential"), (0xC6, "differential"), (0xC7, "differential"),
                      (0xCD, "differential"), (0xCE, "differential"), (0xCF, "differential")):
        _assert_refused_like_cv2(base[:i + 1] + bytes([sof]) + base[i + 2:], what)
    lossless = encode_lossless([_image(8, 12)[..., c] for c in range(3)], [(1, 1)] * 3)
    j = lossless.index(b"\xff\xc3")
    _assert_refused_like_cv2(lossless[:j + 1] + b"\xcb" + lossless[j + 2:], "arithmetic-coded lossless")
    twelve = bytearray(base)
    twelve[i + 4] = 12                      # sample precision
    _assert_refused_like_cv2(bytes(twelve), "12-bit")
    dnl = bytearray(base)
    dnl[i + 5:i + 7] = b"\x00\x00"          # height 0: given by a DNL marker
    _assert_refused_like_cv2(bytes(dnl), "DNL")


def test_remaining_refusals_are_cv2s():
    """What the port still refuses, cv2 reads as None: a 2-component file,
    non-integral sampling ratios (3x1 luma beside 2x1 chroma), a grey
    lossless file read as colour, lossless files in the YCbCr (JFIF,
    Adobe transform 1) and YCCK colour spaces, lossless precisions 1 and
    9-16, and a lossless restart interval that is not whole MCU rows."""
    rng = np.random.default_rng(20)
    _assert_refused_like_cv2(encode_planes(rng.integers(0, 256, (2, 16, 24))), "2-component")
    odd = bytearray(_encode(_image(24, 32), quality=90, sampling_factor=SAMPLING["444"]))
    i = odd.index(b"\xff\xc0")
    odd[i + 11], odd[i + 14] = 0x31, 0x21
    _assert_refused_like_cv2(bytes(odd), "non-integral")
    planes = [rng.integers(0, 256, (9, 14)) for _ in range(4)]
    _assert_refused_like_cv2(encode_lossless(planes[:1], [(1, 1)]), "grey lossless")
    _assert_refused_like_cv2(encode_lossless(planes[:3], [(1, 1)] * 3, jfif=True), "YCbCr")
    _assert_refused_like_cv2(encode_lossless(planes[:3], [(1, 1)] * 3, adobe=1), "YCbCr")
    _assert_refused_like_cv2(encode_lossless(planes, [(1, 1)] * 4, adobe=2), "YCCK")
    for p in (1, 9, 12, 16):
        data = bytearray(encode_lossless([x >> 7 for x in planes[:3]], [(1, 1)] * 3))
        data[data.index(b"\xff\xc3") + 4] = p
        _assert_refused_like_cv2(bytes(data), f"{p}-bit samples in a lossless")
    data = bytearray(encode_lossless(planes[:3], [(1, 1)] * 3, restart=14))
    k = data.index(b"\xff\xdd")
    data[k + 4:k + 6] = (5).to_bytes(2, "big")
    _assert_refused_like_cv2(bytes(data), "restart interval", jpeg.JpegError)


def test_twelve_bit_files_refused_like_cv2(writers):
    """12-bit files as GDCM's IJG library writes them, sequential DCT (SOF1)
    and lossless (SOF3): cv2 reads neither, the port refuses both."""
    exe = _writer(writers, "lossless12")
    samples = np.random.default_rng(21).integers(0, 4096, (16, 24, 3)).astype(np.uint16)
    for args in ((), ("-dct",)):
        _assert_refused_like_cv2(gdcm_write(exe, samples, *args), "12-bit")


ARITH_MODES = {"sequential": (), "sequential_rst": ("-restart", "2"),
               "progressive": ("-progressive",), "progressive_rst": ("-progressive", "-restart", "1"),
               "dac": ("-dac", "2", "4", "2"), "progressive_dac": ("-progressive", "-dac", "1", "3", "20")}


@pytest.mark.parametrize("mode", list(ARITH_MODES))
@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "411", "grey"])
def test_arithmetic_equal_to_cv2(writers, sampling, mode):
    """Arithmetic-coded files (SOF9, SOF10) that libjpeg transcodes from
    cv2's: sequential and progressive, with restart intervals, and with
    DAC conditioning values other than the defaults (L, U of the DC
    statistics; Kx of the AC ones)."""
    exe = _writer(writers, "arith")
    for size in ((1, 1), (17, 33), (40, 56)):
        im = _image(*size, seed=size[1], grey=sampling == "grey")
        params = {} if sampling == "grey" else dict(sampling_factor=SAMPLING[sampling])
        huffman = _encode(im, quality=85, **params)
        data = transcode(exe, huffman, *ARITH_MODES[mode])
        frame = jpeg.parse(data)
        assert frame.arithmetic and frame.progressive == ("progressive" in mode)
        _assert_decodes_like_cv2(data)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), _cv2_rgb(huffman))


def _without_dac(data: bytes) -> bytes:
    """``data`` without its DAC segments."""
    while b"\xff\xcc" in data:
        i = data.index(b"\xff\xcc")
        data = data[:i] + data[i + 2 + int.from_bytes(data[i + 2:i + 4], "big"):]
    return data


def test_arithmetic_conditioning_defaults(writers):
    """Without a DAC marker the statistics use T.81's defaults (L 0, U 1,
    Kx 5): a file coded with them decodes alike with or without its DAC
    segments; one coded with others does not decode to the same image
    without them."""
    exe = _writer(writers, "arith")
    huffman = _encode(_image(24, 40, seed=22), quality=80, sampling_factor=SAMPLING["420"])
    plain = transcode(exe, huffman)
    assert b"\xff\xcc" in plain and b"\xff\xcc" not in _without_dac(plain)
    _assert_decodes_like_cv2(_without_dac(plain))
    np.testing.assert_array_equal(jpeg.decode_jpeg(_without_dac(plain)), _cv2_rgb(huffman))
    other = _without_dac(transcode(exe, huffman, "-dac", "3", "6", "12"))
    assert not np.array_equal(jpeg.decode_jpeg(other), _cv2_rgb(huffman))


@pytest.mark.parametrize("case", ["420_rst", "444_progressive", "grey_progressive_rst", "422_dac",
                                  "420_progressive_dac"])
def test_native_arith_decode_equals_plain(writers, case):
    """jpeg_decode_arith_scan against the Python QM decoder, coefficient
    for coefficient, after every scan of the file."""
    exe = _writer(writers, "arith")
    sampling, args = {"420_rst": ("420", ("-restart", "2")),
                      "444_progressive": ("444", ("-progressive",)),
                      "grey_progressive_rst": (None, ("-progressive", "-restart", "3")),
                      "422_dac": ("422", ("-dac", "2", "5", "9")),
                      "420_progressive_dac": ("420", ("-progressive", "-dac", "1", "2", "30"))}[case]
    params = dict(quality=90)
    if sampling:
        params["sampling_factor"] = SAMPLING[sampling]
    data = transcode(exe, _encode(_image(27, 41, seed=23, grey=sampling is None), **params), *args)
    for n in range(1, len(jpeg.parse(data).scans) + 1):
        part = jpeg.parse(data)
        part.scans = part.scans[:n]
        for a, b in zip(jpeg.entropy_decode(part, data), jpeg.entropy_decode_plain(part, data)):
            assert a.dtype == b.dtype == np.int16
            np.testing.assert_array_equal(a, b)
    assert any(np.count_nonzero(a[..., 1:]) for a in jpeg.entropy_decode(part, data))


def test_arithmetic_smoothing_and_cut_scans(writers):
    """An arithmetic-coded progressive file with dropped scans is smoothed
    as cv2 smooths it; a scan cut short (EOI after half its data) decodes
    as libjpeg decodes it, the coder reading zeros past the marker (T.81
    D.2.6), and a restart marker out of order raises."""
    exe = _writer(writers, "arith")
    huffman = _encode(_image(40, 56, seed=24), quality=90, sampling_factor=SAMPLING["420"])
    prog = transcode(exe, huffman, "-progressive")
    for drop in _consistent_drops(prog):
        _assert_decodes_like_cv2(_drop_scans(prog, drop))
    seq = transcode(exe, huffman)
    scan = jpeg.parse(seq).scans[0]
    _assert_decodes_like_cv2(seq[:(scan.start + scan.end) // 2] + b"\xff\xd9")
    rst = transcode(exe, huffman, "-restart", "1")
    i = rst.index(b"\xff\xd1")
    with pytest.raises(jpeg.JpegError, match="restart"):
        jpeg.decode_jpeg(rst[:i + 1] + b"\xd3" + rst[i + 2:])


@pytest.mark.parametrize("pt", [0, 1, 2])
@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_equal_to_cv2(writers, psv, pt):
    """3-component lossless files (SOF3, RGB with GDCM's Adobe marker) at
    each predictor and point transform, with restarts every 1 or 3 MCU
    rows and without, at sizes from 1x1 up."""
    exe = _writer(writers, "lossless8")
    for i, size in enumerate(((1, 1), (7, 13), (24, 40))):
        im = _image(*size, seed=psv * 3 + pt)
        data = gdcm_write(exe, im, "-predictor", str(psv), "-pt", str(pt),
                          "-restart-rows", str((0, 1, 3)[i]))
        frame = jpeg.parse(data)
        assert frame.lossless and frame.scans[0].spectral[::3] == (psv, pt)
        _assert_decodes_like_cv2(data)
        if pt == 0:
            np.testing.assert_array_equal(jpeg.decode_jpeg(data), im)


@pytest.mark.parametrize("case", ["420", "422_rst", "cmyk", "cmyk_adobe", "no_marker_ids_123",
                                  "precision_2", "precision_6", "pt_3_rst"])
def test_lossless_layouts_equal_to_cv2(case):
    """Lossless files from the encoder here: subsampled components (never
    fancy-upsampled), CMYK with and without the Adobe marker, 3 components
    with ids 1, 2, 3 and no marker (RGB in a lossless file), precisions
    below 8 (samples kept as they are, not scaled), and a point transform
    of 3 with restarts."""
    rng = np.random.default_rng(25)
    h, w = 13, 21
    full = [rng.integers(0, 256, (h, w)) for _ in range(4)]
    half = [rng.integers(0, 256, (7, 11)) for _ in range(2)]
    data = {
        "420": lambda: encode_lossless([full[0], *half], [(2, 2), (1, 1), (1, 1)], psv=5, adobe=0),
        "422_rst": lambda: encode_lossless([full[0], *(x[:, :11] for x in full[1:3])],
                                           [(2, 1), (1, 1), (1, 1)], psv=6, restart=22, adobe=0),
        "cmyk": lambda: encode_lossless(full, [(1, 1)] * 4, psv=4),
        "cmyk_adobe": lambda: encode_lossless(full, [(1, 1)] * 4, psv=7, adobe=0),
        "no_marker_ids_123": lambda: encode_lossless(full[:3], [(1, 1)] * 3, psv=2),
        "precision_2": lambda: encode_lossless([x >> 6 for x in full[:3]], [(1, 1)] * 3,
                                               precision=2),
        "precision_6": lambda: encode_lossless([x >> 2 for x in full[:3]], [(1, 1)] * 3, psv=4,
                                               precision=6),
        "pt_3_rst": lambda: encode_lossless(full[:3], [(1, 1)] * 3, psv=3, pt=3, restart=42,
                                            ids=[82, 71, 66]),
    }[case]()
    assert jpeg.parse(data).lossless
    _assert_decodes_like_cv2(data)


@pytest.mark.parametrize("case", ["gdcm_rst", "420_rst", "pt_2"])
def test_native_lossless_decode_equals_plain(writers, case):
    """jpeg_decode_lossless_scan against the Python loop of jdlhuff.c,
    jddiffct.c and jdlossls.c, sample for sample."""
    rng = np.random.default_rng(26)
    if case == "gdcm_rst":
        data = gdcm_write(_writer(writers, "lossless8"), _image(19, 27, seed=26), "-predictor",
                          "5", "-restart-rows", "2")
    elif case == "420_rst":
        data = encode_lossless([rng.integers(0, 256, (19, 27)), rng.integers(0, 256, (10, 14)),
                                rng.integers(0, 256, (10, 14))], [(2, 2), (1, 1), (1, 1)], psv=7,
                               restart=28)
    else:
        data = encode_lossless([rng.integers(0, 256, (19, 27)) for _ in range(3)],
                               [(1, 1)] * 3, psv=6, pt=2)
    frame = jpeg.parse(data)
    for a, b in zip(jpeg.entropy_decode(frame, data), jpeg.entropy_decode_plain(frame, data)):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def _exif(entries, order=b"MM", mark=0x2A, head=b"Exif\x00\x00", count=None) -> bytes:
    """An APP1 payload: ``head``, a TIFF header in byte order ``order`` and
    IFD0 holding ``entries`` (tag, type, count, 4-byte value or a SHORT),
    its entry count given as ``count`` when set."""
    e = "little" if order == b"II" else "big"
    ifd = (len(entries) if count is None else count).to_bytes(2, e)
    for tag, typ, n, val in entries:
        ifd += tag.to_bytes(2, e) + typ.to_bytes(2, e) + n.to_bytes(4, e)
        ifd += val if isinstance(val, bytes) else val.to_bytes(2, e) + bytes(2)
    return head + order + mark.to_bytes(2, e) + (8).to_bytes(4, e) + ifd + bytes(4)


def _with_app1(data: bytes, payload: bytes) -> bytes:
    """``data`` with an APP1 segment holding ``payload`` right after SOI."""
    return data[:2] + b"\xff\xe1" + (len(payload) + 2).to_bytes(2, "big") + payload + data[2:]


def _with_orientation(data: bytes, orientation: int, order=b"MM") -> bytes:
    """``data`` with an EXIF APP1 segment (IFD0 holding the orientation tag)
    after SOI."""
    return _with_app1(data, _exif([(0x0112, 3, 1, orientation)], order))


@pytest.mark.parametrize("order", [b"MM", b"II"], ids=["MM", "II"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(tmp_path, orientation, order):
    """Orientations 1-8 turn the image as cv2 turns it (5-8 transpose it),
    in both byte orders, through read_jpeg and decode_jpeg alike."""
    data = _encode(_image(16, 24), quality=90)
    turned = _with_orientation(data, orientation, order)
    assert jpeg.parse(turned).orientation == orientation
    _assert_decodes_like_cv2(turned, tmp_path)
    assert jpeg.decode_jpeg(turned).shape[:2] == ((24, 16) if orientation >= 5 else (16, 24))


MAKE = (0x010F, 2, 4, b"abc\x00")                 # a string held in the entry
FAR = (0x010F, 2, 40, (999).to_bytes(4, "big"))    # a string past the end
XRES_FAR = (0x011A, 5, 1, (5000).to_bytes(4, "big"))


@pytest.mark.parametrize("case,want", [
    ("after_make", 6), ("after_unknown_tag", 2), ("after_exif_offset", 4),
    ("first_of_two_entries", 3), ("long_type", 3), ("count_past_end", 8),
    ("bad_entry_after", 5), ("bad_entry_before", 1), ("bad_rational_before", 1),
    ("tag_mark", 1), ("byte_order", 6), ("ifd_past_end", 1), ("header_only", 1),
    ("not_exif", 1), ("xmp_then_exif", 6), ("first_segment_wins", 6),
    ("failed_then_exif", 6)])
def test_exif_read_as_opencv_reads_it(case, want):
    """Where the orientation tag stands and what is around it: the tag not
    first in IFD0, an entry of another type, an entry count past the end,
    an entry that reads past the end after or before the tag (the entries
    read before it stand), a wrong TIFF mark, an IFD past the end, a byte
    order other than II (read as MM), an APP1 that is not EXIF, and several
    EXIF segments (the first orientation found stands). Each as cv2 reads
    it."""
    o6 = [(0x0112, 3, 1, 6)]
    payloads = {
        "after_make": [_exif([MAKE, *o6])],
        "after_unknown_tag": [_exif([(0x9999, 3, 1, 4), (0x0112, 3, 1, 2)])],
        "after_exif_offset": [_exif([(0x8769, 4, 1, bytes(4)), (0x0112, 3, 1, 4)], b"II")],
        "first_of_two_entries": [_exif([(0x0112, 3, 1, 3), *o6])],
        "long_type": [_exif([(0x0112, 4, 1, 3)])],
        "count_past_end": [_exif([(0x0112, 3, 1, 8)], count=40)],
        "bad_entry_after": [_exif([(0x0112, 3, 1, 5), XRES_FAR])],
        "bad_entry_before": [_exif([FAR, *o6])],
        "bad_rational_before": [_exif([XRES_FAR, *o6])],
        "tag_mark": [_exif(o6, mark=0x2B)],
        "byte_order": [_exif(o6, order=b"IM")],           # read big-endian, as MM
        "ifd_past_end": [_exif(o6)[:14]],
        "header_only": [b"Exif\x00\x00"],
        "not_exif": [_exif(o6, head=b"Exif\x00\x01")],
        "xmp_then_exif": [b"http://ns.adobe.com/xap/1.0/\x00<x/>", _exif(o6)],
        "first_segment_wins": [_exif(o6), _exif([(0x0112, 3, 1, 1)])],
        "failed_then_exif": [_exif([MAKE, FAR]), _exif(o6)],
    }[case]
    data = _encode(_image(16, 24), quality=90)
    for p in reversed(payloads):
        data = _with_app1(data, p)
    assert jpeg.parse(data).orientation == want
    _assert_decodes_like_cv2(data)


def _pil_cmyk(cmyk: np.ndarray, **params) -> bytes:
    """A JPEG of a uint8 [H, W, 4] CMYK image written by PIL (libjpeg's
    CMYK, with its Adobe marker: transform 0)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(buf, "JPEG", **params)
    return buf.getvalue()


def _without_adobe(data: bytes) -> bytes:
    i = data.index(b"\xff\xee")
    n = int.from_bytes(data[i + 2:i + 4], "big")
    return data[:i] + data[i + 2 + n:]


def encode_planes(planes: np.ndarray, quality: int = 90, adobe: int | None = None) -> bytes:
    """A baseline JPEG of uint8 [C, H, W] planes, each 1x1 sampled, with an
    Adobe APP14 marker of transform ``adobe`` when given: chip_smoke.py's
    encoder's tables (Annex K, libjpeg's quality scaling), a float DCT and a
    plain bit writer. Components 0 and 3 take the luma tables, 1 and 2 the
    chroma ones (as libjpeg codes YCCK)."""
    import chip_smoke as cs

    nc, h, w = planes.shape
    my, mx = -(-h // 8), -(-w // 8)
    x = np.pad(planes.astype(np.float64), ((0, 0), (0, 8 * my - h), (0, 8 * mx - w)), mode="edge")
    u = np.arange(8)
    dct = np.sqrt(np.where(u == 0, 1.0, 2.0) / 8)[:, None] * np.cos(
        (2 * u[None, :] + 1) * u[:, None] * np.pi / 16)
    qts = cs.jpeg_quant_tables(quality)
    slot = [0, 1, 1, 0][:nc]
    codes = {k: cs._huff_codes(*v) for k, v in cs.ANNEX_K_HUFF.items()}
    f = (x - 128.0).reshape(nc, my, 8, mx, 8).transpose(0, 1, 3, 2, 4)
    coef = dct @ f @ dct.T
    zz = np.stack([np.round(coef[c].reshape(my, mx, 64) / qts[slot[c]])[..., cs.ZIGZAG]
                   for c in range(nc)]).astype(np.int64)
    bits: list[int] = []

    def put(code, length):
        bits.extend((int(code) >> (length - 1 - i)) & 1 for i in range(length))

    def coded(tc, c, sym, v, s):
        put(codes[(tc, slot[c])][0][sym], codes[(tc, slot[c])][1][sym])
        put(v if v >= 0 else v + (1 << s) - 1, s)

    pred = [0] * nc
    for by in range(my):
        for bx in range(mx):
            for c in range(nc):
                blk = zz[c, by, bx]
                d = int(blk[0]) - pred[c]
                pred[c] = int(blk[0])
                coded(0, c, int(abs(d)).bit_length(), d, int(abs(d)).bit_length())
                run = 0
                for k in range(1, 64):
                    v = int(blk[k])
                    if v == 0:
                        run += 1
                        continue
                    while run > 15:
                        coded(1, c, 0xF0, 0, 0)
                        run -= 16
                    s = abs(v).bit_length()
                    coded(1, c, run * 16 + s, v, s)
                    run = 0
                if run:
                    coded(1, c, 0x00, 0, 0)
    bits += [1] * (-len(bits) % 8)
    body = np.packbits(np.array(bits, np.uint8))
    body = np.insert(body, np.flatnonzero(body == 0xFF) + 1, 0).tobytes()

    def segment(marker, payload):
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload

    head = b"" if adobe is None else segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                                             + bytes([adobe]))
    for t, q in enumerate(qts):
        head += segment(0xDB, bytes([t]) + bytes(q[cs.ZIGZAG].astype(np.uint8)))
    head += segment(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([nc])
                    + b"".join(bytes([c + 1, 0x11, slot[c]]) for c in range(nc)))
    for (tc, th), (b, hv) in cs.ANNEX_K_HUFF.items():
        head += segment(0xC4, bytes([tc << 4 | th]) + bytes(b) + hv)
    head += segment(0xDA, bytes([nc]) + b"".join(bytes([c + 1, slot[c] * 0x11])
                                                 for c in range(nc)) + bytes([0, 63, 0]))
    return b"\xff\xd8" + head + body + b"\xff\xd9"


def _ycck_planes(h, w, seed=0) -> np.ndarray:
    """Y, Cb, Cr of ``_image`` and a K ramp with noise: [4, H, W] uint8."""
    rgb = _image(h, w, seed=seed).astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    k = np.add.outer(np.arange(h) * 200.0 / max(h - 1, 1), np.arange(w) * 50.0 / max(w - 1, 1))
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0,
              0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0,
              k + np.random.default_rng(seed).normal(0, 10, (h, w))]
    return np.clip(np.round(planes), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("case", ["adobe", "no_adobe", "progressive", "q50_odd"])
def test_cmyk_equal_to_cv2(case, tmp_path):
    """CMYK files that PIL writes (Adobe transform 0), the same without
    the Adobe marker (libjpeg takes it as CMYK all the same), progressive,
    and at q50 at an odd size: libjpeg's CMYK through OpenCV's integer
    CMYK -> BGR."""
    rng = np.random.default_rng(16)
    h, w = (17, 23) if case == "q50_odd" else (24, 40)
    cmyk = np.concatenate([_image(h, w, seed=17), rng.integers(0, 256, (h, w, 1))],
                          axis=-1).astype(np.uint8)
    data = _pil_cmyk(cmyk, quality=50 if case == "q50_odd" else 90,
                     progressive=case == "progressive")
    if case == "no_adobe":
        data = _without_adobe(data)
    frame = jpeg.parse(data)
    assert len(frame.components) == 4 and frame.progressive == (case == "progressive")
    assert frame.adobe_transform == (None if case == "no_adobe" else 0)
    _assert_decodes_like_cv2(data, tmp_path)


@pytest.mark.parametrize("transform", [2, 1])
def test_ycck_equal_to_cv2(transform, tmp_path):
    """YCCK (Adobe transform 2; libjpeg assumes YCCK for any transform but
    0 in a 4-component file): jdcolor.c's ycck_cmyk_convert, K kept, then
    OpenCV's CMYK -> BGR."""
    data = encode_planes(_ycck_planes(21, 30, seed=transform), quality=90, adobe=transform)
    assert jpeg.parse(data).adobe_transform == transform
    _assert_decodes_like_cv2(data, tmp_path)


@pytest.mark.parametrize("cut", ["eoi", "half", "header", "scan_header"])
def test_truncated_files_raise(cut):
    data = _encode(_image(40, 56, seed=7), quality=90, rst_interval=2,
                   sampling_factor=SAMPLING["420"])
    end = {"eoi": len(data) - 2, "half": len(data) // 2, "header": 40,
           "scan_header": data.index(b"\xff\xda") + 6}[cut]
    with pytest.raises(jpeg.JpegError):
        jpeg.decode_jpeg(data[:end])


def test_corrupt_entropy_data_raises():
    """A restart marker out of order, and a scan cut short before its EOI
    (bits needed past a marker): libjpeg pads with zeros, the port raises."""
    data = _encode(_image(40, 56, seed=8), quality=90, rst_interval=2)
    i = data.index(b"\xff\xd1")
    with pytest.raises(jpeg.JpegError, match="restart"):
        jpeg.decode_jpeg(data[:i + 1] + b"\xd2" + data[i + 2:])
    sos = data.index(b"\xff\xda")
    with pytest.raises(jpeg.JpegError):
        jpeg.decode_jpeg(data[:sos + 40] + b"\xff\xd9")


def test_chip_smoke_encoder_decodes_alike():
    """chip_smoke.py writes phase 4g's colour frames with its own numpy
    encoder: cv2 and the port decode its files alike, the quantisation
    tables are libjpeg's at the same quality, and a smooth frame comes back
    above the phase's 35 dB gate."""
    import chip_smoke

    for h, w in ((1, 1), (9, 14), (40, 72)):
        data = chip_smoke.encode_jpeg(_image(h, w, seed=h), quality=95)
        _assert_decodes_like_cv2(data)
    ours = jpeg.parse(chip_smoke.encode_jpeg(_image(16, 16), quality=95))
    libj = jpeg.parse(_encode(_image(16, 16), quality=95, sampling_factor=SAMPLING["420"]))
    for a, b in zip(ours.components, libj.components):
        assert (a.h, a.v) == (b.h, b.v)
        np.testing.assert_array_equal(a.qt, b.qt)
    yy, xx = np.mgrid[:64, :96]
    smooth = np.stack([xx * 2.0, yy * 3.0, 128 + 60 * np.sin(xx / 9.0)], -1).astype(np.uint8)
    got = jpeg.decode_jpeg(chip_smoke.encode_jpeg(smooth, quality=95)).astype(np.float64)
    psnr = 10 * np.log10(255.0 ** 2 / np.mean((got - smooth) ** 2))
    assert psnr > 35.0, psnr


def _digest(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


# each arithmetic-coded fixture and the Huffman-coded one it was transcoded from
ARITH_SOURCES = {"tabletop_968x1296_q95_420_arith.jpg": "tabletop_968x1296_q95_420.jpg",
                 "tabletop_968x1296_q95_420_arith_progressive.jpg":
                     "tabletop_968x1296_q95_420.jpg",
                 "small_444_rst_arith.jpg": "small_444_rst.jpg"}


def test_fixtures_equal_their_digests():
    """The committed fixtures (chip_smoke.py phase 4g decodes them on the
    card's machine, which has no cv2) decode to the stored digests of cv2's
    decode, here by both decoders; an arithmetic-coded transcode to its
    Huffman source's, since the coefficients are the same."""
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        want = json.load(f)
    assert len(want) == 13
    for name, entry in want.items():
        path = os.path.join(FIXTURES, name)
        ref = cv2.imread(path)[..., ::-1]
        assert list(ref.shape) == entry["shape"] and _digest(ref) == entry["sha256"], name
        got = jpeg.read_jpeg(path)
        assert _digest(got) == entry["sha256"], name
    for name, source in ARITH_SOURCES.items():
        assert jpeg.parse(open(os.path.join(FIXTURES, name), "rb").read()).arithmetic
        assert want[name]["sha256"] == want[source]["sha256"], name
    frame = jpeg.parse(open(os.path.join(FIXTURES, "lossless_rgb_24x40.jpg"), "rb").read())
    assert frame.lossless and frame.scans[0].restart
    assert jpeg.parse(open(os.path.join(FIXTURES, "smoothed_420_40x56.jpg"), "rb").read()).smoothed


def write_fixtures() -> None:
    """Write tests/data/jpeg/: a 968x1296 4:2:0 q95 tabletop frame (the
    synthetic archetype at a ScanNet colour camera), baseline, progressive,
    and transcoded to arithmetic coding, sequential and progressive; a
    small 4:4:4 file with restarts, baseline, progressive and arithmetic; a
    grey file with odd sizes; an orientation-6 file; a CMYK file (PIL's)
    and a YCCK one (``encode_planes``); a lossless RGB file with restarts
    (GDCM's writer); a progressive 4:2:0 file whose last two scans are gone,
    which libjpeg smooths; and digests.json (shape and SHA-256 of cv2's RGB
    decode of each). Builds the C writers with gcc."""
    from openobj_torch.core.scene import Camera
    from openobj_torch.data import synthetic

    os.makedirs(FIXTURES, exist_ok=True)
    cam = Camera(width=1296, height=968, fx=1170.0, fy=1170.0, cx=647.5, cy=483.5)
    scene, orbit = synthetic.archetype_scene("tabletop")
    rgb, _, _ = scene.render(synthetic.orbit_pose(0.7, **orbit), cam.ray_dirs("cpu").numpy())
    small = _image(40, 56, seed=9)
    tmp = tempfile.mkdtemp(prefix="jpeg_writers_")
    built = build_writers(tmp)
    cmyk = np.concatenate([_image(24, 40, seed=18),
                           np.random.default_rng(18).integers(0, 256, (24, 40, 1))], axis=-1)
    files = {
        "tabletop_968x1296_q95_420.jpg": _encode(rgb, quality=95,
                                                 sampling_factor=SAMPLING["420"]),
        "small_444_rst.jpg": _encode(small, quality=90, rst_interval=3,
                                     sampling_factor=SAMPLING["444"]),
        "grey_31x45.jpg": _encode(_image(31, 45, seed=10, grey=True), quality=80),
        "tabletop_968x1296_q95_420_progressive.jpg": _encode(
            rgb, quality=95, progressive=1, sampling_factor=SAMPLING["420"]),
        "small_444_rst_progressive.jpg": _encode(small, quality=90, rst_interval=3, progressive=1,
                                                 sampling_factor=SAMPLING["444"]),
        "orientation6_16x24.jpg": _with_orientation(_encode(_image(16, 24, seed=19), quality=90),
                                                    6),
        "cmyk_24x40.jpg": _pil_cmyk(cmyk.astype(np.uint8), quality=90),
        "ycck_21x30.jpg": encode_planes(_ycck_planes(21, 30, seed=20), quality=90, adobe=2),
        "lossless_rgb_24x40.jpg": gdcm_write(built["lossless8"], _image(24, 40, seed=27),
                                             "-predictor", "6", "-restart-rows", "3"),
        "smoothed_420_40x56.jpg": _drop_scans(_encode(_image(40, 56, seed=28), quality=90,
                                                      progressive=1,
                                                      sampling_factor=SAMPLING["420"]), [8, 9]),
    }
    files["tabletop_968x1296_q95_420_arith.jpg"] = transcode(
        built["arith"], files["tabletop_968x1296_q95_420.jpg"])
    files["tabletop_968x1296_q95_420_arith_progressive.jpg"] = transcode(
        built["arith"], files["tabletop_968x1296_q95_420.jpg"], "-progressive")
    files["small_444_rst_arith.jpg"] = transcode(built["arith"], files["small_444_rst.jpg"],
                                                 "-restart", "3")
    shutil.rmtree(tmp)
    digests = {}
    for name, data in files.items():
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
        ref = _cv2_rgb(data)
        digests[name] = {"shape": list(ref.shape), "sha256": _digest(ref)}
    with open(os.path.join(FIXTURES, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1)


if __name__ == "__main__" and "--write-fixtures" in sys.argv:
    write_fixtures()
