"""The port's baseline JPEG decoder (openobj_torch.utils.jpeg) against
OpenCV's: every byte of ``read_jpeg`` equal to ``cv2.imread(path)[..., ::-1]``
on files that ``cv2.imencode`` writes here (qualities, chroma subsamplings,
grey, restart intervals, optimised tables, sizes from 1x1 to ScanNet's
968x1296); the native entropy decode equal to the Python loop; refusals of
progressive, truncated and rotated files; chip_smoke.py's encoder; and the
committed fixtures under tests/data/jpeg/ (written by ``python
tests/test_torch_jpeg.py --write-fixtures``) equal to their stored digests
of cv2's decode."""

import hashlib
import json
import os
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from openobj_torch.utils import jpeg  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg")
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


def test_progressive_and_other_codings_refused():
    data = _encode(_image(24, 32), quality=90, progressive=1)
    with pytest.raises(NotImplementedError, match="progressive.*A14c"):
        jpeg.decode_jpeg(data)
    base = _encode(_image(24, 32), quality=90)
    i = base.index(b"\xff\xc0")
    for sof, what in ((0xC3, "lossless"), (0xC9, "arithmetic")):
        with pytest.raises(NotImplementedError, match=what):
            jpeg.decode_jpeg(base[:i + 1] + bytes([sof]) + base[i + 2:])
    twelve = bytearray(base)
    twelve[i + 4] = 12                      # sample precision
    with pytest.raises(NotImplementedError, match="12-bit"):
        jpeg.decode_jpeg(bytes(twelve))


def _with_orientation(data: bytes, orientation: int) -> bytes:
    """``data`` with an EXIF APP1 segment (big-endian TIFF, IFD0 holding the
    orientation tag) after SOI."""
    ifd = (1).to_bytes(2, "big") + (0x0112).to_bytes(2, "big") + (3).to_bytes(2, "big") \
        + (1).to_bytes(4, "big") + orientation.to_bytes(2, "big") + b"\x00\x00" + bytes(4)
    payload = b"Exif\x00\x00" + b"MM\x00\x2a" + (8).to_bytes(4, "big") + ifd
    return data[:2] + b"\xff\xe1" + (len(payload) + 2).to_bytes(2, "big") + payload + data[2:]


def test_exif_orientation(tmp_path):
    data = _encode(_image(16, 24), quality=90)
    upright = _with_orientation(data, 1)
    _assert_decodes_like_cv2(upright, tmp_path)         # orientation 1: as is
    rotated = _with_orientation(data, 6)
    p = tmp_path / "r.jpg"
    p.write_bytes(rotated)
    assert cv2.imread(str(p)).shape[:2] == (24, 16)     # cv2 rotates it
    with pytest.raises(NotImplementedError, match="orientation 6.*A14c"):
        jpeg.read_jpeg(str(p))


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


def test_fixtures_equal_their_digests():
    """The committed fixtures (chip_smoke.py phase 4g decodes them on the
    card's machine, which has no cv2) decode to the stored digests of cv2's
    decode, here by both decoders."""
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        want = json.load(f)
    assert len(want) == 3
    for name, entry in want.items():
        path = os.path.join(FIXTURES, name)
        ref = cv2.imread(path)[..., ::-1]
        assert list(ref.shape) == entry["shape"] and _digest(ref) == entry["sha256"], name
        got = jpeg.read_jpeg(path)
        assert _digest(got) == entry["sha256"], name


def write_fixtures() -> None:
    """Write tests/data/jpeg/: a 968x1296 4:2:0 q95 tabletop frame (the
    synthetic archetype at a ScanNet colour camera), a small 4:4:4 file with
    restarts, a grey file with odd sizes, and digests.json (shape and
    SHA-256 of cv2's RGB decode of each)."""
    from openobj_torch.core.scene import Camera
    from openobj_torch.data import synthetic

    os.makedirs(FIXTURES, exist_ok=True)
    cam = Camera(width=1296, height=968, fx=1170.0, fy=1170.0, cx=647.5, cy=483.5)
    scene, orbit = synthetic.archetype_scene("tabletop")
    rgb, _, _ = scene.render(synthetic.orbit_pose(0.7, **orbit), cam.ray_dirs("cpu").numpy())
    files = {
        "tabletop_968x1296_q95_420.jpg": _encode(rgb, quality=95,
                                                 sampling_factor=SAMPLING["420"]),
        "small_444_rst.jpg": _encode(_image(40, 56, seed=9), quality=90, rst_interval=3,
                                     sampling_factor=SAMPLING["444"]),
        "grey_31x45.jpg": _encode(_image(31, 45, seed=10, grey=True), quality=80),
    }
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
