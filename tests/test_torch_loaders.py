"""The port's dataset loaders (openobj_torch.data.loaders) and its OpenCV-free
image transforms against the JAX package's, on the CPU.

The Replica fixture is tests/test_dataset_cli.py's, written by the test.
Tolerances, against OpenCV (which the JAX loader calls and the port does
not): nearest resize and nearest remap bit for bit; bilinear resize and
remap of 8-bit colour within 1 level (OpenCV's 8-bit path is fixed point);
the part-feature 2x bilinear downsample within 1e-6; undistortion maps
within 1e-4 px. Everything else in a loaded sample is equal.
"""

import json
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from openobj_tpu.config import load_scene_config as jload  # noqa: E402
from openobj_tpu.data import loaders as jl  # noqa: E402
from openobj_tpu.data import transforms as jtf  # noqa: E402
from openobj_torch.config import load_scene_config as tload  # noqa: E402
from openobj_torch.data import loaders as tl  # noqa: E402
from openobj_torch.data import transforms as ttf  # noqa: E402
from test_dataset_cli import H, W, _config_json, write_replica_dataset  # noqa: E402

RGB_LSB = 1
PART_ATOL = 1e-6
MAP_ATOL = 1e-4


def assert_samples_equal(a, b, rgb_lsb=0):
    assert a.frame_id == b.frame_id
    if rgb_lsb:
        assert np.abs(a.rgb.astype(int) - b.rgb.astype(int)).max() <= rgb_lsb
    else:
        np.testing.assert_array_equal(a.rgb, b.rgb)
    assert a.rgb.dtype == b.rgb.dtype == np.uint8
    np.testing.assert_array_equal(a.depth, b.depth)
    assert a.depth.dtype == b.depth.dtype
    np.testing.assert_array_equal(a.inst, b.inst)
    assert a.inst.dtype == b.inst.dtype
    np.testing.assert_array_equal(a.t_wc, b.t_wc)
    assert a.bboxes == b.bboxes
    for da, db in ((a.obj_clip, b.obj_clip), (a.obj_cap, b.obj_cap)):
        assert sorted(da) == sorted(db)
        for k in da:
            np.testing.assert_array_equal(da[k], db[k])
    if a.part_feat is None:
        assert b.part_feat is None
    else:
        np.testing.assert_allclose(a.part_feat, b.part_feat, rtol=0, atol=PART_ATOL)


@pytest.fixture(scope="module")
def replica(tmp_path_factory):
    root = tmp_path_factory.mktemp("replica") / "scene"
    write_replica_dataset(str(root), n_raw_frames=30)
    return str(root)


def test_replica_samples_equal(replica):
    kw = dict(stride=10, part_mode=True, part_down=5)
    t, j = tl.Replica(replica, **kw), jl.Replica(replica, **kw)
    assert len(t) == len(j) == 3
    assert t.assoc_stride == j.assoc_stride
    got = list(tl.init_loader(t))
    for i, s in enumerate(got):
        assert_samples_equal(s, j[i])
    assert set(np.unique(got[0].inst)) <= {-1, 0, 4, 5}


def test_imap_mode_and_start(replica):
    for kw in (dict(imap_mode=True), dict(start=3, stride=7)):
        t, j = tl.Replica(replica, **kw), jl.Replica(replica, **kw)
        assert len(t) == len(j)
        assert_samples_equal(t[len(t) - 1], j[len(j) - 1])


def test_resized_frames(tmp_path):
    """Colour and instance maps at another resolution than depth: the
    loaders bring them to depth's, bilinear and nearest."""
    root = tmp_path / "scene"
    write_replica_dataset(str(root), n_raw_frames=20)
    for i in range(20):
        p = root / "rgb" / f"rgb_{i}.png"
        cv2.imwrite(str(p), cv2.resize(cv2.imread(str(p)), (W * 2 - 6, H * 2 + 3)))
    for i in range(2):
        p = root / "instance_our" / f"semantic_instance_{i}.png"
        im = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
        cv2.imwrite(str(p), cv2.resize(im, (W + 17, H - 5), interpolation=cv2.INTER_NEAREST))
    t, j = tl.Replica(str(root)), jl.Replica(str(root))
    for i in range(len(t)):
        assert_samples_equal(t[i], j[i], rgb_lsb=RGB_LSB)


def test_resize_against_opencv():
    rng = np.random.default_rng(0)
    for _ in range(60):
        h, w = (int(x) for x in rng.integers(2, 70, 2))
        oh, ow = (int(x) for x in rng.integers(2, 70, 2))
        ids = rng.integers(0, 65535, (h, w)).astype(np.uint16)
        np.testing.assert_array_equal(
            ttf.resize(ids, (ow, oh), nearest=True),
            cv2.resize(ids, (ow, oh), interpolation=cv2.INTER_NEAREST))
        rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        d = ttf.resize(rgb, (ow, oh)).astype(int) - cv2.resize(
            rgb, (ow, oh), interpolation=cv2.INTER_LINEAR).astype(int)
        assert np.abs(d).max() <= RGB_LSB
        pf = rng.normal(size=(h, w, 8)).astype(np.float32)
        half = (max(w // 2, 1), max(h // 2, 1))
        want = np.stack([cv2.resize(pf[..., c], half, interpolation=cv2.INTER_LINEAR)
                         for c in range(8)], -1)
        np.testing.assert_allclose(ttf.resize(pf, half), want, rtol=0, atol=PART_ATOL)


def _scannet(root, colour_ext, rng_seed=0):
    """tests/test_dataset_cli.py's ScanNet fixture, with colour frames as
    .jpg (the dataset's layout) or .png."""
    for d in ("color", "depth", "instance_our", "partlevel", "intrinsic"):
        os.makedirs(root / d, exist_ok=True)
    rng = np.random.default_rng(rng_seed)
    h, w, n_raw = 48, 64, 30
    for i in range(n_raw):
        cv2.imwrite(str(root / "color" / f"{i}.{colour_ext}"),
                    rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
        cv2.imwrite(str(root / "depth" / f"{i}.png"),
                    (rng.uniform(0.5, 3.0, (h, w)) * 1000).astype(np.uint16))
        np.save(str(root / "partlevel" / f"{i}.npy"),
                rng.normal(size=(h // 5, w // 5, 8)).astype(np.float32))
    for ino in range(3):
        inst = np.ones((h, w), np.uint16)
        inst[10:30, 20:50] = 4
        cv2.imwrite(str(root / "instance_our" / f"semantic_instance_{ino}.png"), inst)
    np.savetxt(str(root / "traj_w_c.txt"), np.stack([np.eye(4).reshape(-1)] * n_raw),
               delimiter=" ")
    feats = {1: rng.normal(size=512), 4: rng.normal(size=512)}
    cfeats = {1: rng.normal(size=384), 4: rng.normal(size=384)}
    with open(root / "object_clipfeat.pkl", "wb") as f:
        pickle.dump([feats] * 3, f)
    with open(root / "object_capfeat.pkl", "wb") as f:
        pickle.dump([cfeats] * 3, f)


def test_scannet_png_colour_and_part_downsample(tmp_path):
    """part_down=10: the 9x12 part map is downsampled 2x (odd height: the
    bilinear path, not OpenCV's 2x2 average)."""
    _scannet(tmp_path / "png", "png")
    _scannet(tmp_path / "jpg", "jpg")
    t = tl.ScanNet(str(tmp_path / "png"), stride=10, part_mode=True, part_down=10)
    j = jl.ScanNet(str(tmp_path / "jpg"), stride=10, part_mode=True, part_down=10)
    assert len(t) == len(j) == 3
    for i in range(3):
        a, b = t[i], j[i]
        np.testing.assert_array_equal(
            a.rgb, cv2.imread(str(tmp_path / "png" / "color" / f"{a.frame_id}.png"))[..., ::-1])
        b.rgb = a.rgb                 # JPEG is lossy: colour compared above
        assert a.part_feat.shape == (4, 6, 8)
        assert_samples_equal(a, b)


def test_scannet_jpeg_colour_raises(tmp_path):
    _scannet(tmp_path / "jpg", "jpg")
    ds = tl.ScanNet(str(tmp_path / "jpg"), stride=10)
    assert len(ds) == 3
    with pytest.raises(NotImplementedError, match="A14b"):
        ds[0]


# --------------------------------------------------------------------------- #
# undistortion: the cases of tests/test_dataset_cli.py (TestUndistortion)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dist", [
    [0.3] + [0.0] * 7,
    [0.2, 0.1, 0.01, 0.02, 0.0, 0.0, 0.0, 0.0],
    [-0.28, 0.07, 0.001, -0.002, 0.01, 0.1, 0.02, 0.003],
    [0.0] * 8,
])
def test_undistort_maps_and_remap_against_opencv(dist):
    rng = np.random.default_rng(5)
    for w, h, f in ((W, H, 40.0), (160, 120, 100.0)):
        got = ttf.undistort_maps(w, h, f, f + 1.0, w / 2 - 0.5, h / 2 + 0.25, dist)
        want = jtf.undistort_maps(w, h, f, f + 1.0, w / 2 - 0.5, h / 2 + 0.25, dist)
        for a, b in zip(got, want):
            assert a.dtype == np.float32 and a.shape == (h, w)
            np.testing.assert_allclose(a, b, rtol=0, atol=MAP_ATOL)
        depth = rng.uniform(0, 5000, (h, w)).astype(np.float32)
        ids = rng.integers(0, 9, (h, w)).astype(np.float32)
        rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        np.testing.assert_array_equal(ttf.undistort(depth, want, nearest=True),
                                      jtf.undistort(depth, want, nearest=True))
        np.testing.assert_array_equal(ttf.undistort(ids, want, nearest=True),
                                      jtf.undistort(ids, want, nearest=True))
        d = ttf.undistort(rgb, want).astype(int) - jtf.undistort(rgb, want).astype(int)
        assert np.abs(d).max() <= RGB_LSB


def _configs(root, tmp_path, **edit):
    p = _config_json(root, tmp_path)
    cfg = json.load(open(p))
    for k, v in edit.items():
        sec, key = k.split("__")
        cfg[sec][key] = v
    json.dump(cfg, open(p, "w"))
    return p


@pytest.mark.parametrize("edit", [
    dict(camera__distortion=[0.3] + [0.0] * 7, dataset__undistort=1),
    dict(camera__distortion=[0.0] * 8, dataset__undistort=1),
    dict(camera__distortion=[0.3] + [0.0] * 7),                 # parsed, not applied
    dict(camera__k1=0.2, camera__k2=0.1, camera__k3=0.0, camera__p1=0.01,
         camera__p2=0.02, dataset__undistort=1),                 # k1..p2, k4-k6 default 0
])
def test_undistorting_loader_matches(edit, tmp_path):
    root = str(tmp_path / "scene")
    write_replica_dataset(root, n_raw_frames=20)
    p = _configs(root, tmp_path, **edit)
    tc, jc = tload(p), jload(p)
    assert tc.distortion == jc.distortion and tc.undistort == jc.undistort
    t, j = tl.make_dataset(tc), jl.make_dataset(jc)
    for i in range(len(t)):
        assert_samples_equal(t[i], j[i], rgb_lsb=RGB_LSB)
    if edit.get("dataset__undistort") and any(edit.get("camera__distortion", [1])):
        plain = tl.Replica(root)[0]
        assert not np.array_equal(plain.inst, t[0].inst)
        assert set(np.unique(t[0].inst)) <= set(np.unique(plain.inst)) | {-1}


def test_undistort_size_mismatch_raises(tmp_path):
    root = str(tmp_path / "scene")
    write_replica_dataset(root, n_raw_frames=20)
    p = _configs(root, tmp_path, camera__distortion=[0.3] + [0.0] * 7,
                 dataset__undistort=1, camera__w=W + 8)
    with pytest.raises(ValueError, match="undistort"):
        tl.make_dataset(tload(p))[0]
