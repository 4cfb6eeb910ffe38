"""The port's perception CLIs (openobj_torch.perception.cli: maskgen,
associate, partfeat) and ``perception.auto`` against the JAX package's on
the same raw scene on disk, on the CPU (``--device cpu``).

Tolerance: none. Both packages' stages are host numpy in float64 (the
similarity matrices agree within 1e-6, far from any edge cut, so the graphs
are the same), so every artifact must be equal: mask_init_all.pkl, the
instance and class PNGs (read back with OpenCV here), object_*.pkl and the
part maps. The port's YAML reader and writer are held to PyYAML's
``safe_load``.
"""

import os
import pickle
import shutil
from dataclasses import asdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
yaml = pytest.importorskip("yaml")

from openobj_tpu.config import SceneConfig as JSceneConfig  # noqa: E402
from openobj_tpu.core.scene import Camera as JCamera  # noqa: E402
from openobj_tpu.core.trainer import TrainConfig as JTrainConfig  # noqa: E402
from openobj_tpu.perception import auto as jauto  # noqa: E402
from openobj_tpu.perception import cli as jcli  # noqa: E402
from openobj_tpu.perception.encoders import load_mask_init as jload  # noqa: E402
from openobj_torch.config import SceneConfig  # noqa: E402
from openobj_torch.core.scene import Camera  # noqa: E402
from openobj_torch.core.trainer import TrainConfig  # noqa: E402
from openobj_torch.data import synthetic  # noqa: E402
from openobj_torch.perception import auto as tauto  # noqa: E402
from openobj_torch.perception import cli as tcli  # noqa: E402
from openobj_torch.utils import yaml_subset  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

W, H, N_FRAMES = 64, 48, 20
CAM = dict(width=W, height=H, fx=0.65 * W, fy=0.65 * W, cx=W / 2.0, cy=H / 2.0)


def _write_scene(root, name):
    scene, orbit = synthetic.archetype_scene(name)
    dirs = Camera(**CAM).ray_dirs("cpu").numpy()
    return synthetic.write_raw_scene(root, scene, dirs, n_frames=N_FRAMES, orbit_kwargs=orbit,
                                     assoc_stride=tauto.keyframe_skip(N_FRAMES))


def _copies(tmp, name):
    """The raw scene and a copy for each package's stages."""
    src = str(tmp / "raw")
    gt = _write_scene(src, name)
    shutil.rmtree(os.path.join(src, "gt_instance"))       # held aside
    out = {}
    for pkg in ("jax", "torch"):
        out[pkg] = str(tmp / pkg)
        shutil.copytree(src, out[pkg])
    return out, gt


def _assert_trees_equal(a, b):
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for f in files:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith(".png"):
            np.testing.assert_array_equal(cv2.imread(pa, -1), cv2.imread(pb, -1))
        elif f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(pa), np.load(pb))
        elif f == "mask_init_all.pkl":
            ga, gb = jload(pa), jload(pb)
            assert sorted(ga) == sorted(gb)
            for k in ga:
                assert ga[k]["bbox"] == gb[k]["bbox"] and ga[k]["caption"] == gb[k]["caption"]
                for fld in ("mask", "capfeat", "clipfeat"):
                    assert len(ga[k][fld]) == len(gb[k][fld])
                    for x, y in zip(ga[k][fld], gb[k][fld]):
                        np.testing.assert_array_equal(x, y)
        elif f.endswith(".pkl"):
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                da, db = pickle.load(fa), pickle.load(fb)
            assert len(da) == len(db)
            for x, y in zip(da, db):
                assert sorted(x) == sorted(y)
                for k in x:
                    np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))
        elif f.endswith(".yaml"):
            with open(pa) as fa, open(pb) as fb:
                assert yaml.safe_load(fa) == yaml.safe_load(fb)
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), f



# --------------------------------------------------------------------------- #
# the three CLIs
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    roots, _ = _copies(tmp_path_factory.mktemp("cli"), "touching")
    common = ["--skip", "5", "--seg-stride", "1", "--clip-dim", "64", "--sbert-dim", "48"]
    for pkg, cli, dev in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
        r = roots[pkg]
        assert cli.maskgen_main([r, *common, *dev, "--min-px", "20", "--seg-min-size", "16",
                                 "--crop-pad", "2", "--seg-fx", str(CAM["fx"])]) == 0
        with open(os.path.join(r, "assoc.yaml"), "w") as f:
            f.write(f"skip: 5\nfx: {CAM['fx']}\nfy: {CAM['fy']}\ncx: {CAM['cx']}\n"
                    f"cy: {CAM['cy']}\nweight_pc: 0.4\ncontact_pc: 0.02\n")
        assert cli.associate_main([r, *dev, "--config", os.path.join(r, "assoc.yaml"),
                                   "--min-component-px", "20", "--dbscan-min-points", "10",
                                   "--dbscan-eps", "0.1", "--geo-bg", "--sbert-dim", "48",
                                   "--debug-overlays", os.path.join(r, "overlays")]) == 0
        assert cli.partfeat_main([r, *common, *dev, "--seg-min-size", "8", "--down", "4"]) == 0
    return roots


def test_cli_artifacts_equal(cli_runs):
    r = cli_runs["torch"]
    for d in ("instance_our", "class_our", "partlevel", "overlays/before", "overlays/after"):
        assert os.listdir(os.path.join(r, d)), d
    assert len(jload(os.path.join(r, "mask_init_all.pkl"))) == N_FRAMES // 5
    assert np.load(os.path.join(r, "partlevel", "5.npy")).shape == (H // 4, W // 4, 64)
    _assert_trees_equal(cli_runs["jax"], r)


def test_clis_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (tcli.maskgen_main, tcli.associate_main, tcli.partfeat_main):
        with pytest.raises((AssertionError, RuntimeError)):
            main([str(tmp_path)])


def test_scannet_jpg_colour_refused(tmp_path):
    """RawFrames on the ScanNet layout decodes color/*.jpg as the JAX
    package's (cv2) does, baseline and progressive; only what ScanNet never
    holds, an arithmetic-coded file, is refused."""
    for d in ("color", "depth"):
        os.makedirs(tmp_path / d)
    rng = np.random.default_rng(0)
    for i in range(2):
        cv2.imwrite(str(tmp_path / "color" / f"{i}.jpg"),
                    rng.integers(0, 256, (24, 40, 3)).astype(np.uint8),
                    [cv2.IMWRITE_JPEG_PROGRESSIVE, i])
        cv2.imwrite(str(tmp_path / "depth" / f"{i}.png"),
                    rng.integers(500, 3000, (24, 40)).astype(np.uint16))
    frames = tcli.RawFrames(str(tmp_path), "ScanNet")
    ref = jcli.RawFrames(str(tmp_path), "ScanNet")
    assert len(frames) == len(ref) == 2
    for i in range(2):
        for got, want in zip(frames[i], ref[i]):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    path = tmp_path / "color" / "1.jpg"
    data = path.read_bytes()
    i = data.index(b"\xff\xc2")
    path.write_bytes(data[:i + 1] + b"\xca" + data[i + 2:])   # SOF10: arithmetic, progressive
    with pytest.raises(NotImplementedError, match="arithmetic.*A14d"):
        frames[1]


def test_scannet_colour_brought_to_depth_size(tmp_path):
    """ScanNet's colour frames are larger than its depth frames: RawFrames
    resizes the colour to the depth camera, as the loader does, so the
    stages see the colour the trainer sees."""
    from openobj_torch.data.transforms import resize

    for d in ("color", "depth"):
        os.makedirs(tmp_path / d)
    rng = np.random.default_rng(1)
    cv2.imwrite(str(tmp_path / "color" / "0.jpg"),
                rng.integers(0, 256, (48, 80, 3)).astype(np.uint8))
    cv2.imwrite(str(tmp_path / "depth" / "0.png"),
                rng.integers(500, 3000, (24, 40)).astype(np.uint16))
    rgb, depth, _ = tcli.RawFrames(str(tmp_path), "ScanNet")[0]
    assert rgb.shape == (24, 40, 3) and depth.shape == (24, 40)
    want = resize(cv2.imread(str(tmp_path / "color" / "0.jpg"))[..., ::-1], (40, 24))
    np.testing.assert_array_equal(rgb, want)


# --------------------------------------------------------------------------- #
# the association YAML without PyYAML
# --------------------------------------------------------------------------- #

REFERENCE_YAML = """\
# Replica room_0 (the reference schema)
skip: 10
start: 0
use_num: -1
graph_method: weighted   # or threshold
if_bg: 1
gt_wall_id: 93
captions_wall: ['wall', "door frame", window]
captions_floor:
- floor
- 'rug # not a comment'
captions_ceiling: []
weight_geo: 0.30
threshold_geo: .5
cap_thre: 8.5e-1
dis_thre: 5e-2
depth_scale: 1000
fx: 600
cx: 599.5
if_bg_geo: false
note: null
tag: 'yes'
octal: 010
big: 1_000
neg: -2.5
inf: .inf
"""


def test_load_assoc_yaml_equals_safe_load(tmp_path):
    p = tmp_path / "room_0.yaml"
    p.write_text(REFERENCE_YAML)
    want = dict(jcli._YAML_DEFAULTS, **yaml.safe_load(REFERENCE_YAML))
    assert tcli._YAML_DEFAULTS == jcli._YAML_DEFAULTS
    got = tcli.load_assoc_yaml(str(p))
    assert got == want and got == jcli.load_assoc_yaml(str(p))
    assert [type(got[k]) for k in sorted(got)] == [type(want[k]) for k in sorted(want)]
    assert asdict(tcli._assoc_config_from_yaml(got)) == asdict(jcli._assoc_config_from_yaml(want))
    assert tcli.load_assoc_yaml(None) == jcli.load_assoc_yaml(None)
    for bad in ("a:\n  b: 1\n", "key: {a: 1}\n", "- x\n"):
        with pytest.raises(ValueError):
            yaml_subset.parse_flat(bad)


def test_dump_assoc_yaml_reads_back():
    cfg = {"skip": 2, "graph_method": "weighted", "depth_scale": 1000.0, "fx": 41.6,
           "weight_pc": 0.4, "contact_pc": 0.02, "tiny": 1e-05, "huge": 1e20, "neg": -3,
           "flag": True, "none": None, "captions_wall": ["wall", "door frame"],
           "odd": ["yes", "1.5", "a: b", "it's", ""], "empty": [], "inf": float("inf")}
    text = yaml_subset.dump_flat(cfg)
    assert yaml.safe_load(text) == cfg == yaml_subset.parse_flat(text)
    assert text == yaml.safe_dump(cfg)


# --------------------------------------------------------------------------- #
# perception.auto
# --------------------------------------------------------------------------- #


def test_scaled_knobs_and_keyframe_skip():
    for n, t in ((30, 10), (20, 10), (7, 10), (400, 10), (40, 6)):
        assert tauto.keyframe_skip(n, t) == jauto.keyframe_skip(n, t)
    for cam in (Camera(**CAM), Camera(width=1200, height=680, fx=600.0, fy=600.0,
                                      cx=599.5, cy=339.5)):
        assert tauto.scaled_knobs(cam, 8.0) == jauto.scaled_knobs(cam, 8.0)


def test_run_auto_perception_equal(tmp_path):
    roots, gt = _copies(tmp_path, "tabletop")
    tauto.run_auto_perception(SceneConfig(train=TrainConfig(part_mode=False), camera=Camera(**CAM),
                                          dataset_dir=roots["torch"]), device="cpu")
    jauto.run_auto_perception(JSceneConfig(train=JTrainConfig(part_mode=False),
                                           camera=JCamera(**CAM), dataset_dir=roots["jax"]))
    inst = [cv2.imread(os.path.join(roots["torch"], "instance_our",
                                    f"semantic_instance_{i}.png"), -1) for i in range(len(gt))]
    assert len(np.unique(np.stack(inst))) >= 4      # the table, objects, background
    _assert_trees_equal(roots["jax"], roots["torch"])
