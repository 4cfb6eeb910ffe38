"""A run's outputs, port against the JAX package: checkpoints, renders and
meshes of one mapper, the PNG codec, evaluation, export, synthetic scenes
and oriented boxes.

The mappers ingest the same synthetic frames (no training), the port's
state is the JAX state carried across by ``convert``, and the renderer's
jitter is replayed from the JAX key splits (``test_torch_renderer``). The
JAX package finds boxes with OpenCV's min-area rectangle where OpenCV is
installed; the port always uses its rotating-calipers path, which the JAX
package takes without OpenCV, so the tests disable OpenCV on the JAX side
where two boxes must be equal. PNGs are read back with OpenCV (the tests
only) and must agree within 1 LSB; meshes have equal faces and vertices
within 5e-5 m: the background's box is 6 m wide at grid 16 (0.4 m voxels),
and where the occupancy changes slowly between two grid nodes, the 1e-6 by
which the two fields' occupancies differ moves an interpolated vertex by up
to ~2e-5 m.
"""

import glob
import os
import struct
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import openobj_tpu.utils.geometry as jgeom  # noqa: E402
from openobj_tpu import eval as jeval  # noqa: E402
from openobj_tpu import train as jtrain  # noqa: E402
from openobj_tpu.core import renderer as jr  # noqa: E402
from openobj_tpu.core import scene as jscene  # noqa: E402
from openobj_tpu.core import trainer as jtrainer  # noqa: E402
from openobj_tpu.data import synthetic as jsyn  # noqa: E402
from openobj_tpu.viz import export as jexport  # noqa: E402
from openobj_torch import convert  # noqa: E402
from openobj_torch import eval as teval  # noqa: E402
from openobj_torch import train as ttrain  # noqa: E402
from openobj_torch.core import renderer as tr  # noqa: E402
from openobj_torch.core import scene as tscene  # noqa: E402
from openobj_torch.core import trainer as ttrainer  # noqa: E402
from openobj_torch.data import synthetic as tsyn  # noqa: E402
from openobj_torch.ops import fused_field as tff  # noqa: E402
from openobj_torch.utils import geometry as tgeom  # noqa: E402
from openobj_torch.utils import png  # noqa: E402
from openobj_torch.viz import export as texport  # noqa: E402
from test_torch_renderer import Replay, batched_draws, obb_draws  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

CFG_KW = dict(n_iters_per_frame=2, win_size=2, n_samples_per_frame=8, win_size_bg=2,
              n_samples_per_frame_bg=16, hidden=32, hidden_bg=16, clip_size=16)
CAM_KW = dict(width=48, height=36, fx=30.0, fy=30.0, cx=24.0, cy=18.0)
N_BINS, CHUNK = 16, 64
VERT_ATOL = 5e-5


def _mappers():
    """JAX and port mappers over the same frames, untrained, with the same
    fields (a little noise on the MLPs and a positive alpha bias, so that
    objects render opaque)."""
    jcfg, tcfg = jtrainer.TrainConfig(**CFG_KW), ttrainer.TrainConfig(**CFG_KW)
    jm = jscene.SceneMapper(jscene.Camera(**CAM_KW), jcfg, frame_capacity=4,
                            max_objects=8, initial_bucket=4)
    tm = tscene.SceneMapper(tscene.Camera(**CAM_KW), tcfg, frame_capacity=4,
                            max_objects=8, initial_bucket=4, device="cpu")
    dirs = np.asarray(jm.camera.ray_dirs())
    scene = jsyn.default_scene(n_spheres=2)
    poses = []
    for rgb, depth, inst, t_wc in jsyn.make_sequence(scene, dirs, 3):
        jm.process_frame(rgb, depth, inst, t_wc, train=False)
        tm.process_frame(rgb, depth, inst, t_wc, train=False)
        poses.append(t_wc)
    rng = np.random.default_rng(0)
    st = jax.tree.map(np.asarray, jm.state)
    for p in (st.fg_params, st.bg_params):
        p["mlp"] = jax.tree.map(
            lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32), p["mlp"])
        p["mlp"]["out_alpha"]["b"] = np.full_like(p["mlp"]["out_alpha"]["b"], 0.5)
    jm.state = jax.tree.map(jnp.asarray, st)
    tm.state = convert.train_state_from_numpy(st, "cpu")
    return jm, tm, scene, dirs, poses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' save_checkpoints, render_dataset and export_meshes."""
    root = tmp_path_factory.mktemp("runs")
    jm, tm, scene, dirs, poses = _mappers()
    mp = pytest.MonkeyPatch()
    calls = []
    orig_b, orig_v = jr.render_frame_batched, jr.render_object_view

    def rec_batched(params, t_wo, *args, **kw):
        calls.append(("batched", args[-1], t_wo.shape[0], kw["max_hit_rays"], kw["n_bins"]))
        return orig_b(params, t_wo, *args, **kw)

    def rec_view(*args, **kw):
        calls.append(("view", args[5], None, None, kw["n_bins"]))
        return orig_v(*args, **kw)

    try:
        mp.setattr(jgeom, "cv2", None)
        mp.setattr(jr, "render_frame_batched", rec_batched)
        mp.setattr(jr, "render_object_view", rec_view)
        dataset = [SimpleNamespace(t_wc=poses[i], frame_id=i) for i in (0, 2)]
        mapping = {4: 11, 5: 12, 0: 13}
        h, w = CAM_KW["height"], CAM_KW["width"]
        jd, td = str(root / "jax"), str(root / "port")
        jtrain.save_checkpoints(jm, jd, poses[-1])
        jtrain.render_dataset(jm, dataset, jd, mapping, n_bins=N_BINS, chunk=CHUNK)
        n_j = jtrain.export_meshes(jm, jd, 16, 0.05)
        draws = []
        for kind, key, o, m, nb in calls:
            draws += (batched_draws(key, o, m, CHUNK, nb) if kind == "batched"
                      else obb_draws(key, h * w, 4096, nb))
        mp.setattr(tr, "_uniform", Replay(draws))
        ttrain.save_checkpoints(tm, td, poses[-1])
        tff.reset_counts()
        ttrain.render_dataset(tm, dataset, td, mapping, n_bins=N_BINS, chunk=CHUNK)
        counts = dict(tff.COUNTS)
        n_t = ttrain.export_meshes(tm, td, 16, 0.05)
        assert tr._uniform.draws == []
    finally:
        mp.undo()
    return SimpleNamespace(jd=jd, td=td, n_j=n_j, n_t=n_t, jm=jm, tm=tm, scene=scene,
                           dirs=dirs, dataset=dataset, calls=calls, counts=counts)


def test_save_checkpoints_match(runs):
    fj = sorted(os.path.relpath(p, runs.jd) for p in glob.glob(f"{runs.jd}/ckpt/*/*.npz"))
    ft = sorted(os.path.relpath(p, runs.td) for p in glob.glob(f"{runs.td}/ckpt/*/*.npz"))
    assert fj == ft and len(fj) == 3          # two spheres and the background
    for f in fj:
        zj, zt = np.load(os.path.join(runs.jd, f)), np.load(os.path.join(runs.td, f))
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype, k
            np.testing.assert_allclose(zt[k], zj[k], atol=1e-6, err_msg=f"{f}:{k}")
    for name in ("cam_pose/twc_frame.npz",):
        np.testing.assert_array_equal(np.load(os.path.join(runs.td, name))["twc"],
                                      np.load(os.path.join(runs.jd, name))["twc"])


def test_render_dataset_matches(runs):
    # one fg field call per chunk, all objects at once; the bg model per chunk
    fg_chunks = sum(-(-m // CHUNK) for kind, _, _, m, _ in runs.calls if kind == "batched")
    bg_chunks = sum(1 for kind, *_ in runs.calls if kind == "view")
    assert runs.counts["fused_field_plain"] == fg_chunks + bg_chunks
    assert runs.counts["field_eager"] == 0
    names = sorted(os.path.basename(p) for p in glob.glob(f"{runs.jd}/render/*.png"))
    assert names == sorted(os.path.basename(p) for p in glob.glob(f"{runs.td}/render/*.png"))
    assert len(names) == 8
    for name in names:
        a = cv2.imread(os.path.join(runs.jd, "render", name), -1).astype(np.int64)
        b = cv2.imread(os.path.join(runs.td, "render", name), -1).astype(np.int64)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a - b).max() <= 1, name
    ids = {int(i) for p in glob.glob(f"{runs.td}/render/inst_*.png")
           for i in np.unique(cv2.imread(p, -1))}
    assert {0, 4} <= ids <= {0, 4, 5}      # the (untrained) background paints over much
    with open(os.path.join(runs.td, "render", "mapping_class.json")) as f:
        assert f.read() == open(os.path.join(runs.jd, "render", "mapping_class.json")).read()


def _read_obj(path):
    v, f = [], []
    for line in open(path):
        parts = line.split()
        if parts[0] == "v":
            v.append([float(x) for x in parts[1:]])
        elif parts[0] == "f":
            f.append([int(x) for x in parts[1:]])
    return np.asarray(v), np.asarray(f)


def test_export_meshes_match(runs):
    assert runs.n_t == runs.n_j == 2
    for path in glob.glob(f"{runs.jd}/scene_mesh/*.obj"):
        vj, fj = _read_obj(path)
        vt, ft = _read_obj(os.path.join(runs.td, "scene_mesh", os.path.basename(path)))
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_allclose(vt[:, :3], vj[:, :3], atol=VERT_ATOL)
        assert np.abs(vt[:, 3:] - vj[:, 3:]).max() <= 1 / 255 + 1e-9


def test_evaluate_run_matches(runs, tmp_path):
    gt = tmp_path / "gt"
    os.makedirs(gt)
    for s in runs.dataset:
        rgb, depth, _ = runs.scene.render(s.t_wc, runs.dirs)
        cv2.imwrite(str(gt / f"rgb_{s.frame_id}.png"), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(gt / f"depth_{s.frame_id}.png"), (depth * 1000).astype(np.uint16))
    for d in (runs.jd, runs.td):
        ref = jeval.evaluate_run(os.path.join(d, "render"), str(gt), str(gt), None, 20)
        got = teval.evaluate_run(os.path.join(d, "render"), str(gt), str(gt), None, 20)
        assert got.keys() == ref.keys() == {"psnr", "depth_l1"}
        for k in ref:
            assert got[k] == pytest.approx(ref[k], rel=1e-12)


def test_evaluate_run_reads_colour_as_cv2(tmp_path):
    """Ground-truth and rendered colour are read as cv2.imread reads them
    by default (IMREAD_COLOR): RGBA, 16-bit RGB, grey and palette
    ground-truth frames and an RGBA render give the JAX evaluate_run's
    PSNR. Read unchanged, they would not have the render's shape."""
    from test_torch_png import encode

    rng = np.random.default_rng(9)
    render, gt = tmp_path / "render", tmp_path / "gt"
    os.makedirs(render)
    os.makedirs(gt)
    h, w = 12, 16
    truth = rng.integers(0, 256, (4, h, w, 3))
    pal = rng.integers(0, 256, (16, 3))
    idx = rng.integers(0, 16, (h, w))
    truth[3] = pal[idx]
    gt_files = [encode(np.concatenate([truth[0], rng.integers(0, 256, (h, w, 1))], -1), 8, 6),
                encode(truth[1] * 257 + rng.integers(0, 256, (h, w, 3)), 16, 2, interlace=1),
                encode(truth[2][..., 1], 8, 0),
                encode(idx, 4, 3, plte=pal, trns=bytes(range(0, 160, 10)))]
    for i, data in enumerate(gt_files):
        (gt / f"rgb_{i}.png").write_bytes(data)
        noisy = np.clip(truth[i] + rng.integers(-9, 10, (h, w, 3)), 0, 255)
        render_rgb = (encode(np.concatenate([noisy, np.full((h, w, 1), 200)], -1), 8, 6)
                      if i == 0 else png.encode_png(noisy.astype(np.uint8)))
        (render / f"rgb_{i}.png").write_bytes(render_rgb)
    ref = jeval.evaluate_run(str(render), str(gt), None, None, 20)
    got = teval.evaluate_run(str(render), str(gt), None, None, 20)
    assert got.keys() == ref.keys() == {"psnr"}
    assert got["psnr"] == pytest.approx(ref["psnr"], rel=1e-12)
    assert png.read_png(str(gt / "rgb_0.png")).shape == (h, w, 4)


def test_evaluate_run_skips_unreadable_renders(tmp_path):
    """A maskid render cut short and an instance render whose IDAT fails its
    CRC read as None (as cv2.imread reads them): both packages skip that
    frame's semantic rows and the other frame's instance and semantic rows,
    and the metrics agree. The same run with the renders intact scores
    otherwise, so the rows were skipped."""
    rng = np.random.default_rng(4)
    render, gt = tmp_path / "render", tmp_path / "gt"
    os.makedirs(render)
    os.makedirs(gt)
    h, w = 12, 16
    (render / "mapping_class.json").write_text('{"0": 2, "4": 5, "5": 7, "6": 5}')
    intact = {}
    for i in range(3):
        truth = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        (gt / f"rgb_{i}.png").write_bytes(png.encode_png(truth))
        noisy = np.clip(truth + rng.integers(-9, 10, (h, w, 3)), 0, 255).astype(np.uint8)
        (render / f"rgb_{i}.png").write_bytes(png.encode_png(noisy))
        gi = rng.choice([0, 1, 2, 4, 5, 6], (h, w)).astype(np.uint16)
        pi = np.where(rng.random((h, w)) < 0.8, gi, rng.choice([0, 4, 5, 6], (h, w)))
        (gt / f"semantic_instance_{i}.png").write_bytes(png.encode_png(gi))
        for name, im in ((f"inst_{i}.png", pi.astype(np.uint16)),
                         (f"maskid_{i}.png", rng.integers(0, 9, (h, w)).astype(np.uint16))):
            intact[name] = png.encode_png(im)
            (render / name).write_bytes(intact[name])

    def run(pkg):
        return pkg.evaluate_run(str(render), str(gt), None, None, 9, gt_inst_dir=str(gt))

    whole = run(jeval)
    data = intact["maskid_1.png"]
    (render / "maskid_1.png").write_bytes(data[:len(data) // 2])
    data = bytearray(intact["inst_2.png"])
    idat = data.index(b"IDAT")
    data[idat + 4 + struct.unpack(">I", data[idat - 4:idat])[0]] ^= 1
    (render / "inst_2.png").write_bytes(bytes(data))
    for name in ("maskid_1.png", "inst_2.png"):
        assert cv2.imread(str(render / name), -1) is None
    ref, got = run(jeval), run(teval)
    assert got.keys() == ref.keys() == whole.keys() and "inst_miou" in ref and "miou" in ref
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-12), k
    assert ref["miou"] != whole["miou"] and ref["inst_miou"] != whole["inst_miou"]


def test_eval_functions_equal():
    rng = np.random.default_rng(0)
    pred = rng.integers(0, 6, (5, 12, 16))
    gt = np.where(rng.random((5, 12, 16)) < 0.7, pred, rng.integers(0, 6, (5, 12, 16)))
    a, b = rng.random((12, 16, 3)), rng.random((12, 16, 3))
    m = rng.random((12, 16)) < 0.5
    assert teval.psnr(a, b, m) == jeval.psnr(a, b, m)
    assert teval.depth_l1(a[..., 0], b[..., 0]) == jeval.depth_l1(a[..., 0], b[..., 0])
    np.testing.assert_array_equal(teval.confusion_matrix(pred[0], gt[0], 6),
                                  jeval.confusion_matrix(pred[0], gt[0], 6))
    np.testing.assert_equal(teval.evaluate_semantic_maps(list(pred), list(gt), 6),
                            jeval.evaluate_semantic_maps(list(pred), list(gt), 6))
    np.testing.assert_equal(teval.evaluate_instance_maps(list(pred), list(gt)),
                            jeval.evaluate_instance_maps(list(pred), list(gt)))
    np.testing.assert_equal(teval.matched_instance_miou(list(pred + 3), list(gt)),
                            jeval.matched_instance_miou(list(pred + 3), list(gt)))
    imgs = [(x * 255).astype(np.uint8) for x in (a, b)]
    np.testing.assert_equal(
        teval.evaluate_renders(imgs, imgs[::-1], [a[..., 0]] * 2, [b[..., 0]] * 2),
        jeval.evaluate_renders(imgs, imgs[::-1], [a[..., 0]] * 2, [b[..., 0]] * 2))
    scores = [{i: float(rng.random()) for i in range(6)} for _ in range(4)]
    np.testing.assert_equal(teval.retrieval_metrics(scores, [1, [2, 3], 0, 5]),
                            jeval.retrieval_metrics(scores, [1, [2, 3], 0, 5]))


def _filtered_png(img, ftype):
    """PNG bytes of an 8-bit RGB image with every row under one filter."""
    import struct
    import zlib

    h, w, _ = img.shape
    x = img.reshape(h, -1).astype(np.int64)
    rows = []
    for y in range(h):
        prior = x[y - 1] if y else np.zeros_like(x[0])
        left = np.concatenate([np.zeros(3, np.int64), x[y, :-3]])
        up_left = np.concatenate([np.zeros(3, np.int64), prior[:-3]])
        if ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prior
        elif ftype == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - up_left
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, up_left))
        rows.append(bytes([ftype]) + ((x[y] - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def test_png_codec(tmp_path):
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (9, 13, 3)).astype(np.uint8),
              rng.integers(0, 65536, (7, 5)).astype(np.uint16)]
    for i, img in enumerate(images):
        path = str(tmp_path / f"a{i}.png")
        png.write_png(path, img)
        back = png.read_png(path)
        assert back.dtype == img.dtype and np.array_equal(back, img)
        c = cv2.imread(path, -1)           # OpenCV reads the port's file ...
        assert np.array_equal(c[..., ::-1] if c.ndim == 3 else c, img)
        path2 = str(tmp_path / f"b{i}.png")  # ... and the port OpenCV's
        cv2.imwrite(path2, img[..., ::-1] if img.ndim == 3 else img)
        assert np.array_equal(png.read_png(path2), img)
    smooth = np.stack(np.meshgrid(np.arange(13) * 9, np.arange(9) * 17), -1)
    smooth = np.concatenate([smooth, smooth.sum(-1, keepdims=True)], -1) % 256
    for ftype in (1, 2, 3, 4):              # every row filter other writers use
        data = _filtered_png(smooth.astype(np.uint8), ftype)
        assert np.array_equal(png.decode_png(data), smooth)
        ocv = cv2.imdecode(np.frombuffer(data, np.uint8), -1)[..., ::-1]
        assert np.array_equal(ocv, smooth)
    grey8 = rng.integers(0, 256, (6, 4)).astype(np.uint8)   # others write it; the port reads it
    cv2.imwrite(str(tmp_path / "g8.png"), grey8)
    assert np.array_equal(png.read_png(str(tmp_path / "g8.png")), grey8)
    for bad in (np.zeros((2, 2, 3), np.float32), grey8):
        with pytest.raises(ValueError):
            png.encode_png(bad)


def test_synthetic_scenes_match(tmp_path):
    dirs = np.asarray(jscene.Camera(**CAM_KW).ray_dirs())
    for name in ("tabletop", "nonconvex"):
        a = jsyn.archetype_scene(name)[0].render(jsyn.orbit_pose(0.3), dirs)
        b = tsyn.archetype_scene(name)[0].render(tsyn.orbit_pose(0.3), dirs)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    sj, st = tmp_path / "j", tmp_path / "t"
    gj = jsyn.write_raw_scene(str(sj), jsyn.default_scene(), dirs, n_frames=3, assoc_stride=2)
    gt = tsyn.write_raw_scene(str(st), tsyn.default_scene(), dirs, n_frames=3, assoc_stride=2)
    np.testing.assert_array_equal(np.stack(gt), np.stack(gj))
    files = sorted(os.path.relpath(p, sj) for p in glob.glob(f"{sj}/**/*.*", recursive=True))
    assert files == sorted(os.path.relpath(p, st)
                           for p in glob.glob(f"{st}/**/*.*", recursive=True))
    for f in files:
        if f.endswith(".png"):
            np.testing.assert_array_equal(cv2.imread(str(st / f), -1), cv2.imread(str(sj / f), -1))
        else:
            assert open(st / f).read() == open(sj / f).read()


def test_oriented_bounds(monkeypatch):
    pts = np.random.default_rng(3).normal(size=(200, 3)) * [0.5, 0.2, 0.1]
    rot = jgeom._rot_to_z(np.array([0.3, -0.2, 0.9]))
    pts = pts @ rot.T + [0.5, 1.0, 2.0]
    with_cv2 = jgeom.oriented_bounds(pts, min_extent=0.05)
    got = tgeom.oriented_bounds(pts, min_extent=0.05)
    # OpenCV's rectangle and the calipers' find the same minimum
    assert got.volume == pytest.approx(with_cv2.volume, rel=1e-4)
    monkeypatch.setattr(jgeom, "cv2", None)
    ref = jgeom.oriented_bounds(pts, min_extent=0.05)
    for k in ("center", "r", "extent"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
    np.testing.assert_array_equal(got.corners, ref.corners)
    assert np.array_equal(got.contains(pts), ref.contains(pts)) and got.contains(pts).all()


def test_export_matches(runs, tmp_path):
    kw = dict(grid_dim=16, live_voxel_size=0.05, hidden=32, hidden_bg=16, clip_size=16)
    ref = jexport.export_from_checkpoints(os.path.join(runs.jd, "ckpt"), "", **kw)
    out = str(tmp_path / "map.pkl.gz")
    got = texport.export_from_checkpoints(os.path.join(runs.td, "ckpt"), out, device="cpu", **kw)
    assert got.keys() == ref.keys() and len(got) >= 2
    for oid in ref:
        a, b = got[oid], ref[oid]
        np.testing.assert_array_equal(a["mesh"]["faces"], b["mesh"]["faces"])
        np.testing.assert_allclose(a["mesh"]["vertices"], b["mesh"]["vertices"],
                                   atol=VERT_ATOL)
        # unit vectors, evaluated at vertices up to VERT_ATOL apart
        np.testing.assert_allclose(a["part_feat"], b["part_feat"], atol=1e-3)
        assert np.abs(a["color"].astype(int) - b["color"].astype(int)).max() <= 1
        assert a["class_id"] == b["class_id"]
    # the port's bundle loads in both packages, and the JAX one in the port
    for bundle in (texport.load_map_bundle(out), jexport.load_map_bundle(out)):
        assert bundle.keys() == got.keys()
    jpath = str(tmp_path / "jmap.pkl.gz")
    jexport.save_map_bundle(jpath, ref)
    np.testing.assert_equal(texport.load_map_bundle(jpath), jexport.load_map_bundle(jpath))
    with pytest.raises(FileNotFoundError):
        texport.export_from_checkpoints(str(tmp_path), "", device="cpu")
