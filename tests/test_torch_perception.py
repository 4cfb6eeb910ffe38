"""The port's instance association (openobj_torch.perception) against the
JAX package's on the same numpy inputs, on the CPU.

Tolerances: the similarity matrices within 1e-6 (both FP32; sums may run
in another order); hit boxes, DBSCAN labels, connected components, Louvain
labels, second-stage mappings, associations and written artifacts equal.
The port's DBSCAN is held to scikit-learn's and its components to OpenCV's,
which the port does not import and this test does.
"""

import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
sklearn_cluster = pytest.importorskip("sklearn.cluster")

import jax.numpy as jnp  # noqa: E402

from openobj_tpu.perception import graph as jgraph  # noqa: E402
from openobj_tpu.perception import merge as jmerge  # noqa: E402
from openobj_tpu.perception import pipeline as jpipe  # noqa: E402
from openobj_tpu.perception import projection as jproj  # noqa: E402
from openobj_tpu.perception import similarity as jsim  # noqa: E402
from openobj_torch.core.scene import Camera  # noqa: E402
from openobj_torch.data import synthetic  # noqa: E402
from openobj_torch.perception import graph as tgraph  # noqa: E402
from openobj_torch.perception import merge as tmerge  # noqa: E402
from openobj_torch.perception import pipeline as tpipe  # noqa: E402
from openobj_torch.perception import projection as tproj  # noqa: E402
from openobj_torch.perception import similarity as tsim  # noqa: E402
from openobj_torch.utils.dbscan import dbscan_labels  # noqa: E402

SIM_ATOL = 1e-6


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def _boxes(rng, m):
    lo = rng.uniform(-2, 2, (m, 3))
    return np.concatenate([lo, lo + rng.uniform(0.05, 1.5, (m, 3))], 1)


# --------------------------------------------------------------------------- #
# similarity matrices
# --------------------------------------------------------------------------- #


def test_iou3d_and_cosine_matrices():
    rng = np.random.default_rng(0)
    b = _boxes(rng, 40)
    b[3] = b[7]                                  # identical boxes
    b[5, 3:] = b[5, :3]                          # a flat (zero-volume) box
    np.testing.assert_allclose(tsim.iou3d_matrix(b, device="cpu"),
                               jsim.iou3d_matrix(b), rtol=0, atol=SIM_ATOL)
    m = torch.backends.cuda.matmul
    prev, m.fp32_precision = m.fp32_precision, "tf32"      # the caller's setting
    try:
        for d in (384, 512, 96):
            f = rng.normal(size=(37, d))
            f[4] = 0.0                           # a zero row
            np.testing.assert_allclose(tsim.cosine_matrix(f, device="cpu"),
                                       jsim.cosine_matrix(f), rtol=0, atol=SIM_ATOL)
            assert m.fp32_precision == "tf32"    # restored
    finally:
        m.fp32_precision = prev


def test_hit_bboxes_equal():
    rng = np.random.default_rng(1)
    hs, ws = 7, 12
    hit = rng.random((9, hs * ws)) < 0.05
    hit[2] = False                               # an empty footprint
    hit[4] = True
    got = tsim._hit_bboxes(torch.as_tensor(hit), hs, ws).numpy()
    want = np.asarray(jsim._hit_bboxes(jnp.asarray(hit), hs, ws))
    np.testing.assert_array_equal(got, want)


def test_projected_iou2d_matrix():
    cam = Camera(width=80, height=60, fx=50.0, fy=50.0, cx=40.0, cy=30.0)
    dirs = cam.ray_dirs("cpu").numpy()
    scene = synthetic.default_scene(n_spheres=2)
    poses = [synthetic.orbit_pose(a) for a in np.linspace(-0.6, 0.6, 4)]
    depths = [scene.render(t, dirs)[1] for t in poses]
    rng = np.random.default_rng(2)
    b = _boxes(rng, 25) * 0.6
    got = tsim.projected_iou2d_matrix(depths, np.stack(poses), cam.fx, cam.fy, cam.cx,
                                      cam.cy, b, skip=3, device="cpu")
    want = jsim.projected_iou2d_matrix(depths, np.stack(poses), cam.fx, cam.fy, cam.cx,
                                       cam.cy, b, skip=3)
    assert (want > 0).sum() > 25                 # the boxes do overlap in view
    np.testing.assert_allclose(got, want, rtol=0, atol=SIM_ATOL)


def test_similarity_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        tsim.cosine_matrix(np.eye(3))


# --------------------------------------------------------------------------- #
# DBSCAN, connected components, Louvain
# --------------------------------------------------------------------------- #


def _shared_border_cloud(rng):
    """Two dense 3-d blobs, a bridge point within eps of core points of
    both (a border point both clusters reach), scattered noise."""
    a = rng.normal(size=(60, 3)) * 0.02
    b = rng.normal(size=(60, 3)) * 0.02 + [0.2, 0, 0]
    bridge = np.array([[0.1, 0.0, 0.0]])
    noise = rng.uniform(-1, 1, (30, 3))
    pts = np.concatenate([noise[:10], b, bridge, a, noise[10:]])
    return pts


@pytest.mark.parametrize("case", ["border", "uniform", "tiers", "rows384", "rows512"])
def test_dbscan_matches_sklearn(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    runs = []
    if case == "border":
        pts = _shared_border_cloud(rng)
        runs = [(pts, eps, ms) for eps in (0.06, 0.08, 0.1) for ms in (2, 5, 10)]
    elif case == "uniform":
        for _ in range(20):
            pts = rng.uniform(0, 1, (int(rng.integers(5, 400)), 3))
            runs.append((pts, float(rng.uniform(0.03, 0.15)), int(rng.integers(1, 12))))
    elif case == "tiers":                        # min_points 100 -> 20 -> 10
        pts = np.concatenate([rng.normal(size=(45, 3)) * 0.01,
                              rng.normal(size=(25, 3)) * 0.01 + 1.0,
                              rng.uniform(-2, 2, (40, 3))])
        runs = [(pts, 0.05, mp) for mp in (100, 20, 10)]
    else:
        d = int(case[4:])
        centres = np.stack([_unit(rng.normal(size=d)) for _ in range(4)])
        rows = centres[rng.integers(0, 4, 120)] + rng.normal(size=(120, d)) * 0.012
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        rows = np.concatenate([rows, np.stack([_unit(rng.normal(size=d)) for _ in range(10)])])
        runs = [(rows, eps, 2) for eps in (0.2, 0.3, 0.5)]
    for pts, eps, ms in runs:
        want = sklearn_cluster.DBSCAN(eps=eps, min_samples=ms).fit_predict(pts)
        np.testing.assert_array_equal(dbscan_labels(pts, eps, ms), want)
    if case == "border":                         # the bridge point reached both
        want = sklearn_cluster.DBSCAN(eps=0.1, min_samples=5).fit_predict(pts)
        assert want[70] >= 0


@pytest.mark.parametrize("n", [150, 1500, 2600])
def test_dbscan_largest_cluster_tiers(n):
    """The 3-tier denoise: sklearn below 2,000 points in the JAX package,
    the port's DBSCAN; the native grid DBSCAN above, in both."""
    rng = np.random.default_rng(n)
    k = n // 3
    pts = np.concatenate([rng.normal(size=(k, 3)) * 0.02,
                          rng.normal(size=(n // 4, 3)) * 0.02 + 1.0,
                          rng.uniform(-3, 3, (n - k - n // 4, 3))])
    for mp in (n // 2, 100, 30):
        got_p, got_k = tproj.dbscan_largest_cluster(pts, eps=0.03, min_points=mp)
        want_p, want_k = jproj.dbscan_largest_cluster(pts, eps=0.03, min_points=mp)
        np.testing.assert_array_equal(got_k, want_k)
        np.testing.assert_array_equal(got_p, want_p)


def test_connected_components_match_opencv():
    rng = np.random.default_rng(3)
    shapes = [tuple(rng.integers(1, 50, 2)) for _ in range(150)] + [(60, 80), (61, 81)]
    for h, w in shapes:
        m = rng.random((h, w)) < rng.uniform(0.05, 0.6)
        n, lab = cv2.connectedComponents(m.astype(np.uint8), connectivity=8)
        got = tproj.connected_components(m)
        assert len(got) == n - 1
        for i, comp in enumerate(got):
            np.testing.assert_array_equal(comp, lab == i + 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_louvain_cluster_matches(seed):
    rng = np.random.default_rng(seed)
    m = 60
    grp = rng.integers(0, 6, m)
    w = np.where(grp[:, None] == grp[None, :], rng.uniform(0.9, 1.6, (m, m)),
                 rng.uniform(0.0, 1.05, (m, m)))
    w = (w + w.T) / 2
    adj, weighted = tgraph.build_adjacency(w, w, w, w, w)
    jadj, jweighted = jgraph.build_adjacency(w, w, w, w, w)
    np.testing.assert_array_equal(adj, jadj)
    np.testing.assert_array_equal(weighted, jweighted)
    assert tgraph.louvain_cluster(adj, weighted, seed=seed) == \
        jgraph.louvain_cluster(adj, weighted, seed=seed)
    assert tgraph.filter_rare_ids(list(grp), 9) == jgraph.filter_rare_ids(list(grp), 9)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No fallback to networkx or scikit-learn: without the native
    libraries, Louvain and the large-cloud DBSCAN raise."""
    from openobj_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "lib_path", lambda src=native.SRC: tmp_path / src.name)
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_tried", set())
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="Louvain"):
        native.louvain_labels(np.zeros(1), np.ones(1), np.ones(1), 2)
    with pytest.raises(RuntimeError, match="geometry"):
        tproj.dbscan_largest_cluster(np.zeros((2001, 3)), eps=0.1, min_points=5)
    assert native.marching_tetrahedra(np.zeros((3, 3, 3), np.float32)) is None   # numpy


def test_networkx_methods_need_networkx(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "networkx", None)
    adj = np.zeros((3, 3), bool)
    with pytest.raises(ImportError, match="networkx"):
        tgraph.louvain_cluster(adj, adj.astype(float), method="Greedy")
    with pytest.raises(ValueError, match="natively"):
        tgraph.louvain_cluster(adj, adj.astype(float), use_native=False)


# --------------------------------------------------------------------------- #
# second-stage merge: the fixtures of tests/test_perception.py (TestMerge)
# --------------------------------------------------------------------------- #


def _merge_cases():
    rng = np.random.default_rng(0)
    u = lambda d: _unit(rng.normal(size=d))                       # noqa: E731
    ua = lambda: _unit(np.abs(rng.normal(size=96)))               # noqa: E731
    cases = {}
    pc = rng.uniform(-1, 1, (400, 3))
    f1, f2, c1 = u(384), u(384), ua()
    cases["overlapping"] = ({10: pc, 11: pc + 0.001, 12: pc + 50.0}, {10: f1, 11: f1, 12: f2},
                            {10: c1, 11: c1, 12: c1},
                            dict(bg_feats={}, weight_pc=0.6, weight_caption=0.3, weight_color=0.6))
    f, c = u(384), ua()
    a = rng.uniform(0.0, 1.0, (300, 3)) * [1, 1, 0.01]
    cpc = a + [0, 0, 1.0]
    pcs = {20: a, 21: cpc, 22: np.concatenate([a, cpc])}
    cases["chain"] = (pcs, {k: f for k in pcs}, {k: c for k in pcs},
                      dict(bg_feats={}, weight_pc=0.6, weight_caption=0.3, weight_color=0.6))
    wall, f_obj, c = u(384), u(384), ua()
    a = rng.uniform(0, 1, (300, 3))
    pcs = {7: a, 8: a + 0.001, 9: a + 0.002}
    cases["bg_chain"] = (pcs, {7: f_obj, 8: f_obj, 9: wall}, {k: c for k in pcs},
                         dict(bg_feats={"wall": wall[None]}, weight_pc=0.6,
                              weight_caption=0.3, weight_color=0.6))
    f_tab, f_obj, c = u(384), u(384), ua()
    top = rng.uniform(0, 1, (600, 3)) * [1, 1, 0.02]
    leg = rng.uniform(0, 1, (200, 3)) * [0.06, 0.06, 0.5] + [0.2, 0.2, 0.0]
    ball = rng.uniform(0, 1, (200, 3)) * [0.1, 0.1, 0.1] + [0.6, 0.6, -0.1]
    nb = rng.uniform(0, 1, (300, 3)) * [0.5, 1, 0.02] + [1.0, 0, 0]
    pcs = {1: top, 2: leg, 3: ball, 4: nb}
    for cp in (0.02, 0.0):
        cases[f"contact_{cp}"] = (pcs, {1: f_tab, 2: f_tab, 3: f_obj, 4: f_tab},
                                  {k: c for k in pcs},
                                  dict(bg_feats={}, dis_thre=0.05, weight_pc=0.4,
                                       weight_caption=0.3, weight_color=0.6,
                                       contact_pc=cp, contact_cap=0.9, up_axis=2))
    f1, f2, c1, c2 = u(384), u(384), ua(), ua()
    a = rng.uniform(0, 1, (3000, 3)) * [0.3, 0.3, 0.3]
    pcs = {1: a, 2: a + [0.30, 0, 0],
           3: rng.uniform(0, 1, (40, 3)) * [0.02, 0.3, 0.3] + [0.29, 0, 0]}
    kw = dict(bg_feats={}, dis_thre=0.05, weight_pc=0.4, weight_caption=0.3, weight_color=0.6)
    cases["bridge_welded"] = (pcs, {1: f1, 2: f2, 3: f1}, {1: c1, 2: c2, 3: c1}, kw)
    cases["bridge_gated"] = (pcs, {1: f1, 2: f2, 3: f1}, {1: c1, 2: c2, 3: c1},
                             dict(kw, n_views={1: 10, 2: 10, 3: 1}))
    f, c = u(384), ua()
    base = rng.uniform(0, 1, (1500, 3)) * [0.2, 1, 0.2]
    pcs = {k: base + [0.08 * k, 0, 0] for k in range(1, 5)}
    cases["leaves"] = (pcs, {k: f for k in pcs}, {k: c for k in pcs},
                       dict(kw, n_views={k: 1 for k in pcs}))
    f, c, c_other = u(384), ua(), ua()
    slab = rng.uniform(0, 1, (300, 3)) * [0.6, 0.2, 0.6]
    kw2 = dict(bg_feats={}, dis_thre=0.02, weight_pc=0.4, weight_caption=0.3,
               weight_color=0.6, contact_cap=0.9)
    for name, shift, col2, views in (("twins", 0.3, c, True), ("clones", 0.45, c, True),
                                     ("twin_colour", 0.3, c_other, True),
                                     ("twins_no_views", 0.3, c, False)):
        extra = {"n_views": {1: 7, 2: 7}} if views else {}
        cases[name] = ({1: slab, 2: slab + [0, shift, 0]}, {1: f, 2: f}, {1: c, 2: col2},
                       dict(kw2, **extra))
    wall, f_obj = u(384), u(384)
    pc = rng.uniform(-1, 1, (100, 3))
    cases["bg_caption"] = ({5: pc, 6: pc + 30}, {5: wall, 6: f_obj},
                           {5: _unit(np.ones(96)), 6: _unit(np.ones(96))},
                           dict(bg_feats={"wall": wall[None]}))
    return cases


MERGE_CASES = _merge_cases()


@pytest.mark.parametrize("name", sorted(MERGE_CASES))
def test_second_stage_mapping_matches(name):
    pcs, caps, cols, kw = MERGE_CASES[name]
    assert tmerge.second_stage_mapping(pcs, caps, cols, **kw) == \
        jmerge.second_stage_mapping(pcs, caps, cols, **kw)


def test_majority_cluster_mean_matches():
    rng = np.random.default_rng(4)
    tight = rng.normal(size=384) * 0.01 + 1.0
    vecs = np.stack([tight + rng.normal(size=384) * 0.01 for _ in range(8)]
                    + [rng.normal(size=384) * 5 for _ in range(2)])
    for eps in (0.2, 0.5):
        np.testing.assert_array_equal(tmerge.majority_cluster_mean(vecs, eps=eps),
                                      jmerge.majority_cluster_mean(vecs, eps=eps))


# --------------------------------------------------------------------------- #
# associate end to end
# --------------------------------------------------------------------------- #


def _gt_frames(scene, poses, dirs, ids, rng, mod, min_px=30):
    """Per frame: one mask per ground-truth id with >= min_px pixels, its
    caption and seeded noisy unit features (the example's stage 1)."""
    frames = []
    for t_wc in poses:
        rgb, depth, inst = scene.render(t_wc, dirs)
        masks, caps, capfts, clipfts = [], [], [], []
        for oid, (capft, clipft, cap) in ids.items():
            m = inst == oid
            if m.sum() < min_px:
                continue
            masks.append(m)
            caps.append(cap)
            capfts.append(capft + rng.normal(size=384) * 0.01)
            clipfts.append(clipft + rng.normal(size=512) * 0.01)
        frames.append(mod.FrameInput(masks=masks, captions=caps, capfeats=capfts,
                                     clipfeats=clipfts, depth=depth, rgb=rgb, t_wc=t_wc))
    return frames


def _scene_inputs(name):
    rng = np.random.default_rng(0)
    if name == "two_object":        # tests/test_perception.py TestAssociateEndToEnd
        cam = Camera(width=64, height=48, fx=40.0, fy=40.0, cx=32.0, cy=24.0)
        scene = synthetic.default_scene(n_spheres=2)
        poses = [synthetic.orbit_pose(a) for a in np.linspace(-0.5, 0.5, 6)]
        kw = dict(min_component_px=20, dbscan_min_points=10, dbscan_eps=0.25)
    else:                           # archetypes at 80 x 60
        cam = Camera(width=80, height=60, fx=50.0, fy=50.0, cx=40.0, cy=30.0)
        scene, orbit = synthetic.archetype_scene(name)
        poses = [synthetic.orbit_pose(2 * np.pi * i / 10, **orbit) for i in range(10)]
        kw = dict(min_component_px=20, dbscan_min_points=10, dbscan_eps=0.2)
    ids = {o.inst_id for o in scene.all_objects} - {0}
    feats = {oid: (_unit(rng.normal(size=384)), _unit(rng.normal(size=512)), f"object {oid}")
             for oid in sorted(ids)}
    feats[0] = (_unit(rng.normal(size=384)), _unit(rng.normal(size=512)), "a wall")
    dirs = cam.ray_dirs("cpu").numpy()
    acfg = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, **kw)
    return scene, poses, dirs, feats, acfg


@pytest.mark.parametrize("name", ["two_object", "spheres", "tabletop"])
def test_associate_matches(name, tmp_path):
    scene, poses, dirs, feats, acfg = _scene_inputs(name)
    bg = {"wall": feats[0][0][None]}
    got = tpipe.associate(_gt_frames(scene, poses, dirs, feats, np.random.default_rng(1), tpipe),
                          bg, tpipe.AssociationConfig(**acfg), device="cpu")
    want = jpipe.associate(_gt_frames(scene, poses, dirs, feats, np.random.default_rng(1), jpipe),
                           bg, jpipe.AssociationConfig(**acfg))
    assert got["final_ids"] == want["final_ids"]
    assert got["cluster_ids"] == want["cluster_ids"]
    assert got["n_objects"] == want["n_objects"]
    assert got["heal_stats"] == want["heal_stats"]
    for a, b in zip(got["inst_images"], want["inst_images"]):
        np.testing.assert_array_equal(a, b)
    for ma, mb in zip(got["masks"], want["masks"]):
        for a, b in zip(ma, mb):
            np.testing.assert_array_equal(a, b)
    assert len({g for ids in got["final_ids"] for g in ids} - {0, 1}) >= 2
    # the written artifacts, read back with OpenCV: equal images and pickles
    h, w = got["inst_images"][0].shape
    for out, mod in ((got, tmerge), (want, jmerge)):
        d = tmp_path / mod.__name__.split(".")[0]
        mod.write_artifacts(str(d), out["masks"], out["final_ids"], out["clipfeats"],
                            out["capfeats"], out["captions"], (h, w),
                            inst_images=out["inst_images"])
    ta, ja = tmp_path / "openobj_torch", tmp_path / "openobj_tpu"
    for sub, stem in (("instance_our", "semantic_instance"), ("class_our", "semantic_class")):
        for i in range(len(poses)):
            a = cv2.imread(str(ta / sub / f"{stem}_{i}.png"), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(str(ja / sub / f"{stem}_{i}.png"), cv2.IMREAD_UNCHANGED)
            assert a.dtype == np.uint16
            np.testing.assert_array_equal(a, b)
    for pkl in ("object_clipfeat.pkl", "object_capfeat.pkl", "object_caption.pkl"):
        with open(ta / pkl, "rb") as f:
            a = pickle.load(f)
        with open(ja / pkl, "rb") as f:
            b = pickle.load(f)
        assert [sorted(x) for x in a] == [sorted(x) for x in b]
        for x, y in zip(a, b):
            for k in x:
                np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


def test_write_artifacts_id_range_and_overlays(tmp_path):
    m = np.zeros((12, 16), bool)
    m[2:6, 3:9] = True
    with pytest.raises(ValueError, match="uint16"):
        tmerge.write_artifacts(str(tmp_path / "a"), [[m]], [[70000]], [[np.ones(512)]],
                               [[np.ones(384)]], [["x"]], (12, 16))
    args = ([[m, ~m]], [[4, 999]], (12, 16))
    tmerge.write_cluster_overlays(str(tmp_path / "t"), *args, skip_id=999)
    jmerge.write_cluster_overlays(str(tmp_path / "j"), *args, skip_id=999)
    a = cv2.imread(str(tmp_path / "t" / "inst_0.png"), cv2.IMREAD_UNCHANGED)
    b = cv2.imread(str(tmp_path / "j" / "inst_0.png"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(a, b)
    assert a[3, 4].any() and not a[0, 0].any()
    assert os.path.getsize(tmp_path / "t" / "inst_0.png") > 0
