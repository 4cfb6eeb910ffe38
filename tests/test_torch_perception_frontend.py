"""The port's perception front end (openobj_torch.perception: encoders,
mask_generation, partfeat, tracking) against the JAX package's on the same
numpy inputs, on the CPU.

Tolerance: none unless stated. The weights-free encoders, the caption
subjects, the split masks, the generated frame masks, the pickles, the part
maps and the tracker's instance images must be equal element for element
(the descriptor's projection is numpy's generator with the same seed, so
its features agree at atol 0). The port's ``split_mask`` is held to the JAX
function, which calls scikit-learn's DBSCAN; its erosion to ``cv2.erode``.
The transformers-based encoders run the same tiny model in both packages
(skipped without transformers) and must agree exactly.
"""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from openobj_tpu.perception import encoders as jenc  # noqa: E402
from openobj_tpu.perception import mask_generation as jmg  # noqa: E402
from openobj_tpu.perception import partfeat as jpf  # noqa: E402
from openobj_tpu.perception import tracking as jtr  # noqa: E402
from openobj_tpu.perception.segmentation import GraphSegmenter as JSeg  # noqa: E402
from openobj_tpu.utils import geometry as jgeom  # noqa: E402
from openobj_torch.core.scene import Camera  # noqa: E402
from openobj_torch.data import synthetic  # noqa: E402
from openobj_torch.perception import encoders as tenc  # noqa: E402
from openobj_torch.perception import mask_generation as tmg  # noqa: E402
from openobj_torch.perception import partfeat as tpf  # noqa: E402
from openobj_torch.perception import tracking as ttr  # noqa: E402
from openobj_torch.perception.segmentation import GraphSegmenter as TSeg  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

W, H = 96, 72
FX = 0.65 * W


def _render(name, angles):
    cam = Camera(width=W, height=H, fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0)
    scene, orbit = synthetic.archetype_scene(name)
    dirs = cam.ray_dirs("cpu").numpy()
    return [scene.render(synthetic.orbit_pose(a, **orbit), dirs) for a in angles]


def _assert_frame_equal(got: dict, want: dict):
    assert set(got) == set(want)
    assert len(got["mask"]) == len(want["mask"])
    for f in ("mask", "capfeat", "clipfeat"):
        for a, b in zip(got[f], want[f]):
            np.testing.assert_array_equal(a, b)
    assert got["bbox"] == want["bbox"] and got["caption"] == want["caption"]


# --------------------------------------------------------------------------- #
# weights-free encoders and the caption subject
# --------------------------------------------------------------------------- #

TEXTS = ["a red ball", "a red ball", "A Red box on the floor", "wall", "", "the 3 cups",
         "sofa sofa sofa"]


@pytest.mark.parametrize("dim,seed", [(384, 0), (64, 3)])
def test_hashing_text_encoder_equal(dim, seed):
    got = tenc.HashingTextEncoder(dim=dim, seed=seed)(TEXTS)
    want = jenc.HashingTextEncoder(dim=dim, seed=seed)(TEXTS)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dim,seed", [(512, 0), (64, 1)])
def test_visual_descriptor_encoder_equal(dim, seed):
    rng = np.random.default_rng(seed)
    crops = [rng.integers(0, 256, (24, 30, 3)).astype(np.uint8),
             np.full((9, 13, 3), 255, np.uint8),             # flat, top bin edge
             rng.integers(0, 256, (1, 17, 3)).astype(np.uint8),   # a sliver
             rng.integers(0, 256, (11, 8)).astype(np.uint8),      # grey
             _render("textured", [0.4])[0][0]]
    got = tenc.VisualDescriptorEncoder(dim=dim, seed=seed)
    want = jenc.VisualDescriptorEncoder(dim=dim, seed=seed)
    np.testing.assert_array_equal(got._proj, want._proj)
    np.testing.assert_allclose(got(crops), want(crops), rtol=0, atol=0)


def test_color_name_captioner_and_caption_subject_equal():
    rgb = _render("tabletop", [0.2])[0][0]
    boxes = [(0, 72, 0, 96), (10, 40, 20, 60), (30, 31, 5, 90), (50, 72, 70, 96)]
    for pad in (0, 4):
        assert tenc.ColorNameCaptioner(pad)(rgb, boxes) == jenc.ColorNameCaptioner(pad)(rgb, boxes)
    caps = ["a wooden chair with four legs", "the red mug on the table", "sofa",
            "A lamp standing next to the bed.", "with a handle", "  an object  ", ""]
    assert [tenc.caption_subject(c) for c in caps] == [jenc.caption_subject(c) for c in caps]


# --------------------------------------------------------------------------- #
# split_mask against the JAX function's scikit-learn DBSCAN
# --------------------------------------------------------------------------- #


def _blobs(h, w, centres, r):
    yy, xx = np.mgrid[:h, :w]
    m = np.zeros((h, w), bool)
    for cy, cx in centres:
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    return m


@pytest.mark.parametrize("case", ["chain", "apart", "one", "small_dropped", "mixed"])
def test_split_mask_equal(case):
    h, w = 60, 80
    masks = {
        # components 10-14 px apart under eps = 14 chain into one group
        "chain": _blobs(h, w, [(10, 8), (10, 30), (10, 52), (45, 70)], 5),
        "apart": _blobs(h, w, [(8, 8), (50, 70), (8, 70), (50, 8)], 6),
        "one": _blobs(h, w, [(30, 40)], 12),
        "small_dropped": _blobs(h, w, [(10, 10), (40, 60)], 2) | _blobs(h, w, [(30, 30)], 9),
        "mixed": _blobs(h, w, [(5, 5), (5, 22), (40, 40), (55, 75), (30, 75)], 4),
    }[case]
    for eps_factor in (0.05, 0.1, 0.2):
        got = tenc.split_mask(masks, min_px=30, eps_factor=eps_factor)
        want = jenc.split_mask(masks, min_px=30, eps_factor=eps_factor)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------- #
# mask generation and its pickle
# --------------------------------------------------------------------------- #


def _stage1(pkg_seg, pkg_enc, pkg_mg, rgb, depth):
    return pkg_mg.generate_frame_masks(
        rgb, pkg_seg(k=3.0, min_size=16, stride=1, fx=FX), pkg_enc.ColorNameCaptioner(),
        pkg_enc.VisualDescriptorEncoder(dim=64).encode_images,
        pkg_enc.HashingTextEncoder(dim=32).encode_texts,
        min_px=20, crop_pad=2, depth=depth)


@pytest.mark.parametrize("name", ["tabletop", "touching"])
def test_generate_frame_masks_equal(name):
    rgb, depth, _ = _render(name, [1.1])[0]
    got = _stage1(TSeg, tenc, tmg, rgb, depth)
    want = _stage1(JSeg, jenc, jmg, rgb, depth)
    assert len(got["mask"]) >= 3
    _assert_frame_equal(got, want)
    masks = np.stack([np.arange(6) < 3, np.arange(6) >= 2]).reshape(2, 2, 3)
    for a, b in zip(tmg.rank_order_masks(masks, [0.5, 0.9]),
                    jmg.rank_order_masks(masks, [0.5, 0.9])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mask_init_pickle_round_trip(tmp_path):
    frames = _render("spheres", [0.0, 0.5])
    mi = {10 * i: _stage1(TSeg, tenc, tmg, rgb, depth) for i, (rgb, depth, _) in
          enumerate(frames)}
    for writer, reader in ((tmg, jenc), (jmg, tenc)):
        path = str(tmp_path / f"{writer.__name__}.pkl")
        writer.save_mask_init(path, mi)
        back = reader.load_mask_init(path)
        assert sorted(back) == [0, 10]
        for k in mi:
            _assert_frame_equal(back[k], mi[k])
    # the reference's field-major layout without frame records, and the
    # legacy frame-major dict, through both loaders
    with open(tmp_path / "ref.pkl", "wb") as f:
        pickle.dump({f: [mi[k][f] for k in (0, 10)] for f in mi[0]}, f)
    with open(tmp_path / "legacy.pkl", "wb") as f:
        pickle.dump(mi, f)
    for name in ("ref.pkl", "legacy.pkl"):
        got = tenc.load_mask_init(str(tmp_path / name))
        want = jenc.load_mask_init(str(tmp_path / name))
        assert sorted(got) == sorted(want)
        for k in got:
            _assert_frame_equal(got[k], want[k])


# --------------------------------------------------------------------------- #
# part maps
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("down", [1, 5])
def test_build_part_feature_map_equal(down):
    rng = np.random.default_rng(down)
    h, w = 47, 61
    masks = [rng.random((h, w)) < p for p in (0.5, 0.3, 0.2, 0.05)] + [np.zeros((h, w), bool)]
    feats = [rng.normal(size=24).astype(np.float32) for _ in masks]
    feats[1] = feats[1].astype(np.float64) * 1.1                   # a float64 row
    scores = list(rng.uniform(0.3, 1.0, len(masks)))
    for s in (scores, None):
        got = tpf.build_part_feature_map(masks, feats, s, down=down, device="cpu")
        want = jpf.build_part_feature_map(masks, feats, s, down=down)
        assert got.dtype == np.float32 and got.shape == (h // down, w // down, 24)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tpf.build_part_feature_map_plain(masks, feats, s, down=down), want)
    assert tpf.enlarge_bbox_xyxy((3, 4, 20, 30), 1.3, h, w) == \
        jpf.enlarge_bbox_xyxy((3, 4, 20, 30), 1.3, h, w)


def test_build_part_feature_map_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        tpf.build_part_feature_map([np.ones((10, 10), bool)], [np.ones(4, np.float32)])


# --------------------------------------------------------------------------- #
# tracking
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("size,iters", [(5, 3), (3, 1), (3, 2)])
def test_erode_equals_cv2_at_the_border(size, iters):
    rng = np.random.default_rng(size * 10 + iters)
    m = rng.random((30, 40)) < 0.85
    m[:, :6] = True                    # solid regions touching the border
    m[-5:, :] = True
    m[10:14, 20:24] = False
    want = cv2.erode(m.astype(np.uint8), np.ones((size, size), np.uint8),
                     iterations=iters).astype(bool)
    got = ttr._erode(m, size, iters)
    assert got[:, 0].any() and got[-1].any()      # the border did not erode
    np.testing.assert_array_equal(got, want)


def test_online_instance_tracker_equal(monkeypatch):
    """Detections over four frames of the tabletop: ground-truth masks with
    one id swapped in frame 2 (an unsure re-observation), one unknown id and
    a tiny mask; proposals from the tracked boxes as well. The JAX package
    fits its boxes by its rotating calipers, as the port does, not by
    OpenCV's rectangle (the same minimum, in other axes)."""
    monkeypatch.setattr(jgeom, "cv2", None)
    cam = Camera(width=W, height=H, fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0)
    frames = _render("tabletop", np.linspace(0.0, 0.6, 4))
    scene, orbit = synthetic.archetype_scene("tabletop")
    poses = [synthetic.orbit_pose(a, **orbit) for a in np.linspace(0.0, 0.6, 4)]
    kw = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, min_pixels=20, min_points=10,
              voxel_size=0.02, erode_size=3, erode_iters=1)
    trackers = (ttr.OnlineInstanceTracker(**kw), jtr.OnlineInstanceTracker(**kw))
    for f, ((rgb, depth, inst), t_wc) in enumerate(zip(frames, poses)):
        ids = [int(i) for i in np.unique(inst) if i > 0]
        masks = [inst == i for i in ids]
        cand = list(ids)
        if f == 2 and len(cand) > 1:
            cand[0], cand[1] = cand[1], cand[0]
        tiny = np.zeros_like(masks[0])
        tiny[2:4, 2:4] = True
        masks, cand = masks + [tiny], cand + [77]
        outs = [tr.ingest(masks, cand, depth, t_wc) for tr in trackers]
        np.testing.assert_array_equal(outs[0], outs[1])
        props = [tr.propose_ids(masks, depth, t_wc) for tr in trackers]
        assert props[0] == props[1]
    a, b = trackers
    assert sorted(a.instances) == sorted(b.instances) and len(a.instances) >= 3
    for k in a.instances:
        ia, ib = a.instances[k], b.instances[k]
        assert (ia.merge_cnt, ia.cmp_cnt) == (ib.merge_cnt, ib.cmp_cnt)
        np.testing.assert_array_equal(ia.points, ib.points)
        for f in ("center", "r", "extent"):
            np.testing.assert_array_equal(getattr(ia.box, f), getattr(ib.box, f))


# --------------------------------------------------------------------------- #
# the transformers-based encoders, on the tiny models of test_hf_encoders.py
# --------------------------------------------------------------------------- #


@pytest.fixture
def hf():
    pytest.importorskip("transformers")
    import test_hf_encoders

    return test_hf_encoders


def test_hf_encoders_equal(hf, tmp_path):
    model, processor = hf.tiny_clip.__wrapped__(tmp_path)
    bmodel, btok = hf.tiny_bert.__wrapped__(tmp_path)
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (40, 56, 3)).astype(np.uint8) for _ in range(3)]
    texts = ["a ball", "the wooden chair near a window"]
    tc = tenc.HFClipEncoder(model=model, processor=processor, device="cpu")
    jc = jenc.HFClipEncoder(model=model, processor=processor)
    np.testing.assert_array_equal(tc.encode_images(imgs), jc.encode_images(imgs))
    np.testing.assert_array_equal(tc.encode_texts(texts), jc.encode_texts(texts))
    ts = tenc.HFSbertEncoder(model=bmodel, tokenizer=btok, device="cpu")
    js = jenc.HFSbertEncoder(model=bmodel, tokenizer=btok)
    np.testing.assert_array_equal(ts.encode_texts(texts + ["cup"]), js.encode_texts(texts + ["cup"]))


def test_hf_captioner_equal(hf, tmp_path):
    model, processor = hf.tiny_blip.__wrapped__(tmp_path)
    rgb = np.random.default_rng(1).integers(0, 255, (60, 80, 3)).astype(np.uint8)
    boxes = [(5, 25, 10, 40), (30, 55, 40, 75)]
    got = tenc.HFCaptioner(model=model, processor=processor, max_new_tokens=4, device="cpu")
    want = jenc.HFCaptioner(model=model, processor=processor, max_new_tokens=4)
    assert got(rgb, boxes) == want(rgb, boxes)
    assert got(rgb, []) == []


def test_hf_encoders_default_to_the_card(hf, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    model, processor = hf.tiny_clip.__wrapped__(tmp_path)
    with pytest.raises((AssertionError, RuntimeError)):
        tenc.HFClipEncoder(model=model, processor=processor)
