"""The port's weights-free RGB-D segmentation
(openobj_torch.perception.segmentation) against the JAX package's on the
same numpy frames, on the CPU.

Tolerance: none. Both run in float64 on the host with the same stable sorts,
so the Felzenszwalb labels, the segmenter's masks and its scores must be
equal element for element. The native union-find is held to the plain
Python loop the port keeps beside it.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from openobj_tpu.perception import segmentation as jseg  # noqa: E402
from openobj_torch import native  # noqa: E402
from openobj_torch.core.scene import Camera  # noqa: E402
from openobj_torch.data import synthetic  # noqa: E402
from openobj_torch.perception import segmentation as tseg  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

W, H = 96, 72
FX = 0.65 * W


def _frame(name: str, i: int = 3, n: int = 40):
    cam = Camera(width=W, height=H, fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0)
    scene, orbit = synthetic.archetype_scene(name)
    rgb, depth, _ = scene.render(synthetic.orbit_pose(2 * np.pi * i / n, **orbit),
                                 cam.ray_dirs("cpu").numpy())
    return rgb, depth


def _depth_step():
    """Two flat surfaces a step apart, the same grey, with a band of
    invalid depth: only the depth term can split them."""
    rgb = np.full((40, 56, 3), 128, np.uint8)
    depth = np.full((40, 56), 2.0, np.float32)
    depth[:, 28:] = 1.4
    depth[30:34, :10] = 0.0
    return rgb, depth


FRAMES = {name: (lambda name=name: _frame(name)) for name in
          ("tabletop", "textured", "touching", "grazing")}
FRAMES["depth_step"] = _depth_step


@pytest.mark.parametrize("mode", ["depth_fx", "depth", "rgb_only"])
@pytest.mark.parametrize("name", list(FRAMES))
def test_felzenszwalb_labels_equal(name, mode):
    rgb, depth = FRAMES[name]()
    kw = dict(k=3.0, min_size=16, fx=FX if mode == "depth_fx" else None)
    d = None if mode == "rgb_only" else depth
    got = tseg.felzenszwalb_rgbd(rgb, d, **kw)
    want = jseg.felzenszwalb_rgbd(rgb, d, **kw)
    assert got.shape == (rgb.shape[0], rgb.shape[1])
    np.testing.assert_array_equal(got, want)
    if name == "depth_step" and mode != "rgb_only":
        assert got[5, 5] != got[5, 50]          # the step splits the grey


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("name", ["tabletop", "textured"])
def test_graph_segmenter_masks_and_scores_equal(name, stride):
    rgb, depth = FRAMES[name]()
    kw = dict(k=3.0, min_size=16, stride=stride, fx=FX)
    got_m, got_s = tseg.GraphSegmenter(**kw)(rgb, depth)
    want_m, want_s = jseg.GraphSegmenter(**kw)(rgb, depth)
    assert got_m.shape[0] > 2 and got_m.shape[1:] == (H, W)
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_array_equal(got_s, want_s)


def _edges(rgb, depth, seed):
    """A frame's 4-connected edges with random weights sorted ascending
    (ties among them on purpose)."""
    h, w = depth.shape
    idx = np.arange(h * w).reshape(h, w)
    ea = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    eb = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    ws = np.round(np.random.default_rng(seed).random(len(ea)), 2)
    order = np.argsort(ws, kind="stable")
    return ea[order], eb[order], ws[order]


@pytest.mark.parametrize("k,min_size", [(0.5, 8), (3.0, 16), (10.0, 64)])
def test_native_union_find_equals_python_loop(k, min_size):
    rgb, depth = FRAMES["touching"]()
    ea, eb, ws = _edges(rgb, depth, seed=int(k * 10))
    n = depth.size
    got = native.felz_union_find(ea, eb, ws, n, k, min_size)
    want = tseg._union_find_python(n, ea, eb, ws, k, min_size)
    np.testing.assert_array_equal(got, want)
    assert 1 < len(np.unique(got)) < n


def test_union_find_raises_without_the_library(monkeypatch):
    ea, eb, ws = _edges(*_depth_step(), seed=0)
    with pytest.raises(ValueError, match="outside"):
        native.felz_union_find(ea, eb, ws, 40 * 56 - 1, 3.0, 16)
    monkeypatch.setattr(native, "load", lambda: None)
    with pytest.raises(RuntimeError, match="no fallback"):
        tseg._union_find_segment(40 * 56, ea, eb, ws, 3.0, 16)
