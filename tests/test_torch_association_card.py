"""The association's similarity matrices and ``associate`` on the card
against the same port on the CPU.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither jax nor openobj_tpu, so it runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_association_card.py

Tolerances: the matrices within 1e-6 (FP32 on both; the card's sums may run
in another order); hit boxes, final ids and instance images equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openobj_torch.core.scene import Camera  # noqa: E402
from openobj_torch.data import synthetic  # noqa: E402
from openobj_torch.perception import pipeline, similarity  # noqa: E402

SIM_ATOL = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _unit(v):
    return v / np.linalg.norm(v)


@pytest.mark.cuda
def test_matrices_on_the_card(cuda_device):
    rng = np.random.default_rng(0)
    lo = rng.uniform(-2, 2, (300, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 1.5, (300, 3))], 1)
    np.testing.assert_allclose(similarity.iou3d_matrix(boxes, device=cuda_device),
                               similarity.iou3d_matrix(boxes, device="cpu"),
                               rtol=0, atol=SIM_ATOL)
    feats = rng.normal(size=(300, 512))
    m = torch.backends.cuda.matmul
    prev, m.fp32_precision = m.fp32_precision, "tf32"      # the caller's TF32 ...
    try:
        got = similarity.cosine_matrix(feats, device=cuda_device)
        assert m.fp32_precision == "tf32"                  # ... restored
    finally:
        m.fp32_precision = prev
    np.testing.assert_allclose(got, similarity.cosine_matrix(feats, device="cpu"),
                               rtol=0, atol=SIM_ATOL)
    hit = torch.as_tensor(rng.random((40, 68 * 120)) < 0.02)
    np.testing.assert_array_equal(
        similarity._hit_bboxes(hit.to(cuda_device), 68, 120).cpu().numpy(),
        similarity._hit_bboxes(hit, 68, 120).numpy())
    cam = Camera(width=1200, height=680, fx=600.0, fy=600.0, cx=599.5, cy=339.5)
    scene, orbit = synthetic.archetype_scene("tabletop")
    dirs = cam.ray_dirs("cpu").numpy()
    poses = [synthetic.orbit_pose(a, **orbit) for a in (0.0, 0.7)]
    depths = [scene.render(t, dirs)[1] for t in poses]
    b = boxes[:120] * 0.5
    np.testing.assert_allclose(
        similarity.projected_iou2d_matrix(depths, np.stack(poses), cam.fx, cam.fy, cam.cx,
                                          cam.cy, b, device=cuda_device),
        similarity.projected_iou2d_matrix(depths, np.stack(poses), cam.fx, cam.fy, cam.cx,
                                          cam.cy, b, device="cpu"),
        rtol=0, atol=SIM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["spheres", "tabletop"])
def test_associate_on_the_card(name, cuda_device):
    cam = Camera(width=80, height=60, fx=50.0, fy=50.0, cx=40.0, cy=30.0)
    scene, orbit = synthetic.archetype_scene(name)
    dirs = cam.ray_dirs("cpu").numpy()
    rng = np.random.default_rng(0)
    ids = sorted({o.inst_id for o in scene.all_objects} - {0}) + [0]
    feats = {i: (_unit(rng.normal(size=384)), _unit(rng.normal(size=512))) for i in ids}
    views = [scene.render(synthetic.orbit_pose(2 * np.pi * i / 10, **orbit), dirs)
             + (synthetic.orbit_pose(2 * np.pi * i / 10, **orbit),) for i in range(10)]

    def frames():
        r = np.random.default_rng(1)
        out = []
        for rgb, depth, inst, t_wc in views:
            keep = [i for i in ids if (inst == i).sum() >= 30]
            out.append(pipeline.FrameInput(
                masks=[inst == i for i in keep], captions=[f"id {i}" for i in keep],
                capfeats=[feats[i][0] + r.normal(size=384) * 0.01 for i in keep],
                clipfeats=[feats[i][1] + r.normal(size=512) * 0.01 for i in keep],
                depth=depth, rgb=rgb, t_wc=t_wc))
        return out

    cfg = pipeline.AssociationConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                                     min_component_px=20, dbscan_min_points=10,
                                     dbscan_eps=0.2)
    bg = {"wall": feats[0][0][None]}
    got = pipeline.associate(frames(), bg, cfg, device=cuda_device)
    want = pipeline.associate(frames(), bg, cfg, device="cpu")
    assert got["final_ids"] == want["final_ids"]
    for a, b in zip(got["inst_images"], want["inst_images"]):
        np.testing.assert_array_equal(a, b)
