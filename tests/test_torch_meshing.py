"""The port's meshing against the JAX package's, on the same fields and
boxes, and the port's native marching against its numpy version.

The port's field is the kernels' plain version on the CPU; the JAX side runs
its default XLA field. Occupancy grids agree within 1e-5 (max abs), colours
within 1e-5 and part features (values up to ~20) within 2e-4; meshes have
equal faces and vertices within 1e-5. Both packages build the same C++
marching source (each its own copy).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from openobj_tpu.core import meshing as jm  # noqa: E402
from openobj_tpu.models import object_field as jof  # noqa: E402
from openobj_tpu.ops import rendering as jrend  # noqa: E402
from openobj_tpu.utils.geometry import OrientedBox as JBox  # noqa: E402
from openobj_torch import convert, native  # noqa: E402
from openobj_torch.core import meshing as tm  # noqa: E402
from openobj_torch.ops import fused_field as tff  # noqa: E402
from openobj_torch.ops import marching as tmarch  # noqa: E402
from openobj_torch.ops import rendering as trend  # noqa: E402
from openobj_torch.utils.geometry import OrientedBox as TBox  # noqa: E402


def _field(h=32, bias=0.3, seed=0):
    """One JAX field with noise on its MLP and an alpha bias that puts the
    level set inside the box."""
    p = jax.tree.map(np.asarray, jof.init_field_params(
        jax.random.PRNGKey(seed), hidden=h, clip_size=16, scale=2.0))
    rng = np.random.default_rng(seed)
    p["mlp"] = jax.tree.map(
        lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32), p["mlp"])
    p["mlp"]["out_alpha"]["b"] = np.asarray([bias], np.float32)
    return p, convert.params_from_numpy(p, "cpu")


def _box():
    a = 0.4
    r = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
    kw = dict(center=np.array([0.2, -0.1, 1.5]), r=r, extent=np.array([0.9, 0.7, 0.8]))
    return JBox(**kw), TBox(**kw), np.array([0.15, -0.05, 1.45], np.float32)


def test_make_3d_grid():
    _, box, _ = _box()
    tf = np.eye(4, dtype=np.float32)
    tf[:3, :3], tf[:3, 3] = box.r, box.center
    scale = np.asarray(box.extent / 1.8, np.float32)
    ref = jrend.make_3d_grid(dim=9, scale=jnp.asarray(scale), transform=jnp.asarray(tf))
    got = trend.make_3d_grid(dim=9, scale=scale, transform=tf)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("do_clip", [False, True])
def test_eval_points_chunked(do_clip):
    pj, pt = _field()
    pts = (np.random.default_rng(3).normal(size=(300, 3)) * 0.5).astype(np.float32)
    ref = jm.eval_points_chunked(pj, jnp.asarray(pts), chunk_size=128, do_clip=do_clip)
    tff.reset_counts()
    got = tm.eval_points_chunked(pt, torch.from_numpy(pts), chunk_size=128, do_clip=do_clip)
    assert tff.COUNTS["fused_field_plain"] == 3        # one per chunk, ragged last
    for g, r, tol in zip(got, ref, (1e-5, 1e-5, 2e-4)):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol)


@pytest.mark.parametrize("coarse_to_fine", [False, True])
def test_eval_grid_occupancy(coarse_to_fine):
    pj, pt = _field()
    jbox, tbox, center = _box()
    scale, tf = tm._box_frame(tbox, False)
    kw = dict(grid_dim=24, coarse_to_fine=coarse_to_fine, block=4, chunk_size=4096)
    ref = jm.eval_grid_occupancy(pj, scale, tf, center, **kw)
    got = tm.eval_grid_occupancy(pt, scale, tf, center, **kw)
    assert got.shape == (24, 24, 24) and got.dtype == np.float32
    assert (ref > 0.5).any() and (ref < 0.5).any()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert tm.adaptive_grid_dim(tbox, 0.03, 24) == jm.adaptive_grid_dim(jbox, 0.03, 24)


@pytest.mark.parametrize("with_part,coarse_to_fine", [(False, False), (True, True)])
def test_mesh_object(with_part, coarse_to_fine):
    pj, pt = _field()
    jbox, tbox, center = _box()
    kw = dict(grid_dim=24, with_part=with_part, coarse_to_fine=coarse_to_fine, block=4)
    ref = jm.mesh_object(pj, jbox, center, **kw)
    got = tm.mesh_object(pt, tbox, center, **kw)
    assert ref is not None and got is not None and len(got.faces) > 100
    np.testing.assert_array_equal(got.faces, ref.faces)
    np.testing.assert_allclose(got.vertices, ref.vertices, atol=1e-5)
    assert np.abs(got.vertex_colors.astype(int) - ref.vertex_colors.astype(int)).max() <= 1
    if with_part:
        np.testing.assert_allclose(got.vertex_attrs["partfeat"],
                                   ref.vertex_attrs["partfeat"], atol=2e-4)


def test_empty_field_meshes_to_none():
    pj, pt = _field(bias=-3.0)
    jbox, tbox, center = _box()
    assert jm.mesh_object(pj, jbox, center, grid_dim=12) is None
    assert tm.mesh_object(pt, tbox, center, grid_dim=12) is None
    assert tm.object_point_cloud(pt, tbox, center, grid_dim=12) is None


def test_object_point_cloud():
    pj, pt = _field()
    jbox, tbox, center = _box()
    pts_j, col_j = jm.object_point_cloud(pj, jbox, center, grid_dim=16)
    pts_t, col_t = tm.object_point_cloud(pt, tbox, center, grid_dim=16)
    np.testing.assert_allclose(pts_t, pts_j, atol=1e-5)
    np.testing.assert_allclose(col_t, col_j, atol=1e-5)


def _canonical(verts, faces):
    """A mesh as its sorted triangles, each a sorted triple of vertices."""
    tri = np.round(verts[faces], 9)                       # [F, 3, 3]
    order = np.lexsort(tri.transpose(2, 0, 1)[::-1], axis=-1)
    tri = np.take_along_axis(tri, order[..., None], axis=1).reshape(len(faces), 9)
    return tri[np.lexsort(tri.T[::-1])]


@pytest.mark.parametrize("shape", [(20, 20, 20), (9, 14, 17)])
def test_native_marching_matches_numpy(shape):
    assert native.load() is not None, "g++ is present here: the library must build"
    rng = np.random.default_rng(5)
    axes = [np.linspace(-1, 1, n) for n in shape]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
    r = np.linalg.norm(g * [1.0, 1.3, 0.8], axis=-1) + 0.05 * rng.normal(size=shape)
    occ = (1 / (1 + np.exp(20 * (r - 0.6)))).astype(np.float32)
    vn, fn = native.marching_tetrahedra(occ, 0.5)
    vp, fp = tmarch.marching_tetrahedra(occ, 0.5)
    assert vn.shape == vp.shape and fn.shape == fp.shape
    np.testing.assert_allclose(_canonical(vn, fn), _canonical(vp, fp), atol=1e-9)


def test_native_voxel_downsample_matches_numpy():
    from openobj_torch.utils.geometry import voxel_downsample

    pts = np.random.default_rng(6).uniform(-2, 2, (4000, 3))
    a, b = native.voxel_downsample(pts, 0.25), voxel_downsample(pts, 0.25)
    np.testing.assert_allclose(a[np.lexsort(a.T)], b[np.lexsort(b.T)], atol=1e-9)
