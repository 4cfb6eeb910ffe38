"""Reference-checkpoint interop and the export over a reference .pth tree,
port against the JAX package.

The .pth files are written by ``test_interop``'s own means (its spec-built
torch twin of the reference model and ``_save_reference_pth``) or by either
package's ``export_torch_checkpoint``. Conversion moves float32 values
between files and never computes with them, so params, boxes and features
must be equal bit for bit across the packages and the round trips. The field
outputs of one package on params that went through the other package's file
must equal its outputs on the originals bit for bit; across the packages
they agree within the float32 tolerance of ``FIELD_ATOL``. The export over
a .pth tree holds ``test_torch_outputs.py``'s tolerances: faces equal,
vertices within ``VERT_ATOL`` (5e-5 m), unit part features within 1e-3,
colours within 1 LSB.
"""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")

import jax  # noqa: E402

from openobj_tpu import interop as jinterop  # noqa: E402
from openobj_tpu.models import object_field as jfield  # noqa: E402
from openobj_tpu.utils.geometry import OrientedBox as JBox  # noqa: E402
from openobj_tpu.viz import export as jexport  # noqa: E402
import openobj_torch  # noqa: E402
from openobj_torch import interop as tinterop  # noqa: E402
from openobj_torch.models import object_field as tfield  # noqa: E402
from openobj_torch.utils.geometry import OrientedBox as TBox  # noqa: E402
from openobj_torch.viz import export as texport  # noqa: E402
from test_interop import (  # noqa: E402
    CLIP, HIDDEN, TorchOccupancyMap, TorchUniDirsEmbed, _save_reference_pth,
)
from test_torch_outputs import VERT_ATOL  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

FIELD_ATOL = 1e-5     # one f32 MLP of width 16 evaluated by two libraries
PART_ATOL = 1e-3      # unit part features at vertices up to VERT_ATOL apart


def _leaves(tree, prefix=""):
    """{path: numpy leaf} of a param tree of tensors or arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.detach().cpu().numpy() if hasattr(v, "detach") \
                else np.asarray(v)
    return out


def _assert_params_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype == np.float32, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def _assert_info_equal(t, j, epoch=True):
    _assert_params_equal(t["params"], j["params"])
    for k in ("obj_id", "obj_scale", "semantic_id", "hidden", "clip_size", "max_deg") \
            + ("epoch",) * epoch:
        assert t[k] == j[k], k
    np.testing.assert_array_equal(t["obj_center"], j["obj_center"])
    for k in ("clip_feats", "caption_feats"):
        np.testing.assert_array_equal(t[k], j[k])
    assert (t["bbox"] is None) == (j["bbox"] is None)
    if t["bbox"] is not None:
        for k in ("center", "r", "extent"):
            np.testing.assert_array_equal(getattr(t["bbox"], k), getattr(j["bbox"], k))


def _fields(params_t, params_j, pts):
    """The port's field (CPU) and the JAX one at ``pts``."""
    with torch.no_grad():
        t = tfield.field_apply(params_t, torch.from_numpy(pts))
    j = jfield.field_apply(params_j, pts)
    return [x.numpy() for x in t], [np.asarray(x) for x in j]


@pytest.mark.parametrize("with_bbox", [True, False])
def test_import_same_pth(tmp_path, with_bbox):
    torch.manual_seed(0)
    fc, pe = TorchOccupancyMap(), TorchUniDirsEmbed(scale=2.0)
    p = str(tmp_path / "obj_7.pth")
    _save_reference_pth(p, fc, pe, with_bbox=with_bbox)
    got = tinterop.import_torch_checkpoint(p, device="cpu")
    ref = jinterop.import_torch_checkpoint(p)
    _assert_info_equal(got, ref)
    assert got["hidden"] == HIDDEN and got["clip_size"] == CLIP
    assert {x.device.type for x in _tensors(got["params"])} == {"cpu"}
    assert isinstance(got["bbox"], TBox) == with_bbox
    # the port's field on the imported params: the twin's outputs
    pts = np.random.default_rng(1).normal(size=(33, 3)).astype(np.float32)
    with torch.no_grad():
        want = fc(pe(torch.from_numpy(pts)))
    t, j = _fields(got["params"], ref["params"], pts)
    for a, b, w in zip(t, j, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=FIELD_ATOL)
        np.testing.assert_allclose(a, w.numpy(), rtol=1e-4, atol=1e-4)


def _tensors(tree):
    for v in tree.values():
        yield from _tensors(v) if isinstance(v, dict) else [v]


def test_pth_across_packages(tmp_path):
    """A .pth the port writes loads in the JAX interop, and one the JAX
    interop writes loads in the port, with identical params, metadata and
    field outputs."""
    params_j = jax.tree.map(np.asarray, jfield.init_field_params(
        jax.random.PRNGKey(3), hidden=HIDDEN, clip_size=CLIP, scale=5.0))
    params_t = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), params_j)
    rng = np.random.default_rng(4)
    clip, cap = rng.normal(size=(3, CLIP)).astype(np.float32), \
        rng.normal(size=(3, 5)).astype(np.float32)
    box = (np.array([0.1, -0.2, 0.3]), np.eye(3), np.array([1.0, 2.0, 0.5]))
    pt, pj = str(tmp_path / "t" / "obj_2.pth"), str(tmp_path / "j" / "obj_2.pth")
    tinterop.export_torch_checkpoint(pt, 2, params_t, bbox3d=TBox(*box), clip_feats=clip,
                                     caption_feats=cap, semantic_id=9, epoch=4)
    jinterop.export_torch_checkpoint(pj, 2, params_j, bbox3d=JBox(*box), clip_feats=clip,
                                     caption_feats=cap, semantic_id=9, epoch=4)
    a, b = torch.load(pt, weights_only=False), torch.load(pj, weights_only=False)
    assert a.keys() == b.keys()
    for sd in ("FC_state_dict", "PE_state_dict"):
        assert a[sd].keys() == b[sd].keys()
        for k in a[sd]:
            assert a[sd][k].dtype == b[sd][k].dtype and a[sd][k].shape == b[sd][k].shape
            assert torch.equal(a[sd][k], b[sd][k]), k
    # each package reads the other's file, and its own
    for path in (pt, pj):
        _assert_info_equal(tinterop.import_torch_checkpoint(path, device="cpu"),
                           jinterop.import_torch_checkpoint(path))
    from_j = tinterop.import_torch_checkpoint(pj, device="cpu")
    from_t = jinterop.import_torch_checkpoint(pt)
    _assert_params_equal(from_j["params"], params_t)
    _assert_params_equal(from_t["params"], params_j)
    assert from_j["obj_scale"] == from_t["obj_scale"] == 5.0
    pts = rng.normal(size=(29, 3)).astype(np.float32)
    t_new, j_new = _fields(from_j["params"], from_t["params"], pts)
    t_old, j_old = _fields(params_t, params_j, pts)
    for tn, to, jn, jo in zip(t_new, t_old, j_new, j_old):
        np.testing.assert_array_equal(tn, to)
        np.testing.assert_array_equal(jn, jo)
        np.testing.assert_allclose(tn, jn, rtol=0, atol=FIELD_ATOL)


def _npz_equal(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def _rel(paths, root):
    return sorted(os.path.relpath(p, root) for p in paths)


def test_convert_checkpoint_dir_both_ways(tmp_path):
    torch.manual_seed(1)
    src = tmp_path / "ref"
    for oid in (0, 4):
        fc, pe = TorchOccupancyMap(), TorchUniDirsEmbed(scale=5.0 if oid == 0 else 2.0)
        (src / str(oid)).mkdir(parents=True)
        _save_reference_pth(str(src / str(oid) / f"obj_{oid}.pth"), fc, pe, obj_id=oid)
    # forward: the same npz files
    tn, jn = tmp_path / "t_npz", tmp_path / "j_npz"
    wt = tinterop.convert_checkpoint_dir(str(src), str(tn))
    wj = jinterop.convert_checkpoint_dir(str(src), str(jn))
    assert _rel(wt, tn) == _rel(wj, jn) == ["0/obj_0.npz", "4/obj_4.npz"]
    for f in _rel(wt, tn):
        _npz_equal(tn / f, jn / f)
    # reverse: the same .pth contents, read back equal (the npz files keep
    # no epoch; both write 0)
    tp, jp = tmp_path / "t_pth", tmp_path / "j_pth"
    wt = tinterop.convert_checkpoint_dir(str(jn), str(tp), reverse=True)
    wj = jinterop.convert_checkpoint_dir(str(jn), str(jp), reverse=True)
    assert _rel(wt, tp) == _rel(wj, jp) == ["0/obj_0.pth", "4/obj_4.pth"]
    for f in _rel(wt, tp):
        orig = jinterop.import_torch_checkpoint(str(src / f))
        for path in (tp / f, jp / f):
            back = tinterop.import_torch_checkpoint(str(path), device="cpu")
            _assert_info_equal(back, orig, epoch=False)
            assert back["epoch"] == 0
    # and forward again from the port's .pth: the npz files of the first pass
    again = tmp_path / "again"
    tinterop.convert_checkpoint_dir(str(tp), str(again))
    for f in _rel(glob.glob(f"{tn}/*/*.npz"), tn):
        _npz_equal(again / f, tn / f)


def test_cli_and_top_level_names(tmp_path, capsys):
    torch.manual_seed(2)
    d = tmp_path / "ckpt" / "5"
    d.mkdir(parents=True)
    _save_reference_pth(str(d / "obj_5.pth"), TorchOccupancyMap(), TorchUniDirsEmbed(),
                        obj_id=5, with_bbox=False)
    tinterop.main([str(tmp_path / "ckpt"), str(tmp_path / "out")])
    out = capsys.readouterr().out
    assert "converted 1 object checkpoints" in out
    assert (tmp_path / "out" / "5" / "obj_5.npz").exists()
    assert openobj_torch.import_torch_checkpoint is tinterop.import_torch_checkpoint
    assert openobj_torch.export_torch_checkpoint is tinterop.export_torch_checkpoint


def _reference_pth_tree(root):
    """A reference .pth tree written by the JAX interop, shaped as
    ``test_torch_outputs``' map of two spheres: a background (id 0, h=16,
    scale 5, a 6 x 6 x 4 m box) and two objects (h=32, scale 2, boxes of
    0.2-0.9 m), clip head 16; each a JAX-initialised field with a little
    noise on the MLP and a positive alpha bias, as that map's fields are."""
    rng = np.random.default_rng(5)
    for oid, hidden, scale, center, extent in (
            (0, 16, 5.0, (0.0, 0.0, 0.0), (6.0, 6.0, 4.0)),
            (4, 32, 2.0, (1.45, 0.0, 0.0), (0.6, 0.6, 0.2)),
            (5, 32, 2.0, (-1.2, 0.0, 0.0), (0.9, 0.75, 0.8))):
        p = jax.tree.map(np.asarray, jfield.init_field_params(
            jax.random.PRNGKey(oid), hidden=hidden, clip_size=16, scale=scale))
        p["mlp"] = jax.tree.map(
            lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32), p["mlp"])
        p["mlp"]["out_alpha"]["b"] = np.full_like(p["mlp"]["out_alpha"]["b"], 0.5)
        jinterop.export_torch_checkpoint(
            str(root / str(oid) / f"obj_{oid}.pth"), oid, p, obj_scale=scale,
            bbox3d=JBox(np.array(center), np.eye(3), np.array(extent)),
            clip_feats=rng.normal(size=(2, 16)).astype(np.float32),
            caption_feats=rng.normal(size=(2, 8)).astype(np.float32), semantic_id=oid + 1)


def test_export_from_reference_pth_tree(tmp_path):
    """A reference .pth tree exported by both packages (the port on the CPU),
    and by the port from the npz tree the JAX interop converts it into."""
    pth = tmp_path / "pth"
    _reference_pth_tree(pth)
    kw = dict(grid_dim=16, live_voxel_size=0.05, hidden=32, hidden_bg=16, clip_size=16)
    ref = jexport.export_from_checkpoints(str(pth), "", **kw)
    out = str(tmp_path / "map.pkl.gz")
    got = texport.export_from_checkpoints(str(pth), out, device="cpu", **kw)
    assert got.keys() == ref.keys() and len(got) >= 2
    for oid in ref:
        a, b = got[oid], ref[oid]
        np.testing.assert_array_equal(a["mesh"]["faces"], b["mesh"]["faces"])
        np.testing.assert_allclose(a["mesh"]["vertices"], b["mesh"]["vertices"],
                                   atol=VERT_ATOL)
        np.testing.assert_allclose(a["part_feat"], b["part_feat"], atol=PART_ATOL)
        assert np.abs(a["color"].astype(int) - b["color"].astype(int)).max() <= 1
        assert a["class_id"] == b["class_id"]
        for k in ("clip_feat", "caption_feat"):
            np.testing.assert_array_equal(a[k], b[k])
    # the bundle the port wrote loads in both packages
    for bundle in (texport.load_map_bundle(out), jexport.load_map_bundle(out)):
        np.testing.assert_equal(bundle, got)
    # the .pth tree exports as its npz conversion does, bit for bit (the
    # reference's obj_center is 0)
    npz = tmp_path / "npz"
    jinterop.convert_checkpoint_dir(str(pth), str(npz))
    np.testing.assert_equal(got, texport.export_from_checkpoints(str(npz), "", device="cpu",
                                                                 **kw))
