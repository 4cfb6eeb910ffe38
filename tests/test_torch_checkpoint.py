"""Checkpoints written by either package load in the other.

Per object: a JAX-written ``obj_<id>.npz`` loads in the port, and the
port's in JAX, with the same keys, bit-identical leaves (so identical field
outputs) and the same box and metadata. Whole mappers: ``save_scene`` ->
``load_scene`` across the packages restores equal params, optimizer state
and registry tables.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from openobj_tpu.core import checkpoint as jck  # noqa: E402
from openobj_tpu.core import scene as jscene  # noqa: E402
from openobj_tpu.core import trainer as jtrainer  # noqa: E402
from openobj_tpu.data import synthetic  # noqa: E402
from openobj_tpu.models import object_field as jof  # noqa: E402
from openobj_tpu.utils.geometry import OrientedBox as JBox  # noqa: E402
from openobj_torch import convert  # noqa: E402
from openobj_torch.core import checkpoint as tck  # noqa: E402
from openobj_torch.core import scene as tscene  # noqa: E402
from openobj_torch.core import trainer as ttrainer  # noqa: E402
from openobj_torch.models import object_field as tof  # noqa: E402
from openobj_torch.ops import fused_field as tff  # noqa: E402

CFG_KW = dict(n_iters_per_frame=2, win_size=2, n_samples_per_frame=8, win_size_bg=2,
              n_samples_per_frame_bg=16, hidden=8, hidden_bg=16, clip_size=16)
CAM_KW = dict(width=32, height=24, fx=20.0, fy=20.0, cx=16.0, cy=12.0)


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + rng.normal(size=np.shape(x))
                                   ).astype(np.asarray(x).dtype), tree)


def _obj_files():
    p = _noisy(jof.init_field_params(jax.random.PRNGKey(0), hidden=8, clip_size=16), 1)
    box = JBox(center=np.array([0.1, 0.2, 1.5]), r=np.eye(3)[[1, 0, 2]] * [1, 1, -1],
               extent=np.array([0.3, 0.4, 0.5]))
    meta = dict(obj_scale=2.0, bbox3d=box, obj_center=np.array([0.1, 0.0, 1.4]),
                clip_feats=np.ones((2, 16)), caption_feats=np.zeros((3, 8)), semantic_id=7)
    return p, meta


def _assert_same_ckpt(a, b):
    assert a["obj_id"] == b["obj_id"] and a["semantic_id"] == b["semantic_id"]
    assert a["obj_scale"] == b["obj_scale"]
    for k in ("obj_center", "clip_feats", "caption_feats"):
        np.testing.assert_array_equal(a[k], b[k])
    for k in ("center", "r", "extent"):
        np.testing.assert_array_equal(getattr(a["bbox"], k), getattr(b["bbox"], k))


def test_jax_object_checkpoint_loads_in_port(tmp_path):
    p, meta = _obj_files()
    path = str(tmp_path / "ckpt" / "3" / "obj_3.npz")
    jck.save_object_checkpoint(path, 3, p, **meta)
    ref = jck.load_object_checkpoint(path, p)
    template = tof.init_field_params(torch.Generator().manual_seed(5), hidden=8,
                                     clip_size=16, device="cpu")
    got = tck.load_object_checkpoint(path, template)
    _assert_same_ckpt(got, ref)
    want = convert.params_from_numpy(p, "cpu")
    tof.tree_map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b.numpy()),
                 got["params"], want)
    pts = torch.from_numpy(np.random.default_rng(2).normal(size=(50, 3)).astype(np.float32))
    for x, y in zip(tff.field_evaluator(got["params"], stacked=False)(pts),
                    tff.field_evaluator(want, stacked=False)(pts)):
        assert torch.equal(x, y)


def test_port_object_checkpoint_loads_in_jax(tmp_path):
    p, meta = _obj_files()
    path_t = str(tmp_path / "t" / "obj_3.npz")
    path_j = str(tmp_path / "j" / "obj_3.npz")
    tck.save_object_checkpoint(path_t, 3, convert.params_from_numpy(p, "cpu"), **meta)
    jck.save_object_checkpoint(path_j, 3, p, **meta)
    zt, zj = np.load(path_t), np.load(path_j)
    assert sorted(zt.files) == sorted(zj.files)
    for k in zj.files:
        assert zt[k].dtype == zj[k].dtype and zt[k].shape == zj[k].shape, k
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    got = jck.load_object_checkpoint(path_t, p)
    _assert_same_ckpt(got, jck.load_object_checkpoint(path_j, p))
    pts = jnp.asarray(np.random.default_rng(2).normal(size=(50, 3)).astype(np.float32))
    for x, y in zip(jof.field_apply(got["params"], pts), jof.field_apply(p, pts)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _mappers(n_frames=3):
    """Both mappers over the same frames, without training (identical
    registries); every state leaf then made random, the same in both."""
    jcfg, tcfg = jtrainer.TrainConfig(**CFG_KW), ttrainer.TrainConfig(**CFG_KW)
    jm = jscene.SceneMapper(jscene.Camera(**CAM_KW), jcfg, frame_capacity=4,
                            max_objects=8, initial_bucket=4)
    tm = tscene.SceneMapper(tscene.Camera(**CAM_KW), tcfg, frame_capacity=4,
                            max_objects=8, initial_bucket=4, device="cpu")
    dirs = np.asarray(jm.camera.ray_dirs())
    seq = synthetic.make_sequence(synthetic.default_scene(n_spheres=2), dirs, n_frames)
    for rgb, depth, inst, t_wc in seq:
        jm.process_frame(rgb, depth, inst, t_wc, train=False)
        tm.process_frame(rgb, depth, inst, t_wc, train=False)
    st = jax.tree.map(np.asarray, jm.state)
    rep = dataclasses.replace
    st = rep(st, fg_params=_noisy(st.fg_params, 3), bg_params=_noisy(st.bg_params, 4),
             fg_opt=rep(st.fg_opt, mu=_noisy(st.fg_opt.mu, 5), nu=_noisy(st.fg_opt.nu, 6),
                        count=np.arange(4, dtype=np.int32) + 1),
             bg_opt=rep(st.bg_opt, mu=_noisy(st.bg_opt.mu, 7), nu=_noisy(st.bg_opt.nu, 8),
                        count=np.asarray(9, np.int32)))
    jm.state = jax.tree.map(jnp.asarray, st)
    tm.state = convert.train_state_from_numpy(st, "cpu")
    return jm, tm


def _fresh():
    jm = jscene.SceneMapper(jscene.Camera(**CAM_KW), jtrainer.TrainConfig(**CFG_KW),
                            frame_capacity=2, max_objects=8, initial_bucket=2)
    tm = tscene.SceneMapper(tscene.Camera(**CAM_KW), ttrainer.TrainConfig(**CFG_KW),
                            frame_capacity=2, max_objects=8, initial_bucket=2, device="cpu")
    return jm, tm


_META = ("kf_frames", "kf_bbox", "n_kf", "latest2", "active", "obj_inst",
         "bg_kf_frames", "bg_kf_bbox", "bg_latest2")


def _assert_same_mapper(tm, jm):
    st = jax.tree.map(np.asarray, jm.state)
    want = {"fg_params": st.fg_params, "bg_params": st.bg_params}
    for k in ("fg_opt", "bg_opt"):
        o = getattr(st, k)
        want[k] = {"mu": o.mu, "nu": o.nu, "count": o.count}
    got = convert.to_numpy(tm.state)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b) or
                 np.testing.assert_equal(a.dtype, b.dtype), got, want)
    for name in _META:
        np.testing.assert_array_equal(getattr(tm.registry, name),
                                      getattr(jm.registry, name), err_msg=name)
    assert tm.registry.inst_to_slot == jm.registry.inst_to_slot
    assert tm.frame_slots == jm.frame_slots and tm.frame_count == jm.frame_count
    assert tm.store.capacity == jm.store.capacity
    assert tm.registry.bg.n_kf == jm.registry.bg.n_kf


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_scene_snapshot_across_packages(direction, tmp_path):
    jm, tm = _mappers()
    jm2, tm2 = _fresh()
    if direction == "jax_to_port":
        jck.save_scene(str(tmp_path), jm)
        tck.load_scene(str(tmp_path), tm2)
        _assert_same_mapper(tm2, jm)
    else:
        tck.save_scene(str(tmp_path), tm)
        jck.load_scene(str(tmp_path), jm2)
        _assert_same_mapper(tm, jm2)
    restored = tm2 if direction == "jax_to_port" else jm2
    assert restored.state.n_slots == 4    # grown from 2 to the snapshot's slots


def test_scene_slot_params():
    _, tm = _mappers(2)
    inst, slot = next(iter(tm.registry.inst_to_slot.items()))
    got = tm.params_for_instance(inst)
    tof.tree_map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b.numpy()),
                 got, tof.slice_slot(tm.state.fg_params, slot))
    assert tm.params_for_instance(0) is tm.state.bg_params
