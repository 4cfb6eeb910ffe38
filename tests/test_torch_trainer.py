"""The slice as a whole: the port's training steps and SceneMapper against
the JAX package.

The step test feeds both packages byte-identical ray batches: the JAX
``train_frame`` regenerates them internally from its key, and
``scripts/reference_twin.py``'s ``export_frame_batches`` replays the same key
splits to export them as numpy, which the port's ``run_step`` consumes from
the JAX initial state carried across by ``convert``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from openobj_tpu.core import scene as jscene  # noqa: E402
from openobj_tpu.core import trainer as jtrainer  # noqa: E402
from openobj_tpu.core.frame_store import append_frame, init_frame_store  # noqa: E402
from openobj_tpu.data import synthetic  # noqa: E402
from openobj_torch import convert  # noqa: E402
from openobj_torch.core import frame_store as tfs  # noqa: E402
from openobj_torch.core import scene as tscene  # noqa: E402
from openobj_torch.core import trainer as ttrainer  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

CFG_KW = dict(n_iters_per_frame=4, win_size=2, n_samples_per_frame=8,
              win_size_bg=2, n_samples_per_frame_bg=16, hidden=8, hidden_bg=16,
              clip_size=16, part_mode=True, part_down=4)


def _export_frame_batches(monkeypatch):
    """``export_frame_batches`` with the JAX samplers it calls jitted (the
    same functions, compiled once instead of op by op)."""
    spec = importlib.util.spec_from_file_location(
        "reference_twin", ROOT / "scripts" / "reference_twin.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(jtrainer, "sample_fg_batch", _JIT_FG)
    monkeypatch.setattr(jtrainer, "sample_bg_batch", _JIT_BG)
    return mod.export_frame_batches


_STATIC = ("cfg", "n_iters", "scan_order")
_JIT_FG = jax.jit(jtrainer.sample_fg_batch, static_argnames=_STATIC)
_JIT_BG = jax.jit(jtrainer.sample_bg_batch, static_argnames=_STATIC)
_JIT_INIT = jax.jit(jtrainer.init_train_state, static_argnames=("cfg", "n_slots"))


def _scene_inputs():
    cam = jscene.Camera(width=32, height=24, fx=20.0, fy=20.0, cx=16.0, cy=12.0)
    store = init_frame_store(3, 24, 32, part_feat_dim=16, part_down=4)
    rng = np.random.default_rng(0)
    for _ in range(2):
        store, _ = append_frame(
            store, rng.integers(0, 255, (24, 32, 3)).astype(np.uint8),
            rng.uniform(0.5, 3.0, (24, 32)).astype(np.float32),
            rng.integers(-1, 3, (24, 32)).astype(np.int32),
            np.eye(4, dtype=np.float32),
            partfeat=rng.normal(size=(6, 8, 16)).astype(np.float32))
    fg = {
        "kf_frames": jnp.zeros((4, 3), jnp.int32).at[:, 1].set(1),
        "kf_bbox": jnp.tile(jnp.asarray([0, 24, 0, 32], jnp.float32), (4, 3, 1)),
        "n_kf": jnp.full((4,), 2, jnp.int32),
        "latest2": jnp.tile(jnp.asarray([0, 1], jnp.int32), (4, 1)),
        "active": jnp.asarray([True, True, False, False]),
        "obj_inst": jnp.arange(1, 5, dtype=jnp.int32),
        "obj_center": jnp.zeros((4, 3), jnp.float32),
    }
    bg = {"kf_frames": fg["kf_frames"][0], "kf_bbox": fg["kf_bbox"][0],
          "n_kf": jnp.asarray(2, jnp.int32), "latest2": fg["latest2"][0]}
    return cam, store, fg, bg


def _step_losses(monkeypatch, jcfg, tcfg):
    """(port's per-step losses on injected batches, JAX train_frame's)."""
    cam, store, fg, bg = _scene_inputs()
    key = jax.random.PRNGKey(3)
    state = _JIT_INIT(jax.random.PRNGKey(0), jcfg, n_slots=4)
    state_np = jax.tree.map(np.asarray, state)
    export = _export_frame_batches(monkeypatch)
    fg_steps, bg_steps = export(key, store, cam.ray_dirs(), fg, bg, jcfg)
    _, jlosses = jtrainer.train_frame(state, store, cam.ray_dirs(), fg, bg, key, jcfg)
    jlosses = np.asarray(jlosses)

    ts = convert.train_state_from_numpy(state_np, "cpu")
    active = torch.from_numpy(np.array(fg["active"]))
    tlosses = []
    for fsl, bsl in zip(fg_steps, bg_steps):
        ts, loss = ttrainer.run_step(
            ts, {k: torch.from_numpy(np.array(v)) for k, v in fsl.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in bsl.items()}, active, tcfg)
        tlosses.append(float(loss))
    return np.array(tlosses), jlosses


@pytest.mark.parametrize("field_impl", ["xla", "pallas"])
def test_step_losses_match_jax_train_frame(field_impl, monkeypatch):
    jcfg = jtrainer.TrainConfig(field_impl=field_impl, **CFG_KW)
    tcfg = ttrainer.TrainConfig(field_impl=field_impl, **CFG_KW)
    tlosses, jlosses = _step_losses(monkeypatch, jcfg, tcfg)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert len(set(tlosses)) == len(tlosses)   # every step moved the params


# (config overrides, fg steps through the kernels' plain version, bg steps
# through it); every other field call takes the eager field
_C1_CASES = {
    "max_deg4": (dict(max_deg=4, hidden=32, hidden_bg=128), 0, 0),
    "h32_bg16": (dict(hidden=32), 1, 1),
    "h32_bg128": (dict(hidden=32, hidden_bg=128), 1, 1),    # the tensor-core widths
}


@pytest.mark.parametrize("case", list(_C1_CASES))
def test_field_dispatch_by_shape(case, monkeypatch):
    """A shape the kernels do not cover (another PE band count) trains
    through the eager field and matches JAX's default XLA field, rel 1e-4;
    covered shapes (max_deg 5, f32, any hidden width: K1 and K2 have a
    SIMT kernel beside the tensor-core ones) take the kernels' path, their
    plain version here, on both fields. (CFG_KW's own widths, 8 and 16, are
    covered too: the test above.)"""
    from openobj_torch.ops import fused_field as tff

    kw, fg_fused, bg_fused = _C1_CASES[case]
    cfg_kw = dict(CFG_KW, **kw)
    jcfg, tcfg = jtrainer.TrainConfig(**cfg_kw), ttrainer.TrainConfig(**cfg_kw)
    tff.reset_counts()
    tlosses, jlosses = _step_losses(monkeypatch, jcfg, tcfg)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    steps = cfg_kw["n_iters_per_frame"]
    assert tff.COUNTS["fused_field_plain"] == steps * (fg_fused + bg_fused)
    assert tff.COUNTS["field_eager"] == steps * (2 - fg_fused - bg_fused)


def test_port_train_frame_runs_and_grows():
    """The port's own sampler + train_frame on the same store, and slot
    growth keeping the old slots."""
    cfg = ttrainer.TrainConfig(**CFG_KW)
    _, store_j, fg, bg = _scene_inputs()
    store = tfs.FrameStore(
        packed=torch.from_numpy(np.asarray(store_j.packed).view(np.int32)),
        t_wc=torch.from_numpy(np.asarray(store_j.t_wc)),
        partfeat=torch.from_numpy(np.asarray(store_j.partfeat)),
        n_frames=int(store_j.n_frames))
    gen = torch.Generator().manual_seed(0)
    state = ttrainer.init_train_state(gen, cfg, n_slots=4, device="cpu")
    tfg = {k: torch.from_numpy(np.asarray(v)) for k, v in fg.items()}
    tbg = {k: torch.from_numpy(np.asarray(v)) for k, v in bg.items()}
    cam_dirs = tscene.Camera(32, 24, 20.0, 20.0, 16.0, 12.0).ray_dirs("cpu")
    batch = ttrainer.sample_fg_batch(gen, store, cam_dirs, tfg, cfg, scan_order=True)
    assert batch["z"].shape == (4, 4, 16, 10)
    assert batch["partfeat_idx"].max() < 3 * 6 * 8
    state2, losses = ttrainer.train_frame(state, store, cam_dirs, tfg, tbg, gen, cfg)
    assert losses.shape == (4,) and torch.isfinite(losses).all()
    # dead slots stay as they were
    w0, w1 = state.fg_params["mlp"]["mid1"]["w"], state2.fg_params["mlp"]["mid1"]["w"]
    assert torch.equal(w0[2:], w1[2:]) and not torch.equal(w0[:2], w1[:2])
    grown = ttrainer.grow_train_state(gen, state2, cfg, 8)
    assert grown.n_slots == 8
    assert torch.equal(grown.fg_params["mlp"]["mid1"]["w"][:4], w1)
    assert grown.fg_opt.count.tolist()[4:] == [0, 0, 0, 0]
    with pytest.raises(NotImplementedError):
        ttrainer.train_frame(state2, store, cam_dirs, tfg, tbg, gen,
                             ttrainer.TrainConfig(sample_per_step=True, **CFG_KW))


@pytest.mark.parametrize("n_frames,capacity", [(3, 4), (6, 4)])
def test_scene_mappers_agree(n_frames, capacity):
    """Both SceneMappers over the same synthetic frames: identical registry
    tables, store slots and store planes; the port's losses are finite. With
    6 frames in a 4-frame store, frames that fell out of every keyframe ring
    are evicted and their slots recycled."""
    kw = dict(CFG_KW, n_iters_per_frame=2)
    jcfg, tcfg = jtrainer.TrainConfig(**kw), ttrainer.TrainConfig(**kw)
    cam_kw = dict(width=64, height=48, fx=40.0, fy=40.0, cx=32.0, cy=24.0)
    jm = jscene.SceneMapper(jscene.Camera(**cam_kw), jcfg, frame_capacity=capacity,
                            max_objects=8, seed=0)
    tm = tscene.SceneMapper(tscene.Camera(**cam_kw), tcfg, frame_capacity=capacity,
                            max_objects=8, seed=0, device="cpu")
    scene = synthetic.default_scene(n_spheres=2)
    dirs = np.asarray(jscene.Camera(**cam_kw).ray_dirs())
    rng = np.random.default_rng(0)
    losses = []
    for rgb, depth, inst, t_wc in synthetic.make_sequence(scene, dirs, n_frames=n_frames):
        pf = rng.normal(size=(12, 16, 16)).astype(np.float32)
        jm.process_frame(rgb, depth, inst, t_wc, partfeat=pf)
        losses.append(tm.process_frame(rgb, depth, inst, t_wc, partfeat=pf))
    jm.finish()
    tm.finish()
    assert tm.n_objects == jm.n_objects == 2
    jr, tr = jm.registry, tm.registry
    for name in ("kf_frames", "kf_bbox", "n_kf", "latest2", "active", "obj_inst",
                 "bg_kf_frames", "bg_kf_bbox", "bg_latest2"):
        np.testing.assert_array_equal(getattr(tr, name), getattr(jr, name), err_msg=name)
    assert tm.frame_slots == jm.frame_slots
    assert len(set(tm.frame_slots)) == min(n_frames, capacity)
    np.testing.assert_array_equal(tm.store.packed.numpy(),
                                  np.asarray(jm.store.packed).view(np.int32))
    np.testing.assert_array_equal(tm.store.t_wc.numpy(), np.asarray(jm.store.t_wc))
    np.testing.assert_array_equal(tm.store.partfeat.numpy(), np.asarray(jm.store.partfeat))
    assert all(torch.isfinite(x).all() for x in losses)
    assert len(tm.loss_history) == n_frames and np.isfinite(tm.loss_history).all()
