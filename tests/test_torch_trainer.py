"""The slice as a whole: the port's training steps and SceneMapper against
the JAX package (the step losses of each field path and dtype are
tests/test_torch_trainer_steps.py's, the field's dispatch by shape
tests/test_torch_trainer_dispatch.py's, on this file's helpers).

The step tests feed both packages byte-identical ray batches: the JAX
``train_frame`` regenerates them internally from its key, and
``scripts/reference_twin.py``'s ``export_frame_batches`` replays the same key
splits to export them as numpy, which the port's ``run_step`` consumes from
the JAX initial state carried across by ``convert``.
"""

import dataclasses
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
from torch_threads import one_torch_thread  # noqa: E402,F401

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


def _shared(jcfg):
    """``jcfg`` as the JAX initialiser and samplers see it: they read
    neither compute_dtype nor field_impl, so the cases share their
    compiles."""
    return dataclasses.replace(jcfg, compute_dtype="f32", field_impl="xla")


def _step_losses(monkeypatch, jcfg, tcfg):
    """(port's per-step losses on injected batches, JAX train_frame's)."""
    cam, store, fg, bg = _scene_inputs()
    key = jax.random.PRNGKey(3)
    state = _JIT_INIT(jax.random.PRNGKey(0), _shared(jcfg), n_slots=4)
    state_np = jax.tree.map(np.asarray, state)
    export = _export_frame_batches(monkeypatch)
    fg_steps, bg_steps = export(key, store, cam.ray_dirs(), fg, bg, _shared(jcfg))
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
    # sample_per_step trains the grown state too
    _, more = ttrainer.train_frame(state2, store, cam_dirs, tfg, tbg, gen,
                                   ttrainer.TrainConfig(sample_per_step=True, **CFG_KW))
    assert more.shape == (4,) and torch.isfinite(more).all()


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


# --------------------------------------------------------------------------- #
# the draw-order options: z_per_step, sample_per_step
# --------------------------------------------------------------------------- #


def _law_scene(depth_names_frame: bool = True):
    """Three frames of constant depth, 1, 2 and 3 m (the depth of a ray
    names its frame) or 2 m in all three (a ray's law then does not depend
    on its frame), the left quarter invalid (depth 0), instance 1 on the
    right half and -1 (unknown) on the rest; objects 1 and 2 see the same
    pixels as "this" and "other"; n_kf 3, the latest two frames 1 and 2."""
    store = init_frame_store(3, 24, 32, part_feat_dim=16, part_down=4)
    rng = np.random.default_rng(0)
    for f in range(3):
        depth = np.full((24, 32), 1.0 + f if depth_names_frame else 2.0, np.float32)
        depth[:, :8] = 0.0
        inst = np.full((24, 32), -1, np.int32)
        inst[:, 16:] = 1
        store, _ = append_frame(
            store, rng.integers(0, 255, (24, 32, 3)).astype(np.uint8), depth, inst,
            np.eye(4, dtype=np.float32), partfeat=rng.normal(size=(6, 8, 16)).astype(np.float32))
    fg = {
        "kf_frames": jnp.tile(jnp.arange(3, dtype=jnp.int32), (2, 1)),
        "kf_bbox": jnp.tile(jnp.asarray([0, 24, 0, 32], jnp.float32), (2, 3, 1)),
        "n_kf": jnp.full((2,), 3, jnp.int32),
        "latest2": jnp.tile(jnp.asarray([1, 2], jnp.int32), (2, 1)),
        "active": jnp.asarray([True, True]),
        "obj_inst": jnp.asarray([1, 2], jnp.int32),
        "obj_center": jnp.zeros((2, 3), jnp.float32),
    }
    cam = jscene.Camera(width=32, height=24, fx=20.0, fy=20.0, cx=16.0, cy=12.0)
    return cam, store, fg


def _torch_store(store):
    return tfs.FrameStore(
        packed=torch.from_numpy(np.asarray(store.packed).view(np.int32)),
        t_wc=torch.from_numpy(np.asarray(store.t_wc)),
        partfeat=torch.from_numpy(np.asarray(store.partfeat)),
        n_frames=int(store.n_frames))


def _t(x):
    return torch.from_numpy(np.array(x))


def _ks_per_bin(zj, zt):
    """Two-sample KS per order statistic (the lattice's bins)."""
    from scipy import stats

    for i in range(zj.shape[-1]):
        assert stats.ks_2samp(zj[..., i].ravel(), zt[..., i].ravel()).pvalue > 1e-3, i


def test_z_per_step_draws_match_jax():
    """z_per_step: the batch carries the frame's per-object depth bound
    (equal in both packages), and each step's lattice drawn from it
    follows JAX resolve_z's law (KS per bin over 40 steps x 16 rays, per
    object; one depth in every frame, so that the rays' laws are the
    same whichever frames the draws picked)."""
    cfg_kw = dict(CFG_KW, n_iters_per_frame=40, z_per_step=True, hidden=8)
    jcfg, tcfg = jtrainer.TrainConfig(**cfg_kw), ttrainer.TrainConfig(**cfg_kw)
    cam, store, fg = _law_scene(depth_names_frame=False)
    jb = _JIT_FG(jax.random.PRNGKey(5), store, cam.ray_dirs(), fg, jcfg, scan_order=True)
    assert "z" not in jb and jb["zkey"].shape == (40, 2)
    zj = jax.jit(jax.vmap(lambda sl: jtrainer.resolve_z(sl, jcfg, False)["z"]))(
        {k: jb[k] for k in ("depth", "state", "zkey", "max_bound")})
    gen = torch.Generator().manual_seed(5)
    tfg = {k: torch.from_numpy(np.asarray(v)) for k, v in fg.items()}
    tb = ttrainer.sample_fg_batch(gen, _torch_store(store), _t(cam.ray_dirs()), tfg, tcfg,
                                  scan_order=True)
    assert "z" not in tb and tb["max_bound"].shape == (40, 2, 1)
    np.testing.assert_array_equal(tb["max_bound"].numpy(), np.asarray(jb["max_bound"]))
    zt = torch.stack([ttrainer.resolve_z(gen, {k: tb[k][i] for k in ("depth", "state",
                                                                      "max_bound")},
                                         tcfg, False)["z"] for i in range(40)])
    assert zt.shape == zj.shape == (40, 2, 16, 10)
    for obj in range(2):   # object 0 sees "this" pixels, object 1 "other" ones
        _ks_per_bin(np.asarray(zj)[:, obj], zt[:, obj].numpy())


def test_sample_per_step_draws_match_jax():
    """sample_per_step: each step's batch (n_iters=1) puts the two latest
    keyframes at the end of its window in both packages (the depth of a ray
    names its frame), the earlier draws cover every keyframe, and the
    lattices follow the same law (KS per bin over 40 steps)."""
    jcfg = jtrainer.TrainConfig(**dict(CFG_KW, sample_per_step=True, win_size=4))
    tcfg = ttrainer.TrainConfig(**dict(CFG_KW, sample_per_step=True, win_size=4))
    cam, store, fg = _law_scene()
    tfg = {k: torch.from_numpy(np.asarray(v)) for k, v in fg.items()}
    tstore, gen = _torch_store(store), torch.Generator().manual_seed(6)
    keys = jax.random.split(jax.random.PRNGKey(6), 40)
    jz, tz, first = [], [], set()
    for k in keys:
        jb = _JIT_FG(k, store, cam.ray_dirs(), fg, jcfg, n_iters=1)
        tb = ttrainer.sample_fg_batch(gen, tstore, _t(cam.ray_dirs()), tfg, tcfg, n_iters=1)
        for b, d in ((jb, np.asarray(jb["depth"])), (tb, tb["depth"].numpy())):
            assert d.shape == (2, 32)        # one step: 4 draws x 8 pixels
            last = d[:, 16:]
            assert set(np.unique(last[last > 0])) <= {2.0, 3.0}
            assert set(np.unique(d[:, 24:][d[:, 24:] > 0])) <= {3.0}
            first |= set(np.unique(d[:, :16][d[:, :16] > 0]).tolist())
        jz.append(np.asarray(jb["z"]))
        tz.append(tb["z"].numpy())
    assert first == {1.0, 2.0, 3.0}
    for obj in range(2):
        _ks_per_bin(np.stack(jz)[:, obj], np.stack(tz)[:, obj])


@pytest.mark.parametrize("kw", [dict(z_per_step=True), dict(sample_per_step=True)])
def test_draw_order_options_train_like_upfront(kw):
    """20 steps with the option land near the upfront path's loss (the JAX
    package's test_z_per_step_trains: the trailing 5 losses' means within
    half of the upfront path's)."""
    cam, store_j, fg = _law_scene()
    tfg = {k: torch.from_numpy(np.asarray(v)) for k, v in fg.items()}
    bg = {k: tfg[k][0] for k in ("kf_frames", "kf_bbox", "latest2")}
    bg["n_kf"] = torch.tensor(3, dtype=torch.int32)
    finals = {}
    for on in (False, True):
        cfg = ttrainer.TrainConfig(**dict(CFG_KW, n_iters_per_frame=20, **(kw if on else {})))
        gen = torch.Generator().manual_seed(0)
        state = ttrainer.init_train_state(gen, cfg, n_slots=2, device="cpu")
        _, losses = ttrainer.train_frame(state, _torch_store(store_j), _t(cam.ray_dirs()),
                                         tfg, bg, gen, cfg)
        assert torch.isfinite(losses).all()
        finals[on] = float(losses[-5:].mean())
    assert abs(finals[True] - finals[False]) < 0.5 * max(finals[False], 1.0)


# --------------------------------------------------------------------------- #
# one step's gradients in float64
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("max_deg", [5])
def test_step_grads_match_jax_in_float64(max_deg, monkeypatch):
    """One training step's loss and gradients (every fg and bg leaf) in
    float64 in both packages, on the same batch: the port through the
    kernels' plain version (max_deg 5), the JAX
    package through its XLA field under enable_x64. Loss rel 1e-12, leaves
    rel 1e-9: roundoff, where f32 agrees to 1e-5. Part mode is off: the
    JAX part term casts its weights to float32 whatever the input's type
    (losses.factored_cosine_loss), so it cannot be held to float64."""
    cfg_kw = dict(CFG_KW, max_deg=max_deg, part_mode=False)
    jcfg, tcfg = jtrainer.TrainConfig(**cfg_kw), ttrainer.TrainConfig(**cfg_kw)
    cam, store, fg, bg = _scene_inputs()
    # the state and batches of the step tests' config (part features drawn
    # too, which the losses here do not read): their compiles are shared
    drawn = _shared(dataclasses.replace(jcfg, part_mode=True))
    state = jax.tree.map(np.asarray, _JIT_INIT(jax.random.PRNGKey(0), drawn, n_slots=4))
    fg_steps, bg_steps = _export_frame_batches(monkeypatch)(
        jax.random.PRNGKey(3), store, cam.ray_dirs(), fg, bg, drawn)

    def f64(tree):
        return jax.tree.map(lambda x: x.astype(np.float64) if x.dtype == np.float32 else x, tree)

    params = {"fg": f64(state.fg_params), "bg": f64(state.bg_params)}
    fsl, bsl = f64(fg_steps[0]), f64(bg_steps[0])
    active = np.asarray(fg["active"])
    with jax.enable_x64(True):
        def jloss(ps):
            t, _ = jtrainer._loss_for_slice(ps["fg"], fsl, active, jcfg, is_bg=False)
            return t + jtrainer._loss_for_slice(ps["bg"], bsl, None, jcfg, is_bg=True)[0]

        l0, g0 = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, params))
        l0, g0 = float(l0), jax.tree.map(np.asarray, g0)

    total, leaves = 0.0, []
    for part, sl, act in (("fg", fsl, torch.from_numpy(active)), ("bg", bsl, None)):
        tp, wrt = ttrainer.differentiable(convert.params_from_numpy(params[part], "cpu"))
        assert tp["mlp"]["mid1"]["w"].dtype == torch.float64
        t, _ = ttrainer._loss_for_slice(tp, {k: torch.from_numpy(v) for k, v in sl.items()},
                                        act, tcfg, is_bg=part == "bg")
        total = total + t
        leaves += [((part,) + q, x) for q, x in wrt]
    grads = torch.autograd.grad(total, [x for _, x in leaves], allow_unused=True)
    assert total.dtype == torch.float64
    assert abs(float(total) - l0) <= 1e-12 * abs(l0)
    for (path, _), g in zip(leaves, grads):
        ref = g0
        for k in path:
            ref = ref[k]
        got = np.zeros_like(ref) if g is None else g.numpy()
        assert np.abs(got - ref).max() <= 1e-9 * (np.abs(ref).max() + 1e-30), path
