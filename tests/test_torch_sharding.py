"""The object axis split across ranks (openobj_torch.parallel.sharding) and
the sharded snapshot (core.checkpoint.save_scene_sharded / load_scene_sharded),
on CPU processes joined by torch.distributed with gloo, as
tests/test_sharding.py and tests/test_geometry_export.py run the JAX package's
on a virtual 8-device mesh.

One group of 2 and one of 4 processes run at once, each rank every case of its
world size (``_child`` below, run with ``sys.modules["jax"] = None``), and
write their results; the tests read them. The config is test_sharding.py's:
8 slots, h 16, clip 4, 32x24, 2 iterations. Sharded step losses are held to
the port's unsharded ones, and a sharded ``run_step`` on batches injected
from ``scripts/reference_twin.py``'s ``export_frame_batches`` (on the
object mesh and on the "data" x "object" one) to the JAX package's
single-device ``train_frame``, at test_sharding.py's rtol 2e-5: a rank's K2
tiles and the loss's sum over objects add in another order. The parameters
after a sharded frame are held to the unsharded frame's, block by block.

The mapper on a split object axis (``SceneMapper.process_frame`` inside
``use_mesh``) runs the lifecycle of test_sharding.py's dry run on "object"
2, "object" 4 and "data" 2 x "object" 2: a frame at bucket 8, a frame past
it (growth 8 -> 16), ``save_scene`` / ``load_scene``, one more frame, held
to the unsharded mapper's run in the same process; the npz it writes to
the unsharded mapper's. ``render_frame_batched`` over 2 and 4 object ranks
is held to the JAX package's, with its draws replayed as
tests/test_torch_renderer.py does, and the refusals of a split axis are
checked.
"""

import importlib.util
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RTOL = 2e-5          # tests/test_sharding.py:179, :237
PARAM_ATOL = 1e-6    # the params after a frame at lr 1e-3
# the mapper's three frames (six AdamW steps) with the rays split over
# "data": each step's gradients are summed in another order, and where a
# gradient is rounding noise (|mu| ~ 5e-10, nu ~ 4e-20) AdamW's
# mu / sqrt(nu) makes a step of about lr (1e-3) whose sign is the noise's;
# later gradients follow the moved params. The bound is six such steps
# (measured: 9.1e-4 on the fg blocks, 2.0e-5 on bg; the losses within
# 3.1e-7). A block of the wrong slots is off by the init's scale, ~0.1-1.
# On "object" alone the blocks and the npz equal the unsharded mapper's
# bit for bit.
DATA_PARAM_ATOL = 6e-3

CFG_KW = dict(n_iters_per_frame=2, win_size=2, n_samples_per_frame=8,
              win_size_bg=2, n_samples_per_frame_bg=8,
              hidden=16, hidden_bg=16, clip_size=4)
# the sharded render: test_torch_renderer.py's scene at 8 objects, one
# inactive and one transparent, and its test_render_frame_batched's settings
RENDER_KW = dict(n_bins=16, max_hit_rays=192, chunk=32)
RENDER_BIAS = (0.6, 0.4, 0.8, 0.5, -3.0, 0.7, 0.3, 0.9)
RENDER_ACTIVE = (1, 1, 1, 0, 1, 1, 1, 1)


# --------------------------------------------------------------------------- #
# the inputs, made alike in both packages
# --------------------------------------------------------------------------- #


def _frame():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 255, (24, 32, 3)).astype(np.uint8),
            rng.uniform(0.5, 3.0, (24, 32)).astype(np.float32),
            rng.integers(-1, 4, (24, 32)).astype(np.int32),
            np.eye(4, dtype=np.float32))


def _tables_np():
    fg = {
        "kf_frames": np.zeros((8, 2), np.int32),
        "kf_bbox": np.tile(np.asarray([0, 24, 0, 32], np.float32), (8, 2, 1)),
        "n_kf": np.ones((8,), np.int32),
        "latest2": np.zeros((8, 2), np.int32),
        "active": np.ones((8,), bool),
        "obj_inst": np.arange(8, dtype=np.int32),
        "obj_center": np.zeros((8, 3), np.float32),
    }
    bg = {"kf_frames": fg["kf_frames"][0], "kf_bbox": fg["kf_bbox"][0],
          "n_kf": np.asarray(1, np.int32), "latest2": fg["latest2"][0]}
    return fg, bg


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[prefix + k] = np.asarray(v)
    return out


def _nest(flat, prefix):
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            node = out
            *path, last = k[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[last] = v
    return out


def _jax_reference(path):
    """The JAX package's single-device train_frame on test_sharding.py's
    inputs, its initial state and the per-step batches it consumed
    (export_frame_batches, its samplers jitted as test_torch_trainer.py
    does), written to ``path`` (whole, by a rename)."""
    import jax
    import jax.numpy as jnp

    from openobj_tpu.core import trainer as jtrainer
    from openobj_tpu.core.frame_store import append_frame, init_frame_store
    from openobj_tpu.core.scene import Camera

    spec = importlib.util.spec_from_file_location(
        "reference_twin", os.path.join(REPO, "scripts", "reference_twin.py"))
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    static = ("cfg", "n_iters", "scan_order")

    cfg = jtrainer.TrainConfig(**CFG_KW)
    cam = Camera(width=32, height=24, fx=20.0, fy=20.0, cx=16.0, cy=12.0)
    state = jax.jit(jtrainer.init_train_state, static_argnames=("cfg", "n_slots"))(
        jax.random.PRNGKey(0), cfg, n_slots=8)
    store, _ = append_frame(init_frame_store(2, 24, 32), *_frame())
    fg, bg = _tables_np()
    fg = {k: jnp.asarray(v) for k, v in fg.items()}
    bg = {k: jnp.asarray(v) for k, v in bg.items()}
    key = jax.random.PRNGKey(7)
    samplers = jtrainer.sample_fg_batch, jtrainer.sample_bg_batch
    jtrainer.sample_fg_batch = jax.jit(samplers[0], static_argnames=static)
    jtrainer.sample_bg_batch = jax.jit(samplers[1], static_argnames=static)
    try:
        fg_steps, bg_steps = twin.export_frame_batches(key, store, cam.ray_dirs(), fg, bg, cfg)
    finally:
        jtrainer.sample_fg_batch, jtrainer.sample_bg_batch = samplers
    st = jax.tree.map(np.asarray, state)      # train_frame donates the state
    _, losses = jtrainer.train_frame(state, store, cam.ray_dirs(), fg, bg, key, cfg)
    data = {"losses": np.asarray(losses)}
    data.update(_flat({"fg_params": st.fg_params, "fg_mu": st.fg_opt.mu, "fg_nu": st.fg_opt.nu,
                       "bg_params": st.bg_params, "bg_mu": st.bg_opt.mu, "bg_nu": st.bg_opt.nu},
                      "state/"))
    data["state/fg_count"] = np.asarray(st.fg_opt.count)
    data["state/bg_count"] = np.asarray(st.bg_opt.count)
    for i, (f, b) in enumerate(zip(fg_steps, bg_steps)):
        data.update(_flat(f, f"fg{i}/"))
        data.update(_flat(b, f"bg{i}/"))
    np.savez(path + ".part.npz", **data)
    os.replace(path + ".part.npz", path)


def _jax_render_reference(path):
    """The JAX package's render_frame_batched on test_torch_renderer.py's
    scene of 8 objects, its inputs and the draws its key splits give,
    written to ``path`` (whole, by a rename)."""
    import jax
    import jax.numpy as jnp

    import test_torch_renderer as ttr
    from openobj_tpu.core import renderer as jr

    p = ttr.make_params(8, alpha_bias=RENDER_BIAS)
    t_wo, ext, cen, origins, dirs, _, _ = ttr.scene(8)
    geo = {"t_wo": t_wo, "extents": ext, "centers": cen,
           "active": np.asarray(RENDER_ACTIVE, bool), "origins": origins, "dirs": dirs}
    key = jax.random.PRNGKey(7)
    ref = jr.render_frame_batched(p, *(jnp.asarray(v) for v in geo.values()), key,
                                  **RENDER_KW)
    draws = ttr.batched_draws(key, 8, RENDER_KW["max_hit_rays"], RENDER_KW["chunk"],
                              RENDER_KW["n_bins"])
    data = {**geo, **_flat(p, "params/"), "n_chunks": np.asarray(len(draws))}
    data.update({f"draw{c}": d for c, d in enumerate(draws)})
    data.update({f"ref_{k}": np.asarray(v) for k, v in ref.items()})
    np.savez(path + ".part.npz", **data)
    os.replace(path + ".part.npz", path)


# --------------------------------------------------------------------------- #
# the ranks' cases (each rank runs every case of its world size)
# --------------------------------------------------------------------------- #


def _port_inputs(gen_seed=0, n_slots=8, **cfg_kw):
    from openobj_torch.core import trainer
    from openobj_torch.core.frame_store import append_frame, init_frame_store
    from openobj_torch.core.scene import Camera

    cfg = trainer.TrainConfig(**{**CFG_KW, **cfg_kw})
    cam = Camera(width=32, height=24, fx=20.0, fy=20.0, cx=16.0, cy=12.0)
    state = trainer.init_train_state(torch.Generator().manual_seed(gen_seed), cfg,
                                     n_slots=n_slots, device="cpu")
    store, _ = append_frame(init_frame_store(2, 24, 32, device="cpu"), *_frame())
    fg, bg = _tables_np()
    fg = {k: torch.from_numpy(v) for k, v in fg.items()}
    bg = {k: torch.from_numpy(np.asarray(v)) for k, v in bg.items()}
    return cfg, cam.ray_dirs("cpu"), state, store, fg, bg


def _copy(state):
    from openobj_torch.core import optim, trainer
    from openobj_torch.models.object_field import tree_map

    def opt(o):
        return None if o is None else optim.AdamWState(
            tree_map(torch.clone, o.mu), tree_map(torch.clone, o.nu), o.count.clone())

    return trainer.TrainState(tree_map(torch.clone, state.fg_params), opt(state.fg_opt),
                              None if state.bg_params is None
                              else tree_map(torch.clone, state.bg_params), opt(state.bg_opt))


_UNSHARDED = {}


def _unsharded(**cfg_kw):
    """The port's unsharded frame (new state, losses), once per config."""
    from openobj_torch.core import trainer

    key = tuple(sorted(cfg_kw.items()))
    if key not in _UNSHARDED:
        cfg, dirs, state, store, fg, bg = _port_inputs(**cfg_kw)
        _UNSHARDED[key] = trainer.train_frame(state, store, dirs, fg, bg,
                                              torch.Generator().manual_seed(7), cfg)
    return _UNSHARDED[key]


def _frame_losses(mesh, **cfg_kw):
    """(unsharded losses, sharded losses on ``mesh``, the fg leaves'
    leading sizes after the sharded frame, whether they are plain
    contiguous tensors, and the largest |difference| of the fg params
    (this rank's block) and the bg params from the unsharded frame's) from
    one start state and seed."""
    from openobj_torch.core import trainer
    from openobj_torch.parallel import sharding

    ref, single = _unsharded(**cfg_kw)
    cfg, dirs, state, store, fg, bg = _port_inputs(**cfg_kw)
    s_state, s_fg, s_store = sharding.shard_scene(mesh, state, fg, store)
    with sharding.use_mesh(mesh):
        new, sharded = trainer.train_frame(s_state, s_store, dirs, s_fg, bg,
                                           torch.Generator().manual_seed(7), cfg)
    lead = sorted({x.shape[0] for x in _flat_tensors(new.fg_params)})
    contiguous = all(x.is_contiguous() and type(x) is torch.Tensor
                     for x in _flat_tensors(new.fg_params))
    n = s_fg["active"].shape[0]
    start = sharding.axis_rank("object", mesh) * n
    fg_d = max(float((a - b.narrow(0, start, n)).abs().max()) for a, b in
               zip(_flat_tensors(new.fg_params), _flat_tensors(ref.fg_params)))
    bg_d = max(float((a - b).abs().max()) for a, b in
               zip(_flat_tensors(new.bg_params), _flat_tensors(ref.bg_params)))
    return single.tolist(), sharded.tolist(), lead, contiguous, fg_d, bg_d


def _flat_tensors(tree):
    from openobj_torch.core import optim

    return [x for _, x in optim.flatten_with_path(tree)]


def _run_step_vs_jax(mesh, npz_path):
    """The sharded run_step on the JAX package's exported batches (every
    slot's and ray's: run_step keeps the rank's share), from its initial
    state, the step losses summed over the mesh. The parent writes them
    while the ranks run their other cases."""
    from openobj_torch import convert
    from openobj_torch.core import trainer
    from openobj_torch.parallel import sharding

    z = dict(np.load(_wait_for(npz_path)))
    st = {"fg_params": _nest(z, "state/fg_params/"), "bg_params": _nest(z, "state/bg_params/"),
          "fg_opt": {"mu": _nest(z, "state/fg_mu/"), "nu": _nest(z, "state/fg_nu/"),
                     "count": z["state/fg_count"]},
          "bg_opt": {"mu": _nest(z, "state/bg_mu/"), "nu": _nest(z, "state/bg_nu/"),
                     "count": z["state/bg_count"]}}
    cfg = trainer.TrainConfig(**CFG_KW)
    state = convert.train_state_from_numpy(st, "cpu")
    fg, _ = _tables_np()
    fg = {k: torch.from_numpy(v) for k, v in fg.items()}
    state, fg = sharding.shard_scene(mesh, state, fg)
    out = []
    with sharding.use_mesh(mesh):
        for i in range(cfg.n_iters_per_frame):
            fsl = {k: torch.from_numpy(v) for k, v in _nest(z, f"fg{i}/").items()}
            bsl = {k: torch.from_numpy(v) for k, v in _nest(z, f"bg{i}/").items()}
            state, loss = trainer.run_step(state, fsl, bsl, fg["active"], cfg)
            out.append(float(sharding.mesh_sum(loss)))
    return out


def _mapper(initial_bucket=4, max_objects=100, **cfg_kw):
    from openobj_torch.core import trainer
    from openobj_torch.core.scene import Camera, SceneMapper

    cfg = trainer.TrainConfig(**{**CFG_KW, **cfg_kw})
    cam = Camera(width=32, height=24, fx=20.0, fy=20.0, cx=16.0, cy=12.0)
    return SceneMapper(cam, cfg, frame_capacity=8, initial_bucket=initial_bucket,
                       max_objects=max_objects, device="cpu")


def _trained_mapper():
    """test_geometry_export.py's mapper: one sphere, 3 frames."""
    from openobj_torch.data import synthetic

    m = _mapper()
    dirs = m.cam_dirs.numpy()
    for rgb, depth, inst, t_wc in synthetic.make_sequence(
            synthetic.default_scene(n_spheres=1), dirs, 3):
        m.process_frame(rgb, depth, inst, t_wc)
    m.finish()
    return m


def _leaves(state):
    from openobj_torch.core import checkpoint

    return {k: x for k, x in _flat_tensors_named(checkpoint._device_state_tree(state))}


def _flat_tensors_named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_tensors_named(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _snapshot_cases(mesh, snap_dir):
    """Sharded save on every rank, sharded load into a fresh mapper, and the
    two refusals; rank 0 also writes the unsharded state (save_scene) that
    the parent holds the unsharded load to."""
    import torch.distributed as dist

    from openobj_torch.core import checkpoint
    from openobj_torch.parallel import sharding

    out = {}
    m1 = _trained_mapper()
    if dist.get_rank() == 0:
        checkpoint.save_scene(os.path.join(snap_dir, "full"), m1)
    m1.state, _ = sharding.shard_scene(mesh, m1.state, {})
    m2 = _mapper()
    m2.state, _ = sharding.shard_scene(mesh, m2.state, {})
    with sharding.use_mesh(mesh):
        checkpoint.save_scene_sharded(os.path.join(snap_dir, "snap"), m1)
        checkpoint.load_scene_sharded(os.path.join(snap_dir, "snap"), m2)
    a, b = _leaves(m1.state), _leaves(m2.state)
    out["leaf_names_equal"] = sorted(a) == sorted(b)
    out["leaves_bit_identical"] = all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
    out["blocks"] = sorted({tuple(b[k].shape)[0] for k in b if k.startswith("fg_")})
    out["registry_equal"] = (
        m2.registry.inst_to_slot == m1.registry.inst_to_slot
        and m2.n_objects == m1.n_objects
        and all(np.array_equal(getattr(m1.registry, t), getattr(m2.registry, t))
                for t in ("kf_frames", "kf_bbox", "n_kf", "latest2", "active", "obj_inst")))
    refused = {}
    for name, kw in (("larger_bucket", dict(initial_bucket=8)),
                     ("bg_mismatch", dict(do_bg=False))):
        m = _mapper(**kw)
        m.state, _ = sharding.shard_scene(mesh, m.state, {})
        try:
            with sharding.use_mesh(mesh):
                checkpoint.load_scene_sharded(os.path.join(snap_dir, "snap"), m)
            refused[name] = None
        except ValueError as e:
            refused[name] = str(e)
    out["refused"] = refused
    return out


def _lifecycle_frames():
    """Frame A sees objects 1-5, B and C objects 1-13 (past the bucket of
    8), with the background (0) and unknown pixels (-1) in each."""
    out = []
    for seed, n_ids in ((1, 6), (2, 14), (3, 14)):
        rng = np.random.default_rng(seed)
        t_wc = np.eye(4, dtype=np.float32)
        t_wc[0, 3] = 0.02 * seed
        out.append((rng.integers(0, 255, (24, 32, 3)).astype(np.uint8),
                    rng.uniform(0.5, 3.0, (24, 32)).astype(np.float32),
                    rng.integers(-1, n_ids, (24, 32)).astype(np.int32), t_wc))
    return out


def _lifecycle(mesh, snap_dir):
    """test_sharding.py's lifecycle through the mapper: frame A at bucket
    8, frame B past it (growth 8 -> 16), save_scene, load_scene into a fresh
    mapper (whose state then carries on), frame C. With ``mesh`` the
    mapper's state is cut by shard_scene and every call runs inside
    use_mesh. Returns (losses, the mapper, whether the loaded state is the
    saved one bit for bit, every slot's slot_params)."""
    import contextlib

    from openobj_torch.core import checkpoint
    from openobj_torch.parallel import sharding

    def cut(m):
        if mesh is not None:
            m.state, _ = sharding.shard_scene(mesh, m.state, {})
        return m

    m = cut(_mapper(initial_bucket=8))
    frames = _lifecycle_frames()
    losses = []
    with sharding.use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        for f in frames[:2]:
            losses.append(m.process_frame(*f))
        m.finish()
        checkpoint.save_scene(snap_dir, m)
        fresh = cut(_mapper(initial_bucket=8))
        checkpoint.load_scene(snap_dir, fresh)
        a, b = _leaves(m.state), _leaves(fresh.state)
        same = sorted(a) == sorted(b) and all(
            a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
        m.state = fresh.state
        losses.append(m.process_frame(*frames[2]))
        m.finish()
        slots = [m.slot_params(s) for s in range(m.state.global_slots)]
    return [x.tolist() for x in losses], m, same, slots


_UNSHARDED_LIFE = {}


def _lifecycle_case(mesh, tag, out_dir):
    """The lifecycle on ``mesh`` against the unsharded mapper's, run once
    in this process: losses, slot counts, the rank's block and every
    slot_params against the unsharded mapper's, the snapshot round trip,
    and the paths of both npz files."""
    import torch.distributed as dist

    from openobj_torch.parallel import sharding

    ref_dir = os.path.join(out_dir, f"unsharded_r{dist.get_rank()}")
    if "ref" not in _UNSHARDED_LIFE:
        _UNSHARDED_LIFE["ref"] = _lifecycle(None, ref_dir)
    ref_losses, ref, _, ref_slots = _UNSHARDED_LIFE["ref"]
    losses, m, same, slots = _lifecycle(mesh, os.path.join(out_dir, tag))
    # train.render_stack (render_dataset's objects) on boxes set by hand
    from openobj_torch import train
    from openobj_torch.utils.geometry import OrientedBox

    for mapper in (m, ref):
        for st in mapper.registry.slots.values():
            st.bbox3d = OrientedBox(center=np.zeros(3), r=np.eye(3), extent=np.ones(3))
    with sharding.use_mesh(mesh):
        stack = train.render_stack(m)
    ref_stack = train.render_stack(ref)
    n = m.state.n_slots
    start = sharding.axis_rank("object", mesh) * n
    whole = _leaves(ref.state)
    mine = _leaves(m.state)
    return {
        "losses": losses, "ref_losses": ref_losses,
        "block": n, "global_slots": m.state.global_slots, "n_shards": m.state.n_shards,
        "block_d": max(float((x - whole[k].narrow(0, start, n)).abs().max())
                       for k, x in mine.items() if k.startswith("fg_")),
        "bg_d": max(float((x - whole[k]).abs().max())
                    for k, x in mine.items() if k.startswith("bg_")),
        "slot_d": max(float((x - y).abs().max()) for sa, sb in zip(slots, ref_slots)
                      for x, y in zip(_flat_tensors(sa), _flat_tensors(sb))),
        "n_slot_params": len(slots),
        "render_stack_ids": stack[0].tolist() == ref_stack[0].tolist(),
        "render_stack_d": max(float((x - y).abs().max()) for x, y in
                              zip(_flat_tensors(stack[1]), _flat_tensors(ref_stack[1]))),
        "reload_bit_identical": same,
        "npz": os.path.join(out_dir, tag, "scene_state.npz"),
        "ref_npz": os.path.join(ref_dir, "scene_state.npz"),
    }


class _Replay:
    """tests/test_torch_renderer.py's Replay (that module imports jax, which
    the ranks lack): stands in for ``renderer._uniform`` and hands out the
    given draws in order, checking each one's shape against the request."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, gen, shape, device):
        a = self.draws.pop(0)
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.from_numpy(a).to(device)


def _render_case(mesh, npz_path):
    """render_frame_batched of this rank's block inside use_mesh, on the
    JAX reference's params, boxes and rays, with its draws replayed."""
    from openobj_torch import convert
    from openobj_torch.core import renderer
    from openobj_torch.models.object_field import tree_map
    from openobj_torch.parallel import sharding

    z = dict(np.load(_wait_for(npz_path)))
    o = z["extents"].shape[0]
    n = o // sharding.axis_size("object", mesh)
    start = sharding.axis_rank("object", mesh) * n
    params = tree_map(lambda x: x[start:start + n].clone(),
                      convert.params_from_numpy(_nest(z, "params/"), "cpu"))
    geo = [torch.from_numpy(z[k]) for k in ("t_wo", "extents", "centers", "active",
                                             "origins", "dirs")]
    draws = [z[f"draw{c}"] for c in range(int(z["n_chunks"]))]
    replay, renderer._uniform = renderer._uniform, _Replay(draws)
    try:
        with sharding.use_mesh(mesh):
            out = renderer.render_frame_batched(params, *geo, torch.Generator(),
                                                **RENDER_KW)
        left = len(renderer._uniform.draws)
    finally:
        renderer._uniform = replay
    return {k: v.tolist() for k, v in out.items()} | {"draws_left": left}


def _refusals(mesh) -> dict:
    """What a split object axis refuses, each before anything trains: a
    bucket that does not divide the axis, max_objects not a multiple of
    it, a block used outside its mesh, and a whole state inside it."""
    from openobj_torch.core import checkpoint, trainer
    from openobj_torch.parallel import sharding

    n = sharding.axis_size("object", mesh)
    out = {}

    def refused(name, fn, m=None):
        gen_state = m.gen.get_state() if m is not None else None
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
        if m is not None:    # nothing ingested, drawn or trained
            out[name + "_untouched"] = (m.frame_count == 0 and m.store.n_frames == 0
                                        and torch.equal(m.gen.get_state(), gen_state))

    m = _mapper(initial_bucket=8)
    m.state, _ = sharding.shard_scene(mesh, m.state, {})

    def grow():
        with sharding.use_mesh(mesh):
            m.state = trainer.grow_train_state(m.gen, m.state, m.cfg, 8 + n + 1)

    refused("bucket", grow, m)
    odd = _mapper(initial_bucket=8, max_objects=8 + n + 1)
    odd.state, _ = sharding.shard_scene(mesh, odd.state, {})

    def odd_frame():
        with sharding.use_mesh(mesh):
            odd.process_frame(*_lifecycle_frames()[0])

    refused("max_objects", odd_frame, odd)
    refused("outside_mesh", lambda: m.process_frame(*_lifecycle_frames()[0]), m)
    refused("train_frame_outside_mesh", lambda: trainer.train_frame(
        m.state, m.store, m.cam_dirs, m._fg_tables_device(), None, m.gen, m.cfg))
    refused("save_outside_mesh", lambda: checkpoint.save_scene(os.devnull, m))
    whole = _mapper(initial_bucket=8)

    def whole_frame():
        with sharding.use_mesh(mesh):
            whole.process_frame(*_lifecycle_frames()[0])

    refused("whole_inside_mesh", whole_frame, whole)
    return out


def _wait_for(path):
    import time

    deadline = time.monotonic() + 240
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.2)
    return path


def _child(rank, world, port, out_dir, npz_path, render_npz):
    import torch.distributed as dist

    from openobj_torch.core import trainer
    from openobj_torch.parallel import distributed, sharding

    res = {"rank": rank}
    try:
        sharding.make_mesh(device_type="cpu")
    except RuntimeError as e:
        res["no_group"] = str(e)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = sharding.make_mesh()
    mesh2 = sharding.make_mesh_2d(n_data=2)
    res["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    res["mesh_2d"] = dict(zip(mesh2.mesh_dim_names, mesh2.shape))
    try:
        sharding.make_mesh_2d(n_data=3)
    except ValueError as e:
        res["bad_data_axis"] = str(e)
    st = trainer.init_train_state(torch.Generator().manual_seed(0), trainer.TrainConfig(
        hidden=8, hidden_bg=8, clip_size=4), n_slots=6 if world == 4 else 5, device="cpu")
    try:
        sharding.shard_scene(mesh, st, {})
    except ValueError as e:
        res["indivisible"] = str(e)
    res["object"] = _frame_losses(mesh)
    if world == 2:
        res["object_z_per_step"] = _frame_losses(mesh, z_per_step=True)
        res["object_sample_per_step"] = _frame_losses(mesh, sample_per_step=True)
        res["snapshot"] = _snapshot_cases(mesh, out_dir)
        res["life_object2"] = _lifecycle_case(mesh, "life_object2", out_dir)
        res["run_step_vs_jax"] = _run_step_vs_jax(mesh, npz_path)
    else:
        res["data_object"] = _frame_losses(mesh2)
        res["data_object_z_per_step"] = _frame_losses(mesh2, z_per_step=True)
        res["snapshot"] = _snapshot_cases(mesh2, out_dir)
        res["life_object4"] = _lifecycle_case(mesh, "life_object4", out_dir)
        res["life_data2_object2"] = _lifecycle_case(mesh2, "life_data2_object2", out_dir)
        res["run_step_vs_jax_2d"] = _run_step_vs_jax(mesh2, npz_path)
    res["refusals"] = _refusals(mesh)
    res["render"] = _render_case(mesh, render_npz)
    distributed.barrier("sharding")
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


# --------------------------------------------------------------------------- #
# the parent: two groups at once, then the tests over their results
# --------------------------------------------------------------------------- #


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_LAUNCH = (
    "import sys; sys.modules['jax'] = None; sys.path.insert(0, {here!r}); "
    "import test_torch_sharding as t; "
    "t._child({rank}, {world}, {port}, {out!r}, {npz!r}, {render!r})")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharding")
    npz = str(root / "jax_reference.npz")
    render_npz = str(root / "jax_render.npz")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs, outs = [], {}
    for world in (2, 4):
        out = root / f"world{world}"
        out.mkdir()
        outs[world] = out
        port = _free_port()
        for rank in range(world):
            code = _LAUNCH.format(here=HERE, rank=rank, world=world, port=port,
                                  out=str(out), npz=npz, render=render_npz)
            procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
    try:
        _jax_reference(npz)       # while the ranks run
        _jax_render_reference(render_npz)
        for p in procs:
            o, e = p.communicate(timeout=300)
            assert p.returncode == 0, f"rc={p.returncode}\n{o}\n{e}"
    finally:
        for p in procs:
            p.kill()
    res = {}
    for world, out in outs.items():
        res[world] = []
        for rank in range(world):
            with open(out / f"rank{rank}.json") as f:
                res[world].append(json.load(f))
    res["jax_losses"] = np.load(npz)["losses"]
    res["jax_render"] = dict(np.load(render_npz))
    res["snap_dir"] = str(outs[2])
    return res


def _assert_sharded_equal(case, n_slots_local):
    single, sharded, lead, contiguous, _, _ = case
    assert np.isfinite(single).all() and len(single) == CFG_KW["n_iters_per_frame"]
    np.testing.assert_allclose(sharded, single, rtol=RTOL)
    assert lead == [n_slots_local], lead       # the params stay blocks
    assert contiguous


class TestMesh:
    def test_mesh_shapes(self, runs):
        for world in (2, 4):
            for r in runs[world]:
                assert r["mesh"] == {"object": world}
                assert r["mesh_2d"] == {"data": 2, "object": world // 2}
                assert "not divisible by data axis 3" in r["bad_data_axis"]

    def test_make_mesh_needs_a_process_group(self, runs):
        for r in runs[2] + runs[4]:
            assert "process group" in r["no_group"]

    @pytest.mark.parametrize("world", [2, 4])
    def test_indivisible_slots_rejected(self, runs, world):
        for r in runs[world]:
            assert "grow the bucket first" in r["indivisible"]


class TestShardedParity:
    @pytest.mark.parametrize("world", [2, 4])
    def test_object_sharded_equals_unsharded(self, runs, world):
        for r in runs[world]:
            _assert_sharded_equal(r["object"], 8 // world)
        # every rank reports the same losses: the whole run's
        assert len({tuple(r["object"][1]) for r in runs[world]}) == 1

    @pytest.mark.parametrize("option", ["z_per_step", "sample_per_step"])
    def test_draw_order_options_sharded(self, runs, option):
        for r in runs[2]:
            _assert_sharded_equal(r[f"object_{option}"], 4)

    @pytest.mark.parametrize("case", ["data_object", "data_object_z_per_step"])
    def test_2d_mesh_ray_dp_matches(self, runs, case):
        for r in runs[4]:
            _assert_sharded_equal(r[case], 4)

    def test_sharded_run_step_matches_jax(self, runs):
        for r in runs[2]:
            np.testing.assert_allclose(r["run_step_vs_jax"], runs["jax_losses"], rtol=RTOL)

    def test_2d_mesh_run_step_matches_jax(self, runs):
        """Rays split over "data": the counts and gradients summed over it."""
        for r in runs[4]:
            np.testing.assert_allclose(r["run_step_vs_jax_2d"], runs["jax_losses"],
                                       rtol=RTOL)

    @pytest.mark.parametrize("world,case", [
        (2, "object"), (2, "object_z_per_step"), (2, "object_sample_per_step"),
        (4, "object"), (4, "data_object"), (4, "data_object_z_per_step")])
    def test_sharded_params_match_unsharded(self, runs, world, case):
        """Each rank's fg block and its bg copy after the sharded frame
        equal the unsharded frame's, so every gradient was whole."""
        for r in runs[world]:
            fg_d, bg_d = r[case][4:]
            assert fg_d <= PARAM_ATOL and bg_d <= PARAM_ATOL, (fg_d, bg_d)


class TestShardedSnapshot:
    """On 2 ranks ("object" 2) and on 4 ("data" 2 x "object" 2, each
    block written once and read by both of its data ranks)."""

    @pytest.mark.parametrize("world", [2, 4])
    def test_roundtrip(self, runs, world):
        for r in runs[world]:
            s = r["snapshot"]
            assert s["leaf_names_equal"] and s["leaves_bit_identical"]
            assert s["blocks"] == [2]           # 4 slots over an object axis of 2
            assert s["registry_equal"]

    @pytest.mark.parametrize("world", [2, 4])
    def test_larger_bucket_rejected(self, runs, world):
        for r in runs[world]:
            assert "initial_bucket" in r["snapshot"]["refused"]["larger_bucket"]

    @pytest.mark.parametrize("world", [2, 4])
    def test_bg_mismatch_rejected(self, runs, world):
        for r in runs[world]:
            assert "background" in r["snapshot"]["refused"]["bg_mismatch"]

    def test_sharded_snapshot_into_unsharded_mapper(self, runs):
        """The two ranks' snapshot loads into a plain mapper in this process
        (no process group) equal to the state before it was split."""
        from openobj_torch.core import checkpoint

        m = _mapper()
        checkpoint.load_scene_sharded(os.path.join(runs["snap_dir"], "snap"), m)
        ref = _mapper()
        checkpoint.load_scene(os.path.join(runs["snap_dir"], "full"), ref)
        a, b = _leaves(ref.state), _leaves(m.state)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        assert m.registry.inst_to_slot == ref.registry.inst_to_slot
        assert m.state.n_slots == 4


# (world, case, "object" axis size, the params' tolerance)
_LIFECYCLES = [(2, "life_object2", 2, PARAM_ATOL), (4, "life_object4", 4, PARAM_ATOL),
               (4, "life_data2_object2", 2, DATA_PARAM_ATOL)]


class TestShardedMapper:
    """SceneMapper.process_frame on a split object axis through a bucket
    growth, save_scene / load_scene and one more frame, held to the
    unsharded mapper's run of the same frames (test_sharding.py's
    lifecycle, through the mapper): bit for bit on "object" 2 and 4, the
    params within DATA_PARAM_ATOL with the rays split over "data"."""

    @pytest.mark.parametrize("world,case,n,atol", _LIFECYCLES)
    def test_losses_match_unsharded(self, runs, world, case, n, atol):
        for r in runs[world]:
            life = r[case]
            assert len(life["losses"]) == 3
            for got, ref in zip(life["losses"], life["ref_losses"]):
                assert np.isfinite(ref).all() and len(ref) == CFG_KW["n_iters_per_frame"]
                np.testing.assert_allclose(got, ref, rtol=RTOL)

    @pytest.mark.parametrize("world,case,n,atol", _LIFECYCLES)
    def test_bucket_grows_in_blocks(self, runs, world, case, n, atol):
        for r in runs[world]:
            life = r[case]
            assert (life["global_slots"], life["n_shards"], life["block"]) == (16, n, 16 // n)

    @pytest.mark.parametrize("world,case,n,atol", _LIFECYCLES)
    def test_blocks_match_unsharded(self, runs, world, case, n, atol):
        """Each rank's fg block (params, moments, counts) and its bg copy
        after the three frames equal the unsharded mapper's."""
        for r in runs[world]:
            assert r[case]["block_d"] <= atol and r[case]["bg_d"] <= atol, r[case]

    @pytest.mark.parametrize("world,case,n,atol", _LIFECYCLES)
    def test_slot_params_on_every_rank(self, runs, world, case, n, atol):
        """slot_params of every slot, on every rank, whichever rank holds it."""
        for r in runs[world]:
            assert r[case]["n_slot_params"] == 16
            assert r[case]["slot_d"] <= atol

    @pytest.mark.parametrize("world,case,n,atol", _LIFECYCLES)
    def test_render_stack_gathers_the_objects(self, runs, world, case, n, atol):
        """render_dataset's stack of objects, by slot, on every rank."""
        for r in runs[world]:
            assert r[case]["render_stack_ids"] and r[case]["render_stack_d"] <= atol

    @pytest.mark.parametrize("world,case,n,atol", _LIFECYCLES)
    def test_save_scene_writes_the_unsharded_npz(self, runs, world, case, n, atol):
        sharded = np.load(runs[world][0][case]["npz"])
        for r in runs[world]:
            ref = np.load(r[case]["ref_npz"])
            assert sorted(sharded.files) == sorted(ref.files)
            for k in ref.files:
                assert sharded[k].dtype == ref[k].dtype, k
                if atol == PARAM_ATOL or sharded[k].dtype.kind != "f":
                    np.testing.assert_array_equal(sharded[k], ref[k], err_msg=k)
                else:
                    np.testing.assert_allclose(sharded[k], ref[k], atol=atol, rtol=0, err_msg=k)
        assert sharded["fg_count"].shape == (16,)

    @pytest.mark.parametrize("world,case,n,atol", _LIFECYCLES)
    def test_load_scene_gives_each_rank_its_block(self, runs, world, case, n, atol):
        for r in runs[world]:
            assert r[case]["reload_bit_identical"]


class TestShardedRender:
    @pytest.mark.parametrize("world", [2, 4])
    def test_render_frame_batched_matches_jax(self, runs, world):
        """Every rank renders its block of 8 objects with the JAX draws
        replayed (each chunk's [8, chunk, bins] draw, its rows kept) and
        returns the JAX package's unsharded render."""
        ref = runs["jax_render"]
        hit = ref["ref_winner"] >= 0
        assert hit.any() and not hit.all()
        block = 8 // world
        # objects of more than one block win: the merge decides rays
        assert len({int(w) // block for w in ref["ref_winner"][hit]}) > 1
        for r in runs[world]:
            got = r["render"]
            assert got["draws_left"] == 0
            for k in ("winner", "n_hit"):
                np.testing.assert_array_equal(got[k], ref[f"ref_{k}"], err_msg=k)
            depth = np.asarray(got["depth"], np.float32)
            np.testing.assert_array_equal(np.isinf(depth), ~hit)
            np.testing.assert_allclose(depth[hit], ref["ref_depth"][hit], atol=1e-5, rtol=0)
            np.testing.assert_allclose(got["color"], ref["ref_color"], atol=5e-5, rtol=0)


class TestShardedRefusals:
    """Each refusal raises with a message before anything is ingested,
    drawn or trained."""

    @pytest.mark.parametrize("world", [2, 4])
    def test_bucket_not_dividing_the_axis(self, runs, world):
        for r in runs[world]:
            f = r["refusals"]
            assert f"bucket {8 + world + 1} is not a multiple" in f["bucket"]
            assert f["bucket_untouched"]

    @pytest.mark.parametrize("world", [2, 4])
    def test_max_objects_not_a_multiple_of_the_axis(self, runs, world):
        for r in runs[world]:
            f = r["refusals"]
            assert f"max_objects ({8 + world + 1})" in f["max_objects"]
            assert f["max_objects_untouched"]

    @pytest.mark.parametrize("world", [2, 4])
    def test_block_outside_its_mesh(self, runs, world):
        for r in runs[world]:
            f = r["refusals"]
            for name in ("outside_mesh", "train_frame_outside_mesh", "save_outside_mesh"):
                assert f"cut into {world} object block(s)" in f[name], name
            assert f["outside_mesh_untouched"]

    @pytest.mark.parametrize("world", [2, 4])
    def test_whole_state_inside_a_split_axis(self, runs, world):
        for r in runs[world]:
            f = r["refusals"]
            assert f"cut into 1 object block(s) but the ambient 'object' mesh axis is {world}" \
                in f["whole_inside_mesh"]
            assert f["whole_inside_mesh_untouched"]
