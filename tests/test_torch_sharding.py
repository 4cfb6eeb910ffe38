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

CFG_KW = dict(n_iters_per_frame=2, win_size=2, n_samples_per_frame=8,
              win_size_bg=2, n_samples_per_frame_bg=8,
              hidden=16, hidden_bg=16, clip_size=4)


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
    import time

    from openobj_torch import convert
    from openobj_torch.core import trainer
    from openobj_torch.parallel import sharding

    deadline = time.monotonic() + 240
    while not os.path.exists(npz_path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{npz_path} never appeared")
        time.sleep(0.2)
    z = dict(np.load(npz_path))
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


def _mapper(initial_bucket=4, **cfg_kw):
    from openobj_torch.core import trainer
    from openobj_torch.core.scene import Camera, SceneMapper

    cfg = trainer.TrainConfig(**{**CFG_KW, **cfg_kw})
    cam = Camera(width=32, height=24, fx=20.0, fy=20.0, cx=16.0, cy=12.0)
    return SceneMapper(cam, cfg, frame_capacity=8, initial_bucket=initial_bucket,
                       device="cpu")


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


def _mapper_refusal(mesh) -> str | None:
    """A mapper asked to process a frame with its object axis split."""
    from openobj_torch.parallel import sharding

    m = _mapper()
    try:
        with sharding.use_mesh(mesh):
            m.process_frame(*_frame())
    except NotImplementedError as e:
        return str(e)
    return None


def _child(rank, world, port, out_dir, npz_path):
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
        res["mapper_refusal"] = _mapper_refusal(mesh)
        res["snapshot"] = _snapshot_cases(mesh, out_dir)
        res["run_step_vs_jax"] = _run_step_vs_jax(mesh, npz_path)
    else:
        res["data_object"] = _frame_losses(mesh2)
        res["data_object_z_per_step"] = _frame_losses(mesh2, z_per_step=True)
        res["snapshot"] = _snapshot_cases(mesh2, out_dir)
        res["run_step_vs_jax_2d"] = _run_step_vs_jax(mesh2, npz_path)
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
    "import test_torch_sharding as t; t._child({rank}, {world}, {port}, {out!r}, {npz!r})")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharding")
    npz = str(root / "jax_reference.npz")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs, outs = [], {}
    for world in (2, 4):
        out = root / f"world{world}"
        out.mkdir()
        outs[world] = out
        port = _free_port()
        for rank in range(world):
            code = _LAUNCH.format(here=HERE, rank=rank, world=world, port=port,
                                  out=str(out), npz=npz)
            procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
    try:
        _jax_reference(npz)       # while the ranks run
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

    def test_mapper_refuses_a_split_object_axis(self, runs):
        for r in runs[2]:
            assert "A16c" in r["mapper_refusal"]


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
