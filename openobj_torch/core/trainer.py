"""The incremental-mapping training frame.

Port of ``openobj_tpu.core.trainer``. One frame draws every object's rays
from the frame store in one flat gather (``_sample_batch``), then runs
``n_iters_per_frame`` AdamW steps (``run_step``), each a field
forward+backward over [O objects, rays, samples] plus the background model,
the composited multi-term loss, and the slot-masked AdamW update. Two
options change the order of the draws, not their law: ``z_per_step``
keeps the frame's rays and per-object depth bound but has each step draw
its own z lattice (``resolve_z``); ``sample_per_step`` has each step draw
its own rays (``n_iters=1``), so the two latest keyframes, forced to the
end of a draw list, land in every step's window, as in the JAX package.
Every draw comes from the one ``torch.Generator`` of the frame.

Inside ``parallel.sharding.use_mesh(mesh)`` the state and the fg tables
are this rank's block of object slots (``sharding.shard_scene``), as the
JAX trainer's arrays are under ``jax.set_mesh``: ``train_frame`` gathers
the small tables, draws for every slot exactly what the unsharded run
draws, and each step keeps the rank's block of slots and, on a "data"
axis, its share of the rays (``sharding.maybe_constrain``); the masked
means' counts and the gradients are summed over "data", and the per-step
losses over the mesh once a frame. ``grow_train_state`` grows a block the
same way: every rank draws the whole new stack and keeps its block. The
state records how many blocks it was cut into, and a block used outside
its mesh is refused. Outside a mesh none of this does anything.

Workload shape at the Replica room_0 envelope: per object and step 120 rays
(win 5 x 24 pixels) x 10 samples; background 1200 rays x 14 samples with its
own 128-wide field; one AdamW over everything, lr 1e-3, wd 0.013.

The field forward/backward goes through ``ops.fused_field.field_evaluator``,
whatever ``field_impl`` says. Where the kernels cover the field's shape
(``fused_field.kernels_cover``: ``max_deg`` 5, f32 or bf16, at any hidden
width) that is the hand-written kernel pair of the compute dtype on a CUDA
device and the kernels' plain version on the CPU; any other shape runs the
eager ``object_field`` field on either device, as the reference's default
``field_impl="xla"`` does. The pick is made on the shape before anything is
launched. ``compute_dtype="bf16"`` thus follows the JAX kernel's bf16
numerics where the kernels cover the shape (the JAX trainer's pallas path
itself evaluates the kernel in f32 whatever ``compute_dtype`` says) and
the XLA field's elsewhere; the part loss takes the dtype too, and params,
gradients and optimizer state stay f32. ``optim_impl="flat"`` runs each
step's update as ``optim.adamw_update_flat``, as the JAX trainer does: on
a CUDA device one launch of the flat AdamW kernel a model, on the CPU its
plain version; any other value keeps the per-leaf ``adamw_update``. Knobs
that only shape the JAX program's layout (``scan_unroll``, ``remat``,
``gemm_impl``, and the JAX package's ray-minor batch storage) are
accepted so that configs load, and ignored.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from openobj_torch.core import frame_store as FS
from openobj_torch.core import optim
from openobj_torch.core.frame_store import FrameStore
from openobj_torch.models import object_field
from openobj_torch.ops import fused_field, losses, sampling
from openobj_torch.parallel import sharding


@dataclass(frozen=True)
class TrainConfig:
    """Training configuration; defaults = Replica room_0. Field names and
    defaults match ``openobj_tpu.core.trainer.TrainConfig``."""
    n_iters_per_frame: int = 100
    win_size: int = 5
    n_samples_per_frame: int = 24          # rays per keyframe draw (fg)
    win_size_bg: int = 10
    n_samples_per_frame_bg: int = 120
    n_bins_cam2surface: int = 1
    n_bins_cam2surface_bg: int = 5
    n_bins: int = 9
    surface_eps: float = 0.1
    stop_eps: float = 0.05
    min_depth: float = 0.0
    learning_rate: float = 1e-3
    weight_decay: float = 0.013
    color_scaling: float = 5.0
    opacity_scaling: float = 10.0
    partfeat_scaling: float = 5.0
    part_mode: bool = False
    part_down: int = 5
    part_dtype: str = "int8"               # part-feature store: "int8" | "bf16"
    hidden: int = 32
    hidden_bg: int = 128
    clip_size: int = 512
    max_deg: int = 5
    obj_scale: float = 2.0
    bg_scale: float = 5.0
    do_bg: bool = True
    # accepted for config compatibility; the field runs through the fused
    # kernels wherever they cover its shape (module docstring)
    field_impl: str = "xla"
    compute_dtype: str = "f32"             # "f32" | "bf16" (products on bf16 operands)
    # the optimizer step: "tree" (per leaf) or "flat" (one update a model)
    optim_impl: str = "tree"
    # JAX program layout knobs: accepted, ignored
    gemm_impl: str = "segmented"
    scan_unroll: int = 4
    remat: bool = False
    # the order of the draws (module docstring): each step draws its own z
    # lattice, or its own rays
    z_per_step: bool = False
    sample_per_step: bool = False

    @property
    def n_rays_per_step(self) -> int:
        return self.win_size * self.n_samples_per_frame        # 120

    @property
    def n_rays_per_step_bg(self) -> int:
        return self.win_size_bg * self.n_samples_per_frame_bg  # 1200


@dataclass
class TrainState:
    fg_params: dict          # stacked leaves [O, ...]
    fg_opt: optim.AdamWState
    bg_params: dict | None
    bg_opt: optim.AdamWState | None
    # the blocks of the object axis the fg leaves were cut into
    # (``sharding.shard_scene``): this state is one of them
    n_shards: int = 1

    @property
    def n_slots(self) -> int:
        """The slots this state holds (its block's, when cut)."""
        return self.fg_params["mlp"]["in_layer"]["w"].shape[0]

    @property
    def global_slots(self) -> int:
        """The whole run's slots."""
        return self.n_slots * self.n_shards


def check_mesh(state: TrainState) -> None:
    """Raise unless ``state`` was cut for the ambient "object" axis: a block
    used outside its mesh (or under another one), or a whole state inside
    a split object axis, would train or write the wrong slots."""
    n = sharding.axis_size("object")
    if state.n_shards != n:
        raise ValueError(
            f"the state was cut into {state.n_shards} object block(s) but the ambient "
            f"'object' mesh axis is {n}: run a state inside sharding.use_mesh of the "
            "mesh it was cut for (sharding.shard_scene)")


def init_train_state(gen: torch.Generator, cfg: TrainConfig, n_slots: int,
                     device="cuda") -> TrainState:
    # the clip head exists whatever part_mode says, so that every init site
    # builds the same tree
    fg = object_field.init_stacked_fields(
        gen, n_slots, hidden=cfg.hidden, clip_size=cfg.clip_size,
        scale=cfg.obj_scale, max_deg=cfg.max_deg, do_clip=True, device=device)
    bg = bg_opt = None
    if cfg.do_bg:
        bg = object_field.init_field_params(
            gen, hidden=cfg.hidden_bg, clip_size=cfg.clip_size,
            scale=cfg.bg_scale, max_deg=cfg.max_deg, device=device)
        bg_opt = optim.init_adamw_state(bg, n_slots=None)
    return TrainState(fg_params=fg, fg_opt=optim.init_adamw_state(fg, n_slots=n_slots),
                      bg_params=bg, bg_opt=bg_opt)


def grow_train_state(gen: torch.Generator, state: TrainState, cfg: TrainConfig,
                     new_n_slots: int) -> TrainState:
    """Pad the stacked fg axis with freshly initialized slots, to
    ``new_n_slots`` for the whole run. Inside ``sharding.use_mesh`` with
    the object axis split, ``state`` is this rank's block: every rank
    draws the whole new stack, as the unsharded run does, so that the
    generators stay in step, and keeps its block of the grown axis
    (``sharding.grow_objects``). ``new_n_slots`` must then be a multiple
    of the axis."""
    check_mesh(state)
    n = state.n_shards
    if new_n_slots % n:
        raise ValueError(f"bucket {new_n_slots} is not a multiple of the 'object' mesh "
                         f"axis ({n}): every rank holds an equal block")
    extra_n = new_n_slots - state.global_slots
    dev = state.fg_opt.count.device
    extra = object_field.init_stacked_fields(
        gen, extra_n, hidden=cfg.hidden, clip_size=cfg.clip_size,
        scale=cfg.obj_scale, max_deg=cfg.max_deg, device=dev)

    def pad0(tree):
        zeros = object_field.tree_map(lambda a: a.new_zeros((extra_n, *a.shape[1:])), tree)
        return sharding.grow_objects(tree, zeros)

    opt = optim.AdamWState(mu=pad0(state.fg_opt.mu), nu=pad0(state.fg_opt.nu),
                           count=pad0(state.fg_opt.count))
    return TrainState(fg_params=sharding.grow_objects(state.fg_params, extra), fg_opt=opt,
                      bg_params=state.bg_params, bg_opt=state.bg_opt, n_shards=n)


# --------------------------------------------------------------------------- #
# sampling
# --------------------------------------------------------------------------- #


def _sample_batch(
    gen: torch.Generator,
    store: FrameStore,
    cam_dirs: torch.Tensor,     # [H, W, 3]
    kf_frames: torch.Tensor,    # [O, K] frame indices
    kf_bbox: torch.Tensor,      # [O, K, 4] (r0, r1, c0, c1) half-open
    n_kf: torch.Tensor,         # [O]
    latest2: torch.Tensor,      # [O, 2] keyframe-slot indices
    obj_inst: torch.Tensor,     # [O] instance id ("this" pixels)
    obj_center: torch.Tensor,   # [O, 3]
    n_draws: int,
    n_px: int,
    n_bins_c2s: int,
    cfg: TrainConfig,
    scan_iters: int | None = None,
):
    """Draw (n_draws * n_px) training rays for every object slot at once and
    build the fixed-shape z lattice. All pixel fetches are one flat gather
    over the object x draw x pixel axes. With ``scan_iters=I`` every leaf
    comes out step-ordered [I, O, rays/step, ...]: step i gets exactly the
    draws i*win .. (i+1)*win-1 of each object. With ``scan_iters`` and
    ``cfg.z_per_step`` no z is drawn here: the batch carries each object's
    depth bound over the frame's draws instead (``max_bound`` [I, O, 1]),
    and each step draws its lattice (``resolve_z``)."""
    dev = kf_frames.device
    o = kf_frames.shape[0]
    h, w = store.frame_shape

    n_kf_safe = torch.clamp(n_kf.long(), min=1)[:, None]
    u_kf = torch.rand((o, n_draws), generator=gen, device=dev)
    draws = torch.minimum(torch.floor(u_kf * n_kf_safe).long(), n_kf_safe - 1)
    # the two most recent keyframes go at the END of the draw list, as in
    # the reference, so they land only in the last step's window
    forced = torch.cat([draws[:, :-2], latest2.long()], dim=1)
    draws = torch.where((n_kf > 2)[:, None], forced, draws)

    oix = torch.arange(o, device=dev)[:, None]
    frames = kf_frames.long()[oix, draws]           # [O, D]
    bbox = kf_bbox[oix, draws]                      # [O, D, 4]
    ru = torch.rand((o, n_draws, n_px), generator=gen, device=dev)
    rv = torch.rand((o, n_draws, n_px), generator=gen, device=dev)
    u = torch.floor(ru * (bbox[..., 1:2] - bbox[..., 0:1]) + bbox[..., 0:1]).long()
    v = torch.floor(rv * (bbox[..., 3:4] - bbox[..., 2:3]) + bbox[..., 2:3]).long()

    if scan_iters:
        win = n_draws // scan_iters

        def to_steps(x):
            return x.reshape(o, scan_iters, win, *x.shape[2:]).transpose(0, 1)

        frames, u, v = to_steps(frames), to_steps(u), to_steps(v)
        lead = (scan_iters, o)
    else:
        lead = (o,)

    f = frames[..., None]                           # [..., win|D, 1]
    lin = ((f * h + u) * w + v).reshape(-1)
    px_shape = u.shape
    px = store.packed.reshape(3, -1)[:, lin]        # one gather, three planes
    rgb = FS.unpack_rgb(px).to(torch.float32) / 255.0
    depth = FS.unpack_depth(px).reshape(px_shape)
    inst = FS.unpack_inst(px).reshape(px_shape)
    obj_b = obj_inst[:, None, None]
    if scan_iters:
        obj_b = obj_b[None]
    state = torch.where(
        inst == obj_b, sampling.STATE_THIS,
        torch.where(inst == -1, sampling.STATE_UNKNOWN, sampling.STATE_OTHER))

    dirs_c = cam_dirs.reshape(-1, 3)[(u * w + v).reshape(-1)].reshape(*px_shape, 3)
    t_wc = store.t_wc[frames]                       # [..., 4, 4]
    origins, dirs_w = sampling.origin_dirs_w(t_wc[..., None, :, :], dirs_c)

    # per-object max over all of the frame's draws (reference vmap.py:493)
    max_axes = (0, 2, 3) if scan_iters else (1, 2)
    max_bound = torch.amax(depth, dim=max_axes, keepdim=True)
    defer_z = bool(scan_iters) and cfg.z_per_step
    if not defer_z:
        z = sampling.sample_z_values(
            gen, depth, state, cfg.min_depth, n_bins_c2s, cfg.n_bins,
            cfg.surface_eps, cfg.stop_eps, max_bound=max_bound)
    center_b = obj_center[:, None, None]
    if scan_iters:
        center_b = center_b[None]

    R = (win if scan_iters else n_draws) * n_px
    P = n_bins_c2s + cfg.n_bins
    batch = {
        "rgb": rgb.reshape(*lead, R, 3),
        "depth": depth.reshape(*lead, R),
        "state": state.reshape(*lead, R),
        "origins": (origins - center_b).reshape(*lead, R, 3),
        "dirs_w": dirs_w.reshape(*lead, R, 3),
    }
    if defer_z:
        batch["max_bound"] = max_bound.reshape(1, o, 1).expand(scan_iters, o, 1)
    else:
        batch["z"] = z.reshape(*lead, R, P)
    if cfg.part_mode and store.partfeat is not None:
        hp, wp = store.partfeat.shape[1], store.partfeat.shape[2]
        lin_pf = (f * hp + u // cfg.part_down) * wp + v // cfg.part_down
        # deferred: each step gathers its own slice (gather_partfeat)
        batch["partfeat_idx"] = lin_pf.reshape(*lead, R)
    return batch


def resolve_z(gen: torch.Generator, sl: dict, cfg: TrainConfig, is_bg: bool) -> dict:
    """A step's z lattice where its batch deferred it (``cfg.z_per_step``):
    the same three-mode law as the upfront batch, within the frame's
    per-object depth bound, drawn now."""
    mb = sl.pop("max_bound", None)
    if mb is None:
        return sl
    if gen is None:
        raise ValueError("a step whose z is deferred (z_per_step) needs the frame's generator")
    n_c2s = cfg.n_bins_cam2surface_bg if is_bg else cfg.n_bins_cam2surface
    sl["z"] = sampling.sample_z_values(
        gen, sl["depth"], sl["state"], cfg.min_depth, n_c2s, cfg.n_bins,
        cfg.surface_eps, cfg.stop_eps, max_bound=mb)
    return sl


def gather_partfeat(sl: dict, partfeat: torch.Tensor | None) -> dict:
    """Resolve a slice's deferred part-feature indices against the store."""
    idx = sl.pop("partfeat_idx", None)
    if idx is not None and partfeat is not None:
        c = partfeat.shape[-1]
        sl["partfeat"] = partfeat.reshape(-1, c)[idx.reshape(-1)].reshape(*idx.shape, c)
    return sl


def sample_fg_batch(gen, store, cam_dirs, tables, cfg: TrainConfig,
                    n_iters: int | None = None, scan_order: bool = False):
    """All object slots at once; tables leaves [O, ...]. ``scan_order``
    returns leaves shaped [iters, O, rays/step, ...]."""
    iters = n_iters if n_iters is not None else cfg.n_iters_per_frame
    return _sample_batch(
        gen, store, cam_dirs, tables["kf_frames"], tables["kf_bbox"],
        tables["n_kf"], tables["latest2"], tables["obj_inst"],
        tables["obj_center"], iters * cfg.win_size, cfg.n_samples_per_frame,
        cfg.n_bins_cam2surface, cfg, scan_iters=iters if scan_order else None)


def sample_bg_batch(gen, store, cam_dirs, bg_tables, cfg: TrainConfig,
                    n_iters: int | None = None, scan_order: bool = False):
    iters = n_iters if n_iters is not None else cfg.n_iters_per_frame
    dev = cam_dirs.device
    batch = _sample_batch(
        gen, store, cam_dirs,
        bg_tables["kf_frames"][None], bg_tables["kf_bbox"][None],
        bg_tables["n_kf"].reshape(1), bg_tables["latest2"][None],
        torch.zeros((1,), dtype=torch.int32, device=dev),
        torch.zeros((1, 3), dtype=torch.float32, device=dev),
        iters * cfg.win_size_bg, cfg.n_samples_per_frame_bg,
        cfg.n_bins_cam2surface_bg, cfg, scan_iters=iters if scan_order else None)
    ax = 1 if scan_order else 0
    return {k: x.squeeze(ax) for k, x in batch.items()}


# --------------------------------------------------------------------------- #
# one optimizer step and the frame
# --------------------------------------------------------------------------- #


def _loss_for_slice(params, batch, active, cfg: TrainConfig, is_bg: bool):
    """Field forward + step_batch_loss on one step's ray slice."""
    pts = sampling.rays_to_points(batch["origins"], batch["dirs_w"], batch["z"])
    gt_pf = batch.get("partfeat")
    field = fused_field.field_evaluator(
        params, stacked=not is_bg, max_deg=cfg.max_deg, do_clip=cfg.part_mode,
        compute_dtype=cfg.compute_dtype)
    a, c, f = field(pts)
    if is_bg:
        a, c = a[None], c[None]
        f = f[None] if f is not None else None
        gt_rgb, gt_d = batch["rgb"][None], batch["depth"][None]
        state, z = batch["state"][None], batch["z"][None]
        gt_pf = gt_pf[None] if gt_pf is not None else None
        act = None
    else:
        gt_rgb, gt_d = batch["rgb"], batch["depth"]
        state, z = batch["state"], batch["z"]
        act = active
    return losses.step_batch_loss(
        a[..., 0], c, gt_d, gt_rgb, state, z,
        active=act,
        color_scaling=cfg.color_scaling,
        opacity_scaling=cfg.opacity_scaling,
        gt_partfeat=gt_pf if cfg.part_mode else None,
        pred_partfeat_hidden=f if cfg.part_mode else None,
        partfeat_head=params["mlp"] if cfg.part_mode else None,
        partfeat_scaling=cfg.partfeat_scaling,
        compute_dtype=cfg.compute_dtype,
    )


def differentiable(params: dict):
    """Detached copy of the tree whose trainable leaves require grad, and
    the list of (path, leaf) to differentiate with respect to."""
    out = {}
    wrt = []
    for path, x in optim.flatten_with_path(params):
        y = x.detach()
        if optim.trainable(path):
            y.requires_grad_(True)
            wrt.append((path, y))
        optim.set_path(out, path, y)
    return out, wrt


def run_step(state: TrainState, fg_sl: dict, bg_sl: dict | None,
             active: torch.Tensor, cfg: TrainConfig,
             partfeat: torch.Tensor | None = None,
             gen: torch.Generator | None = None):
    """One optimizer step on given ray slices (ray-major leaves [O, R, ...]
    for fg, [R, ...] for bg). A slice carries either ``partfeat`` (already
    gathered) or ``partfeat_idx`` into ``partfeat``, and either ``z`` or
    the ``max_bound`` from which ``gen`` draws it (``resolve_z``). Returns
    (new state, the step's total loss as a 0-d tensor on the device).
    Inside ``sharding.use_mesh`` the state and ``active`` are this rank's
    block of slots and the slices the whole step's, and the loss is this
    rank's share: ``sharding.mesh_sum`` of it is the step's loss."""
    fg_sl = resolve_z(gen, dict(fg_sl), cfg, is_bg=False)
    bg_sl = None if bg_sl is None else resolve_z(gen, dict(bg_sl), cfg, is_bg=True)
    # ray-level data parallelism: under a ("data", "object") mesh each rank
    # takes its block of slots and its share of the step's rays
    fg_sl = {k: sharding.maybe_constrain(v, "object", "data") for k, v in fg_sl.items()}
    if bg_sl is not None:
        bg_sl = {k: sharding.maybe_constrain(v, "data") for k, v in bg_sl.items()}
    if cfg.part_mode:
        fg_sl = gather_partfeat(fg_sl, partfeat)
        if bg_sl is not None:
            bg_sl = gather_partfeat(bg_sl, partfeat)

    fg_p, fg_wrt = differentiable(state.fg_params)
    total, _ = _loss_for_slice(fg_p, fg_sl, active, cfg, is_bg=False)
    loss = total.detach()
    wrt = [("fg",) + p for p, _ in fg_wrt]
    leaves = [x for _, x in fg_wrt]
    if bg_sl is not None:
        bg_p, bg_wrt = differentiable(state.bg_params)
        bg_total, _ = _loss_for_slice(bg_p, bg_sl, None, cfg, is_bg=True)
        total = total + bg_total
        if sharding.axis_rank("object") == 0:    # the bg's term counted once
            loss = total.detach()
        wrt += [("bg",) + p for p, _ in bg_wrt]
        leaves += [x for _, x in bg_wrt]
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = sharding.data_sum_all(grads)
    grads = optim.unflatten(zip(wrt, grads))

    update = optim.adamw_update_flat if cfg.optim_impl == "flat" else optim.adamw_update
    fg_params, fg_opt = update(
        state.fg_params, grads["fg"], state.fg_opt,
        lr=cfg.learning_rate, weight_decay=cfg.weight_decay, active=active)
    bg_params, bg_opt = state.bg_params, state.bg_opt
    if bg_sl is not None:
        bg_params, bg_opt = update(
            state.bg_params, grads["bg"], state.bg_opt,
            lr=cfg.learning_rate, weight_decay=cfg.weight_decay)
    return TrainState(fg_params, fg_opt, bg_params, bg_opt, state.n_shards), loss


def train_frame(
    state: TrainState,
    store: FrameStore,
    cam_dirs: torch.Tensor,
    fg_tables: dict,
    bg_tables: dict | None,
    gen: torch.Generator,
    cfg: TrainConfig,
):
    """One frame of incremental mapping: draw the frame's rays (all of them
    up front, or each step its own with ``cfg.sample_per_step``), then
    n_iters optimizer steps, each consuming win*samples rays per object
    (+ the bg window). Returns (new state, per-step losses [n_iters]) with
    the losses left on the device. Inside ``sharding.use_mesh`` the state
    and ``fg_tables`` are this rank's block of slots, and the losses are
    the whole run's; a state cut for another "object" axis is refused
    (``check_mesh``)."""
    check_mesh(state)
    active = fg_tables["active"]
    # every rank draws for every slot, as the unsharded run does, so its
    # block's rays are the unsharded run's; run_step keeps the block
    fg_tables = sharding.gather_objects(fg_tables)
    do_bg = cfg.do_bg and state.bg_params is not None and bg_tables is not None
    if not cfg.sample_per_step:
        fg_batch = sample_fg_batch(gen, store, cam_dirs, fg_tables, cfg, scan_order=True)
        bg_batch = (sample_bg_batch(gen, store, cam_dirs, bg_tables, cfg, scan_order=True)
                    if do_bg else None)
    step_losses = []
    for i in range(cfg.n_iters_per_frame):
        if cfg.sample_per_step:
            fg_sl = sample_fg_batch(gen, store, cam_dirs, fg_tables, cfg, n_iters=1)
            bg_sl = (sample_bg_batch(gen, store, cam_dirs, bg_tables, cfg, n_iters=1)
                     if do_bg else None)
        else:
            fg_sl = {k: x[i] for k, x in fg_batch.items()}
            bg_sl = {k: x[i] for k, x in bg_batch.items()} if do_bg else None
        state, loss = run_step(state, fg_sl, bg_sl, active, cfg, store.partfeat, gen)
        step_losses.append(loss)
    return state, sharding.mesh_sum(torch.stack(step_losses))
