"""SceneMapper — the incremental multi-object mapping runtime.

Port of ``openobj_tpu.core.scene``: frames stream in, objects are registered
into preallocated slots, and each frame runs one training frame
(``core.trainer.train_frame``). The host touches only the frame append,
per-object bbox extraction, the keyframe policy (``core.registry``) and
slot allocation.

The stacked object axis grows in power-of-two buckets (8, 16, 32, ...)
capped at ``max_objects``. A frame's loss vector stays on the device until
the next frame is dispatched (one-deep pipelining), so the host prepares
frame N+1 while the device trains frame N.

On a split object axis (``sharding.shard_scene`` of ``mapper.state``, then
``process_frame`` inside ``sharding.use_mesh``) each rank holds its block
of slots and the registry and frame store whole. Every rank makes every
draw the unsharded mapper makes (new slots' params, the grown bucket, the
frame's rays), so the generators stay in step and each block trains as the
unsharded mapper's slots do; a slot's params are written by the rank that
holds it, and ``slot_params`` sends them from there to every rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from openobj_torch.core import optim, trainer
from openobj_torch.core.frame_store import FrameStore, append_frame, init_frame_store
from openobj_torch.core.registry import ObjectRegistry
from openobj_torch.models import object_field
from openobj_torch.ops import sampling
from openobj_torch.parallel import sharding


@dataclass(frozen=True)
class Camera:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    def ray_dirs(self, device="cuda") -> torch.Tensor:
        return sampling.camera_ray_dirs(
            self.width, self.height, self.fx, self.fy, self.cx, self.cy,
            device=device)


def _next_bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class LossExplosionError(RuntimeError):
    """Raised when a frame's losses go non-finite or explode."""


class SceneMapper:
    def __init__(
        self,
        camera: Camera,
        cfg: trainer.TrainConfig,
        frame_capacity: int = 256,
        max_objects: int = 100,
        keyframe_buffer_size: int = 20,
        keyframe_step: float = 25,
        keyframe_step_bg: float = 50,
        seed: int = 0,
        initial_bucket: int = 8,
        on_loss_explosion: str = "raise",   # "raise" | "warn" | "ignore"
        loss_explosion_factor: float = 1e4,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.camera = camera
        self.cfg = cfg
        self.max_objects = max_objects
        self.cam_dirs = camera.ray_dirs(device=self.device)
        self.store: FrameStore = init_frame_store(
            frame_capacity, camera.height, camera.width,
            part_feat_dim=cfg.clip_size if cfg.part_mode else 0,
            part_down=cfg.part_down, part_dtype=cfg.part_dtype,
            device=self.device)
        self.registry = ObjectRegistry(
            max_objects=max_objects,
            keyframe_buffer_size=keyframe_buffer_size,
            keyframe_step=keyframe_step,
            keyframe_step_bg=keyframe_step_bg,
            do_bg=cfg.do_bg,
            seed=seed,
        )
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.state = trainer.init_train_state(
            self.gen, cfg, n_slots=initial_bucket, device=self.device)
        self.frame_count = 0
        # temporal frame i -> store slot (eviction can recycle slots)
        self.frame_slots: list[int] = []
        self.loss_history: list[float] = []
        self.on_loss_explosion = on_loss_explosion
        self.loss_explosion_factor = loss_explosion_factor
        self._pending_losses = None

    # ------------------------------------------------------------------ #

    def _ensure_capacity(self, n_objects: int):
        if n_objects <= self.state.global_slots:
            return
        # never outgrow the registry, whose tables are sized [max_objects]
        bucket = min(_next_bucket(n_objects), self.max_objects)
        self.state = trainer.grow_train_state(self.gen, self.state, self.cfg, bucket)

    def _block(self) -> slice:
        """This rank's slots of the whole run's."""
        n = self.state.n_slots
        start = sharding.slot_offset(n)
        return slice(start, start + n)

    def _allocate_new_slots(self, slots: list[int]):
        """Fresh params + zeroed optimizer state for reused/new slots. Every
        rank draws each slot's params, so that the generators stay in step;
        the rank holding the slot writes them."""
        block = self._block()
        for slot in slots:
            p = object_field.init_field_params(
                self.gen, hidden=self.cfg.hidden, clip_size=self.cfg.clip_size,
                scale=self.cfg.obj_scale, max_deg=self.cfg.max_deg,
                device=self.device)
            if block.start <= slot < block.stop:
                at = slot - block.start
                self.state.fg_params = object_field.write_slot(self.state.fg_params, at, p)
                self.state.fg_opt = optim.reset_slot(self.state.fg_opt, at)

    def _to_dev(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _fg_tables_device(self) -> dict:
        """The fg keyframe tables of this rank's slots, as ``train_frame``
        takes them."""
        b = self._block()
        r = self.registry
        centers = np.zeros((self.max_objects, 3), np.float32)
        for slot, st in r.slots.items():
            centers[slot] = st.obj_center
        return {
            "kf_frames": self._to_dev(r.kf_frames[b]),
            "kf_bbox": self._to_dev(r.kf_bbox[b]),
            "n_kf": self._to_dev(r.n_kf[b]),
            "latest2": self._to_dev(r.latest2[b]),
            "active": self._to_dev(r.active[b]),
            "obj_inst": self._to_dev(r.obj_inst[b]),
            "obj_center": self._to_dev(centers[b]),
        }

    def _bg_tables_device(self) -> dict:
        t = self.registry.bg_tables()
        return {k: self._to_dev(t[k]) for k in ("kf_frames", "kf_bbox", "n_kf", "latest2")}

    # ------------------------------------------------------------------ #

    def process_frame(
        self,
        rgb: np.ndarray,           # [H, W, 3] uint8
        depth: np.ndarray,         # [H, W] float32 meters (0 = invalid)
        inst: np.ndarray,          # [H, W] int32 global instance ids, -1 unknown
        t_wc: np.ndarray,          # [4, 4]
        bboxes: dict[int, tuple] | None = None,
        partfeat: np.ndarray | None = None,
        obj_clip: dict[int, np.ndarray] | None = None,
        obj_cap: dict[int, np.ndarray] | None = None,
        obj_caption: dict[int, str] | None = None,
        train: bool = True,
    ):
        """Ingest one posed RGB-D frame and run one frame's optimization.
        Returns the per-step loss vector (a device tensor) or None if
        train=False. Inside ``sharding.use_mesh`` every rank calls it with
        the same frame; the state must have been cut for that mesh's
        "object" axis, and ``max_objects`` must be a multiple of it."""
        from openobj_torch.data.transforms import instance_bboxes

        trainer.check_mesh(self.state)
        n_shards = self.state.n_shards
        if self.max_objects % n_shards:
            # the bucket stops at max_objects, which every rank must split alike
            raise ValueError(
                f"max_objects ({self.max_objects}) is not a multiple of the 'object' "
                f"mesh axis ({n_shards})")
        at = None
        if self.store.n_frames >= self.store.capacity:
            at = self._evict_frame_slot()
        self.store, frame_idx = append_frame(
            self.store, rgb, depth, inst, t_wc, partfeat, at=at)
        self.frame_slots.append(frame_idx)
        if bboxes is None:
            bboxes = instance_bboxes(np.asarray(inst))
        for oid, bbox in bboxes.items():
            self.registry.observe_object(
                oid, frame_idx, np.asarray(bbox, np.float32),
                clip_feat=(obj_clip or {}).get(oid),
                caption_feat=(obj_cap or {}).get(oid),
                caption=(obj_caption or {}).get(oid),
            )
        new_slots = self.registry.pop_new_slots()
        self._ensure_capacity(self.registry.n_objects)
        self._allocate_new_slots(new_slots)
        self.frame_count += 1

        if not train or (self.registry.n_objects == 0 and not self.registry.bg_seen):
            return None

        # validate the PREVIOUS frame's losses (already computed), keeping
        # this frame's dispatch asynchronous (one-deep pipeline)
        self.finish()
        losses = self._train_once_async()
        self._pending_losses = (self.frame_count - 1, losses)
        return losses

    def _evict_frame_slot(self) -> int:
        """Pick a store slot no keyframe ring references."""
        ref = self.registry.referenced_frames()
        for i in range(self.store.capacity):
            if i not in ref:
                return i
        raise RuntimeError(
            f"frame store exhausted: all {self.store.capacity} slots are "
            f"referenced by keyframe rings ({len(ref)} referenced). Raise "
            "frame_capacity or shrink keyframe_buffer_size.")

    def finish(self) -> None:
        """Drain the pipeline: validate the last frame's losses."""
        if self._pending_losses is not None:
            pframe, plosses = self._pending_losses
            prev = plosses.cpu().numpy()
            self._check_losses(prev, pframe)
            self.loss_history.append(float(prev[-1]))
            self._pending_losses = None

    def _check_losses(self, losses: np.ndarray, frame_idx: int):
        """Non-finite losses, or a frame ending > loss_explosion_factor x
        its running median, signal divergence."""
        if self.on_loss_explosion == "ignore":
            return
        last = float(losses[-1])
        bad = not np.isfinite(losses).all()
        if not bad and len(self.loss_history) >= 3:
            med = float(np.median(self.loss_history[-20:]))
            bad = med > 0 and last > self.loss_explosion_factor * med
        if bad:
            msg = (f"loss explosion at frame {frame_idx}: "
                   f"last={last!r}, history tail="
                   f"{[round(x, 3) for x in self.loss_history[-3:]]}")
            if self.on_loss_explosion == "raise":
                raise LossExplosionError(msg)
            print(f"[openobj_torch] WARNING: {msg}")

    def _train_once_async(self):
        fg_tables = self._fg_tables_device()
        bg_tables = self._bg_tables_device() if self.cfg.do_bg else None
        self.state, losses = trainer.train_frame(
            self.state, self.store, self.cam_dirs, fg_tables, bg_tables,
            self.gen, self.cfg)
        return losses

    # ------------------------------------------------------------------ #

    @property
    def n_objects(self) -> int:
        return self.registry.n_objects

    def slot_params(self, slot: int) -> dict:
        """One slot's params, by the whole run's slot index. On a split
        object axis, a collective: the rank holding the slot sends it to
        every rank, so every rank calls this for the same slots in the
        same order."""
        trainer.check_mesh(self.state)
        return sharding.broadcast_slot(self.state.fg_params, slot)

    def params_for_instance(self, inst_id: int) -> dict:
        """An instance's params (the background model's for id 0 with
        ``do_bg``); a collective as ``slot_params`` is."""
        if self.cfg.do_bg and inst_id == 0:
            return self.state.bg_params
        return self.slot_params(self.registry.inst_to_slot[inst_id])
