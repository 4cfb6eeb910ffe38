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
        if n_objects <= self.state.n_slots:
            return
        # never outgrow the registry, whose tables are sized [max_objects]
        bucket = min(_next_bucket(n_objects), self.max_objects)
        self.state = trainer.grow_train_state(self.gen, self.state, self.cfg, bucket)

    def _allocate_new_slots(self, slots: list[int]):
        """Fresh params + zeroed optimizer state for reused/new slots."""
        for slot in slots:
            p = object_field.init_field_params(
                self.gen, hidden=self.cfg.hidden, clip_size=self.cfg.clip_size,
                scale=self.cfg.obj_scale, max_deg=self.cfg.max_deg,
                device=self.device)
            self.state.fg_params = object_field.write_slot(self.state.fg_params, slot, p)
            self.state.fg_opt = optim.reset_slot(self.state.fg_opt, slot)

    def _to_dev(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _fg_tables_device(self) -> dict:
        n = self.state.n_slots
        r = self.registry
        centers = np.zeros((self.max_objects, 3), np.float32)
        for slot, st in r.slots.items():
            centers[slot] = st.obj_center
        return {
            "kf_frames": self._to_dev(r.kf_frames[:n]),
            "kf_bbox": self._to_dev(r.kf_bbox[:n]),
            "n_kf": self._to_dev(r.n_kf[:n]),
            "latest2": self._to_dev(r.latest2[:n]),
            "active": self._to_dev(r.active[:n]),
            "obj_inst": self._to_dev(r.obj_inst[:n]),
            "obj_center": self._to_dev(centers[:n]),
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
        train=False."""
        from openobj_torch.data.transforms import instance_bboxes

        if sharding.axis_size("object") > 1:
            # the registry's tables and slot writes are the whole run's
            raise NotImplementedError(
                "SceneMapper.process_frame on a state split over the 'object' "
                "mesh axis is not ported (ROADMAP A16c); train a sharded state "
                "with trainer.train_frame")
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
        return object_field.slice_slot(self.state.fg_params, slot)

    def params_for_instance(self, inst_id: int) -> dict:
        if self.cfg.do_bg and inst_id == 0:
            return self.state.bg_params
        return self.slot_params(self.registry.inst_to_slot[inst_id])
