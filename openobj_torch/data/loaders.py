"""Replica / ScanNet sequence loaders.

Port of ``openobj_tpu.data.loaders``. Images are read with the port's PNG
codec (``utils.png``) and ScanNet's ``.jpg`` colour frames with its baseline
JPEG decoder (``utils.jpeg``, equal to OpenCV's decode), and resized with
``data.transforms.resize``, where the JAX package uses OpenCV; frames stay
numpy here and become tensors at the ``SceneMapper`` boundary.

Parity with the reference objnerf/dataset.py (kept in [H, W] layout —
the reference transposes everything to [W, H]):

  * frame subsampling: idx = start + i * stride (:79-81); the association
    artifacts (instance/class PNGs, feature pickles) are indexed by
    idx/10 — the association pipeline's own stride (:82, hardcoded 10);
  * instance PNG: uint16 ids; 0 -> -1 unknown (:107-109); the wall class
    (id 1, background_cls_list) -> bg id 0 (:163-164); pixels of dropped
    (too-small) objects -> -1 (:166);
  * per-object bboxes from masks, sides <= 10 px dropped, enlarged by
    bbox_scale=0.2 (x1.2) (:140-158);
  * bg (id 0) gets the full-frame bbox + the wall's features (:172-175);
  * depth: float32 * depth_scale, > max_depth -> 0 (image_transforms);
  * part features: partlevel/<idx>.npy, optional 2x bilinear downsample
    when part_down == 10 (ScanNet, :314-318);
  * poses from traj_w_c.txt rows (Replica + our ScanNet convention).

Loading is host-side and prefetched on a background thread — the
framework's equivalent of the reference's 4-worker DataLoader.
"""

from __future__ import annotations

import math
import os
import pickle
import queue
import threading
from dataclasses import dataclass

import numpy as np

from openobj_torch.data.transforms import (
    enlarge_bbox, resize, scale_depth, undistort, undistort_maps,
)
from openobj_torch.utils.jpeg import read_jpeg
from openobj_torch.utils.png import read_png

BACKGROUND_CLS = (1,)  # the association pipeline's wall id (dataset.py:67)


@dataclass
class FrameSample:
    frame_id: int
    rgb: np.ndarray            # [H, W, 3] uint8
    depth: np.ndarray          # [H, W] float32 meters
    inst: np.ndarray           # [H, W] int32: -1 unknown, 0 bg, 4+ objects
    t_wc: np.ndarray           # [4, 4]
    bboxes: dict               # {obj_id: (r0, r1, c0, c1)}
    obj_clip: dict             # {obj_id: 512-d}
    obj_cap: dict              # {obj_id: 384-d}
    part_feat: np.ndarray | None = None


def _natsort_key(p):
    base = os.path.splitext(os.path.basename(p))[0]
    digits = "".join(ch for ch in base if ch.isdigit())
    return int(digits) if digits else 0


def process_instance_frame(
    inst: np.ndarray,
    obj_clipfeat: dict,
    obj_capfeat: dict,
    bbox_scale: float = 0.2,
    min_side: int = 10,
    background_cls=BACKGROUND_CLS,
    imap_mode: bool = False,
):
    """The reference's per-frame instance/bbox derivation (dataset.py:107-175).
    Returns (inst_out, bboxes, clip_dict, cap_dict)."""
    inst = inst.astype(np.int32)
    h, w = inst.shape
    if imap_mode:
        # iMAP baseline (reference cfg imap_mode): no object decomposition —
        # everything is the background field, trained on the full frame
        return np.zeros_like(inst), {0: (0, h, 0, w)}, {}, {}
    inst = inst.copy()
    inst[inst == 0] = -1  # 0 is "unknown", not background (dataset.py:107-109)

    bboxes, clip_d, cap_d = {}, {}, {}
    kept = np.zeros_like(inst)
    for inst_id in np.unique(inst):
        if inst_id == -1 or inst_id in background_cls:
            continue
        mask = inst == inst_id
        rows = np.any(mask, axis=1)
        cols = np.any(mask, axis=0)
        r0, r1 = np.argmax(rows), h - np.argmax(rows[::-1])
        c0, c1 = np.argmax(cols), w - np.argmax(cols[::-1])
        if (r1 - r0) <= min_side or (c1 - c0) <= min_side:
            continue  # too small -> unknown (dataset.py:147)
        bb = enlarge_bbox((r0, r1, c0, c1), 1.0 + bbox_scale, h, w)
        inst_id = int(inst_id)
        kept[mask] = 1
        bboxes[inst_id] = bb
        if inst_id in obj_clipfeat:
            clip_d[inst_id] = obj_clipfeat[inst_id]
        if inst_id in obj_capfeat:
            cap_d[inst_id] = obj_capfeat[inst_id]
    for cls in background_cls:
        inst[inst == cls] = 0
    inst[(kept == 0) & (inst != 0)] = -1  # dropped objects -> unknown

    # background slot: full-frame bbox + the wall's features (dataset.py:172-175)
    wall_key = background_cls[0]
    if wall_key in obj_clipfeat:
        bboxes[0] = (0, h, 0, w)
        clip_d[0] = obj_clipfeat[wall_key]
        if wall_key in obj_capfeat:     # same omit-when-missing contract
            cap_d[0] = obj_capfeat[wall_key]   # as the object slots above
    return inst, bboxes, clip_d, cap_d


def infer_assoc_stride(inst_dir: str, n_raw: int, train_stride: int = 10,
                       default: int = 10) -> int:
    """Association-artifact stride, inferred from the artifacts themselves.

    The perception stages write one instance map / feature entry per
    KEYFRAME (raw indices 0, s, 2s, ... -> artifact k for raw frame k*s).
    The reference hardcodes s=10 (dataset.py:82), but the weights-free
    auto path scales s to the sequence length (perception.auto
    keyframe_skip) — a loader that assumed 10 would hand every frame of a
    short scene the WRONG frame's instance supervision. Inference: count
    the semantic_instance_*.png files; the unique stride consistent with
    covering n_raw frames satisfies (n_assoc-1)*s < n_raw <= n_assoc*s,
    i.e. s = ceil(n_raw / n_assoc).

    The writer (perception.auto.keyframe_skip) only ever emits divisors of
    the train stride, so any other inferred value is evidence of a
    DAMAGED mount (e.g. one artifact deleted making 40 frames / 3 files
    "look like" stride 14), not of an exotic layout — those, and missing
    or empty artifact dirs (pre-perception runs), fall back to
    ``default`` so the preflight's per-frame existence checks still fire
    on the true indices."""
    try:
        n_assoc = sum(
            1 for f in os.listdir(inst_dir)
            if f.startswith("semantic_instance_") and f.endswith(".png")
        )
    except OSError:
        return default
    if n_assoc <= 0 or n_raw <= 0:
        return default
    s = -(-n_raw // n_assoc)
    if (n_assoc - 1) * s < n_raw <= n_assoc * s and train_stride % s == 0:
        return s
    return default


class _SequenceDataset:
    """Common Replica/ScanNet logic; subclasses provide file lists."""

    # artifact index = frame_idx // assoc_stride (reference dataset.py:82);
    # inferred lazily from the artifacts via infer_assoc_stride — lazily
    # because ScanNet's file lists are built AFTER the base __init__
    _assoc_stride: int | None = None

    @property
    def assoc_stride(self) -> int:
        if self._assoc_stride is None:
            self._assoc_stride = infer_assoc_stride(
                os.path.dirname(self._inst_path(0)), self._n_raw_frames(),
                train_stride=self.stride,
            )
        return self._assoc_stride

    def __init__(self, root_dir: str, start: int = 0, stride: int = 10,
                 depth_scale: float = 1e-3, max_depth: float = 8.0,
                 part_mode: bool = False, part_down: int = 5,
                 imap_mode: bool = False, camera=None, distortion=None,
                 apply_undistort: bool = False,
                 margin_h: int = 0, margin_w: int = 0,
                 min_bbox_side: int = 10):
        self.root_dir = root_dir
        self.start = start
        self.stride = stride
        self.depth_scale = depth_scale
        self.max_depth = max_depth
        self.part_mode = part_mode
        self.part_down = part_down
        self.imap_mode = imap_mode
        self.min_bbox_side = min_bbox_side
        # undistortion (reference image_transforms.py:36-59; maps built
        # lazily from the first frame's size). Explicit opt-in: the
        # reference parses coefficients but never applies Undistort in its
        # loaders, so presence of coefficients alone must not remap.
        self.camera = camera
        self.distortion = distortion
        self.apply_undistort = apply_undistort and distortion is not None
        self.margin_h = margin_h
        self.margin_w = margin_w
        self._undistort_maps = None
        self.t_wc_all = np.loadtxt(
            os.path.join(root_dir, "traj_w_c.txt"), delimiter=" "
        ).reshape(-1, 4, 4)
        with open(os.path.join(root_dir, "object_clipfeat.pkl"), "rb") as f:
            self.obj_clipfeat = pickle.load(f)
        with open(os.path.join(root_dir, "object_capfeat.pkl"), "rb") as f:
            self.obj_capfeat = pickle.load(f)

    def _rgb_path(self, idx: int) -> str:
        raise NotImplementedError

    def _depth_path(self, idx: int) -> str:
        raise NotImplementedError

    def _inst_path(self, idx_no: int) -> str:
        return os.path.join(
            self.root_dir, "instance_our", f"semantic_instance_{idx_no}.png"
        )

    def _n_raw_frames(self) -> int:
        raise NotImplementedError

    # Replica floors (reference dataset.py:75), ScanNet ceils (:278) —
    # a non-multiple frame count keeps its last frame only on ScanNet
    length_ceil = False

    def __len__(self) -> int:
        n = (self._n_raw_frames() - self.start) / self.stride
        return int(math.ceil(n)) if self.length_ceil else int(n)

    def __getitem__(self, i: int) -> FrameSample:
        idx = int(self.start + i * self.stride)
        idx_no = idx // self.assoc_stride
        rgb = _read_rgb(self._rgb_path(idx))
        depth_raw = read_png(self._depth_path(idx)).astype(np.float32)
        depth_raw = np.nan_to_num(depth_raw, nan=0.0)
        if rgb.shape[:2] != depth_raw.shape:
            # bring rgb to depth resolution FIRST so one set of maps (built
            # for the depth intrinsics) undistorts everything consistently
            rgb = resize(rgb, (depth_raw.shape[1], depth_raw.shape[0]))
        inst_raw = read_png(self._inst_path(idx_no))
        if inst_raw.shape[:2] != depth_raw.shape:
            # bring the id image to depth resolution too (nearest — ids
            # must never blend); otherwise masks are misaligned with the
            # resized rgb/depth and per-pixel packing gets mixed shapes
            inst_raw = resize(inst_raw, (depth_raw.shape[1], depth_raw.shape[0]),
                              nearest=True)
        if self.apply_undistort:
            if self._undistort_maps is None:
                h_im, w_im = depth_raw.shape
                cam = self.camera
                exp = (cam.height + 2 * self.margin_h,
                       cam.width + 2 * self.margin_w)
                if (h_im, w_im) != exp:
                    raise ValueError(
                        f"undistort: on-disk image size {(h_im, w_im)} != "
                        f"config size {exp}; maps built from the config "
                        "intrinsics would be silently wrong"
                    )
                # the camera's cx/cy are margin-cropped (config.py); the
                # maps act on the full-size image, so shift back
                self._undistort_maps = undistort_maps(
                    w_im, h_im, cam.fx, cam.fy,
                    cam.cx + self.margin_w, cam.cy + self.margin_h,
                    self.distortion,
                )
            depth_raw = undistort(depth_raw, self._undistort_maps,
                                  nearest=True)
            rgb = undistort(rgb, self._undistort_maps)
            if inst_raw.shape[:2] == depth_raw.shape:
                # instance ids ride the same lens: remap nearest so ids
                # never blend (through float32, as the JAX package does)
                inst_raw = undistort(
                    inst_raw.astype(np.float32), self._undistort_maps,
                    nearest=True,
                ).astype(inst_raw.dtype)
        depth = scale_depth(depth_raw, self.depth_scale, self.max_depth)
        inst, bboxes, clip_d, cap_d = process_instance_frame(
            inst_raw,
            self.obj_clipfeat[idx_no], self.obj_capfeat[idx_no],
            min_side=self.min_bbox_side,
            imap_mode=self.imap_mode,
        )
        pf = None
        if self.part_mode:
            pf = np.load(os.path.join(self.root_dir, "partlevel", f"{idx}.npy"))
            if self.part_down == 10:  # ScanNet downsample (dataset.py:314-318)
                pf = resize(pf, (pf.shape[1] // 2, pf.shape[0] // 2))
        return FrameSample(
            frame_id=idx, rgb=rgb, depth=depth, inst=inst,
            t_wc=self.t_wc_all[idx], bboxes=bboxes,
            obj_clip=clip_d, obj_cap=cap_d, part_feat=pf,
        )


def _read_rgb(path: str) -> np.ndarray:
    """[H, W, 3] uint8 RGB of a colour frame, as OpenCV's default colour
    read gives it: a ``.jpg``/``.jpeg`` file through the baseline JPEG
    decoder, a PNG with its alpha channel dropped, grey replicated and
    16-bit samples keeping their high byte. Other formats raise."""
    if path.lower().endswith((".jpg", ".jpeg")):
        return read_jpeg(path)
    if not path.lower().endswith(".png"):
        raise NotImplementedError(f"{path}: the port reads JPEG and PNG colour frames")
    im = read_png(path)
    if im.dtype == np.uint16:
        im = (im >> 8).astype(np.uint8)
    if im.ndim == 2:
        im = np.repeat(im[..., None], 3, axis=2)
    elif im.shape[2] == 2:
        im = np.repeat(im[..., :1], 3, axis=2)
    return np.ascontiguousarray(im[..., :3])


class Replica(_SequenceDataset):
    """rgb/rgb_<i>.png + depth/depth_<i>.png (dataset.py:86-87)."""

    def _rgb_path(self, idx):
        return os.path.join(self.root_dir, "rgb", f"rgb_{idx}.png")

    def _depth_path(self, idx):
        return os.path.join(self.root_dir, "depth", f"depth_{idx}.png")

    def _n_raw_frames(self):
        return len(os.listdir(os.path.join(self.root_dir, "depth")))


class ScanNet(_SequenceDataset):
    """color/<i>.jpg + depth/<i>.png, natsorted (dataset.py:204-218)."""

    length_ceil = True  # reference dataset.py:278 (math.ceil)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        import glob

        color = os.path.join(self.root_dir, "color")
        self.color_paths = sorted(glob.glob(os.path.join(color, "*.jpg")),
                                  key=_natsort_key)
        self.depth_paths = sorted(
            glob.glob(os.path.join(self.root_dir, "depth", "*.png")),
            key=_natsort_key,
        )

    def _rgb_path(self, idx):
        return self.color_paths[idx]

    def _depth_path(self, idx):
        return self.depth_paths[idx]

    def _n_raw_frames(self):
        return len(self.color_paths)


def init_loader(dataset, prefetch: int = 2):
    """Background-thread prefetching iterator (the reference's DataLoader
    with 4 workers, dataset.py:19-41 — one thread suffices since zlib,
    numpy and the native JPEG entropy decode release the GIL)."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = object()

    def worker():
        # a per-frame failure must surface in the consumer, not silently
        # truncate the sequence: ship the exception through the queue
        try:
            for i in range(len(dataset)):
                q.put(dataset[i])
            q.put(stop)
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            break
        if isinstance(item, BaseException):
            raise item
        yield item


def make_dataset(scene_cfg):
    """SceneConfig -> dataset instance."""
    cls = {"Replica": Replica, "ScanNet": ScanNet}[scene_cfg.dataset_format]
    return cls(
        scene_cfg.dataset_dir,
        start=scene_cfg.start,
        stride=scene_cfg.stride,
        depth_scale=scene_cfg.depth_scale,
        max_depth=scene_cfg.max_depth,
        part_mode=scene_cfg.train.part_mode,
        part_down=scene_cfg.train.part_down,
        imap_mode=scene_cfg.imap_mode,
        min_bbox_side=getattr(scene_cfg, "min_bbox_side", 10),
        camera=scene_cfg.camera,
        distortion=scene_cfg.distortion,
        apply_undistort=scene_cfg.undistort,
        margin_h=scene_cfg.margin_h,
        margin_w=scene_cfg.margin_w,
    )
