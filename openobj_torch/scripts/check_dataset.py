"""Preflight a mounted Replica/ScanNet scene against every on-disk contract
the loaders consume, then run real frames end to end through the dataset
class: one command that answers "can I run on this mount?" before any card
time is spent.

    python -m openobj_torch.scripts.check_dataset configs/replica/room_0.json
    python -m openobj_torch.scripts.check_dataset cfg.json --root /mnt/replica/room_0
    python -m openobj_torch.scripts.check_dataset cfg.json --frames 4   # e2e frames

Port of ``scripts/check_dataset.py``, with the same PASS/WARN/FAIL rows on
the same tree. It is a host preflight and takes no ``--device`` (the JAX one
forces the CPU): frames are read with the port's readers (``utils.png``;
colour through ``data.loaders._read_rgb``, ScanNet's JPEG included) where
the JAX script uses OpenCV.

Contracts checked (docs/DATA.md; reference objnerf/dataset.py:52-109):
  traj_w_c.txt row-per-frame flattened 4x4 poses; rgb/depth frame files and
  dtypes; instance_our/class_our id images at the association stride;
  object_{clipfeat,capfeat,caption}.pkl per-assoc-frame feature dicts
  (dims, normalization, id coverage); partlevel/<idx>.npy part maps
  (shape vs part_down); ScanNet intrinsic/intrinsic_depth.txt; then
  make_dataset + __getitem__ on first/last sampled frames with field-level
  validation of the produced FrameSamples.

Exit code 0 = no FAIL rows (WARNs allowed, each explained).
"""


import argparse
import os
import pickle
import sys

import numpy as np

_ROWS = []


def check(name, ok, detail="", warn=False):
    status = "PASS" if ok else ("WARN" if warn else "FAIL")
    _ROWS.append((status, name, detail))
    print(f"[{status}] {name}" + (f" — {detail}" if detail else ""), flush=True)
    return ok


def _imread(path, colour=False):
    """The image at ``path`` (colour: [H, W, 3] uint8; else as stored), or
    None when it cannot be read, as ``cv2.imread`` returns."""
    from openobj_torch.data.loaders import _read_rgb
    from openobj_torch.utils.png import read_png

    try:
        return _read_rgb(path) if colour else read_png(path)
    except Exception:  # noqa: BLE001 — a file that does not decode
        return None


def check_poses(root, n_needed):
    path = os.path.join(root, "traj_w_c.txt")
    if not check("traj_w_c.txt exists", os.path.isfile(path), path):
        return None
    try:
        t = np.loadtxt(path, delimiter=" ")
    except ValueError:
        # the reference writes space-delimited; tolerate generic whitespace
        t = np.loadtxt(path)
    ok = t.ndim == 2 and t.shape[1] == 16
    if not check("pose rows are flattened 4x4 (16 cols)", ok, f"shape {t.shape}"):
        return None
    t = t.reshape(-1, 4, 4)
    check("pose count covers the sampled range",
          t.shape[0] >= n_needed, f"{t.shape[0]} poses, need >= {n_needed}")
    check("poses finite", bool(np.isfinite(t).all()))
    bottom = t[:, 3, :]
    check("pose bottom rows are [0,0,0,1]",
          bool(np.allclose(bottom, [0, 0, 0, 1], atol=1e-5)),
          warn=True, detail="loader uses rows as T_wc verbatim")
    return t


def check_frame_files(ds, cfg, sample_idxs):
    h_exp = cfg.camera.height + 2 * cfg.margin_h
    w_exp = cfg.camera.width + 2 * cfg.margin_w
    for idx in sample_idxs:
        rp, dp = ds._rgb_path(idx), ds._depth_path(idx)
        if not check(f"rgb frame {idx}", os.path.isfile(rp), rp):
            continue
        rgb = _imread(rp, colour=True)
        check(f"rgb frame {idx} decodes 3-channel",
              rgb is not None and rgb.ndim == 3 and rgb.shape[2] == 3)
        if not check(f"depth frame {idx}", os.path.isfile(dp), dp):
            continue
        depth = _imread(dp)
        if not check(f"depth frame {idx} decodes", depth is not None):
            continue
        check(f"depth frame {idx} integer depth (mm convention)",
              depth.dtype in (np.uint16, np.int32, np.uint8),
              f"dtype {depth.dtype} (scaled by {cfg.depth_scale})",
              warn=depth.dtype == np.uint8)
        check(f"depth frame {idx} size matches config camera",
              depth.shape[:2] == (h_exp, w_exp),
              f"{depth.shape[:2]} vs config {(h_exp, w_exp)}"
              " (rgb/inst are resized to depth; config mismatch breaks "
              "ray directions)",
              # hard error when undistorting: maps are built from config
              warn=not cfg.undistort)
        mm = depth.astype(np.float64) * cfg.depth_scale
        frac_in = float((mm[mm > 0] < cfg.max_depth).mean()) if (mm > 0).any() else 0.0
        check(f"depth frame {idx} plausible after scale ({cfg.depth_scale})",
              frac_in > 0.5,
              f"{frac_in:.0%} of valid pixels < max_depth {cfg.max_depth} m",
              warn=True)


def check_instances(ds, sample_idxs):
    seen_ids = set()
    for idx in sample_idxs:
        ip = ds._inst_path(idx // ds.assoc_stride)
        if not check(f"instance image for frame {idx} (assoc "
                     f"{idx // ds.assoc_stride})", os.path.isfile(ip), ip):
            continue
        inst = _imread(ip)
        if not check(f"instance image {idx // ds.assoc_stride} decodes",
                     inst is not None):
            continue
        check(f"instance image {idx // ds.assoc_stride} integer ids",
              np.issubdtype(inst.dtype, np.integer), f"dtype {inst.dtype}")
        ids = set(int(i) for i in np.unique(inst))
        seen_ids |= ids
        check(f"instance ids in reference convention (frame {idx})",
              all(i >= 0 for i in ids),
              "0=unknown/bg wall, 1/2/3 reserved, 4+ objects, 999 junk",
              warn=False)
    cp = os.path.join(ds.root_dir, "class_our")
    check("class_our/ present (eval protocol input)", os.path.isdir(cp),
          cp, warn=True)
    return seen_ids


def check_feature_pkls(root, assoc_idxs, inst_ids):
    out = {}
    dims = {"object_clipfeat.pkl": 512, "object_capfeat.pkl": 384,
            "object_caption.pkl": None}
    for fname, dim in dims.items():
        path = os.path.join(root, fname)
        # caption pkl is consumed by the viz/query layer, not the trainer's
        # loader — its absence degrades retrieval, not training
        optional = fname == "object_caption.pkl"
        if not check(f"{fname} exists", os.path.isfile(path), path,
                     warn=optional):
            continue
        with open(path, "rb") as f:
            d = pickle.load(f)
        out[fname] = d
        # the loader indexes by assoc idx — both a list (reference writer,
        # mask_graph.py:1268-1280 appends per frame) and a dict qualify
        check(f"{fname} indexable by assoc frame", isinstance(d, (dict, list)),
              f"type {type(d).__name__}")
        if isinstance(d, dict):
            missing = [i for i in assoc_idxs if i not in d]
        else:
            missing = [i for i in assoc_idxs if i >= len(d)]
        check(f"{fname} covers the sampled assoc frames", not missing,
              f"missing assoc idxs {missing}" if missing else
              f"{len(d)} assoc frames")
        if not d or missing:
            continue
        frame = d[assoc_idxs[0]]
        check(f"{fname} frames map global_id -> value",
              isinstance(frame, dict), f"type {type(frame).__name__}")
        if dim is not None and isinstance(frame, dict) and frame:
            k0 = next(iter(frame))
            v = np.asarray(frame[k0])
            check(f"{fname} feature dim == {dim}", v.shape[-1] == dim,
                  f"shape {v.shape}")
            n = float(np.linalg.norm(np.asarray(v, np.float64)))
            check(f"{fname} features unit-norm", abs(n - 1.0) < 2e-2,
                  f"|v|={n:.4f} (similarity math assumes normalized)",
                  warn=True)
            # every instance id rendered into the PNGs should have features
            have = set()
            for fr in (d.values() if isinstance(d, dict) else d):
                if isinstance(fr, dict):
                    have |= set(int(k) for k in fr)
            # reserved/unknown ids (0..3, 999) have anchored features
            need = {i for i in inst_ids if i >= 4 and i != 999}
            orphan = sorted(need - have)[:10]
            check(f"{fname} has features for rendered instance ids",
                  not orphan,
                  f"ids in PNGs without features: {orphan}" if orphan else
                  f"{len(have)} ids", warn=True)
    return out


def check_partmaps(ds, cfg, sample_idxs):
    if not cfg.train.part_mode:
        check("part maps", True, "part_mode off — skipped")
        return
    h = cfg.camera.height + 2 * cfg.margin_h
    w = cfg.camera.width + 2 * cfg.margin_w
    down = cfg.train.part_down
    # on-disk maps are stored at down=5 even for ScanNet's part_down=10
    # (the loader applies the extra 2x, dataset.py:314-318)
    disk_down = 5 if down == 10 else down
    for idx in sample_idxs:
        pp = os.path.join(ds.root_dir, "partlevel", f"{idx}.npy")
        if not check(f"part map for frame {idx}", os.path.isfile(pp), pp):
            continue
        pf = np.load(pp, mmap_mode="r")
        ok_shape = (pf.ndim == 3
                    and abs(pf.shape[0] - h // disk_down) <= 1
                    and abs(pf.shape[1] - w // disk_down) <= 1)
        check(f"part map {idx} shape ~ (H/{disk_down}, W/{disk_down}, C)",
              ok_shape, f"{pf.shape} vs ~({h // disk_down}, {w // disk_down}, C)")


def check_end_to_end(ds, cfg, n_frames):
    n = len(ds)
    if not check("dataset length > 0", n > 0, f"{n} sampled frames"):
        return
    # first n_frames-1 sampled frames PLUS always the last one: the sorted
    # slice form silently truncated n-1 (the largest element) for any
    # n > n_frames, letting tail-corrupt mounts pass preflight
    take = sorted(set(range(min(max(n_frames - 1, 1), n))) | {n - 1})
    for i in take:
        try:
            s = ds[i]
        except Exception as e:  # noqa: BLE001 — report, don't crash preflight
            check(f"__getitem__({i})", False, f"{type(e).__name__}: {e}")
            continue
        hw = s.depth.shape
        ok = (
            s.rgb.shape[:2] == hw
            and s.inst.shape == hw
            and np.isfinite(s.depth).all()
            and float(s.depth.max()) <= cfg.max_depth + 1e-6
            and np.isfinite(s.t_wc).all()
        )
        check(f"frame sample {i} (raw idx {s.frame_id}) consistent", bool(ok),
              f"rgb {s.rgb.shape} depth {hw} inst {s.inst.shape} "
              f"max_depth {float(s.depth.max()):.2f}")
        for oid, bb in (s.bboxes or {}).items():
            r0, r1, c0, c1 = bb
            if not (0 <= r0 < r1 <= hw[0] and 0 <= c0 < c1 <= hw[1]):
                check(f"frame {i} bbox for instance {oid} inside image",
                      False, f"{bb} vs {hw}")
                break
        if cfg.train.part_mode:
            check(f"frame sample {i} part map loaded",
                  s.part_feat is not None and s.part_feat.ndim == 3,
                  f"{None if s.part_feat is None else s.part_feat.shape}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config", help="scene config JSON (configs/...)")
    ap.add_argument("--root", help="override dataset.path from the config")
    ap.add_argument("--frames", type=int, default=2,
                    help="frames to run end to end (default 2)")
    args = ap.parse_args(argv)

    from openobj_torch.config import load_scene_config
    from openobj_torch.data import loaders

    _ROWS.clear()
    cfg = load_scene_config(args.config)
    if args.root:
        cfg.dataset_dir = args.root
    root = cfg.dataset_dir
    print(f"preflight: {cfg.dataset_format} scene at {root}\n")
    if not check("dataset directory exists", os.path.isdir(root), root):
        _finish()

    if cfg.dataset_format == "ScanNet":
        ip = os.path.join(root, "intrinsic", "intrinsic_depth.txt")
        if check("intrinsic/intrinsic_depth.txt", os.path.isfile(ip), ip):
            k = np.loadtxt(ip)
            check("intrinsics 4x4 with positive focals",
                  k.shape == (4, 4) and k[0, 0] > 0 and k[1, 1] > 0,
                  f"shape {k.shape}")

    try:
        ds = loaders.make_dataset(cfg)
    except Exception as e:  # noqa: BLE001
        check("loader constructs", False, f"{type(e).__name__}: {e}")
        _finish()

    n = len(ds)
    idx_last = cfg.start + max(n - 1, 0) * cfg.stride
    sample_idxs = sorted({cfg.start, cfg.start + cfg.stride, idx_last})
    check_poses(root, n_needed=idx_last + 1)
    check_frame_files(ds, cfg, sample_idxs)
    inst_ids = check_instances(ds, sample_idxs)
    assoc_idxs = sorted({i // ds.assoc_stride for i in sample_idxs})
    check_feature_pkls(root, assoc_idxs, inst_ids)
    check_partmaps(ds, cfg, sample_idxs)
    check_end_to_end(ds, cfg, args.frames)
    _finish()


def _finish():
    fails = [r for r in _ROWS if r[0] == "FAIL"]
    warns = [r for r in _ROWS if r[0] == "WARN"]
    print(f"\n{len(_ROWS)} checks: {len(_ROWS) - len(fails) - len(warns)} pass,"
          f" {len(warns)} warn, {len(fails)} fail")
    if fails:
        print("NOT READY — fix the FAIL rows before spending card time:")
        for _, name, detail in fails:
            print(f"  FAIL {name}" + (f" — {detail}" if detail else ""))
        sys.exit(1)
    print("READY: this mount satisfies every loader contract "
          "(see docs/DATA.md for the run commands)")
    sys.exit(0)


if __name__ == "__main__":
    main()
