#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (openobj_torch) on one NVIDIA GPU.

Run from the root of a checkout:   python3 chip_smoke.py

It builds the CUDA kernels from openobj_torch/csrc with nvcc (sm_90a), then:
  1. prints the card and its power limit, and the build time;
  2. holds every kernel against its plain PyTorch version at the shapes of
     the main path (fg 64 objects x 1200 points, h=32; bg 1 x 16800, h=128;
     clip head on) and times kernel, plain version and bound; then the same
     at the other widths' shapes: the tensor-core K1/K2 at the room_0 shapes
     with h=64, fg at h=16, 48 and 96, bg at h=80 and 112 (every width they
     are built for), and the SIMT K1/K2/K2r at h=24 (fg-like [8, 1200]);
  3. runs the port of examples/synthetic_convergence.py through the kernels
     and a few training steps on the card against the same steps on the CPU;
  4. drives the main path: SceneMapper.process_frame at the Replica room_0
     envelope (configs/replica/room_0.json, 680x1200 frames, 50 objects +
     background, 512-d part features) for 3 frames, with the launch counts
     reset just before and read just after;
  4b. the map's outputs of that mapper at full width, with the counts reset
     just before and read just after: train.save_checkpoints (one object
     and the background reloaded, field outputs bit-identical),
     train.render_dataset of one pose (680x1200, 150 bins, chunks of 2048)
     and train.export_meshes (the config's grid 128, voxel 0.005): K1 must
     carry every field evaluation, as many launches as the code implies,
     with no K2, plain or eager call. Then, outside the counted run, one
     chunk of 4 objects rendered through K1 and through the plain field on
     the card with the same jitter, one object's occupancy grid likewise,
     one mesh timed stage by stage, and K1 against its plain version at
     the render and mesh shapes (K1's rows of the kernels line gain those
     shapes, each with the launches counted at exactly its dims);
  4c. the port of examples/run_synthetic_scene.py on a scene with ground
     truth, with the counts reset before and read after: stage 1, the
     association (perception.pipeline.associate, its similarity matrices
     on the card; the same call on the CPU must give the same final ids and
     instance images, bit for bit; the smallest |weighted - 1.0| over all
     pairs is printed), whose instance images feed stage 2, training with
     hidden_bg 64 (ff_fwd_kernel<64> and ff_bwd_kernel<64>; never the SIMT
     kernels, never the eager field), a held-out render composited, meshes;
     PSNR > 18, depth MAE < 0.3 m and at least one mesh, the example's
     gates; then K1/K2/K2r against their plain versions at the h=64 shapes
     that run launched;
  4d. room_0 from disk: a raw Replica-layout sequence (synthetic archetype
     tabletop, 30 frames at room_0's camera, 680x1200) written with
     data.synthetic.write_raw_scene; masks from its held-aside ground-truth
     maps associated on the card (and on the CPU: equal) and written as the
     loader's artifacts; random [136, 240, 512] part maps; then
     train.main on configs/replica/room_0.json with only dataset.path
     changed, in process, with the counts reset before and read after:
     checkpoints for the background and every object, scene_state.npz and
     timing.json, finite losses, K1/K2/K2r 200 times per trained frame and
     nothing plain or eager; prints ms per association frame, per loaded
     frame and per trained frame, and the matched instance mIoU of the
     written maps against the ground truth;
  5. the probe kernels (csrc/probes.cu, ports of the Pallas kernels of
     scripts/bench_ensemble_mm.py and scripts/bench_fused_step_probe.py):
     drives the two probe scripts' port (openobj_torch.scripts.*) with the
     probe counts reset just before and read just after, logs their
     answers, and holds each kernel's output from that run against its
     plain version, beside the times the scripts took of kernel, plain
     version and library call, and the bound;
  6. prints one JSON line with every kernel's numbers (the fused field's
     launches summed over the counted runs of phases 4, 4b, 4c and 4d, and by
     run and shape as counted), the card's nvidia-smi line, and last a
     JSON line {"ok": true, "device": ...}.

Each phase raises on failure; the script then exits non-zero and prints no
result line. Without a CUDA device, or without the repository beside it, it
exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# main-path shapes at the room_0 envelope
FG = dict(name="fg", o=64, n=1200, h=32)      # 64-slot bucket x 120 rays x 10 samples
BG = dict(name="bg", o=1, n=16800, h=128)     # 1200 rays x 14 samples
# the other widths, phase 2: the tensor-core kernels at the room_0 shapes
# with h=64, and at fg or bg at every other width they are built for
# (weights in shared memory at h=16; from L2, one n-tile per K1 item at 48,
# two at 80 to 112); the SIMT kernels at h=24
OTHER_WIDTHS = (
    dict(name="fg_h64", o=64, n=1200, h=64), dict(name="bg_h64", o=1, n=16800, h=64),
    dict(name="fg_h16", o=64, n=1200, h=16), dict(name="fg_h48", o=64, n=1200, h=48),
    dict(name="bg_h80", o=1, n=16800, h=80), dict(name="fg_h96", o=64, n=1200, h=96),
    dict(name="bg_h112", o=1, n=16800, h=112), dict(name="simt_h24", o=8, n=1200, h=24),
)

FWD_ATOL = 1e-4
GRAD_RTOL = 1e-3
# phase 4b: K1's render against the plain field on the card (one chunk of
# 4 objects, the same jitter): depth and colour where both pick the same
# winner, and the share of pixels whose winner differs (sharp thresholds:
# opacity >= 0.9, depth within the box, the z-buffer's strict <)
RENDER_ATOL = 1e-3
WINNER_FLIP_FRAC = 1e-3
OCC_ATOL = 1e-4
# phase 4b's render envelope (the JAX package's train.render_dataset
# defaults) and the view renderer's chunk
RENDER_BINS, RENDER_CHUNK, HIT_FRAC, VIEW_CHUNK = 150, 2048, 0.25, 4096
MESH_CHUNK = 65536          # meshing.eval_points_chunked's default


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------- #
# phase 2: every kernel against its plain version
# --------------------------------------------------------------------------- #


def check_kernels(device, shapes) -> dict:
    """Each kernel against its plain version at each shape, and its times."""
    import torch
    from openobj_torch.models import object_field
    from openobj_torch.ops import fused_field as ff
    from openobj_torch.scripts._benchlib import bound_ms, field_bounds

    per = {"fused_field_fwd": [], "fused_field_bwd": [], "fused_field_bwd_reduce": []}
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    for shape in shapes:
        o, n, h = shape["o"], shape["n"], shape["h"]
        params = object_field.init_stacked_fields(
            gen, o, hidden=h, clip_size=512, scale=2.0, device=device)
        # random biases too, so that every packed entry is exercised
        params = object_field.tree_map(
            lambda x: x + 0.05 * torch.randn(x.shape, generator=gen, device=device),
            params)
        wflat = ff._pack_params(params, h, True).contiguous()
        pts = (0.5 * torch.randn((o, n, 3), generator=gen, device=device)).contiguous()
        da = torch.randn((o, n, 1), generator=gen, device=device)
        dc = torch.randn((o, n, 3), generator=gen, device=device)
        dh = torch.randn((o, n, h), generator=gen, device=device)

        lib = ff._lib()

        def fwd_k():   # the forward kernel alone, into preallocated outputs
            err = lib.ff_forward(pts.data_ptr(), wflat.data_ptr(), a_k.data_ptr(),
                                 c_k.data_ptr(), f_k.data_ptr(), o, n, h, 1, ff._stream(pts))
            if err:
                raise RuntimeError(f"ff_forward: CUDA error {err}")

        # forward
        a_k, c_k, f_k = ff.fused_field_forward_cuda(wflat, pts, h, True)
        a_p, c_p, f_p = ff.fused_field_plain(wflat, pts, h, True)
        torch.cuda.synchronize()
        fwd_err = max(float((a_k - a_p).abs().max()), float((c_k - c_p).abs().max()),
                      float((f_k - f_p).abs().max()))
        if not fwd_err <= FWD_ATOL:
            raise AssertionError(f"K1 {shape['name']}: max abs err {fwd_err:.3e} > {FWD_ATOL}")

        # backward
        g_k = ff.fused_field_backward_cuda(wflat, pts, da, dc, dh, h, True)
        w_req = wflat.detach().requires_grad_(True)
        a_p, c_p, f_p = ff.fused_field_plain(w_req, pts, h, True)
        obj = (a_p * da).sum() + (c_p * dc).sum() + (f_p * dh).sum()
        (g_p,) = torch.autograd.grad(obj, w_req, retain_graph=True)
        torch.cuda.synchronize()
        bwd_err = float((g_k - g_p).abs().max())
        worst = 0.0
        ofs = 0
        for name, (r, c) in ff.param_layout(h):
            sl = slice(ofs, ofs + r * c)
            ofs += r * c
            ref = float(g_p[:, sl].abs().max())
            rel = float((g_k[:, sl] - g_p[:, sl]).abs().max()) / (ref + 1e-12)
            worst = max(worst, rel)
            if not rel <= GRAD_RTOL:
                raise AssertionError(
                    f"K2 {shape['name']} leaf {name}: max|d|/max|ref| {rel:.3e} > {GRAD_RTOL}")

        # the reduction on its own, against its plain version: the same sum in
        # tile order (the order of the TPU kernel's sequential grid), which it
        # must match exactly; torch.sum over the tile axis (another order,
        # rounding apart by ~1e-4 over 525 tiles) is the library call
        p = lib.ff_param_count(h)
        tile, n_tiles = ff.bwd_tiling(lib, o, n, h, device)
        part = torch.randn((o, n_tiles, p), generator=gen, device=device)
        red = torch.empty((o, p), device=device)

        def reduce_k():
            err = lib.ff_reduce(part.data_ptr(), red.data_ptr(), o, n_tiles, p,
                                ff._stream(part))
            if err:
                raise RuntimeError(f"ff_reduce: CUDA error {err}")

        def reduce_plain():
            acc = part[:, 0].clone()
            for t in range(1, n_tiles):
                acc += part[:, t]
            return acc

        reduce_k()
        red_ref = reduce_plain()
        torch.cuda.synchronize()
        red_err = float((red - red_ref).abs().max())
        if not torch.equal(red, red_ref):
            raise AssertionError(f"reduction {shape['name']}: max abs err {red_err:.3e} from "
                                 "the sum in tile order (must be exact)")

        def bwd_k():   # the backward kernel alone, into the same scratch
            err = lib.ff_backward(pts.data_ptr(), wflat.data_ptr(), da.data_ptr(),
                                  dc.data_ptr(), dh.data_ptr(), part.data_ptr(),
                                  o, n, h, 1, tile, ff._stream(pts))
            if err:
                raise RuntimeError(f"ff_backward: CUDA error {err}")

        # times: kernel, plain version, bound
        t_fwd = time_ms(fwd_k)
        t_fwd_plain = time_ms(lambda: ff.fused_field_plain(wflat, pts, h, True))
        t_bwd = time_ms(bwd_k)
        t_red = time_ms(reduce_k)
        t_bwd_plain = time_ms(lambda: torch.autograd.grad(obj, w_req, retain_graph=True))
        t_red_plain = time_ms(reduce_plain)
        t_sum = time_ms(lambda: part.sum(dim=1))

        fb = field_bounds(o, n, h, p)
        b_fwd, b_bwd = fb["fwd"], fb["bwd"]
        simt_fwd, simt_bwd = fb["fwd_simt"][0], fb["bwd_simt"][0]
        b_red = bound_ms(float(o * n_tiles * p), 4.0 * o * n_tiles * p + o * p * 4)
        names = ff.kernel_names(h)
        per["fused_field_fwd"].append(dict(
            shape=shape["name"], dims=[o, n, h], ms=t_fwd, plain_ms=t_fwd_plain, bound=b_fwd,
            bound_simt=simt_fwd, err=fwd_err, library_ms=None))
        per["fused_field_bwd"].append(dict(
            shape=shape["name"], dims=[o, n, h], ms=t_bwd, plain_ms=t_bwd_plain, bound=b_bwd,
            bound_simt=simt_bwd, err=bwd_err, rel=worst, library_ms=None))
        per["fused_field_bwd_reduce"].append(dict(
            shape=shape["name"], dims=[o, n, h], ms=t_red, plain_ms=t_red_plain, bound=b_red,
            bound_simt=b_red[0], err=red_err, library_ms=t_sum, tiles=n_tiles))
        for k, rows in per.items():
            rows[-1]["kernel"] = names[k]
        log(f"[kernels] {shape['name']} O={o} N={n} h={h} ({names['fused_field_fwd']}, "
            f"{names['fused_field_bwd']}): "
            f"K1 err {fwd_err:.2e} {t_fwd:.4f} ms (plain {t_fwd_plain:.4f}, bound {b_fwd[0]:.4f} "
            f"{b_fwd[1]}, SIMT-only {simt_fwd:.4f}) | "
            f"K2 err {bwd_err:.2e} worst-leaf rel {worst:.2e} {t_bwd:.4f} ms tile {tile} "
            f"(plain bwd {t_bwd_plain:.4f}, bound {b_bwd[0]:.4f} {b_bwd[1]}, "
            f"SIMT-only {simt_bwd:.4f}) | "
            f"reduce {n_tiles} tiles err {red_err:.2e} {t_red:.4f} ms (plain, in tile order, "
            f"{t_red_plain:.4f}; torch.sum {t_sum:.4f}, bound {b_red[0]:.4f} {b_red[1]})")
        del params, wflat, pts, da, dc, dh, part, red, obj, w_req
    return per


# --------------------------------------------------------------------------- #
# phase 3: convergence through the kernels, and steps against the CPU
# --------------------------------------------------------------------------- #


def check_convergence(device) -> None:
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import torch_synthetic_convergence as conv

    t0 = time.perf_counter()
    res = conv.run(device=device)
    conv.check(res)
    log(f"[convergence] losses {[round(x, 3) for x in res['losses']]} "
        f"depth MAE {res['depth_mae']:.4f} m colour MAE {res['color_mae']:.4f} "
        f"({time.perf_counter() - t0:.1f} s) CONVERGED OK")


def check_steps_vs_cpu(device) -> None:
    """A few optimizer steps of a small scene on the card (kernels) and on
    the CPU (plain version) from the same state and batches: the per-step
    losses must agree."""
    import torch
    from openobj_torch import convert
    from openobj_torch.core import trainer
    from openobj_torch.core.frame_store import append_frame, init_frame_store
    from openobj_torch.core.scene import Camera

    cfg = trainer.TrainConfig(
        n_iters_per_frame=4, win_size=2, n_samples_per_frame=16,
        win_size_bg=2, n_samples_per_frame_bg=64, hidden=32, hidden_bg=128,
        clip_size=64, part_mode=True, part_down=4)
    cam = Camera(width=40, height=32, fx=30.0, fy=30.0, cx=20.0, cy=16.0)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    state_cpu = trainer.init_train_state(gen, cfg, n_slots=4, device="cpu")
    store = init_frame_store(2, 32, 40, part_feat_dim=64, part_down=4, device="cpu")
    for _ in range(2):
        store, _ = append_frame(
            store, rng.integers(0, 255, (32, 40, 3)).astype(np.uint8),
            rng.uniform(0.5, 3.0, (32, 40)).astype(np.float32),
            rng.integers(-1, 4, (32, 40)).astype(np.int32), np.eye(4, dtype=np.float32),
            partfeat=rng.normal(size=(8, 10, 64)).astype(np.float32))
    fg = {
        "kf_frames": torch.tensor([[0, 1, 0]] * 4, dtype=torch.int32),
        "kf_bbox": torch.tensor([0, 32, 0, 40], dtype=torch.float32).repeat(4, 3, 1),
        "n_kf": torch.full((4,), 2, dtype=torch.int32),
        "latest2": torch.tensor([[0, 1]] * 4, dtype=torch.int32),
        "active": torch.tensor([True, True, True, False]),
        "obj_inst": torch.arange(1, 5, dtype=torch.int32),
        "obj_center": torch.zeros((4, 3)),
    }
    bg = {"kf_frames": fg["kf_frames"][0], "kf_bbox": fg["kf_bbox"][0],
          "n_kf": torch.tensor(2, dtype=torch.int32), "latest2": fg["latest2"][0]}
    fg_b = trainer.sample_fg_batch(gen, store, cam.ray_dirs("cpu"), fg, cfg, scan_order=True)
    bg_b = trainer.sample_bg_batch(gen, store, cam.ray_dirs("cpu"), bg, cfg, scan_order=True)
    state_gpu = convert.train_state_from_numpy(convert.to_numpy(state_cpu), device)
    pf_gpu = store.partfeat.to(device)
    act_gpu = fg["active"].to(device)
    worst = 0.0
    for i in range(cfg.n_iters_per_frame):
        fsl = {k: x[i] for k, x in fg_b.items()}
        bsl = {k: x[i] for k, x in bg_b.items()}
        state_cpu, l_cpu = trainer.run_step(state_cpu, fsl, bsl, fg["active"], cfg, store.partfeat)
        state_gpu, l_gpu = trainer.run_step(
            state_gpu, {k: x.to(device) for k, x in fsl.items()},
            {k: x.to(device) for k, x in bsl.items()}, act_gpu, cfg, pf_gpu)
        rel = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
        worst = max(worst, rel)
        if not (np.isfinite(float(l_gpu)) and rel <= 1e-4):
            raise AssertionError(f"step {i}: card loss {float(l_gpu)!r} vs CPU {float(l_cpu)!r}")
    log(f"[steps] {cfg.n_iters_per_frame} steps, card (kernels) vs CPU (plain): "
        f"worst rel loss diff {worst:.2e} (limit 1e-4)")


# --------------------------------------------------------------------------- #
# phase 4: the main path
# --------------------------------------------------------------------------- #


def synthetic_frames(n_frames: int, h: int, w: int, n_obj: int, clip: int,
                     down: int, seed: int = 0):
    """Room-like frames: a background at 4-6 m with n_obj axis-aligned
    blocks (instance ids 1..n_obj) at 0.5-4 m in front of it, one per cell
    of a grid so that every block stays visible, a thin band of unknown
    (-1) pixels, and a part-feature map at 1/down resolution. The blocks
    drift 3 px per frame."""
    rng = np.random.default_rng(seed)
    gc = int(np.ceil(np.sqrt(2 * n_obj)))
    gr = -(-n_obj // gc)
    ch, cw = h // gr, w // gc
    hs = rng.integers(ch // 3, 3 * ch // 4, n_obj)
    ws = rng.integers(cw // 3, 3 * cw // 4 - 3 * n_frames, n_obj)
    rows = (np.arange(n_obj) // gc) * ch + rng.integers(0, ch - hs)
    cols = (np.arange(n_obj) % gc) * cw + rng.integers(0, cw - ws - 3 * n_frames)
    zs = rng.uniform(0.5, 4.0, n_obj).astype(np.float32)
    cols_rgb = rng.integers(0, 256, (n_obj + 1, 3))
    for f in range(n_frames):
        shift = 3 * f
        depth = np.linspace(4.0, 6.0, w, dtype=np.float32)[None, :].repeat(h, 0)
        inst = np.zeros((h, w), np.int32)
        for k in range(n_obj):
            r0, c0 = rows[k], cols[k] + shift
            depth[r0:r0 + hs[k], c0:c0 + ws[k]] = zs[k] + 0.01 * np.arange(ws[k])[None, :]
            inst[r0:r0 + hs[k], c0:c0 + ws[k]] = k + 1
        inst[:, :4] = -1
        rgb = (cols_rgb[inst.clip(0)] + rng.integers(0, 8, (h, w, 3))).clip(0, 255).astype(np.uint8)
        t_wc = np.eye(4, dtype=np.float32)
        t_wc[0, 3] = 0.02 * f
        partfeat = rng.normal(size=(h // down, w // down, clip)).astype(np.float32)
        yield rgb, depth, inst, t_wc, partfeat


def profile_frame(step) -> None:
    """Run ``step`` (one frame) under torch.profiler; print the device busy
    share and the fused-field kernels' share of device time, and write the
    kernel table to chiprun_out/profile_main.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy = sum(dev_us(e) for e in rows)
    ff_us = sum(dev_us(e) for e in rows if "ff_" in e.key)
    launches = sum(e.count for e in rows)
    log(f"[profile] one frame: wall {wall_us / 1e3:.1f} ms (profiled), device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%), fused-field kernels "
        f"{ff_us / 1e3:.1f} ms ({100 * ff_us / max(busy, 1):.1f}% of busy), "
        f"{launches} device ops")
    top = sorted(rows, key=dev_us, reverse=True)[:12]
    for e in top:
        log(f"[profile]   {dev_us(e) / 1e3:9.2f} ms  x{e.count:6d}  {e.key[:90]}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_main.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))


def run_main_path(device, profile: bool = False):
    import torch
    from openobj_torch.config import load_scene_config, make_mapper
    from openobj_torch.ops import fused_field as ff

    cfg = load_scene_config(os.path.join(ROOT, "configs", "replica", "room_0.json"))
    mapper = make_mapper(cfg, frame_capacity=8, device=device)
    cam, tc = cfg.camera, cfg.train
    frames = list(synthetic_frames(3, cam.height, cam.width, 50, tc.clip_size, tc.part_down))
    torch.cuda.synchronize()

    ff.reset_counts()
    times, outs = [], []
    for rgb, depth, inst, t_wc, pf in frames:
        t0 = time.perf_counter()
        losses = mapper.process_frame(rgb, depth, inst, t_wc, partfeat=pf)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(losses)
    mapper.finish()
    counts = dict(ff.COUNTS)
    by_shape = dict(ff.COUNTS_BY_SHAPE)
    if profile:   # one more frame, outside the counted run
        rgb, depth, inst, t_wc, pf = frames[-1]
        profile_frame(lambda: mapper.process_frame(rgb, depth, inst, t_wc, partfeat=pf))
        mapper.finish()

    trained = sum(x is not None for x in outs)
    vecs = [x.cpu().numpy() for x in outs if x is not None]
    if trained != 3:
        raise AssertionError(f"only {trained} of 3 frames trained")
    for v in vecs:
        if v.shape != (tc.n_iters_per_frame,) or not np.isfinite(v).all():
            raise AssertionError(f"bad loss vector {v}")
    for i in range(len(vecs)):
        for j in range(i + 1, len(vecs)):
            if np.array_equal(vecs[i], vecs[j]):
                raise AssertionError(f"frames {i} and {j} gave identical loss vectors")
    steps = 2 * tc.n_iters_per_frame * trained     # fg + bg per step
    for k in ("fused_field_fwd", "fused_field_bwd", "fused_field_bwd_reduce"):
        if counts[k] != steps:
            raise AssertionError(f"{k} launched {counts[k]} times, expected {steps}")
    if counts["fused_field_plain"] != 0:
        raise AssertionError(f"plain version ran {counts['fused_field_plain']} times on the card")
    if counts["field_eager"] != 0:
        raise AssertionError(f"the eager field ran {counts['field_eager']} times at room_0's widths")
    want = {(k, s["o"], s["n"], s["h"]): steps // 2 for s in (FG, BG)
            for k in ("fused_field_fwd", "fused_field_bwd", "fused_field_bwd_reduce")}
    if by_shape != want:
        raise AssertionError(f"launches by shape {by_shape}, expected {want}")
    if mapper.state.n_slots != FG["o"] or mapper.n_objects != 50:
        raise AssertionError(f"bucket {mapper.state.n_slots} / objects {mapper.n_objects}")
    log(f"[main] room_0 envelope, {cam.height}x{cam.width}, {mapper.n_objects} objects "
        f"in a {mapper.state.n_slots}-slot bucket + bg: frame times "
        f"{[round(t * 1e3, 1) for t in times]} ms (first includes warm-up); "
        f"last-step losses {[round(float(v[-1]), 4) for v in vecs]}; counts {counts}")
    log(f"[main] ms/frame (frames 2-3): {1e3 * float(np.mean(times[1:])):.1f}")
    return by_shape, cfg, mapper, frames


# --------------------------------------------------------------------------- #
# phase 4b: the map's outputs at full width
# --------------------------------------------------------------------------- #


@contextlib.contextmanager
def plain_field_on_card():
    """Within: the fused field runs its plain version on CUDA tensors too
    (for comparisons only; nothing is counted)."""
    from openobj_torch.ops import fused_field as ff

    launch = ff.fused_field_apply
    ff.fused_field_apply = ff.fused_field_plain
    try:
        yield
    finally:
        ff.fused_field_apply = launch


@contextlib.contextmanager
def fixed_jitter(u):
    """Within: the renderer's jitter is ``u`` (cut to the shape asked for)."""
    from openobj_torch.core import renderer

    draw = renderer._uniform
    renderer._uniform = lambda gen, shape, device: u[tuple(slice(0, n) for n in shape)]
    try:
        yield
    finally:
        renderer._uniform = draw


def k1_shape_row(name, wflat, pts, h, launches) -> dict:
    """K1 with the clip head off at one render or mesh shape: its max abs
    error from the plain version, its time, the plain version's and the
    bound; ``launches`` were counted at exactly this shape."""
    import torch
    from openobj_torch.ops import fused_field as ff
    from openobj_torch.scripts._benchlib import bound_ms, fwd_macs_noclip

    o, n, _ = pts.shape
    lib = ff._lib()
    alpha = torch.empty((o, n, 1), device=pts.device)
    color = torch.empty((o, n, 3), device=pts.device)

    def fwd_k():
        err = lib.ff_forward(pts.data_ptr(), wflat.data_ptr(), alpha.data_ptr(),
                             color.data_ptr(), None, o, n, h, 0, ff._stream(pts))
        if err:
            raise RuntimeError(f"ff_forward: CUDA error {err}")

    fwd_k()
    with torch.no_grad():
        a_p, c_p, _ = ff.fused_field_plain(wflat, pts, h, False)
        torch.cuda.synchronize()
        err = max(float((alpha - a_p).abs().max()), float((color - c_p).abs().max()))
        del a_p, c_p
        if not err <= FWD_ATOL:
            raise AssertionError(f"K1 {name}: max abs err {err:.3e} > {FWD_ATOL}")
        t_k = time_ms(fwd_k)
        t_p = time_ms(lambda: ff.fused_field_plain(wflat, pts, h, False), iters=3, warmup=1)
    macs, mm = fwd_macs_noclip(h)
    npts = o * n
    nbytes = npts * 12 + wflat.numel() * 4 + npts * 4 * (1 + 3)
    b = bound_ms(2.0 * macs * npts, nbytes, 2.0 * mm * npts)
    log(f"[outputs] K1 {name} [{o},{n},3] h={h}: err {err:.2e}, {t_k:.4f} ms "
        f"(plain {t_p:.4f}, bound {b[0]:.4f} {b[1]}, SIMT-only "
        f"{bound_ms(2.0 * macs * npts, nbytes)[0]:.4f}), {launches} launches at this shape")
    return {"shape": name, "kernel": ff.kernel_names(h)["fused_field_fwd"], "dims": [o, n, h],
            "launches": launches, "max_abs_err": err,
            "ms": t_k, "plain_ms": t_p, "bound_ms": b[0], "bound_by": b[1],
            "bound_simt_ms": bound_ms(2.0 * macs * npts, nbytes)[0], "library_ms": None}


def run_outputs(device, cfg, mapper, frames) -> tuple[list[dict], dict]:
    """Phase 4b. Returns K1's rows for the render and mesh shapes, and the
    launches by shape that the outputs made."""
    import shutil
    from types import SimpleNamespace

    import torch
    from openobj_torch import train
    from openobj_torch.core import checkpoint, meshing, renderer
    from openobj_torch.models import object_field
    from openobj_torch.ops import fused_field as ff
    from openobj_torch.ops import sampling

    from openobj_torch import native

    if native.load() is None:
        raise AssertionError("the native geometry library (native/geometry.cc) did not build")
    out = os.path.join(ROOT, "build", "chip_smoke_outputs")
    shutil.rmtree(out, ignore_errors=True)
    cam, tc = cfg.camera, cfg.train
    t_wc = frames[-1][3]
    mapping = {i: i % 7 for i in mapper.registry.inst_to_slot}
    mapping[0] = 0
    torch.cuda.synchronize()

    ff.reset_counts()
    t0 = time.perf_counter()
    train.save_checkpoints(mapper, out, t_wc)
    t1 = time.perf_counter()
    train.render_dataset(mapper, [SimpleNamespace(t_wc=t_wc, frame_id=0)], out, mapping,
                         bg_ids=cfg.bg_ids, n_bins=RENDER_BINS, chunk=RENDER_CHUNK,
                         hit_frac=HIT_FRAC)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n_meshes = train.export_meshes(mapper, out, cfg.grid_dim, cfg.live_voxel_size)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = dict(ff.COUNTS)
    by_shape = dict(ff.COUNTS_BY_SHAPE)

    # the launches the code implies: one K1 per fg chunk (every object at
    # once), one per chunk of each background-id view (the config's bg ids
    # 0/2/3: the background model and, here, blocks 2 and 3), and per
    # meshed object its grid chunks plus its vertex chunks
    reg = mapper.registry
    ids, params, t_wo, ext, cen = train.render_stack(mapper, cfg.bg_ids)
    n_views = sum(1 for i, s in reg.inst_to_slot.items()
                  if i in cfg.bg_ids and reg.slots[s].bbox3d is not None)
    bg_model = int(tc.do_bg and reg.bg is not None and reg.bg.bbox3d is not None)
    n_px = cam.height * cam.width
    dirs_c = mapper.cam_dirs.reshape(-1, 3)
    tw = torch.as_tensor(t_wc, dtype=torch.float32, device=device)
    origins, dirs_w = sampling.origin_dirs_w(tw.expand(n_px, 4, 4), dirs_c)
    act = torch.ones(len(ids), dtype=torch.bool, device=device)
    need = int(renderer.obb_hit_counts(t_wo, ext, act, origins, dirs_w).max())
    full = -(-n_px // RENDER_CHUNK) * RENDER_CHUNK
    cap = min(-(-int(n_px * HIT_FRAC) // RENDER_CHUNK) * RENDER_CHUNK, full)
    while cap < min(need, full):
        cap = min(cap * 2, full)
    fg_launches = cap // RENDER_CHUNK
    view_chunks = -(-n_px // VIEW_CHUNK)
    bg_launches = (n_views + bg_model) * view_chunks
    mesh_launches = 0
    for i, s in reg.inst_to_slot.items():
        dim = meshing.adaptive_grid_dim(reg.slots[s].bbox3d, cfg.live_voxel_size, cfg.grid_dim)
        mesh_launches += -(-dim ** 3 // min(MESH_CHUNK, dim ** 3))
        obj = os.path.join(out, "scene_mesh", f"obj{i}.obj")
        if os.path.exists(obj):
            with open(obj) as f:
                n_v = sum(1 for line in f if line.startswith("v "))
            mesh_launches += -(-n_v // MESH_CHUNK)
    want = fg_launches + bg_launches + mesh_launches
    if counts["fused_field_fwd"] != want:
        raise AssertionError(f"K1 launched {counts['fused_field_fwd']} times, the code implies "
                             f"{want} ({fg_launches} fg, {bg_launches} bg, {mesh_launches} mesh)")
    others = {k: v for k, v in counts.items() if k != "fused_field_fwd" and v}
    if others:
        raise AssertionError(f"the outputs ran more than K1: {others}")
    if sum(by_shape.values()) != counts["fused_field_fwd"]:
        raise AssertionError(f"launches by shape {by_shape} do not add up to {counts}")
    boxed = sum(st.bbox3d is not None for st in reg.slots.values())
    if n_meshes < 1 or boxed != mapper.n_objects:
        raise AssertionError(f"{n_meshes} meshes, {boxed} of {mapper.n_objects} objects boxed")
    for name in ("rgb_0", "depth_0", "maskid_0", "inst_0"):
        if not os.path.exists(os.path.join(out, "render", f"{name}.png")):
            raise AssertionError(f"render_dataset wrote no {name}.png")
    log(f"[outputs] checkpoints {1e3 * (t1 - t0):.1f} ms; rendered frame "
        f"{cam.height}x{cam.width}, {RENDER_BINS} bins: {1e3 * (t2 - t1):.1f} ms/frame "
        f"({len(ids)} objects together, cap {cap} rays each, {need} hit at most; "
        f"{n_views} background-id objects and the background model as views); {n_meshes} "
        f"meshes at grid "
        f"{cfg.grid_dim}: {1e3 * (t3 - t2) / max(n_meshes, 1):.1f} ms/mesh; counts {counts}")

    # reload one object and the background: bit-identical field outputs
    gen = torch.Generator(device=device).manual_seed(0)
    pts = 0.5 * torch.randn((4096, 3), generator=gen, device=device)
    slot = reg.inst_to_slot[int(ids[0])]
    for inst, live, h in ((ids[0], mapper.slot_params(slot), tc.hidden),
                          (0, mapper.state.bg_params, tc.hidden_bg)):
        template = object_field.init_field_params(gen, hidden=h, clip_size=tc.clip_size,
                                                  device=device)
        ck = checkpoint.load_object_checkpoint(
            os.path.join(out, "ckpt", str(inst), f"obj_{inst}.npz"), template)
        with torch.no_grad():
            a = ff.field_evaluator(ck["params"], stacked=False)(pts)
            b = ff.field_evaluator(live, stacked=False)(pts)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"object {inst}: reloaded field outputs differ")
    log(f"[outputs] object {ids[0]} and the background reloaded: field outputs bit-identical")

    # one chunk of 4 objects through K1 and through the plain field
    sub = slice(0, 4)
    u = torch.rand((4, RENDER_CHUNK, RENDER_BINS), generator=gen, device=device)
    args = (object_field.tree_map(lambda x: x[sub], params), t_wo[sub], ext[sub], cen[sub],
            act[sub], origins, dirs_w, gen)
    kw = dict(n_bins=RENDER_BINS, max_hit_rays=RENDER_CHUNK, chunk=RENDER_CHUNK,
              max_deg=tc.max_deg)
    with fixed_jitter(u):
        got = renderer.render_frame_batched(*args, **kw)
        with plain_field_on_card():
            ref = renderer.render_frame_batched(*args, **kw)
    wk, wp = got["winner"], ref["winner"]
    either = int(((wk >= 0) | (wp >= 0)).sum())
    flips = int(((wk != wp) & ((wk >= 0) | (wp >= 0))).sum())
    same = (wk == wp) & (wk >= 0)
    d_err = float((got["depth"] - ref["depth"])[same].abs().max())
    c_err = float((got["color"] - ref["color"])[same].abs().max())
    log(f"[outputs] render chunk, 4 objects x {RENDER_CHUNK} rays x {RENDER_BINS} bins, K1 vs "
        f"plain on the card: {flips} of {either} covered pixels ({flips / max(either, 1):.2e}; "
        f"of all {n_px}: {flips / n_px:.2e}) change winner (limit {WINNER_FLIP_FRAC}); where "
        f"the winner agrees ({int(same.sum())}) depth max abs {d_err:.2e}, colour {c_err:.2e} "
        f"(limit {RENDER_ATOL})")
    if not (flips <= WINNER_FLIP_FRAC * max(either, 1) and d_err <= RENDER_ATOL
            and c_err <= RENDER_ATOL and int(same.sum()) > 0):
        raise AssertionError("K1's render chunk disagrees with the plain field")

    # one mesh, stage by stage
    box = reg.slots[slot].bbox3d
    scale, tf = meshing._box_frame(box, False)
    dim = meshing.adaptive_grid_dim(box, cfg.live_voxel_size, cfg.grid_dim)
    one = mapper.slot_params(slot)
    c0 = cen[0].cpu().numpy()
    t0 = time.perf_counter()
    occ_k = meshing.eval_grid_occupancy(one, scale, tf, c0, dim)
    t1 = time.perf_counter()
    native.marching_tetrahedra(occ_k, 0.5)
    t2 = time.perf_counter()
    mesh = meshing.mesh_object(one, box, c0, grid_dim=dim, with_color=True)
    torch.cuda.synchronize()
    if mesh is None:
        raise AssertionError(f"object {ids[0]} has no surface")
    t3 = time.perf_counter()
    mesh.export_obj(os.path.join(out, "breakdown.obj"))
    t4 = time.perf_counter()
    log(f"[outputs] one mesh (object {ids[0]}, grid {dim}^3): occupancy grid "
        f"{1e3 * (t1 - t0):.1f} ms ({-(-dim ** 3 // MESH_CHUNK)} K1 launches), native marching "
        f"{1e3 * (t2 - t1):.1f} ms, mesh_object whole {1e3 * (t3 - t2):.1f} ms, OBJ text "
        f"{1e3 * (t4 - t3):.1f} ms; {len(mesh.vertices)} vertices, {len(mesh.faces)} faces")

    # that occupancy grid through the plain field
    with plain_field_on_card():
        occ_p = meshing.eval_grid_occupancy(one, scale, tf, c0, dim)
    occ_err = float(np.abs(occ_k - occ_p).max())
    log(f"[outputs] object {ids[0]} occupancy grid {dim}^3, K1 vs plain on the card: max abs "
        f"{occ_err:.2e} (limit {OCC_ATOL}); {int((occ_k > 0.5).sum())} voxels inside")
    if not occ_err <= OCC_ATOL:
        raise AssertionError("K1's occupancy grid disagrees with the plain field")

    # K1 alone at the render and mesh shapes, on this mapper's weights
    del got, ref, occ_k, occ_p
    torch.cuda.empty_cache()
    rows = []
    n_r = RENDER_CHUNK * (RENDER_BINS - 1)
    w_fg = ff._pack_params(params, tc.hidden, False).contiguous()
    w_bg = ff._pack_params(object_field.tree_map(lambda x: x[None], mapper.state.bg_params),
                           tc.hidden_bg, False).contiguous()
    n_v = VIEW_CHUNK * (RENDER_BINS - 1)
    # (the view chunks and the grid chunks of a mesh: the full-size ones)
    for name, w, o, n, h in (
            ("render", w_fg, len(ids), n_r, tc.hidden),
            ("view_bg", w_bg, 1, n_v, tc.hidden_bg),
            ("view", w_fg[:1], 1, n_v, tc.hidden),
            ("mesh", w_fg[:1], 1, MESH_CHUNK, tc.hidden)):
        launches = by_shape.get(("fused_field_fwd", o, n, h), 0)
        if not launches:
            if name in ("render", "mesh"):
                raise AssertionError(f"K1 never launched at the {name} shape [{o},{n},{h}]")
            continue
        x = 0.5 * torch.randn((o, n, 3), generator=gen, device=device)
        rows.append(k1_shape_row(name, w, x, h, launches))
        del x
        torch.cuda.empty_cache()
    return rows, by_shape


# --------------------------------------------------------------------------- #
# phase 4c: quality on a scene with ground truth
# --------------------------------------------------------------------------- #


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def warm_matrices(device) -> None:
    """One call of each similarity matrix on a tiny input, so that the
    timed association holds no first-call set-up of the card's libraries."""
    from openobj_torch.perception import similarity

    box = np.asarray([[0.0, 0.0, 1.0, 1.0, 1.0, 2.0]] * 2)
    similarity.iou3d_matrix(box, device=device)
    similarity.cosine_matrix(np.eye(2, 4), device=device)
    similarity.projected_iou2d_matrix([np.ones((4, 4), np.float32)], np.eye(4)[None],
                                      2.0, 2.0, 2.0, 2.0, box, skip=2, device=device)


def closest_to_cut(weighted) -> float:
    """The smallest |weighted - 1.0| over all pairs (the graph's edge cut)."""
    w = np.asarray(weighted, np.float64)
    off = ~np.eye(len(w), dtype=bool)
    return float(np.abs(w[off] - 1.0).min()) if off.any() else float("inf")


def associate_twice(frames, bg_feats, acfg, device, tag):
    """``pipeline.associate`` on the card, timed (its similarity matrices
    under their own span), then the same call on the CPU: final ids and
    instance images must be equal, bit for bit."""
    import torch
    from openobj_torch.perception import pipeline
    from openobj_torch.utils import profiling

    span = "association: similarity matrices"
    warm_matrices(device)
    profiling.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    assoc = pipeline.associate(frames, bg_feats, acfg, device=device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    spans = profiling.stats()
    if spans.get(span, {}).get("n") != 1:
        raise AssertionError(f"associate timed no single '{span}' span: {spans}")
    card_ms = spans[span]["last_ms"]
    on_cpu = pipeline.associate(frames, bg_feats, acfg, device="cpu")
    if on_cpu["final_ids"] != assoc["final_ids"] or not all(
            np.array_equal(a, b) for a, b in zip(assoc["inst_images"], on_cpu["inst_images"])):
        raise AssertionError(f"[{tag}] association on the card differs from the CPU's: "
                             f"{assoc['final_ids']} vs {on_cpu['final_ids']}")
    gap = closest_to_cut(assoc["weighted"])
    log(f"[{tag}] association on the card: {assoc['n_objects'] - 4} objects, final ids "
        f"{assoc['final_ids']}; {1e3 * secs / len(frames):.1f} ms per association frame "
        f"({len(frames)} frames, {sum(len(f.masks) for f in frames)} masks, the card's "
        f"libraries warmed first), of which the similarity matrices on the card "
        f"{card_ms / len(frames):.1f}; equal on the CPU; "
        f"smallest |weighted - 1.0| over all pairs {gap:.3e}")
    return assoc, secs / len(frames), gap


def run_synthetic_scene(device) -> dict:
    """examples/run_synthetic_scene.py on the port: stage 1, the
    association, on the card (its instance images feed stage 2, remapped as
    the example does: the wall's reserved id 1 -> background 0, unlabelled
    -> -1), then stages 2-4 (training, a held-out render composited,
    meshes), on ``device``."""
    import tempfile

    import torch
    from openobj_torch import eval as oeval
    from openobj_torch import train
    from openobj_torch.core import meshing, renderer, trainer
    from openobj_torch.core.scene import Camera, SceneMapper
    from openobj_torch.data import synthetic
    from openobj_torch.ops import fused_field as ff
    from openobj_torch.perception import pipeline

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    cam = Camera(width=80, height=60, fx=50.0, fy=50.0, cx=40.0, cy=30.0)
    dirs = cam.ray_dirs("cpu").numpy()
    scene = synthetic.default_scene(n_spheres=2)
    torch.cuda.synchronize()
    ff.reset_counts()

    # ---- stage 1: the association over the sequence, on the card ----
    feats = {
        4: (_unit(rng.normal(size=384)), _unit(rng.normal(size=512)), "a red ball"),
        5: (_unit(rng.normal(size=384)), _unit(rng.normal(size=512)), "a blue ball"),
        0: (_unit(rng.normal(size=384)), _unit(rng.normal(size=512)), "a wall"),
    }
    views = [(synthetic.orbit_pose(a),) + scene.render(synthetic.orbit_pose(a), dirs)
             for a in np.linspace(-0.6, 0.6, 8)]
    frames = []
    for t_wc, rgb, depth, inst in views:
        masks, caps, capfts, clipfts = [], [], [], []
        for oid, (capft, clipft, cap) in feats.items():
            m = inst == oid
            if m.sum() < 30:
                continue
            masks.append(m)
            caps.append(cap)
            capfts.append(capft + rng.normal(size=384) * 0.01)
            clipfts.append(clipft + rng.normal(size=512) * 0.01)
        frames.append(pipeline.FrameInput(masks=masks, captions=caps, capfeats=capfts,
                                          clipfeats=clipfts, depth=depth, rgb=rgb, t_wc=t_wc))
    acfg = pipeline.AssociationConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                                      min_component_px=20, dbscan_min_points=10,
                                      dbscan_eps=0.2)
    assoc, assoc_s, gap = associate_twice(frames, {"wall": feats[0][0][None]}, acfg, device,
                                          "synthetic")

    # ---- stage 2: incremental mapping on the associated instances ----
    tcfg = trainer.TrainConfig(
        n_iters_per_frame=25, win_size=2, n_samples_per_frame=24,
        win_size_bg=2, n_samples_per_frame_bg=64, hidden=32, hidden_bg=64, clip_size=16)
    mapper = SceneMapper(cam, tcfg, frame_capacity=16, initial_bucket=4, device=device)
    for (t_wc, rgb, depth, _), inst_img in zip(views, assoc["inst_images"]):
        inst_m = np.where(inst_img == 1, 0, inst_img)
        inst_m = np.where(inst_img == 0, -1, inst_m)
        losses = mapper.process_frame(rgb, depth, inst_m.astype(np.int32), t_wc)
    mapper.finish()
    losses = losses.cpu().numpy()

    # held-out view: per-object renders composited by z-buffer
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out = tempfile.mkdtemp(prefix="synthetic_", dir=os.path.join(ROOT, "build"))
    train.save_checkpoints(mapper, out, t_wc)      # the objects' boxes from their keyframes
    t_eval = synthetic.orbit_pose(0.05)
    rgb_gt, depth_gt, inst_gt = scene.render(t_eval, dirs)
    gen = torch.Generator(device=mapper.device).manual_seed(5)
    views, class_of = {}, {}
    for inst_id, slot in mapper.registry.inst_to_slot.items():
        st = mapper.registry.slots[slot]
        if st.bbox3d is None:
            continue
        views[inst_id] = renderer.render_object_view(
            mapper.slot_params(slot), st.bbox3d, st.obj_center, t_eval, mapper.cam_dirs, gen,
            n_bins=96, chunk_size=1024)
        class_of[inst_id] = inst_id
    comp = renderer.composite_views(views, class_of, cam.height, cam.width)
    obj_mask = inst_gt > 0
    covered = comp["instid"] > 0
    hit = obj_mask & covered
    psnr = oeval.psnr(comp["rgb"] / 255.0, rgb_gt / 255.0, hit) if hit.any() else 0.0
    derr = oeval.depth_l1(comp["depth"], depth_gt, hit) if hit.any() else float("inf")
    iou = float(hit.sum() / max((obj_mask | covered).sum(), 1))

    n_meshes = 0
    for inst_id, slot in mapper.registry.inst_to_slot.items():
        st = mapper.registry.slots[slot]
        mesh = meshing.mesh_object(mapper.slot_params(slot), st.bbox3d, st.obj_center,
                                   grid_dim=48, with_color=True) if st.bbox3d is not None else None
        if mesh is not None:
            mesh.export_obj(os.path.join(out, f"obj_{inst_id}.obj"))
            n_meshes += 1
    torch.cuda.synchronize()
    counts = dict(ff.COUNTS)
    by_shape = dict(ff.COUNTS_BY_SHAPE)
    res = {"objects": mapper.n_objects, "loss_first": float(losses[0]),
           "loss_last": float(losses[-1]), "pixels": int(hit.sum()), "psnr": psnr,
           "depth_mae": derr, "iou": iou, "meshes": n_meshes, "counts": counts,
           "by_shape": by_shape, "assoc_ms_per_frame": 1e3 * assoc_s, "cut_gap": gap,
           "final_ids": assoc["final_ids"], "seconds": time.perf_counter() - t0}
    log(f"[synthetic] {res['objects']} objects + bg; last frame loss {res['loss_first']:.3f} "
        f"-> {res['loss_last']:.3f}; held-out object-pixel PSNR {psnr:.2f} dB, depth MAE "
        f"{derr:.4f} m, silhouette IoU {iou:.3f} over {res['pixels']} pixels; {n_meshes} "
        f"meshes; counts {counts} ({res['seconds']:.1f} s)")
    if not (res["pixels"] >= 100 and psnr > 18 and derr < 0.3 and n_meshes >= 1):
        raise AssertionError(f"synthetic scene below the example's gates: {res}")
    if counts["field_eager"] or counts["fused_field_plain"]:
        raise AssertionError(f"the synthetic scene left the kernels: {counts}")
    if counts["fused_field_bwd"] != counts["fused_field_bwd_reduce"]:
        raise AssertionError(f"K2 and its reduction launched unequally: {counts}")
    # hidden_bg 64: the tensor-core kernels, ff_fwd_kernel<64> and ff_bwd_kernel<64>
    if not ff.tensor_core_width(tcfg.hidden_bg):
        raise AssertionError(f"h={tcfg.hidden_bg} has no tensor-core K1/K2 in the library")
    for k in ("fused_field_fwd", "fused_field_bwd"):
        if not any(key[0] == k and key[3] == tcfg.hidden_bg for key in by_shape):
            raise AssertionError(f"{k} never launched at h={tcfg.hidden_bg}: {by_shape}")
    log(f"[synthetic] h={tcfg.hidden_bg} launches through "
        f"{ff.kernel_names(tcfg.hidden_bg)['fused_field_fwd']} / "
        f"{ff.kernel_names(tcfg.hidden_bg)['fused_field_bwd']}: "
        f"{sum(v for key, v in by_shape.items() if key[3] == tcfg.hidden_bg)}")
    return res


# --------------------------------------------------------------------------- #
# phase 4d: room_0 from disk
# --------------------------------------------------------------------------- #

# room_0's camera (configs/replica/room_0.json) and the cut of the sequence
ROOM0_CAM = dict(width=1200, height=680, fx=600.0, fy=600.0, cx=599.5, cy=339.5)
RAW_FRAMES, ASSOC_STRIDE = 30, 10


def run_room0_from_disk(device) -> dict:
    """A raw Replica-layout sequence on disk (synthetic archetype
    ``tabletop``: a table and three objects in a room, at room_0's camera),
    associated on the card into the artifacts the loader reads, then
    ``train.main`` on a copy of configs/replica/room_0.json whose only
    change is ``dataset.path``, in process, with the counts reset just
    before it and read just after. The temporary tree is removed
    afterwards."""
    import shutil
    import tempfile

    import torch
    from openobj_torch import config as oconfig
    from openobj_torch import eval as oeval
    from openobj_torch import train
    from openobj_torch.core.scene import Camera
    from openobj_torch.data import loaders, synthetic
    from openobj_torch.ops import fused_field as ff
    from openobj_torch.perception import merge, pipeline
    from openobj_torch.utils.png import read_png

    t_all = time.perf_counter()
    cam = Camera(**ROOM0_CAM)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="room0_disk_", dir=os.path.join(ROOT, "build"))
    try:
        root = os.path.join(tmp, "scene")
        scene, orbit = synthetic.archetype_scene("tabletop")
        t0 = time.perf_counter()
        gt_maps = synthetic.write_raw_scene(root, scene, cam.ray_dirs("cpu").numpy(),
                                            n_frames=RAW_FRAMES, orbit_kwargs=orbit,
                                            assoc_stride=ASSOC_STRIDE)
        write_s = time.perf_counter() - t0

        # ---- association on the card, from the raw frames on disk ----
        rng = np.random.default_rng(0)
        ids = sorted({int(i) for g in gt_maps for i in np.unique(g)})
        feats = {i: (_unit(rng.normal(size=384)), _unit(rng.normal(size=512)),
                     "a wall" if i == 0 else f"object {i}") for i in ids}
        poses = np.loadtxt(os.path.join(root, "traj_w_c.txt")).reshape(-1, 4, 4)
        frames = []
        for k, gt in enumerate(gt_maps):
            i = k * ASSOC_STRIDE
            masks, caps, capfts, clipfts = [], [], [], []
            for oid in ids:     # the room is the wall
                m = gt == oid
                if m.sum() < 100:
                    continue
                masks.append(m)
                caps.append(feats[oid][2])
                capfts.append(feats[oid][0] + rng.normal(size=384) * 0.01)
                clipfts.append(feats[oid][1] + rng.normal(size=512) * 0.01)
            frames.append(pipeline.FrameInput(
                masks=masks, captions=caps, capfeats=capfts, clipfeats=clipfts,
                depth=read_png(os.path.join(root, "depth", f"depth_{i}.png")).astype(
                    np.float32) * 1e-3,
                rgb=read_png(os.path.join(root, "rgb", f"rgb_{i}.png")), t_wc=poses[i]))
        acfg = pipeline.AssociationConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy)
        assoc, assoc_s, gap = associate_twice(frames, {"wall": feats[0][0][None]}, acfg,
                                              device, "room_0 disk")
        merge.write_artifacts(root, assoc["masks"], assoc["final_ids"], assoc["clipfeats"],
                              assoc["capfeats"], assoc["captions"], (cam.height, cam.width),
                              inst_images=assoc["inst_images"])
        written = [read_png(os.path.join(root, "instance_our", f"semantic_instance_{k}.png"))
                   for k in range(len(gt_maps))]
        score = oeval.matched_instance_miou([w.astype(np.int32) for w in written], gt_maps)

        # ---- the training command line on room_0.json, path changed ----
        with open(os.path.join(ROOT, "configs", "replica", "room_0.json")) as f:
            cfg = json.load(f)
        cfg["dataset"]["path"] = root
        cfg_path = os.path.join(tmp, "room_0.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f, indent=1)
        scfg = oconfig.load_scene_config(cfg_path)
        part = (cam.height // scfg.train.part_down, cam.width // scfg.train.part_down,
                scfg.train.clip_size)
        os.makedirs(os.path.join(root, "partlevel"), exist_ok=True)
        prng = np.random.default_rng(1)
        for i in range(0, RAW_FRAMES, scfg.stride):        # the frames that are read
            np.save(os.path.join(root, "partlevel", f"{i}.npy"),
                    prng.normal(size=part).astype(np.float32))
        dataset = loaders.make_dataset(scfg)
        load_ms, want_ckpts = [], {"0"}     # the background and every object loaded
        for i in range(len(dataset)):
            t0 = time.perf_counter()
            sample = dataset[i]
            load_ms.append(1e3 * (time.perf_counter() - t0))
            want_ckpts |= {str(k) for k in sample.bboxes}

        logdir = os.path.join(tmp, "logs")
        torch.cuda.synchronize()
        ff.reset_counts()
        t0 = time.perf_counter()
        mapper = train.main(["--config", cfg_path, "--logdir", logdir])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = dict(ff.COUNTS)
        by_shape = dict(ff.COUNTS_BY_SHAPE)
        ckpts = set(os.listdir(os.path.join(logdir, "ckpt")))
        with open(os.path.join(logdir, "timing.json")) as f:
            timing = json.load(f)
        trained = [timing[f"frame {i}"] for i in range(1, len(dataset))]
        losses = mapper.loss_history
        res = {"objects": mapper.n_objects, "ckpts": sorted(ckpts, key=int),
               "counts": counts, "by_shape": by_shape, "assoc_ms_per_frame": 1e3 * assoc_s,
               "load_ms_per_frame": float(np.mean(load_ms)),
               "train_ms_per_frame": float(np.mean(trained)), "losses": losses,
               "inst_miou": score["inst_miou"], "bg_iou": score["bg_iou"], "cut_gap": gap,
               "write_s": write_s, "train_s": train_s}
        log(f"[room_0 disk] {RAW_FRAMES} raw frames at {cam.height}x{cam.width} written in "
            f"{write_s:.1f} s; matched instance mIoU of the written maps against the ground "
            f"truth {score['inst_miou']:.4f} (background IoU {score['bg_iou']:.4f}; "
            f"{score['matches']}); ms per loaded frame {res['load_ms_per_frame']:.1f} "
            f"({[round(x, 1) for x in load_ms]}); train.main {train_s:.1f} s, ms per trained "
            f"frame (frames 2-{len(dataset)}, timing.json) {res['train_ms_per_frame']:.1f} "
            f"({trained}); {mapper.n_objects} objects + bg, checkpoints {res['ckpts']}; "
            f"last-step losses {[round(x, 4) for x in losses]}; counts {counts}")
        if not ckpts >= want_ckpts or mapper.n_objects < 1:
            raise AssertionError(f"checkpoints {sorted(ckpts)}, expected {sorted(want_ckpts)}")
        for name in ("scene_state.npz", "timing.json"):
            if not os.path.exists(os.path.join(logdir, name)):
                raise AssertionError(f"train.main wrote no {name}")
        if len(losses) != len(dataset) or not np.isfinite(losses).all():
            raise AssertionError(f"losses {losses} over {len(dataset)} frames")
        steps = 2 * scfg.train.n_iters_per_frame * len(dataset)   # fg + bg per step
        for k in ("fused_field_fwd", "fused_field_bwd", "fused_field_bwd_reduce"):
            if counts[k] != steps:
                raise AssertionError(f"{k} launched {counts[k]} times, expected {steps}")
        if counts["field_eager"] or counts["fused_field_plain"]:
            raise AssertionError(f"room_0 from disk left the kernels: {counts}")
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        log(f"[room_0 disk] phase 4d took {time.perf_counter() - t_all:.1f} s "
            "(temporary tree removed)")


# --------------------------------------------------------------------------- #
# phase 5: the probe kernels (K3, K4)
# --------------------------------------------------------------------------- #

def run_probe_path(device) -> list[dict]:
    """The probe scripts' port, driven through their entry points with the
    probe counts reset just before and read just after. Each section
    returns the cases it measured (kernel, plain version and library call
    timed once each with scan_time: CUDA graphs of 1 and N calls); each
    kernel's output from that run is then held against its plain version on
    the same inputs. Logs the scripts' answers."""
    import torch
    from openobj_torch.ops import probes
    from openobj_torch.scripts import bench_ensemble_mm as em
    from openobj_torch.scripts import bench_fused_step_probe as fs
    from openobj_torch.scripts._benchlib import bound_ms, rel_err

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    probes.reset_counts()
    k3, cases = em.run(device)
    answers = {}
    for name, section in fs.SECTIONS.items():
        answers[name], more = section(device)
        cases += more
    torch.cuda.synchronize()
    counts = dict(probes.COUNTS)

    for row in k3:
        log(f"[K3] {json.dumps(row)}")
    for name, ans in answers.items():
        log(f"[{name}] {json.dumps(ans)}")
    verdicts = {**answers["q4"], **{k: v for k, v in answers["q5"].items()
                                    if k.startswith("compile")}}
    bad = {k: v for k, v in verdicts.items() if v != "ok"}
    if bad:
        raise AssertionError(f"probe cases failed: {bad}")
    missing = [k for k in probes.kernel_names() if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"probe kernels never launched by the probe scripts: {missing}")
    if counts["probes_plain"] != 0:
        raise AssertionError(f"plain probe versions ran {counts['probes_plain']} times on the card")
    for key in probes.kernel_names():     # every launch belongs to exactly one case
        attributed = sum(c.launches for c in cases if c.key == key)
        if attributed != counts[key]:
            raise AssertionError(f"{key}: {counts[key]} launches, {attributed} in its cases")
    log(f"[probes] launches by the probe scripts (eager; graph replays not counted): {counts}")

    rows = []
    for case in cases:
        ref = case.plain()
        got = case.out if isinstance(case.out, tuple) else (case.out,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        rel = rel_err(got, ref)
        exact = all(torch.equal(a, b) for a, b in zip(got, ref))
        tol = case.tol
        if (tol is None and not exact) or (tol is not None and not rel <= tol):
            raise AssertionError(f"{case.name}: max|d| {err:.3e}, max|d|/max|ref| "
                                 f"{rel:.3e} (limit {'exact' if tol is None else tol})")
        b = bound_ms(case.flops, case.nbytes, case.mm_flops)
        simt = bound_ms(case.flops, case.nbytes)[0]
        lib = case.library_us
        rows.append({
            "name": case.name, "route": "cuda", "source": "openobj_torch/csrc/probes.cu",
            "replaces": case.site, "launches": case.launches, "max_abs_err": err,
            "ms": case.us / 1e3, "plain_ms": case.plain_us / 1e3, "bound_ms": b[0],
            "bound_by": b[1], "bound_simt_ms": simt,
            "library_ms": lib / 1e3 if lib is not None else None, "path": "probe scripts",
        })
        log(f"[probe] {case.name}: max|d| {err:.2e} rel {rel:.2e} "
            f"(limit {'exact' if tol is None else tol}); {case.us:.3f} us "
            f"(plain {case.plain_us:.3f}, library "
            f"{f'{lib:.3f}' if lib is not None else 'none'}, bound {1e3 * b[0]:.3f} {b[1]}, "
            f"SIMT-only {1e3 * simt:.3f}); "
            f"{case.launches} launches")
    log(f"[probes] phase 5 took {time.perf_counter() - t0:.1f} s")
    return rows


# --------------------------------------------------------------------------- #


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, profile one more frame")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from openobj_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: openobj_torch not found beside this script ({e})", file=sys.stderr)
        return 2

    # full FP32 everywhere: the plain versions are the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = kernels.build(verbose=True)
    log(f"[build] {secs} ({time.perf_counter() - t0:.1f} s)")

    per = check_kernels(device, (FG, BG) + OTHER_WIDTHS)
    check_convergence(device)
    check_steps_vs_cpu(device)
    by_shape_main, cfg, mapper, frames = run_main_path(device, profile=args.profile)
    k1_output_rows, by_shape_out = run_outputs(device, cfg, mapper, frames)
    del mapper, frames
    torch.cuda.empty_cache()
    syn = run_synthetic_scene(device)
    disk = run_room0_from_disk(device)
    # the synthetic scene's trained shapes at widths other than the main
    # path's (its bg field, h=64)
    other = sorted({(o, n, h) for (k, o, n, h) in syn["by_shape"]
                    if k == "fused_field_bwd" and h not in (FG["h"], BG["h"])})
    per_syn = check_kernels(device, [dict(name=f"synthetic_bg{h}", o=o, n=n, h=h)
                                     for o, n, h in other])
    probe_rows = run_probe_path(device)

    replaces = {
        "fused_field_fwd": "openobj_tpu/ops/fused_field.py:160",
        "fused_field_bwd": "openobj_tpu/ops/fused_field.py:172",
        "fused_field_bwd_reduce": "openobj_tpu/ops/fused_field.py:285",
    }
    # launches as counted in each run, by (count, O, N, h)
    paths = {"room_0 training": by_shape_main, "room_0 outputs": by_shape_out,
             "synthetic scene": syn["by_shape"], "room_0 from disk": disk["by_shape"]}

    def launches_at(name, dims):
        return sum(bs.get((name, *dims), 0) for bs in paths.values())

    rows = []
    for name, every in per.items():
        shapes = [s for s in every if s["shape"] in (FG["name"], BG["name"])]
        b = [s["bound"] for s in shapes]
        timed = [{"shape": s["shape"], "kernel": s["kernel"], "dims": s["dims"],
                  "launches": launches_at(name, s["dims"]), "max_abs_err": s["err"],
                  "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound"][0],
                  "bound_by": s["bound"][1], "bound_simt_ms": s["bound_simt"],
                  "library_ms": s["library_ms"]}
                 for s in every + per_syn[name]]
        if name == "fused_field_fwd":
            timed += k1_output_rows
        by_path = {p: sum(v for k, v in bs.items() if k[0] == name) for p, bs in paths.items()}
        rows.append({
            "name": name, "route": "cuda", "source": "openobj_torch/csrc/fused_field.cu",
            "replaces": replaces[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(s["max_abs_err"] for s in timed),
            # one room_0 training step launches each kernel once at each shape
            "ms": sum(s["ms"] for s in shapes),
            "plain_ms": sum(s["plain_ms"] for s in shapes),
            "bound_ms": sum(x[0] for x in b),
            "bound_by": max(b)[1],     # that of the larger per-shape bound
            "bound_simt_ms": sum(s["bound_simt"] for s in shapes),
            "library_ms": (sum(s["library_ms"] for s in shapes)
                           if shapes[0]["library_ms"] is not None else None),
            # every kernel instance run (each tensor-core width, the SIMT kernels)
            "instances": sorted({s["kernel"] for s in timed}, key=lambda k: (len(k), k)),
            # timed shapes, each with the launches counted at exactly its dims
            "per_shape": timed,
            # every shape launched: [O, N, h, launches] by run
            "launch_shapes": {p: [[*k[1:], v] for k, v in sorted(bs.items()) if k[0] == name]
                              for p, bs in paths.items()},
        })
    rows += probe_rows
    log(f"[time] chip_smoke.py {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
