#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (openobj_torch) on one NVIDIA GPU.

Run from the root of a checkout:   python3 chip_smoke.py

It builds the CUDA kernels from openobj_torch/csrc with nvcc (sm_90a), then:
  1. prints the card and its power limit, and the build time;
  2. holds every kernel against its plain PyTorch version at the shapes of
     the main path (fg 64 objects x 1200 points, h=32; bg 1 x 16800, h=128;
     clip head on) and times kernel, plain version and bound;
  3. runs the port of examples/synthetic_convergence.py through the kernels
     and a few training steps on the card against the same steps on the CPU;
  4. drives the main path: SceneMapper.process_frame at the Replica room_0
     envelope (configs/replica/room_0.json, 680x1200 frames, 50 objects +
     background, 512-d part features) for 3 frames, with the launch counts
     reset just before and read just after;
  5. the probe kernels (csrc/probes.cu, ports of the Pallas kernels of
     scripts/bench_ensemble_mm.py and scripts/bench_fused_step_probe.py):
     drives the two probe scripts' port (openobj_torch.scripts.*) with the
     probe counts reset just before and read just after, logs their
     answers, and holds each kernel's output from that run against its
     plain version, beside the times the scripts took of kernel, plain
     version and library call, and the bound;
  6. prints one JSON line with every kernel's numbers, the card's
     nvidia-smi line, and last a JSON line {"ok": true, "device": ...}.

Each phase raises on failure; the script then exits non-zero and prints no
result line. Without a CUDA device, or without the repository beside it, it
exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, dense
# TF32 on the tensor cores, HBM3
PEAK_F32 = 67e12
PEAK_TF32 = 494.7e12
PEAK_BYTES = 3.35e12

# main-path shapes at the room_0 envelope
FG = dict(name="fg", o=64, n=1200, h=32)      # 64-slot bucket x 120 rays x 10 samples
BG = dict(name="bg", o=1, n=16800, h=128)     # 1200 rays x 14 samples

FWD_ATOL = 1e-4
GRAD_RTOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------- #
# bounds: the work of one call at these shapes
# --------------------------------------------------------------------------- #


def fwd_mm_macs(h: int) -> int:
    """Multiply-adds per point of the forward's matrix products (the trunk
    and the two e2-fed heads, N = h)."""
    return 87 * h + h * h + (h + 87) * h + h * h + 2 * (h + 42) * h


def fwd_macs(h: int) -> int:
    """Multiply-adds per point of the field forward (clip head on): the
    matrix products, the projection, the alpha and colour heads."""
    return 21 * 3 + fwd_mm_macs(h) + h + 3 * h


def bwd_macs(h: int) -> int:
    """Per point: the recomputed forward, the weight gradients (one MAC per
    weight), the input gradients of every layer, and the PE backward."""
    dx = 3 * h + h + 2 * h * h + 2 * 42 * h + h * h + (h + 87) * h + h * h + 87 * h
    return fwd_macs(h) + fwd_macs(h) + dx + 6 * 21


def bwd_mm_macs(h: int) -> int:
    """The backward's matrix products: the recomputed forward's, the weight
    gradients X^T dY and the input gradients dY W^T, each as many
    multiply-adds as the forward's products."""
    return 3 * fwd_mm_macs(h)


def bound_ms(flops: float, nbytes: float, mm_flops: float = 0.0) -> tuple[float, str]:
    """Least time (ms) for ``flops`` FP32-accurate operations moving
    ``nbytes``, and what bounds it. The ``mm_flops`` of them that are matrix
    products may run on the tensor cores in 3xTF32 (three TF32 products for
    one FP32-accurate one); the rest run at the FP32 rate. The two kinds of
    unit may overlap, so the operations take the longer of the two times.
    With mm_flops = 0 this is the SIMT-only bound."""
    t_ops = max(3.0 * mm_flops / PEAK_TF32, (flops - mm_flops) / PEAK_F32)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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


def check_kernels(device) -> dict:
    import torch
    from openobj_torch.models import object_field
    from openobj_torch.ops import fused_field as ff

    per = {"fused_field_fwd": [], "fused_field_bwd": [], "fused_field_bwd_reduce": []}
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    for shape in (FG, BG):
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

        # the reduction on its own, against torch.sum over the tile axis
        p = lib.ff_param_count(h)
        tile, n_tiles = ff.bwd_tiling(lib, o, n, h, device)
        part = torch.randn((o, n_tiles, p), generator=gen, device=device)
        red = torch.empty((o, p), device=device)

        def reduce_k():
            err = lib.ff_reduce(part.data_ptr(), red.data_ptr(), o, n_tiles, p,
                                ff._stream(part))
            if err:
                raise RuntimeError(f"ff_reduce: CUDA error {err}")

        reduce_k()
        red_ref = part.sum(dim=1)
        torch.cuda.synchronize()
        red_err = float((red - red_ref).abs().max())
        if not red_err <= 1e-4:
            raise AssertionError(f"reduction {shape['name']}: max abs err {red_err:.3e}")

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
        t_sum = time_ms(lambda: part.sum(dim=1))

        npts = o * n
        wbytes = o * p * 4
        fwd_bytes = npts * 12 + wbytes + npts * 4 * (1 + 3 + h)
        bwd_bytes = npts * 12 + wbytes + npts * 4 * (1 + 3 + h) + wbytes
        b_fwd = bound_ms(2.0 * fwd_macs(h) * npts, fwd_bytes, 2.0 * fwd_mm_macs(h) * npts)
        b_bwd = bound_ms(2.0 * bwd_macs(h) * npts, bwd_bytes, 2.0 * bwd_mm_macs(h) * npts)
        simt_fwd = bound_ms(2.0 * fwd_macs(h) * npts, fwd_bytes)[0]
        simt_bwd = bound_ms(2.0 * bwd_macs(h) * npts, bwd_bytes)[0]
        b_red = bound_ms(float(o * n_tiles * p), 4.0 * o * n_tiles * p + wbytes)
        per["fused_field_fwd"].append(dict(
            shape=shape["name"], ms=t_fwd, plain_ms=t_fwd_plain, bound=b_fwd,
            bound_simt=simt_fwd, err=fwd_err, library_ms=None))
        per["fused_field_bwd"].append(dict(
            shape=shape["name"], ms=t_bwd, plain_ms=t_bwd_plain, bound=b_bwd,
            bound_simt=simt_bwd, err=bwd_err, rel=worst, library_ms=None))
        per["fused_field_bwd_reduce"].append(dict(
            shape=shape["name"], ms=t_red, plain_ms=t_sum, bound=b_red,
            bound_simt=b_red[0], err=red_err, library_ms=t_sum, tiles=n_tiles))
        log(f"[kernels] {shape['name']} O={o} N={n} h={h}: "
            f"K1 err {fwd_err:.2e} {t_fwd:.4f} ms (plain {t_fwd_plain:.4f}, bound {b_fwd[0]:.4f} "
            f"{b_fwd[1]}, SIMT-only {simt_fwd:.4f}) | "
            f"K2 err {bwd_err:.2e} worst-leaf rel {worst:.2e} {t_bwd:.4f} ms tile {tile} "
            f"(plain bwd {t_bwd_plain:.4f}, bound {b_bwd[0]:.4f} {b_bwd[1]}, "
            f"SIMT-only {simt_bwd:.4f}) | "
            f"reduce {n_tiles} tiles err {red_err:.2e} {t_red:.4f} ms "
            f"(torch.sum {t_sum:.4f}, bound {b_red[0]:.4f} {b_red[1]})")
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


def run_main_path(device, profile: bool = False) -> dict:
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
    if mapper.state.n_slots != FG["o"] or mapper.n_objects != 50:
        raise AssertionError(f"bucket {mapper.state.n_slots} / objects {mapper.n_objects}")
    log(f"[main] room_0 envelope, {cam.height}x{cam.width}, {mapper.n_objects} objects "
        f"in a {mapper.state.n_slots}-slot bucket + bg: frame times "
        f"{[round(t * 1e3, 1) for t in times]} ms (first includes warm-up); "
        f"last-step losses {[round(float(v[-1]), 4) for v in vecs]}; counts {counts}")
    log(f"[main] ms/frame (frames 2-3): {1e3 * float(np.mean(times[1:])):.1f}")
    return counts


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
    from openobj_torch.scripts._benchlib import rel_err

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

    per = check_kernels(device)
    check_convergence(device)
    check_steps_vs_cpu(device)
    counts = run_main_path(device, profile=args.profile)
    probe_rows = run_probe_path(device)

    replaces = {
        "fused_field_fwd": "openobj_tpu/ops/fused_field.py:160",
        "fused_field_bwd": "openobj_tpu/ops/fused_field.py:172",
        "fused_field_bwd_reduce": "openobj_tpu/ops/fused_field.py:285",
    }
    rows = []
    for name, shapes in per.items():
        b = [s["bound"] for s in shapes]
        rows.append({
            "name": name, "route": "cuda", "source": "openobj_torch/csrc/fused_field.cu",
            "replaces": replaces[name], "launches": counts[name],
            "max_abs_err": max(s["err"] for s in shapes),
            # one training step launches each kernel once at each shape
            "ms": sum(s["ms"] for s in shapes),
            "plain_ms": sum(s["plain_ms"] for s in shapes),
            "bound_ms": sum(x[0] for x in b),
            "bound_by": max(b)[1],     # that of the larger per-shape bound
            "bound_simt_ms": sum(s["bound_simt"] for s in shapes),
            "library_ms": (sum(s["library_ms"] for s in shapes)
                           if shapes[0]["library_ms"] is not None else None),
            "per_shape": [{"shape": s["shape"], "ms": s["ms"], "plain_ms": s["plain_ms"],
                           "bound_ms": s["bound"][0], "bound_by": s["bound"][1],
                           "bound_simt_ms": s["bound_simt"]}
                          for s in shapes],
        })
    rows += probe_rows
    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
