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
     and K1/K2 bf16 (csrc/fused_field_bf16.cu; K1 bf16 is ff_fwd_bf16_kernel,
     K2 bf16 is ff_bwd_bf16_kernel behind its weight conversion
     ff_bf16_image_kernel) against the plain version in bf16 at fg and bg
     (ff.bf16_output_errors for K1, BF16_RATIO per leaf for K2, the
     conversion bit for bit), timed with their bounds (K1's beside its
     encode's own floor) and K1 bf16's launch, and K2r over the bf16
     library's slots; and the flat AdamW kernel (csrc/adamw_flat.cu) against
     its plain version on the room_0 fg and bg trees with some slots frozen
     (ADAMW_RTOL per leaf), timed beside its byte bound, the plain flat
     version, the per-leaf tree update and torch._fused_adamw_;
  3. runs the port of examples/synthetic_convergence.py through the kernels
     and a few training steps on the card against the same steps on the CPU;
  4. drives the main path: SceneMapper.process_frame at the Replica room_0
     envelope (configs/replica/room_0.json, 680x1200 frames, 50 objects +
     background, 512-d part features) for 3 frames, with the launch counts
     reset just before and read just after; then, from that state, one
     frame with the per-leaf update and one with trainer.optim_impl "flat"
     (counts reset around it: the flat AdamW kernel 200 times, once a model
     a step), whose step losses must match the tree frame's
     (FLAT_FRAME_RTOL);
  4b. the map's outputs of that mapper at full width, with the counts reset
     just before and read just after: train.save_checkpoints (one object
     and the background reloaded, field outputs bit-identical),
     train.render_dataset of one pose (680x1200, 150 bins, chunks of 2048)
     and train.export_meshes of MESH_OBJECTS objects (the config's grid
     128, voxel 0.005): K1 must
     carry every field evaluation, as many launches as the code implies,
     with no K2, plain or eager call. Then, outside the counted run, one
     chunk of 4 objects rendered through K1 and through the plain field on
     the card with the same jitter, one object's occupancy grid likewise,
     one mesh timed stage by stage, and K1 against its plain version at
     the render and mesh shapes (K1's rows of the kernels line gain those
     shapes, each with the launches counted at exactly its dims);
  4h. room_0 at bf16: phase 4's frames through a mapper whose config has
     compute_dtype "bf16" (room_0.json otherwise as published), counts reset
     before and read after: K1/K2 bf16, K2 bf16's weight conversion and K2r
     200 times per trained frame,
     nothing f32, plain or eager; ms per frame; the losses beside phase 4's;
     a few steps on the card against the same steps on the CPU at bf16
     (STEP_RTOL_BF16); one render chunk of 4 objects through K1 bf16 against
     the plain version in bf16 (on the boxes phase 4b fitted); one frame
     each with z_per_step and sample_per_step through the kernels (finite
     losses, launch counts);
  4i. room_0 sharded: from phase 4's mapper (its state, tables and frame
     store) one frame trained unsharded and one through
     parallel.sharding.shard_scene and train_frame inside use_mesh, on a
     mesh of the one card ("object" of size 1; NCCL as a group of one), the
     same start state and generator seed, counts reset around the sharded
     frame: K1/K2/K2r 200 times at the room_0 shapes and nothing plain or
     eager, losses equal to the unsharded frame's bit for bit (on a mesh of
     one; within SHARDED_RTOL on more ranks), ms per frame of each; then
     save_scene_sharded (a DCP directory) and load_scene_sharded into a
     fresh mapper sharded on the same mesh: every leaf bit-identical, the
     registry equal; prints ms per sharded frame, the largest relative loss
     difference, the snapshot's seconds and bytes. Then the mapper on that
     mesh: a fresh mapper of phase 4's config and seed, its state cut by
     shard_scene at bucket 8, runs phase 4's frames through process_frame
     inside use_mesh, counts reset around them: the bucket grows 8 -> 64
     inside the mesh, the loss vectors equal phase 4's bit for bit, K1/K2/K2r
     only; save_scene under the mesh and load_scene into a fresh sharded
     mapper, every leaf bit-identical (bytes and seconds printed); and
     render_frame_batched of its trained state, inside the mesh and outside
     it with one seed, over a band of one 680x1200 pose's rays on the boxes
     phase 4b fitted: winner and n_hit equal, depth and colour bit-equal,
     K1's launches counted at their shapes;
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
     tabletop, 30 frames at room_0's camera, 680x1200) written once with
     data.synthetic.write_raw_scene (phases 4d and 4e read it); masks from
     its held-aside ground-truth maps associated on the card (and on the
     CPU: equal) and written as the loader's artifacts; random
     [136, 240, 512] part maps; then train.main on
     configs/replica/room_0.json with only dataset.path changed, in
     process, with the counts reset before and read after: checkpoints for
     the background and every object, scene_state.npz and timing.json,
     finite losses, K1/K2/K2r 200 times per trained frame and nothing plain
     or eager; prints ms per association frame, per loaded frame and per
     trained frame, and the matched instance mIoU of the written maps
     against the ground truth;
  4e. room_0 auto perception: the same raw frames alone (a fresh root with
     rgb/, depth/ and traj_w_c.txt) through
     perception.auto.run_auto_perception on the card with room_0.json's
     settings (part mode on; 15 keyframes at skip 2): weights-free
     segmentation, captions and descriptors, association, part maps painted
     on the card; gates: mask_init_all.pkl with every keyframe and its five
     fields, instance_our/ and class_our/ per keyframe, object_*.pkl, a
     float32 [136, 240, 512] part map for every trained frame, and frame
     0's part map painted on the card equal to numpy's painting (and to the
     written map) bit for bit; then train.main on those artifacts with 4d's
     gates; prints ms per keyframe of maskgen, association (and its
     similarity matrices) and partfeat (and its painting), the painting
     alone, masks per keyframe, the matched instance mIoU at frames 0, 10,
     20 against the ground truth, and 4d's training numbers;
  4f. room_0 export and query, on 4e's checkpoint tree (background h=128,
     objects h=32, 512-d clip head): perception.class_features.main on the
     replica vocabulary (read back by train.load_class_features), the
     replica class table written and read back by ClassColorMap.from_yaml
     without PyYAML, interop.convert_checkpoint_dir (host work) to a
     reference .pth tree and back (every param, box and feature
     bit-identical); then, with the counts reset before and read after
     each, viz.export._main on the .pth tree at grid 128 and
     export_from_checkpoints on the npz tree: bundles equal bit for bit,
     K1 carrying every field evaluation (as many launches
     as the code implies, nothing else); one object's vertex part features
     through K1 against the plain field on the card; viewer.main with
     --query, --part-query, --class-colors replica and --ply-dir (the HTML
     holds viewer_math's JS, a PLY per object); the query server on
     127.0.0.1 (a free port): GET /, /objects and 18 /query requests equal
     to the direct calls, object colourings equal to bake_object_query's;
     prints ms per exported object by stage (utils.profiling spans), K1's
     launches and shapes, the bundle's bytes, write and load times, ms per
     converted checkpoint, the HTML's bytes and the median ms per HTTP query;
  4g. a ScanNet scan on disk: 4d's first 21 raw frames laid out as ScanNet's
     scene0011_01 (colour resized to 968x1296 and written as baseline 4:2:0
     q95 JPEGs by this script's numpy encoder, each decoded by the port and
     gated > 35 dB against its source; depth resized nearest to 480x640; the
     depth camera's intrinsics; the ground-truth maps held aside); the
     committed JPEG fixtures (tests/data/jpeg/: baseline, progressive,
     arithmetic-coded, lossless, smoothed, rotated, CMYK, YCCK) decoded and
     the PNG fixtures (tests/data/png/: palette, low-bit grey, Adam7, tRNS,
     16-bit) read equal to their digests of OpenCV's decode; then
     scripts.run_scenes on an unedited copy
     of configs/scannet/scene0011_01.json with --perception auto,
     --max-frames 3, --device cuda and --distributed as a group of one
     (NCCL's init and a barrier on the card), counts reset around it: auto
     perception from the JPEG and PNG frames, train.main (K1/K2/K2r 600
     each, nothing plain or eager), the export (K1 only, as many launches as
     the code implies), summary.json; multislice.run_parallel on one device
     group (the worker's current card); the matched instance mIoU at frames
     0, 10, 20 within 0.02 of the CPU rehearsal's (rehearse_scannet); prints
     ms per decoded JPEG (entropy decode and the rest: baseline, progressive,
     arithmetic-coded sequential and progressive), per loaded and per
     trained frame, per keyframe of each perception stage, the export's and
     the phase's seconds;
  5. the probe kernels (csrc/probes.cu, ports of the Pallas kernels of
     scripts/bench_ensemble_mm.py and scripts/bench_fused_step_probe.py):
     drives the two probe scripts' port (openobj_torch.scripts.*) with the
     probe counts reset just before and read just after, logs their
     answers, and holds each kernel's output from that run against its
     plain version, beside the times the scripts took of kernel, plain
     version and library call, and the bound;
  6. prints one JSON line with every kernel's numbers (the fused field's
     launches summed over the counted runs of phases 4 to 4h, and by
     run and shape as counted; K1/K2 bf16 as rows of their own), each
     phase's seconds, the card's nvidia-smi line, and last a JSON line
     {"ok": true, "device": ...}.

Each phase raises on failure; the script then exits non-zero and prints no
result line. Without a CUDA device, or without the repository beside it, it
exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
# bf16 (phase 2's K1/K2 bf16 and phase 4h): the bf16 kernels against the
# plain version in bf16. K1's outputs by ff.bf16_output_errors over every
# entry: at most ff.BF16_OFF_FRAC of them off by more than FWD_ATOL, none
# further off than the plain bf16 is from the plain f32, all finite, and
# the plain f32 in the kernel's place must fail the share. 4h's render
# chunk likewise on depth and colour, at FWD_ATOL too (at RENDER_ATOL the
# plain f32 would pass: 0.4% of its depths are off by more). K2: each
# gradient leaf's max|d|/max|ref| within BF16_RATIO of that leaf's
# bf16-vs-f32 distance (at most GRAD_RTOL)
BF16_RATIO = 0.1
# card-vs-CPU step losses at bf16 (the f32 gate is 1e-4)
STEP_RTOL_BF16 = 1e-3
# phase 4i: the sharded frame's losses against the unsharded frame's on a
# mesh of more than one rank (the CPU tests' tolerance for 2 and 4 ranks,
# tests/test_torch_sharding.py); on a mesh of one they are equal
SHARDED_RTOL = 2e-5
# the flat AdamW kernel (csrc/adamw_flat.cu) against its plain version, per
# leaf max|d|/max|ref| (powf's last bit against torch.pow), and phase 4's
# flat frame's step losses against a tree-update frame from the same state
ADAMW_RTOL = 1e-6
FLAT_FRAME_RTOL = 1e-5
# slots of the room_0 bucket frozen in phase 2's flat AdamW check: the 14
# empty slots of 50 objects in 64, and two of the objects' own
ADAMW_FROZEN = (3, 17, *range(50, 64))
SHARDED_BAND = 64           # rows of the pose phase 4i renders inside and outside the mesh
# phase 4b meshes this many objects (and keeps its one-mesh breakdown)
MESH_OBJECTS = 4
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


def _device_us(e) -> float:
    """A profiler event's own device time in microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def traced_ms(fn, kernel: str, iters: int = 20) -> float:
    """The mean device time (ms) of one launch of ``kernel`` (part of its
    name), one of the kernels each call of ``fn`` launches once, from a
    torch.profiler trace of ``iters`` calls behind as many untraced ones
    (the profiler's warm-up step); fails where the trace holds none of its
    launches, more than ``iters``, or no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        prof.step()   # the traced calls: the profiler keeps this step's events
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
    n, us = sum(e.count for e in rows), sum(_device_us(e) for e in rows)
    if not 0 < n <= iters or not us > 0:
        raise RuntimeError(f"trace of {kernel}: {n} launches of {iters}, {us} us")
    if n < iters:
        log(f"[trace] {kernel}: {n} of {iters} launches in the trace")
    return us / n / 1e3


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
            bound_simt=simt_fwd, encode_floor=fb["fwd_encode"][0], err=fwd_err, library_ms=None))
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
            f"{b_fwd[1]}, SIMT-only {simt_fwd:.4f}, encode floor {fb['fwd_encode'][0]:.4f}) | "
            f"K2 err {bwd_err:.2e} worst-leaf rel {worst:.2e} {t_bwd:.4f} ms tile {tile} "
            f"(plain bwd {t_bwd_plain:.4f}, bound {b_bwd[0]:.4f} {b_bwd[1]}, "
            f"SIMT-only {simt_bwd:.4f}) | "
            f"reduce {n_tiles} tiles err {red_err:.2e} {t_red:.4f} ms (plain, in tile order, "
            f"{t_red_plain:.4f}; torch.sum {t_sum:.4f}, bound {b_red[0]:.4f} {b_red[1]})")
        del params, wflat, pts, da, dc, dh, part, red, obj, w_req
    return per


def bf16_leaf_limit(dist: float) -> float:
    """A gradient leaf's bf16 gate: a tenth of the plain version's own
    bf16-vs-f32 distance there, at most GRAD_RTOL (GRAD_RTOL where bf16
    does not move the leaf: b_alpha)."""
    return min(GRAD_RTOL, BF16_RATIO * dist) if dist > 0 else GRAD_RTOL


def bf16_shown(errs: dict) -> str:
    """ff.bf16_output_errors of several outputs, for the log."""
    return ", ".join(f"{k} off {e['off']:.2e} (plain f32 {e['control_off']:.2e}) max abs "
                     f"{e['max_abs']:.2e} (bf16-vs-f32 {e['bf16_max']:.2e})"
                     for k, e in errs.items())


def check_kernels_bf16(device, shapes) -> dict:
    """K1 and K2 of csrc/fused_field_bf16.cu against the plain version in
    bf16 at each shape (K1 by ff.bf16_output_errors, K2 by BF16_RATIO per
    leaf), and their times: kernel, plain version, bound with bf16 products
    at the dense bf16 rate (K1's beside its encode's floor, which the bound
    does not count). K1 bf16 converts its weights to bf16 inside its own
    blocks (no launch of its own); its launch (blocks resident an SM, tile)
    is logged. K2 bf16 (ff_backward) launches the weight
    conversion ff_bf16_image_kernel first, and its time holds both; the
    images it leaves in the scratch are held to their plain version
    (ff.bf16_weight_image, bit for bit), the conversion's own time is read
    from a trace of K2 bf16's launches, and K2r is timed over the bf16
    library's slots ("reduce_bf16")."""
    import torch
    from openobj_torch.models import object_field
    from openobj_torch.ops import fused_field as ff
    from openobj_torch.scripts._benchlib import bound_ms, field_bounds

    per = {"fused_field_fwd_bf16": [], "fused_field_bwd_bf16": [],
           "fused_field_bwd_bf16_image": [], "reduce_bf16": []}
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    lib = ff._lib("fused_field_bf16")
    for shape in shapes:
        o, n, h = shape["o"], shape["n"], shape["h"]
        params = object_field.init_stacked_fields(
            gen, o, hidden=h, clip_size=512, scale=2.0, device=device)
        params = object_field.tree_map(
            lambda x: x + 0.05 * torch.randn(x.shape, generator=gen, device=device), params)
        wflat = ff._pack_params(params, h, True).contiguous()
        pts = (0.5 * torch.randn((o, n, 3), generator=gen, device=device)).contiguous()
        cts = [torch.randn((o, n, k), generator=gen, device=device) for k in (1, 3, h)]

        outs_k = ff.fused_field_forward_cuda(wflat, pts, h, True, "bf16")
        g_k = ff.fused_field_backward_cuda(wflat, pts, *cts, h, True, "bf16")
        plain, w_req = {}, {}
        for cd in ("bf16", "f32"):
            w_req[cd] = wflat.detach().requires_grad_(True)
            outs = ff.fused_field_plain(w_req[cd], pts, h, True, cd)
            plain[cd + "_obj"] = sum((x * c).sum() for x, c in zip(outs, cts))
            plain[cd] = [x.detach() for x in outs]
            (plain[cd + "_grad"],) = torch.autograd.grad(plain[cd + "_obj"], w_req[cd],
                                                         retain_graph=True)
        torch.cuda.synchronize()
        errs = {name: ff.bf16_output_errors(xk, xp, x32, FWD_ATOL)
                for name, xk, xp, x32 in zip(("alpha", "color", "hclip"), outs_k,
                                             plain["bf16"], plain["f32"])}
        fwd_err = max(e["max_abs"] for e in errs.values())
        dev = ff.leaf_errors(g_k, plain["bf16_grad"], h)
        dist = ff.leaf_errors(plain["bf16_grad"], plain["f32_grad"], h)
        worst = max(dev, key=lambda k: dev[k] / bf16_leaf_limit(dist[k]))
        log(f"[kernels bf16] {shape['name']} K1 vs plain bf16: {bf16_shown(errs)}")
        bad = [k for k, e in errs.items() if not e["ok"]]
        bad += [k for k in dev if not dev[k] <= bf16_leaf_limit(dist[k])]
        if bad:
            raise AssertionError(f"K1/K2 bf16 {shape['name']}: {bad} outside the gates: "
                                 f"outputs {errs}; leaves {dev} against bf16-vs-f32 {dist}")

        def fwd_k():
            err = lib.ff_forward(pts.data_ptr(), wflat.data_ptr(), a_t.data_ptr(),
                                 c_t.data_ptr(), f_t.data_ptr(), o, n, h, 1, ff._stream(pts))
            if err:
                raise RuntimeError(f"ff_forward (bf16): CUDA error {err}")

        tile, n_tiles = ff.bwd_tiling(lib, o, n, h, device)
        p = lib.ff_param_count(h)
        buf, part = ff.bwd_scratch(lib, o, n_tiles, h, device)

        def bwd_k():
            err = lib.ff_backward(pts.data_ptr(), wflat.data_ptr(), cts[0].data_ptr(),
                                  cts[1].data_ptr(), cts[2].data_ptr(), buf.data_ptr(),
                                  o, n, h, 1, tile, ff._stream(pts))
            if err:
                raise RuntimeError(f"ff_backward (bf16): CUDA error {err}")

        # the weight conversion, ff_backward's first launch: the images it
        # leaves after the slots against their plain version bit for bit
        img_ref = ff.bf16_weight_image(wflat, h)
        bwd_k()
        torch.cuda.synchronize()
        if not torch.equal(ff.bwd_image(buf, o, n_tiles, h).view(torch.int16),
                           img_ref.view(torch.int16)):
            raise AssertionError(f"ff_bf16_image_kernel {shape['name']}: not the plain bf16 image")
        t_img = traced_ms(bwd_k, "ff_bf16_image_kernel")
        t_img_plain = time_ms(lambda: ff.bf16_weight_image(wflat, h))
        # it reads the six weight matrices (w_in, w_mid1, w_cat, w_mid2, w_col,
        # w_clip: 5h^2 + 258h floats an object) and writes the padded images
        b_img = bound_ms(0.0, 4.0 * o * (5 * h * h + 258 * h) + 2.0 * img_ref.numel())
        per["fused_field_bwd_bf16_image"].append(dict(
            shape=shape["name"], dims=[o, n, h], library_ms=None,
            kernel=ff.kernel_names(h, "bf16")["fused_field_bwd_bf16_image"], ms=t_img,
            plain_ms=t_img_plain, bound=b_img, bound_simt=b_img[0], err=0.0))

        # K2r over the bf16 library's slots (its chunk and tiling), in tile order
        red = torch.empty((o, p), device=device)

        def reduce_k():
            err = lib.ff_reduce(part.data_ptr(), red.data_ptr(), o, n_tiles, p, ff._stream(pts))
            if err:
                raise RuntimeError(f"ff_reduce (bf16 library): CUDA error {err}")

        def reduce_plain():
            acc = part[:, 0].clone()
            for t in range(1, n_tiles):
                acc += part[:, t]
            return acc

        a_t, c_t, f_t = (torch.empty_like(x) for x in outs_k)
        t_fwd = time_ms(fwd_k)
        with torch.no_grad():
            t_fwd_plain = time_ms(lambda: ff.fused_field_plain(wflat, pts, h, True, "bf16"))
        t_bwd = time_ms(bwd_k)
        bwd_k()
        reduce_k()
        red_ref = reduce_plain()
        torch.cuda.synchronize()
        if not torch.equal(red, red_ref):
            raise AssertionError(f"reduction (bf16 library) {shape['name']}: not the sum in "
                                 "tile order")
        t_red = time_ms(reduce_k)
        t_red_plain = time_ms(reduce_plain)
        t_sum = time_ms(lambda: part.sum(dim=1))
        b_red = bound_ms(float(o * n_tiles * p), 4.0 * o * n_tiles * p + o * p * 4)
        per["reduce_bf16"].append(dict(
            shape=f"{shape['name']} bf16", kernel="ff_reduce_kernel", dims=[o, n, h], ms=t_red,
            plain_ms=t_red_plain, bound=b_red, bound_simt=b_red[0], err=0.0, library_ms=t_sum,
            tiles=n_tiles))
        t_bwd_plain = time_ms(lambda: torch.autograd.grad(plain["bf16_obj"], w_req["bf16"],
                                                          retain_graph=True))
        fb = field_bounds(o, n, h, lib.ff_param_count(h), "bf16")
        names = ff.kernel_names(h, "bf16")
        common = dict(shape=shape["name"], dims=[o, n, h], library_ms=None)
        per["fused_field_fwd_bf16"].append(dict(
            common, kernel=names["fused_field_fwd_bf16"], ms=t_fwd, plain_ms=t_fwd_plain,
            bound=fb["fwd"], bound_simt=fb["fwd_simt"][0], encode_floor=fb["fwd_encode"][0],
            err=fwd_err, off={k: e["off"] for k, e in errs.items()},
            launch=ff.fwd_launch(lib, o, n, h)))
        per["fused_field_bwd_bf16"].append(dict(
            common, kernel=names["fused_field_bwd_bf16"], ms=t_bwd, plain_ms=t_bwd_plain,
            bound=fb["bwd"], bound_simt=fb["bwd_simt"][0],
            err=float((g_k - plain["bf16_grad"]).abs().max()), rel=dev[worst]))
        log(f"[kernels bf16] {shape['name']} O={o} N={n} h={h} ({names['fused_field_fwd_bf16']}, "
            f"{names['fused_field_bwd_bf16']}): K1 outputs off by > {FWD_ATOL} at most "
            f"{max(e['off'] for e in errs.values()):.2e} (limit {ff.BF16_OFF_FRAC}), max abs "
            f"{fwd_err:.2e}; {t_fwd:.4f} ms (plain {t_fwd_plain:.4f}, bound {fb['fwd'][0]:.4f} "
            f"{fb['fwd'][1]}, encode floor {fb['fwd_encode'][0]:.4f}; launch "
            f"{per['fused_field_fwd_bf16'][-1]['launch']}) | K2 worst leaf {worst} {dev[worst]:.2e} (bf16-vs-f32 "
            f"{dist[worst]:.2e}, limit {bf16_leaf_limit(dist[worst]):.2e}); {t_bwd:.4f} ms tile "
            f"{tile} (plain bwd {t_bwd_plain:.4f}, bound {fb['bwd'][0]:.4f} {fb['bwd'][1]}); "
            f"of it the weight image {t_img:.4f} ms (plain {t_img_plain:.4f}, bound "
            f"{b_img[0]:.4f} {b_img[1]}, equal bit for bit) | K2r over {n_tiles} bf16 slots "
            f"{t_red:.4f} ms (torch.sum {t_sum:.4f}, bound {b_red[0]:.4f} {b_red[1]})")
        log(f"[kernels bf16] {shape['name']} per leaf, K2 vs plain bf16 / plain bf16 vs f32: "
            + ", ".join(f"{k} {dev[k]:.1e}/{dist[k]:.1e}" for k in dev))
        del params, wflat, pts, cts, outs_k, g_k, plain, w_req, buf, part, a_t, c_t, f_t
        del img_ref, red, red_ref
    return per


# --------------------------------------------------------------------------- #
# phase 3: convergence through the kernels, and steps against the CPU
# --------------------------------------------------------------------------- #


def device_busy_ms(fn, iters: int = 10) -> float:
    """The device time (ms) of every kernel one call of ``fn`` launches,
    summed, from a torch.profiler trace of ``iters`` calls behind as many
    untraced ones; fails where the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for step in range(2):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            if step == 0:
                prof.step()
    us = sum(_device_us(e) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if not us > 0:
        raise RuntimeError("trace: no device time")
    return us / iters / 1e3


def packed_grads(gen, params, stacked: bool, device) -> dict:
    """Random gradients laid out as the trainer's autograd leaves them: views
    into one packed [O, P] (or [P]) gradient, each slot's row contiguous."""
    import torch
    from openobj_torch.core import optim

    leaves = [(p, x) for p, x in optim.flatten_with_path(params) if optim.trainable(p)]
    rows = [x[0].numel() if stacked else x.numel() for _, x in leaves]
    lead = (leaves[0][1].shape[0],) if stacked else ()
    packed = 1e-2 * torch.randn(lead + (sum(rows),), generator=gen, device=device)
    out, at = {}, 0
    for (path, x), k in zip(leaves, rows):
        optim.set_path(out, path, (packed[:, at:at + k] if stacked else packed[at:at + k])
                       .view(x.shape))
        at += k
    return out


def check_adamw_flat(device, smi: str) -> dict:
    """The flat AdamW kernel against its plain version on the room_0 trees
    (fg: the 64-slot bucket, h=32, with ADAMW_FROZEN's slots frozen; bg:
    h=128), from a state with moments and per-slot counts: per leaf within
    ADAMW_RTOL, the new counts equal, frozen slots bit for bit, the inputs
    untouched. Times (one launch a model per step): the kernel's device
    time (torch.profiler), the wrapper's call (CUDA events, host work
    included), the plain flat version, the per-leaf tree update (events,
    and its kernels' device time summed) and torch._fused_adamw_ over the
    same leaves cut into slots (the library's one call; no per-slot gate, so
    only the stepping slots go in), beside the byte bound."""
    import torch
    from openobj_torch.config import load_scene_config
    from openobj_torch.core import optim, trainer
    from openobj_torch.models.object_field import tree_map
    from openobj_torch.scripts._benchlib import bound_ms

    tc = load_scene_config(os.path.join(ROOT, "configs", "replica", "room_0.json")).train
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    st = trainer.init_train_state(gen, tc, n_slots=FG["o"], device=device)
    frozen = torch.zeros(FG["o"], dtype=torch.bool)
    frozen[list(ADAMW_FROZEN)] = True
    active = (~frozen).to(device)
    rows = []
    for name, params, opt, act in (("fg", st.fg_params, st.fg_opt, active),
                                   ("bg", st.bg_params, st.bg_opt, None)):
        stacked = act is not None
        opt = optim.AdamWState(
            mu=tree_map(lambda x: 1e-2 * torch.randn(x.shape, generator=gen,
                                                           device=device), opt.mu),
            nu=tree_map(lambda x: 1e-4 * torch.rand(x.shape, generator=gen,
                                                          device=device), opt.nu),
            count=(torch.randint(0, 300, opt.count.shape, generator=gen, device=device)
                   .to(torch.int32)))
        grads = packed_grads(gen, params, stacked, device)
        leaves = optim._trainable_leaves(params, grads, opt)
        before = [x.clone() for _, *xs in leaves for x in xs if x is not None]
        optim.reset_counts()
        k_p, k_s = optim.adamw_update_flat(params, grads, opt, tc.learning_rate,
                                           tc.weight_decay, act)
        p_p, p_s = optim.adamw_update_flat_plain(params, grads, opt, tc.learning_rate,
                                                 tc.weight_decay, act)
        torch.cuda.synchronize()
        if optim.COUNTS["adamw_flat"] != 1:
            raise AssertionError(f"[adamw_flat] {name}: {optim.COUNTS} launches, expected 1")
        after = [x for _, *xs in leaves for x in xs if x is not None]
        if not all(torch.equal(a, b) for a, b in zip(before, after)):
            raise AssertionError(f"[adamw_flat] {name}: the update changed its inputs")
        if not torch.equal(k_s.count, p_s.count):
            raise AssertionError(f"[adamw_flat] {name}: counts {k_s.count} vs {p_s.count}")
        worst, err = 0.0, 0.0
        for tree_k, tree_p, tree_in in ((k_p, p_p, params), (k_s.mu, p_s.mu, opt.mu),
                                        (k_s.nu, p_s.nu, opt.nu)):
            ref = dict(optim.flatten_with_path(tree_p))
            start = dict(optim.flatten_with_path(tree_in))
            for path, x in optim.flatten_with_path(tree_k):
                d = float((x - ref[path]).abs().max())
                rel = d / (float(ref[path].abs().max()) + 1e-30)
                worst, err = max(worst, rel), max(err, d)
                if not rel <= ADAMW_RTOL:
                    raise AssertionError(f"[adamw_flat] {name} {path}: max|d|/max|ref| "
                                         f"{rel:.3e} > {ADAMW_RTOL}")
                if stacked and optim.trainable(path) and not torch.equal(
                        x[frozen.to(device)], start[path][frozen.to(device)]):
                    raise AssertionError(f"[adamw_flat] {name} {path}: a frozen slot moved")

        # times; the launch alone, from its arguments made once
        lib = optim._lib()
        stream = torch.cuda.current_stream(device).cuda_stream
        args = (lib, leaves, opt.count, act, tc.learning_rate, tc.weight_decay, 0.9, 0.999,
                1e-8, stream)
        t_kernel = traced_ms(lambda: optim.flat_launch(*args), "adamw_flat_kernel")
        t_call = time_ms(lambda: optim.adamw_update_flat(params, grads, opt, tc.learning_rate,
                                                         tc.weight_decay, act))
        t_plain = time_ms(lambda: optim.adamw_update_flat_plain(
            params, grads, opt, tc.learning_rate, tc.weight_decay, act))

        def tree():
            return optim.adamw_update(params, grads, opt, tc.learning_rate, tc.weight_decay, act)

        t_tree, t_tree_busy = time_ms(tree), device_busy_ms(tree)
        # the library's one call, in place on copies: per-slot views of the
        # stepping slots (the fused kernel keeps one step count a tensor)
        slots = [i for i in range(FG["o"]) if not frozen[i]] if stacked else [None]
        lib_lists = [[], [], [], []]   # p, g, m, v: a view a (leaf, stepping slot)
        for _, *xs in leaves:
            for x, out in zip(xs, lib_lists):
                y = x.clone()
                out.extend([y[i] for i in slots] if stacked else [y])
        steps = [(opt.count[i] if stacked else opt.count).float() + 1
                 for _ in leaves for i in slots]

        def library():
            torch._fused_adamw_(*lib_lists, [], steps, lr=tc.learning_rate, beta1=0.9,
                                beta2=0.999, weight_decay=tc.weight_decay, eps=1e-8,
                                amsgrad=False, maximize=False)

        try:
            t_lib = time_ms(library)
        except (RuntimeError, TypeError, AttributeError) as e:   # no such call in this torch
            log(f"[adamw_flat] {name}: torch._fused_adamw_ unavailable ({e})")
            t_lib = None

        # bytes this run's data needs: a stepping slot's float read 4 times
        # (p, g, m, v) and written 3 (p, m, v); a frozen one read and written 3
        # times; the counts read and written, the gate read
        n_on = (FG["o"] - len(ADAMW_FROZEN)) if stacked else 1
        n_slots = FG["o"] if stacked else 1
        per_slot = sum(p.numel() for _, p, _, _, _ in leaves) // n_slots
        nbytes = per_slot * (28 * n_on + 24 * (n_slots - n_on)) + 9 * n_slots
        bound = bound_ms(15.0 * per_slot * n_on, nbytes)
        rows.append(dict(shape=name, dims=[n_slots, per_slot], leaves=len(leaves), ms=t_kernel,
                         call_ms=t_call, plain_ms=t_plain, tree_ms=t_tree,
                         tree_busy_ms=t_tree_busy, library_ms=t_lib, bound=bound, err=err,
                         rel=worst, bytes=nbytes))
        log(f"[adamw_flat] {name}: {len(leaves)} leaves x {n_slots} slots ({n_on} stepping) x "
            f"{per_slot} floats, max|d|/max|ref| {worst:.2e} (limit {ADAMW_RTOL}), max abs "
            f"{err:.2e}, counts equal, frozen slots and inputs bit-identical | kernel "
            f"{1e3 * t_kernel:.2f} us a launch (device, traced), the wrapper's call "
            f"{1e3 * t_call:.2f} us (events, host work included), bound {1e3 * bound[0]:.2f} us "
            f"{bound[1]} ({nbytes} bytes at 3.35 TB/s) | plain flat {t_plain:.4f} ms | tree "
            f"update {t_tree:.4f} ms (events), its kernels' device time {t_tree_busy:.4f} ms | "
            f"torch._fused_adamw_ over {len(lib_lists[0])} slot views "
            f"{'n/a' if t_lib is None else f'{t_lib:.4f} ms'} | {smi}")
    return {"adamw_flat": rows}


def check_convergence(device) -> None:
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import torch_synthetic_convergence as conv

    t0 = time.perf_counter()
    res = conv.run(device=device)
    conv.check(res)
    log(f"[convergence] losses {[round(x, 3) for x in res['losses']]} "
        f"depth MAE {res['depth_mae']:.4f} m colour MAE {res['color_mae']:.4f} "
        f"({time.perf_counter() - t0:.1f} s) CONVERGED OK")


def check_steps_vs_cpu(device, compute_dtype: str = "f32") -> list:
    """A few optimizer steps of a small scene on the card (kernels) and on
    the CPU (plain version) from the same state and batches: the per-step
    losses must agree (rel 1e-4 in f32, STEP_RTOL_BF16 in bf16). Returns
    the (card, CPU) loss pairs."""
    import torch
    from openobj_torch import convert
    from openobj_torch.core import trainer
    from openobj_torch.core.frame_store import append_frame, init_frame_store
    from openobj_torch.core.scene import Camera
    from openobj_torch.ops import fused_field as ff

    cfg = trainer.TrainConfig(
        n_iters_per_frame=4, win_size=2, n_samples_per_frame=16,
        win_size_bg=2, n_samples_per_frame_bg=64, hidden=32, hidden_bg=128,
        clip_size=64, part_mode=True, part_down=4, compute_dtype=compute_dtype)
    limit = STEP_RTOL_BF16 if compute_dtype == "bf16" else 1e-4
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
    worst, pairs = 0.0, []
    ff.reset_counts()
    for i in range(cfg.n_iters_per_frame):
        fsl = {k: x[i] for k, x in fg_b.items()}
        bsl = {k: x[i] for k, x in bg_b.items()}
        state_cpu, l_cpu = trainer.run_step(state_cpu, fsl, bsl, fg["active"], cfg, store.partfeat)
        state_gpu, l_gpu = trainer.run_step(
            state_gpu, {k: x.to(device) for k, x in fsl.items()},
            {k: x.to(device) for k, x in bsl.items()}, act_gpu, cfg, pf_gpu)
        rel = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
        worst = max(worst, rel)
        pairs.append((float(l_gpu), float(l_cpu)))
        if not (np.isfinite(float(l_gpu)) and rel <= limit):
            raise AssertionError(f"step {i} ({compute_dtype}): card loss {float(l_gpu)!r} vs "
                                 f"CPU {float(l_cpu)!r}")
    fwd = "fused_field_fwd_bf16" if compute_dtype == "bf16" else "fused_field_fwd"
    if ff.COUNTS[fwd] != 2 * cfg.n_iters_per_frame or ff.COUNTS["field_eager"]:
        raise AssertionError(f"steps ({compute_dtype}) left the kernels: {ff.COUNTS}")
    log(f"[steps] {cfg.n_iters_per_frame} steps at {compute_dtype}, h 32/128, card (kernels) vs "
        f"CPU (plain): losses {[(round(a, 5), round(b, 5)) for a, b in pairs]}, worst rel loss "
        f"diff {worst:.2e} (limit {limit})")
    return pairs


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
    busy = sum(_device_us(e) for e in rows)
    ff_us = sum(_device_us(e) for e in rows if "ff_" in e.key)
    launches = sum(e.count for e in rows)
    log(f"[profile] one frame: wall {wall_us / 1e3:.1f} ms (profiled), device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%), fused-field kernels "
        f"{ff_us / 1e3:.1f} ms ({100 * ff_us / max(busy, 1):.1f}% of busy), "
        f"{launches} device ops")
    top = sorted(rows, key=_device_us, reverse=True)[:12]
    for e in top:
        log(f"[profile]   {_device_us(e) / 1e3:9.2f} ms  x{e.count:6d}  {e.key[:90]}")
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
    flat = run_flat_frame(device, mapper, tc)
    return by_shape, cfg, mapper, frames, vecs, flat


def run_flat_frame(device, mapper, tc) -> dict:
    """Phase 4's frame with ``trainer.optim_impl`` "flat": from the mapper's
    state after its frames, one frame with the per-leaf update and one with
    the flat one (one launch of the flat AdamW kernel a model a step), the
    same start state and generator seed, the counts reset just before the
    flat frame and read just after: the flat kernel 2 x n_iters times, K1,
    K2 and K2r n_iters times at fg and at bg, nothing plain or eager; its
    step losses within FLAT_FRAME_RTOL of the tree frame's."""
    import dataclasses

    import torch
    from openobj_torch.core import optim, trainer
    from openobj_torch.ops import fused_field as ff

    start = _clone_state(mapper.state)
    fg_tables, bg_tables = mapper._fg_tables_device(), mapper._bg_tables_device()

    def frame(cfg):
        gen = torch.Generator(device=device).manual_seed(13)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, losses = trainer.train_frame(_clone_state(start), mapper.store, mapper.cam_dirs,
                                        fg_tables, bg_tables, gen, cfg)
        losses = losses.cpu().numpy()
        return losses, 1e3 * (time.perf_counter() - t0)

    tree, tree_ms = frame(tc)
    ff.reset_counts()
    optim.reset_counts()
    flat, flat_ms = frame(dataclasses.replace(tc, optim_impl="flat"))
    counts, by_shape = dict(ff.COUNTS), dict(ff.COUNTS_BY_SHAPE)
    launches = optim.COUNTS["adamw_flat"]
    steps = tc.n_iters_per_frame
    want = {(k, s["o"], s["n"], s["h"]): steps for s in (FG, BG)
            for k in ("fused_field_fwd", "fused_field_bwd", "fused_field_bwd_reduce")}
    if launches != 2 * steps or by_shape != want or counts["fused_field_plain"] \
            or counts["field_eager"]:
        raise AssertionError(f"[room_0 flat] flat AdamW {launches} launches (expected "
                             f"{2 * steps}), field launches {by_shape} (counts {counts})")
    if flat.shape != tree.shape or not np.isfinite(flat).all():
        raise AssertionError(f"[room_0 flat] losses {flat}")
    rel = float(np.max(np.abs(flat - tree) / np.abs(tree)))
    if not rel <= FLAT_FRAME_RTOL:
        raise AssertionError(f"[room_0 flat] losses {rel:.3e} from the tree frame's (limit "
                             f"{FLAT_FRAME_RTOL}): {flat} vs {tree}")
    log(f"[room_0 flat] one frame with optim_impl \"flat\" from phase 4's state: "
        f"{flat_ms:.1f} ms (the tree update's frame from the same state and seed, run first: "
        f"{tree_ms:.1f} ms); flat AdamW {launches} launches, K1/K2/K2r {steps} each at fg and "
        f"bg; largest relative loss difference {rel:.3e} (limit {FLAT_FRAME_RTOL}), "
        f"{'bit-equal' if np.array_equal(flat, tree) else 'not bit-equal'}; last losses "
        f"{float(flat[-1]):.6f} / {float(tree[-1]):.6f}")
    return {"launches": launches, "by_shape": by_shape, "rel": rel, "flat_ms": flat_ms,
            "tree_ms": tree_ms}


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


def k1_shape_row(name, wflat, pts, h, launches, compute_dtype: str = "f32") -> dict:
    """K1 (of the ``compute_dtype`` build) with the clip head off at one
    render or mesh shape: its error from the plain version (f32: max abs,
    gated at FWD_ATOL; bf16: ff.bf16_output_errors at FWD_ATOL), its time, the plain version's and the bound; ``launches``
    were counted at exactly this shape."""
    import torch
    from openobj_torch.ops import fused_field as ff
    from openobj_torch.scripts._benchlib import SINF_OPS, bound_ms, fwd_macs_noclip

    o, n, _ = pts.shape
    cd = compute_dtype
    lib = ff._lib(ff._SOURCE[cd])
    alpha = torch.empty((o, n, 1), device=pts.device)
    color = torch.empty((o, n, 3), device=pts.device)

    def fwd_k():
        err = lib.ff_forward(pts.data_ptr(), wflat.data_ptr(), alpha.data_ptr(),
                             color.data_ptr(), None, o, n, h, 0, ff._stream(pts))
        if err:
            raise RuntimeError(f"ff_forward: CUDA error {err}")

    fwd_k()
    with torch.no_grad():
        a_p, c_p, _ = ff.fused_field_plain(wflat, pts, h, False, cd)
        torch.cuda.synchronize()
        err = max(float((alpha - a_p).abs().max()), float((color - c_p).abs().max()))
        gate = ""
        if cd == "f32":
            if not err <= FWD_ATOL:
                raise AssertionError(f"K1 {name} ({cd}): max abs err {err:.3e} > {FWD_ATOL}")
        else:
            a_32, c_32, _ = ff.fused_field_plain(wflat, pts, h, False)
            errs = {"alpha": ff.bf16_output_errors(alpha, a_p, a_32, FWD_ATOL),
                    "color": ff.bf16_output_errors(color, c_p, c_32, FWD_ATOL)}
            del a_32, c_32
            gate = f" ({bf16_shown(errs)}; off limit {ff.BF16_OFF_FRAC})"
            if not all(e["ok"] for e in errs.values()):
                raise AssertionError(f"K1 {name} ({cd}) outside the bf16 gate: {errs}")
        del a_p, c_p
        t_k = time_ms(fwd_k)
        t_p = time_ms(lambda: ff.fused_field_plain(wflat, pts, h, False, cd), iters=3, warmup=1)
    macs, mm = fwd_macs_noclip(h)
    npts = o * n
    nbytes = npts * 12 + wflat.numel() * 4 + npts * 4 * (1 + 3)
    b = bound_ms(2.0 * macs * npts, nbytes, 2.0 * mm * npts, cd)
    enc = bound_ms((2.0 * 63 + 126 * SINF_OPS) * npts, 0.0)[0]   # the encode's own floor
    log(f"[outputs] K1 {name} [{o},{n},3] h={h} {cd}: err {err:.2e}{gate}, {t_k:.4f} ms "
        f"(plain {t_p:.4f}, bound {b[0]:.4f} {b[1]}, SIMT-only "
        f"{bound_ms(2.0 * macs * npts, nbytes)[0]:.4f}, encode floor {enc:.4f}; launch "
        f"{ff.fwd_launch(lib, o, n, h)}), {launches} launches at this shape")
    return {"shape": name, "kernel": ff.kernel_names(h, cd)[ff._FWD[cd]], "dims": [o, n, h],
            "launches": launches, "max_abs_err": err,
            "ms": t_k, "plain_ms": t_p, "bound_ms": b[0], "bound_by": b[1],
            "bound_simt_ms": bound_ms(2.0 * macs * npts, nbytes)[0], "library_ms": None}


def run_outputs(device, cfg, mapper, frames) -> tuple[list[dict], dict]:
    """Phase 4b. Returns K1's rows for the render and mesh shapes, and the
    launches by shape that the outputs made."""
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
    meshed = sorted(mapper.registry.inst_to_slot)[:MESH_OBJECTS]
    n_meshes = train.export_meshes(mapper, out, cfg.grid_dim, cfg.live_voxel_size,
                                   inst_ids=meshed)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = dict(ff.COUNTS)
    by_shape = dict(ff.COUNTS_BY_SHAPE)

    # the launches the code implies: one K1 per fg chunk (every object at
    # once), one per chunk of each background-id view (the config's bg ids
    # 0/2/3: the background model and, here, blocks 2 and 3), and per
    # meshed object (the first MESH_OBJECTS) its grid chunks plus its
    # vertex chunks
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
        if i not in meshed:
            continue
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
        f"meshes (objects {meshed}) at grid "
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
# phase 4h: room_0 at bf16
# --------------------------------------------------------------------------- #


def render_chunk_bf16(device, mapper, boxed, cfg, t_wc) -> dict:
    """One render chunk of 4 of ``mapper``'s objects (the boxes of
    ``boxed``, phase 4's mapper, which phase 4b fitted; the same jitter)
    through K1 bf16, the plain version in bf16 and in f32, on the card:
    winners that differ
    between K1 and the plain bf16 on at most WINNER_FLIP_FRAC of the covered
    pixels; where all three agree, depth and colour by
    ff.bf16_output_errors at FWD_ATOL."""
    import torch
    from openobj_torch import train
    from openobj_torch.core import renderer
    from openobj_torch.models import object_field
    from openobj_torch.ops import fused_field as ff
    from openobj_torch.ops import sampling

    cam = cfg.camera
    ids, _, t_wo, ext, cen = train.render_stack(boxed, cfg.bg_ids)
    slots = torch.as_tensor([mapper.registry.inst_to_slot[int(i)] for i in ids[:4]],
                            device=device)
    params = object_field.tree_map(lambda x: x[slots], mapper.state.fg_params)
    n_px = cam.height * cam.width
    tw = torch.as_tensor(t_wc, dtype=torch.float32, device=device)
    origins, dirs_w = sampling.origin_dirs_w(tw.expand(n_px, 4, 4),
                                             mapper.cam_dirs.reshape(-1, 3))
    gen = torch.Generator(device=device).manual_seed(1)
    sub = slice(0, 4)
    u = torch.rand((4, RENDER_CHUNK, RENDER_BINS), generator=gen, device=device)
    args = (params, t_wo[sub], ext[sub], cen[sub],
            torch.ones(4, dtype=torch.bool, device=device), origins, dirs_w, gen)
    kw = dict(n_bins=RENDER_BINS, max_hit_rays=RENDER_CHUNK, chunk=RENDER_CHUNK,
              max_deg=cfg.train.max_deg)
    with fixed_jitter(u):
        got = renderer.render_frame_batched(*args, compute_dtype="bf16", **kw)
        with plain_field_on_card():
            ref = renderer.render_frame_batched(*args, compute_dtype="bf16", **kw)
            f32 = renderer.render_frame_batched(*args, compute_dtype="f32", **kw)
    wk, wp, w32 = got["winner"], ref["winner"], f32["winner"]
    either = int(((wk >= 0) | (wp >= 0)).sum())
    flips = int(((wk != wp) & ((wk >= 0) | (wp >= 0))).sum())
    same = (wk == wp) & (wp == w32) & (wk >= 0)
    if not int(same.sum()):
        raise AssertionError("[room_0 bf16] the render chunk hit nothing")
    errs = {k: ff.bf16_output_errors(got[k][same], ref[k][same], f32[k][same], FWD_ATOL)
            for k in ("depth", "color")}
    log(f"[room_0 bf16] render chunk, 4 objects x {RENDER_CHUNK} rays x {RENDER_BINS} bins, K1 "
        f"bf16 vs plain bf16 on the card: {flips} of {either} covered pixels change winner "
        f"({flips / max(either, 1):.2e}, limit {WINNER_FLIP_FRAC}); where all three agree "
        f"({int(same.sum())}), off by > {FWD_ATOL}: {bf16_shown(errs)} (off limit "
        f"{ff.BF16_OFF_FRAC}); winners bf16 vs f32 differ on "
        f"{int(((wp != w32) & ((wp >= 0) | (w32 >= 0))).sum())}")
    if not (flips <= WINNER_FLIP_FRAC * max(either, 1) and all(e["ok"] for e in errs.values())):
        raise AssertionError("K1 bf16's render chunk disagrees with the plain field in bf16")
    return {"flips": flips, "errors": errs, "max_abs": max(e["max_abs"] for e in errs.values())}


def run_room0_bf16(device, frames, f32_vecs, f32_mapper) -> dict:
    """Phase 4h: phase 4's main path with the config's compute_dtype "bf16"
    (room_0.json otherwise unchanged, the same 3 synthetic frames), counts
    reset before and read after: K1/K2 bf16 and K2r 200 times per trained
    frame, nothing f32, plain or eager; the card's steps against the CPU's
    at bf16; one render chunk K1 bf16 vs plain (on the boxes that phase 4b
    fitted to ``f32_mapper``, phase 4's); one frame each with z_per_step
    and sample_per_step through the kernels."""
    import dataclasses

    import torch
    from openobj_torch.config import load_scene_config, make_mapper
    from openobj_torch.ops import fused_field as ff

    t_all = time.perf_counter()
    cfg = load_scene_config(os.path.join(ROOT, "configs", "replica", "room_0.json"))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="bf16"))
    tc = cfg.train
    mapper = make_mapper(cfg, frame_capacity=8, device=device)
    torch.cuda.synchronize()
    ff.reset_counts()
    times, vecs = [], []
    for rgb, depth, inst, t_wc, pf in frames:
        t0 = time.perf_counter()
        losses = mapper.process_frame(rgb, depth, inst, t_wc, partfeat=pf)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        vecs.append(None if losses is None else losses.cpu().numpy())
    mapper.finish()
    counts, by_shape = dict(ff.COUNTS), dict(ff.COUNTS_BY_SHAPE)
    if any(v is None or v.shape != (tc.n_iters_per_frame,) or not np.isfinite(v).all()
           for v in vecs):
        raise AssertionError(f"[room_0 bf16] loss vectors {vecs}")
    steps = 2 * tc.n_iters_per_frame * len(vecs)
    want = {"fused_field_fwd_bf16": steps, "fused_field_bwd_bf16": steps,
            "fused_field_bwd_bf16_image": steps, "fused_field_bwd_reduce": steps}
    if {k: v for k, v in counts.items() if v} != want:
        raise AssertionError(f"[room_0 bf16] counts {counts}, expected {want} and nothing else")
    ms = 1e3 * float(np.mean(times[1:]))
    log(f"[room_0 bf16] room_0 envelope at compute_dtype bf16, {mapper.n_objects} objects in a "
        f"{mapper.state.n_slots}-slot bucket + bg: frame times {[round(t * 1e3, 1) for t in times]}"
        f" ms; ms/frame (frames 2-3) {ms:.1f}; launches K1 bf16 {counts['fused_field_fwd_bf16']}, "
        f"K2 bf16 {counts['fused_field_bwd_bf16']} (its weight images "
        f"{counts['fused_field_bwd_bf16_image']}), K2r {counts['fused_field_bwd_reduce']} "
        f"(the code implies {steps} each), f32 / plain / eager 0")
    log(f"[room_0 bf16] last-step losses bf16 {[round(float(v[-1]), 4) for v in vecs]} beside "
        f"f32 (phase 4) {[round(float(v[-1]), 4) for v in f32_vecs]}; mean over the last 10 "
        f"steps bf16 {[round(float(v[-10:].mean()), 4) for v in vecs]}, f32 "
        f"{[round(float(v[-10:].mean()), 4) for v in f32_vecs]}")
    pairs = check_steps_vs_cpu(device, "bf16")
    chunk = render_chunk_bf16(device, mapper, f32_mapper, cfg, frames[-1][3])
    # K1 bf16 alone at phase 4b's render shape (every object of the stack x
    # one chunk of 2048 rays x 149 samples), on this mapper's weights; no
    # counted run renders at bf16, hence no launches at that shape
    from openobj_torch import train
    from openobj_torch.models import object_field

    ids = train.render_stack(f32_mapper, cfg.bg_ids)[0]
    slots = torch.as_tensor([mapper.registry.inst_to_slot[int(i)] for i in ids], device=device)
    w = ff._pack_params(object_field.tree_map(lambda x: x[slots], mapper.state.fg_params),
                        tc.hidden, False).contiguous()
    gen = torch.Generator(device=device).manual_seed(2)
    x = 0.5 * torch.randn((len(ids), RENDER_CHUNK * (RENDER_BINS - 1), 3), generator=gen,
                          device=device)
    k1_rows = [k1_shape_row("render", w, x, tc.hidden, 0, "bf16")]
    del mapper, w, x
    torch.cuda.empty_cache()

    options = {}
    for opt in ("z_per_step", "sample_per_step"):
        ocfg = dataclasses.replace(cfg, train=dataclasses.replace(tc, **{opt: True}))
        omapper = make_mapper(ocfg, frame_capacity=8, device=device)
        rgb, depth, inst, t_wc, pf = frames[0]
        ff.reset_counts()
        t0 = time.perf_counter()
        losses = omapper.process_frame(rgb, depth, inst, t_wc, partfeat=pf)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(ff.COUNTS)
        v = None if losses is None else losses.cpu().numpy()
        want = {k: 2 * tc.n_iters_per_frame for k in
                ("fused_field_fwd_bf16", "fused_field_bwd_bf16", "fused_field_bwd_bf16_image",
                 "fused_field_bwd_reduce")}
        if v is None or not np.isfinite(v).all() or {k: x for k, x in counts.items() if x} != want:
            raise AssertionError(f"[room_0 bf16] {opt}: losses {v}, counts {counts}")
        options[opt] = dict(ff.COUNTS_BY_SHAPE)
        log(f"[room_0 bf16] {opt}: one frame {1e3 * dt:.1f} ms (the first: warm-up in it), "
            f"losses finite, last {float(v[-1]):.4f}; K1/K2 bf16 and K2r "
            f"{counts['fused_field_fwd_bf16']} each")
        del omapper
    log(f"[room_0 bf16] phase 4h took {time.perf_counter() - t_all:.1f} s")
    return {"by_shape": by_shape, "by_shape_options": options, "ms_per_frame": ms,
            "vecs": vecs, "steps": pairs, "render_chunk": chunk, "k1_rows": k1_rows}


# --------------------------------------------------------------------------- #
# phase 4i: room_0 sharded
# --------------------------------------------------------------------------- #


def _clone_state(st):
    from openobj_torch.core import optim, trainer
    from openobj_torch.models.object_field import tree_map

    def clone(tree):
        return tree_map(lambda x: x.clone(), tree)

    def opt(o):
        return optim.AdamWState(clone(o.mu), clone(o.nu), o.count.clone())

    return trainer.TrainState(clone(st.fg_params), opt(st.fg_opt), clone(st.bg_params),
                              opt(st.bg_opt))


def run_room0_sharded(device, cfg, mapper, frames, vecs) -> dict:
    """Phase 4i: one frame of phase 4's mapper (its state, tables and
    store) trained unsharded and one through shard_scene and the sharded
    train_frame on a mesh of the one card (NCCL as a group of one), from
    the same start state and seed, counts reset around the sharded frame;
    then the sharded snapshot saved and loaded into a fresh mapper, every
    leaf bit-identical; then ``sharded_mapper``. Leaves ``mapper`` with the
    sharded frame's state."""
    import torch
    import torch.distributed as dist
    from openobj_torch.config import make_mapper
    from openobj_torch.core import checkpoint, trainer
    from openobj_torch.ops import fused_field as ff
    from openobj_torch.parallel import distributed, sharding

    t_all = time.perf_counter()
    tc = cfg.train
    start = _clone_state(mapper.state)
    fg_tables, bg_tables = mapper._fg_tables_device(), mapper._bg_tables_device()
    store, dirs = mapper.store, mapper.cam_dirs

    def gen():
        return torch.Generator(device=device).manual_seed(11)

    def unsharded():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, losses = trainer.train_frame(_clone_state(start), store, dirs, fg_tables,
                                        bg_tables, gen(), tc)
        losses = losses.cpu().numpy()
        return losses, 1e3 * (time.perf_counter() - t0)

    single, single_ms = unsharded()
    snap = tempfile.mkdtemp(prefix="room0_sharded_", dir=os.path.join(ROOT, "build"))
    t0 = time.perf_counter()
    distributed.initialize(f"127.0.0.1:{free_port()}", num_processes=1, process_id=0,
                           device="cuda")
    try:
        mesh = sharding.make_mesh()
        distributed.barrier("room_0 sharded")   # NCCL makes its communicator here
        init_s = time.perf_counter() - t0
        if (mesh.device_type, mesh.mesh_dim_names, tuple(mesh.shape)) != ("cuda", ("object",),
                                                                          (1,)) \
                or dist.get_backend() != "nccl":
            raise AssertionError(f"[room_0 sharded] mesh {mesh}, backend {dist.get_backend()}")

        def sharded_frame():
            s_state, s_tables, s_store = sharding.shard_scene(mesh, start, fg_tables, store)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with sharding.use_mesh(mesh):
                new, losses = trainer.train_frame(s_state, s_store, dirs, s_tables,
                                                  bg_tables, gen(), tc)
            losses = losses.cpu().numpy()
            return new, losses, 1e3 * (time.perf_counter() - t0)

        ff.reset_counts()
        new_state, sharded, frame_ms = sharded_frame()
        counts, by_shape = dict(ff.COUNTS), dict(ff.COUNTS_BY_SHAPE)
        steps = tc.n_iters_per_frame
        want = {(k, s["o"], s["n"], s["h"]): steps for s in (FG, BG)
                for k in ("fused_field_fwd", "fused_field_bwd", "fused_field_bwd_reduce")}
        if by_shape != want or counts["fused_field_plain"] or counts["field_eager"]:
            raise AssertionError(f"[room_0 sharded] launches {by_shape} (counts {counts}), "
                                 f"expected {want} and nothing plain or eager")
        if sharded.shape != single.shape or not np.isfinite(sharded).all():
            raise AssertionError(f"[room_0 sharded] losses {sharded}")
        rel = float(np.max(np.abs(sharded - single) / np.abs(single)))
        # on a mesh of one every op is the unsharded path's
        limit = 0.0 if mesh.size() == 1 else SHARDED_RTOL
        if not (np.array_equal(sharded, single) if limit == 0.0 else rel <= limit):
            raise AssertionError(f"[room_0 sharded] losses {rel:.3e} apart (limit "
                                 f"{limit}): {sharded} vs {single}")
        log(f"[room_0 sharded] one frame on a mesh of one card ({dict(zip(mesh.mesh_dim_names, mesh.shape))},"
            f" NCCL; group, mesh and communicator made in {init_s:.3f} s): "
            f"{frame_ms:.1f} ms (unsharded, same start and seed, run first after phase 4h: "
            f"{single_ms:.1f} ms); launches by shape {by_shape}; largest "
            f"relative loss difference {rel:.3e} (limit {limit}); last losses "
            f"{float(sharded[-1]):.6f} / {float(single[-1]):.6f}")

        # ---- the sharded snapshot, saved (twice: the first save also
        # imports DCP and plans) and loaded into a fresh mapper ----
        mapper.state = new_state
        save_s = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with sharding.use_mesh(mesh):
                checkpoint.save_scene_sharded(snap, mapper)
            save_s.append(time.perf_counter() - t0)
        n_bytes = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(snap) for f in fs)
        fresh = make_mapper(cfg, frame_capacity=8, device=device)
        fresh.state, _ = sharding.shard_scene(mesh, fresh.state, {})
        t0 = time.perf_counter()
        with sharding.use_mesh(mesh):
            checkpoint.load_scene_sharded(snap, fresh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        a = dict(_named_leaves(checkpoint._device_state_tree(new_state)))
        b = dict(_named_leaves(checkpoint._device_state_tree(fresh.state)))
        differ = [k for k in a if k not in b or a[k].dtype != b[k].dtype
                  or a[k].device != b[k].device or not torch.equal(a[k], b[k])]
        if sorted(a) != sorted(b) or differ:
            raise AssertionError(f"[room_0 sharded] restored leaves differ: {differ}")
        reg, reg2 = mapper.registry, fresh.registry
        if reg2.inst_to_slot != reg.inst_to_slot or not all(
                np.array_equal(getattr(reg, t), getattr(reg2, t))
                for t in ("kf_frames", "kf_bbox", "n_kf", "latest2", "active", "obj_inst")):
            raise AssertionError("[room_0 sharded] restored registry differs")
        log(f"[room_0 sharded] save_scene_sharded {save_s[0]:.3f} s (again: {save_s[1]:.3f} s), "
            f"{n_bytes} bytes (DCP state + scene_meta.npz); load_scene_sharded into a fresh "
            f"mapper ({fresh.state.n_slots} slots after growing from 8) {load_s:.3f} s; "
            f"{len(a)} leaves bit-identical, registry equal")
        del fresh
        mapper_run = sharded_mapper(device, cfg, mesh, frames, vecs, snap, mapper.registry)
        distributed.barrier("room_0 sharded")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(snap, ignore_errors=True)
    log(f"[room_0 sharded] phase 4i took {time.perf_counter() - t_all:.1f} s")
    return {"by_shape": by_shape, "frame_ms": frame_ms, "rel": rel, "save_s": save_s,
            "load_s": load_s, "bytes": n_bytes, **mapper_run}


def sharded_mapper(device, cfg, mesh, frames, vecs, snap, boxed_registry) -> dict:
    """Phase 4i's mapper on ``mesh``: a fresh mapper of phase 4's config and
    seed, cut at bucket 8, trains phase 4's frames inside use_mesh (its
    loss vectors ``vecs``, bit for bit), saves and reloads its npz
    snapshot under the mesh, then renders a band of one pose inside the
    mesh and outside it (on the boxes of ``boxed_registry``)."""
    import torch
    from openobj_torch.config import make_mapper
    from openobj_torch.core import checkpoint, renderer
    from openobj_torch.ops import fused_field as ff
    from openobj_torch.ops import sampling
    from openobj_torch.parallel import sharding

    tc, cam = cfg.train, cfg.camera
    m = make_mapper(cfg, frame_capacity=8, device=device)
    bucket0 = m.state.global_slots
    m.state, _ = sharding.shard_scene(mesh, m.state, {})
    ff.reset_counts()
    times, got = [], []
    with sharding.use_mesh(mesh):
        for rgb, depth, inst, t_wc, pf in frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got.append(m.process_frame(rgb, depth, inst, t_wc, partfeat=pf))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        m.finish()
    counts, train_shapes = dict(ff.COUNTS), dict(ff.COUNTS_BY_SHAPE)
    got = [x.cpu().numpy() for x in got]
    steps = len(frames) * tc.n_iters_per_frame
    want = {(k, s["o"], s["n"], s["h"]): steps for s in (FG, BG)
            for k in ("fused_field_fwd", "fused_field_bwd", "fused_field_bwd_reduce")}
    if train_shapes != want or counts["fused_field_plain"] or counts["field_eager"]:
        raise AssertionError(f"[room_0 sharded mapper] launches {train_shapes} (counts "
                             f"{counts}), expected {want} and nothing plain or eager")
    if (bucket0, m.state.global_slots, m.state.n_shards) != (8, FG["o"], 1):
        raise AssertionError(f"[room_0 sharded mapper] bucket {bucket0} -> "
                             f"{m.state.global_slots} over {m.state.n_shards} shard(s)")
    same = len(got) == len(vecs) and all(np.array_equal(a, b) for a, b in zip(got, vecs))
    if not same:
        raise AssertionError(f"[room_0 sharded mapper] losses differ from phase 4's: "
                             f"{[float(v[-1]) for v in got]} vs {[float(v[-1]) for v in vecs]}")
    log(f"[room_0 sharded mapper] a fresh mapper cut at bucket {bucket0} on a mesh of one card "
        f"trained phase 4's {len(frames)} frames through process_frame inside use_mesh: bucket "
        f"{bucket0} -> {m.state.global_slots}, loss vectors bit-equal to phase 4's; frame times "
        f"{[round(t, 1) for t in times]} ms (first includes the growth); launches by shape "
        f"{train_shapes}, nothing plain or eager")

    # the npz snapshot under the mesh, loaded into a fresh sharded mapper
    path = os.path.join(snap, "npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sharding.use_mesh(mesh):
        checkpoint.save_scene(path, m)
    save_s = time.perf_counter() - t0
    n_bytes = os.path.getsize(os.path.join(path, "scene_state.npz"))
    fresh = make_mapper(cfg, frame_capacity=8, device=device)
    fresh.state, _ = sharding.shard_scene(mesh, fresh.state, {})
    t0 = time.perf_counter()
    with sharding.use_mesh(mesh):
        checkpoint.load_scene(path, fresh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    a = dict(_named_leaves(checkpoint._device_state_tree(m.state)))
    b = dict(_named_leaves(checkpoint._device_state_tree(fresh.state)))
    differ = [k for k in a if k not in b or a[k].dtype != b[k].dtype
              or a[k].device != b[k].device or not torch.equal(a[k], b[k])]
    if sorted(a) != sorted(b) or differ:
        raise AssertionError(f"[room_0 sharded mapper] reloaded leaves differ: {differ}")
    del fresh
    log(f"[room_0 sharded mapper] save_scene under the mesh {save_s:.3f} s, {n_bytes} bytes "
        f"(scene_state.npz); load_scene into a fresh sharded mapper {load_s:.3f} s; {len(a)} "
        f"leaves bit-identical")

    # render_frame_batched of the trained state, inside the mesh and outside
    reg = boxed_registry
    o = m.state.global_slots
    t_wo = np.tile(np.eye(4, dtype=np.float32), (o, 1, 1))
    ext = np.ones((o, 3), np.float32)
    cen = np.zeros((o, 3), np.float32)
    act = np.zeros(o, bool)
    for slot, st in reg.slots.items():
        if st.bbox3d is not None:
            t_wo[slot, :3, :3], t_wo[slot, :3, 3] = st.bbox3d.r, st.bbox3d.center
            ext[slot], cen[slot], act[slot] = st.bbox3d.extent, st.obj_center, True
    geo = [torch.as_tensor(x, device=device) for x in (t_wo, ext, cen, act)]
    rows = slice(cam.height // 2 - SHARDED_BAND // 2, cam.height // 2 + SHARDED_BAND // 2)
    dirs_c = m.cam_dirs[rows].reshape(-1, 3)
    tw = torch.as_tensor(frames[-1][3], dtype=torch.float32, device=device)
    origins, dirs_w = sampling.origin_dirs_w(tw.expand(dirs_c.shape[0], 4, 4), dirs_c)
    need = int(renderer.obb_hit_counts(geo[0], geo[1], geo[3], origins, dirs_w).max())
    cap = max(1, -(-need // RENDER_CHUNK)) * RENDER_CHUNK
    kw = dict(n_bins=RENDER_BINS, max_hit_rays=cap, chunk=RENDER_CHUNK, max_deg=tc.max_deg)

    def render(inside):
        gen = torch.Generator(device=device).manual_seed(5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sharding.use_mesh(mesh) if inside else contextlib.nullcontext():
            out = renderer.render_frame_batched(m.state.fg_params, *geo, origins, dirs_w,
                                                gen, **kw)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    ff.reset_counts()
    (inside, in_ms), (outside, out_ms) = render(True), render(False)
    counts, render_shapes = dict(ff.COUNTS), dict(ff.COUNTS_BY_SHAPE)
    n_chunks = cap // RENDER_CHUNK
    want = {("fused_field_fwd", o, RENDER_CHUNK * (RENDER_BINS - 1), tc.hidden): 2 * n_chunks}
    if render_shapes != want or counts["fused_field_plain"] or counts["field_eager"]:
        raise AssertionError(f"[room_0 sharded render] launches {render_shapes} (counts "
                             f"{counts}), expected {want} and nothing plain or eager")
    differ = [k for k in inside if not torch.equal(inside[k], outside[k])]
    covered = int((inside["winner"] >= 0).sum())
    if differ or not covered:
        raise AssertionError(f"[room_0 sharded render] inside vs outside the mesh: {differ} "
                             f"differ, {covered} rays covered")
    log(f"[room_0 sharded render] {o} slots ({int(act.sum())} boxed), a band of "
        f"{SHARDED_BAND}x{cam.width} rays of one pose, {RENDER_BINS} bins, cap {cap} ({need} "
        f"hit at most): inside the mesh {in_ms:.1f} ms, outside {out_ms:.1f} ms; winner, n_hit "
        f"equal, depth and colour bit-equal, {covered} rays covered; launches {render_shapes}")
    return {"mapper_shapes": train_shapes, "render_shapes": render_shapes,
            "mapper_frame_ms": times, "npz_save_s": save_s, "npz_load_s": load_s,
            "npz_bytes": n_bytes, "render_ms": [in_ms, out_ms]}


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


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


def write_room0_raw(tmp) -> dict:
    """The raw Replica-layout sequence that phases 4d and 4e read: the
    synthetic archetype ``tabletop`` (a table and three objects in a room)
    at room_0's camera, RAW_FRAMES frames written once, with the ground-truth
    instance maps of every ASSOC_STRIDE-th frame held aside."""
    from openobj_torch.core.scene import Camera
    from openobj_torch.data import synthetic

    cam = Camera(**ROOM0_CAM)
    root = os.path.join(tmp, "scene")
    scene, orbit = synthetic.archetype_scene("tabletop")
    t0 = time.perf_counter()
    gt_maps = synthetic.write_raw_scene(root, scene, cam.ray_dirs("cpu").numpy(),
                                        n_frames=RAW_FRAMES, orbit_kwargs=orbit,
                                        assoc_stride=ASSOC_STRIDE)
    write_s = time.perf_counter() - t0
    log(f"[room_0 raw] {RAW_FRAMES} raw frames at {cam.height}x{cam.width} written in "
        f"{write_s:.1f} s on 4 threads (phases 4d and 4e read them)")
    return {"root": root, "gt_maps": gt_maps, "cam": cam, "write_s": write_s}


def room0_config(tmp, root):
    """A copy of configs/replica/room_0.json whose only change is
    ``dataset.path``: (its path, the loaded SceneConfig)."""
    from openobj_torch import config as oconfig

    with open(os.path.join(ROOT, "configs", "replica", "room_0.json")) as f:
        cfg = json.load(f)
    cfg["dataset"]["path"] = root
    cfg_path = os.path.join(tmp, "room_0.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)
    return cfg_path, oconfig.load_scene_config(cfg_path)


def train_room0(scfg, cfg_path, logdir, tag) -> dict:
    """``train.main`` on ``cfg_path``, in process, with the counts reset
    just before it and read just after. Gates: checkpoints for the background
    and every object loaded, scene_state.npz and timing.json, finite losses,
    K1/K2/K2r 2 x n_iters launches per trained frame and nothing plain or
    eager."""
    import torch
    from openobj_torch import train
    from openobj_torch.data import loaders
    from openobj_torch.ops import fused_field as ff

    dataset = loaders.make_dataset(scfg)
    load_ms, want_ckpts = [], {"0"}     # the background and every object loaded
    for i in range(len(dataset)):
        t0 = time.perf_counter()
        sample = dataset[i]
        load_ms.append(1e3 * (time.perf_counter() - t0))
        want_ckpts |= {str(k) for k in sample.bboxes}

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
    res = {"objects": mapper.n_objects, "ckpts": sorted(ckpts, key=int), "counts": counts,
           "by_shape": by_shape, "load_ms_per_frame": float(np.mean(load_ms)),
           "train_ms_per_frame": float(np.mean(trained)), "losses": losses,
           "train_s": train_s}
    log(f"[{tag}] ms per loaded frame {res['load_ms_per_frame']:.1f} "
        f"({[round(x, 1) for x in load_ms]}); train.main {train_s:.1f} s, ms per trained "
        f"frame (frames 2-{len(dataset)}, timing.json) {res['train_ms_per_frame']:.1f} "
        f"({trained}); {mapper.n_objects} objects + bg, checkpoints {res['ckpts']}; "
        f"last-step losses {[round(x, 4) for x in losses]}; counts {counts}")
    if not ckpts >= want_ckpts or mapper.n_objects < 1:
        raise AssertionError(f"[{tag}] checkpoints {sorted(ckpts)}, expected {sorted(want_ckpts)}")
    for name in ("scene_state.npz", "timing.json"):
        if not os.path.exists(os.path.join(logdir, name)):
            raise AssertionError(f"[{tag}] train.main wrote no {name}")
    if len(losses) != len(dataset) or not np.isfinite(losses).all():
        raise AssertionError(f"[{tag}] losses {losses} over {len(dataset)} frames")
    steps = 2 * scfg.train.n_iters_per_frame * len(dataset)   # fg + bg per step
    for k in ("fused_field_fwd", "fused_field_bwd", "fused_field_bwd_reduce"):
        if counts[k] != steps:
            raise AssertionError(f"[{tag}] {k} launched {counts[k]} times, expected {steps}")
    if counts["field_eager"] or counts["fused_field_plain"]:
        raise AssertionError(f"[{tag}] training left the kernels: {counts}")
    return res


def written_miou(root, keyframes, gt_maps) -> dict:
    """Matched instance mIoU of the written instance maps at ``keyframes``
    against the ground truth held aside for them."""
    from openobj_torch import eval as oeval
    from openobj_torch.utils.png import read_png

    written = [read_png(os.path.join(root, "instance_our", f"semantic_instance_{k}.png"))
               .astype(np.int32) for k in keyframes]
    return oeval.matched_instance_miou(written, gt_maps)


def run_room0_from_disk(device, raw) -> dict:
    """Phase 4d: the raw sequence's ground-truth masks with seeded features,
    associated on the card into the artifacts the loader reads, random part
    maps, then ``train.main`` on room_0.json with only ``dataset.path``
    changed."""
    from openobj_torch.perception import merge, pipeline
    from openobj_torch.utils.png import read_png

    root, gt_maps, cam = raw["root"], raw["gt_maps"], raw["cam"]
    t_all = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="room0_disk_", dir=os.path.dirname(root))

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
    score = written_miou(root, range(len(gt_maps)), gt_maps)

    # ---- the training command line on room_0.json, path changed ----
    cfg_path, scfg = room0_config(tmp, root)
    part = (cam.height // scfg.train.part_down, cam.width // scfg.train.part_down,
            scfg.train.clip_size)
    os.makedirs(os.path.join(root, "partlevel"), exist_ok=True)
    prng = np.random.default_rng(1)
    for i in range(0, RAW_FRAMES, scfg.stride):        # the frames that are read
        np.save(os.path.join(root, "partlevel", f"{i}.npy"),
                prng.normal(size=part).astype(np.float32))
    log(f"[room_0 disk] matched instance mIoU of the written maps against the ground "
        f"truth {score['inst_miou']:.4f} (background IoU {score['bg_iou']:.4f}; "
        f"{score['matches']})")
    res = train_room0(scfg, cfg_path, os.path.join(tmp, "logs"), "room_0 disk")
    res.update({"assoc_ms_per_frame": 1e3 * assoc_s, "inst_miou": score["inst_miou"],
                "bg_iou": score["bg_iou"], "cut_gap": gap})
    log(f"[room_0 disk] phase 4d took {time.perf_counter() - t_all:.1f} s")
    return res


def run_room0_auto(device, raw) -> dict:
    """Phase 4e: the raw sequence alone (a fresh root holding only rgb/,
    depth/ and traj_w_c.txt) through ``perception.auto.run_auto_perception``
    on the card with room_0.json's settings (part mode on), then
    ``train.main`` on the artifacts it wrote, with no ground truth. Gates:
    the artifact contract, one frame's part map painted on the card equal
    to its numpy painting bit for bit, and ``train_room0``'s."""
    import pickle

    import torch
    from openobj_torch.perception import auto, cli, partfeat
    from openobj_torch.perception import encoders as enc
    from openobj_torch.perception.segmentation import GraphSegmenter
    from openobj_torch.utils import profiling

    t_all = time.perf_counter()
    cam = raw["cam"]
    tmp = tempfile.mkdtemp(prefix="room0_auto_", dir=os.path.dirname(raw["root"]))
    root = os.path.join(tmp, "scene")
    for d in ("rgb", "depth"):
        shutil.copytree(os.path.join(raw["root"], d), os.path.join(root, d))
    shutil.copy(os.path.join(raw["root"], "traj_w_c.txt"), root)
    cfg_path, scfg = room0_config(tmp, root)
    if not scfg.train.part_mode:
        raise AssertionError("room_0.json has part mode off")

    # ---- perception on the card, timed by the stages' own spans ----
    warm_matrices(device)
    profiling.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    auto.run_auto_perception(scfg, device=device)
    torch.cuda.synchronize()
    perception_s = time.perf_counter() - t0
    spans = profiling.stats()

    # ---- the artifact contract ----
    skip = auto.keyframe_skip(RAW_FRAMES, scfg.stride)
    keyframes = list(range(0, RAW_FRAMES, skip))
    mask_init = enc.load_mask_init(os.path.join(root, "mask_init_all.pkl"))
    fields = ("mask", "bbox", "caption", "capfeat", "clipfeat")
    if sorted(mask_init) != keyframes or any(set(mask_init[k]) != set(fields)
                                             for k in keyframes):
        raise AssertionError(f"mask_init_all.pkl holds {sorted(mask_init)}, expected "
                             f"{keyframes} with {fields}")
    for k in range(len(keyframes)):
        for d, name in (("instance_our", "semantic_instance"), ("class_our", "semantic_class")):
            if not os.path.exists(os.path.join(root, d, f"{name}_{k}.png")):
                raise AssertionError(f"no {d}/{name}_{k}.png")
    for name in ("clipfeat", "capfeat", "caption"):
        with open(os.path.join(root, f"object_{name}.pkl"), "rb") as f:
            if len(pickle.load(f)) != len(keyframes):
                raise AssertionError(f"object_{name}.pkl is not per keyframe")
    part_shape = (cam.height // scfg.train.part_down, cam.width // scfg.train.part_down,
                  scfg.train.clip_size)
    trained_frames = list(range(0, RAW_FRAMES, scfg.stride))
    for i in trained_frames:
        pf = np.load(os.path.join(root, "partlevel", f"{i}.npy"), mmap_mode="r")
        if pf.shape != part_shape or pf.dtype != np.float32:
            raise AssertionError(f"partlevel/{i}.npy is {pf.dtype} {pf.shape}, "
                                 f"expected float32 {part_shape}")

    # ---- one frame's part map: on the card against numpy, and as written ----
    knobs = auto.scaled_knobs(cam, scfg.max_depth)
    segmenter = GraphSegmenter(k=1.0, min_size=max(8, knobs["seg_min"] // 2),
                               stride=knobs["seg_stride"])     # partfeat's, as auto runs it
    rgb, depth, _ = cli.RawFrames(root, depth_scale=scfg.depth_scale,
                                  max_depth=scfg.max_depth)[0]
    masks, feats, scores = cli.part_map_inputs(
        rgb, depth, segmenter, enc.VisualDescriptorEncoder(dim=scfg.train.clip_size))
    card = partfeat.build_part_feature_map(masks, feats, scores, scfg.train.part_down,
                                           device=device)
    plain = partfeat.build_part_feature_map_plain(masks, feats, scores, scfg.train.part_down)
    written = np.load(os.path.join(root, "partlevel", "0.npy"))
    if not (np.array_equal(card, plain) and np.array_equal(written, plain)):
        raise AssertionError("the part map painted on the card differs from numpy's")
    paint_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        partfeat.build_part_feature_map(masks, feats, scores, scfg.train.part_down,
                                        device=device)
        paint_ms.append(1e3 * (time.perf_counter() - t0))
    t0 = time.perf_counter()
    partfeat.build_part_feature_map_plain(masks, feats, scores, scfg.train.part_down)
    plain_ms = 1e3 * (time.perf_counter() - t0)

    gt_keys = [k for k in keyframes if k % ASSOC_STRIDE == 0]
    score = written_miou(root, [keyframes.index(k) for k in gt_keys], raw["gt_maps"])
    n_masks = [len(mask_init[k]["mask"]) for k in keyframes]

    def per_frame(name):
        st = spans.get(name)
        if st is None:
            raise AssertionError(f"no '{name}' span: {sorted(spans)}")
        return st["mean_ms"] * st["n"] / len(keyframes)

    res = {"perception_s": perception_s, "keyframes": len(keyframes),
           "maskgen_ms": per_frame("maskgen: frame"),
           "assoc_ms": per_frame("associate: association"),
           "sim_ms": per_frame("association: similarity matrices"),
           "partfeat_ms": per_frame("partfeat: frame"),
           "paint_run_ms": per_frame("partfeat: part map painting"),
           "paint_ms": float(np.median(paint_ms)), "paint_plain_ms": plain_ms,
           "masks_per_keyframe": float(np.mean(n_masks)), "part_masks_frame0": len(masks),
           "inst_miou": score["inst_miou"], "bg_iou": score["bg_iou"]}
    log(f"[room_0 auto] run_auto_perception {perception_s:.1f} s over {len(keyframes)} "
        f"keyframes (skip {skip}); ms per keyframe: maskgen {res['maskgen_ms']:.1f}, "
        f"association {res['assoc_ms']:.1f} (similarity matrices on the card "
        f"{res['sim_ms']:.1f}), partfeat {res['partfeat_ms']:.1f} (painting on the card "
        f"{res['paint_run_ms']:.1f}); masks per keyframe {res['masks_per_keyframe']:.2f} "
        f"({n_masks}); frame 0's part map ({len(masks)} masks) painted on the card "
        f"{res['paint_ms']:.2f} ms (median of 5, to numpy), numpy's loop {plain_ms:.2f} ms, "
        f"equal bit for bit and to the written map; matched instance mIoU at frames "
        f"{gt_keys} (keyframes {[keyframes.index(k) for k in gt_keys]}) against the ground "
        f"truth {score['inst_miou']:.4f} (background IoU "
        f"{score['bg_iou']:.4f}; {score['matches']})")
    res.update(train_room0(scfg, cfg_path, os.path.join(tmp, "logs"), "room_0 auto"))
    res["logdir"] = os.path.join(tmp, "logs")
    log(f"[room_0 auto] phase 4e took {time.perf_counter() - t_all:.1f} s")
    return res


# --------------------------------------------------------------------------- #
# phase 4f: room_0 export and query
# --------------------------------------------------------------------------- #

# the viewer's and the server's queries (object text, part text, top-k)
QUERIES = (("a chair", None, None), ("a table", None, 1), ("a wall", None, 3),
           ("a chair", "leg", None), ("a table", "top", 2), ("a cup", "handle", 1))
# the server's queries are timed over this many rounds of QUERIES
HTTP_ROUNDS = 3


def export_k1_launches(npz_paths, bundle) -> tuple[int, int]:
    """The K1 launches an export of these checkpoints implies, and the
    number of boxed objects: per object its occupancy grid's chunks (grid
    128 at voxel 0.005, at most MESH_CHUNK points a launch), and per meshed
    object its vertex chunks."""
    want, n_boxed = 0, 0
    for p in npz_paths:
        with np.load(p) as z:
            if "bbox_extent" not in z:
                continue
            dim = int(min(np.max(z["bbox_extent"].astype(np.float64)) // 0.005 + 1, 128))
        n_boxed += 1
        want += -(-dim ** 3 // min(MESH_CHUNK, dim ** 3))
    want += sum(-(-len(e["mesh"]["vertices"]) // MESH_CHUNK) for e in bundle.values())
    return want, n_boxed


def run_room0_export(device, logdir) -> dict:
    """Phase 4f: phase 4e's checkpoint tree (the background at h=128, the
    objects at h=32, the 512-d clip head) through the map's consumers: the
    class features and the class table (read back without PyYAML), the
    interop to a reference .pth tree and back (bit-identical), the export of
    the .pth tree by its CLI and of the npz tree (counted, equal bit for bit,
    K1 only), one object's vertex part features through K1 against the plain
    field, the viewer CLI, and the query server over HTTP on 127.0.0.1."""
    import pickle
    import threading
    import urllib.parse
    import urllib.request

    import torch
    from openobj_torch import interop, train
    from openobj_torch.core import checkpoint, meshing
    from openobj_torch.models import object_field
    from openobj_torch.ops import fused_field as ff
    from openobj_torch.perception import class_features
    from openobj_torch.utils import profiling
    from openobj_torch.viz import class_tables, colors, export, query, server, viewer
    from openobj_torch.viz import viewer_math

    t_all = time.perf_counter()
    ckpt = os.path.join(logdir, "ckpt")
    tmp = tempfile.mkdtemp(prefix="room0_export_", dir=os.path.dirname(logdir))
    npz_paths = sorted(glob.glob(os.path.join(ckpt, "*", "obj_*.npz")))
    rel = [os.path.relpath(p, ckpt) for p in npz_paths]

    # ---- class features and the class table, without PyYAML ----
    cf_path = os.path.join(tmp, "class_features.npz")
    class_features.main(["--dataset", "replica", "--encoders", "fake", cf_path])
    feats = train.load_class_features(cf_path)
    names = class_tables.class_names("replica")
    norms = np.linalg.norm(np.concatenate([feats["clipfeat"], feats["capfeat"]], 1), axis=1)
    if (feats["names"] != names or feats["clipfeat"].shape != (len(names), 512)
            or feats["capfeat"].shape != (len(names), 384)
            or not np.allclose(norms, np.sqrt(2.0), atol=1e-5)):
        raise AssertionError(f"class features: {len(feats['names'])} names, clip "
                             f"{feats['clipfeat'].shape}, caption {feats['capfeat'].shape}")
    yml = os.path.join(tmp, "replica_colors.yaml")
    class_tables.write_yaml("replica", yml)
    table = colors.ClassColorMap.from_yaml(yml)
    want = class_tables.for_dataset("replica")
    col_err = max(float(np.abs(table.colors[k] - want.colors[k]).max()) for k in want.colors)
    if (table.mapping != want.mapping or table.names != want.names
            or table.colors.keys() != want.colors.keys() or col_err > 5e-5 + 1e-12
            or any(not np.array_equal(table.color_of(k), want.color_of(k)) for k in want.mapping)):
        raise AssertionError("the replica class table read back differs from for_dataset's")
    have_yaml = importlib.util.find_spec("yaml") is not None
    log(f"[room_0 export] class features {feats['clipfeat'].shape} + "
        f"{feats['capfeat'].shape} for {len(names)} replica names; class table "
        f"{os.path.getsize(yml)} bytes read back by utils.yaml_subset (PyYAML installed "
        f"here: {have_yaml}): mapping and names equal, colours within {col_err:.1e} (4 "
        f"decimals written), uint8 colours equal")

    # ---- the interop (host work): the npz tree to reference .pth files and back ----
    pth, back = os.path.join(tmp, "pth"), os.path.join(tmp, "npz")
    t0 = time.perf_counter()
    to_pth = interop.convert_checkpoint_dir(ckpt, pth, reverse=True)
    t1 = time.perf_counter()
    to_npz = interop.convert_checkpoint_dir(pth, back)
    t2 = time.perf_counter()
    if sorted(os.path.relpath(p, back) for p in to_npz) != rel or len(to_pth) != len(rel):
        raise AssertionError(f"the interop wrote {to_pth} and {to_npz} for {rel}")
    for r in rel:
        with np.load(os.path.join(ckpt, r)) as za, np.load(os.path.join(back, r)) as zb:
            if sorted(za.files) != sorted(zb.files) or not all(
                    za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k])
                    for k in za.files):
                raise AssertionError(f"{r}: npz -> .pth -> npz changed it")
    conv_ms = (1e3 * (t1 - t0) / len(rel), 1e3 * (t2 - t1) / len(rel))
    log(f"[room_0 export] interop: {len(rel)} checkpoints ({rel}) npz -> .pth -> npz, every "
        f"param, box and feature bit-identical; ms per converted checkpoint on the host "
        f"{conv_ms[0]:.1f} (to .pth), {conv_ms[1]:.1f} (to npz)")

    # ---- the export, counted: the .pth tree by the CLI, then the npz tree ----
    bundle = os.path.join(tmp, "map_vis.pkl.gz")
    runs = []
    for how in ("cli", "npz"):
        torch.cuda.synchronize()
        ff.reset_counts()
        profiling.reset_stats()
        t0 = time.perf_counter()
        # (the second run's bundle is compared in memory: the gzip of the
        # 512-d vertex part features costs seconds and is the same code)
        if how == "cli":
            export._main([pth, "--out", bundle, "--grid-dim", "128", "--device", str(device)])
        else:
            b = export.export_from_checkpoints(ckpt, "", grid_dim=128, device=device)
        torch.cuda.synchronize()
        runs.append({"s": time.perf_counter() - t0, "counts": dict(ff.COUNTS),
                     "by_shape": dict(ff.COUNTS_BY_SHAPE), "spans": profiling.stats()})
    # equal bit for bit: the same bytes of every array and value, in order
    t0 = time.perf_counter()
    a = export.load_map_bundle(bundle)
    load_s = time.perf_counter() - t0
    if not a or pickle.dumps(a) != pickle.dumps(export.normalize_bundle(b)):
        raise AssertionError("the exports of the .pth and the npz trees differ")
    want_k1, n_boxed = export_k1_launches(npz_paths, a)
    for run in runs:
        c = run["counts"]
        if c["fused_field_fwd"] != want_k1 or any(v for k, v in c.items()
                                                  if k != "fused_field_fwd"):
            raise AssertionError(f"the export launched {c}; the code implies {want_k1} K1 "
                                 "launches and nothing else")
        if sum(run["by_shape"].values()) != want_k1:
            raise AssertionError(f"launches by shape {run['by_shape']} do not add up")
    by_shape = {}
    for run in runs:
        for k, v in run["by_shape"].items():
            by_shape[k] = by_shape.get(k, 0) + v
    spans = runs[0]["spans"]

    def per_object(name):
        st = spans.get(name)
        if st is None:
            raise AssertionError(f"no '{name}' span: {sorted(spans)}")
        return st["mean_ms"] * st["n"] / n_boxed

    stages = {k: per_object(k) for k in ("export: checkpoint load", "export: mesh")}
    conv_run = spans["export: reference checkpoint conversion"]["mean_ms"] / len(rel)
    n_v = {oid: len(e["mesh"]["vertices"]) for oid, e in a.items()}
    write_s = spans["export: bundle write"]["mean_ms"] / 1e3
    log(f"[room_0 export] export of the .pth tree (viz.export._main, grid 128) "
        f"{runs[0]['s']:.2f} s (with its bundle's write, {write_s:.2f} s for "
        f"{os.path.getsize(bundle)} bytes; load_map_bundle {load_s:.2f} s), of the npz tree "
        f"{runs[1]['s']:.2f} s (in memory); bundles equal bit for "
        f"bit; {len(a)} meshed of {n_boxed} boxed objects, vertices {n_v}; ms per exported "
        f"object: " + ", ".join(f"{k.split(': ')[1]} {v:.1f}" for k, v in stages.items())
        + f" (the .pth tree's conversion {conv_run:.1f} ms per checkpoint); K1 launches "
        f"{want_k1} per run, no other launch; shapes [O, N, h]: launches "
        f"{[[*k[1:], v] for k, v in sorted(runs[0]['by_shape'].items())]}")

    # ---- one object's vertex part features: K1 against the plain field ----
    oid = min(o for o in a if o != 0) if len(a) > 1 else min(a)
    h = 128 if oid == 0 else 32
    template = object_field.init_field_params(torch.Generator(device=device).manual_seed(0),
                                              hidden=h, clip_size=512, scale=1.0,
                                              device=device)
    ck = checkpoint.load_object_checkpoint(os.path.join(ckpt, str(oid), f"obj_{oid}.npz"),
                                           template)
    pts = torch.as_tensor(a[oid]["mesh"]["vertices"] - ck["obj_center"], device=device)
    _, col_k, pf_k = meshing.eval_points_chunked(ck["params"], pts, do_clip=True)
    with plain_field_on_card():
        _, col_p, pf_p = meshing.eval_points_chunked(ck["params"], pts, do_clip=True)
    pf_err = float((pf_k - pf_p).abs().max())
    col_err = float((col_k - col_p).abs().max())
    unit = pf_p / pf_p.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    bundle_err = float(np.abs(a[oid]["part_feat"] - unit.cpu().numpy()).max())
    log(f"[room_0 export] object {oid} (h={h}), {len(pts)} vertices, K1 vs plain on the card: "
        f"part features max abs {pf_err:.2e}, colour {col_err:.2e}, the bundle's unit part "
        f"features from the plain field's {bundle_err:.2e} (limit {FWD_ATOL})")
    if not max(pf_err, col_err, bundle_err) <= FWD_ATOL:
        raise AssertionError("K1's vertex part features disagree with the plain field")

    # ---- the viewer CLI ----
    html = os.path.join(tmp, "map.html")
    plys = os.path.join(tmp, "plys")
    t0 = time.perf_counter()
    viewer.main([bundle, "--out-html", html, "--query", QUERIES[0][0], "--part-query",
                 "leg", "--class-colors", "replica", "--ply-dir", plys, "--encoders", "fake"])
    viewer_s = time.perf_counter() - t0
    with open(html) as f:
        page = f.read()
    if viewer_math.JS_MAT4 not in page or viewer_math.JS_ORBIT_EYE not in page:
        raise AssertionError("the viewer HTML lacks viewer_math's JS")
    written = sorted(os.listdir(plys))
    if written != sorted(f"obj_{o}.ply" for o in a) or not all(
            os.path.getsize(os.path.join(plys, f)) > 0 for f in written):
        raise AssertionError(f"the viewer wrote PLYs {written} for objects {sorted(a)}")
    html_bytes = os.path.getsize(html)
    log(f"[room_0 export] viewer.main: {html_bytes} bytes of HTML (viewer_math's JS "
        f"verbatim), {len(written)} PLYs, {viewer_s:.2f} s")

    # ---- the query server over HTTP ----
    clip_enc, sbert_enc = viewer.make_encoders("fake")
    service = server.QueryService(a, clip_enc, sbert_enc, class_colors=table)
    httpd = server.make_server(service, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=600) as r:
            if r.status != 200:
                raise AssertionError(f"GET {path}: {r.status}")
            return r.read()

    query_ms = []
    try:
        if get("/").decode() != service.html():
            raise AssertionError("GET / differs from QueryService.html()")
        if json.loads(get("/objects")) != service.objects():
            raise AssertionError("GET /objects differs from QueryService.objects()")
        for _ in range(HTTP_ROUNDS):
            for text, part, topk in QUERIES:
                path = f"/query?text={urllib.parse.quote(text)}" + \
                    (f"&part={urllib.parse.quote(part)}" if part else "") + \
                    (f"&topk={topk}" if topk else "")
                t0 = time.perf_counter()
                got = json.loads(get(path))
                query_ms.append(1e3 * (time.perf_counter() - t0))
                if got != service.query(text, part=part, topk=topk):
                    raise AssertionError(f"GET {path} differs from QueryService.query")
                if part is None:
                    scores = query.query_objects(text, a, clip_enc, sbert_enc)
                    baked = viewer.bake_object_query(a, scores, top_k=topk)
                    if got["colors"] != {str(o): viewer._b64(c) for o, c in baked.items()}:
                        raise AssertionError(f"GET {path}: colouring differs from "
                                             "bake_object_query's")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("the query server did not stop")
    log(f"[room_0 export] query server on 127.0.0.1: GET / ({len(service.html())} bytes) and "
        f"/objects equal to the direct calls; {len(query_ms)} GET /query "
        f"({len(QUERIES)} queries x {HTTP_ROUNDS}, with &part= and &topk=) equal to "
        f"QueryService.query, object colourings equal to bake_object_query's; ms per HTTP "
        f"query median {float(np.median(query_ms)):.1f} (min {min(query_ms):.1f}, max "
        f"{max(query_ms):.1f})")
    log(f"[room_0 export] phase 4f took {time.perf_counter() - t_all:.1f} s")
    return {"by_shape": by_shape, "k1_per_run": want_k1, "objects": len(a),
            "stages_ms": stages, "conv_ms": conv_ms, "html_bytes": html_bytes,
            "query_ms": float(np.median(query_ms))}


# --------------------------------------------------------------------------- #
# phase 4g: a ScanNet scan on disk, through run_scenes
# --------------------------------------------------------------------------- #

# ITU-T T.81 Annex K: the example quantisation tables (natural order) and
# Huffman tables (BITS, HUFFVAL), which libjpeg writes by default
ANNEX_K_Q = (np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]),
    np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4
             + [24, 26, 56] + [99] * 5 + [47, 66] + [99] * 38))
ANNEX_K_HUFF = {   # (class, slot): (BITS, HUFFVAL)
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], bytes(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], bytes(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
        "535455565758595a636465666768696a737475767778797a838485868788898a"
        "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
        "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}
ZIGZAG = np.array([    # zigzag index -> natural index (jpeg_natural_order)
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_BITLEN = np.array([int(i).bit_length() for i in range(1 << 12)])


def jpeg_quant_tables(quality: int) -> list[np.ndarray]:
    """Annex K's tables scaled as libjpeg's jpeg_set_quality does (forced
    to baseline: each entry in [1, 255])."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [np.clip((q * scale + 50) // 100, 1, 255) for q in ANNEX_K_Q]


def _huff_codes(bits, vals):
    """(code, length) of every symbol of a canonical table (T.81 C.2)."""
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(bits, 1):
        for _ in range(n):
            code_of[vals[k]], len_of[vals[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """Baseline JFIF JPEG of a uint8 [H, W, 3] RGB image: 4:2:0 (Y 2x2, Cb and
    Cr 1x1), Annex K's tables scaled to ``quality``, a float DCT. The chip's
    machine has no JPEG writer; this one writes the colour frames of phase
    4g's ScanNet scan, in numpy (the Huffman coding vectorised over tokens)."""
    h, w = rgb.shape[:2]
    my, mx = -(-h // 16), -(-w // 16)
    x = np.pad(rgb.astype(np.float64), ((0, 16 * my - h), (0, 16 * mx - w), (0, 0)), mode="edge")
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    ycc = [0.299 * r + 0.587 * g + 0.114 * b,
           -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0,
           0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0]
    ycc[1:] = [c.reshape(8 * my, 2, 8 * mx, 2).mean(axis=(1, 3)) for c in ycc[1:]]
    u = np.arange(8)
    dct = np.sqrt(np.where(u == 0, 1.0, 2.0) / 8)[:, None] * np.cos(
        (2 * u[None, :] + 1) * u[:, None] * np.pi / 16)
    qts = jpeg_quant_tables(quality)
    blocks = []
    for c, plane in enumerate(ycc):
        bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
        f = (plane - 128.0).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = (dct @ f @ dct.T).reshape(bh, bw, 64)
        zz = np.round(coef / qts[min(c, 1)])[..., ZIGZAG].astype(np.int64)
        if c == 0:      # the four Y blocks of each MCU, in raster order
            zz = zz.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, 4, 64)
        blocks.append(zz.reshape(my * mx, -1, 64))
    seq = np.concatenate(blocks, axis=1).reshape(-1, 64)       # stream order
    comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)
    codes = {k: _huff_codes(*v) for k, v in ANNEX_K_HUFF.items()}
    dc_code = np.stack([codes[(0, min(c, 1))][0] for c in range(3)])[comp]
    dc_len = np.stack([codes[(0, min(c, 1))][1] for c in range(3)])[comp]
    ac_code = np.stack([codes[(1, min(c, 1))][0] for c in range(3)])[comp]
    ac_len = np.stack([codes[(1, min(c, 1))][1] for c in range(3)])[comp]

    def extra(v):            # magnitude category and its extra bits
        s = _BITLEN[np.abs(v)]
        return s, np.where(v >= 0, v, v + (1 << s) - 1)

    keys, vals, lens = [], [], []
    nb = np.arange(len(seq))
    dc = seq[:, 0].copy()
    for c in range(3):
        sel = comp == c
        dc[sel] = np.diff(seq[sel, 0], prepend=0)
    s, e = extra(dc)
    keys.append(nb * 4096)
    vals.append((dc_code[nb, s] << s) | e)
    lens.append(dc_len[nb, s] + s)
    bi, ki = np.nonzero(seq[:, 1:])
    ki = ki + 1
    first = np.r_[True, bi[1:] != bi[:-1]]
    prev = np.where(first, 0, np.r_[0, ki[:-1]])
    run = ki - prev - 1
    s, e = extra(seq[bi, ki])
    for z in range(3):      # ZRL (16 zeros) before a coefficient, up to 3
        sel = run // 16 > z
        keys.append(bi[sel] * 4096 + ki[sel] * 16 + z)
        vals.append(ac_code[bi[sel], 0xF0])
        lens.append(ac_len[bi[sel], 0xF0])
    sym = (run % 16) * 16 + s
    keys.append(bi * 4096 + ki * 16 + 15)
    vals.append((ac_code[bi, sym] << s) | e)
    lens.append(ac_len[bi, sym] + s)
    last = np.zeros(len(seq), np.int64)
    last[bi] = ki                          # nonzero order is ascending k
    eob = nb[last < 63]
    keys.append(eob * 4096 + 4095)
    vals.append(ac_code[eob, 0x00])
    lens.append(ac_len[eob, 0x00])
    order = np.argsort(np.concatenate(keys), kind="stable")
    vals, lens = np.concatenate(vals)[order], np.concatenate(lens)[order]
    tok = np.repeat(np.arange(len(lens)), lens)
    pos = np.arange(len(tok)) - np.repeat(np.cumsum(lens) - lens, lens)
    stream = ((vals[tok] >> (lens[tok] - 1 - pos)) & 1).astype(np.uint8)
    stream = np.r_[stream, np.ones(-len(stream) % 8, np.uint8)]   # pad with 1s
    data = np.packbits(stream)
    data = np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0)  # byte stuffing

    def segment(marker, payload):
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload

    head = segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t, q in enumerate(qts):
        head += segment(0xDB, bytes([t]) + bytes(q[ZIGZAG].astype(np.uint8)))
    head += segment(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                    + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for (tc, th), (bits, hv) in ANNEX_K_HUFF.items():
        head += segment(0xC4, bytes([tc << 4 | th]) + bytes(bits) + hv)
    head += segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return b"\xff\xd8" + head + data.tobytes() + b"\xff\xd9"


# the scan: ScanNet's colour and depth cameras, the raw frames it holds
# (frames 0, 10 and 20 train at scene0011_01.json's stride 10), the phase's
# gate on each frame's decode against its source, and the matched instance
# mIoU of the CPU rehearsal of its perception (rehearse_scannet, below)
SCANNET_SCENE = "scene0011_01"
SCANNET_COLOUR, SCANNET_DEPTH = (968, 1296), (480, 640)
SCANNET_RAW_FRAMES, SCANNET_PSNR_DB = 21, 35.0
SCANNET_CPU_MIOU, SCANNET_MIOU_TOL = 0.9827623919138745, 0.02
JPEG_FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg")
PNG_FIXTURES = os.path.join(ROOT, "tests", "data", "png")


def free_port() -> int:
    """A TCP port on 127.0.0.1 free at the time of the call."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_scannet_scan(raw, dest) -> dict:
    """Phase 4d's raw tabletop frames laid out as the ScanNet scan
    ``scene0011_01`` under ``dest``: colour resized to 968x1296 with the
    port's resize and written as baseline 4:2:0 q95 JPEGs by encode_jpeg,
    depth resized nearest to 480x640 (uint16 PNG), the depth camera's
    intrinsics scaled from room_0's, the poses, and the ground-truth
    instance maps (frames 0, 10, 20) resized nearest and held aside. Each
    JPEG decoded by the port is gated against its source frame (PSNR)."""
    from openobj_torch.data.transforms import resize
    from openobj_torch.utils import jpeg
    from openobj_torch.utils.png import read_png, write_png

    cam, src = raw["cam"], raw["root"]
    root = os.path.join(dest, SCANNET_SCENE)
    for d in ("color", "depth", "intrinsic"):
        os.makedirs(os.path.join(root, d))
    (hc, wc), (hd, wd) = SCANNET_COLOUR, SCANNET_DEPTH
    enc_ms, psnr, nbytes = [], [], 0
    for i in range(SCANNET_RAW_FRAMES):
        colour = resize(read_png(os.path.join(src, "rgb", f"rgb_{i}.png")), (wc, hc))
        t0 = time.perf_counter()
        data = encode_jpeg(colour, quality=95)
        enc_ms.append(1e3 * (time.perf_counter() - t0))
        path = os.path.join(root, "color", f"{i}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        nbytes += len(data)
        err = jpeg.read_jpeg(path).astype(np.float64) - colour
        psnr.append(float(10 * np.log10(255.0 ** 2 / max(np.mean(err ** 2), 1e-12))))
        depth = read_png(os.path.join(src, "depth", f"depth_{i}.png"))
        write_png(os.path.join(root, "depth", f"{i}.png"), resize(depth, (wd, hd), nearest=True))
    poses = np.loadtxt(os.path.join(src, "traj_w_c.txt")).reshape(-1, 16)
    np.savetxt(os.path.join(root, "traj_w_c.txt"), poses[:SCANNET_RAW_FRAMES], delimiter=" ")
    sx, sy = wd / cam.width, hd / cam.height
    k = np.eye(4)
    k[0, 0], k[1, 1] = cam.fx * sx, cam.fy * sy
    k[0, 2], k[1, 2] = (cam.cx + 0.5) * sx - 0.5, (cam.cy + 0.5) * sy - 0.5
    np.savetxt(os.path.join(root, "intrinsic", "intrinsic_depth.txt"), k)
    gt = [resize(g.astype(np.uint16), (wd, hd), nearest=True).astype(np.int32)
          for g in raw["gt_maps"]]
    if min(psnr) <= SCANNET_PSNR_DB:
        raise AssertionError(f"[scannet] a decoded frame {min(psnr):.2f} dB from its source, "
                             f"gate {SCANNET_PSNR_DB}")
    log(f"[scannet] {SCANNET_RAW_FRAMES} frames laid out as ScanNet {SCANNET_SCENE}: colour "
        f"{hc}x{wc} baseline 4:2:0 q95 by encode_jpeg ({nbytes / SCANNET_RAW_FRAMES / 1e3:.1f} "
        f"kB, {np.median(enc_ms):.1f} ms a frame), decoded by the port {min(psnr):.2f}-"
        f"{max(psnr):.2f} dB from the source (gate > {SCANNET_PSNR_DB}); depth {hd}x{wd}")
    return {"root": root, "gt_maps": gt, "gt_frames": [ASSOC_STRIDE * j for j in range(len(gt))],
            "psnr_min": min(psnr)}


# the committed progressive and arithmetic-coded ScanNet-size fixtures, timed
# in phase 4g beside the scan's baseline frames, and the times each is decoded
JPEG_PROGRESSIVE = "tabletop_968x1296_q95_420_progressive.jpg"
JPEG_ARITH = {"arith": "tabletop_968x1296_q95_420_arith.jpg",
              "arith_progressive": "tabletop_968x1296_q95_420_arith_progressive.jpg"}
JPEG_PROGRESSIVE_REPS = 3


def _card() -> str:
    """The card's name and power limit as nvidia-smi gives them ("not
    measured" where nvidia-smi is missing, as in the CPU rehearsal)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "card not measured"


def _decode_timed(data: bytes) -> tuple[np.ndarray, float, float]:
    """One decode: the RGB image, ms of parse + entropy decode (native),
    ms of the rest (smoothing, IDCT, upsampling, colour, orientation;
    numpy)."""
    from openobj_torch.utils import jpeg

    t0 = time.perf_counter()
    frame = jpeg.parse(data)
    coefs = jpeg.entropy_decode(frame, data)
    t1 = time.perf_counter()
    rgb = jpeg.orient(jpeg.reconstruct(frame, coefs), frame.orientation)
    t2 = time.perf_counter()
    return rgb, 1e3 * (t1 - t0), 1e3 * (t2 - t1)


def _decode_ms(data: bytes) -> tuple[float, float]:
    return _decode_timed(data)[1:]


def _sha256(im: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(im).tobytes()).hexdigest()


def check_png_reader() -> None:
    """The committed PNG fixtures (palette, low-bit grey, Adam7, tRNS,
    16-bit) read to the stored digests of OpenCV's decode, unchanged and
    as colour."""
    from openobj_torch.utils import png

    with open(os.path.join(PNG_FIXTURES, "digests.json")) as f:
        want = json.load(f)
    for name, modes in want.items():
        for mode, entry in modes.items():
            im = png.read_png(os.path.join(PNG_FIXTURES, name), colour=mode == "colour")
            got = {"shape": list(im.shape), "dtype": str(im.dtype), "sha256": _sha256(im)}
            if got != entry:
                raise AssertionError(f"[scannet] PNG fixture {name} ({mode}): {got}, OpenCV's "
                                     f"decode {entry}")
    log(f"[scannet] PNG fixtures {sorted(want)} read equal to their digests of OpenCV's decode, "
        "unchanged and as colour")


def check_jpeg_decoder(root) -> dict:
    """The committed fixtures (baseline, progressive, arithmetic-coded,
    lossless, smoothed, EXIF orientation 6, CMYK, YCCK) decoded to the
    stored SHA-256 of OpenCV's decode (shape too), the PNG fixtures
    likewise, then ms per decoded 968x1296 JPEG, entropy decode (native)
    and the rest (IDCT, upsampling, colour; numpy): medians over the scan's
    baseline frames, and over JPEG_PROGRESSIVE_REPS decodes of the
    progressive and of each arithmetic-coded fixture (the first of them the
    digest's), with the card's name and power limit (the decode runs on the
    host)."""
    from openobj_torch.utils import jpeg

    with open(os.path.join(JPEG_FIXTURES, "digests.json")) as f:
        want = json.load(f)
    timed = {}
    for name, entry in want.items():
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
            data = f.read()
        rgb, *ms = _decode_timed(data)
        if list(rgb.shape) != entry["shape"] or _sha256(rgb) != entry["sha256"]:
            raise AssertionError(f"[scannet] fixture {name}: {rgb.shape} {_sha256(rgb)}, "
                                 f"OpenCV's decode {entry['shape']} {entry['sha256']}")
        if name in JPEG_ARITH.values():
            if not jpeg.parse(data).arithmetic:
                raise AssertionError(f"[scannet] {name} is not arithmetic-coded")
            timed[name] = [ms] + [_decode_ms(data) for _ in range(JPEG_PROGRESSIVE_REPS - 1)]
    check_png_reader()
    times = []
    for i in range(SCANNET_RAW_FRAMES):
        with open(os.path.join(root, "color", f"{i}.jpg"), "rb") as f:
            times.append(_decode_ms(f.read()))
    with open(os.path.join(JPEG_FIXTURES, JPEG_PROGRESSIVE), "rb") as f:
        data = f.read()
    if not jpeg.parse(data).progressive:
        raise AssertionError(f"[scannet] {JPEG_PROGRESSIVE} is not progressive")
    prog = [_decode_ms(data) for _ in range(JPEG_PROGRESSIVE_REPS)]
    res = {"entropy_ms": float(np.median([t[0] for t in times])),
           "rest_ms": float(np.median([t[1] for t in times])),
           "progressive_entropy_ms": float(np.median([t[0] for t in prog])),
           "progressive_rest_ms": float(np.median([t[1] for t in prog]))}
    for key, name in JPEG_ARITH.items():
        res[f"{key}_entropy_ms"] = float(np.median([t[0] for t in timed[name]]))
        res[f"{key}_rest_ms"] = float(np.median([t[1] for t in timed[name]]))

    def both(key):
        return (f"{res[key + '_entropy_ms'] + res[key + '_rest_ms']:.1f} = entropy decode "
                f"{res[key + '_entropy_ms']:.1f} + the rest {res[key + '_rest_ms']:.1f}")

    size = f"{SCANNET_COLOUR[0]}x{SCANNET_COLOUR[1]}"
    log(f"[scannet] JPEG fixtures {sorted(want)} decoded equal to their digests of OpenCV's "
        f"decode; ms per decoded {size} JPEG on the host of {_card()}: baseline (median of "
        f"{SCANNET_RAW_FRAMES}) {res['entropy_ms'] + res['rest_ms']:.1f} = entropy decode "
        f"{res['entropy_ms']:.1f} + the rest {res['rest_ms']:.1f}; progressive {JPEG_PROGRESSIVE} "
        f"(median of {JPEG_PROGRESSIVE_REPS}) {both('progressive')}; arithmetic-coded (median of "
        f"{JPEG_PROGRESSIVE_REPS} each) {JPEG_ARITH['arith']} {both('arith')}; progressive "
        f"{JPEG_ARITH['arith_progressive']} {both('arith_progressive')}")
    return res


def scannet_miou(root, scan) -> dict:
    """Matched instance mIoU of the written instance maps at the frames
    with held-aside ground truth (every raw frame is a keyframe here)."""
    return written_miou(root, scan["gt_frames"], scan["gt_maps"])


def run_scannet(device, raw) -> dict:
    """Phase 4g: a ScanNet scan on disk through the port's run_scenes, on
    an unedited copy of configs/scannet/scene0011_01.json: auto perception
    from the JPEG and PNG frames, train.main through K1/K2/K2r, the export
    through K1 and summary.json, joined by NCCL as a group of one (its
    barrier on the card after); then multislice.run_parallel on one device
    group. Counts reset around run_scenes; the perception and the export
    are timed and counted by wrapping the functions run_scenes calls."""
    import torch
    import torch.distributed as dist
    from openobj_torch import config as oconfig
    from openobj_torch.data import loaders
    from openobj_torch.ops import fused_field as ff
    from openobj_torch.parallel import distributed, multislice
    from openobj_torch.scripts import run_scenes
    from openobj_torch.utils import profiling
    from openobj_torch.viz import export

    t_all = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="scannet_", dir=os.path.dirname(raw["root"]))
    scan = write_scannet_scan(raw, os.path.join(tmp, "data"))
    dec = check_jpeg_decoder(scan["root"])
    cfg_dir = os.path.join(tmp, "configs")
    os.makedirs(cfg_dir)
    shutil.copy(os.path.join(ROOT, "configs", "scannet", f"{SCANNET_SCENE}.json"), cfg_dir)
    out = os.path.join(tmp, "runs")

    seen = {}
    run_perception, export_from_checkpoints = run_scenes.run_perception, export.export_from_checkpoints

    def timed_perception(cfg_path, args):
        profiling.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_perception(cfg_path, args)
        torch.cuda.synchronize()
        seen["perception_s"] = time.perf_counter() - t0
        seen["spans"] = profiling.stats()
        seen["counts_perception"] = dict(ff.COUNTS)

    def counted_export(*a, **kw):
        torch.cuda.synchronize()
        seen["counts_train"] = dict(ff.COUNTS)
        t0 = time.perf_counter()
        bundle = export_from_checkpoints(*a, **kw)
        torch.cuda.synchronize()
        seen["export_s"] = time.perf_counter() - t0
        seen["counts_export"] = {k: v - seen["counts_train"][k] for k, v in ff.COUNTS.items()}
        seen["bundle"] = bundle
        return bundle

    port = free_port()
    run_scenes.run_perception, export.export_from_checkpoints = timed_perception, counted_export
    try:
        torch.cuda.synchronize()
        ff.reset_counts()
        t0 = time.perf_counter()
        summary = run_scenes.main([
            cfg_dir, "--data-root", os.path.dirname(scan["root"]), "--out", out,
            "--perception", "auto", "--max-frames", "3", "--device", "cuda",
            "--distributed", f"127.0.0.1:{port}", "--num-processes", "1", "--process-id", "0"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        by_shape = dict(ff.COUNTS_BY_SHAPE)
        if dist.get_backend() != "nccl" or distributed.process_scene_shard() != "0:1":
            raise AssertionError(f"[scannet] process group {dist.get_backend()}, shard "
                                 f"{distributed.process_scene_shard()}")
        distributed.barrier("scannet")
    finally:
        run_scenes.run_perception, export.export_from_checkpoints = (run_perception,
                                                                     export_from_checkpoints)
        if dist.is_initialized():
            dist.destroy_process_group()

    # ---- one device group: the worker thread's current card ----
    groups = multislice.device_groups(1)
    [probe] = multislice.run_parallel(
        [("probe", lambda devs: (torch.cuda.current_device(), torch.zeros(1, device="cuda").device,
                                 devs))], groups=groups)
    if not probe.ok or probe.result[0] != groups[0][0].index or \
            probe.result[1] != groups[0][0] or probe.result[2] != groups[0]:
        raise AssertionError(f"[scannet] run_parallel over {groups}: {probe}")

    # ---- gates ----
    entry = summary.get(SCANNET_SCENE, {})
    logdir = os.path.join(out, SCANNET_SCENE)
    with open(os.path.join(logdir, "summary.json")) as f:
        written = json.load(f)
    frames = sorted(k for k in written.get("timing", {}) if k.startswith("frame "))
    if entry.get("status") != "ok" or written != entry or entry.get("objects", 0) < 1 \
            or frames != ["frame 0", "frame 1", "frame 2"] \
            or not os.path.exists(os.path.join(logdir, "map_vis.pkl.gz")):
        raise AssertionError(f"[scannet] summary {entry.get('status')}, objects "
                             f"{entry.get('objects')}, frames {frames}")
    if any(seen["counts_perception"].values()):
        raise AssertionError(f"[scannet] the perception launched {seen['counts_perception']}")
    c_train, c_export = seen["counts_train"], seen["counts_export"]
    steps = 2 * 100 * 3
    for k in ("fused_field_fwd", "fused_field_bwd", "fused_field_bwd_reduce"):
        if c_train[k] != steps:
            raise AssertionError(f"[scannet] training launched {k} {c_train[k]} times, "
                                 f"expected {steps}")
    if c_train["field_eager"] or c_train["fused_field_plain"]:
        raise AssertionError(f"[scannet] training left the kernels: {c_train}")
    npz_paths = sorted(glob.glob(os.path.join(logdir, "ckpt", "*", "obj_*.npz")))
    want_k1, n_boxed = export_k1_launches(npz_paths, seen["bundle"])
    if c_export["fused_field_fwd"] != want_k1 or any(
            v for k, v in c_export.items() if k != "fused_field_fwd"):
        raise AssertionError(f"[scannet] the export launched {c_export}; the code implies "
                             f"{want_k1} K1 launches and nothing else")
    score = scannet_miou(scan["root"], scan)
    if abs(score["inst_miou"] - SCANNET_CPU_MIOU) > SCANNET_MIOU_TOL:
        raise AssertionError(f"[scannet] instance mIoU {score['inst_miou']:.4f}, the CPU "
                             f"rehearsal's {SCANNET_CPU_MIOU} (tolerance {SCANNET_MIOU_TOL})")

    # ---- frames loaded and trained ----
    scfg = oconfig.load_scene_config(os.path.join(logdir, "config.json"))
    dataset = loaders.make_dataset(scfg)
    load_ms = []
    for i in range(len(dataset)):
        t0 = time.perf_counter()
        dataset[i]
        load_ms.append(1e3 * (time.perf_counter() - t0))
    trained = [written["timing"][f"frame {i}"] for i in (1, 2)]
    spans = seen["spans"]
    n_kf = SCANNET_RAW_FRAMES       # count_raw_frames reads rgb/*.png: skip 1

    def per_keyframe(name):
        st = spans.get(name)
        if st is None:
            raise AssertionError(f"[scannet] no '{name}' span: {sorted(spans)}")
        return st["mean_ms"] * st["n"] / n_kf

    res = {"by_shape": by_shape, "objects": entry["objects"], "run_s": run_s,
           "perception_s": seen["perception_s"], "export_s": seen["export_s"],
           "export_k1": want_k1, "maskgen_ms": per_keyframe("maskgen: frame"),
           "assoc_ms": per_keyframe("associate: association"),
           "sim_ms": per_keyframe("association: similarity matrices"),
           "load_ms_per_frame": float(np.mean(load_ms)),
           "train_ms_per_frame": float(np.mean(trained)), "inst_miou": score["inst_miou"],
           "bg_iou": score["bg_iou"], **dec}
    log(f"[scannet] run_scenes {run_s:.1f} s (NCCL group of one, shard 0:1, barrier on the "
        f"card): perception {seen['perception_s']:.1f} s over {n_kf} keyframes (skip 1: "
        f"count_raw_frames reads rgb/*.png), ms per keyframe: maskgen {res['maskgen_ms']:.1f}, "
        f"association {res['assoc_ms']:.1f} (similarity matrices on the card "
        f"{res['sim_ms']:.1f}); ms per loaded frame {res['load_ms_per_frame']:.1f} "
        f"({[round(x, 1) for x in load_ms]}), per trained frame (frames 2-3, timing.json) "
        f"{res['train_ms_per_frame']:.1f} ({trained}); K1/K2/K2r {steps} each in training, "
        f"nothing plain or eager; export {seen['export_s']:.2f} s, {entry['objects']} objects "
        f"({n_boxed} boxed), K1 {want_k1} launches as the code implies; matched instance "
        f"mIoU at frames {scan['gt_frames']} {score['inst_miou']:.4f} (CPU rehearsal "
        f"{SCANNET_CPU_MIOU}; background IoU {score['bg_iou']:.4f}; {score['matches']}); "
        f"run_parallel over {[[str(d) for d in g] for g in groups]}: the worker's current "
        f"card {probe.result[0]}")
    log(f"[scannet] phase 4g took {time.perf_counter() - t_all:.1f} s")
    return res


def rehearse_scannet() -> float:
    """The CPU rehearsal of phase 4g's perception: phase 4d's raw frames
    written again, laid out as the same scan, ``run_auto_perception`` with
    scene0011_01.json's settings on the CPU, and the matched instance mIoU
    it gives (SCANNET_CPU_MIOU above). Run from the root of a checkout:
    ``python3 -c "import chip_smoke; chip_smoke.rehearse_scannet()"``."""
    from openobj_torch import config as oconfig
    from openobj_torch.perception import auto

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="scannet_rehearsal_", dir=os.path.join(ROOT, "build"))
    try:
        raw = write_room0_raw(tmp)
        scan = write_scannet_scan(raw, os.path.join(tmp, "data"))
        check_jpeg_decoder(scan["root"])
        with open(os.path.join(ROOT, "configs", "scannet", f"{SCANNET_SCENE}.json")) as f:
            cfg = json.load(f)
        cfg["dataset"]["path"] = scan["root"]
        cfg_path = os.path.join(tmp, "scannet.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        t0 = time.perf_counter()
        auto.run_auto_perception(oconfig.load_scene_config(cfg_path), device="cpu")
        score = scannet_miou(scan["root"], scan)
        log(f"[scannet rehearsal] perception on the CPU {time.perf_counter() - t0:.1f} s; "
            f"matched instance mIoU at frames {scan['gt_frames']} {score['inst_miou']!r} "
            f"(background IoU {score['bg_iou']:.4f}; {score['matches']})")
        return score["inst_miou"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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

    phase_s = {}

    def phase(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = round(time.perf_counter() - t, 1)
        log(f"[time] phase {name}: {phase_s[name]} s")
        return out

    t0 = time.perf_counter()
    secs = phase("1 build", kernels.build, verbose=True)
    log(f"[build] {secs} ({time.perf_counter() - t0:.1f} s)")

    per = phase("2 kernels", check_kernels, device, (FG, BG) + OTHER_WIDTHS)
    per.update(phase("2 kernels bf16", check_kernels_bf16, device, (FG, BG)))
    per["fused_field_bwd_reduce"] += per.pop("reduce_bf16")   # K2r over the bf16 slots
    adamw = phase("2 kernels adamw", check_adamw_flat, device, smi)["adamw_flat"]
    phase("3 convergence", check_convergence, device)
    phase("3 steps", check_steps_vs_cpu, device)
    by_shape_main, cfg, mapper, frames, vecs, flat = phase("4 main", run_main_path, device,
                                                           profile=args.profile)
    k1_output_rows, by_shape_out = phase("4b outputs", run_outputs, device, cfg, mapper, frames)
    bf16 = phase("4h room_0 bf16", run_room0_bf16, device, frames, vecs, mapper)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    sharded = phase("4i room_0 sharded", run_room0_sharded, device, cfg, mapper, frames, vecs)
    del mapper, frames
    torch.cuda.empty_cache()
    syn = phase("4c synthetic", run_synthetic_scene, device)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    raw_dir = tempfile.mkdtemp(prefix="room0_raw_", dir=os.path.join(ROOT, "build"))
    try:
        raw = phase("4d raw frames", write_room0_raw, raw_dir)
        disk = phase("4d disk", run_room0_from_disk, device, raw)
        auto = phase("4e auto", run_room0_auto, device, raw)
        exported = phase("4f export", run_room0_export, device, auto["logdir"])
        scannet = phase("4g scannet", run_scannet, device, raw)
    finally:
        shutil.rmtree(raw_dir, ignore_errors=True)
    # the synthetic scene's trained shapes at widths other than the main
    # path's (its bg field, h=64)
    other = sorted({(o, n, h) for (k, o, n, h) in syn["by_shape"]
                    if k == "fused_field_bwd" and h not in (FG["h"], BG["h"])})
    per_syn = phase("4c kernels", check_kernels, device,
                    [dict(name=f"synthetic_bg{h}", o=o, n=n, h=h) for o, n, h in other])
    probe_rows = phase("5 probes", run_probe_path, device)

    replaces = {
        "fused_field_fwd": "openobj_tpu/ops/fused_field.py:160",
        "fused_field_bwd": "openobj_tpu/ops/fused_field.py:172",
        "fused_field_bwd_reduce": "openobj_tpu/ops/fused_field.py:285",
        "fused_field_fwd_bf16": "openobj_tpu/ops/fused_field.py:160",
        "fused_field_bwd_bf16": "openobj_tpu/ops/fused_field.py:172",
        # the weights' astype(cdt) in _bwd_kernel's mmBT
        "fused_field_bwd_bf16_image": "openobj_tpu/ops/fused_field.py:200",
    }
    # K1 bf16, K2 bf16 and its weight conversion are the bf16 build's own
    # kernels (csrc/fused_field_bf16.cu)
    sources = {"fused_field_fwd_bf16": "fused_field_fwd_bf16.cuh",
               "fused_field_bwd_bf16": "fused_field_bwd_bf16.cuh",
               "fused_field_bwd_bf16_image": "fused_field_bwd_bf16.cuh"}
    # launches as counted in each run, by (count, O, N, h)
    paths = {"room_0 training": by_shape_main, "room_0 outputs": by_shape_out,
             "synthetic scene": syn["by_shape"], "room_0 from disk": disk["by_shape"],
             "room_0 auto perception": auto["by_shape"],
             "room_0 export": exported["by_shape"], "scannet": scannet["by_shape"],
             "room_0 bf16": bf16["by_shape"], "room_0 sharded": sharded["by_shape"],
             "room_0 sharded mapper": sharded["mapper_shapes"],
             "room_0 sharded render": sharded["render_shapes"], "room_0 flat": flat["by_shape"],
             **{f"room_0 bf16 {k}": v for k, v in bf16["by_shape_options"].items()}}

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
                 for s in every + per_syn.get(name, [])]
        if name == "fused_field_fwd":
            timed += k1_output_rows
        if name == "fused_field_fwd_bf16":
            timed += bf16["k1_rows"]
        by_path = {p: sum(v for k, v in bs.items() if k[0] == name) for p, bs in paths.items()}
        rows.append({
            "name": name, "route": "cuda",
            "source": "openobj_torch/csrc/" + sources.get(name, "fused_field.cu"),
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
        if name == "fused_field_fwd_bf16":   # the gate's measure beside the max abs
            rows[-1]["off_share"] = {s["shape"]: s["off"] for s in shapes}
            rows[-1]["launch"] = {s["shape"]: s["launch"] for s in shapes}
        if name in ("fused_field_fwd", "fused_field_fwd_bf16"):   # beside the bound
            rows[-1]["encode_floor_ms"] = sum(s["encode_floor"] for s in shapes)
    # the flat AdamW kernel: one launch a model a step (fg + bg summed, as
    # the field's rows); not a Pallas site, the JAX function it ports
    rows.append({
        "name": "adamw_flat", "route": "cuda", "source": "openobj_torch/csrc/adamw_flat.cu",
        "replaces": "openobj_tpu/core/optim.py:121", "launches": flat["launches"],
        "launches_by_path": {"room_0 flat": flat["launches"]},
        "max_abs_err": max(r["err"] for r in adamw),
        "ms": sum(r["ms"] for r in adamw), "plain_ms": sum(r["plain_ms"] for r in adamw),
        "bound_ms": sum(r["bound"][0] for r in adamw),
        "bound_by": max(r["bound"] for r in adamw)[1],
        "library_ms": (None if any(r["library_ms"] is None for r in adamw)
                       else sum(r["library_ms"] for r in adamw)),
        # the per-leaf tree update of the same step: CUDA events around it,
        # and its kernels' device time summed
        "tree_ms": sum(r["tree_ms"] for r in adamw),
        "tree_busy_ms": sum(r["tree_busy_ms"] for r in adamw),
        "per_shape": [{k: v for k, v in r.items() if k != "bound"}
                      | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]} for r in adamw],
    })
    rows += probe_rows
    log(f"[time] phases {phase_s}")
    log(f"[time] chip_smoke.py {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
