"""The probe kernels: the ensemble GEMM, launch, streaming, fused-chain and
part-term probes of the fused-step and part-term designs.

Port of the Pallas kernels in ``scripts/bench_ensemble_mm.py`` (K3) and
``scripts/bench_fused_step_probe.py`` (K4). Each function below has a plain
PyTorch version (``*_plain``, the reference) and a hand-written CUDA kernel
in ``openobj_torch/csrc/probes.cu`` (``*_cuda``). The dispatching function
runs the plain version on a CPU tensor and the kernel on a CUDA tensor; a
CUDA tensor never takes the plain path.

``COUNTS`` holds the launches of each kernel variant, and the calls of the
plain versions through the dispatching functions, as plain ints. A call
made while a CUDA graph is being captured records the kernel into the graph
and launches nothing, so it is not counted; neither are the graph's
replays.
"""

from __future__ import annotations

import ctypes

import torch

_F32 = torch.float32

SCHEDULES = ("grid", "objtile", "persistent")
PART_MODES = ("tg", "dw", "quad")
CHAIN_DEPTHS = (0, 1, 4)      # the depths the probe scripts use

# launches of each kernel variant (and calls of the plain versions)
COUNTS: dict[str, int] = {}


def kernel_names() -> list[str]:
    """Every count key of a kernel variant the probe scripts launch."""
    names = [f"ens_gemm_{s}{sfx}" for sfx in ("", "_sin") for s in SCHEDULES]
    names += ["launch_nop", "slab_stream"]
    names += [f"step_chain_d{d}" for d in CHAIN_DEPTHS]
    names += [f"part_term_{m}" for m in PART_MODES]
    return names


def reset_counts() -> None:
    COUNTS.clear()
    COUNTS.update({k: 0 for k in kernel_names()})
    COUNTS["probes_plain"] = 0


reset_counts()


def _count(key: str) -> None:
    if not torch.cuda.is_current_stream_capturing():
        COUNTS[key] = COUNTS.get(key, 0) + 1


# --------------------------------------------------------------------------- #
# plain versions (the probe scripts' math, in PyTorch)
# --------------------------------------------------------------------------- #


def ens_gemm_plain(x: torch.Tensor, w: torch.Tensor, sin: bool = False) -> torch.Tensor:
    """out[o] = f(x[o]) w[o], f = sin or identity; x [O,N,K], w [O,K,H]."""
    return torch.einsum("onk,okh->onh", torch.sin(x) if sin else x, w)


def launch_nop_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def slab_stream_plain(xs: torch.Tensor, w0: torch.Tensor, h: int) -> torch.Tensor:
    """q2's output: w0[:, :1, :h] * 1.000001 for every step; xs [S,O,R,DX]
    (streamed by the kernel, unused by the result), w0 [O,DX,K] ->
    [S,O,1,h]."""
    s = xs.shape[0]
    return (w0[:, :1, :h] * 1.000001)[None].expand(s, -1, -1, -1).contiguous()


def step_chain_plain(xs, w0, w1, w2, depth: int) -> torch.Tensor:
    """Per (step, object): the row sum of relu(... relu(sin(x w0) w1) w2 ...)
    with depth-1 layers of w2 (depth 0: the row sum of sin(x w0)[:, :H]).
    xs [S,O,N,DX], w0 [O,DX,K], w1 [O,K,H], w2 [O,H,H] -> [S,O,1,H]."""
    e = torch.sin(torch.einsum("sonk,okh->sonh", xs, w0))
    if depth == 0:
        return e[..., : w1.shape[-1]].sum(dim=2, keepdim=True)
    h = torch.relu(torch.einsum("sonh,ohg->song", e, w1))
    for _ in range(depth - 1):
        h = torch.relu(torch.einsum("sonh,ohg->song", h, w2))
    return h.sum(dim=2, keepdim=True)


def part_tg_plain(gt: torch.Tensor, wb: torch.Tensor):
    """t = gt wb^T [O,R,Hp], g = wb wb^T [O,Hp,Hp]; gt [O,R,C], wb [O,Hp,C]."""
    t = torch.einsum("orc,ohc->orh", gt, wb)
    g = torch.einsum("ohc,okc->ohk", wb, wb)
    return t, g


def part_dw_plain(dt: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """dW = dt^T gt over the rays: dt [O,R,Hp], gt [O,R,C] -> [O,Hp,C]."""
    return torch.einsum("orh,orc->ohc", dt, gt)


def part_quad_plain(hp: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """z = hp (wb wb^T): hp [O,R,Hp], wb [O,Hp,C] -> [O,R,Hp]."""
    g = torch.einsum("ohc,okc->ohk", wb, wb)
    return torch.einsum("orh,ohk->ork", hp, g)


def part_epilogue(t: torch.Tensor, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """q5's epilogue, kept outside the kernel as in the script: num + pn2."""
    num = torch.sum(t * h, dim=-1)
    pn2 = torch.einsum("orh,ohk,ork->or", h, g, h)
    return num + pn2


# --------------------------------------------------------------------------- #
# the kernels
# --------------------------------------------------------------------------- #

_VP = ctypes.c_void_p
_INT = ctypes.c_int


def _lib():
    from openobj_torch import kernels

    lib = kernels.load("probes")
    if not getattr(lib, "_openobj_typed", False):
        lib.pr_ens_gemm.argtypes = [_VP] * 3 + [_INT] * 8 + [_VP]
        lib.pr_launch_nop.argtypes = [_VP, _VP, _INT, _VP]
        lib.pr_slab_stream.argtypes = [_VP] * 3 + [_INT] * 7 + [_VP]
        lib.pr_step_chain.argtypes = [_VP] * 5 + [_INT] * 7 + [_VP]
        lib.pr_part_tg.argtypes = [_VP] * 4 + [_INT] * 4 + [_VP]
        lib.pr_part_dw.argtypes = [_VP] * 3 + [_INT] * 4 + [_VP]
        lib.pr_part_quad.argtypes = [_VP] * 3 + [_INT] * 4 + [_VP]
        for fn in (lib.pr_ens_gemm, lib.pr_launch_nop, lib.pr_slab_stream,
                   lib.pr_step_chain, lib.pr_part_tg, lib.pr_part_dw, lib.pr_part_quad):
            fn.restype = _INT
        lib._openobj_typed = True
    return lib


def _check(x: torch.Tensor, name: str, shape: tuple, device=None) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if device is not None and x.device != device:
        raise ValueError(f"{name}: expected device {device}, got {x.device}")
    if x.dtype != _F32:
        raise ValueError(f"{name}: expected float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def ens_gemm_cuda(x, w, schedule: str = "grid", sin: bool = False,
                  obj_tile: int = 8) -> torch.Tensor:
    """Launch P1 with one of SCHEDULES. ``obj_tile``: objects per block of
    the objtile schedule; the persistent schedule runs one block per SM."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r}: expected one of {SCHEDULES}")
    o, n, k = x.shape
    h = w.shape[-1]
    _check(x, "x", (o, n, k))
    _check(w, "w", (o, k, h), x.device)
    if not (1 <= k <= 128 and 1 <= h <= 64):
        raise ValueError(f"ens_gemm: K={k} must be in 1..128 and H={h} in 1..64")
    if obj_tile < 1:
        raise ValueError(f"obj_tile={obj_tile}: expected >= 1")
    n_blocks = torch.cuda.get_device_properties(x.device).multi_processor_count
    out = torch.empty((o, n, h), dtype=_F32, device=x.device)
    err = _lib().pr_ens_gemm(x.data_ptr(), w.data_ptr(), out.data_ptr(), o, n, k, h,
                             SCHEDULES.index(schedule), int(sin), obj_tile, n_blocks,
                             _stream(x))
    _raise_on(err, f"ens_gemm[{schedule}]")
    _count(f"ens_gemm_{schedule}{'_sin' if sin else ''}")
    return out


def launch_nop_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch P2: a copy of x (a few hundred floats; the launch is the cost)."""
    _check(x, "x", tuple(x.shape))
    out = torch.empty_like(x)
    err = _lib().pr_launch_nop(x.data_ptr(), out.data_ptr(), x.numel(), _stream(x))
    _raise_on(err, "launch_nop")
    _count("launch_nop")
    return out


def slab_stream_cuda(xs: torch.Tensor, w0: torch.Tensor, h: int,
                     obj_tile: int = 8) -> torch.Tensor:
    """Launch P3 over the grid (object tiles, steps). Returns [S,O,1,h]."""
    s, o, r, dx = xs.shape
    k = w0.shape[-1]
    _check(xs, "xs", (s, o, r, dx))
    _check(w0, "w0", (o, dx, k), xs.device)
    if (r * dx) % 4 or xs.data_ptr() % 16:
        raise ValueError("slab_stream: the slab rows must be whole 16-byte units")
    if not (1 <= h <= k) or obj_tile < 1:
        raise ValueError(f"slab_stream: h={h} must be in 1..{k}, obj_tile >= 1")
    out = torch.empty((s, o, 1, h), dtype=_F32, device=xs.device)
    err = _lib().pr_slab_stream(xs.data_ptr(), w0.data_ptr(), out.data_ptr(), s, o, r,
                                dx, k, h, obj_tile, _stream(xs))
    _raise_on(err, "slab_stream")
    _count("slab_stream")
    return out


def step_chain_cuda(xs, w0, w1, w2, depth: int) -> torch.Tensor:
    """Launch P4: a cluster of 1-8 blocks per (step, object) pair, the
    largest with which every pair's cluster is resident at once, splitting
    the pair's rays. One launch; a refused cluster launch raises. Returns
    [S,O,1,H]."""
    s, o, n, dx = xs.shape
    k = w0.shape[-1]
    h = w1.shape[-1]
    _check(xs, "xs", (s, o, n, dx))
    _check(w0, "w0", (o, dx, k), xs.device)
    _check(w1, "w1", (o, k, h), xs.device)
    if depth >= 2:
        _check(w2, "w2", (o, h, h), xs.device)
    if not (1 <= dx <= 16 and 1 <= k <= 128 and 4 <= h <= 64 and h % 4 == 0):
        raise ValueError(f"step_chain: DX={dx} (1..16), K={k} (1..128), "
                         f"H={h} (4..64, a multiple of 4)")
    if depth < 0 or (depth == 0 and h > k):
        raise ValueError(f"step_chain: depth={depth} with K={k}, H={h}")
    out = torch.empty((s, o, 1, h), dtype=_F32, device=xs.device)
    err = _lib().pr_step_chain(xs.data_ptr(), w0.data_ptr(), w1.data_ptr(),
                               w2.data_ptr() if depth >= 2 else None, out.data_ptr(),
                               s, o, n, dx, k, h, depth, _stream(xs))
    _raise_on(err, f"step_chain[depth {depth}]")
    _count(f"step_chain_d{depth}")
    return out


def _check_hp(hp: int) -> None:
    if not 1 <= hp <= 64:
        raise ValueError(f"part_term: Hp={hp} must be in 1..64")


def part_tg_cuda(gt: torch.Tensor, wb: torch.Tensor):
    """Launch P5 mode tg. Returns (t [O,R,Hp], g [O,Hp,Hp])."""
    o, r, c = gt.shape
    hp = wb.shape[1]
    _check(gt, "gt", (o, r, c))
    _check(wb, "wb", (o, hp, c), gt.device)
    _check_hp(hp)
    t = torch.empty((o, r, hp), dtype=_F32, device=gt.device)
    g = torch.empty((o, hp, hp), dtype=_F32, device=gt.device)
    err = _lib().pr_part_tg(gt.data_ptr(), wb.data_ptr(), t.data_ptr(), g.data_ptr(),
                            o, r, hp, c, _stream(gt))
    _raise_on(err, "part_term[tg]")
    _count("part_term_tg")
    return t, g


def part_dw_cuda(dt: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Launch P5 mode dw. Returns dW [O,Hp,C]."""
    o, r, hp = dt.shape
    c = gt.shape[-1]
    _check(dt, "dt", (o, r, hp))
    _check(gt, "gt", (o, r, c), dt.device)
    _check_hp(hp)
    out = torch.empty((o, hp, c), dtype=_F32, device=dt.device)
    err = _lib().pr_part_dw(dt.data_ptr(), gt.data_ptr(), out.data_ptr(), o, r, hp, c,
                            _stream(dt))
    _raise_on(err, "part_term[dw]")
    _count("part_term_dw")
    return out


def part_quad_cuda(h: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """Launch P5 mode quad: z = h (wb wb^T). Returns z [O,R,Hp]."""
    o, r, hp = h.shape
    c = wb.shape[-1]
    _check(h, "hp", (o, r, hp))
    _check(wb, "wb", (o, hp, c), h.device)
    _check_hp(hp)
    out = torch.empty((o, r, hp), dtype=_F32, device=h.device)
    err = _lib().pr_part_quad(h.data_ptr(), wb.data_ptr(), out.data_ptr(), o, r, hp, c,
                              _stream(h))
    _raise_on(err, "part_term[quad]")
    _count("part_term_quad")
    return out


# --------------------------------------------------------------------------- #
# dispatch: the kernel on a CUDA tensor, the plain version on a CPU one
# --------------------------------------------------------------------------- #


def _on_cpu(x: torch.Tensor, what: str) -> bool:
    if x.is_cuda:
        return False
    if x.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {x.device}")
    COUNTS["probes_plain"] += 1
    return True


def ens_gemm(x, w, schedule: str = "grid", sin: bool = False,
             obj_tile: int = 8) -> torch.Tensor:
    if _on_cpu(x, "ens_gemm"):
        return ens_gemm_plain(x, w, sin)
    return ens_gemm_cuda(x, w, schedule, sin, obj_tile)


def launch_nop(x: torch.Tensor) -> torch.Tensor:
    if _on_cpu(x, "launch_nop"):
        return launch_nop_plain(x)
    return launch_nop_cuda(x)


def slab_stream(xs, w0, h: int, obj_tile: int = 8) -> torch.Tensor:
    if _on_cpu(xs, "slab_stream"):
        return slab_stream_plain(xs, w0, h)
    return slab_stream_cuda(xs, w0, h, obj_tile)


def step_chain(xs, w0, w1, w2, depth: int) -> torch.Tensor:
    if _on_cpu(xs, "step_chain"):
        return step_chain_plain(xs, w0, w1, w2, depth)
    return step_chain_cuda(xs, w0, w1, w2, depth)


def part_tg(gt, wb):
    if _on_cpu(gt, "part_tg"):
        return part_tg_plain(gt, wb)
    return part_tg_cuda(gt, wb)


def part_dw(dt, gt):
    if _on_cpu(dt, "part_dw"):
        return part_dw_plain(dt, gt)
    return part_dw_cuda(dt, gt)


def part_quad(hp, wb):
    if _on_cpu(hp, "part_quad"):
        return part_quad_plain(hp, wb)
    return part_quad_cuda(hp, wb)
