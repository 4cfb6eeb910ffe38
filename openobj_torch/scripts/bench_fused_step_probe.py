"""Feasibility probes of a fused optimizer-step kernel, on one CUDA device.

Port of ``scripts/bench_fused_step_probe.py``: the same five questions,
asked of this card, with the hand-written kernels of ``csrc/probes.cu``
in place of the Pallas kernels and PyTorch's library calls in place of
XLA's.

  q1. The ensemble GEMM sin(x) w at the room_0 per-step shape ([16,1200,87]
      x [16,87,32]): the kernel (P1, three placements) against
      ``torch.einsum`` on the same math.
  q2. The cost of one (object tile, step) block of a steps grid (8 tiles x
      100 steps) whose body does nothing but stream its ray slab
      [8,1200,8] through shared memory (P3), against a tiny [8,8,8] block.
  q3. The per-object forward chain sin(x w0) -> relu(. w1) -> 3 x relu(. w2)
      -> row sum over that grid (P4, depth 4: activations never leave the
      SM) against the same math as whole-frame library calls.
  q4. The short chains (depth 0 and 1) at object tiles 8 and 16: "ok" when
      the kernel builds, launches and matches its plain version.
  q5. The part term t = gt wb^T with g = wb wb^T in one kernel (P5 tg;
      epilogue num + pn2 outside, as in the script) against the library;
      then dW = dt^T gt and z = hp (wb wb^T) as correctness cases, each
      timed beside its library call (``torch.bmm``, a three-operand
      ``torch.einsum``).

Times come from ``openobj_torch.scripts._benchlib.scan_time`` (CUDA
graphs of 1 and N calls). Inputs are made from a seed on the device.
Each section returns its answers and the ``_benchlib.Case`` of every
kernel it measured, with the kernel's, the plain version's and the
library call's times.

Run on a CUDA device:
    python -m openobj_torch.scripts.bench_fused_step_probe [--only q1 q3]
Without one it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from openobj_torch.scripts._benchlib import SINF_OPS

# room_0 per-step ensemble shape: O objects x (120 rays x 10 pts) x 87-d
# embedding into h=32, the biggest GEMM of the step
O_TILE = 16
N = 1200
K = 87
H = 32
STEPS = 100

CHAIN_RTOL = 1e-4     # max|d| / max|ref|: five layers amplify rounding and relu kinks
GEMM_RTOL = 1e-5      # max|d| / max|ref|: FP32 sums over 87-512 products in another order

SCRIPT = "scripts/bench_fused_step_probe.py"


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _compile_case(make) -> tuple[str, list]:
    """Measure the case ``make()`` builds. Returns ("ok", [case]) when its
    kernel matches its plain version within its tol, else the mismatch or
    the error, and what was measured."""
    from openobj_torch.scripts._benchlib import measure, rel_err

    try:
        case = measure(make())
        torch.cuda.synchronize()
    except (RuntimeError, ValueError) as e:
        return f"error: {str(e).splitlines()[0][:160]}", []
    err = rel_err(case.out, case.plain())
    if err > case.tol:
        return f"mismatch: max|d|/max|ref| {err:.3e} > {case.tol}", [case]
    return "ok", [case]


def q1(device, seed: int = 0) -> tuple[dict, list]:
    """Per-site cost of the ensemble GEMM sin(x) w, kernel vs library."""
    from openobj_torch.ops import probes
    from openobj_torch.scripts._benchlib import Case, measure

    g = _gen(device, seed)
    x = torch.randn((O_TILE, N, K), generator=g, device=device)
    w = torch.randn((O_TILE, K, H), generator=g, device=device)
    flops = 2 * O_TILE * N * K * H
    nbytes = 4 * (O_TILE * N * K + O_TILE * K * H + O_TILE * N * H)
    # grid and persistent port _batched_dot_kernel (:74), objtile the unrolled one (:82)
    sites = {"grid": 74, "objtile": 82, "persistent": 74}
    cases = []
    for s in probes.SCHEDULES:
        cases.append(measure(Case(
            f"ens_gemm[{s},sin]", f"{SCRIPT}:{sites[s]}", f"ens_gemm_{s}_sin",
            lambda s=s: probes.ens_gemm(x, w, s, sin=True, obj_tile=O_TILE),
            # the plain version is the script's library form, einsum on sin(x)
            lambda: probes.ens_gemm_plain(x, w, sin=True), None,
            flops, nbytes, GEMM_RTOL, 200), same_as=cases[0] if cases else None))
    out = {f"cuda_{c.key.removeprefix('ens_gemm_')}": c.us for c in cases}
    out["torch_einsum"] = cases[0].plain_us
    return ({name: {"us_per_site": round(us, 3), "tflops": round(flops / us / 1e6, 3)}
             for name, us in out.items()}, cases)


def q2(device, seed: int = 0, n_tiles: int = 8, o_tile: int = 8) -> tuple[dict, list]:
    """Per-block cost of a (tiles x steps) grid that streams its ray slab.
    The inputs are random, not zeros as in the script, so that the check of
    the output against the plain version means something."""
    from openobj_torch.ops import probes
    from openobj_torch.scripts._benchlib import Case, measure

    g = _gen(device, seed)
    o = n_tiles * o_tile
    xs = torch.randn((STEPS, o, N, 8), generator=g, device=device)
    w0 = torch.randn((o, 8, K), generator=g, device=device)
    cases = []
    for label, xq in (("full", xs), ("tiny", xs[:, :, :8, :].contiguous())):
        cases.append(measure(Case(
            f"slab_stream[{label}]", f"{SCRIPT}:144", "slab_stream",
            lambda xq=xq: probes.slab_stream(xq, w0, H, o_tile),
            lambda xq=xq: probes.slab_stream_plain(xq, w0, H), None,
            o * STEPS * H, 4 * (xq.numel() + o * H + STEPS * o * H), None, 30)))
    full, tiny = cases
    gs = n_tiles * STEPS
    return {
        "grid_steps": gs,
        "us_per_launch_ray_slab": round(full.us, 3),
        "us_per_grid_step_ray_slab": round(full.us / gs, 4),
        "us_per_grid_step_tiny_block": round(tiny.us / gs, 4),
        "ray_slab_gb_per_s": round(xs.numel() * 4 / full.us / 1e3, 1),
        "note": "delta = streaming the [o_tile,1200,8] ray slab through shared memory",
    }, cases


def _chain_case(name, site, xs, w0, w1, w2, depth, iters):
    """The chain's case. Its work per ray: the encode on the SIMT cores (the
    projection's DX * K multiply-adds and K sines, each sine SINF_OPS
    operations; at depth 0 only the H columns kept) and, at depth >= 1, the
    products K * H + (depth - 1) * H * H, which the kernel runs on the tensor
    cores (``mm_flops``)."""
    from openobj_torch.ops import probes
    from openobj_torch.scripts._benchlib import Case

    s, o, n, dx = xs.shape
    k, h = w0.shape[-1], w1.shape[-1]
    cols = h if depth == 0 else k                  # encoded columns
    mm = 0 if depth == 0 else k * h + (depth - 1) * h * h
    rays = s * o * n
    weights = w0.numel() + (w1.numel() if depth else 0) + (w2.numel() if depth > 1 else 0)
    return Case(name, site, f"step_chain_d{depth}",
                lambda: probes.step_chain(xs, w0, w1, w2, depth),
                lambda: probes.step_chain_plain(xs, w0, w1, w2, depth), None,
                rays * (2 * dx * cols + SINF_OPS * cols + 2 * mm),
                4 * (xs.numel() + weights + s * o * h), CHAIN_RTOL, iters,
                mm_flops=2 * rays * mm)


def q3(device, seed: int = 0, n_tiles: int = 8, o_tile: int = 8) -> tuple[dict, list]:
    """The depth-4 chain fused per (object, step) vs whole-frame library
    calls; the plain version is that library chain (the script's XLA
    chain)."""
    from openobj_torch.scripts._benchlib import measure, rel_err

    g = _gen(device, seed)
    o = n_tiles * o_tile
    xs = torch.randn((STEPS, o, N, 8), generator=g, device=device) * 0.1
    w0 = torch.randn((o, 8, K), generator=g, device=device)
    w1 = torch.randn((o, K, H), generator=g, device=device)
    w2 = torch.randn((o, H, H), generator=g, device=device)
    case = measure(_chain_case("step_chain[d4]", f"{SCRIPT}:192", xs, w0, w1, w2, 4, 5))
    gs = n_tiles * STEPS
    return {
        "cuda_step_chain": {
            "ms_per_frame_equiv": round(case.us / 1e3, 4),
            "us_per_grid_step": round(case.us / gs, 4),
            "grid_steps": gs,
            "blocks": int(xs.shape[0] * xs.shape[1]),
        },
        "library_whole_frame_same_chain": {"ms": round(case.plain_us / 1e3, 4)},
        "max_rel_err_vs_library": rel_err(case.out, case.plain()),
    }, [case]


def q4(device, seed: int = 0) -> tuple[dict, list]:
    """The short chains: ok when the kernel matches its plain version. The
    script's chained-batched (:281) and per-object (:290) bodies are one
    kernel here, since a block owns one (object, step) pair either way: one
    depth-1 case per object tile answers for both."""

    def compile_case(o_tile: int, depth: int):
        g = _gen(device, seed + o_tile)
        xs = torch.randn((4, o_tile, N, 8), generator=g, device=device) * 0.1
        w0 = torch.randn((o_tile, 8, K), generator=g, device=device)
        w1 = torch.randn((o_tile, K, H), generator=g, device=device)
        return _compile_case(lambda: _chain_case(
            f"step_chain[d{depth},o{o_tile}]", f"{SCRIPT}:257", xs, w0, w1, None, depth, 50))

    (single, c0), (d1_o8, c1), (d1_o16, c2) = (
        compile_case(16, 0), compile_case(8, 1), compile_case(16, 1))
    return {
        "single_batched_dot_o16": single,
        "chained_batched_dot_o16": d1_o16,
        "chained_batched_dot_o8": d1_o8,
        "per_object_2d_o8": d1_o8,
        "per_object_2d_o16": d1_o16,
    }, c0 + c1 + c2


def _einsum_path(eq: str, *ops) -> str:
    """The order in which ``torch.einsum`` contracts ``ops``: opt_einsum's
    path (pairs of operand positions) where torch uses it, else left to
    right."""
    oe = torch.backends.opt_einsum
    if oe.enabled and oe.is_available():
        import opt_einsum

        path, _ = opt_einsum.contract_path(eq, *ops, optimize=oe.strategy)
        return f"opt_einsum {oe.strategy}: {path}"
    return "left to right"


def q5(device, seed: int = 0, n_tiles: int = 8, o_tile: int = 8) -> tuple[dict, list]:
    """The part term's {t, g} kernel, epilogue outside, vs the library;
    then dW and the quadratic form as correctness cases."""
    from openobj_torch.ops import probes
    from openobj_torch.scripts._benchlib import Case, counted, measure, rel_err, scan_time

    g = _gen(device, seed)
    obj, r, hpd, c = n_tiles * o_tile, 120, H + 1, 512
    gt0 = torch.randn((obj, r, c), generator=g, device=device) * 0.1
    wb = torch.randn((obj, hpd, c), generator=g, device=device) * 0.1
    hp = torch.randn((obj, r, hpd), generator=g, device=device) * 0.1
    gt = torch.sin(gt0)

    def cuda_fn(w, h, g0):
        t, gram = probes.part_tg(torch.sin(g0), w)
        return probes.part_epilogue(t, gram, h)

    def library_fn(w, h, g0):
        t, gram = probes.part_tg_plain(torch.sin(g0), w)
        return probes.part_epilogue(t, gram, h)

    tg_flops = 2 * obj * (r * hpd * c + hpd * hpd * c)    # all on the tensor cores
    tg = measure(Case(
        "part_term[tg]", f"{SCRIPT}:342", "part_term_tg", lambda: probes.part_tg(gt, wb),
        lambda: probes.part_tg_plain(gt, wb), None,
        tg_flops, 4 * obj * (r * c + hpd * c + r * hpd + hpd * hpd), GEMM_RTOL, 100,
        mm_flops=tg_flops))
    with counted(tg):
        per = scan_time(cuda_fn, (wb, hp, gt0), iters=100)
        err = rel_err(cuda_fn(wb, hp, gt0), library_fn(wb, hp, gt0))
    perx = scan_time(library_fn, (wb, hp, gt0), iters=100)
    dw, dw_case = _compile_case(lambda: Case(
        "part_term[dw]", f"{SCRIPT}:422", "part_term_dw", lambda: probes.part_dw(hp, gt),
        lambda: probes.part_dw_plain(hp, gt), lambda: torch.bmm(hp.transpose(1, 2), gt),
        2 * obj * hpd * r * c, 4 * obj * (r * hpd + r * c + hpd * c), GEMM_RTOL, 100))
    gram_flops = 2 * obj * hpd * hpd * c                  # on the tensor cores
    # the library's one call: with the operands in this order, left-to-right
    # contraction (torch's without opt_einsum) forms g = wb wb^T first, and
    # so does opt_einsum's cheapest path
    quad, quad_case = _compile_case(lambda: Case(
        "part_term[quad]", f"{SCRIPT}:426", "part_term_quad", lambda: probes.part_quad(hp, wb),
        lambda: probes.part_quad_plain(hp, wb),
        lambda: torch.einsum("ohc,okc,orh->ork", wb, wb, hp),
        gram_flops + 2 * obj * r * hpd * hpd, 4 * obj * (r * hpd + hpd * c + r * hpd),
        GEMM_RTOL, 100, mm_flops=gram_flops))
    return {
        "cuda_t_g_us_per_step": round(per * 1e6, 3),
        "cuda_t_g_kernel_alone_us": round(tg.us, 3),
        "library_same_math_us_per_step": round(perx * 1e6, 3),
        "per_frame_ms_cuda_x100": round(per * 1e6 / 10, 3),
        "per_frame_ms_library_x100": round(perx * 1e6 / 10, 3),
        "max_rel_err_vs_library": err,
        "compile_bwd_dW_loaded_operands": dw,
        "compile_quadratic_chained_dot": quad,
        "cuda_quad_kernel_alone_us": round(quad_case[0].us, 3) if quad_case else None,
        "library_quad_us": round(quad_case[0].library_us, 3) if quad_case else None,
        "library_quad_einsum_path": _einsum_path("ohc,okc,orh->ork", wb, wb, hp),
    }, [tg] + dw_case + quad_case


SECTIONS = {"q1": q1, "q2": q2, "q3": q3, "q4": q4, "q5": q5}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=None, choices=sorted(SECTIONS),
                    help="subset of q1 q2 q3 q4 q5")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_fused_step_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda", 0)
    print("devices:", [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())],
          flush=True)
    for name, fn in SECTIONS.items():
        if args.only and name not in args.only:
            continue
        print(f"== {name} ==", flush=True)
        print(json.dumps(fn(device)[0], indent=2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
