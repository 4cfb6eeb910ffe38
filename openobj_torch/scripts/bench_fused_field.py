"""Time K1 and K2, the fused-field forward and backward, of this checkout,
alone or against the kernels built from another copy of
``csrc/fused_field.cu`` with the same C entry points, in one process on one
card.

    python -m openobj_torch.scripts.bench_fused_field
    mkdir -p chip_proof/other && git archive <commit> openobj_torch/csrc/fused_field.cu \\
        | tar -x -C chip_proof/other
    python -m openobj_torch.scripts.bench_fused_field \\
        --against chip_proof/other/openobj_torch/csrc/fused_field.cu

At the main path's two shapes (fg 64 objects x 1200 points, h=32; bg 1 x
16800, h=128) and at other widths' (the synthetic scene's bg [1, 1792] at
h=64; the room_0 shapes at h=64; fg at h=16 and h=96), clip head on, inputs
from a seed, it builds both sources with
the same ``nvcc`` flags and tiles both backwards with
``fused_field.bwd_tiling``. For each forward it reports the max abs
difference from ``fused_field_plain`` (the 1e-4 gate of ``chip_smoke.py``).
For each backward it reports the worst leaf's max|d|/max|ref| (and which
leaf and object) against the plain FP32 backward, which is the gate of
``chip_smoke.py``, and against the plain backward in float64 (``vs_f64``;
its projection t . dirs^T keeps the FP32 rounding all versions share),
beside the plain FP32 backward's own distance from float64. It times each
kernel alone (the forward into preallocated outputs, the backward into its
own per-tile scratch, without the reduction) with CUDA events in turns:
this, other, other, this; and the plain forward and backward (autograd of
``fused_field_plain``), and each kernel's bound (``_benchlib.field_bounds``)
and the kernels this checkout launches there. The last line is one JSON
object with every number.

With ``--dtype bf16`` it does the same for the bf16 library
(``csrc/fused_field_bf16.cu``; ``--against`` then names another copy of
that file, beside its own ``fused_field.cu``) at the main path's two
shapes, against the plain version in bf16, and counts the ReLU masks of
the recomputed forward that differ between the plain version and K2 bf16,
read from the kernel's own stored operands by a copy of the source with a
probe (``probed_source``); then K1 bf16 alone at the render shape (48
objects x 305,152 points, h=32, clip head off), each library's outputs
held to the plain bf16 by ``fused_field.bf16_output_errors``:

    mkdir -p chip_proof/parent && git archive HEAD~1 openobj_torch/csrc | tar -x -C chip_proof/parent
    python -m openobj_torch.scripts.bench_fused_field --dtype bf16 \\
        --against chip_proof/parent/openobj_torch/csrc/fused_field_bf16.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from openobj_torch import kernels
from openobj_torch.models import object_field
from openobj_torch.ops import fused_field as ff
from openobj_torch.scripts._benchlib import bound_ms, field_bounds, fwd_macs_noclip

SHAPES = (
    dict(name="fg", o=64, n=1200, h=32), dict(name="bg", o=1, n=16800, h=128),
    dict(name="syn_bg_h64", o=1, n=1792, h=64),
    dict(name="fg_h64", o=64, n=1200, h=64), dict(name="bg_h64", o=1, n=16800, h=64),
    dict(name="fg_h16", o=64, n=1200, h=16), dict(name="fg_h96", o=64, n=1200, h=96),
)
# K1 bf16's render shape (phase 4b's), clip head off
RENDER = dict(o=48, n=2048 * 149, h=32)
ITERS = 20      # timed launches per reading, after 3 warm-ups
_RELU_LAYERS = ("h1", "h2", "hc", "h3", "hcol", "hclip")


class Field:
    """One library's kernels at one shape: outputs, scratch, launches and
    reduction."""

    def __init__(self, lib, wflat, pts, da, dc, dh, h: int):
        self.lib, self.args = lib, (wflat, pts, da, dc, dh)
        o, n, _ = pts.shape
        self.o, self.n, self.h = o, n, h
        self.tile, self.n_tiles = ff.bwd_tiling(lib, o, n, h, pts.device)
        self.p = lib.ff_param_count(h)
        self.buf, self.part = ff.bwd_scratch(lib, o, self.n_tiles, h, pts.device)
        self.outs = [torch.empty((o, n, k), device=pts.device) for k in (1, 3, h)]
        self.stream = torch.cuda.current_stream(pts.device).cuda_stream

    def forward(self) -> None:
        w, pts = self.args[:2]
        a, c, f = self.outs
        err = self.lib.ff_forward(pts.data_ptr(), w.data_ptr(), a.data_ptr(), c.data_ptr(),
                                  f.data_ptr(), self.o, self.n, self.h, 1, self.stream)
        if err:
            raise RuntimeError(f"ff_forward: CUDA error {err}")

    def backward(self) -> None:
        w, pts, da, dc, dh = self.args
        err = self.lib.ff_backward(pts.data_ptr(), w.data_ptr(), da.data_ptr(), dc.data_ptr(),
                                   dh.data_ptr(), self.buf.data_ptr(), self.o, self.n,
                                   self.h, 1, self.tile, self.stream)
        if err:
            raise RuntimeError(f"ff_backward: CUDA error {err}")

    def grad(self) -> torch.Tensor:
        self.backward()
        g = torch.empty((self.o, self.p), device=self.part.device)
        err = self.lib.ff_reduce(self.part.data_ptr(), g.data_ptr(), self.o, self.n_tiles,
                                 self.p, self.stream)
        if err:
            raise RuntimeError(f"ff_reduce: CUDA error {err}")
        return g


def _time(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def _leaf_rel(g: torch.Tensor, ref: torch.Tensor, h: int) -> tuple[float, str]:
    """Worst per-leaf max|d|/max|ref|, and where: "leaf[object]"."""
    worst, where, ofs = 0.0, "", 0
    for name, (r, c) in ff.param_layout(h):
        sl = slice(ofs, ofs + r * c)
        ofs += r * c
        d = (g[:, sl].double() - ref[:, sl].double()).abs()
        rel = float(d.max()) / (float(ref[:, sl].abs().max()) + 1e-12)
        if rel > worst:
            worst, where = rel, f"{name}[{int(d.amax(dim=1).argmax())}]"
    return worst, where


def _plain_grad(wflat, pts, cts, h: int, dtype, compute_dtype: str = "f32"):
    """(objective, packed gradient, leaf) of the plain backward in ``dtype``
    (at ``compute_dtype``)."""
    w = wflat.detach().to(dtype).requires_grad_(True)
    outs = ff.fused_field_plain(w, pts.to(dtype), h, True, compute_dtype)
    obj = sum((x * c.to(dtype)).sum() for x, c in zip(outs, cts))
    (g,) = torch.autograd.grad(obj, w, retain_graph=True)
    return obj, g, w


# K2 bf16 with a probe: after each chunk's recompute, its ReLU masks as the
# kernel's stored operands carry them go to the buffer given to ff_mask_out
MASK_HEAD = r"""
__device__ unsigned char* g_mask_out = nullptr;
extern "C" int ff_mask_out(void* p) {
  return (int)cudaMemcpyToSymbol(g_mask_out, &p, sizeof(p));
}
"""
MASK_AT = "    // ---- colour head"
MASK_READ = r"""    // probe: bit l of byte [o][point][unit] is layer l's mask (h1, h2, hc,
    // h3, hcol from their stored operands' bits; hclip as d_hclip != 0)
    if (g_mask_out) {
      const bf* mk[6] = {A1, X2, AC, X3, AO, DH + H};
      const int ld[6] = {LW, LX2, LW, LX3, LW, LDH};
      for (int i = tid; i < nv * H; i += NT) {
        const int pt = i / H, j = i - pt * H;
        unsigned m = 0;
        for (int l = 0; l < (do_clip ? 6 : 5); ++l) m |= (mk[l][pt * ld[l] + j] != 0 ? 1u : 0u) << l;
        g_mask_out[((size_t)o * N + c0 + pt) * H + j] = (unsigned char)m;
      }
      __syncthreads();
    }
"""


def probed_source() -> Path:
    """A copy of ``csrc/fused_field_bf16.cu``, beside copies of what it
    includes, whose K2 bf16 writes each point's recompute masks (bit l of
    a byte per unit: h1, h2, hc, h3, hcol, hclip) to the [O, N, h] uint8
    buffer given to ``ff_mask_out``, where one is given."""
    src = kernels.CSRC / "fused_field_bf16.cu"
    out = kernels.BUILD_DIR / "mask_probe"
    out.mkdir(parents=True, exist_ok=True)
    for f in kernels.included(src):
        text = f.read_text()
        if f.name == "fused_field_bwd_bf16.cuh":
            if text.count(MASK_AT) != 1:
                raise RuntimeError(f"{f.name}: the recompute's end moved; update the probe")
            text = text.replace(MASK_AT, MASK_READ + MASK_AT)
        if f == src:
            text = MASK_HEAD + text
        (out / f.name).write_text(text)
    return out / src.name


def plain_masks(wflat, pts, dh, h: int, do_clip: bool = True) -> torch.Tensor:
    """The plain bf16 version's recompute masks in ``probed_source``'s
    layout: [O, N, h] uint8, bit l for layer l (hclip's where dh is not 0
    in bf16, as the kernel keeps it)."""
    _, _, hclip, a = ff._plain_forward(ff._unpack(wflat, h), pts, h, do_clip, ff._bmm_bf16)
    masks = torch.zeros(a["h1"].shape, dtype=torch.uint8, device=a["h1"].device)
    for layer, name in enumerate(_RELU_LAYERS[:5]):
        masks |= (a[name] > 0).to(torch.uint8) << layer
    if do_clip:
        masks |= ((hclip > 0) & (ff._round_bf16(dh) != 0)).to(torch.uint8) << 5
    return masks


def mask_flips(got: torch.Tensor, want: torch.Tensor, do_clip: bool = True) -> dict:
    """{layer: units whose mask differs} between two [O, N, h] mask bytes."""
    diff = got ^ want
    return {name: int(((diff >> layer) & 1).sum())
            for layer, name in enumerate(_RELU_LAYERS[:6 if do_clip else 5])}


def kernel_mask_flips(lib, wflat, pts, cts, h: int) -> dict:
    """{layer: recompute masks of K2 bf16 (``lib``: ``probed_source``'s
    build) unlike the plain bf16 version's}, clip head on."""
    o, n, _ = pts.shape
    got = torch.full((o, n, h), 0xFF, dtype=torch.uint8, device=pts.device)
    if lib.ff_mask_out(got.data_ptr()):
        raise RuntimeError("ff_mask_out failed")
    Field(lib, wflat, pts, *cts, h).backward()
    torch.cuda.synchronize()
    lib.ff_mask_out(None)
    return mask_flips(got, plain_masks(wflat, pts, cts[2], h))


def run(against: Path | None, compute_dtype: str = "f32") -> dict:
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    source = ff._SOURCE[compute_dtype]
    bf16 = compute_dtype == "bf16"
    probed = probed_source() if bf16 else None
    secs = kernels.build([source] + ([against] if against else []) + ([probed] if bf16 else []),
                         verbose=True)
    print(f"[build] nvcc seconds (sources not built yet, in parallel): {secs}", flush=True)
    libs = {"this": ff._lib(source)}
    if against:
        libs["other"] = ff._lib(against)
    if bf16:
        probe = ff._lib(probed)
        probe.ff_mask_out.argtypes = [ctypes.c_void_p]
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    out = {}
    for shape in (SHAPES[:2] if bf16 else SHAPES):
        o, n, h = shape["o"], shape["n"], shape["h"]
        params = object_field.init_stacked_fields(gen, o, hidden=h, clip_size=512, scale=2.0,
                                                  device=device)
        params = object_field.tree_map(
            lambda x: x + 0.05 * torch.randn(x.shape, generator=gen, device=device), params)
        wflat = ff._pack_params(params, h, True).contiguous()
        pts = (0.5 * torch.randn((o, n, 3), generator=gen, device=device)).contiguous()
        cts = [torch.randn((o, n, k), generator=gen, device=device) for k in (1, 3, h)]
        obj, ref, w_req = _plain_grad(wflat, pts, cts, h, torch.float32, compute_dtype)
        # (the plain bf16 backward rounds to f32 operands: no float64 reading)
        ref64 = ref if bf16 else _plain_grad(wflat, pts, cts, h, torch.float64)[1]

        outs_p = ff.fused_field_plain(wflat, pts, h, True, compute_dtype)
        bounds = field_bounds(o, n, h, ff.packed_size(h), compute_dtype)
        row = {"o": o, "n": n, "h": h, "plain_vs_f64": _leaf_rel(ref, ref64, h)[0],
               "kernels": ff.kernel_names(h, compute_dtype),
               "bound_fwd_ms": bounds["fwd"][0], "bound_ms": bounds["bwd"][0],
               "encode_floor_ms": bounds["fwd_encode"][0]}
        if bf16:
            row["mask_flips"] = kernel_mask_flips(probe, wflat, pts, cts, h)
            row["mask_units"] = o * n * h
        runs = {k: Field(lib, wflat, pts, *cts, h) for k, lib in libs.items()}
        for k, r in runs.items():
            r.forward()
            fwd_err = max(float((x - y).abs().max()) for x, y in zip(r.outs, outs_p))
            g = r.grad()
            rel, where = _leaf_rel(g, ref, h)
            row[k] = {"fwd_max_abs": fwd_err, "tile": r.tile, "tiles": r.n_tiles,
                      "worst_leaf_rel": rel, "worst_leaf": where,
                      "vs_f64": _leaf_rel(g, ref64, h)[0], "fwd_ms": [], "ms": []}
        order = ["this", "other", "other", "this"] if against else ["this", "this"]
        for k in order:
            row[k]["fwd_ms"].append(_time(runs[k].forward))
        for k in order:
            row[k]["ms"].append(_time(runs[k].backward))
        row["plain_fwd_ms"] = _time(lambda: ff.fused_field_plain(wflat, pts, h, True,
                                                                   compute_dtype))
        row["plain_ms"] = _time(lambda: torch.autograd.grad(obj, w_req, retain_graph=True))
        out[shape["name"]] = row
        fwd_name, bwd_name = ff._FWD[compute_dtype], ff._BWD[compute_dtype]
        if bf16:
            print(f"[masks] {shape['name']}: K2 bf16's recompute masks (its stored operands) "
                  f"unlike the plain bf16's, of "
                  f"{row['mask_units']} a layer: {row['mask_flips']}", flush=True)
        print(f"[k1] {shape['name']} O={o} N={n} h={h} ({row['kernels'][fwd_name]}): "
              + "; ".join(f"{k} {['%.4f' % t for t in row[k]['fwd_ms']]} ms "
                          f"(max abs {row[k]['fwd_max_abs']:.2e})" for k in runs)
              + f"; plain forward {row['plain_fwd_ms']:.4f} ms; bound "
              f"{row['bound_fwd_ms']:.4f} ms, encode floor {row['encode_floor_ms']:.4f} ms",
              flush=True)
        print(f"[k2] {shape['name']} O={o} N={n} h={h} ({row['kernels'][bwd_name]}): "
              + "; ".join(f"{k} {['%.4f' % t for t in row[k]['ms']]} ms (tile {row[k]['tile']}, "
                          f"worst leaf rel {row[k]['worst_leaf_rel']:.2e} at {row[k]['worst_leaf']}, "
                          f"vs f64 {row[k]['vs_f64']:.2e})"
                          for k in runs)
              + f"; plain backward {row['plain_ms']:.4f} ms (vs f64 {row['plain_vs_f64']:.2e}); "
              f"bound {row['bound_ms']:.4f} ms", flush=True)
        del params, wflat, pts, cts, w_req, obj, ref, ref64, runs, outs_p
    if bf16:
        out["render"] = _render_k1(libs, gen, device)
    return out


def _render_k1(libs: dict, gen, device) -> dict:
    """K1 bf16 of each library at the render shape (phase 4b's stack of 48
    objects x a chunk of 2048 rays x 149 samples, h=32, clip head off), in
    turns, each held to the plain bf16 by ``bf16_output_errors``."""
    o, n, h = RENDER["o"], RENDER["n"], RENDER["h"]
    params = object_field.init_stacked_fields(gen, o, hidden=h, clip_size=512, scale=2.0,
                                              device=device)
    wflat = ff._pack_params(params, h, False).contiguous()
    pts = (0.5 * torch.randn((o, n, 3), generator=gen, device=device)).contiguous()
    with torch.no_grad():
        ref = ff.fused_field_plain(wflat, pts, h, False, "bf16")[:2]
        ref32 = ff.fused_field_plain(wflat, pts, h, False)[:2]
    outs = {k: [torch.empty((o, n, c), device=device) for c in (1, 3)] for k in libs}

    def fwd(k):
        a, c = outs[k]
        err = libs[k].ff_forward(pts.data_ptr(), wflat.data_ptr(), a.data_ptr(), c.data_ptr(),
                                 None, o, n, h, 0, ff._stream(pts))
        if err:
            raise RuntimeError(f"ff_forward ({k}): CUDA error {err}")

    # the bound as chip_smoke.py's K1 rows take it: points and weights read,
    # alpha and colour written, products at the bf16 rate
    npts = o * n
    macs, mm = fwd_macs_noclip(h)
    bound = bound_ms(2.0 * macs * npts, npts * 12 + wflat.numel() * 4 + npts * 16, 2.0 * mm * npts,
                     "bf16")
    row = {"o": o, "n": n, "h": h, "kernels": ff.kernel_names(h, "bf16"),
           "bound_fwd_ms": bound[0], "encode_floor_ms": field_bounds(o, n, h, 1)["fwd_encode"][0]}
    for k in libs:
        fwd(k)
        torch.cuda.synchronize()
        errs = {name: ff.bf16_output_errors(x, r, r32, 1e-4)
                for name, x, r, r32 in zip(("alpha", "color"), outs[k], ref, ref32)}
        if not all(e["ok"] for e in errs.values()):
            raise AssertionError(f"K1 bf16 ({k}) at the render shape: outside the gate {errs}")
        row[k] = {"off": {name: e["off"] for name, e in errs.items()},
                  "max_abs": max(e["max_abs"] for e in errs.values()), "fwd_ms": []}
    for k in (["this", "other", "other", "this"] if "other" in libs else ["this", "this"]):
        row[k]["fwd_ms"].append(_time(lambda: fwd(k)))
    print(f"[k1] render O={o} N={n} h={h} clip off ({row['kernels']['fused_field_fwd_bf16']}): "
          + "; ".join(f"{k} {['%.4f' % t for t in row[k]['fwd_ms']]} ms (off {row[k]['off']})"
                      for k in libs) + f"; bound {bound[0]:.4f} ms {bound[1]}, encode floor "
          f"{row['encode_floor_ms']:.4f} ms", flush=True)
    del params, wflat, pts, ref, ref32, outs
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path,
                    help="another fused_field.cu (fused_field_bf16.cu with --dtype bf16), with "
                         "the same entry points, to time beside this one")
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                    help="the library: fused_field.cu (f32) or fused_field_bf16.cu (bf16)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_fused_field: no CUDA device", file=sys.stderr)
        return 2
    res = run(args.against.resolve() if args.against else None, args.dtype)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "fused_field": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
