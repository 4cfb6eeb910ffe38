"""The probe kernels' plain versions against the Pallas probe kernels.

Each Pallas body of ``scripts/bench_ensemble_mm.py`` (K3) and
``scripts/bench_fused_step_probe.py`` (K4) runs on the CPU in interpret
mode, with the script's grid and block specs at small shapes, and is held
against its plain version in ``openobj_torch/ops/probes.py`` on the same
numpy inputs. ``_batched_dot_kernel`` and ``_unrolled_dot_kernel`` are
imported from the script; the bodies nested inside the scripts' functions
are restated here verbatim, each citing its source line. The plain versions
are also held against the scripts' own XLA expressions. The CUDA kernels
are held against the plain versions in tests/test_torch_probe_kernels.py
(needs a GPU, not JAX).
"""

import functools as ft
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from openobj_torch.ops import probes  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5          # max|d| / max|ref|: FP32 sums in another order
CHAIN_RTOL = 1e-4    # the chain: five layers amplify rounding and relu kinks

# small shapes: N rays, STEPS steps, object tiles of O_TILE objects
N, K, H, STEPS, N_TILES, O_TILE = 64, 87, 32, 3, 2, 2


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jfs = _load_script("bench_fused_step_probe")


def _rng(seed: int = 0):
    return np.random.default_rng(seed)


def _f32(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got: torch.Tensor, ref, rtol: float) -> None:
    ref = np.asarray(ref)
    d = float(np.abs(got.numpy() - ref).max())
    assert d <= rtol * float(np.abs(ref).max()), f"max|d| {d:.3e}, max|ref| {np.abs(ref).max():.3e}"


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# --------------------------------------------------------------------------- #
# K3: scripts/bench_ensemble_mm.py, bodies nested in main()
# --------------------------------------------------------------------------- #

EO, EK, TO = 4, 88, 2


def _em_inputs():
    rng = _rng(0)
    return _f32(rng, (EO, N, EK)), _f32(rng, (EO, EK, H), 0.1)


def _em_batched(x, w):
    # bench_ensemble_mm.py:52-64, batched_kernel and pallas_batched
    def batched_kernel(x_ref, w_ref, o_ref):
        o_ref[:] = jax.lax.dot_general(
            x_ref[:], w_ref[:], (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)

    return pl.pallas_call(
        batched_kernel,
        out_shape=jax.ShapeDtypeStruct((EO, N, H), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.ANY),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.ANY),
        interpret=True,
    )(x, w)


def _em_tiled(x, w):
    # bench_ensemble_mm.py:79-94, tiled_kernel and pallas_tiled
    def tiled_kernel(x_ref, w_ref, o_ref):
        o_ref[:] = jax.lax.dot_general(
            x_ref[:], w_ref[:], (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)

    return pl.pallas_call(
        tiled_kernel,
        grid=(EO // TO,),
        out_shape=jax.ShapeDtypeStruct((EO, N, H), jnp.float32),
        in_specs=[
            pl.BlockSpec((TO, N, EK), lambda i: (i, 0, 0)),
            pl.BlockSpec((TO, EK, H), lambda i: (i, 0, 0)),
        ],
        out_specs=pl.BlockSpec((TO, N, H), lambda i: (i, 0, 0)),
        interpret=True,
    )(x, w)


def _em_loop(x, w):
    # bench_ensemble_mm.py:105-124, loop_kernel and pallas_loop
    def loop_kernel(x_hbm, w_ref, o_ref, xbuf, sem):
        def body(i, _):
            cp = pltpu.make_async_copy(x_hbm.at[i], xbuf, sem)
            cp.start(); cp.wait()  # noqa: E702
            o_ref[i] = jax.lax.dot_general(
                xbuf[:], w_ref[i], (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
            return 0
        jax.lax.fori_loop(0, EO, body, 0)

    return pl.pallas_call(
        loop_kernel,
        out_shape=jax.ShapeDtypeStruct((EO, N, H), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.ANY),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((N, EK), jnp.float32),
                        pltpu.SemaphoreType.DMA],
        interpret=True,
    )(x, w)


@pytest.mark.parametrize("body", [_em_batched, _em_tiled, _em_loop],
                         ids=["batched_kernel", "tiled_kernel", "loop_kernel"])
def test_ensemble_gemm_matches_pallas(body):
    x, w = _em_inputs()
    _close(probes.ens_gemm_plain(*_t(x, w)), body(jnp.asarray(x), jnp.asarray(w)), RTOL)


def test_ensemble_gemm_matches_xla():
    # bench_ensemble_mm.py:44-46, xla_mm
    x, w = _em_inputs()
    ref = jnp.einsum("onk,okh->onh", jnp.asarray(x), jnp.asarray(w),
                     preferred_element_type=jnp.float32)
    _close(probes.ens_gemm_plain(*_t(x, w)), ref, RTOL)


def test_nop_matches_pallas():
    # bench_ensemble_mm.py:135-144, nop_kernel and pallas_nop
    def nop_kernel(x_ref, o_ref):
        o_ref[:] = x_ref[:]

    x, _ = _em_inputs()
    ref = pl.pallas_call(
        nop_kernel,
        out_shape=jax.ShapeDtypeStruct((8, EK), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(x)[0, :8, :])
    got = probes.launch_nop_plain(torch.from_numpy(x)[0, :8])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# --------------------------------------------------------------------------- #
# K4 q1: the script's module-level kernels (they need O_TILE = 16 objects)
# --------------------------------------------------------------------------- #


def _q1_inputs():
    rng = _rng(1)
    return _f32(rng, (jfs.O_TILE, N, K)), _f32(rng, (jfs.O_TILE, K, H))


@pytest.mark.parametrize("kernel", [jfs._batched_dot_kernel, jfs._unrolled_dot_kernel],
                         ids=["_batched_dot_kernel", "_unrolled_dot_kernel"])
def test_q1_sin_gemm_matches_pallas(kernel):
    x, w = _q1_inputs()
    # bench_fused_step_probe.py:96-101, pallas_fn
    f = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((jfs.O_TILE, N, H), jnp.float32),
        interpret=True)
    ref = f(jnp.asarray(x), jnp.asarray(w))
    _close(probes.ens_gemm_plain(*_t(x, w), sin=True), ref, RTOL)


def test_q1_sin_gemm_matches_xla():
    # bench_fused_step_probe.py:103-105, xla_fn
    x, w = _q1_inputs()
    ref = jnp.einsum("onk,okh->onh", jnp.sin(jnp.asarray(x)), jnp.asarray(w),
                     preferred_element_type=jnp.float32)
    _close(probes.ens_gemm_plain(*_t(x, w), sin=True), ref, RTOL)


# --------------------------------------------------------------------------- #
# K4 q2: the slab-streaming no-op over a (tiles x steps) grid
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("rows", [N, 8], ids=["ray_slab", "tiny_block"])
def test_q2_slab_stream_matches_pallas(rows):
    rng = _rng(2)
    xs = _f32(rng, (STEPS, N_TILES * O_TILE, rows, 8))
    w0 = _f32(rng, (N_TILES * O_TILE, 8, K))

    # bench_fused_step_probe.py:144-160, noop_kernel and make
    def noop_kernel(x, w0r, o):
        w = w0r[...]
        o[...] = (w[:, :1, :H] * 1.000001)[None]

    f = pl.pallas_call(
        noop_kernel,
        grid=(N_TILES, STEPS),
        in_specs=[
            pl.BlockSpec((1, O_TILE, rows, 8), lambda i, j: (j, i, 0, 0)),
            pl.BlockSpec((O_TILE, 8, K), lambda i, j: (i, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, O_TILE, 1, H), lambda i, j: (j, i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((STEPS, N_TILES * O_TILE, 1, H), jnp.float32),
        interpret=True,
    )
    ref = f(jnp.asarray(xs), jnp.asarray(w0))
    got = probes.slab_stream_plain(*_t(xs, w0), H)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# --------------------------------------------------------------------------- #
# K4 q3: the depth-4 chain over the steps grid
# --------------------------------------------------------------------------- #


def _q3_inputs():
    rng = _rng(3)
    ot = N_TILES * O_TILE
    return (_f32(rng, (STEPS, ot, N, 8), 0.1), _f32(rng, (ot, 8, K)),
            _f32(rng, (ot, K, H)), _f32(rng, (ot, H, H)))


def _mm(a, b):
    return jnp.dot(a, b, preferred_element_type=jnp.float32)


def test_q3_chain_matches_pallas():
    xs, w0, w1, w2 = _q3_inputs()
    o_tile = O_TILE

    # bench_fused_step_probe.py:192-212, kernel and f
    def kernel(x, w0r, w1r, w2r, o):
        for b in range(o_tile):
            e = jnp.sin(_mm(x[0, b], w0r[b]))
            h1 = jax.nn.relu(_mm(e, w1r[b]))
            h = h1
            for _ in range(3):
                h = jax.nn.relu(_mm(h, w2r[b]))
            o[0, b] = jnp.sum(h, axis=0, keepdims=True)

    f = pl.pallas_call(
        kernel,
        grid=(N_TILES, STEPS),
        in_specs=[
            pl.BlockSpec((1, o_tile, N, 8), lambda i, j: (j, i, 0, 0)),
            pl.BlockSpec((o_tile, 8, K), lambda i, j: (i, 0, 0)),
            pl.BlockSpec((o_tile, K, H), lambda i, j: (i, 0, 0)),
            pl.BlockSpec((o_tile, H, H), lambda i, j: (i, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, o_tile, 1, H), lambda i, j: (j, i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((STEPS, N_TILES * o_tile, 1, H), jnp.float32),
        interpret=True,
    )
    ref = f(*map(jnp.asarray, (xs, w0, w1, w2)))
    _close(probes.step_chain_plain(*_t(xs, w0, w1, w2), 4), ref, CHAIN_RTOL)


def test_q3_chain_matches_xla():
    xs, w0, w1, w2 = _q3_inputs()

    # bench_fused_step_probe.py:225-233, xla_chain
    def xla_chain(a, b, c, x):
        e = jnp.sin(jnp.einsum("sonk,okh->sonh", x, a,
                               preferred_element_type=jnp.float32))
        h = jax.nn.relu(jnp.einsum("sonh,ohg->song", e, b,
                                   preferred_element_type=jnp.float32))
        for _ in range(3):
            h = jax.nn.relu(jnp.einsum("sonh,ohg->song", h, c,
                                       preferred_element_type=jnp.float32))
        return h.sum(axis=2)

    ref = xla_chain(*map(jnp.asarray, (w0, w1, w2, xs)))
    got = probes.step_chain_plain(*_t(xs, w0, w1, w2), 4)[:, :, 0]
    _close(got, ref, CHAIN_RTOL)


# --------------------------------------------------------------------------- #
# K4 q4: compile_case's bodies, at object tiles 8 and 16 cut to 2 and 4
# --------------------------------------------------------------------------- #

_bd = ft.partial(
    jax.lax.dot_general,
    dimension_numbers=(((2,), (1,)), ((0,), (0,))),
    preferred_element_type=jnp.float32,
)


# bench_fused_step_probe.py:281-296, the three bodies
def _chained_batched(x, w0r, w1r, o):
    e = jnp.sin(_bd(x[0], w0r[...]))
    h = jax.nn.relu(_bd(e, w1r[...]))
    o[...] = jnp.sum(h, axis=1, keepdims=True)[None]


def _single_batched(x, w0r, w1r, o):
    e = jnp.sin(_bd(x[0], w0r[...]))
    o[...] = jnp.sum(e[:, :, :H], axis=1, keepdims=True)[None]


def _per_object_2d(x, w0r, w1r, o):
    for b in range(x.shape[1]):
        e = jnp.sin(jnp.dot(x[0, b], w0r[b],
                            preferred_element_type=jnp.float32))
        h = jax.nn.relu(jnp.dot(e, w1r[b],
                                preferred_element_type=jnp.float32))
        o[0, b] = jnp.sum(h, axis=0, keepdims=True)


@pytest.mark.parametrize("body,depth", [(_single_batched, 0), (_chained_batched, 1),
                                        (_per_object_2d, 1)],
                         ids=["single_batched", "chained_batched", "per_object_2d"])
@pytest.mark.parametrize("o_tile", [2, 4])
def test_q4_short_chains_match_pallas(body, depth, o_tile):
    rng = _rng(4 + o_tile)
    xs = _f32(rng, (4, o_tile, N, 8), 0.1)
    w0 = _f32(rng, (o_tile, 8, K))
    w1 = _f32(rng, (o_tile, K, H))
    # bench_fused_step_probe.py:257-273, compile_case's call
    f = pl.pallas_call(
        body,
        grid=(1, 4),
        in_specs=[
            pl.BlockSpec((1, o_tile, N, 8), lambda i, j: (j, i, 0, 0)),
            pl.BlockSpec((o_tile, 8, K), lambda i, j: (i, 0, 0)),
            pl.BlockSpec((o_tile, K, H), lambda i, j: (i, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, o_tile, 1, H), lambda i, j: (j, i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((4, o_tile, 1, H), jnp.float32),
        interpret=True,
    )
    ref = f(*map(jnp.asarray, (xs, w0, w1)))
    _close(probes.step_chain_plain(*_t(xs, w0, w1), None, depth), ref, CHAIN_RTOL)


# --------------------------------------------------------------------------- #
# K4 q5: the part term (R rays, Hp = H + 1, C cut from 512 to 128)
# --------------------------------------------------------------------------- #

PR, PHP, PC = 24, H + 1, 128
_bd_c = ft.partial(
    jax.lax.dot_general,
    dimension_numbers=(((2,), (2,)), ((0,), (0,))),
    preferred_element_type=jnp.float32,
)
_bd_r = ft.partial(
    jax.lax.dot_general,
    dimension_numbers=(((1,), (1,)), ((0,), (0,))),
    preferred_element_type=jnp.float32,
)


def _q5_inputs():
    rng = _rng(5)
    obj = N_TILES * O_TILE
    return (_f32(rng, (obj, PR, PC), 0.1), _f32(rng, (obj, PHP, PC), 0.1),
            _f32(rng, (obj, PR, PHP), 0.1))


def test_q5_t_g_matches_pallas():
    gt0, wb, hp = _q5_inputs()
    obj, r, hpd, c, o_tile = gt0.shape[0], PR, PHP, PC, O_TILE

    # bench_fused_step_probe.py:342-363, kernel and f
    def kernel(gt_ref, wb_ref, t_ref, g_ref):
        gt = gt_ref[...]
        w = wb_ref[...]
        t_ref[...] = _bd_c(gt, w)
        g_ref[...] = _bd_c(w, w)

    f = pl.pallas_call(
        kernel,
        grid=(N_TILES,),
        in_specs=[
            pl.BlockSpec((o_tile, r, c), lambda i: (i, 0, 0)),
            pl.BlockSpec((o_tile, hpd, c), lambda i: (i, 0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((o_tile, r, hpd), lambda i: (i, 0, 0)),
            pl.BlockSpec((o_tile, hpd, hpd), lambda i: (i, 0, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((obj, r, hpd), jnp.float32),
            jax.ShapeDtypeStruct((obj, hpd, hpd), jnp.float32),
        ],
        interpret=True,
    )
    gt = np.sin(gt0).astype(np.float32)
    t_ref, g_ref = f(jnp.asarray(gt), jnp.asarray(wb))
    t, g = probes.part_tg_plain(*_t(gt, wb))
    _close(t, t_ref, RTOL)
    _close(g, g_ref, RTOL)


def test_q5_part_term_matches_xla():
    gt0, wb, hp = _q5_inputs()

    # bench_fused_step_probe.py:365-380, epilogue and xla_fn
    def epilogue(t, g, h):
        num = jnp.sum(t * h, axis=-1)
        pn2 = jnp.einsum("orh,ohk,ork->or", h, g, h)
        return num + pn2

    def xla_fn(w, h, g0):
        gt = jnp.sin(g0)
        t = jnp.einsum("orc,ohc->orh", gt, w,
                       preferred_element_type=jnp.float32)
        g = jnp.einsum("ohc,okc->ohk", w, w,
                       preferred_element_type=jnp.float32)
        return epilogue(t, g, h)

    ref = xla_fn(*map(jnp.asarray, (wb, hp, gt0)))
    wb_t, hp_t, gt0_t = _t(wb, hp, gt0)
    t, g = probes.part_tg_plain(torch.sin(gt0_t), wb_t)
    _close(probes.part_epilogue(t, g, hp_t), ref, RTOL)


# bench_fused_step_probe.py:422-434, the two compile_case bodies
def _bwd_dw(gt_ref, wb_ref, dt_ref, o_ref):
    o_ref[...] = _bd_r(dt_ref[...], gt_ref[...])


def _fwd_quadratic_chained(gt_ref, wb_ref, hp_ref, o_ref):
    w = wb_ref[...]
    g = _bd_c(w, w)
    z = jax.lax.dot_general(
        hp_ref[...], g,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)
    o_ref[...] = z


@pytest.mark.parametrize("mode", ["dw", "quad"])
def test_q5_compile_cases_match_pallas(mode):
    gt0, wb, hp = _q5_inputs()
    obj, r, hpd, c, o_tile = gt0.shape[0], PR, PHP, PC, O_TILE
    body, n_out = {"dw": (_bwd_dw, (hpd, c)), "quad": (_fwd_quadratic_chained, (r, hpd))}[mode]
    # bench_fused_step_probe.py:397-408, compile_case's call
    fs = pl.pallas_call(
        body,
        grid=(N_TILES,),
        in_specs=[
            pl.BlockSpec((o_tile, r, c), lambda i: (i, 0, 0)),
            pl.BlockSpec((o_tile, hpd, c), lambda i: (i, 0, 0)),
            pl.BlockSpec((o_tile, r, hpd), lambda i: (i, 0, 0)),
        ],
        out_specs=pl.BlockSpec((o_tile,) + n_out, lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((obj,) + n_out, jnp.float32),
        interpret=True,
    )
    ref = fs(*map(jnp.asarray, (gt0, wb, hp)))
    gt_t, wb_t, hp_t = _t(gt0, wb, hp)
    got = probes.part_dw_plain(hp_t, gt_t) if mode == "dw" else probes.part_quad_plain(hp_t, wb_t)
    _close(got, ref, RTOL)


# --------------------------------------------------------------------------- #
# dispatch and refusal without a card
# --------------------------------------------------------------------------- #


def test_cpu_dispatch_runs_plain_and_counts_it():
    x, w = (torch.from_numpy(a) for a in _em_inputs())
    before = dict(probes.COUNTS)
    for schedule in probes.SCHEDULES:
        out = probes.ens_gemm(x, w, schedule)
        assert torch.equal(out, probes.ens_gemm_plain(x, w))
    assert probes.COUNTS["probes_plain"] == before["probes_plain"] + 3
    assert all(probes.COUNTS[k] == before[k] for k in probes.kernel_names())
    assert set(probes.kernel_names()) <= set(probes.COUNTS)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never falls back: a CPU tensor is refused."""
    x = torch.zeros((2, 8, 8))
    w0 = torch.zeros((2, 8, 8))
    calls = [
        lambda: probes.ens_gemm_cuda(x, w0),
        lambda: probes.launch_nop_cuda(x),
        lambda: probes.slab_stream_cuda(x[None], w0, 4),
        lambda: probes.step_chain_cuda(x[None], w0, w0, w0, 4),
        lambda: probes.part_tg_cuda(x, w0),
        lambda: probes.part_dw_cuda(x, w0),
        lambda: probes.part_quad_cuda(x, w0),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_timing_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from openobj_torch.scripts._benchlib import eager_time, scan_time

    for timer in (scan_time, eager_time):
        with pytest.raises(RuntimeError, match="CUDA"):
            timer(lambda: None)


def test_probe_drivers_measure_every_kernel_once(monkeypatch):
    """The drivers' sections at small shapes on CPU tensors, with the timers
    stubbed: every probe kernel has a case, every case names its Pallas
    site, and each case's kept output is its plain version's."""
    from openobj_torch.scripts import _benchlib
    from openobj_torch.scripts import bench_ensemble_mm as em
    from openobj_torch.scripts import bench_fused_step_probe as fs

    monkeypatch.setattr(_benchlib, "scan_time", lambda fn, args=(), **kw: (fn(*args), 1e-5)[1])
    monkeypatch.setattr(_benchlib, "eager_time", lambda fn, args=(), **kw: (fn(*args), 2e-5)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(em, "O", 3)
    monkeypatch.setattr(em, "N", N)
    monkeypatch.setattr(fs, "N", N)
    monkeypatch.setattr(fs, "STEPS", STEPS)
    rows, cases = em.run("cpu")
    answers = {}
    for name, section in fs.SECTIONS.items():
        small = {} if name in ("q1", "q4") else {"n_tiles": N_TILES, "o_tile": O_TILE}
        answers[name], more = section("cpu", **small)
        cases += more
    assert [r["which"] for r in rows] == [
        "torch_bmm", "cuda_grid", "cuda_objtile8", "cuda_persistent", "cuda_nop_launch"]
    assert set(answers["q4"].values()) == {"ok"}
    assert answers["q5"]["compile_quadratic_chained_dot"] == "ok"
    assert {c.key for c in cases} == set(probes.kernel_names())
    assert len({c.name for c in cases}) == len(cases) == 16
    for c in cases:
        script, line = c.site.split(":")
        assert (ROOT / script).is_file() and int(line) > 0
        got = c.out if isinstance(c.out, tuple) else (c.out,)
        ref = c.plain()
        for a, b in zip(got, ref if isinstance(ref, tuple) else (ref,)):
            assert torch.equal(a, b), c.name
        assert c.us == 10.0 and c.plain_us == 10.0 and c.launches == 0


@pytest.mark.parametrize("module", ["bench_ensemble_mm", "bench_fused_step_probe"])
def test_probe_scripts_exit_nonzero_without_cuda(module):
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", f"openobj_torch.scripts.{module}"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert out.stdout == ""
