"""The port's slot-masked AdamW against the JAX package's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from openobj_tpu.core import optim as joptim  # noqa: E402
from openobj_tpu.models import object_field as jof  # noqa: E402
from openobj_torch import convert  # noqa: E402
from openobj_torch.core import optim as toptim  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

# same formulas and operation order; the float32 power b^t may differ by an
# ulp between the two libraries
RTOL, ATOL = 2e-6, 1e-9


def _grads(rng, tree):
    return jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32) * 0.1, tree)


@pytest.mark.parametrize("stacked", [True, False])
def test_adamw_five_steps_match_jax(stacked):
    rng = np.random.default_rng(0)
    if stacked:
        p = jof.init_stacked_fields(jax.random.PRNGKey(0), 4, hidden=8, clip_size=6)
        jstate = joptim.init_adamw_state(p, n_slots=4)
        active = np.array([True, False, True, False])
    else:
        p = jof.init_field_params(jax.random.PRNGKey(0), hidden=8, clip_size=6)
        jstate = joptim.init_adamw_state(p)
        active = None
    p_np = jax.tree.map(np.asarray, p)
    tp = convert.params_from_numpy(p_np, "cpu")
    tstate = toptim.init_adamw_state(tp, n_slots=4 if stacked else None)
    t_active = None if active is None else torch.from_numpy(active)
    for _ in range(5):
        g = _grads(rng, p_np)
        p, jstate = joptim.adamw_update(p, g, jstate, lr=1e-3, weight_decay=0.013,
                                        active=active)
        tp, tstate = toptim.adamw_update(tp, convert.params_from_numpy(g, "cpu"), tstate,
                                         lr=1e-3, weight_decay=0.013, active=t_active)
    for name, jt, tt in (("params", p, tp), ("mu", jstate.mu, tstate.mu),
                         ("nu", jstate.nu, tstate.nu)):
        jn = jax.tree.map(np.asarray, jt)
        for path, leaf in toptim.flatten_with_path(tt):
            ref = jn
            for k in path:
                ref = ref[k]
            np.testing.assert_allclose(leaf.numpy(), ref, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} {path}")
    np.testing.assert_array_equal(tstate.count.numpy(), np.asarray(jstate.count))

    # the PE scale never moves; dead slots are bit-identical to the start
    p0 = convert.params_from_numpy(p_np, "cpu")
    assert torch.equal(tp["pe"]["scale"], p0["pe"]["scale"])
    if stacked:
        for path, leaf in toptim.flatten_with_path(tp):
            ref = p0
            for k in path:
                ref = ref[k]
            for dead in (1, 3):
                assert torch.equal(leaf[dead], ref[dead]), path
        for tree in (tstate.mu, tstate.nu):
            for path, leaf in toptim.flatten_with_path(tree):
                assert not leaf[1].any() and not leaf[3].any(), path
        assert tstate.count.tolist() == [5, 0, 5, 0]


def test_reset_slot_zeroes_only_its_slot():
    gen = torch.Generator().manual_seed(0)
    from openobj_torch.models import object_field as tof

    p = tof.init_stacked_fields(gen, 3, hidden=4, clip_size=4, device="cpu")
    st = toptim.init_adamw_state(p, n_slots=3)
    g = tof.tree_map(lambda x: torch.ones_like(x), p)
    _, st = toptim.adamw_update(p, g, st, lr=1e-3, weight_decay=0.0,
                                active=torch.tensor([True, True, True]))
    st2 = toptim.reset_slot(st, 1)
    assert st2.count.tolist() == [1, 0, 1]
    for path, leaf in toptim.flatten_with_path(st2.mu):
        if "scale" in path:
            continue
        assert not leaf[1].any() and leaf[0].any() and leaf[2].any(), path
    # the input state is left as it was
    assert st.count.tolist() == [1, 1, 1]


def test_jax_reset_slot_agrees():
    p = jof.init_stacked_fields(jax.random.PRNGKey(1), 3, hidden=4, clip_size=4)
    js = joptim.init_adamw_state(p, n_slots=3)
    g = jax.tree.map(jnp.ones_like, p)
    _, js = joptim.adamw_update(p, g, js, lr=1e-3, weight_decay=0.0,
                                active=jnp.array([True, True, True]))
    js = joptim.reset_slot(js, 2)
    ts = convert.train_state_from_numpy(
        {"fg_params": jax.tree.map(np.asarray, p),
         "fg_opt": jax.tree.map(np.asarray, js), "bg_params": None, "bg_opt": None}, "cpu")
    assert ts.fg_opt.count.tolist() == [1, 1, 0]
    assert ts.bg_params is None and ts.n_slots == 3


# the flat update: one step over every trainable leaf at once
FLAT_RTOL = 1e-6     # max |d| / max |ref| per leaf: the float32 b^t may differ by an ulp


def _state_from_numpy(p_np, stacked, rng):
    """(JAX params and state, port params and state) of the same numpy
    values: random moments and, stacked, per-slot counts."""
    m = jax.tree.map(lambda x: (0.01 * rng.normal(size=x.shape)).astype(np.float32), p_np)
    v = jax.tree.map(lambda x: (1e-4 * rng.random(x.shape)).astype(np.float32), p_np)
    count = np.array([3, 0, 1, 7], np.int32) if stacked else np.array(2, np.int32)
    jstate = joptim.AdamWState(mu=jax.tree.map(jnp.asarray, m), nu=jax.tree.map(jnp.asarray, v),
                               count=jnp.asarray(count))
    tstate = toptim.AdamWState(mu=convert.params_from_numpy(m, "cpu"),
                               nu=convert.params_from_numpy(v, "cpu"),
                               count=torch.from_numpy(count))
    return jax.tree.map(jnp.asarray, p_np), jstate, convert.params_from_numpy(p_np, "cpu"), tstate


@pytest.mark.parametrize("stacked", [True, False])
def test_adamw_flat_matches_jax(stacked):
    """The port's plain flat update against the JAX adamw_update_flat over
    five steps from a state with moments and counts (stacked: two slots
    frozen, one of them with a count of its own)."""
    rng = np.random.default_rng(1)
    if stacked:
        p = jof.init_stacked_fields(jax.random.PRNGKey(2), 4, hidden=8, clip_size=6)
        active = np.array([True, False, True, False])
    else:
        p = jof.init_field_params(jax.random.PRNGKey(2), hidden=8, clip_size=6)
        active = None
    p_np = jax.tree.map(np.asarray, p)
    jp, jstate, tp, tstate = _state_from_numpy(p_np, stacked, rng)
    t_active = None if active is None else torch.from_numpy(active)
    for _ in range(5):
        g = _grads(rng, p_np)
        jp, jstate = joptim.adamw_update_flat(jp, g, jstate, lr=1e-3, weight_decay=0.013,
                                              active=active)
        tp, tstate = toptim.adamw_update_flat(tp, convert.params_from_numpy(g, "cpu"), tstate,
                                              lr=1e-3, weight_decay=0.013, active=t_active)
    for jt, tt in ((jp, tp), (jstate.mu, tstate.mu), (jstate.nu, tstate.nu)):
        jn = dict(toptim.flatten_with_path(jax.tree.map(np.asarray, jt)))
        for path, leaf in toptim.flatten_with_path(tt):
            scale = float(np.abs(jn[path]).max()) + 1e-30
            assert float(np.abs(leaf.numpy() - jn[path]).max()) / scale <= FLAT_RTOL, path
    np.testing.assert_array_equal(tstate.count.numpy(), np.asarray(jstate.count))
    assert toptim.COUNTS["adamw_flat"] == 0    # the CPU runs the plain version


@pytest.mark.parametrize("stacked", [True, False])
def test_adamw_flat_plain_bit_equal_to_tree(stacked):
    """The plain flat update equals the per-leaf adamw_update bit for bit
    (the same operations on each element), with gradients as autograd
    leaves them for the packed field (views slots apart) and one absent,
    and returns leaves of their own, leaving its inputs as they were."""
    from openobj_torch.models import object_field as tof

    gen = torch.Generator().manual_seed(4)
    if stacked:
        p = tof.init_stacked_fields(gen, 5, hidden=8, clip_size=6, device="cpu")
        st = toptim.init_adamw_state(p, n_slots=5)
        active = torch.tensor([True, False, True, True, False])
    else:
        p = tof.init_field_params(gen, hidden=8, clip_size=6, device="cpu")
        st = toptim.init_adamw_state(p)
        active = None
    paths = [q for q, _ in toptim.flatten_with_path(p)]
    tree, flat = (p, st), (p, st)
    for step in range(4):
        packed = torch.randn((5, 4000) if stacked else (4000,), generator=gen)
        g, at = {}, 0
        for path, x in toptim.flatten_with_path(p):
            k = x[0].numel() if stacked else x.numel()
            view = (packed[:, at:at + k] if stacked else packed[at:at + k]).view(x.shape)
            toptim.set_path(g, path, None if step == 2 and "out_clip" in path else view)
            at += k
        before = {q: x.clone() for q, x in toptim.flatten_with_path(flat[0])}
        inputs = flat
        tree = toptim.adamw_update(tree[0], g, tree[1], 1e-3, 0.013, active)
        flat = toptim.adamw_update_flat_plain(flat[0], g, flat[1], 1e-3, 0.013, active)
        for q, x in toptim.flatten_with_path(flat[0]):
            assert x.is_contiguous(), q
        for q, x in toptim.flatten_with_path(inputs[0]):
            assert torch.equal(before[q], x), (step, q)
    for a, b in ((tree[0], flat[0]), (tree[1].mu, flat[1].mu), (tree[1].nu, flat[1].nu)):
        fa, fb = dict(toptim.flatten_with_path(a)), dict(toptim.flatten_with_path(b))
        assert sorted(fa) == sorted(fb) == sorted(paths)
        for q in fa:
            assert fa[q].dtype == fb[q].dtype and torch.equal(fa[q], fb[q]), q
    assert torch.equal(tree[1].count, flat[1].count)
    # the PE scale is never updated and passes through as the same tensor
    assert flat[0]["pe"]["scale"] is p["pe"]["scale"]
