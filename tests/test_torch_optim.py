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
