"""The port's per-step losses against the JAX package's ``train_frame`` on
every field path and dtype, on byte-identical ray batches
(tests/test_torch_trainer.py's ``_step_losses``): apart from that file so
that the test run's workers share the JAX compiles.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from openobj_tpu.core import trainer as jtrainer  # noqa: E402
from openobj_torch.core import trainer as ttrainer  # noqa: E402
from test_torch_trainer import CFG_KW, _step_losses  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _jax_kernel_at(monkeypatch, compute_dtype):
    """The JAX trainer's pallas path calls its kernel without the config's
    compute_dtype (trainer._loss_for_slice: the kernel runs in f32 and only
    the part loss follows compute_dtype); the port's kernels follow it, so
    the JAX kernel is handed it here."""
    from openobj_tpu.ops import fused_field as jff

    for name in ("field_apply_stacked_fused", "field_apply_fused"):
        monkeypatch.setattr(jff, name, functools.partial(getattr(jff, name),
                                                         compute_dtype=compute_dtype))


# (field_impl, overrides): f32 on both fields; bf16 through the kernels (the
# port's plain version against the JAX kernel in bf16), and at max_deg 4,
# which the kernels do not cover, through both packages' eager field in bf16
# (the JAX package's XLA field). Losses rel 1e-4 in all five: bf16's own
# rounding is the same on both sides, and where the two round an element
# differently (one bf16 ulp, after a sum in another order or the encodings'
# 1e-5 difference) AdamW's normalised step barely notices. "xla-bf16" is
# the default config at bf16 against the JAX trainer as it is: the port
# takes its kernels' plain version (the JAX kernel's numerics), the JAX
# trainer its XLA field, whose weight gradients are rounded to bf16 (8e-3
# apart on the worst leaf); measured 5.1e-5 over these 4 steps, and the
# two drift apart with more steps (2.9e-4 by step 6 of 8). "-flat": the
# step's update as adamw_update_flat in both packages (optim_impl="flat").
_STEP_CASES = {
    "xla": ("xla", {}),
    "pallas": ("pallas", {}),
    "xla-flat": ("xla", dict(optim_impl="flat")),
    "pallas-bf16": ("pallas", dict(compute_dtype="bf16")),
    "xla-bf16": ("xla", dict(compute_dtype="bf16")),
    "xla-bf16-max_deg4": ("xla", dict(compute_dtype="bf16", max_deg=4)),
}


@pytest.mark.parametrize("case", list(_STEP_CASES))
def test_step_losses_match_jax_train_frame(case, monkeypatch):
    field_impl, kw = _STEP_CASES[case]
    if field_impl == "pallas" and kw:
        _jax_kernel_at(monkeypatch, kw["compute_dtype"])
    jcfg = jtrainer.TrainConfig(field_impl=field_impl, **CFG_KW, **kw)
    tcfg = ttrainer.TrainConfig(field_impl=field_impl, **CFG_KW, **kw)
    tlosses, jlosses = _step_losses(monkeypatch, jcfg, tcfg)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert len(set(tlosses)) == len(tlosses)   # every step moved the params
