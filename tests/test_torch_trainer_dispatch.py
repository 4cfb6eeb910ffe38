"""The port's field dispatch by shape in training, against the JAX
package's ``train_frame`` on byte-identical ray batches
(tests/test_torch_trainer.py's ``_step_losses``): apart from that file so
that the test run's workers share the JAX compiles.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from openobj_tpu.core import trainer as jtrainer  # noqa: E402
from openobj_torch.core import trainer as ttrainer  # noqa: E402
from test_torch_trainer import CFG_KW, _step_losses  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


# (config overrides, fg steps through the kernels' plain version, bg steps
# through it); every other field call takes the eager field
_C1_CASES = {
    "max_deg4": (dict(max_deg=4, hidden=32, hidden_bg=128), 0, 0),
    "h32_bg16": (dict(hidden=32), 1, 1),
    "h32_bg128": (dict(hidden=32, hidden_bg=128), 1, 1),    # the tensor-core widths
}


@pytest.mark.parametrize("case", list(_C1_CASES))
def test_field_dispatch_by_shape(case, monkeypatch):
    """A shape the kernels do not cover (another PE band count) trains
    through the eager field and matches JAX's default XLA field, rel 1e-4;
    covered shapes (max_deg 5, f32, any hidden width: K1 and K2 have a
    SIMT kernel beside the tensor-core ones) take the kernels' path, their
    plain version here, on both fields. (CFG_KW's own widths, 8 and 16, are
    covered too: tests/test_torch_trainer_steps.py.)"""
    from openobj_torch.ops import fused_field as tff

    kw, fg_fused, bg_fused = _C1_CASES[case]
    cfg_kw = dict(CFG_KW, **kw)
    jcfg, tcfg = jtrainer.TrainConfig(**cfg_kw), ttrainer.TrainConfig(**cfg_kw)
    tff.reset_counts()
    tlosses, jlosses = _step_losses(monkeypatch, jcfg, tcfg)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    steps = cfg_kw["n_iters_per_frame"]
    assert tff.COUNTS["fused_field_plain"] == steps * (fg_fused + bg_fused)
    assert tff.COUNTS["field_eager"] == steps * (2 - fg_fused - bg_fused)
