"""The port of examples/synthetic_convergence.py passes the example's own
asserts (loss drops 2x, held-out depth MAE < 0.15 m, colour MAE < 0.1)."""

import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent


def test_port_synthetic_convergence_cpu():
    spec = importlib.util.spec_from_file_location(
        "torch_synthetic_convergence", ROOT / "examples" / "torch_synthetic_convergence.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.run(device="cpu")
    mod.check(res)
    assert len(res["losses"]) == 6
