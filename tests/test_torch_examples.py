"""The ports of examples/live_mapping.py, open_vocab_demo.py and
scale_check.py (examples/torch_*.py) run end to end on the CPU at a cut
(fewer frames and iterations, passed as the examples' own arguments) and
finish with finite losses; the live example's front end (segment -> track)
gives the JAX package's ids and instance images on the same frames. Their
full gates are checked on the card."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_live_mapping_front_end_matches_jax():
    from openobj_tpu.perception.segmentation import GraphSegmenter as JSegmenter
    from openobj_tpu.perception.tracking import OnlineInstanceTracker as JTracker

    live = _example("torch_live_mapping")
    ours, theirs = live.front_end(), live.front_end(JSegmenter, JTracker)
    seen = set()
    for t_wc, rgb, depth in live.stream(3):
        m_t, ids_t, inst_t = live.segment_and_track(*ours, rgb, depth, t_wc)
        m_j, ids_j, inst_j = live.segment_and_track(*theirs, rgb, depth, t_wc)
        assert [int(i) for i in ids_t] == [int(i) for i in ids_j]
        assert len(m_t) == len(m_j) and all(np.array_equal(a, b) for a, b in zip(m_t, m_j))
        np.testing.assert_array_equal(np.asarray(inst_t), np.asarray(inst_j))
        seen.update(int(i) for i in ids_t)
    assert len(seen - {0}) == 2          # both spheres tracked


@pytest.mark.parametrize("name, argv", [
    ("torch_live_mapping", ["--frames", "3", "--iters", "4"]),
    ("torch_open_vocab_demo", ["--frames", "3", "--iters", "4"]),
    ("torch_scale_check", ["--frames", "3", "--iters", "2", "--max-hit-rays", "512"]),
])
def test_example_cut_runs(name, argv, tmp_path):
    if name == "torch_open_vocab_demo":
        argv = argv + ["--out", str(tmp_path)]
    res = _example(name).main(["--device", "cpu", *argv])
    assert len(res["losses"]) == int(argv[1]) and np.isfinite(res["losses"]).all()
    if name == "torch_scale_check":
        assert res["buckets"] == [8, 16, 32] and res["rendered"] > 0
    if name == "torch_open_vocab_demo":
        assert res["meshed"] == 2 and Path(res["html"]).stat().st_size > 0


def test_convergence_example_needs_a_card_by_default():
    """Its CLI defaults to the card, as every other example's does: without
    one it stops and names the device instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    conv = _example("torch_synthetic_convergence")
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        conv.main([])
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        conv.run()
