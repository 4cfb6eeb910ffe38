"""The port's dataset preflight (openobj_torch.scripts.check_dataset)
against scripts/check_dataset.py: tests/test_check_dataset.py's fixtures (a
contract-complete Replica mount and its broken variants) and a ScanNet mount
with .jpg colour, through both scripts, give the same PASS/WARN/FAIL rows
and the same exit code."""

import json
import os
import pickle
import runpy
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
from torch_threads import one_torch_thread  # noqa: E402,F401

sys.path.insert(0, os.path.dirname(__file__))

from openobj_torch.scripts import check_dataset as tcheck  # noqa: E402
from test_dataset_cli import _config_json, write_replica_dataset  # noqa: E402

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts", "check_dataset.py")


def _rows(out: str) -> list[str]:
    return [line for line in out.splitlines() if line.startswith(("[PASS]", "[WARN]", "[FAIL]"))]


def _run_both(argv, capsys):
    old = sys.argv
    sys.argv = ["check_dataset.py"] + argv
    try:
        with pytest.raises(SystemExit) as e:
            runpy.run_path(SCRIPT, run_name="__main__")
    finally:
        sys.argv = old
    jrc, jout = int(e.value.code or 0), capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        tcheck.main(argv)
    trc, tout = int(e.value.code or 0), capsys.readouterr().out
    return (jrc, _rows(jout)), (trc, _rows(tout))


def _scannet_mount(tmp_path):
    """A ScanNet scan (color/<i>.jpg, depth/<i>.png, intrinsics, the
    association artifacts) and its config."""
    root = tmp_path / "scan"
    for d in ("color", "depth", "instance_our", "class_our", "intrinsic"):
        os.makedirs(root / d)
    rng = np.random.default_rng(0)
    h, w, n_raw = 48, 64, 21
    for i in range(n_raw):
        cv2.imwrite(str(root / "color" / f"{i}.jpg"),
                    rng.integers(0, 255, (96, 128, 3)).astype(np.uint8))
        cv2.imwrite(str(root / "depth" / f"{i}.png"),
                    (rng.uniform(0.5, 3.0, (h, w)) * 1000).astype(np.uint16))
    for ino in range(3):
        inst = np.ones((h, w), np.uint16)
        inst[10:30, 20:50] = 4
        cv2.imwrite(str(root / "instance_our" / f"semantic_instance_{ino}.png"), inst)
    np.savetxt(str(root / "traj_w_c.txt"), np.stack([np.eye(4).reshape(-1)] * n_raw),
               delimiter=" ")
    k = np.eye(4)
    k[0, 0], k[1, 1], k[0, 2], k[1, 2] = 42.0, 43.0, 31.5, 23.5
    np.savetxt(str(root / "intrinsic" / "intrinsic_depth.txt"), k)

    def unit(n):
        v = rng.normal(size=n)
        return v / np.linalg.norm(v)

    for name, dim in (("clipfeat", 512), ("capfeat", 384)):
        with open(root / f"object_{name}.pkl", "wb") as f:
            pickle.dump([{1: unit(dim), 4: unit(dim)} for _ in range(3)], f)
    with open(_config_json(str(root), tmp_path)) as f:
        cfg = json.load(f)
    cfg["dataset"]["format"] = "ScanNet"
    cfg["trainer"]["part_mode"] = 0
    cfg_path = tmp_path / "scannet.json"
    cfg_path.write_text(json.dumps(cfg))
    return str(root), str(cfg_path)


CASES = ["ready", "root_override", "missing_clipfeat", "truncated_poses",
         "missing_instance", "scannet_ready", "scannet_corrupt_colour"]


@pytest.mark.parametrize("case", CASES)
def test_rows_equal_to_the_jax_script(case, tmp_path, capsys):
    if case.startswith("scannet"):
        root, cfg = _scannet_mount(tmp_path)
    else:
        root = str(tmp_path / "scene")
        os.makedirs(root)
        write_replica_dataset(root)
        cfg = _config_json(root, tmp_path)
    argv = [cfg]
    if case == "root_override":
        os.makedirs(tmp_path / "empty")
        argv += ["--root", str(tmp_path / "empty")]
    elif case == "missing_clipfeat":
        os.remove(os.path.join(root, "object_clipfeat.pkl"))
    elif case == "truncated_poses":
        t = np.loadtxt(os.path.join(root, "traj_w_c.txt"), delimiter=" ")
        np.savetxt(os.path.join(root, "traj_w_c.txt"), t[:3], delimiter=" ")
    elif case == "missing_instance":
        os.remove(os.path.join(root, "instance_our", "semantic_instance_1.png"))
    elif case == "scannet_corrupt_colour":       # a sampled frame that decodes in neither
        with open(os.path.join(root, "color", "10.jpg"), "wb") as f:
            f.write(b"not a JPEG file")
    (jrc, jrows), (trc, trows) = _run_both(argv, capsys)
    assert trows == jrows
    assert trc == jrc == (0 if case.endswith("ready") else 1)
    assert len(trows) >= (2 if case in ("root_override", "missing_clipfeat") else 10)
