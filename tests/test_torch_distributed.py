"""Two processes joined by torch.distributed with gloo (the port's
openobj_torch.parallel.distributed, as tests/test_distributed.py runs the
JAX package's on two CPU processes): each joins the group, takes its scene
shard, trains it end to end and meets the other at a collective and a
barrier; then two processes of ``run_scenes --distributed --device cpu``
split a directory of scene configs between them."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

sys.path.insert(0, os.path.dirname(__file__))

from test_dataset_cli import _config_json, write_replica_dataset  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import json, sys
sys.modules["jax"] = None          # the port stands alone
pid, port, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]

import numpy as np
import torch
import torch.distributed as dist
from openobj_torch.parallel import distributed, multislice

distributed.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid, device="cpu")
assert dist.get_world_size() == 2 and dist.get_rank() == pid and dist.get_backend() == "gloo"

scenes = ["sceneA", "sceneB", "sceneC"]
mine = multislice.shard_scene_list(scenes, distributed.process_scene_shard())

from openobj_torch.core import trainer
from openobj_torch.core.scene import Camera, SceneMapper
from openobj_torch.data import synthetic

losses = {}
for name in mine:
    cam = Camera(width=32, height=24, fx=20.0, fy=20.0, cx=16.0, cy=12.0)
    cfg = trainer.TrainConfig(n_iters_per_frame=3, win_size=2, n_samples_per_frame=8,
                              win_size_bg=2, n_samples_per_frame_bg=16,
                              hidden=16, hidden_bg=16, clip_size=4)
    m = SceneMapper(cam, cfg, frame_capacity=6, initial_bucket=4, device="cpu")
    dirs = cam.ray_dirs("cpu").numpy()
    for rgb, depth, inst, t_wc in synthetic.make_sequence(
            synthetic.default_scene(n_spheres=1), dirs, 3):
        m.process_frame(rgb, depth, inst, t_wc)
    m.finish()
    losses[name] = float(m.loss_history[-1])

counts = [torch.zeros(1, dtype=torch.int64) for _ in range(2)]
dist.all_gather(counts, torch.tensor([len(mine)]))
distributed.barrier("end")
dist.destroy_process_group()
with open(out_path, "w") as f:
    json.dump({"pid": pid, "scenes": mine, "losses": losses,
               "allgather_counts": [int(c) for c in counts]}, f)
"""

_RUN_SCENES_CHILD = r"""
import sys
sys.modules["jax"] = None
pid, port, cfg_dir, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
import torch.distributed as dist
from openobj_torch.parallel import distributed
from openobj_torch.scripts import run_scenes

run_scenes.main([cfg_dir, "--out", out, "--distributed", f"127.0.0.1:{port}",
                 "--num-processes", "2", "--process-id", str(pid), "--device", "cpu",
                 "--max-frames", "1", "--skip-export"])
distributed.barrier("run_scenes")
dist.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_pair(code, args_of):
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(pid), port, *args_of(pid)],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for pid in range(2)]
    for p in procs:
        try:
            o, e = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"rc={p.returncode}\n{o}\n{e}"


class TestTwoProcessDistributed:
    def test_scene_shard_training(self, tmp_path):
        outs = [str(tmp_path / f"proc{pid}.json") for pid in range(2)]
        _run_pair(_CHILD, lambda pid: [outs[pid]])
        results = []
        for o in outs:
            with open(o) as f:
                results.append(json.load(f))
        assert results[0]["scenes"] == ["sceneA", "sceneC"]
        assert results[1]["scenes"] == ["sceneB"]
        for r in results:
            assert r["losses"] and all(np.isfinite(v) for v in r["losses"].values())
            assert r["allgather_counts"] == [2, 1]

    def test_run_scenes_distributed(self, tmp_path):
        """--distributed with no --scene-shard: each process takes rank:world
        of the scene list and trains it."""
        cfg_dir = tmp_path / "configs"
        os.makedirs(cfg_dir)
        for seed, name in enumerate(("sceneA", "sceneB")):
            root = tmp_path / "data" / name
            write_replica_dataset(str(root), n_raw_frames=20, rng=np.random.default_rng(seed))
            with open(_config_json(str(root), tmp_path)) as f:
                cfg = json.load(f)
            cfg["render"]["iters_per_frame"] = 2
            cfg["vis"]["if_render"] = 0
            cfg["vis"]["if_obj"] = 0
            with open(cfg_dir / f"{name}.json", "w") as f:
                json.dump(cfg, f)
        outs = [str(tmp_path / f"runs{pid}") for pid in range(2)]
        _run_pair(_RUN_SCENES_CHILD, lambda pid: [str(cfg_dir), outs[pid]])
        for pid, name in enumerate(("sceneA", "sceneB")):
            with open(os.path.join(outs[pid], "summary.json")) as f:
                summary = json.load(f)
            assert list(summary) == [name]
            assert summary[name]["status"] == "ok", summary
            assert os.path.exists(os.path.join(outs[pid], name, "scene_state.npz"))
