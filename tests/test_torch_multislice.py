"""Scene-level scale-out in the port (openobj_torch.parallel.multislice) and
its multi-scene runner (openobj_torch.scripts.run_scenes): the cases of
tests/test_multislice.py with CPU device lists, the current device each
worker thread sets, ``run_scenes --parallel 2 --device cpu``, and the ScanNet
``--perception auto`` case of tests/test_perception_cli.py on the same raw
scan in both packages, with equal artifacts."""

import json
import os
import shutil
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
from torch_threads import one_torch_thread  # noqa: E402,F401

sys.path.insert(0, os.path.dirname(__file__))

from openobj_torch.parallel import multislice  # noqa: E402
from openobj_torch.scripts import run_scenes as trun  # noqa: E402
from test_dataset_cli import _config_json, write_replica_dataset  # noqa: E402

CPUS = [torch.device("cpu", i) for i in range(8)]


class TestDeviceGroups:
    def test_even_split(self):
        groups = multislice.device_groups(2, CPUS[::-1])
        assert [len(g) for g in groups] == [4, 4]
        ids = [d.index for g in groups for d in g]
        assert ids == sorted(ids)       # contiguous by index

    def test_uneven_split(self):
        assert [len(g) for g in multislice.device_groups(3, CPUS)] == [3, 3, 2]

    def test_bounds(self):
        with pytest.raises(ValueError):
            multislice.device_groups(0, CPUS)
        with pytest.raises(ValueError):
            multislice.device_groups(9, CPUS)

    def test_default_devices_are_the_cards(self):
        assert multislice.default_devices() == [
            torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class TestSceneShard:
    def test_round_robin(self):
        scenes = list("abcdef")
        assert multislice.shard_scene_list(scenes, "0:2") == ["a", "c", "e"]
        assert multislice.shard_scene_list(scenes, "1:2") == ["b", "d", "f"]
        assert multislice.shard_scene_list(scenes, "2:4") == ["c"]

    def test_bad_shard(self):
        with pytest.raises(ValueError):
            multislice.shard_scene_list([], "3:2")


class TestRunParallel:
    def test_tasks_pinned_to_groups(self):
        """Each task computes on its group's first device, in its own thread
        (the four tasks meet at a barrier, so each group's thread takes one)."""
        groups = multislice.device_groups(4, CPUS)
        all_four = threading.Barrier(4, timeout=30)

        def task(devices):
            all_four.wait()
            x = torch.ones(4, device=devices[0]) * 2.0
            return float(x.sum()), devices[0].index, threading.get_ident()

        results = multislice.run_parallel([(f"t{i}", task) for i in range(4)], groups=groups)
        assert all(r.ok for r in results)
        assert sorted(r.result[1] for r in results) == [g[0].index for g in groups]
        assert len({r.result[2] for r in results}) == 4
        assert all(r.result[0] == 8.0 for r in results)

    def test_worker_sets_the_current_card(self, monkeypatch):
        """On card groups every worker thread makes its group's first card
        current (torch.cuda.set_device, the counterpart of
        jax.default_device) before its tasks run."""
        current = {}
        monkeypatch.setattr(torch.cuda, "set_device",
                            lambda d: current.__setitem__(threading.get_ident(), d))
        groups = multislice.device_groups(2, [torch.device("cuda", i) for i in range(4)])
        both = threading.Barrier(2, timeout=30)

        def task(devs, wait):
            if wait:            # the first two tasks meet: one in each thread
                both.wait()
            return current.get(threading.get_ident()), devs[0]

        results = multislice.run_parallel(
            [(f"t{i}", lambda devs, i=i: task(devs, i < 2)) for i in range(5)], groups=groups)
        assert all(r.ok for r in results)
        assert all(r.result[0] == r.result[1] for r in results)
        assert {r.result[1] for r in results} == {torch.device("cuda", 0),
                                                  torch.device("cuda", 2)}

    def test_more_tasks_than_groups_queue(self):
        results = multislice.run_parallel(
            [(f"t{i}", lambda devs, i=i: i * 10) for i in range(5)],
            groups=multislice.device_groups(2, CPUS))
        assert [r.result for r in results] == [0, 10, 20, 30, 40]

    def test_exception_isolated(self):
        def boom(devices):
            raise RuntimeError("scene exploded")

        results = multislice.run_parallel(
            [("bad", boom), ("good", lambda devs: 1)],
            groups=multislice.device_groups(2, CPUS))
        assert not results[0].ok and "exploded" in str(results[0].error)
        assert results[1].ok and results[1].result == 1


def _replica_configs(tmp_path, names, iters=3):
    cfg_dir = tmp_path / "configs"
    os.makedirs(cfg_dir)
    for seed, name in enumerate(names):
        root = tmp_path / "data" / name
        write_replica_dataset(str(root), n_raw_frames=20, rng=np.random.default_rng(seed))
        with open(_config_json(str(root), tmp_path)) as f:
            cfg = json.load(f)
        cfg["render"]["iters_per_frame"] = iters
        cfg["vis"]["if_render"] = 0
        cfg["vis"]["if_obj"] = 0
        with open(cfg_dir / f"{name}.json", "w") as f:
            json.dump(cfg, f)
    return cfg_dir


class TestParallelScenesDriver:
    def test_two_scenes_concurrently(self, tmp_path):
        """run_scenes --parallel 2 --device cpu: two scenes train at once in
        two worker threads, both produce full artifacts, each with its own
        frame timings (thread-local profiling)."""
        cfg_dir = _replica_configs(tmp_path, ("sceneA", "sceneB"))
        out = tmp_path / "runs"
        trun.main([str(cfg_dir), "--out", str(out), "--parallel", "2", "--max-frames", "2",
                   "--device", "cpu"])
        with open(out / "summary.json") as f:
            summary = json.load(f)
        for name in ("sceneA", "sceneB"):
            assert summary[name]["status"] == "ok", summary[name]
            assert summary[name]["objects"] >= 1
            assert os.path.exists(out / name / "map_vis.pkl.gz")
            assert any(k.startswith("frame") for k in summary[name]["timing"])

    def test_scene_shard_cli(self, tmp_path):
        """--scene-shard limits this launch to its slice of the list."""
        cfg_dir = _replica_configs(tmp_path, ("sceneA",))
        shutil.copy(cfg_dir / "sceneA.json", cfg_dir / "sceneB.json")
        out = tmp_path / "runs"
        trun.main([str(cfg_dir), "--out", str(out), "--scene-shard", "1:2",
                   "--max-frames", "1", "--skip-export", "--device", "cpu"])
        with open(out / "summary.json") as f:
            assert list(json.load(f)) == ["sceneB"]

    def test_data_root_rewrites_the_path(self, tmp_path):
        """--data-root points each scene at <data-root>/<scene>, through a
        config written into the scene's logdir: the port's train CLI leaves
        a config already there in place (the JAX train CLI copies it onto
        itself, and its run_scenes reports the scene failed)."""
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
        import run_scenes as jrun

        cfg_dir = _replica_configs(tmp_path, ("sceneA",), iters=2)
        with open(cfg_dir / "sceneA.json") as f:
            cfg = json.load(f)
        cfg["dataset"]["path"] = "/nonexistent"
        with open(cfg_dir / "sceneA.json", "w") as f:
            json.dump(cfg, f)
        args = [str(cfg_dir), "--data-root", str(tmp_path / "data"), "--max-frames", "1",
                "--skip-export"]
        summary = trun.main(args + ["--out", str(tmp_path / "t"), "--device", "cpu"])
        assert summary["sceneA"]["status"] == "ok", summary
        with open(tmp_path / "t" / "sceneA" / "config.json") as f:
            assert json.load(f)["dataset"]["path"] == str(tmp_path / "data" / "sceneA")
        jrun.main(args + ["--out", str(tmp_path / "j")])
        with open(tmp_path / "j" / "summary.json") as f:
            status = json.load(f)["sceneA"]["status"]
        assert status.startswith("failed") and "same file" in status


def test_scannet_perception_auto_equal_to_jax(tmp_path):
    """The ScanNet --perception auto case of tests/test_perception_cli.py:
    one raw scan (color/*.jpg, depth/*.png, intrinsics) copied for each
    package, run_scenes in each (the JAX one with --skip-export: its
    meshing's compile alone takes ~30 s here); both runs succeed, every
    perception artifact is equal (the JPEG colour decoded alike), both train
    a checkpoint for the same instances and write the same files, the
    port's run adding its bundle."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
    import run_scenes as jrun
    from test_perception_cli import H, W, write_scannet_raw
    from test_torch_perception_cli import _assert_trees_equal

    raw = tmp_path / "raw"
    write_scannet_raw(str(raw), n_raw_frames=20)
    summaries, scans = {}, {}
    for pkg, run in (("jax", jrun.main), ("torch", trun.main)):
        scan = tmp_path / pkg / "scan"
        shutil.copytree(raw, scan)
        cfg = {
            "dataset": {"path": str(scan), "format": "ScanNet"},
            "optimizer": {"args": {"lr": 1e-3, "weight_decay": 0.013}},
            "trainer": {"stride": 10, "scale": 1000.0, "part_mode": 0},
            "render": {"depth_range": [0.0, 8.0], "n_bins": 9, "n_bins_cam2surface": 1,
                       "n_bins_cam2surface_bg": 5, "iters_per_frame": 10,
                       "n_per_optim": 24, "n_per_optim_bg": 24},
            "model": {"n_unidir_funcs": 5, "obj_scale": 2.0, "bg_scale": 5.0,
                      "surface_eps": 0.1, "other_eps": 0.05, "keyframe_buffer_size": 4,
                      "keyframe_step": 25, "keyframe_step_bg": 50, "window_size": 2,
                      "window_size_bg": 2, "hidden_feature_size": 8,
                      "hidden_feature_size_bg": 8, "clip_point_feature_size": 8},
            "camera": {"w": W, "h": H, "mw": 0, "mh": 0},
            "vis": {"if_render": 0},
        }
        cfg_dir = tmp_path / pkg / "configs"
        os.makedirs(cfg_dir)
        with open(cfg_dir / "scan.json", "w") as f:
            json.dump(cfg, f)
        out = tmp_path / pkg / "runs"
        run([str(cfg_dir), "--out", str(out), "--perception", "auto"]
            + (["--device", "cpu"] if pkg == "torch" else ["--skip-export"]))
        with open(out / "summary.json") as f:
            summaries[pkg] = json.load(f)
        scans[pkg] = scan
    assert summaries["jax"]["scan"]["status"] == summaries["torch"]["scan"]["status"] == "ok"
    assert summaries["torch"]["scan"]["objects"] >= 1
    runs = {pkg: tmp_path / pkg / "runs" / "scan" for pkg in scans}
    assert sorted(os.listdir(runs["torch"] / "ckpt")) == sorted(os.listdir(runs["jax"] / "ckpt"))
    assert sorted(os.listdir(runs["torch"])) == sorted(os.listdir(runs["jax"]) + ["map_vis.pkl.gz"])
    for pkg in scans:       # the perception's outputs alone, in each copy
        for d in ("color", "depth", "intrinsic"):
            shutil.rmtree(scans[pkg] / d)
        os.remove(scans[pkg] / "traj_w_c.txt")
    assert os.path.exists(scans["torch"] / "instance_our" / "semantic_instance_0.png")
    _assert_trees_equal(str(scans["jax"]), str(scans["torch"]))
