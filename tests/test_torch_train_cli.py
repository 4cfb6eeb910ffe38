"""The port's training command line (openobj_torch.train.main) on the CPU,
on tests/test_dataset_cli.py's Replica fixture written by the test; its
semantic assignment and the query functions it uses against the JAX
package's.

Tolerances: ``assign_all_semantics`` and ``assign_semantics`` equal; the
part-feature PCA colours within 1e-5, signs included; the object queries
within 1e-12 (float64 sums in the same order).
"""

import copy
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")

from openobj_tpu import train as jtrain  # noqa: E402
from openobj_tpu.viz import query as jquery  # noqa: E402
from openobj_torch import train as ttrain  # noqa: E402
from openobj_torch.config import load_scene_config, make_mapper  # noqa: E402
from openobj_torch.core.checkpoint import load_scene  # noqa: E402
from openobj_torch.viz import query as tquery  # noqa: E402
from test_dataset_cli import _config_json, _unit, write_replica_dataset  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

PCA_ATOL = 1e-5
QUERY_ATOL = 1e-12


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One end-to-end run of the CLI on the CPU (4 frames, renders, meshes)."""
    tmp = tmp_path_factory.mktemp("cli")
    root = str(tmp / "scene")
    write_replica_dataset(root, n_raw_frames=40)
    cfg_path = _config_json(root, tmp)
    rng = np.random.default_rng(3)
    names = ["wall", "floor", "ceiling", "ball", "chair"]
    cf = str(tmp / "classes.npz")
    np.savez(cf, names=np.array(names),
             clipfeat=np.stack([_unit(rng, 512) for _ in names]),
             capfeat=np.stack([_unit(rng, 384) for _ in names]))
    logdir = str(tmp / "logs")
    ttrain.main(["--config", cfg_path, "--logdir", logdir, "--class-features", cf,
                 "--device", "cpu"])
    return SimpleNamespace(root=root, cfg_path=cfg_path, logdir=logdir, classes=cf)


def test_end_to_end(run):
    logdir = run.logdir
    # checkpoints for bg + 2 objects
    ckpts = sorted(os.listdir(os.path.join(logdir, "ckpt")))
    assert "0" in ckpts and len(ckpts) >= 3
    meshes = os.listdir(os.path.join(logdir, "scene_mesh"))
    assert len(meshes) >= 1
    assert os.path.exists(os.path.join(logdir, "cam_pose", "twc_frame.npz"))
    assert os.path.exists(os.path.join(logdir, "scene_state.npz"))
    timing = json.load(open(os.path.join(logdir, "timing.json")))
    assert sorted(timing) == [f"frame {i}" for i in range(4)]
    renders = os.listdir(os.path.join(logdir, "render"))
    for kind in ("rgb_", "maskid_", "depth_", "inst_"):
        assert any(r.startswith(kind) for r in renders), kind
    mapping = json.load(open(os.path.join(logdir, "render", "mapping_class.json")))
    assert mapping["0"] == 0                       # the background is the wall
    assert os.path.exists(os.path.join(logdir, "cfg.json"))


def test_assign_all_semantics_matches(run):
    """On the same mapper (the run's frames ingested, features
    registered): the port's mapping and the JAX package's."""
    from openobj_torch.data.loaders import init_loader, make_dataset

    scfg = load_scene_config(run.cfg_path)
    m = make_mapper(scfg, frame_capacity=8, device="cpu")
    for s in init_loader(make_dataset(scfg)):
        m.process_frame(s.rgb, s.depth, s.inst, s.t_wc, bboxes=s.bboxes,
                        partfeat=s.part_feat, obj_clip=s.obj_clip, obj_cap=s.obj_cap,
                        train=False)
    assert m.n_objects >= 2
    feats = ttrain.load_class_features(run.classes)
    jfeats = jtrain.load_class_features(run.classes)
    assert feats["names"] == jfeats["names"]
    for k in ("clipfeat", "capfeat"):
        np.testing.assert_array_equal(feats[k], jfeats[k])
    a = SimpleNamespace(registry=copy.deepcopy(m.registry))
    b = SimpleNamespace(registry=copy.deepcopy(m.registry))
    got = ttrain.assign_all_semantics(a, feats)
    want = jtrain.assign_all_semantics(b, jfeats)
    assert got == want and 4 in got
    for inst_id, slot in a.registry.inst_to_slot.items():
        assert a.registry.slots[slot].semantic_id == b.registry.slots[slot].semantic_id
    assert a.registry.bg.semantic_id == b.registry.bg.semantic_id == 0


def test_resume(tmp_path, capsys):
    """--resume restores the full state snapshot, re-ingests the frames
    already seen into the store, and trains only the new ones
    (tests/test_dataset_cli.py TestResume)."""
    root = str(tmp_path / "scene")
    write_replica_dataset(root, n_raw_frames=40)
    cfg_path = _config_json(root, tmp_path)
    cfg = json.load(open(cfg_path))
    cfg["render"]["iters_per_frame"] = 5
    cfg["vis"]["if_render"] = 0
    cfg["vis"]["if_obj"] = 0
    json.dump(cfg, open(cfg_path, "w"))
    logdir = str(tmp_path / "logs")

    ttrain.main(["--config", cfg_path, "--logdir", logdir, "--max-frames", "2",
                 "--device", "cpu"])
    scfg = load_scene_config(cfg_path)
    m = make_mapper(scfg, frame_capacity=8, device="cpu")
    load_scene(logdir, m)
    assert m.frame_count == 2 and m.n_objects >= 1
    assert not os.path.exists(os.path.join(logdir, "render"))     # if_render 0
    assert not os.path.exists(os.path.join(logdir, "scene_mesh"))  # if_obj 0

    ttrain.main(["--config", cfg_path, "--logdir", logdir, "--max-frames", "4",
                 "--resume", "--device", "cpu", "--ckpt-every", "1"])
    assert "resuming after frame 2" in capsys.readouterr().out
    m2 = make_mapper(scfg, frame_capacity=8, device="cpu")
    load_scene(logdir, m2)
    assert m2.frame_count == 4
    timing = json.load(open(os.path.join(logdir, "timing.json")))
    assert sorted(timing) == ["frame 2", "frame 3"]     # only the new frames trained


def test_bf16_config_trains(tmp_path, monkeypatch):
    """A scene JSON with trainer.compute_dtype "bf16" trains through the
    CLI on the CPU: every field call takes the kernels' plain version in
    bf16, and the checkpoints hold float32 masters, as the JAX package's."""
    from openobj_torch.ops import fused_field as tff

    root = str(tmp_path / "scene")
    write_replica_dataset(root, n_raw_frames=20)
    cfg_path = _config_json(root, tmp_path)
    cfg = json.load(open(cfg_path))
    cfg["trainer"]["compute_dtype"] = "bf16"
    cfg["render"]["iters_per_frame"] = 3
    cfg["vis"]["if_render"] = cfg["vis"]["if_obj"] = 0
    json.dump(cfg, open(cfg_path, "w"))
    seen = []
    plain = tff.fused_field_plain

    def spy(*args, **kw):
        seen.append(args[4] if len(args) > 4 else kw.get("compute_dtype", "f32"))
        return plain(*args, **kw)

    monkeypatch.setattr(tff, "fused_field_plain", spy)
    logdir = str(tmp_path / "logs")
    m = ttrain.main(["--config", cfg_path, "--logdir", logdir, "--max-frames", "2",
                     "--device", "cpu"])
    assert m.cfg.compute_dtype == "bf16" and set(seen) == {"bf16"} and len(seen) >= 6
    assert np.isfinite(m.loss_history).all()
    ckpt = os.path.join(logdir, "ckpt", "0", "obj_0.npz")
    with np.load(ckpt) as z:
        floats = [z[k].dtype for k in z.files if z[k].dtype.kind == "f"]
    assert floats and set(floats) == {np.dtype(np.float32)}


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = str(tmp_path / "scene")
    write_replica_dataset(root, n_raw_frames=10)
    with pytest.raises((AssertionError, RuntimeError)):
        ttrain.main(["--config", _config_json(root, tmp_path), "--logdir",
                     str(tmp_path / "logs")])


# --------------------------------------------------------------------------- #
# viz/query
# --------------------------------------------------------------------------- #


def _bundle(rng):
    out = {}
    for oid in (4, 5, 9):
        base_c, base_s = rng.normal(size=512), rng.normal(size=384)
        n = int(rng.integers(1, 7))
        out[oid] = {
            "clip_feat": np.stack([base_c + 0.01 * rng.normal(size=512) for _ in range(n)]),
            "caption_feat": np.stack([base_s + 0.01 * rng.normal(size=384) for _ in range(n)]),
            "part_feat": rng.normal(size=(50, 512)),
        }
    out[11] = {"clip_feat": None, "caption_feat": None}
    return out


def _encoder(dim, seed):
    def enc(texts):
        return np.stack([np.random.default_rng([seed, len(t), ord(t[0])]).normal(size=dim)
                         for t in texts])
    return enc


def test_query_functions_match():
    rng = np.random.default_rng(7)
    bundle = _bundle(rng)
    clip_enc, sbert_enc = _encoder(512, 1), _encoder(384, 2)
    got = tquery.canonical_object_features(bundle)
    want = jquery.canonical_object_features(bundle)
    assert sorted(got) == sorted(want) == [4, 5, 9]
    for k in got:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(a, b)
    for top_k in (None, 2):
        a = tquery.query_objects("a ball", bundle, clip_enc, sbert_enc, top_k=top_k)
        b = jquery.query_objects("a ball", bundle, clip_enc, sbert_enc, top_k=top_k)
        assert list(a) == list(b)
        np.testing.assert_allclose(list(a.values()), list(b.values()), rtol=0, atol=QUERY_ATOL)
    a = tquery.query_part("a ball", "a handle", bundle, clip_enc, sbert_enc, top_k_objects=2)
    b = jquery.query_part("a ball", "a handle", bundle, clip_enc, sbert_enc, top_k_objects=2)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=QUERY_ATOL)


@pytest.mark.parametrize("shape", [(50, 8), (400, 8), (30, 16), (12, 40)])
def test_part_feature_pca_colors(shape):
    rng = np.random.default_rng(shape[0])
    x = rng.normal(size=shape) @ rng.normal(size=(shape[1], shape[1]))
    x[:, 1] = 3.0                                  # a constant column
    np.testing.assert_allclose(tquery.part_feature_pca_colors(x),
                               jquery.part_feature_pca_colors(x), rtol=0, atol=PCA_ATOL)


def test_assign_semantics_matches():
    rng = np.random.default_rng(8)
    ccls, scls = rng.normal(size=(6, 512)), rng.normal(size=(6, 384))
    ccls /= np.linalg.norm(ccls, axis=1, keepdims=True)
    scls /= np.linalg.norm(scls, axis=1, keepdims=True)
    for n, conf in ((1, 0.5), (5, 0.5), (5, 0.0), (5, 2.0), (8, 0.1)):
        c = ccls[rng.integers(0, 6)] + 0.05 * rng.normal(size=(n, 512))
        s = scls[rng.integers(0, 6)] + 0.05 * rng.normal(size=(n, 384))
        assert tquery.assign_semantics(c, s, ccls, scls, conf) == \
            jquery.assign_semantics(c, s, ccls, scls, conf)
