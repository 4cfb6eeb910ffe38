"""Open-vocabulary demo with openobj_torch (the port of
examples/open_vocab_demo.py): train a synthetic scene in part mode, export
the object map, run text queries, and write the interactive viewer HTML.

No dataset or model weights are needed: the scene is analytic (coloured
spheres in a box room) and the text encoders are the deterministic fakes
(``--encoders hf`` in the viewer CLI swaps in real CLIP/SBERT). Each object
is given the encoding of its own description, so each query's top object
is the one it describes (viz.query: 0.2 sbert + 0.8 clip cosine).

Run:  python examples/torch_open_vocab_demo.py [--device cuda|cpu]
          [--out DIR] [--frames 8] [--iters 40]
At the published run (8 frames, 40 iterations) the example's gates apply:
each query's top object is the described one, the viewer HTML is written,
then "DEMO OK". A cut run prints the same and checks only that the losses
are finite and the HTML is written. DIR defaults to
build/torch_open_vocab_demo in the checkout.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from openobj_torch.core import trainer  # noqa: E402
from openobj_torch.core.scene import Camera, SceneMapper  # noqa: E402
from openobj_torch.data import synthetic  # noqa: E402
from openobj_torch.utils.geometry import object_bound_from_keyframes  # noqa: E402
from openobj_torch.viz import export as viz_export  # noqa: E402
from openobj_torch.viz import query as viz_query  # noqa: E402
from openobj_torch.viz import viewer as viz_viewer  # noqa: E402

N_FRAMES, N_ITERS = 8, 40
DESCRIPTIONS = {4: "a red ball", 5: "a blue ball"}


def run(device="cuda", out_dir=None, n_frames: int = N_FRAMES, n_iters: int = N_ITERS) -> dict:
    """Train, export, query, write the HTML. Returns {"losses", "objects",
    "meshed", "top" (query -> top object), "ranked", "html", "seconds"}."""
    out_dir = out_dir or os.path.join(ROOT, "build", "torch_open_vocab_demo")
    os.makedirs(out_dir, exist_ok=True)
    cam = Camera(width=96, height=72, fx=60.0, fy=60.0, cx=48.0, cy=36.0)
    cfg = trainer.TrainConfig(
        n_iters_per_frame=n_iters, win_size=2, n_samples_per_frame=24,
        win_size_bg=2, n_samples_per_frame_bg=24,
        hidden=16, hidden_bg=16, clip_size=16, part_mode=True, part_down=4)
    mapper = SceneMapper(cam, cfg, frame_capacity=10, max_objects=8,
                         keyframe_buffer_size=6, keyframe_step=2,
                         keyframe_step_bg=2, initial_bucket=4, device=device)
    t0 = time.perf_counter()

    # the fake text encoders are deterministic hashes: each object gets the
    # encoding of its own description, so queries resolve to it
    clip_enc, sbert_enc = viz_viewer.make_encoders("fake", device=device)
    obj_clip = {k: clip_enc([v])[0] for k, v in DESCRIPTIONS.items()}
    obj_cap = {k: sbert_enc([v])[0] for k, v in DESCRIPTIONS.items()}

    scene = synthetic.default_scene(n_spheres=2)
    dirs = cam.ray_dirs("cpu").numpy()
    rng = np.random.default_rng(0)
    print("[train]")
    for i in range(n_frames):
        t_wc = synthetic.orbit_pose(2 * np.pi * i / 12)
        rgb, depth, inst = scene.render(t_wc, dirs)
        pf = rng.normal(size=(72 // 4, 96 // 4, 16)).astype(np.float32)
        mapper.process_frame(rgb, depth, inst, t_wc, partfeat=pf,
                             obj_clip=obj_clip, obj_cap=obj_cap)
    mapper.finish()
    print(f"  {mapper.n_objects} objects, last loss {mapper.loss_history[-1]:.2f}")

    print("[export]")
    reg, store = mapper.registry, mapper.store
    for inst_id, slot in reg.inst_to_slot.items():
        st = reg.slots[slot]
        kfs = torch.as_tensor(reg.kf_frames[slot][: st.n_kf], device=store.depth.device)
        st.bbox3d = object_bound_from_keyframes(
            store.depth[kfs].cpu().numpy(), (store.inst[kfs] == inst_id).cpu().numpy(),
            store.t_wc[kfs].cpu().numpy(), cam.fx, cam.fy, cam.cx, cam.cy)
    bundle_path = os.path.join(out_dir, "map_vis.pkl.gz")
    bundle = viz_export.export_scene_map(mapper, bundle_path, grid_dim=48)
    print(f"  {len(bundle)} meshed objects -> {bundle_path}")

    print("[query]")
    top, ranked_all = {}, {}
    for text in DESCRIPTIONS.values():
        scores = viz_query.query_objects(text, bundle, clip_enc, sbert_enc)
        ranked = sorted(scores.items(), key=lambda kv: -kv[1])
        print(f"  {text!r}: " + ", ".join(f"obj {o} {s:+.3f}" for o, s in ranked))
        top[text] = int(ranked[0][0]) if ranked else None
        ranked_all[text] = [(int(o), float(s)) for o, s in ranked]

    html = os.path.join(out_dir, "viewer.html")
    scores = viz_query.query_objects("a red ball", bundle, clip_enc, sbert_enc)
    viz_viewer.build_html(
        bundle, html,
        colorings={"query": viz_viewer.bake_object_query(bundle, scores)},
        scores=scores, initial="query")
    print(f"[viewer] {html}  (open in a browser; keys R/I/S/O/C/A/H/V/B)")
    if device != "cpu":
        torch.cuda.synchronize()
    return {"losses": list(mapper.loss_history), "objects": mapper.n_objects,
            "meshed": len(bundle), "top": top, "ranked": ranked_all, "html": html,
            "seconds": time.perf_counter() - t0}


def check(res: dict, gates: bool = True) -> None:
    """Finite losses and the HTML written; at the published run also each
    query's top object is the described one."""
    if not res["losses"] or not np.isfinite(res["losses"]).all():
        raise AssertionError(f"losses not finite: {res['losses']}")
    if not os.path.getsize(res["html"]):
        raise AssertionError(f"{res['html']} is empty")
    if gates:
        for text, obj in res["top"].items():
            if DESCRIPTIONS.get(obj) != text:
                raise AssertionError(f"query {text!r}: top object {obj}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--iters", type=int, default=N_ITERS)
    args = ap.parse_args(argv)
    res = run(args.device, args.out, args.frames, args.iters)
    full = (args.frames, args.iters) == (N_FRAMES, N_ITERS)
    check(res, gates=full)
    print(f"[demo] {res['seconds']:.1f} s")
    print("DEMO OK" if full else "cut run: losses finite, HTML written (the query gate "
          f"applies at {N_FRAMES} frames, {N_ITERS} iterations)")
    return res


if __name__ == "__main__":
    main()
