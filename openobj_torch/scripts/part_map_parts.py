"""Where the time of a part map painted on the card goes.

``perception.partfeat.build_part_feature_map`` stacks a frame's down-sampled
masks, copies them to the card, gathers feature x score by each pixel's last
covering mask, and copies the [H/down, W/down, C] map back into numpy for
``np.save``. This script paints one frame of the synthetic tabletop at
room_0's camera (680x1200, partfeat's settings as ``perception.auto`` runs
them: 512-d descriptors, down 5) and times, each 7 times after a
synchronise: the whole call, numpy's loop (``build_part_feature_map_plain``),
the host stack, the masks' copy to the card, the gather on the card, the
map's copy to pageable numpy memory, to a pinned buffer and into a reused
numpy array, and allocating and touching a fresh 67 MB array.

    python -m openobj_torch.scripts.part_map_parts

Needs a CUDA device; prints one JSON line of lists of ms.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch


def _times(fn, n: int = 7) -> list[float]:
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(round(1e3 * (time.perf_counter() - t0), 3))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("part_map_parts: no CUDA device", file=sys.stderr)
        return 2
    from openobj_torch.core.scene import Camera
    from openobj_torch.data import synthetic
    from openobj_torch.perception import auto, cli, partfeat
    from openobj_torch.perception import encoders as enc
    from openobj_torch.perception.segmentation import GraphSegmenter

    dev, down, clip = torch.device("cuda", 0), 5, 512
    cam = Camera(width=1200, height=680, fx=600.0, fy=600.0, cx=599.5, cy=339.5)
    scene, orbit = synthetic.archetype_scene("tabletop")
    rgb, depth, _ = scene.render(synthetic.orbit_pose(0.0, **orbit), cam.ray_dirs("cpu").numpy())
    knobs = auto.scaled_knobs(cam, 8.0)
    segmenter = GraphSegmenter(k=1.0, min_size=max(8, knobs["seg_min"] // 2),
                               stride=knobs["seg_stride"])
    masks, feats, scores = cli.part_map_inputs(rgb, depth, segmenter,
                                               enc.VisualDescriptorEncoder(clip))
    hd, wd = cam.height // down, cam.width // down

    def stack():
        return np.stack([m[: hd * down : down, : wd * down : down] for m in masks])

    md_host = stack()
    md = torch.as_tensor(md_host, device=dev)
    fe = torch.as_tensor(np.stack(feats), device=dev)
    sc = torch.as_tensor(np.asarray(scores, np.float32), device=dev)

    def gather():
        table = torch.cat([fe.new_zeros(1, clip), fe * sc[:, None]])
        order = torch.arange(1, len(masks) + 1, device=dev)
        return table[(md.to(torch.int64) * order[:, None, None]).amax(0)]

    out = gather()
    pinned = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    reused = np.empty(out.shape, np.float32)
    row = {
        "device": torch.cuda.get_device_name(0), "masks": len(masks),
        "map_bytes": out.numel() * 4,
        "whole": _times(lambda: partfeat.build_part_feature_map(masks, feats, scores, down,
                                                                device=dev)),
        "numpy_loop": _times(lambda: partfeat.build_part_feature_map_plain(masks, feats,
                                                                           scores, down)),
        "host_stack": _times(stack),
        "masks_to_card": _times(lambda: torch.as_tensor(md_host, device=dev)),
        "gather_on_card": _times(gather),
        "map_to_pageable_numpy": _times(lambda: out.cpu().numpy()),
        "map_to_pinned": _times(lambda: pinned.copy_(out)),
        "map_into_reused_numpy": _times(lambda: torch.from_numpy(reused).copy_(out)),
        "fresh_67mb_numpy_touched": _times(lambda: np.ones(out.shape, np.float32)),
    }
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
