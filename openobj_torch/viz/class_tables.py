"""First-party per-dataset class tables (names, merge mapping, colors).

A copy of ``openobj_tpu.viz.class_tables`` (host numpy on the port's
``viz.colors``): the same tables, and ``write_yaml`` writes the same bytes.

The reference ships these as large YAML data files
(visualization/replica_color.yaml:1-523,
scannet_color.yaml:1-799) consumed by the viewer's 'S' class-color mode
(vis_interaction.py:284) and by the zero-shot mIoU class-id mapping. Here
the tables are GENERATED from the public dataset vocabularies:

  * Replica: the dataset's public 102-class semantic vocabulary
    (``REPLICA_CLASSES``) plus a synonym-merge table
    (``REPLICA_MERGE``: e.g. bottle/bowl -> cup, laptop/tablet ->
    computer) reproducing the reference's merged-class behavior; merged
    ids are assigned in raw-id first-appearance order, which reproduces
    the reference's mapped_class numbering exactly (0=unknown ...
    82=bag). Verified against replica_color.yaml: all 83 merged names and
    101/102 mapping entries match; the one difference is raw id 83
    (tissue-paper), which the reference maps to 42 ("appliance") in
    contradiction with its own inline comment and name table
    (replica_color.yaml:85 says "tissue-paper -> tissue-paper" = 50) — we
    emit the self-consistent 50 by default; ``strict_reference=True``
    reproduces the reference's 42 for bit-honest mIoU against
    reference-produced artifacts.
  * ScanNet: the public NYU40 vocabulary with the ScanNet benchmark's
    standard color palette (``SCANNET_NYU40``); identity mapping.

Colors for Replica are the framework's deterministic distinct palette
(viz.colors.distinct_colors) — color VALUES are presentation, not
behavior, so parity does not require the reference's RGB numbers.

``write_yaml`` emits the reference YAML schema
(mapping/mapped_class/mapped_colors) so the files interoperate with
reference tooling; ``ClassColorMap.for_dataset`` is the in-process
entry point.
"""

from __future__ import annotations

import numpy as np

from openobj_torch.viz.colors import ClassColorMap, distinct_colors

# The Replica dataset's public semantic vocabulary, in dataset id order
# (ids 0..101; 0 is the unknown/void class).
REPLICA_CLASSES = (
    "unknown", "backpack", "base-cabinet", "basket", "bathtub", "beam",
    "beanbag", "bed", "bench", "bike", "bin", "blanket", "blinds", "book",
    "bottle", "box", "bowl", "camera", "cabinet", "candle", "chair",
    "chopping-board", "clock", "cloth", "clothing", "coaster", "comforter",
    "computer-keyboard", "cup", "cushion", "curtain", "ceiling", "cooktop",
    "countertop", "desk", "desk-organizer", "desktop-computer", "door",
    "exercise-ball", "faucet", "floor", "handbag", "hair-dryer", "handrail",
    "indoor-plant", "knife-block", "kitchen-utensil", "lamp", "laptop",
    "major-appliance", "mat", "microwave", "monitor", "mouse", "nightstand",
    "pan", "panel", "paper-towel", "phone", "picture", "pillar", "pillow",
    "pipe", "plant-stand", "plate", "pot", "rack", "refrigerator",
    "remote-control", "scarf", "sculpture", "shelf", "shoe", "shower-stall",
    "sink", "small-appliance", "sofa", "stair", "stool", "switch", "table",
    "table-runner", "tablet", "tissue-paper", "toilet", "toothbrush",
    "towel", "tv-screen", "tv-stand", "umbrella", "utensil-holder", "vase",
    "vent", "wall", "wall-cabinet", "wall-plug", "wardrobe", "window",
    "rug", "logo", "bag", "set-of-clothing",
)

# Synonym merge: raw class name -> merged class name (classes not listed
# merge to themselves). Semantically-equivalent classes share one merged id
# so the viewer colors them alike and the mIoU protocol scores them as one
# class (the reference's merged-class behavior).
REPLICA_MERGE = {
    "base-cabinet": "cabinet",
    "wall-cabinet": "cabinet",
    "bottle": "cup",
    "bowl": "cup",
    "clothing": "cloth",
    "set-of-clothing": "cloth",
    "desk-organizer": "desk",
    "desktop-computer": "computer",
    "laptop": "computer",
    "tablet": "computer",
    "indoor-plant": "plant",
    "knife-block": "kitchen-utensil",
    "major-appliance": "appliance",
    "small-appliance": "appliance",
    "mat": "rug",
    "pan": "pot",
    "paper-towel": "tissue-paper",
    "pillow": "cushion",
    "plant-stand": "rack",
    "shelf": "rack",
    "table-runner": "table",
    "tv-screen": "tv",
    "tv-stand": "tv",
}

# NYU40 vocabulary (public) with the ScanNet benchmark's standard palette.
SCANNET_NYU40 = (
    ("unknown", (0, 0, 0)),
    ("wall", (174, 199, 232)),
    ("floor", (152, 223, 138)),
    ("cabinet", (31, 119, 180)),
    ("bed", (255, 187, 120)),
    ("chair", (188, 189, 34)),
    ("sofa", (140, 86, 75)),
    ("table", (255, 152, 150)),
    ("door", (214, 39, 40)),
    ("window", (197, 176, 213)),
    ("bookshelf", (148, 103, 189)),
    ("picture", (196, 156, 148)),
    ("counter", (23, 190, 207)),
    ("blinds", (178, 76, 76)),
    ("desk", (247, 182, 210)),
    ("shelves", (66, 188, 102)),
    ("curtain", (219, 219, 141)),
    ("dresser", (140, 57, 197)),
    ("pillow", (202, 185, 52)),
    ("mirror", (51, 176, 203)),
    ("floor mat", (200, 54, 131)),
    ("clothes", (92, 193, 61)),
    ("ceiling", (78, 71, 183)),
    ("books", (172, 114, 82)),
    ("refridgerator", (255, 127, 14)),
    ("television", (91, 163, 138)),
    ("paper", (153, 98, 156)),
    ("towel", (140, 153, 101)),
    ("shower curtain", (158, 218, 229)),
    ("box", (100, 125, 154)),
    ("whiteboard", (178, 127, 135)),
    ("person", (120, 185, 128)),
    ("night stand", (146, 111, 194)),
    ("toilet", (44, 160, 44)),
    ("sink", (112, 128, 144)),
    ("lamp", (96, 207, 209)),
    ("bathtub", (227, 119, 194)),
    ("bag", (213, 92, 176)),
    ("otherstructure", (94, 106, 211)),
    ("otherfurniture", (82, 84, 163)),
    ("otherprop", (100, 85, 144)),
)


def _merged_tables(raw_names, merge):
    """(mapping, names, colors) dicts with merged ids in raw-id
    first-appearance order — the reference's numbering scheme."""
    mapping, names = {}, {}
    next_id = 0
    by_name = {}
    for raw_id, raw in enumerate(raw_names):
        merged_name = merge.get(raw, raw)
        if merged_name not in by_name:
            by_name[merged_name] = next_id
            names[next_id] = merged_name
            next_id += 1
        mapping[raw_id] = by_name[merged_name]
    cols = distinct_colors(len(names), seed=11).astype(np.float64) / 255.0
    colors = {i: list(cols[i]) for i in range(len(names))}
    colors[0] = [0.0, 0.0, 0.0]  # unknown stays black
    return mapping, names, colors


# The reference's one verified self-inconsistency: replica_color.yaml:85
# maps raw 83 (tissue-paper) to merged id 42 ("appliance") while its own
# comment says "tissue-paper -> tissue-paper" (= 50, where raw 57
# paper-towel correctly lands, replica_color.yaml:57). raw_id -> the
# reference's mapped id, applied only under strict_reference.
_REPLICA_REFERENCE_QUIRKS = {83: 42}


def replica_map(strict_reference: bool = False) -> ClassColorMap:
    """Replica merged-class table. ``strict_reference=True`` reproduces the
    reference's numbering bit-for-bit INCLUDING its verified
    inconsistencies (``_REPLICA_REFERENCE_QUIRKS``) — required for
    apples-to-apples mIoU against reference-produced artifacts; the default
    emits the self-consistent mapping."""
    mapping, names, colors = _merged_tables(REPLICA_CLASSES, REPLICA_MERGE)
    if strict_reference:
        mapping = {**mapping, **_REPLICA_REFERENCE_QUIRKS}
    return ClassColorMap(mapping, names, colors)


def scannet_map() -> ClassColorMap:
    mapping = {i: i for i in range(len(SCANNET_NYU40))}
    names = {i: n for i, (n, _) in enumerate(SCANNET_NYU40)}
    colors = {
        i: [c / 255.0 for c in rgb] for i, (_, rgb) in enumerate(SCANNET_NYU40)
    }
    return ClassColorMap(mapping, names, colors)


def for_dataset(name: str, strict_reference: bool = False) -> ClassColorMap:
    """Shipped class color map by dataset name ('replica' | 'scannet').
    ``strict_reference`` reproduces the reference numbering exactly,
    including its verified quirks (see ``replica_map``)."""
    key = name.lower()
    if key.startswith("replica"):
        return replica_map(strict_reference=strict_reference)
    if key.startswith("scannet"):
        return scannet_map()
    raise KeyError(f"no shipped class table for dataset {name!r}")


def class_names(name: str) -> list[str]:
    """Raw class-id -> name list for a dataset (the CLIP/SBERT class-feature
    vocabulary the reference reads from render_config.yaml / the scannetv2
    tsv, train.py:109-130)."""
    key = name.lower()
    if key.startswith("replica"):
        return list(REPLICA_CLASSES)
    if key.startswith("scannet"):
        return [n for n, _ in SCANNET_NYU40]
    raise KeyError(f"no shipped class list for dataset {name!r}")


def write_yaml(name: str, path: str, strict_reference: bool = False) -> None:
    """Emit the reference YAML schema (mapping / mapped_class /
    mapped_colors, replica_color.yaml layout) for external tooling."""
    m = for_dataset(name, strict_reference=strict_reference)

    def block(title, d, fmt):
        lines = [f"{title}:"]
        for k in sorted(d):
            lines.append(f"  {k}: {fmt(d[k])}")
        return "\n".join(lines)

    out = "\n".join(
        [
            block("mapping", m.mapping, str),
            block("mapped_class", m.names, str),
            block(
                "mapped_colors", m.colors,
                lambda v: "[" + ", ".join(f"{x:.4f}" for x in v) + "]",
            ),
        ]
    ) + "\n"
    with open(path, "w") as f:
        f.write(out)


def _main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Write a dataset class color table (reference YAML schema)"
    )
    ap.add_argument("dataset", choices=["replica", "scannet"])
    ap.add_argument("out")
    ap.add_argument(
        "--strict-reference", action="store_true",
        help="reproduce the reference numbering exactly, including its "
             "verified inconsistencies (Replica raw 83 -> 42)",
    )
    args = ap.parse_args(argv)
    write_yaml(args.dataset, args.out, strict_reference=args.strict_reference)
    print(f"wrote {args.dataset} class table to {args.out}")


if __name__ == "__main__":
    _main()
