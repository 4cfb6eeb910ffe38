"""Class-name feature table production (the --class-features npz).

Port of ``openobj_tpu.perception.class_features``: the same npz for the
same names and encoders, which ``openobj_torch.train.load_class_features``
reads. render_config.yaml is read with ``utils.yaml_subset``, not PyYAML;
only ``--encoders hf`` touches a torch device (``--device``, the card by
default).

The reference builds its open-vocabulary class list at train time — Replica:
``render_config.yaml``'s classes[].name; ScanNet: the unique nyu40class
column of ``scannetv2-labels.combined.tsv`` (hardcoded absolute path) — and
encodes the names with CLIP ViT-B/32 + SBERT on the GPU
(objnerf/train.py:109-150). Here that is a separate,
configurable tool producing the ``{names, clipfeat, capfeat}`` npz the
train CLI consumes, with injectable encoders:

    python -m openobj_torch.perception.class_features \
        --from-yaml <replica>/render_config.yaml out.npz --encoders hf
    python -m openobj_torch.perception.class_features \
        --from-tsv scannetv2-labels.combined.tsv out.npz
    python -m openobj_torch.perception.class_features --names wall,floor,chair out.npz
"""

from __future__ import annotations

import argparse
import csv

import numpy as np

from openobj_torch.utils import yaml_subset


def class_names_from_render_config(path: str) -> list[str]:
    """Replica render_config.yaml -> classes[].name (train.py:109-114)."""
    with open(path) as f:
        data = yaml_subset.load(f.read())
    return [item["name"] for item in data["classes"]]


def class_names_from_scannet_tsv(path: str) -> list[str]:
    """scannetv2-labels.combined.tsv -> unique nyu40class values in file
    order (train.py:115-130)."""
    names: list[str] = []
    with open(path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            c = row["nyu40class"]
            if c not in names:
                names.append(c)
    return names


def build_class_features(names: list[str], clip_encoder, sbert_encoder) -> dict:
    """Encode class names -> unit-norm CLIP [C, 512] + SBERT [C, 384]
    tables (train.py:135-150). Encoders: texts -> [C, D] (normalized or
    not; re-normalized here)."""
    def norm(x):
        x = np.asarray(x, np.float32)
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

    return {
        "names": np.asarray(names, object),
        "clipfeat": norm(clip_encoder(list(names))),
        "capfeat": norm(sbert_encoder(list(names))),
    }


def save_class_features(path: str, feats: dict) -> None:
    np.savez(path, **feats)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="produce the --class-features npz for the train CLI")
    ap.add_argument("out", help="output .npz")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--from-yaml", default=None,
                     help="Replica render_config.yaml")
    src.add_argument("--from-tsv", default=None,
                     help="scannetv2-labels.combined.tsv")
    src.add_argument("--names", default=None, help="comma-separated list")
    src.add_argument("--dataset", default=None,
                     choices=("replica", "scannet"),
                     help="use the shipped public vocabulary "
                          "(viz.class_tables) — no dataset files needed")
    ap.add_argument("--encoders", default="fake",
                    choices=("fake", "hf", "vocab"))
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the transformers encoders; read only "
                         "with --encoders hf (default: the card)")
    args = ap.parse_args(argv)

    if args.from_yaml:
        names = class_names_from_render_config(args.from_yaml)
    elif args.from_tsv:
        names = class_names_from_scannet_tsv(args.from_tsv)
    elif args.dataset:
        from openobj_torch.viz.class_tables import class_names

        names = class_names(args.dataset)
    else:
        names = [n.strip() for n in args.names.split(",") if n.strip()]

    from openobj_torch.viz.viewer import make_encoders

    clip_enc, sbert_enc = make_encoders(args.encoders, args.vocab, device=args.device)
    save_class_features(args.out, build_class_features(names, clip_enc, sbert_enc))
    print(f"wrote {len(names)} class features to {args.out}")


if __name__ == "__main__":
    main()
