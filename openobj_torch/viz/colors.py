"""Color utilities for map visualization.

A copy of ``openobj_tpu.viz.colors`` (numpy); ``perception.merge``,
``viz.query``, ``viz.class_tables`` and the viewer use it.
``ClassColorMap.from_yaml`` reads the colour map with ``utils.yaml_subset``,
not PyYAML.

Covers the reference viewer's three coloring sources
(reference visualization/vis_interaction.py):

  * class colors from a scene color map YAML with keys ``mapping`` (raw
    class id -> merged class id), ``mapped_class`` (merged id -> name) and
    ``mapped_colors`` (merged id -> [r, g, b] in [0, 1]) — the schema of
    the reference's replica_color.yaml / scannet_color.yaml (the viewer
    looks classes up as mapping[class_id + 1], vis_interaction.py:284);
  * per-instance distinct colors (the reference uses distinctipy; here a
    deterministic golden-ratio HSV walk — no dependency, stable across
    runs);
  * a rainbow similarity colormap + top-k red highlighting for text-query
    results (vis_interaction.py:322-376).
"""

from __future__ import annotations

import colorsys

import numpy as np

from openobj_torch.utils import yaml_subset


def distinct_colors(n: int, seed: int = 0) -> np.ndarray:
    """[n, 3] uint8 visually-distinct colors (deterministic)."""
    golden = 0.6180339887498949
    h = (seed * golden) % 1.0
    out = np.empty((n, 3), np.uint8)
    for i in range(n):
        h = (h + golden) % 1.0
        s = 0.55 + 0.35 * ((i * 2654435761) % 97) / 97.0
        v = 0.75 + 0.25 * ((i * 40503) % 89) / 89.0
        out[i] = np.round(np.array(colorsys.hsv_to_rgb(h, s, v)) * 255)
    return out


def instance_color(obj_id: int) -> np.ndarray:
    """Stable color for a global instance id."""
    return distinct_colors(1, seed=int(obj_id) * 7 + 3)[0]


class ClassColorMap:
    """Reference-format class color map (mapping/mapped_class/mapped_colors)."""

    def __init__(self, mapping: dict, names: dict, colors: dict):
        self.mapping = {int(k): int(v) for k, v in mapping.items()}
        self.names = {int(k): str(v) for k, v in names.items()}
        self.colors = {
            int(k): (np.asarray(v, np.float64) if v else np.zeros(3))
            for k, v in colors.items()
        }

    @classmethod
    def from_yaml(cls, path: str) -> "ClassColorMap":
        with open(path) as f:
            data = yaml_subset.load(f.read())
        return cls(data["mapping"], data["mapped_class"], data["mapped_colors"])

    @classmethod
    def generated(cls, class_names: list[str]) -> "ClassColorMap":
        """Fallback map when no dataset YAML is supplied: identity mapping +
        distinct generated colors."""
        cols = distinct_colors(len(class_names), seed=11).astype(np.float64) / 255
        return cls(
            {i: i for i in range(len(class_names))},
            dict(enumerate(class_names)),
            {i: list(cols[i]) for i in range(len(class_names))},
        )

    def color_of(self, class_id: int) -> np.ndarray:
        """[3] uint8 for a raw class id (the viewer's class_id+1 convention
        is applied by the caller)."""
        merged = self.mapping.get(int(class_id), 0)
        return np.round(self.colors.get(merged, np.zeros(3)) * 255).astype(np.uint8)

    def name_of(self, class_id: int) -> str:
        return self.names.get(self.mapping.get(int(class_id), 0), "unknown")


def rainbow_colormap(values: np.ndarray) -> np.ndarray:
    """values in [0, 1] -> [N, 3] uint8 rainbow (blue -> red), the viewer's
    query heat coloring (vis_interaction.py:322-340)."""
    v = np.clip(np.asarray(values, np.float64), 0.0, 1.0)
    # piecewise rainbow: hue 240 (blue) -> 0 (red), vectorized HSV->RGB at
    # s=v=1 (the live part-query path colors 10^5+ vertices per query — a
    # per-vertex colorsys loop took seconds)
    h6 = (1.0 - v) * (240.0 / 360.0) * 6.0
    i = np.floor(h6).astype(np.int64) % 6
    f = h6 - np.floor(h6)
    q, t = 1.0 - f, f
    ones, zeros = np.ones_like(f), np.zeros_like(f)
    r = np.choose(i, [ones, q, zeros, zeros, t, ones])
    g = np.choose(i, [t, ones, ones, q, zeros, zeros])
    b = np.choose(i, [zeros, zeros, t, ones, ones, q])
    return np.round(np.stack([r, g, b], -1) * 255).astype(np.uint8)


def normalize_scores(scores: dict[int, float]) -> dict[int, float]:
    if not scores:        # e.g. a bundle exported without features
        return {}
    vals = np.asarray(list(scores.values()), np.float64)
    lo, hi = float(vals.min()), float(vals.max())
    rng = max(hi - lo, 1e-9)
    return {k: (v - lo) / rng for k, v in scores.items()}
