"""Perception front end + cross-frame instance association: weights-free
RGB-D segmentation (``segmentation``), pluggable encoders and captioners
(``encoders``), per-frame mask generation (``mask_generation``), part-level
feature maps painted on a torch device (``partfeat``), online tracking
(``tracking``); mask -> 3D evidence projection, the multi-cue similarity
graph (the matrices on a torch device), Louvain clustering, global merge,
reprojection healing and artifact IO (``pipeline`` and the modules under
it); the three perception CLIs (``cli``) and ``auto``, which runs them over
a raw scene; and ``class_features``, the class-name feature table that
training reads."""

from openobj_torch.perception import (  # noqa: F401
    encoders, graph, merge, partfeat, pipeline, projection, similarity,
)
