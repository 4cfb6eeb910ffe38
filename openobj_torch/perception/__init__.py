"""Cross-frame instance association: mask -> 3D evidence projection,
multi-cue similarity graph (the matrices on a torch device), Louvain
clustering, global merge, reprojection healing and artifact IO. The
perception front end (segmentation, encoders, part-level features) is not
ported yet."""

from openobj_torch.perception import (  # noqa: F401
    graph, healing, merge, pipeline, projection, similarity,
)
