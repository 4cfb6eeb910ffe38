"""Map export (meshes and features per object)."""

from openobj_torch.viz import export, query  # noqa: F401
