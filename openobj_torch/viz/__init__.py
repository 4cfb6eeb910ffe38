"""Map export (meshes and features per object), headless open-vocabulary
query serving, the HTML viewer (``viewer``, ``viewer_math``), the query
server (``server``) and the class tables (``class_tables``)."""

from openobj_torch.viz import export, query  # noqa: F401
