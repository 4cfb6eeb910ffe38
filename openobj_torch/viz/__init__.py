"""Map export (meshes and features per object)."""
