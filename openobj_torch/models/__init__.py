"""Per-object neural fields."""

from openobj_torch.models import object_field  # noqa: F401
