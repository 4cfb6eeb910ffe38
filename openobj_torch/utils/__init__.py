"""Host-side utilities: geometry and the PNG codec."""

from openobj_torch.utils import geometry  # noqa: F401
