"""Host-side frame preprocessing."""

from openobj_torch.data import synthetic, transforms  # noqa: F401
