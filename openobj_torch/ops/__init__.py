"""Array ops: positional encoding, field MLP, fused field, rendering,
losses, ray sampling, and the design-probe kernels (probes)."""

from openobj_torch.ops import embedding, losses, mlp, rendering, sampling  # noqa: F401
