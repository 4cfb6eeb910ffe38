"""Array ops: positional encoding, field MLP, fused field, rendering,
losses, ray sampling, and the design-probe kernels (probes)."""
