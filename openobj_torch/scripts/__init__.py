"""The port's probe scripts (run with ``python -m openobj_torch.scripts.<name>``
on a CUDA device)."""
