"""openobj_torch — the PyTorch/CUDA port of openobj_tpu.

Module paths and public names mirror ``openobj_tpu`` so that each module's
counterpart is easy to find. Parameter trees are plain nested dicts with the
JAX package's keys; every entry point takes an explicit ``device`` (default
``"cuda"``). The fused field forward/backward runs as hand-written CUDA
kernels (``csrc/fused_field.cu``) on a CUDA device and as its plain PyTorch
version on the CPU. The design probes of the fused-step and part-term
plans (``ops/probes.py``, ``csrc/probes.cu``) run as ``python -m
openobj_torch.scripts.<name>`` on a CUDA device.

This package imports neither ``jax`` nor ``openobj_tpu``.
"""

__version__ = "0.1.0"
