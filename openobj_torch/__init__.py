"""openobj_torch — the PyTorch/CUDA port of openobj_tpu.

Module paths and public names mirror ``openobj_tpu`` so that each module's
counterpart is easy to find. Parameter trees are plain nested dicts with the
JAX package's keys; every entry point takes an explicit ``device`` (default
``"cuda"``). The fused field forward/backward runs as hand-written CUDA
kernels (``csrc/fused_field.cu``) on a CUDA device and as its plain PyTorch
version on the CPU. The design probes of the fused-step and part-term
plans (``ops/probes.py``, ``csrc/probes.cu``) run as ``python -m
openobj_torch.scripts.<name>`` on a CUDA device.

The top-level API resolves lazily, as the JAX package's does:
``openobj_torch.SceneMapper``, ``.Camera``, ``.TrainConfig``,
``.load_scene_config``, ``.make_mapper``, ``.associate``,
``.AssociationConfig``, ``.GraphSegmenter``, ``.OnlineInstanceTracker``,
``.import_torch_checkpoint`` and ``.export_torch_checkpoint``.

This package imports neither ``jax`` nor ``openobj_tpu``.
"""

__version__ = "0.1.0"

from openobj_torch import ops  # noqa: F401

_LAZY = {
    "SceneMapper": ("openobj_torch.core.scene", "SceneMapper"),
    "Camera": ("openobj_torch.core.scene", "Camera"),
    "TrainConfig": ("openobj_torch.core.trainer", "TrainConfig"),
    "load_scene_config": ("openobj_torch.config", "load_scene_config"),
    "make_mapper": ("openobj_torch.config", "make_mapper"),
    "GraphSegmenter": ("openobj_torch.perception.segmentation", "GraphSegmenter"),
    "OnlineInstanceTracker": ("openobj_torch.perception.tracking", "OnlineInstanceTracker"),
    "associate": ("openobj_torch.perception.pipeline", "associate"),
    "AssociationConfig": ("openobj_torch.perception.pipeline", "AssociationConfig"),
    "import_torch_checkpoint": ("openobj_torch.interop", "import_torch_checkpoint"),
    "export_torch_checkpoint": ("openobj_torch.interop", "export_torch_checkpoint"),
}


def __getattr__(name):
    """Lazy top-level API: the names above without importing the whole
    stack at package-import time."""
    from importlib import import_module

    if name in _LAZY:
        mod, attr = _LAZY[name]
        return getattr(import_module(mod), attr)
    raise AttributeError(f"module 'openobj_torch' has no attribute {name!r}")
