"""The incremental mapping runtime: frame store, registry, optimizer,
trainer and SceneMapper."""

from openobj_torch.core import frame_store, optim, registry, scene, trainer  # noqa: F401
