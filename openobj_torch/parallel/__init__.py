"""Scene-level scale-out: device groups in one process (``multislice``) and
processes joined by ``torch.distributed`` (``distributed``). Port of
``openobj_tpu.parallel``'s scene-level half; the object-axis sharding
(``sharding``) is ROADMAP A16b."""
