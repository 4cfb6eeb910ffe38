"""Scale-out: the object axis split across GPUs, one process each
(``sharding``), processes joined by ``torch.distributed`` (``distributed``),
and scenes on device groups in one process (``multislice``). Port of
``openobj_tpu.parallel``."""
