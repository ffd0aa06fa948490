"""Execution strategies of the port: ``SingleDevice`` (the reference's
``tfsingle.py`` mode), ``SyncDataParallel`` / ``AsyncDataParallel``
(``strategy.py``) and ``ShardedDataParallel`` (``fsdp.py``) over the
``torch.distributed`` world of ``mesh.py``."""
