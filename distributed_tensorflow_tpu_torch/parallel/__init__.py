"""Execution strategies of the port: ``SingleDevice`` (the reference's
``tfsingle.py`` mode), ``SyncDataParallel`` / ``AsyncDataParallel``
(``strategy.py``) and ``ShardedDataParallel`` (``fsdp.py``) over the
``torch.distributed`` world of ``mesh.py``, whose named-axes ``Mesh``
(``make_named_mesh``) carries the sequence-parallel collectives."""
