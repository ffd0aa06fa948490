"""Execution strategies of the port: ``SingleDevice`` (the reference's
``tfsingle.py`` mode), ``SyncDataParallel`` / ``AsyncDataParallel``
(``strategy.py``; sync takes a tensor-parallel ``param_specs``) and
``ShardedDataParallel`` (``fsdp.py``) over the named-axes ``Mesh`` of
``mesh.py`` (``make_mesh``: ``("data", "model")`` by default), which also
carries the sequence-parallel collectives; ``specs.py`` holds the sharded
layouts' shards, gathers, optimizer-slot layouts and update."""
