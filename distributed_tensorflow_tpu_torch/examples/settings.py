"""Cluster topology in the reference's ``settings.py`` form (two host:port
lists). ``ps_svrs`` is accepted and plays no role; each ``worker_svrs``
entry is one rank of the process group, entry 0 its rendezvous and the
chief. Two workers: the reference's data-parallel topologies."""

ps_svrs = ["localhost:2222"]
worker_svrs = ["localhost:2223", "localhost:2224"]
