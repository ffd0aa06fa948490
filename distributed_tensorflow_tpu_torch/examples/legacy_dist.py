"""Legacy variant: the reference's ``tfdist.py`` (its pre-``settings.py``
iteration, with the cluster's addresses in the script); the port's
``examples/legacy_dist.py``.

Edit the two lists below instead of a settings module; start one process a
task (``--job_name worker|ps --task_index i``), e.g. through
``tools/launch_local.py``. Async data parallelism, the copies averaged
every 50 steps. Superseded by ``between_async.py``.
"""

from __future__ import annotations

from distributed_tensorflow_tpu_torch.config import ClusterConfig, TrainConfig
from distributed_tensorflow_tpu_torch.launch import run

ps_svrs = ["10.88.104.31:2223"]  # accepted, plays no role (no parameter server)
worker_svrs = ["10.88.104.31:2222", "10.88.102.119:2222"]


def main(argv=None, **kw):
    return run(ClusterConfig.from_lists(worker_svrs, ps_svrs),
               TrainConfig(sync=False, async_avg_every=50), argv=argv, **kw)


if __name__ == "__main__":
    main()
