"""Sync data-parallel training: the ``tfdist_between_sync.py`` equivalent.

``SyncReplicasOptimizer``'s accumulate-average-apply becomes one
all-reduce of the gradients a step over the ranks of ``settings.py``'s
worker list (no queues, no chief queue-runner, no parameter server).
Start every task at once with the launcher::

    python -m distributed_tensorflow_tpu_torch.tools.launch_local --workers 2 --ps 1 -- \\
        python -m distributed_tensorflow_tpu_torch.examples.between_sync

or one task by hand: ``python -m
distributed_tensorflow_tpu_torch.examples.between_sync --job_name=worker
--task_index=0``. ``DTF_*`` overrides apply (``launch.config_from_env``).
"""

from distributed_tensorflow_tpu_torch.config import ClusterConfig, TrainConfig
from distributed_tensorflow_tpu_torch.examples import settings
from distributed_tensorflow_tpu_torch.launch import run

if __name__ == "__main__":
    run(
        ClusterConfig.from_settings_module(settings),
        TrainConfig(sync=True),
    )
