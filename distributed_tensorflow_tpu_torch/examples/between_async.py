"""Async data-parallel training: the ``tfdist_between.py`` equivalent.

The reference's HOGWILD parameter-server updates become a parameter copy a
rank, stepping on its own rows with its update scaled by the worker count,
and the copies averaged every 50 steps (``parallel/strategy.py``). Start
every task at once with the launcher::

    python -m distributed_tensorflow_tpu_torch.tools.launch_local --workers 2 --ps 1 -- \\
        python -m distributed_tensorflow_tpu_torch.examples.between_async

``DTF_*`` overrides apply (``launch.config_from_env``).
"""

from distributed_tensorflow_tpu_torch.config import ClusterConfig, TrainConfig
from distributed_tensorflow_tpu_torch.examples import settings
from distributed_tensorflow_tpu_torch.launch import run

if __name__ == "__main__":
    run(
        ClusterConfig.from_settings_module(settings),
        TrainConfig(sync=False, async_avg_every=50),
    )
