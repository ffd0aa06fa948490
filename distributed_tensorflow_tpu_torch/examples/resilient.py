"""Resilient single-device training: durable checkpoints, preemption and
anomaly rollback (``train/resilience.py``, ``train/supervisor.py``); the
port's ``examples/resilient.py``.

Run: ``python -m distributed_tensorflow_tpu_torch.examples.resilient``
     ``kill -TERM <pid>``: a stop at the next epoch with a final save, exit 0;
     run it again: it resumes from the newest VALID step_N (a corrupt or
     partial save is skipped).

Every epoch saves ``step_N`` with a CRC32C manifest; retention keeps the
newest 3. A NaN/inf epoch, or one whose cost passes 3x the median of the
trailing window, restores the last good checkpoint and retries on the next
data window, at most twice, printing a ``Rollback:`` line each time. The
``DTF_*`` overrides of ``launch.config_from_env`` apply (``DTF_EPOCHS``,
``DTF_CHECKPOINT``, ...). On the card unless ``DTF_DEVICE=cpu``.
"""

from __future__ import annotations

import os

from distributed_tensorflow_tpu_torch.config import TrainConfig
from distributed_tensorflow_tpu_torch.launch import build_trainer, config_from_env


def main(print_fn=print, **kw):
    config = TrainConfig(
        checkpoint_dir="./checkpoints_resilient",
        keep_last_n=3,  # old steps removed; the last valid one survives
        max_rollbacks=2,  # the anomaly guard's budget (0 disables)
        spike_threshold=3.0,  # x the trailing window's median; NaN always trips
        handle_preemption=True,  # SIGTERM/SIGINT: save at the boundary, exit 0
    )
    trainer = build_trainer(config_from_env(config), print_fn=print_fn,
                            device=os.environ.get("DTF_DEVICE") or None, **kw)
    print_fn(f"resuming from step {trainer.start_step}" if trainer.start_step
             else "fresh start")
    return trainer.run()


if __name__ == "__main__":
    main()
