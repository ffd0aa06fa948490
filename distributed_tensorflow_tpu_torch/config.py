"""Training configuration of the port: the slice of the JAX package's
``TrainConfig`` (``distributed_tensorflow_tpu/config.py``) that the MLP
training path reads, with the same defaults, so one configuration means
the same run in both packages.

``engine`` keeps the JAX values: ``"xla"`` is the generic path (plain
PyTorch ops and autograd here) and ``"pallas"`` the fused whole-epoch
kernel (the CUDA kernels of ``ops/fused_mlp.py`` here).

A JAX field this slice does not port is refused, whatever its value,
naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import dataclasses

# JAX TrainConfig field -> the ROADMAP item that ports it.
NOT_PORTED = {
    **dict.fromkeys(
        ("checkpoint_dir", "keep_last_n", "max_rollbacks", "epochs_per_dispatch",
         "prefetch", "logs_path", "profile_dir", "log_placement"), "A8"),
    **dict.fromkeys(
        ("sync", "async_avg_every", "dp_mode", "per_worker_epoch", "model",
         "param_dtype"), "A6"),
    **dict.fromkeys(
        ("lr_schedule", "warmup_steps", "accumulate_steps", "grad_clip_norm", "remat"), "A4"),
    "matmul_dtype": "A5",
}


@dataclasses.dataclass(frozen=True)
class _TrainFields:
    """Hyperparameters. Defaults reproduce the reference (and the JAX
    package's defaults)."""

    batch_size: int = 100
    learning_rate: float = 0.001
    epochs: int = 100
    log_frequency: int = 100  # print every N batches
    seed: int = 1
    compute_dtype: str = "bfloat16"  # operand dtype of the model's products
    optimizer: str = "sgd"
    # "naive" = the reference's CE over probabilities; "stable" = log-softmax.
    loss: str = "naive"
    # One device loop per epoch over staged batches (train/scan.py). None
    # resolves by device: True on cuda, False on the CPU.
    scan_epoch: bool | None = None
    # Every epoch, shuffle and eval in one call (train/compiled_run.py).
    compiled_run: bool = False
    # compiled_run engine: "xla" (PyTorch ops) | "pallas" (CUDA kernels).
    engine: str = "xla"

    def __post_init__(self):
        if self.engine not in ("xla", "pallas"):
            raise ValueError(f"unknown engine {self.engine!r} (xla|pallas)")
        if self.loss not in ("naive", "stable"):
            raise ValueError(f"unknown loss {self.loss!r}; use 'naive' or 'stable'")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"compute_dtype must be 'bfloat16' or 'float32', got {self.compute_dtype!r}"
            )


class TrainConfig(_TrainFields):
    __doc__ = _TrainFields.__doc__

    def __init__(self, *args, **kw):
        # A JAX-only field is refused with its ROADMAP item before the
        # dataclass sees it as unknown.
        for name in kw:
            if name in NOT_PORTED:
                raise NotImplementedError(
                    f"TrainConfig.{name} is not ported yet (ROADMAP {NOT_PORTED[name]})"
                )
        super().__init__(*args, **kw)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
