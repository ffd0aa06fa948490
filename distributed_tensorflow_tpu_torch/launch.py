"""Launcher of the port: config → model + strategy + trainer, one device.

Counterpart of ``distributed_tensorflow_tpu/launch.py`` ``build_trainer``
and ``config_from_env`` for the single-device path; cluster and
data-parallel configurations are ROADMAP A6.

    python -m distributed_tensorflow_tpu_torch.launch

is the port's ``examples/single.py``: it trains the 784→100→10 MLP with
SGD lr=0.001, batch 100, for 100 epochs on the card, printing the
reference's log lines (the ``DTF_*`` environment overrides below apply).
"""

from __future__ import annotations

import os

import torch

from distributed_tensorflow_tpu_torch.config import TrainConfig

# Environment knobs of the JAX launcher that this slice does not port.
NOT_PORTED_ENV = {
    "DTF_CHECKPOINT": "A8", "DTF_KEEP_LAST": "A8", "DTF_MAX_ROLLBACKS": "A8",
    "DTF_MAX_RESTARTS": "A8", "DTF_STALL_TIMEOUT_MS": "A8", "DTF_MIN_WORKERS": "A8",
    "DTF_REJOIN_TIMEOUT_S": "A8", "DTF_LOGS": "A8", "DTF_MODEL": "A6",
    "DTF_SYNC_EVERY": "A7", "DTF_OUTER_LR": "A7", "DTF_OUTER_MOMENTUM": "A7",
    "DTF_DELTA_DTYPE": "A7", "DTF_STALE_LIMIT": "A7", "DTF_REMAT": "A4",
    "DTF_MATMUL_DTYPE": "A5",
}


def config_from_env(base: TrainConfig | None = None) -> TrainConfig:
    """Apply environment overrides to a TrainConfig: DTF_EPOCHS,
    DTF_BATCH_SIZE, DTF_LR, DTF_SCAN (=1 → scan_epoch), DTF_COMPILED (=1 →
    compiled_run), as the JAX launcher reads them. The JAX launcher's other
    knobs raise naming the ROADMAP item that brings them, unless empty;
    invalid values raise ValueError naming the knob."""

    def _parse(var: str, conv):
        try:
            return conv(os.environ[var])
        except ValueError as exc:
            raise ValueError(f"invalid {var}={os.environ[var]!r}: {exc}") from None

    for var, item in NOT_PORTED_ENV.items():
        if os.environ.get(var):
            raise NotImplementedError(f"{var} is not ported yet (ROADMAP {item})")
    cfg = base or TrainConfig()
    kw = {}
    if "DTF_EPOCHS" in os.environ:
        kw["epochs"] = _parse("DTF_EPOCHS", int)
    if "DTF_BATCH_SIZE" in os.environ:
        kw["batch_size"] = _parse("DTF_BATCH_SIZE", int)
    if "DTF_LR" in os.environ:
        kw["learning_rate"] = _parse("DTF_LR", float)
    if "DTF_SCAN" in os.environ:
        kw["scan_epoch"] = os.environ["DTF_SCAN"] == "1"
    if "DTF_COMPILED" in os.environ:
        kw["compiled_run"] = os.environ["DTF_COMPILED"] == "1"
    return cfg.replace(**kw) if kw else cfg


class _LogitsAdapter:
    """Presents ``apply_logits`` as ``apply`` so the logits-based stable
    loss composes with the strategy (accuracy's argmax is unchanged)."""

    def __init__(self, model):
        self._model = model

    def __getattr__(self, name):
        return getattr(self._model, name)

    def apply(self, params, x):
        return self._model.apply_logits(params, x)


def build_trainer(
    config: TrainConfig | None = None,
    *,
    context=None,
    model=None,
    datasets=None,
    strategy=None,
    optimizer=None,
    loss_fn=None,
    data_dir: str = "MNIST_data",
    print_fn=print,
    device=None,
):
    """The single-device Trainer for ``config``: the MLP in the config's
    compute dtype, the MNIST loader (synthetic when ``data_dir`` holds no
    IDX files), the configured optimizer and loss. ``device`` defaults to
    cuda and raises without one."""
    from distributed_tensorflow_tpu_torch.data.mnist import read_data_sets
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.ops import losses as losses_lib
    from distributed_tensorflow_tpu_torch.ops import optim as optim_lib
    from distributed_tensorflow_tpu_torch.parallel.strategy import SingleDevice
    from distributed_tensorflow_tpu_torch.train.trainer import Trainer

    if context is not None:
        raise NotImplementedError("cluster launch is not ported yet (ROADMAP A6)")
    config = config or TrainConfig()
    strategy = strategy or SingleDevice(device)
    if model is None:
        model = MLP(compute_dtype=getattr(torch, config.compute_dtype))
    datasets = datasets or read_data_sets(data_dir, one_hot=True)
    if optimizer is None:
        optimizer = optim_lib.make(config.optimizer, config.learning_rate)
    if loss_fn is None:
        if config.loss == "stable":
            if not hasattr(model, "apply_logits"):
                raise ValueError(f"loss='stable' needs apply_logits on {type(model).__name__}")
            model = _LogitsAdapter(model)
            loss_fn = losses_lib.stable_cross_entropy
        else:
            loss_fn = losses_lib.cross_entropy
    return Trainer(
        model, datasets, config, strategy=strategy, optimizer=optimizer,
        loss_fn=loss_fn, print_fn=print_fn,
    )


if __name__ == "__main__":
    build_trainer(config_from_env(TrainConfig())).run()
