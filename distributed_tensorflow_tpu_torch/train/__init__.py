"""Training loops of the port: the MLP ``Trainer`` with its eager,
scanned and whole-run paths, the GPT ``LMTrainer``, the local-SGD /
DiLoCo outer loop and its mailbox gang (``local_sgd.py``), and the
checkpoints and recovery under them (``supervisor.py``,
``resilience.py``).

Lazy exports, as the JAX package's ``train/__init__.py`` has them: a name
imports its module when it is first touched."""

_LAZY_EXPORTS = {
    "Trainer": ("distributed_tensorflow_tpu_torch.train.trainer", "Trainer"),
    "LMTrainer": ("distributed_tensorflow_tpu_torch.train.lm_trainer", "LMTrainer"),
    "Supervisor": ("distributed_tensorflow_tpu_torch.train.supervisor", "Supervisor"),
    "DeltaExchange": ("distributed_tensorflow_tpu_torch.train.local_sgd", "DeltaExchange"),
    "DiLoCoState": ("distributed_tensorflow_tpu_torch.train.local_sgd", "DiLoCoState"),
    "make_lm_diloco_parts": ("distributed_tensorflow_tpu_torch.train.local_sgd",
                             "make_lm_diloco_parts"),
    "make_lm_diloco_vmapped": ("distributed_tensorflow_tpu_torch.train.local_sgd",
                               "make_lm_diloco_vmapped"),
}

__all__ = list(_LAZY_EXPORTS)


def __getattr__(name):
    try:
        module, attr = _LAZY_EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value
    return value
