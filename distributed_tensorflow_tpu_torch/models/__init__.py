"""Model families of the port. Each satisfies the init/apply protocol
(``models/base.py``), so any of them drops into the strategies and the
Trainer unchanged: the reference MLP (``mlp``), the CNN (``cnn``), the
LSTM (``rnn``), the transformer classifier (``transformer``) and the GPT
LM (``gpt``; it trains through ``train/lm_trainer.py`` and serves).

The registry gives the configs and the launcher a string surface for the
classifier families (the JAX ``models/__init__.py`` ``MODEL_REGISTRY``).
Exports are lazy (PEP 562): importing the package imports no model module,
so the serving stack (``serve.py`` → ``models/gpt.py``) pulls in no
classifier.
"""

_PKG = "distributed_tensorflow_tpu_torch.models"
_LAZY_EXPORTS = {
    "CNN": (f"{_PKG}.cnn", "CNN"),
    "CNNParams": (f"{_PKG}.cnn", "CNNParams"),
    "GPTLM": (f"{_PKG}.gpt", "GPTLM"),
    "GPTLMParams": (f"{_PKG}.gpt", "GPTLMParams"),
    "KVCache": (f"{_PKG}.gpt", "KVCache"),
    "make_lm_train_step": (f"{_PKG}.gpt", "make_lm_train_step"),
    "MLP": (f"{_PKG}.mlp", "MLP"),
    "MLPParams": (f"{_PKG}.mlp", "MLPParams"),
    "LSTMClassifier": (f"{_PKG}.rnn", "LSTMClassifier"),
    "LSTMParams": (f"{_PKG}.rnn", "LSTMParams"),
    "TransformerClassifier": (f"{_PKG}.transformer", "TransformerClassifier"),
    "TransformerParams": (f"{_PKG}.transformer", "TransformerParams"),
}

# name → (module, class). GPTLM is not here: the registry serves the
# Trainer's image classifiers; the LM trains on token batches.
MODEL_REGISTRY = {
    "mlp": (f"{_PKG}.mlp", "MLP"),
    "cnn": (f"{_PKG}.cnn", "CNN"),
    "transformer": (f"{_PKG}.transformer", "TransformerClassifier"),
    "lstm": (f"{_PKG}.rnn", "LSTMClassifier"),
}

__all__ = list(_LAZY_EXPORTS) + ["MODEL_REGISTRY", "build_model"]


def __getattr__(name):
    try:
        module, attr = _LAZY_EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value  # the next access skips __getattr__
    return value


def build_model(name: str, **kwargs):
    """Construct a registered model family by name."""
    try:
        module, attr = MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; registered: {sorted(MODEL_REGISTRY)}") from None
    import importlib

    return getattr(importlib.import_module(module), attr)(**kwargs)
