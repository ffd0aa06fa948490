"""PyTorch + CUDA port of ``distributed_tensorflow_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package re-implements its
slices in PyTorch, with every Pallas TPU kernel on a slice's path
replaced by a hand-written CUDA kernel (``ops/csrc/*.cu``, built at first
use by ``ops/_build.py``). It imports ``torch`` and never ``jax``, and
nothing of the JAX package: modules it needs from there are copied.

Slice 1 is GPT text serving: ``TextServer`` over ``GPTLM`` with the
flash-prefill kernel and the fused decode kernels. Slice 2 is the
reference workload, the MNIST MLP trained by SGD: ``Trainer`` (built by
``launch.build_trainer``) with the fused step and whole-epoch kernels.
Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; without a CUDA device
and without that explicit choice they raise.
"""

__version__ = "0.1.0"

_LAZY_EXPORTS = {
    "GPTLM": ("distributed_tensorflow_tpu_torch.models.gpt", "GPTLM"),
    "GPTLMParams": ("distributed_tensorflow_tpu_torch.models.gpt", "GPTLMParams"),
    "TextServer": ("distributed_tensorflow_tpu_torch.serve", "TextServer"),
    "GenerationConfig": (
        "distributed_tensorflow_tpu_torch.serve",
        "GenerationConfig",
    ),
    "ByteTokenizer": ("distributed_tensorflow_tpu_torch.data.text", "ByteTokenizer"),
    "flash_attention": (
        "distributed_tensorflow_tpu_torch.ops.flash_attention",
        "flash_attention",
    ),
    "gpt_params_from_numpy": (
        "distributed_tensorflow_tpu_torch.convert",
        "gpt_params_from_numpy",
    ),
    "gpt_params_to_numpy": (
        "distributed_tensorflow_tpu_torch.convert",
        "gpt_params_to_numpy",
    ),
    "MLP": ("distributed_tensorflow_tpu_torch.models.mlp", "MLP"),
    "Trainer": ("distributed_tensorflow_tpu_torch.train.trainer", "Trainer"),
    "TrainConfig": ("distributed_tensorflow_tpu_torch.config", "TrainConfig"),
    "read_data_sets": ("distributed_tensorflow_tpu_torch.data.mnist", "read_data_sets"),
    "build_trainer": ("distributed_tensorflow_tpu_torch.launch", "build_trainer"),
}


def __getattr__(name):
    """Lazy top-level API: ``import distributed_tensorflow_tpu_torch`` stays
    cheap until something that needs a submodule is touched."""
    try:
        module, attr = _LAZY_EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value  # cache: next access skips __getattr__
    return value
