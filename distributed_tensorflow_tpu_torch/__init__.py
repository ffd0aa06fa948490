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
Slice 3 serves on a paged block pool (``TextServer(paged=True)``) with
the radix prefix cache and prompt-lookup speculation, through the paged
decode kernels and the speculation-verify kernel. Slice 4 trains ``GPTLM``
through ``LMTrainer`` (``make_lm_train_step``, Adam/AdamW/momentum, the
``copy_corpus`` / ``markov_corpus`` token data), with the flash-attention
backward kernels behind one ``torch.library`` operator. Slice 12 finishes
that training: selective remat (the forward kernel once a layer a step),
learning-rate schedules, clipping and accumulation, the LM trainer's
compiled run, stateful optimizers on the MLP ``Trainer``, and the text data
(``BPETokenizer``, ``text_corpus``; ``examples/text_lm.py``). Slice 13 is
the reference's data-parallel modes over ``torch.distributed``. Slice 14
brings the other classifier families of the registry (``CNN``,
``LSTMClassifier``, ``TransformerClassifier``; ``build_model``), which the
``Trainer`` and every strategy take as they take the MLP, the flash
kernels at head_dim 16 for the transformer's flash attention, and
``Predictor`` (batched prediction from a training state). Slice 16 brings
``GPTLM``'s MoE blocks (``ops/moe.py``), its int8/fp8 projection products
(``matmul_dtype``, ``ops/quantized.quantized_dot``) and weight-only
quantized serving (``TextServer(decode_matmul_dtype=)``), and head dim 4 on
the decode kernels. Entry points run on
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
    "PagedKVCache": ("distributed_tensorflow_tpu_torch.models.gpt", "PagedKVCache"),
    "MLP": ("distributed_tensorflow_tpu_torch.models.mlp", "MLP"),
    "CNN": ("distributed_tensorflow_tpu_torch.models.cnn", "CNN"),
    "LSTMClassifier": ("distributed_tensorflow_tpu_torch.models.rnn", "LSTMClassifier"),
    "TransformerClassifier": (
        "distributed_tensorflow_tpu_torch.models.transformer",
        "TransformerClassifier",
    ),
    "build_model": ("distributed_tensorflow_tpu_torch.models", "build_model"),
    "Predictor": ("distributed_tensorflow_tpu_torch.inference", "Predictor"),
    "Trainer": ("distributed_tensorflow_tpu_torch.train.trainer", "Trainer"),
    "TrainConfig": ("distributed_tensorflow_tpu_torch.config", "TrainConfig"),
    "read_data_sets": ("distributed_tensorflow_tpu_torch.data.mnist", "read_data_sets"),
    "build_trainer": ("distributed_tensorflow_tpu_torch.launch", "build_trainer"),
    "LMTrainer": ("distributed_tensorflow_tpu_torch.train.lm_trainer", "LMTrainer"),
    "make_lm_train_step": (
        "distributed_tensorflow_tpu_torch.models.gpt",
        "make_lm_train_step",
    ),
    "copy_corpus": ("distributed_tensorflow_tpu_torch.data.tokens", "copy_corpus"),
    "markov_corpus": ("distributed_tensorflow_tpu_torch.data.tokens", "markov_corpus"),
    "BPETokenizer": ("distributed_tensorflow_tpu_torch.data.text", "BPETokenizer"),
    "text_corpus": ("distributed_tensorflow_tpu_torch.data.text", "text_corpus"),
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
