"""Shared helpers of the ``test_torch_*`` parity tests: the same seeded
numpy inputs and perturbed weights go through the JAX package and its
PyTorch port. Importing it only sets torch's thread count and defines
functions: JAX arrays and models are made inside the tests."""

from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(2)  # xdist runs several workers side by side

# Small model geometry shared by the parity tests.
SMALL = dict(vocab_size=97, max_len=64, model_dim=32, num_heads=4, num_layers=2)


def jax_model(dtype="float32", **kw):
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.models.gpt import GPTLM

    return GPTLM(**{**SMALL, **kw}, compute_dtype=getattr(jnp, dtype))


def torch_model(dtype="float32", **kw):
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    return GPTLM(**{**SMALL, **kw}, compute_dtype=getattr(torch, dtype))


def numpy_params(jmodel, seed=0) -> dict:
    """The JAX ``init(seed=1)`` params with every zero-initialized residual
    weight, bias and layernorm parameter replaced by seeded random values
    (at init ``wo``/``w_down`` are zero and every block is the identity,
    which would hide attention from the logits)."""
    p = jmodel.init(seed=1)
    rng = np.random.default_rng(seed)
    blocks = {k: np.asarray(v).copy() for k, v in p.blocks._asdict().items()}
    n, d, _ = blocks["wo"].shape
    f = blocks["w_up"].shape[-1]
    blocks["wo"] = (rng.standard_normal((n, d, d)) / np.sqrt(d)).astype(np.float32)
    blocks["w_down"] = (rng.standard_normal((n, f, d)) / np.sqrt(f)).astype(np.float32)
    for nm, shape in (("b_up", (n, f)), ("b_down", (n, d)), ("ln1_bias", (n, d)),
                      ("ln2_bias", (n, d))):
        blocks[nm] = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    for nm in ("ln1_scale", "ln2_scale"):
        blocks[nm] = (1 + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    return {
        "embed": np.array(p.embed),
        "pos": np.array(p.pos),
        "blocks": blocks,
        "lnf_scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        "lnf_bias": (0.05 * rng.standard_normal(d)).astype(np.float32),
    }


def jax_params(tree):
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.models.gpt import GPTBlockParams, GPTLMParams

    return GPTLMParams(
        embed=jnp.asarray(tree["embed"]),
        pos=jnp.asarray(tree["pos"]),
        blocks=GPTBlockParams(**{k: jnp.asarray(v) for k, v in tree["blocks"].items()}),
        lnf_scale=jnp.asarray(tree["lnf_scale"]),
        lnf_bias=jnp.asarray(tree["lnf_bias"]),
    )


def torch_params(tree):
    from distributed_tensorflow_tpu_torch.convert import gpt_params_from_numpy

    return gpt_params_from_numpy(tree, device="cpu")


def max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))
