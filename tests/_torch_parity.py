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
    # MoE blocks: the FFN fields carry an expert axis after the layer's, and
    # the gate is drawn here too.
    e = (blocks["wg"].shape[-1],) if "wg" in blocks else ()
    blocks["wo"] = (rng.standard_normal((n, d, d)) / np.sqrt(d)).astype(np.float32)
    blocks["w_down"] = (rng.standard_normal((n, *e, f, d)) / np.sqrt(f)).astype(np.float32)
    if e:
        blocks["wg"] = (rng.standard_normal((n, d, *e)) / np.sqrt(d)).astype(np.float32)
    for nm, shape in (("b_up", (n, *e, f)), ("b_down", (n, *e, d)), ("ln1_bias", (n, d)),
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
    from distributed_tensorflow_tpu.models.gpt import (
        GPTBlockParams,
        GPTLMParams,
        GPTMoEBlockParams,
    )

    cls = GPTMoEBlockParams if "wg" in tree["blocks"] else GPTBlockParams
    return GPTLMParams(
        embed=jnp.asarray(tree["embed"]),
        pos=jnp.asarray(tree["pos"]),
        blocks=cls(**{k: jnp.asarray(v) for k, v in tree["blocks"].items()}),
        lnf_scale=jnp.asarray(tree["lnf_scale"]),
        lnf_bias=jnp.asarray(tree["lnf_bias"]),
    )


def torch_params(tree):
    from distributed_tensorflow_tpu_torch.convert import gpt_params_from_numpy

    return gpt_params_from_numpy(tree, device="cpu")


def max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


# -- the MLP slice -------------------------------------------------------------


def mlp_numpy_params(in_dim=784, hidden=100, out=10, seed=0, fan_in=False) -> dict:
    """MLP weights as the reference draws them (N(0,1) weights), or scaled
    by 1/sqrt(fan-in) with ``fan_in=True``, with small random biases so the
    bias paths are exercised too."""
    rng = np.random.default_rng(seed)
    s1, s2 = (in_dim ** -0.5, hidden ** -0.5) if fan_in else (1.0, 1.0)
    return {
        "w1": (s1 * rng.standard_normal((in_dim, hidden))).astype(np.float32),
        "b1": (0.1 * rng.standard_normal(hidden)).astype(np.float32),
        "w2": (s2 * rng.standard_normal((hidden, out))).astype(np.float32),
        "b2": (0.1 * rng.standard_normal(out)).astype(np.float32),
    }


def mlp_numpy_batches(steps, batch, in_dim=784, out=10, seed=0):
    """``steps`` batches of MNIST-like inputs in [0, 1) and one-hot labels:
    ``xs`` [steps, batch, in_dim], ``ys`` [steps, batch, out], f32."""
    rng = np.random.default_rng(seed)
    xs = rng.random((steps, batch, in_dim), dtype=np.float32)
    ys = np.eye(out, dtype=np.float32)[rng.integers(0, out, (steps, batch))]
    return xs, ys


def torch_fused(tree, device="cpu"):
    """The port's ``FusedState`` of a numpy MLP tree, on ``device``."""
    from distributed_tensorflow_tpu_torch.convert import mlp_params_from_numpy
    from distributed_tensorflow_tpu_torch.ops.fused_mlp import to_fused

    return to_fused(mlp_params_from_numpy(tree, device=device))


# -- the classifier families ----------------------------------------------------

# Narrow widths of each registry family for the parity tests (registry name,
# constructor keywords): the CNN with an odd and an even kernel (XLA puts
# an even kernel's extra SAME row on the high side).
CLASSIFIERS = {
    "cnn": ("cnn", dict(channels=(4, 8), kernel=5, hidden_dim=16)),
    "cnn_even": ("cnn", dict(channels=(4, 8), kernel=4, hidden_dim=16)),
    "lstm": ("lstm", dict(hidden_dim=16)),
    "transformer": ("transformer", dict(model_dim=32, num_heads=2)),
}


def classifier_models(family, dtype="float32", **extra):
    """The JAX and the port model of ``CLASSIFIERS[family]``."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.models import build_model as jbuild
    from distributed_tensorflow_tpu_torch.models import build_model

    name, kw = CLASSIFIERS[family]
    kw = {**kw, **extra}
    return (jbuild(name, compute_dtype=getattr(jnp, dtype), **kw),
            build_model(name, compute_dtype=getattr(torch, dtype), **kw))


def classifier_numpy_params(jmodel, seed=0) -> dict:
    """The JAX ``init(seed=1)`` params as numpy, with every constant leaf
    (zero biases and head, unit layernorm scales) replaced by seeded
    values, so that no path hides behind a zero or a one."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in jmodel.init(seed=1)._asdict().items():
        a = np.array(v, dtype=np.float32)
        if np.all(a == a.flat[0]):
            a = (a.flat[0] + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        out[k] = a
    return out


def jax_classifier_params(jmodel, tree):
    import jax.numpy as jnp

    cls = type(jmodel.init(seed=1))
    return cls(**{k: jnp.asarray(tree[k]) for k in cls._fields})


def torch_classifier_params(tmodel, tree, device="cpu"):
    from distributed_tensorflow_tpu_torch.convert import params_from_numpy

    return params_from_numpy(tree, type(tmodel.init(seed=1, device="cpu")), device)
