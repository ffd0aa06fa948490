"""Carry parameters between the JAX package and the port through numpy.

GPT: the exchange format is a nested dict of numpy arrays keyed by field
name: ``{"embed", "pos", "blocks": {"ln1_scale", ..., "b_down"},
"lnf_scale", "lnf_bias"}`` — the JAX package's ``GPTLMParams`` / ``GPTBlockParams``
fields. Any NamedTuple with those fields (``_asdict``) is accepted as
well, so a JAX params tree can be handed in as it is: its leaves are
read with ``numpy.asarray``. Without a dtype the round trip is bitwise.

MLP: a flat dict ``{"w1", "b1", "w2", "b2"}`` (the JAX ``MLPParams``
fields), or that NamedTuple itself; the round trip is bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.models.gpt import (
    GPTBlockParams,
    GPTLMParams,
    map_params,
)
from distributed_tensorflow_tpu_torch.models.mlp import MLPParams


def _as_dict(tree) -> dict:
    return tree._asdict() if hasattr(tree, "_asdict") else dict(tree)


def gpt_params_from_numpy(tree, device=None, dtype=None) -> GPTLMParams:
    """numpy tree → port ``GPTLMParams`` on ``device`` (default cuda),
    keeping each array's dtype unless ``dtype`` is given."""
    dev = resolve_device(device)
    top = _as_dict(tree)
    blocks = _as_dict(top["blocks"])

    def t(a):
        x = torch.from_numpy(np.array(np.asarray(a), copy=True))
        return x.to(device=dev, dtype=dtype) if dtype else x.to(dev)

    return GPTLMParams(
        embed=t(top["embed"]),
        pos=t(top["pos"]),
        blocks=GPTBlockParams(**{k: t(blocks[k]) for k in GPTBlockParams._fields}),
        lnf_scale=t(top["lnf_scale"]),
        lnf_bias=t(top["lnf_bias"]),
    )


def gpt_params_to_numpy(params: GPTLMParams) -> dict:
    """Port ``GPTLMParams`` → the nested numpy dict (bf16 leaves widen to
    f32, numpy having no bfloat16)."""
    p = map_params(
        params,
        lambda x: (x.float() if x.dtype == torch.bfloat16 else x)
        .detach().cpu().numpy(),
    )
    out = p._asdict()
    out["blocks"] = p.blocks._asdict()
    return out


def mlp_params_from_numpy(tree, device=None) -> MLPParams:
    """numpy ``{"w1", "b1", "w2", "b2"}`` → port ``MLPParams`` on
    ``device`` (default cuda), dtypes kept."""
    dev = resolve_device(device)
    top = _as_dict(tree)
    return MLPParams(*(
        torch.from_numpy(np.array(np.asarray(top[k]), copy=True)).to(dev)
        for k in MLPParams._fields
    ))


def mlp_params_to_numpy(params: MLPParams) -> dict:
    """Port ``MLPParams`` → ``{"w1", "b1", "w2", "b2"}`` of numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in params._asdict().items()}
