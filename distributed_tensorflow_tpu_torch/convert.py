"""Carry GPT parameters between the JAX package and the port through numpy.

The exchange format is a nested dict of numpy arrays keyed by field name:
``{"embed", "pos", "blocks": {"ln1_scale", ..., "b_down"}, "lnf_scale",
"lnf_bias"}`` — the JAX package's ``GPTLMParams`` / ``GPTBlockParams``
fields. Any NamedTuple with those fields (``_asdict``) is accepted as
well, so a JAX params tree can be handed in as it is: its leaves are
read with ``numpy.asarray``. Without a dtype the round trip is bitwise.
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
