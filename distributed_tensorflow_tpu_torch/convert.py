"""Carry parameters between the JAX package and the port through numpy.

GPT: the exchange format is a nested dict of numpy arrays keyed by field
name: ``{"embed", "pos", "blocks": {"ln1_scale", ..., "b_down"},
"lnf_scale", "lnf_bias"}`` — the JAX package's ``GPTLMParams`` / ``GPTBlockParams``
fields. Any NamedTuple with those fields (``_asdict``) is accepted as
well, so a JAX params tree can be handed in as it is: its leaves are
read with ``numpy.asarray``. A MoE tree (``"wg"`` among the block fields:
``GPTMoEBlockParams``, experts stacked on axis 1) goes the same way. A
weight-only quantized leaf (``QuantizedLinear``, from ``decode_weights``)
is ``{"qw", "scale"}`` (or the NamedTuple): int8 codes as int8, e4m3 codes
as their bytes (uint8) on the way out and, on the way in, as uint8 or as a
JAX fp8 array (``ml_dtypes``), reinterpreted bit for bit. Without a dtype
the round trip is bitwise.

The classifiers (MLP, CNN, LSTM, transformer): a flat dict keyed by the
JAX params NamedTuple's fields (``{"w1", "b1", "w2", "b2"}`` for the MLP),
or that NamedTuple itself, through :func:`params_from_numpy` with the
port's NamedTuple of the same fields (:func:`mlp_params_from_numpy` and
its CNN, LSTM and transformer counterparts). The layouts are the JAX
package's (HWIO conv kernels, the stacked ``[in+hidden, 4, hidden]`` gate
kernel), so the copy permutes nothing; the round trip is bitwise. An
optimizer state (SGD's, empty, and Adam's with its count) goes through
:func:`mlp_opt_state_from_numpy`; a JAX ``AsyncDataParallel`` state, whose
leaves stack a copy a replica ``[n, ...]``, becomes one rank's copy
(:func:`async_rank_state_from_numpy`) and per-rank copies stack back
(:func:`stack_replicas`); a canonical state becomes a ZeRO or
tensor-parallel rank's blocks through the strategy's ``from_canonical``
(:func:`sharded_state_from_numpy`) and comes back through its
``to_canonical`` (:func:`sharded_state_to_numpy`). Each takes the params
NamedTuple as ``cls`` (default the MLP's).

A tensor-parallel GPT state: the JAX canonical params and Adam state, as
numpy, become this rank's blocks of a spec tree (``GPTLM.partition_specs``;
the slots laid out by ``parallel/specs.match_slot_specs``) through
:func:`lm_sharded_state_from_numpy`, and every rank's blocks gather back
through :func:`lm_sharded_state_to_numpy` (a collective); the round trip
is bitwise. The same functions carry an expert-parallel state
(``models/gpt.expert_parallel_specs``: the expert leaves split on dim 1)
and, with ``stages`` / ``staged``, a pipeline state (the blocks staged as
[S, L/S, ...] and split on dim 0, ``pipeline_parallel_specs``); a JAX
staged tree (``pipeline_stage_params``) becomes a canonical one through
:func:`unstage_numpy`.

The LM's async, ZeRO and DiLoCo states: a JAX async state (GPT params
and Adam state stacked a copy a replica ``[n, ...]``) becomes this rank's
copy through :func:`lm_async_state_from_numpy` and every rank's copy
stacks back through :func:`lm_async_state_to_numpy` (a collective); a
ZeRO state is :func:`lm_sharded_state_from_numpy` / ``_to_numpy`` over
``models/gpt.make_lm_zero_parts``' specs; a JAX ``DiLoCoState`` (the inner
states stacked ``[n, ...]``, θ_start, momentum, the residual and the
in-flight ``{"delta", "landing"}``, each None when its lever is off) goes
through :func:`diloco_state_from_numpy` / :func:`diloco_state_to_numpy`,
this rank's inner state on a mesh (the others gathered back), the whole
stack on one device; None stays None. Each round trip is bitwise.

Adam state: optax's ``ScaleByAdamState`` (``count``, and ``mu`` / ``nu``
over the GPT param tree), or a dict of those keys, carried to the port's
``ops/optim.AdamState`` and back, so a run can continue across the two
packages; the round trip is bitwise.

Paged KV pool: ``{"k", "v", "block_tables", "lengths"}`` (the JAX
``PagedKVCache`` fields, or that NamedTuple), so both packages can be fed
the same pool and tables. A bf16 pool leaves as f32 (exact) and comes back
as bf16 given ``dtype=torch.bfloat16``; a JAX bf16 array (numpy's
``ml_dtypes`` bfloat16) is read bit for bit. The round trip is bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.models.gpt import (
    GPTBlockParams,
    GPTLMParams,
    GPTMoEBlockParams,
    PagedKVCache,
    map_params,
)
from distributed_tensorflow_tpu_torch.models.cnn import CNNParams
from distributed_tensorflow_tpu_torch.models.mlp import MLPParams
from distributed_tensorflow_tpu_torch.models.rnn import LSTMParams
from distributed_tensorflow_tpu_torch.models.transformer import TransformerParams
from distributed_tensorflow_tpu_torch.ops.optim import AdamState
from distributed_tensorflow_tpu_torch.ops.quantized import QuantizedLinear


def _as_dict(tree) -> dict:
    return tree._asdict() if hasattr(tree, "_asdict") else dict(tree)


def gpt_params_from_numpy(tree, device=None, dtype=None) -> GPTLMParams:
    """numpy tree → port ``GPTLMParams`` (``GPTMoEBlockParams`` blocks for a
    tree with a gate ``wg``) on ``device`` (default cuda), keeping each
    array's dtype unless ``dtype`` is given; ``QuantizedLinear`` leaves keep
    their codes and f32 scales whatever ``dtype`` says."""
    dev = resolve_device(device)
    top = _as_dict(tree)
    blocks = _as_dict(top["blocks"])
    cls = GPTMoEBlockParams if "wg" in blocks else GPTBlockParams

    def t(a):
        if isinstance(a, dict) or hasattr(a, "_fields"):
            q = _as_dict(a)
            qw = _tensor(q["qw"], dev)
            if qw.dtype == torch.uint8:  # e4m3 codes as their bytes
                qw = qw.view(torch.float8_e4m3fn)
            return QuantizedLinear(qw, _tensor(q["scale"], dev, torch.float32))
        return _tensor(a, dev, dtype)

    return GPTLMParams(
        embed=t(top["embed"]),
        pos=t(top["pos"]),
        blocks=cls(**{k: t(blocks[k]) for k in cls._fields}),
        lnf_scale=t(top["lnf_scale"]),
        lnf_bias=t(top["lnf_bias"]),
    )


def gpt_params_to_numpy(params: GPTLMParams) -> dict:
    """Port ``GPTLMParams`` → the nested numpy dict (bf16 leaves widen to
    f32, numpy having no bfloat16; a ``QuantizedLinear`` leaf becomes
    ``{"qw", "scale"}``, e4m3 codes as uint8 bytes)."""
    def arr(x):
        if x.dtype == torch.bfloat16:
            x = x.float()
        elif x.dtype == torch.float8_e4m3fn:
            x = x.view(torch.uint8)
        return x.detach().cpu().numpy()

    p = map_params(params, arr)
    out = p._asdict()
    out["blocks"] = {k: v._asdict() if isinstance(v, QuantizedLinear) else v
                     for k, v in p.blocks._asdict().items()}
    return out


def adam_state_from_numpy(state, device=None) -> AdamState:
    """optax ``ScaleByAdamState`` (or ``{"count", "mu", "nu"}``) over GPT
    params → port ``AdamState`` on ``device`` (default cuda): an int32
    count and f32 moments."""
    top = _as_dict(state)
    return AdamState(
        count=_tensor(top["count"], resolve_device(device), torch.int32).reshape(()),
        mu=gpt_params_from_numpy(top["mu"], device=device),
        nu=gpt_params_from_numpy(top["nu"], device=device),
    )


def adam_state_to_numpy(state: AdamState) -> dict:
    """Port ``AdamState`` → ``{"count": int32 scalar, "mu", "nu"}`` with
    the moments as nested numpy dicts."""
    return {
        "count": np.int32(state.count.item()),
        "mu": gpt_params_to_numpy(state.mu),
        "nu": gpt_params_to_numpy(state.nu),
    }


def params_from_numpy(tree, cls, device=None):
    """A flat numpy tree keyed by ``cls``'s fields → the port's ``cls``
    NamedTuple on ``device`` (default cuda), dtypes kept."""
    dev = resolve_device(device)
    top = _as_dict(tree)
    return cls(*(
        torch.from_numpy(np.array(np.asarray(top[k]), copy=True)).to(dev)
        for k in cls._fields
    ))


def params_to_numpy(params) -> dict:
    """A flat port params NamedTuple → a dict of numpy arrays by field."""
    return {k: v.detach().cpu().numpy() for k, v in params._asdict().items()}


def mlp_params_from_numpy(tree, device=None) -> MLPParams:
    """numpy ``{"w1", "b1", "w2", "b2"}`` → port ``MLPParams``."""
    return params_from_numpy(tree, MLPParams, device)


def cnn_params_from_numpy(tree, device=None) -> CNNParams:
    """numpy ``CNNParams`` fields (HWIO conv kernels) → port ``CNNParams``."""
    return params_from_numpy(tree, CNNParams, device)


def lstm_params_from_numpy(tree, device=None) -> LSTMParams:
    """numpy ``LSTMParams`` fields → port ``LSTMParams``."""
    return params_from_numpy(tree, LSTMParams, device)


def transformer_params_from_numpy(tree, device=None) -> TransformerParams:
    """numpy ``TransformerParams`` fields → port ``TransformerParams``."""
    return params_from_numpy(tree, TransformerParams, device)


# Every flat classifier tree leaves the same way.
mlp_params_to_numpy = cnn_params_to_numpy = lstm_params_to_numpy = params_to_numpy
transformer_params_to_numpy = params_to_numpy


def _tensor(a, dev, dtype=None):
    """numpy (or array-like) → tensor on ``dev``; a bfloat16 or
    float8_e4m3fn array of ``ml_dtypes`` (what ``numpy.asarray`` gives for
    a JAX bf16 or fp8 array) is reinterpreted bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16), copy=True)).view(torch.bfloat16)
    elif a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(np.array(a.view(np.uint8), copy=True)).view(torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=dev, dtype=dtype) if dtype else t.to(dev)


def paged_cache_from_numpy(tree, device=None, dtype=None) -> PagedKVCache:
    """numpy ``{"k", "v", "block_tables", "lengths"}`` (and ``"k_scale"``,
    ``"v_scale"`` for an int8/fp8 pool) → port ``PagedKVCache`` on
    ``device`` (default cuda); the pool in ``dtype`` when given, tables and
    lengths int32, scales f32."""
    dev = resolve_device(device)
    top = _as_dict(tree)
    scale = lambda nm: (None if top.get(nm) is None  # noqa: E731
                        else _tensor(top[nm], dev, torch.float32))
    return PagedKVCache(
        k=_tensor(top["k"], dev, dtype),
        v=_tensor(top["v"], dev, dtype),
        block_tables=_tensor(top["block_tables"], dev, torch.int32),
        lengths=_tensor(top["lengths"], dev, torch.int32),
        k_scale=scale("k_scale"),
        v_scale=scale("v_scale"),
    )


def paged_cache_to_numpy(cache: PagedKVCache) -> dict:
    """Port ``PagedKVCache`` → the numpy dict (a bf16 pool widens to f32,
    an fp8 one keeps its bytes as uint8; absent scales are left out)."""
    def arr(t):
        if t.dtype == torch.bfloat16:
            t = t.float()
        elif t.dtype == torch.float8_e4m3fn:
            t = t.view(torch.uint8)
        return t.detach().cpu().numpy()

    return {k: arr(v) for k, v in cache._asdict().items() if v is not None}


def _adam_like(state) -> dict | None:
    """The ``{"count", "mu", "nu"}`` of an optax Adam state (the chain
    tuple ``(ScaleByAdamState, EmptyState)``, the state itself, or that
    dict), or None for a state that holds no arrays (constant-lr SGD)."""
    if isinstance(state, dict):
        return state if state else None
    if hasattr(state, "_fields") and "mu" in state._fields:
        return state._asdict()
    if isinstance(state, tuple):
        for sub in state:
            found = _adam_like(sub)
            if found is not None:
                return found
    return None


def mlp_opt_state_from_numpy(state, device=None, cls=MLPParams):
    """optax state of ``sgd`` or ``adam`` over the flat params ``cls`` (as
    JAX ``ops.optim.make`` builds it, or ``{"count", "mu", "nu"}``) → the
    port's (``()`` for constant-lr SGD, ``AdamState`` with an int32
    count)."""
    top = _adam_like(state)
    if top is None:
        return ()
    return AdamState(
        count=_tensor(top["count"], resolve_device(device), torch.int32).reshape(()),
        mu=params_from_numpy(top["mu"], cls, device),
        nu=params_from_numpy(top["nu"], cls, device),
    )


def mlp_opt_state_to_numpy(state) -> dict:
    """The port's SGD (``{}``) or ``AdamState`` (``{"count", "mu", "nu"}``)
    over flat params as numpy."""
    if not isinstance(state, AdamState):
        return {}
    return {"count": np.int32(state.count.item()), "mu": params_to_numpy(state.mu),
            "nu": params_to_numpy(state.nu)}


def _row(tree, rank: int):
    """Replica ``rank`` of a stacked numpy tree (dicts, tuples, arrays)."""
    if isinstance(tree, dict):
        return {k: _row(v, rank) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {k: _row(v, rank) for k, v in tree._asdict().items()}
    if isinstance(tree, tuple):
        return tuple(_row(v, rank) for v in tree)
    return np.asarray(tree)[rank]


def async_rank_state_from_numpy(params, opt_state, steps, rank: int, device=None,
                                cls=MLPParams):
    """A JAX ``AsyncDataParallel`` state (params ``cls`` and optimizer
    state stacked ``[n, ...]``, the step vector ``[n]``) → rank ``rank``'s
    ``TrainState`` of the port's ``AsyncDataParallel``: its copy, and every
    rank's step as a tuple."""
    from distributed_tensorflow_tpu_torch.parallel.strategy import TrainState

    return TrainState(
        params_from_numpy(_row(params, rank), cls, device),
        mlp_opt_state_from_numpy(_row(opt_state, rank), device=device, cls=cls),
        tuple(int(s) for s in np.asarray(steps)),
    )


def stack_replicas(trees: list):
    """Per-rank numpy trees (dicts of arrays) → one tree stacked ``[n,
    ...]``, the JAX async layout."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_replicas([t[k] for t in trees]) for k in first}
    return np.stack([np.asarray(t) for t in trees])


def sharded_state_from_numpy(strategy, params, opt_state=(), step: int = 0, device=None,
                             cls=MLPParams):
    """A canonical numpy state (params ``cls``, their optax or dict
    optimizer state, the step) → this rank's ``ShardedDataParallel``
    state: its slices of the parameters and of the moments that track
    them."""
    from distributed_tensorflow_tpu_torch.parallel.strategy import TrainState

    dev = device if device is not None else strategy.device
    return strategy.from_canonical(TrainState(
        params_from_numpy(params, cls, dev),
        mlp_opt_state_from_numpy(opt_state, device=dev, cls=cls), int(step)))


def sharded_state_to_numpy(strategy, state) -> tuple:
    """A sharded strategy's state → the canonical numpy ``(params,
    optimizer state, step)`` (``strategy.to_canonical``: a collective)."""
    c = strategy.to_canonical(state)
    return params_to_numpy(c.params), mlp_opt_state_to_numpy(c.opt_state), int(c.step)


def lm_sharded_state_from_numpy(params, opt_state, mesh, specs, device=None,
                                stages: int | None = None) -> tuple:
    """JAX canonical GPT params and Adam state (numpy trees, or the JAX
    NamedTuples) → this rank's blocks ``(params, AdamState)`` of the spec
    tree ``specs`` over ``mesh`` (tensor, expert or pipeline parallel).
    ``stages``: the blocks and their slots are first staged as [stages,
    L/stages, ...] (``models/gpt.pipeline_stage_params``), the pipeline
    layout ``specs`` splits on dim 0."""
    from distributed_tensorflow_tpu_torch.parallel.specs import (
        map_split,
        match_slot_specs,
        shard_tree,
    )

    p, o = gpt_params_from_numpy(params, device=device), adam_state_from_numpy(opt_state, device)
    if stages is not None:
        def split(a):
            return a.reshape((stages, a.shape[0] // stages) + tuple(a.shape[1:]))

        o = map_split(o, match_slot_specs(o, p, specs), split)
        p = map_split(p, specs, split)
    return (shard_tree(p, specs, mesh),
            shard_tree(o, match_slot_specs(o, p, specs), mesh))


def lm_sharded_state_to_numpy(params, opt_state, mesh, specs, staged: bool = False) -> tuple:
    """Every rank's blocks of GPT params and their ``AdamState`` → the
    canonical numpy ``(params, {"count", "mu", "nu"})`` (a collective over
    the axes ``specs`` names); ``staged``: the pipeline layout's blocks and
    slots unstaged to [num_layers, ...]."""
    from distributed_tensorflow_tpu_torch.parallel.specs import gather_tree, match_slot_specs

    slots = match_slot_specs(opt_state, params, specs)
    p, o = gather_tree(params, specs, mesh), gather_tree(opt_state, slots, mesh)
    p, o = gpt_params_to_numpy(p), adam_state_to_numpy(o)
    if staged:
        p, o = unstage_numpy(p), {**o, "mu": unstage_numpy(o["mu"]), "nu": unstage_numpy(o["nu"])}
    return p, o


def unstage_numpy(tree) -> dict:
    """A staged GPT tree (JAX ``pipeline_stage_params``: blocks [S, L/S,
    ...]; numpy, or the JAX NamedTuple) → the canonical numpy tree, the two
    leading block dims merged; bit for bit."""
    d = _as_dict(tree)
    blocks = {k: np.asarray(v) for k, v in _as_dict(d["blocks"]).items()}
    return {**{k: np.asarray(v) for k, v in d.items() if k != "blocks"},
            "blocks": {k: v.reshape((-1,) + v.shape[2:]) for k, v in blocks.items()}}


def _lm_opt_from_numpy(state, device=None):
    """An optax (or dict) SGD or Adam state over GPT params → the port's
    (``()`` for constant-lr SGD, else ``AdamState``)."""
    top = _adam_like(state)
    return () if top is None else adam_state_from_numpy(top, device)


def _lm_opt_to_numpy(state) -> dict:
    """:func:`adam_state_to_numpy` of an ``AdamState`` whose count may be a
    stack ``[n]``, ``{}`` for constant-lr SGD's empty state."""
    if not isinstance(state, AdamState):
        return {}
    return {"count": state.count.cpu().numpy(), "mu": gpt_params_to_numpy(state.mu),
            "nu": gpt_params_to_numpy(state.nu)}


def _stacked(tree, mesh, axis):
    """Every rank's tensors of ``tree`` stacked ``[n, ...]`` in axis order
    (a collective over ``axis``)."""
    from distributed_tensorflow_tpu_torch.ops.collectives import all_gather_raw
    from distributed_tensorflow_tpu_torch.ops.optim import tree_map

    return tree_map(lambda t: all_gather_raw(t.unsqueeze(0), mesh, axis, 0), tree)


def lm_async_state_from_numpy(params, opt_state, mesh, axis: str = "data",
                              device=None) -> tuple:
    """A JAX async LM state (GPT params and their SGD or Adam state stacked
    ``[n, ...]``, numpy or the JAX trees) → this rank's copy ``(params,
    opt_state)`` (its index along ``axis``)."""
    r = mesh.axis_index(axis)
    return (gpt_params_from_numpy(_row(params, r), device=device),
            _lm_opt_from_numpy(_row(opt_state, r), device))


def lm_async_state_to_numpy(params, opt_state, mesh, axis: str = "data") -> tuple:
    """Every rank's copy of GPT params and optimizer state → the JAX async
    layout as numpy, stacked ``[n, ...]`` (a collective over ``axis``)."""
    return (gpt_params_to_numpy(_stacked(params, mesh, axis)),
            _lm_opt_to_numpy(_stacked(opt_state, mesh, axis)))


def diloco_state_from_numpy(state, mesh=None, axis: str = "data", device=None):
    """A JAX ``DiLoCoState`` (numpy, or the NamedTuple) → the port's: on a
    ``mesh`` the inner state of this rank's worker, else the stacked
    ``[n, ...]`` inner states of the one-device gang; θ_start, momentum,
    residual and in-flight state as they are (None stays None)."""
    from distributed_tensorflow_tpu_torch.train.local_sgd import DiLoCoState, InFlight

    d = _as_dict(state)
    inner = d["inner"]
    if _adam_like(inner) is None:
        inner = ()
    elif mesh is not None:
        inner = _lm_opt_from_numpy(_row(inner, mesh.axis_index(axis)), device)
    else:
        top = _as_dict(_adam_like(inner))
        inner = AdamState(_tensor(top["count"], resolve_device(device), torch.int32),
                          gpt_params_from_numpy(top["mu"], device=device),
                          gpt_params_from_numpy(top["nu"], device=device))

    def tree(x):
        return None if x is None else gpt_params_from_numpy(x, device=device)

    f = d.get("inflight")
    return DiLoCoState(inner, tree(d["theta"]), tree(d["momentum"]), tree(d.get("residual")),
                       None if f is None else InFlight(tree(_as_dict(f)["delta"]),
                                                       tree(_as_dict(f)["landing"])))


def diloco_state_to_numpy(state, mesh=None, axis: str = "data") -> dict:
    """The port's ``DiLoCoState`` → the JAX fields as numpy, the inner
    states stacked ``[n, ...]`` (on a ``mesh`` gathered from every rank: a
    collective), ``inflight`` as ``{"delta", "landing"}``; None stays
    None."""
    inner = state.inner
    if mesh is not None and isinstance(inner, AdamState):
        inner = _stacked(inner, mesh, axis)
    inner = _lm_opt_to_numpy(inner)

    def tree(x):
        return None if x is None else gpt_params_to_numpy(x)

    f = state.inflight
    return {"inner": inner, "theta": tree(state.theta), "momentum": tree(state.momentum),
            "residual": tree(state.residual),
            "inflight": None if f is None else {"delta": tree(f.delta),
                                                "landing": tree(f.landing)}}
