"""A Switch-style top-k mixture-of-experts FFN on one device.

Counterpart of ``distributed_tensorflow_tpu/ops/moe.py``: ``MoEParams``
(:40), ``MoEAux`` (:48), ``init_moe`` (:78), ``_expert_ffn`` (:91),
``_route`` (:98), ``_combine`` (:172), ``moe_ffn_dense`` (:179) and
``moe_ffn_local`` (:205) and the expert-parallel body ``moe_ffn`` (:244):
one expert a rank of a mesh axis, the tokens exchanged by two
all-to-alls (``parallel/mesh.Mesh.all_to_all``, whose backward is the
inverse exchange).

Semantics, as there:

- top-k routing on the gate logits ``x @ wg`` (f32 products of the
  compute-dtype activations and the f32 gate): k=1 takes the first maximum
  (Switch) and combines with the raw router probability; k>=2 takes the k
  largest in rank order and renormalizes their probabilities to sum to 1;
- a static capacity a call: each expert takes at most ``capacity`` of the
  (token, choice) dispatches, filled CHOICE-MAJOR (every token's first
  choice before any second choice); a dispatch past capacity contributes
  zero;
- ``token_mask`` (ragged batches) keeps pad tokens out of routing, the
  capacity slots and every aux statistic.

Nothing here reads a value back to the host, and every shape is static.
The JAX package computes the experts' products outside any Pallas kernel
(XLA ops), so here they are PyTorch products over the expert-stacked
buffers: ``_expert_ffn``'s first product on compute-dtype operands with
f32 accumulation, its tanh-GELU output kept in f32, and the down
projection an f32 product of that output and the compute-dtype-valued
``w_down`` (the JAX dtype promotion).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class MoEParams(NamedTuple):
    wg: torch.Tensor  # [D, E] gate (f32)
    w_up: torch.Tensor  # [E, D, H]
    b_up: torch.Tensor  # [E, H]
    w_down: torch.Tensor  # [E, H, D]
    b_down: torch.Tensor  # [E, D]


class MoEAux(NamedTuple):
    """The router's statistics over the tokens of one call, f32:
    ``balance_loss`` (Switch, ``E · Σ_e f_e · P_e``), ``z_loss`` (ST-MoE,
    ``mean(logsumexp(logits)²)``), ``drop_fraction`` (dispatches past
    capacity, a metric with no gradient) and ``expert_fraction`` ``f``
    [E], the dispatch distribution."""

    balance_loss: torch.Tensor
    z_loss: torch.Tensor
    drop_fraction: torch.Tensor
    expert_fraction: torch.Tensor

    @staticmethod
    def zero(device=None) -> "MoEAux":
        z = torch.zeros((), dtype=torch.float32, device=device)
        return MoEAux(z, z, z, z)


def init_moe(d: int, hidden: int, num_experts: int, generator: torch.Generator) -> MoEParams:
    """Fresh expert weights from ``generator`` (the JAX scales: the gate
    and the up projections N(0, 1/fan-in), the down projections N(0,
    1/hidden), zero biases)."""
    def normal(*shape):
        return torch.randn(shape, generator=generator)

    return MoEParams(
        wg=normal(d, num_experts) / d ** 0.5,
        w_up=normal(num_experts, d, hidden) / d ** 0.5,
        b_up=torch.zeros(num_experts, hidden),
        w_down=normal(num_experts, hidden, d) / hidden ** 0.5,
        b_down=torch.zeros(num_experts, d),
    )


def _expert_ffn(x, w_up, b_up, w_down, b_down):
    """One FFN an expert over ``x`` [E, C, D] (or [C, D] with unbatched
    weights): the up product of compute-dtype operands with f32
    accumulation, tanh-GELU in f32, and the down product in f32 (``h``
    stays f32; ``w_down``'s compute-dtype values upcast exactly)."""
    h = F.gelu(torch.matmul(x.float(), w_up.float()) + b_up.float().unsqueeze(-2),
               approximate="tanh")
    return torch.matmul(h, w_down.float()) + b_down.float().unsqueeze(-2)


def _route(x, wg, num_experts: int, capacity: int, token_mask=None, k: int = 1):
    """Top-k routing of ``x`` [T, D]: ``(expert_idx [T, k], gate_w [T, k],
    slot [T, k], keep [T, k], aux)``, where ``slot`` is a dispatch's place
    in its expert's capacity buffer (choice-major: choice c of token t is
    row c·T + t of the cumulative count) and ``keep = slot < capacity``
    (and the token real, under ``token_mask`` [T] bool)."""
    if not 1 <= k <= num_experts:
        raise ValueError(f"top-k k={k} must be in [1, num_experts={num_experts}]")
    t = x.shape[0]
    logits = x.float() @ wg.float()
    probs = torch.softmax(logits, dim=-1)
    if k == 1:
        expert_idx = torch.argmax(logits, dim=-1)[:, None]  # the first maximum
    else:
        expert_idx = torch.topk(logits, k, dim=-1).indices  # rank order
    gate_w = probs.gather(-1, expert_idx)
    if k > 1:
        gate_w = gate_w / gate_w.sum(-1, keepdim=True)
    onehot = F.one_hot(expert_idx, num_experts).to(torch.int32)  # [T, k, E]
    if token_mask is not None:
        onehot = onehot * token_mask.to(torch.int32)[:, None, None]
    flat = onehot.transpose(0, 1).reshape(k * t, num_experts)
    slot_flat = (torch.cumsum(flat, dim=0) - 1).reshape(k, t, num_experts)
    slot = slot_flat.transpose(0, 1).gather(-1, expert_idx[:, :, None])[:, :, 0]
    keep = slot < capacity
    if token_mask is not None:
        keep = keep & token_mask[:, None]
    lse2 = torch.logsumexp(logits, dim=-1) ** 2
    dispatch = onehot.sum(1).float()  # [T, E]
    if token_mask is None:
        f = dispatch.mean(0) / k
        p_mean = probs.mean(0)
        z = lse2.mean()
        kept = keep.float().mean()
    else:
        w = token_mask.float()
        denom = torch.clamp(w.sum(), min=1.0)
        f = dispatch.sum(0) / (denom * k)
        p_mean = (probs * w[:, None]).sum(0) / denom
        z = (lse2 * w).sum() / denom
        kept = (keep.float() * w[:, None]).sum() / (denom * k)
    aux = MoEAux(balance_loss=num_experts * (f * p_mean).sum(), z_loss=z,
                 drop_fraction=1.0 - kept, expert_fraction=f)
    return expert_idx, gate_w, slot, keep, aux


def _combine(gate_w, keep, gathered):
    """``Σ_c keep_c · w_c · out_c``: gate_w / keep [T, k], gathered
    [T, k, D] → [T, D]."""
    w = torch.where(keep, gate_w, torch.zeros_like(gate_w))
    return torch.einsum("tk,tkd->td", w, gathered)


def moe_ffn_dense(params: MoEParams, x, capacity: int, *, with_aux: bool = False,
                  token_mask=None, k: int = 1):
    """Reference form: every expert on every token, the same routing and
    drops as :func:`moe_ffn_local`."""
    e = params.wg.shape[1]
    expert_idx, gate_w, _, keep, aux = _route(x, params.wg, e, capacity, token_mask, k=k)
    outs = _expert_ffn(x.unsqueeze(0), params.w_up, params.b_up, params.w_down,
                       params.b_down)  # [E, T, D]
    picked = outs[expert_idx, torch.arange(x.shape[0], device=x.device)[:, None]]
    out = _combine(gate_w, keep, picked)
    return (out, aux) if with_aux else out


def moe_ffn_local(params: MoEParams, x, capacity: int, *, with_aux: bool = False,
                  token_mask=None, k: int = 1):
    """The sparse form: each expert runs once on its buffer of ``capacity``
    dispatches ([E, C, D]). A kept dispatch owns its (expert, slot); a
    dropped one is written to a spare row C of its expert, which the
    experts never read (so no write lands on a kept token and no
    accumulation is needed), and reads zeros back."""
    e = params.wg.shape[1]
    t, d = x.shape
    expert_idx, gate_w, slot, keep, aux = _route(x, params.wg, e, capacity, token_mask, k=k)
    cols = torch.where(keep, slot, torch.full_like(slot, capacity))
    contrib = torch.where(keep[:, :, None], x[:, None, :], torch.zeros_like(x[:, None, :]))
    send = x.new_zeros((e, capacity + 1, d)).index_put((expert_idx, cols), contrib)
    out = _expert_ffn(send[:, :capacity], params.w_up, params.b_up, params.w_down,
                      params.b_down)  # [E, C, D]
    gathered = F.pad(out, (0, 0, 0, 1))[expert_idx, cols]  # the spare row reads zeros
    result = _combine(gate_w, keep, gathered)
    return (result, aux) if with_aux else result


def moe_ffn(params: MoEParams, x, mesh, axis_name: str, capacity: int, *,
            with_aux: bool = False, token_mask=None, k: int = 1):
    """The expert-parallel body (JAX ``moe_ffn``): this rank's tokens
    ``x`` [T, D] routed over the n experts of ``axis_name`` of ``mesh``, one
    a rank (``params.w_up`` etc. carry a leading [1, ...]: this rank's
    expert; ``wg`` [D, n] is replicated). Capacity holds per (expert,
    source rank). The [n, C, D] send buffer is :func:`moe_ffn_local`'s
    spare-row scatter; the first all-to-all gives this rank's expert its
    [n, C, D] rows by source, the expert runs once on the n·C rows, the
    second all-to-all returns them, and each token gathers and combines its
    k choices. Returns [T, D] (and this rank's ``MoEAux`` over its own
    tokens with ``with_aux``). A collective: every rank of the axis calls
    it; differentiable, the gradient taking the inverse exchanges."""
    n = mesh.axis_size(axis_name)
    if params.wg.shape[-1] != n or params.w_up.shape[0] != 1:
        raise ValueError(
            f"moe_ffn over the {n}-way {axis_name!r} axis routes over {n} experts, one a "
            f"rank: got a gate over {params.wg.shape[-1]} experts and {params.w_up.shape[0]} "
            "local experts")
    t, d = x.shape
    expert_idx, gate_w, slot, keep, aux = _route(x, params.wg, n, capacity, token_mask, k=k)
    cols = torch.where(keep, slot, torch.full_like(slot, capacity))
    contrib = torch.where(keep[:, :, None], x[:, None, :], torch.zeros_like(x[:, None, :]))
    send = x.new_zeros((n, capacity + 1, d)).index_put((expert_idx, cols), contrib)
    recv = mesh.all_to_all(send[:, :capacity], axis_name, 0, 0)  # [n, C, D] by source
    out = _expert_ffn(recv.reshape(n * capacity, d), params.w_up[0], params.b_up[0],
                      params.w_down[0], params.b_down[0]).reshape(n, capacity, d)
    back = mesh.all_to_all(out, axis_name, 0, 0)  # [n, C, D] by expert
    gathered = F.pad(back, (0, 0, 0, 1))[expert_idx, cols]  # the spare row reads zeros
    result = _combine(gate_w, keep, gathered)
    return (result, aux) if with_aux else result
