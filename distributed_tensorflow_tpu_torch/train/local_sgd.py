"""Local SGD / DiLoCo outer loop for the GPT family.

Counterpart of ``distributed_tensorflow_tpu/train/local_sgd.py`` (:120-770).
The reference's async parameter server (``tfdist_between.py``) applies each
worker's update the moment it has it; ``models/gpt.make_lm_async_parts``
carries that to the GPT family as a copy a rank exchanging at the mean. This
module is its communication-reducing form, local SGD with a DiLoCo outer
optimizer:

- each worker runs ``sync_every`` = H **inner** steps with the inner
  optimizer on its own shard of the batch (no traffic between workers);
- the gang then applies ONE **outer** update from the pseudo-gradient
  Δ = θ_start − mean_w(θ_w) through Nesterov momentum (m ← μ·m + Δ;
  θ ← θ_start − η_out·(Δ + μ·m); ``nesterov=False`` is the heavy-ball
  θ ← θ_start − η_out·m), and every copy jumps to the new θ, the next
  round's θ_start.

``outer_lr`` None resolves to N, the worker count (async's
``update_scale=N``: the parameter server applied all N workers' updates in
turn); ``outer_lr=1`` is plain local-SGD averaging. At ``sync_every=1,
outer_lr=1, outer_momentum=0`` the outer update returns the parameter mean
itself (:func:`outer_update`), so the step equals the async exchange
(``make_lm_async_parts(avg_every=1, update_scale=1)``) bit for bit and, for
SGD, the sync data-parallel step up to the order of the sums.

Two levers, both off by default (the outer loop above is then unchanged):

- ``delta_dtype`` "int8" | "fp8": Δ is quantized per tensor
  (``ops/quantized.quantize_tensor``) with an error-feedback residual
  carried in :class:`DiLoCoState`: each round quantizes Δ + r and keeps
  (Δ + r) − Δ̂ for the next (:func:`compress_delta`);
  :func:`delta_payload_nbytes` counts the wire bytes.
- ``overlap``: the delta computed at a boundary goes in flight and is
  applied one round late, while the next H inner steps run; the
  pseudo-gradient is the mean round movement (from where the copies landed
  at the last boundary) and the copies merge toward the stale-applied
  anchor by :data:`OVERLAP_MERGE` instead of jumping to it
  (:func:`outer_round_step`). :func:`streaming_schedule` is the layer-wise
  plan a gang issues the partitions by; the math does not depend on it.

Two engines, one math, both through :func:`_local_inner_step` and
:func:`outer_round_step`:

- :func:`make_lm_diloco_parts`: the gang on a :class:`~parallel.mesh.Mesh`,
  one rank a worker. The rank holds its copy and its inner optimizer state;
  θ_start, momentum, residual and in-flight state are held alike by every
  rank. The exchange is a host ``if`` on the step count: its all-reduces
  run only on round boundaries.
- :func:`make_lm_diloco_vmapped`: the same gang emulated on one device,
  the copies stacked [n, ...]. The JAX package vectorizes the workers with
  ``jax.vmap``; here the body is a loop over the n workers, because the
  flash operator (``dtf::FlashAttention``) has no batching rule for
  ``torch.func.vmap``.

The mailbox gang (JAX :772-1149): :class:`DeltaExchange` moves the outer
round to the host for a stale-tolerant gang, one member a process: each
member posts its (compressed) delta to a shared directory at its own
boundary and applies the outer update from whatever peers have posted,
weighted by :func:`staleness_weight`, never waiting. The posts are JAX's
files: the same ``.npz`` keys, fp8 codes stored as ``uint8``, the same
CRC32C envelope (``train/resilience.py``), so a JAX member and a port
member on one directory read each other's posts.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.models.gpt import _shard, make_lm_train_step
from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves, tree_map, tree_unflatten


class InFlight(NamedTuple):
    """The overlapped exchange's state (the JAX dict's two keys): ``delta``,
    the outer pseudo-gradient in flight, and ``landing``, the mean point
    the copies landed on at the last boundary. Both dense parameter trees."""

    delta: Any
    landing: Any


class DiLoCoState(NamedTuple):
    """The ``opt_state`` slot of a diloco-mode ``TrainState``.

    ``inner``: the workers' inner optimizer states (this rank's on the mesh
    engine, stacked [n, ...] on the one-device engine; they persist across
    outer rounds). ``theta``: the outer anchor θ_start and ``momentum`` the
    outer Nesterov buffer, parameter trees held alike by every worker.
    ``residual``: the error-feedback residual of ``delta_dtype`` (None when
    that lever is off); ``inflight``: the overlapped exchange's
    :class:`InFlight` (None when ``overlap`` is off)."""

    inner: Any
    theta: Any
    momentum: Any
    residual: Any = None
    inflight: Any = None


def _zeros(params):
    return tree_map(torch.zeros_like, params)


def _copy(params):
    return tree_map(torch.clone, params)


def outer_update(theta, mean_params, momentum, *, outer_lr: float, outer_momentum: float,
                 nesterov: bool = True):
    """One outer apply, ``(θ_start, mean_w(θ_w), m) → (θ', m')``: Δ = θ_start −
    mean_params, m' = μ·m + Δ, θ' = θ_start − η_out·(Δ + μ·m') (Nesterov) or
    θ_start − η_out·m' (heavy-ball). At ``outer_lr == 1 and outer_momentum
    == 0`` θ' is ``mean_params`` itself (θ − (θ − mean) = mean, exactly),
    and m' records Δ."""
    mu, eta = float(outer_momentum), float(outer_lr)
    with torch.no_grad():
        delta = tree_map(torch.sub, theta, mean_params)
    if eta == 1.0 and mu == 0.0:
        return mean_params, delta
    return outer_apply(theta, delta, momentum, outer_lr=eta, outer_momentum=mu,
                       nesterov=nesterov)


@torch.no_grad()
def outer_apply(theta, delta, momentum, *, outer_lr: float, outer_momentum: float,
                nesterov: bool = True):
    """The outer optimizer on a given pseudo-gradient, ``(θ_start, Δ, m) →
    (θ', m')``: :func:`outer_update` below its Δ (a compressed Δ̂ or the
    in-flight Δ of an overlapped round goes through the same recurrence)."""
    mu, eta = float(outer_momentum), float(outer_lr)
    new_m = tree_map(lambda m, d: mu * m + d, momentum, delta) if mu != 0.0 else delta
    if nesterov:
        step = tree_map(lambda d, m: d + mu * m, delta, new_m) if mu != 0.0 else delta
    else:
        step = new_m
    return tree_map(lambda t, s: t - eta * s, theta, step), new_m


@torch.no_grad()
def compress_delta(delta, residual, delta_dtype: str):
    """Error-feedback compression of the outer pseudo-gradient: Δ + r
    quantized per tensor (one symmetric f32 scale a tensor, the wire
    format) and back, and the error kept: ``(Δ̂, (Δ + r) − Δ̂)``."""
    from distributed_tensorflow_tpu_torch.ops.quantized import (
        dequantize_tensor,
        quantize_tensor,
    )

    corr = tree_map(torch.add, delta, residual)
    dhat = tree_map(lambda x: dequantize_tensor(*quantize_tensor(x, delta_dtype), x.dtype), corr)
    return dhat, tree_map(torch.sub, corr, dhat)


# How far an overlapped boundary pulls each copy toward the stale-applied
# anchor (0 keeps the local copy, 1 resets it): the JAX package's measured
# streaming-DiLoCo merge. Both engines read this constant.
OVERLAP_MERGE = 0.25


@torch.no_grad()
def _merge_toward(local, target):
    """``(1 − α)·local + α·target``, α = :data:`OVERLAP_MERGE`
    (``target`` broadcasts against a stack of copies)."""
    a = OVERLAP_MERGE
    return tree_map(lambda x, t: (1.0 - a) * x + a * t, local, target)


@torch.no_grad()
def outer_round_step(theta, mean_params, momentum, residual, inflight, *, outer_lr: float,
                     outer_momentum: float, nesterov: bool = True,
                     delta_dtype: str | None = None, overlap: bool = False):
    """ONE outer round under the levers, shared by both engines:
    ``(θ_start, mean_w(θ_w), m, r, f) → (θ', m', r', f')``.

    With both levers off this is :func:`outer_update`. ``delta_dtype``
    passes the pseudo-gradient through :func:`compress_delta`. ``overlap``
    applies the in-flight delta of the previous boundary (zero at the first)
    and puts this round's in its place; this round's pseudo-gradient is the
    mean round movement ``f.landing − mean_w(θ_w)``, and the new landing is
    where the merged copies land on average, ``(1 − α)·mean + α·θ'``."""
    if delta_dtype is None and not overlap:
        theta2, m2 = outer_update(theta, mean_params, momentum, outer_lr=outer_lr,
                                  outer_momentum=outer_momentum, nesterov=nesterov)
        return theta2, m2, residual, inflight
    base = inflight.landing if overlap else theta
    delta = tree_map(torch.sub, base, mean_params)
    if delta_dtype is not None:
        delta, residual = compress_delta(delta, residual, delta_dtype)
    kw = dict(outer_lr=outer_lr, outer_momentum=outer_momentum, nesterov=nesterov)
    if not overlap:
        theta2, m2 = outer_apply(theta, delta, momentum, **kw)
        return theta2, m2, residual, inflight
    theta2, m2 = outer_apply(theta, inflight.delta, momentum, **kw)
    return theta2, m2, residual, InFlight(delta, _merge_toward(mean_params, theta2))


def resolve_outer_lr(outer_lr: float | None, num_workers: int) -> float:
    """``outer_lr`` None → N (the ``update_scale=N`` convention of the async
    modes); the one place that default lives."""
    return float(num_workers) if outer_lr is None else float(outer_lr)


def sync_rounds_between(count0: int, count1: int, sync_every: int) -> int:
    """Outer rounds fired by the steps ``count0 .. count1 − 1`` (step t
    fires iff ``(t + 1) % sync_every == 0``)."""
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    return count1 // sync_every - count0 // sync_every


def params_nbytes(params) -> int:
    """Bytes of one dense parameter set: the payload of one outer round's
    all-reduce (meta tensors count alike)."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(params)))


def delta_payload_nbytes(params, delta_dtype: str | None) -> int:
    """Bytes one outer delta puts on the wire: :func:`params_nbytes` at
    ``delta_dtype=None``, else a byte an element and one f32 scale a
    tensor."""
    if delta_dtype is None:
        return params_nbytes(params)
    if delta_dtype not in ("int8", "fp8"):
        raise ValueError(f"delta_dtype must be None, 'int8', or 'fp8'; got {delta_dtype!r}")
    leaves = tree_leaves(params)
    return int(sum(t.numel() for t in leaves) + 4 * len(leaves))


def staleness_weight(age: int, stale_limit: int) -> float:
    """Weight of a delta ``age`` outer rounds old: 1/(1 + age) within the
    window, 0 past it and for a negative age."""
    if age < 0 or age > stale_limit:
        return 0.0
    return 1.0 / (1.0 + age)


def streaming_schedule(params, sync_every: int, partitions: int | None = None) -> list[dict]:
    """The overlapped exchange's plan: the delta's leaves, in order, split
    greedily into ``partitions`` byte-balanced runs of adjacent leaves
    (default one a leaf, at most H), partition k issued after inner step
    ``k·H // P`` of the next round. ``[{"partition", "leaves", "nbytes",
    "issue_step"}, ...]``."""
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    leaves = tree_leaves(params)
    if not leaves:
        return []
    if partitions is None:
        partitions = min(len(leaves), sync_every)
    partitions = max(1, min(int(partitions), len(leaves)))
    sizes = [int(t.numel() * t.element_size()) for t in leaves]
    target = sum(sizes) / partitions
    groups: list[list[int]] = [[]]
    acc = 0
    for i, nb in enumerate(sizes):
        remaining_groups = partitions - (len(groups) - 1)
        remaining_leaves = len(sizes) - i
        if (groups[-1] and acc + nb / 2 >= target and remaining_groups > 1
                and remaining_leaves >= remaining_groups):
            groups.append([])
            acc = 0
        groups[-1].append(i)
        acc += nb
    return [{"partition": k, "leaves": len(idxs), "nbytes": int(sum(sizes[i] for i in idxs)),
             "issue_step": (k * sync_every) // len(groups)} for k, idxs in enumerate(groups)]


def _local_inner_step(model, optimizer, ragged: bool):
    """One worker's inner step, ``step(p, o, tokens, lens) -> (p, o,
    loss)``, shared by both engines: the single-device step
    (``models/gpt.make_lm_train_step``), masked over ``lens`` when
    ``ragged``."""
    single = make_lm_train_step(model, optimizer)

    def step(p, o, tokens, lens):
        return single(p, o, tokens, lens if ragged else None)

    return step


def _fresh_outer(params, delta_dtype, overlap):
    """θ_start at ``params`` (a copy), zero momentum, and the levers' state
    from nothing: a zero residual, nothing in flight and every copy landed
    on θ_start (a copy of it, never the same tensors)."""
    return (_copy(params), _zeros(params),
            _zeros(params) if delta_dtype is not None else None,
            InFlight(_zeros(params), _copy(params)) if overlap else None)


def make_lm_diloco_parts(model, optimizer, mesh, *, axis: str = "data", sync_every: int,
                         outer_lr: float | None = None, outer_momentum: float = 0.0,
                         nesterov: bool = True, ragged: bool = False,
                         delta_dtype: str | None = None, overlap: bool = False):
    """The DiLoCo gang on ``mesh``, one rank of ``axis`` a worker (the
    LMTrainer's ``dp_mode="diloco"`` with a mesh). Returns ``(init_state,
    mapped)``:

    - ``init_state(params, opt_state) -> (params, DiLoCoState, count)``:
      this rank's worker copy, its inner state, θ_start = params, zero
      momentum (and the levers' state), count 0;
    - ``mapped(params, dstate, tokens, lens, count) -> (params, dstate,
      loss)``: one inner step on this rank's rows of the global batch
      ``tokens`` [n·B, L] (and ``lens`` when ``ragged``), then, when
      ``(count + 1) % sync_every == 0`` (a host ``if`` on the host count,
      so the all-reduce runs on boundaries only), the outer round on the
      mean of the copies, one all-reduce of a flat bucket. ``loss`` is this
      rank's own; the trainer means it over the ranks where it reads it."""
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    n = mesh.axis_size(axis)
    eta = resolve_outer_lr(outer_lr, n)
    step_fn = _local_inner_step(model, optimizer, ragged)

    def init_state(params, opt_state):
        return (_copy(params),
                DiLoCoState(tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                                     opt_state),
                            *_fresh_outer(params, delta_dtype, overlap)), 0)

    def mapped(params, dstate, tokens, lens, count):
        toks = _shard(tokens, mesh, axis, 0)
        ln = _shard(lens, mesh, axis, 0) if ragged else None
        p, o, loss = step_fn(params, dstate.inner, toks, ln)
        theta, m, r, f = dstate.theta, dstate.momentum, dstate.residual, dstate.inflight
        if (count + 1) % sync_every == 0:
            pbar = tree_unflatten(p, mesh.mean_(tree_leaves(p), axis))
            theta, m, r, f = outer_round_step(
                theta, pbar, m, r, f, outer_lr=eta, outer_momentum=outer_momentum,
                nesterov=nesterov, delta_dtype=delta_dtype, overlap=overlap)
            p = _merge_toward(p, theta) if overlap else _copy(theta)
        return p, DiLoCoState(o, theta, m, r, f), loss

    return init_state, mapped


def _stack(trees):
    """Per-worker trees → one tree stacked [n, ...]; a leaf that is not a
    tensor (a host count every worker shares) kept once."""
    def one(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        if any(x != xs[0] for x in xs):
            raise ValueError(f"host leaves differ between workers: {xs}")
        return xs[0]

    return tree_map(one, *trees)


def _row(tree, w: int):
    """Worker ``w``'s tree of a stacked one."""
    return tree_map(lambda t: t[w] if isinstance(t, torch.Tensor) else t, tree)


def make_lm_diloco_vmapped(model, optimizer, num_workers: int, *, sync_every: int,
                           outer_lr: float | None = None, outer_momentum: float = 0.0,
                           nesterov: bool = True, ragged: bool = False,
                           delta_dtype: str | None = None, overlap: bool = False):
    """The same DiLoCo gang as ONE single-device program (the LMTrainer's
    ``dp_mode="diloco"`` with ``mesh=None`` and ``diloco_workers=n``): the
    copies and inner states stacked [n, ...], the first batch dim of
    ``tokens`` split n ways in worker order (the mesh engine's split), the
    exchange a mean over the stack. The JAX package maps the workers with
    ``jax.vmap``; the port loops over them, because the flash operator
    (``dtf::FlashAttention``) has no batching rule for ``torch.func.vmap``.
    Same contract as :func:`make_lm_diloco_parts`; ``loss`` is the mean of
    the workers' losses."""
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    if num_workers < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    n = num_workers
    eta = resolve_outer_lr(outer_lr, n)
    step_fn = _local_inner_step(model, optimizer, ragged)

    def init_state(params, opt_state):
        return (_stack([params] * n),
                DiLoCoState(_stack([opt_state] * n), *_fresh_outer(params, delta_dtype, overlap)),
                0)

    def mapped(params, dstate, tokens, lens, count):
        b, l = tokens.shape
        if b % n:
            raise ValueError(f"batch {b} must divide over {n} emulated workers")
        rows = b // n
        out = [step_fn(_row(params, w), _row(dstate.inner, w), tokens[w * rows:(w + 1) * rows],
                       lens[w * rows:(w + 1) * rows] if ragged else None) for w in range(n)]
        p, inner = _stack([x[0] for x in out]), _stack([x[1] for x in out])
        loss = torch.stack([x[2] for x in out]).mean()
        theta, m, r, f = dstate.theta, dstate.momentum, dstate.residual, dstate.inflight
        if (count + 1) % sync_every == 0:
            with torch.no_grad():
                pbar = tree_map(lambda x: x.sum(0) / n, p)
            theta, m, r, f = outer_round_step(
                theta, pbar, m, r, f, outer_lr=eta, outer_momentum=outer_momentum,
                nesterov=nesterov, delta_dtype=delta_dtype, overlap=overlap)
            p = _merge_toward(p, theta) if overlap else _stack([theta] * n)
        return p, DiLoCoState(inner, theta, m, r, f), loss

    return init_state, mapped


# ---------------------------------------------------------------------------
# The mailbox gang: a stale-tolerant outer round through a shared directory.
# Files commit atomically (tmp + os.replace), so a reader never sees a torn
# payload and a member's crash leaves nothing half written.
# ---------------------------------------------------------------------------


def _np_encode_delta(leaves, delta_dtype):
    """Leaves for the wire through :func:`ops.quantized.quantize_tensor`
    (the in-graph compressed path's quantizer): ``(stored, scales,
    dequantized)``. ``stored`` goes to disk (int8 codes, or the fp8 codes
    viewed as uint8, as the JAX package stores them); ``dequantized`` is
    what every reader reconstructs, returned so that the poster's residual
    sees the wire values."""
    if delta_dtype is None:
        leaves = [np.asarray(x, np.float32) for x in leaves]
        return leaves, None, leaves
    if delta_dtype not in ("int8", "fp8"):
        raise ValueError(f"delta_dtype must be None, 'int8', or 'fp8'; got {delta_dtype!r}")
    from distributed_tensorflow_tpu_torch.ops.quantized import quantize_tensor

    stored, scales, deq = [], [], []
    for x in leaves:
        q, scale = quantize_tensor(torch.from_numpy(np.asarray(x, np.float32)), delta_dtype)
        scale = float(scale)
        codes = q.view(torch.uint8).numpy() if delta_dtype == "fp8" else q.numpy()
        stored.append(codes)
        deq.append(_codes_to_f32(codes, delta_dtype) * scale)
        scales.append(scale)
    return stored, np.asarray(scales, np.float32), deq


def _codes_to_f32(codes: np.ndarray, delta_dtype: str) -> np.ndarray:
    """Stored codes as float32 (exact): int8 as they are, fp8 (e4m3, stored
    as uint8) through torch's float8 dtype (numpy has none)."""
    if delta_dtype == "fp8":
        return torch.from_numpy(np.ascontiguousarray(codes)).view(
            torch.float8_e4m3fn).float().numpy()
    return codes.astype(np.float32)


def _np_decode_delta(stored, scales, delta_dtype):
    """Inverse of :func:`_np_encode_delta` on the read side."""
    if delta_dtype is None:
        return [np.asarray(x, np.float32) for x in stored]
    return [_codes_to_f32(x, delta_dtype) * float(s) for x, s in zip(stored, scales)]


class DeltaExchange:
    """Filesystem outer-delta mailbox of a stale-tolerant DiLoCo gang (the
    JAX ``DeltaExchange``, whose behaviour it keeps).

    One instance a member (``rank`` of ``world``), all on one ``dirpath``.
    At each outer boundary (``LMTrainer(delta_exchange=)`` drives it):

    1. :meth:`post` compresses (``delta_dtype``) and publishes this
       member's delta of round ``r`` as ``w<rank>_r<round>.npz`` and
       returns the dequantized wire values;
    2. :meth:`weighted_delta` takes the round's pseudo-gradient: its own
       delta at weight 1 plus every peer post this member has not consumed
       yet and no more than ``stale_limit`` rounds old, each weighted
       ``1/(1 + age)`` (a post from a round ahead is age 0). Each post is
       applied at most once (a per-peer consumed watermark); a peer with
       nothing new does not contribute; the round never waits.

    Each post garbage-collects the member's own posts past the window.
    Every post carries a CRC32C envelope over its stored bytes, checked on
    read: a committed post that fails it (or a broken zip) is skipped,
    never consumed, the watermark passing it, with a ``mailbox_corrupt``
    journal event and ``corrupt_posts`` counting it; a transient read
    error retries at the next boundary. A post without a ``crc`` entry
    (an older writer) is read unchecked. ``.tmp`` orphans of killed writers
    are swept (age-guarded) at construction and at each post.
    Failpoints: ``delta.post`` (+ its tear), ``delta.post.commit``,
    ``delta.load``."""

    _CORRUPT = object()  # _load's sentinel: committed but bad, skipped

    def __init__(self, dirpath: str, rank: int, world: int, *, stale_limit: int = 0,
                 delta_dtype: str | None = None, journal=None, metrics=None,
                 orphan_age_s: float = 60.0):
        from distributed_tensorflow_tpu_torch.train import resilience

        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        if not 0 <= rank < world:
            raise ValueError(f"rank must be in [0, {world}), got {rank}")
        if stale_limit < 0:
            raise ValueError(f"stale_limit must be >= 0, got {stale_limit}")
        if delta_dtype not in (None, "int8", "fp8"):
            raise ValueError(f"delta_dtype must be None, 'int8', or 'fp8'; got {delta_dtype!r}")
        self.dirpath = str(dirpath)
        self.rank = int(rank)
        self.world = int(world)
        self.stale_limit = int(stale_limit)
        self.delta_dtype = delta_dtype
        self.journal = journal  # LMTrainer wires its own; None = the process's
        self.metrics = metrics
        self.orphan_age_s = float(orphan_age_s)
        self.corrupt_posts = 0
        self._consumed: dict[int, int] = {}  # per-peer consumed-round watermark
        os.makedirs(self.dirpath, exist_ok=True)
        resilience.sweep_tmp_orphans(self.dirpath, age_s=self.orphan_age_s)

    def _emit_corrupt(self, *, file: str, reason: str, peer: int, round_idx: int):
        self.corrupt_posts += 1
        if self.metrics is not None:
            self.metrics.counter("mailbox_corrupt_posts_total").inc()
        j = self.journal
        if j is None:
            from distributed_tensorflow_tpu_torch.observability import journal as obs_journal

            j = obs_journal.get_journal()
        j.emit("mailbox_corrupt", mailbox="delta", file=file, reason=reason, action="skipped",
               peer=int(peer), round=int(round_idx))

    def _fname(self, rank: int, round_idx: int) -> str:
        return f"w{rank:04d}_r{round_idx:010d}.npz"

    def _scan(self) -> dict[int, list[int]]:
        """One directory listing → ``{rank: sorted rounds}``."""
        out: dict[int, list[int]] = {}
        for name in os.listdir(self.dirpath):
            if not (name.startswith("w") and name.endswith(".npz")):
                continue
            try:
                rank = int(name[1:5])
                r = int(name[7:-4])
            except ValueError:
                continue
            out.setdefault(rank, []).append(r)
        for rounds in out.values():
            rounds.sort()
        return out

    def _rounds_of(self, rank: int) -> list[int]:
        return self._scan().get(rank, [])

    def payload_nbytes(self, round_idx: int) -> int | None:
        """On-disk size of this member's post of ``round_idx`` (None before
        it posts): the bytes a round puts on the wire."""
        try:
            return os.path.getsize(os.path.join(self.dirpath, self._fname(self.rank, round_idx)))
        except OSError:
            return None

    @staticmethod
    def _payload_crc(stored, scales) -> int:
        """CRC32C over the stored arrays' bytes in order, then the scales'."""
        from distributed_tensorflow_tpu_torch.train import resilience

        blob = b"".join(np.ascontiguousarray(x).tobytes() for x in stored)
        if scales is not None:
            blob += np.ascontiguousarray(scales).tobytes()
        return resilience._crc32c_bytes(blob)

    def post(self, round_idx: int, leaves) -> list:
        """Publish round ``round_idx``'s delta (numpy leaves in the dense
        parameter order); returns the dequantized leaves as peers read
        them."""
        from distributed_tensorflow_tpu_torch.train import failpoints, resilience

        failpoints.fire("delta.post")
        stored, scales, deq = _np_encode_delta(leaves, self.delta_dtype)
        payload = {f"a{i}": x for i, x in enumerate(stored)}
        payload["n"] = np.asarray(len(stored), np.int64)
        if scales is not None:
            payload["scales"] = scales
        payload["crc"] = np.asarray(self._payload_crc(stored, scales), np.int64)
        path = os.path.join(self.dirpath, self._fname(self.rank, round_idx))
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        failpoints.fire("delta.post.commit")
        os.replace(tmp, path)  # readers see all of it or nothing
        failpoints.tear("delta.post", path)
        # Own posts past the window (+1: a peer may be reading the oldest).
        floor = round_idx - self.stale_limit - 1
        for r in self._rounds_of(self.rank):
            if r < floor:
                try:
                    os.remove(os.path.join(self.dirpath, self._fname(self.rank, r)))
                except OSError:
                    pass
        resilience.sweep_tmp_orphans(self.dirpath, age_s=self.orphan_age_s)
        return deq

    def _load(self, rank: int, round_idx: int):
        """A peer post, read and checked: the decoded leaves, None for a
        transient read failure (retried at the next boundary, watermark
        kept), or ``_CORRUPT`` for a committed post that is bad (skipped
        for good, watermark advanced)."""
        import zipfile

        from distributed_tensorflow_tpu_torch.train import failpoints

        path = os.path.join(self.dirpath, self._fname(rank, round_idx))
        try:
            failpoints.fire("delta.load")
            with np.load(path) as z:
                n = int(z["n"])
                stored = [z[f"a{i}"] for i in range(n)]
                scales = z["scales"] if "scales" in z.files else None
                crc = int(z["crc"]) if "crc" in z.files else None
        except OSError:
            return None
        except (KeyError, ValueError, zipfile.BadZipFile, EOFError):
            return self._CORRUPT
        if crc is not None and crc != self._payload_crc(stored, scales):
            return self._CORRUPT
        return _np_decode_delta(stored, scales, self.delta_dtype)

    def gather(self, round_idx: int) -> list[tuple[int, int, float, list]]:
        """The peers' contributions at the boundary of ``round_idx``:
        ``[(rank, age, weight, leaves), ...]``, every post not consumed yet
        and inside the window, each once; the watermark advances (posts
        past the window are dropped for good). Own rank excluded."""
        posts = self._scan()
        out = []
        for rank in range(self.world):
            if rank == self.rank:
                continue
            floor = self._consumed.get(rank, -1)
            consumed = floor
            for r in posts.get(rank, []):
                if r <= floor:
                    continue
                if round_idx - r > self.stale_limit:
                    consumed = max(consumed, r)  # too old: dropped
                    continue
                leaves = self._load(rank, r)
                if leaves is None:
                    break  # transient: retried at the next boundary
                if leaves is self._CORRUPT:
                    consumed = max(consumed, r)
                    self._emit_corrupt(file=self._fname(rank, r), reason="crc", peer=rank,
                                       round_idx=r)
                    continue
                consumed = max(consumed, r)
                age = max(0, round_idx - r)
                out.append((rank, age, staleness_weight(age, self.stale_limit), leaves))
            if consumed > floor:
                self._consumed[rank] = consumed
        return out

    def weighted_delta(self, round_idx: int, own_leaves):
        """The round's outer pseudo-gradient: the staleness-weighted mean of
        its own delta (weight 1) and every admissible peer post. Returns
        ``(leaves, total_weight, contributors)``, contributors ``[(rank,
        age, weight), ...]`` own first; ``total_weight`` (1 + the peers'
        weights) is what ``outer_lr=None`` scales by."""
        own = [np.asarray(x, np.float32) for x in own_leaves]
        peers = self.gather(round_idx)
        total = 1.0 + sum(w for _, _, w, _ in peers)
        acc = [x.copy() for x in own]
        for _, _, w, leaves in peers:
            for a, b in zip(acc, leaves):
                a += w * b
        mean = [a / total for a in acc]
        contributors = [(self.rank, 0, 1.0)] + [(r, age, w) for r, age, w, _ in peers]
        return mean, total, contributors
