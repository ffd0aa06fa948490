"""Cluster and training configuration of the port: a copy of the JAX
package's ``ClusterConfig`` and the slice of its ``TrainConfig``
(``distributed_tensorflow_tpu/config.py``) that the MLP and GPT training
paths read, with the same defaults, so one configuration means the same
run in both packages.

``ClusterConfig`` keeps the reference's ``settings.py`` surface (two
host:port lists). ``worker_svrs`` entries are the ranks of one
``torch.distributed`` process group, entry 0 its rendezvous address and
the chief; ``ps_svrs`` is accepted and plays no role (parameters live on
the ranks, gradients and parameters meet by all-reduce).

``engine`` keeps the JAX values: ``"xla"`` is the generic path (plain
PyTorch ops and autograd here) and ``"pallas"`` the fused whole-epoch
kernel (the CUDA kernels of ``ops/fused_mlp.py`` here). ``model`` names a
family of ``models/__init__.MODEL_REGISTRY`` (``mlp``, ``cnn``, ``lstm``,
``transformer``); ``launch.build_trainer`` builds it.

A JAX field the port does not have yet is refused, whatever its value,
naming the ROADMAP item that brings it (none is left); so would be a value
of ``dp_mode`` that a later item brings (none is left). ``logs_path`` (the
tfevents summaries, written by the chief's ``SummaryWriter``; empty turns
them off) and ``profile_dir`` (a ``torch.profiler`` trace of the first
epoch) keep the JAX defaults. The checkpoint and recovery fields
(``checkpoint_dir``, ``keep_last_n``, ``checkpoint_retries``,
``checkpoint_retry_backoff``, ``async_checkpoint``, ``handle_preemption``,
``max_rollbacks``, ``anomaly_window``, ``spike_threshold``,
``epochs_per_dispatch``; ``train/supervisor.py``, ``train/resilience.py``)
and the DiLoCo mailbox gang's ``stale_limit`` (``local_sgd.DeltaExchange``)
carry the JAX defaults and validation.
The DiLoCo outer loop's fields (``sync_every``, ``outer_lr``,
``outer_momentum``, ``diloco_workers``, ``delta_dtype``,
``delta_overlap``) carry the JAX defaults and validation
(``train/local_sgd.py``).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Sequence

# JAX TrainConfig field -> the ROADMAP item that ports it.
NOT_PORTED: dict = {}
# Values of dp_mode that a later item brings (LM-trainer modes) -> its item.
DP_MODES_NOT_PORTED: dict = {}


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Topology of a training job (the JAX ``ClusterConfig``).

    ``worker_svrs`` host:port entries map 1:1 to ranks; entry 0 is the
    rendezvous (``tcp://<entry 0>``) and the chief, as the reference's
    ``is_chief=(task_index==0)``. ``ps_svrs`` is kept for drop-in
    compatibility with the reference's ``settings.py``. The heartbeat
    detector (``heartbeat_port`` / ``heartbeat_host``) is ROADMAP A8c and
    refused when set. ``connect_timeout_s`` / ``connect_attempts`` bound
    ``cluster.bounded_initialize``."""

    worker_svrs: tuple[str, ...] = ()
    ps_svrs: tuple[str, ...] = ()
    heartbeat_port: int | None = None
    heartbeat_timeout_ms: int = 10_000
    heartbeat_host: str | None = None
    connect_timeout_s: int = 300
    connect_attempts: int = 3

    def __post_init__(self):
        for name in ("heartbeat_port", "heartbeat_host"):
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"ClusterConfig.{name}: the heartbeat detector is not ported yet (ROADMAP A8c)"
                )

    @property
    def num_processes(self) -> int:
        return max(1, len(self.worker_svrs))

    @property
    def coordinator_address(self) -> str | None:
        return self.worker_svrs[0] if self.worker_svrs else None

    def is_chief(self, task_index: int) -> bool:
        return task_index == 0

    @classmethod
    def from_settings_module(cls, module: Any | str = "settings") -> "ClusterConfig":
        """Load a reference-style ``settings.py``."""
        if isinstance(module, str):
            module = importlib.import_module(module)
        return cls(
            worker_svrs=tuple(getattr(module, "worker_svrs", ())),
            ps_svrs=tuple(getattr(module, "ps_svrs", ())),
        )

    @classmethod
    def from_lists(
        cls, worker_svrs: Sequence[str], ps_svrs: Sequence[str] = ()
    ) -> "ClusterConfig":
        return cls(worker_svrs=tuple(worker_svrs), ps_svrs=tuple(ps_svrs))

    def subset(self, ranks: Sequence[int]) -> "ClusterConfig":
        """The sub-cluster served by original ranks ``ranks`` (new rank
        ``r`` is original rank ``ranks[r]``; ``ranks[0]``'s address becomes
        the rendezvous)."""
        ranks = tuple(int(r) for r in ranks)
        if not ranks:
            raise ValueError("subset needs at least one rank")
        if len(set(ranks)) != len(ranks):
            raise ValueError(f"subset ranks must be unique, got {ranks}")
        bad = [r for r in ranks if not 0 <= r < len(self.worker_svrs)]
        if bad:
            raise ValueError(
                f"subset ranks {bad} out of range for "
                f"{len(self.worker_svrs)} worker_svrs entries"
            )
        return dataclasses.replace(
            self, worker_svrs=tuple(self.worker_svrs[r] for r in ranks)
        )


@dataclasses.dataclass(frozen=True)
class _TrainFields:
    """Hyperparameters. Defaults reproduce the reference (and the JAX
    package's defaults)."""

    batch_size: int = 100
    learning_rate: float = 0.001
    epochs: int = 100
    log_frequency: int = 100  # print every N batches
    logs_path: str = "./logs"  # reference logs_path, tfdist_between.py:22
    seed: int = 1
    compute_dtype: str = "bfloat16"  # operand dtype of the model's products
    optimizer: str = "sgd"  # sgd | momentum | adam | adamw (ops/optim.make)
    lr_schedule: str | None = None  # None/constant | cosine | linear | exponential
    warmup_steps: int = 0  # linear lr ramp before the schedule
    # Average grads over N micro-steps, apply once (ops/optim.accumulate).
    # The trainers' global step counts micro-steps, not applies.
    accumulate_steps: int = 1
    # Global-norm gradient clipping (ops/optim.clip); 0 disables.
    grad_clip_norm: float = 0.0
    # "naive" = the reference's CE over probabilities; "stable" = log-softmax.
    loss: str = "naive"
    # One device loop per epoch over staged batches (train/scan.py). None
    # resolves by device: True on cuda, False on the CPU. The MLP Trainer
    # reads it; the LM trainer has one loop and ignores it.
    scan_epoch: bool | None = None
    # Every epoch, shuffle and eval in one call (train/compiled_run.py).
    compiled_run: bool = False
    # compiled_run engine: "xla" (PyTorch ops) | "pallas" (CUDA kernels).
    engine: str = "xla"
    param_dtype: str = "float32"
    # Model family from the registry (models/__init__.py): mlp (the
    # reference's) | cnn | lstm | transformer.
    model: str = "mlp"
    # Data parallelism (parallel/strategy.py): sync (gradient all-reduce)
    # or async (per-rank copies, parameters averaged every
    # async_avg_every steps; 0 = never).
    sync: bool = True
    async_avg_every: int = 0
    # Local SGD / DiLoCo (train/local_sgd.py; the LM trainer's
    # dp_mode="diloco"): each worker runs sync_every = H inner steps, then
    # the gang applies one outer Nesterov update from Δ = θ_start −
    # mean_w(θ_w). outer_lr None = N (the worker count, async's
    # update_scale=N convention); outer_momentum 0 keeps that step
    # uncompounded; sync_every=1, outer_lr=1, outer_momentum=0 is the
    # per-step parameter mean.
    sync_every: int = 1
    outer_lr: float | None = None
    outer_momentum: float = 0.0
    # dp_mode="diloco" without a mesh: the same gang of this many workers
    # emulated on one device (0 = diloco needs a mesh).
    diloco_workers: int = 0
    # The outer delta quantized per tensor before the exchange (None |
    # "int8" | "fp8"), its error carried into the next round.
    delta_dtype: str | None = None
    # The outer update applied one round late (streaming DiLoCo), the
    # copies merged toward the anchor (local_sgd.OVERLAP_MERGE).
    delta_overlap: bool = False
    # Sync parameter layout: "replicated" or "zero" (ZeRO-3,
    # parallel/fsdp.py; the LM trainer's over models/gpt.make_lm_zero_parts).
    # The LM trainer also takes "sp" (sequence parallelism over a mesh's
    # seq axis), "tp" (tensor parallelism over its model axis), "ep"
    # (expert parallelism over its expert axis), "pp" (the GPipe pipeline
    # over its stage axis) and "diloco" (the local-SGD outer loop).
    dp_mode: str = "replicated"
    # Keep N device-placed batches in flight in the eager loop
    # (data/prefetch.py); 0 disables.
    prefetch: int = 0
    # Print each parameter's placement at startup on the chief
    # (utils/placement.py).
    log_placement: bool = False
    # Epoch definition: False = one pass over the data globally (N ranks
    # split the batches); True = the reference's, each worker runs
    # num_examples // batch_size steps an epoch.
    per_worker_epoch: bool = False
    # Checkpoint every GPT block in the LM trainer's forward (recomputed in
    # the backward). "selective" saves the flash kernel's out and lse, so
    # only the layernorm/QKV/MLP half of a block replays (models/gpt.py).
    # The MLP Trainer takes any truthy value as plain remat of the model's
    # apply (launch.build_trainer).
    remat: bool | str = False
    # Low-precision projection products of the LM family (GPTLM(matmul_dtype=),
    # ops/quantized.quantized_dot): None | "int8" | "fp8". The classifier
    # path refuses it (launch.build_trainer).
    matmul_dtype: str | None = None
    # A torch.profiler trace of epoch 0 into this directory (utils/profiler.py;
    # the card's kernels too on a CUDA device).
    profile_dir: str | None = None
    # -- checkpoints and recovery (train/supervisor.py, train/resilience.py)
    # Save a checkpoint each epoch (each dispatch) into this directory, and
    # restore the newest valid one at construction.
    checkpoint_dir: str | None = None
    # Keep the newest N step_N checkpoints (the newest valid one is never
    # removed); None/0 keeps everything.
    keep_last_n: int | None = None
    # Bounded retry with exponential backoff around checkpoint I/O.
    checkpoint_retries: int = 3
    checkpoint_retry_backoff: float = 0.25
    # The save boundary pays the host snapshot only; a depth-1 background
    # writer commits the same files the synchronous path writes.
    async_checkpoint: bool = True
    # run() turns SIGTERM/SIGINT into a stop at the next boundary with a
    # final save (with a supervisor, on the main thread).
    handle_preemption: bool = True
    # Anomaly rollback: on a NaN/inf epoch cost, or one past spike_threshold
    # x the median of the last anomaly_window good epochs, restore the
    # newest valid checkpoint and go on with the next data window, at most
    # max_rollbacks times a run (0 disables; spike_threshold=0 keeps the
    # NaN/inf check only).
    max_rollbacks: int = 0
    anomaly_window: int = 8
    spike_threshold: float = 3.0
    # Dispatch the whole-run program k epochs at a time (a checkpoint, the
    # epoch lines and the stop check after each dispatch); None/0 = off.
    epochs_per_dispatch: int | None = None
    # The DiLoCo mailbox gang (local_sgd.DeltaExchange): peer deltas up to
    # this many outer rounds old are applied, weighted 1/(1 + age).
    stale_limit: int = 0

    def __post_init__(self):
        if self.epochs_per_dispatch is not None and self.epochs_per_dispatch < 0:
            raise ValueError(
                "epochs_per_dispatch must be >= 1 (or None/0 to disable), "
                f"got {self.epochs_per_dispatch}"
            )
        if self.max_rollbacks < 0:
            raise ValueError(f"max_rollbacks must be >= 0 (0 disables), got {self.max_rollbacks}")
        if self.keep_last_n is not None and self.keep_last_n < 0:
            raise ValueError(
                f"keep_last_n must be >= 1 (or None/0 to keep everything), got {self.keep_last_n}"
            )
        if self.anomaly_window < 1:
            raise ValueError(f"anomaly_window must be >= 1, got {self.anomaly_window}")
        if self.stale_limit < 0:
            raise ValueError(
                f"stale_limit must be >= 0 (0 = same-round deltas only), got {self.stale_limit}"
            )
        if self.dp_mode in DP_MODES_NOT_PORTED:
            raise NotImplementedError(
                f"TrainConfig.dp_mode={self.dp_mode!r} is not ported yet "
                f"(ROADMAP {DP_MODES_NOT_PORTED[self.dp_mode]})"
            )
        if not (isinstance(self.remat, bool) or self.remat == "selective"):
            raise ValueError(
                f"remat must be False, True, or 'selective'; got {self.remat!r} "
                "(callable policies go directly on the model: GPTLM(remat=policy))"
            )
        if self.matmul_dtype not in (None, "int8", "fp8"):
            raise ValueError(
                f"matmul_dtype must be None, 'int8', or 'fp8'; got {self.matmul_dtype!r}"
            )
        if self.engine not in ("xla", "pallas"):
            raise ValueError(f"unknown engine {self.engine!r} (xla|pallas)")
        if self.loss not in ("naive", "stable"):
            raise ValueError(f"unknown loss {self.loss!r}; use 'naive' or 'stable'")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"compute_dtype must be 'bfloat16' or 'float32', got {self.compute_dtype!r}"
            )
        if self.sync_every < 1:
            raise ValueError(
                f"sync_every must be >= 1 (1 = exchange every step), got {self.sync_every}"
            )
        if self.outer_lr is not None and not self.outer_lr > 0:
            raise ValueError(
                f"outer_lr must be > 0 (or None for the worker-count default), "
                f"got {self.outer_lr}"
            )
        if not 0 <= self.outer_momentum < 1:
            raise ValueError(f"outer_momentum must be in [0, 1), got {self.outer_momentum}")
        if self.diloco_workers < 0:
            raise ValueError(
                f"diloco_workers must be >= 0 (0 = diloco needs a mesh), "
                f"got {self.diloco_workers}"
            )
        if self.delta_dtype not in (None, "int8", "fp8"):
            raise ValueError(
                f"delta_dtype must be None, 'int8', or 'fp8'; got {self.delta_dtype!r}"
            )
        if (self.delta_dtype or self.delta_overlap or self.stale_limit) and self.dp_mode != "diloco":
            raise ValueError(
                "delta_dtype/delta_overlap/stale_limit are diloco outer-loop levers "
                "(train/local_sgd.py) and would be silently ignored under "
                f"dp_mode={self.dp_mode!r}; set dp_mode='diloco'"
            )


class TrainConfig(_TrainFields):
    __doc__ = _TrainFields.__doc__

    def __init__(self, *args, **kw):
        # A JAX-only field is refused with its ROADMAP item before the
        # dataclass sees it as unknown.
        for name in kw:
            if name in NOT_PORTED:
                raise NotImplementedError(
                    f"TrainConfig.{name} is not ported yet (ROADMAP {NOT_PORTED[name]})"
                )
        super().__init__(*args, **kw)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
