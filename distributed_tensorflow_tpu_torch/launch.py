"""Launcher of the port: config → model + strategy + trainer.

Counterpart of ``distributed_tensorflow_tpu/launch.py``:

- ``sync=True`` → :class:`SyncDataParallel` (``dp_mode="zero"``:
  :class:`ShardedDataParallel`), or :class:`SingleDevice` in a world of
  one rank — the ``tfdist_between_sync.py`` path;
- ``sync=False`` → :class:`AsyncDataParallel` with
  ``avg_every=async_avg_every`` — the ``tfdist_between.py`` path;
- :func:`run` is the end-to-end entry of a task: ``--job_name`` /
  ``--task_index``, the bootstrap (``cluster.py``), the trainer.

    python -m distributed_tensorflow_tpu_torch.launch

is the port's ``examples/single.py``: it trains the 784→100→10 MLP with
SGD lr=0.001, batch 100, for 100 epochs on the card, printing the
reference's log lines (the ``DTF_*`` environment overrides below apply:
``DTF_MODEL=cnn`` trains the CNN, and so on for ``lstm`` and
``transformer``).
The data-parallel examples are ``examples/between_sync.py`` and
``examples/between_async.py``, started a task each by
``tools/launch_local.py``.
"""

from __future__ import annotations

import os

import torch

from distributed_tensorflow_tpu_torch.config import ClusterConfig, TrainConfig

# Environment knobs of the JAX launcher that the port does not have yet ->
# the ROADMAP item that brings them: the elastic gang (A8c).
NOT_PORTED_ENV = {
    "DTF_MAX_RESTARTS": "A8c", "DTF_STALL_TIMEOUT_MS": "A8c", "DTF_MIN_WORKERS": "A8c",
    "DTF_REJOIN_TIMEOUT_S": "A8c",
}


def config_from_env(base: TrainConfig | None = None) -> TrainConfig:
    """Apply environment overrides to a TrainConfig: DTF_MODEL (a registry
    name: ``mlp``, ``cnn``, ``lstm``, ``transformer``), DTF_EPOCHS,
    DTF_BATCH_SIZE, DTF_LR, DTF_SCAN (=1 → scan_epoch), DTF_COMPILED (=1 →
    compiled_run), DTF_LOGS (the tfevents directory, ``logs_path``; empty
    turns the summaries off), DTF_REMAT (empty/0/1 → False/True, else the value, e.g.
    "selective"), DTF_MATMUL_DTYPE (empty → None, else "int8" | "fp8"), and
    the DiLoCo outer loop's DTF_SYNC_EVERY, DTF_OUTER_LR (empty → None, the
    worker-count default), DTF_OUTER_MOMENTUM, DTF_DELTA_DTYPE (empty →
    None, else "int8" | "fp8") and DTF_STALE_LIMIT (the mailbox gang's
    window in outer rounds), and the resilience knobs: DTF_CHECKPOINT (the
    checkpoint directory, empty → None: what a scheduler sets so that a
    preempted run resumes), DTF_KEEP_LAST (retention, 0 → None) and
    DTF_MAX_ROLLBACKS (the anomaly guard's budget), as the JAX launcher
    reads them. The JAX launcher's other knobs (the elastic gang's) raise
    naming the ROADMAP item that brings them, unless empty; invalid values
    raise ValueError naming the knob."""

    def _parse(var: str, conv):
        try:
            return conv(os.environ[var])
        except ValueError as exc:
            raise ValueError(f"invalid {var}={os.environ[var]!r}: {exc}") from None

    for var, item in NOT_PORTED_ENV.items():
        if os.environ.get(var):
            raise NotImplementedError(f"{var} is not ported yet (ROADMAP {item})")
    cfg = base or TrainConfig()
    kw = {}
    if "DTF_CHECKPOINT" in os.environ:
        kw["checkpoint_dir"] = os.environ["DTF_CHECKPOINT"] or None
    if "DTF_KEEP_LAST" in os.environ:
        kw["keep_last_n"] = _parse("DTF_KEEP_LAST", int) or None
    if "DTF_MAX_ROLLBACKS" in os.environ:
        kw["max_rollbacks"] = _parse("DTF_MAX_ROLLBACKS", int)
    if "DTF_MODEL" in os.environ:
        kw["model"] = os.environ["DTF_MODEL"]
    if "DTF_EPOCHS" in os.environ:
        kw["epochs"] = _parse("DTF_EPOCHS", int)
    if "DTF_BATCH_SIZE" in os.environ:
        kw["batch_size"] = _parse("DTF_BATCH_SIZE", int)
    if "DTF_LR" in os.environ:
        kw["learning_rate"] = _parse("DTF_LR", float)
    if "DTF_SCAN" in os.environ:
        kw["scan_epoch"] = os.environ["DTF_SCAN"] == "1"
    if "DTF_COMPILED" in os.environ:
        kw["compiled_run"] = os.environ["DTF_COMPILED"] == "1"
    if "DTF_LOGS" in os.environ:
        kw["logs_path"] = os.environ["DTF_LOGS"]
    if "DTF_REMAT" in os.environ:
        raw = os.environ["DTF_REMAT"]
        # Anything but empty/0/1/"selective" fails in TrainConfig.
        kw["remat"] = raw == "1" if raw in ("", "0", "1") else raw
    if "DTF_MATMUL_DTYPE" in os.environ:
        # Bad names fail in TrainConfig.
        kw["matmul_dtype"] = os.environ["DTF_MATMUL_DTYPE"] or None
    if "DTF_SYNC_EVERY" in os.environ:
        kw["sync_every"] = _parse("DTF_SYNC_EVERY", int)
    if "DTF_OUTER_LR" in os.environ:
        raw = os.environ["DTF_OUTER_LR"]
        kw["outer_lr"] = _parse("DTF_OUTER_LR", float) if raw else None
    if "DTF_OUTER_MOMENTUM" in os.environ:
        kw["outer_momentum"] = _parse("DTF_OUTER_MOMENTUM", float)
    if "DTF_DELTA_DTYPE" in os.environ:
        # Bad names, and a lever on a job that is not diloco, fail in TrainConfig.
        kw["delta_dtype"] = os.environ["DTF_DELTA_DTYPE"] or None
    if "DTF_STALE_LIMIT" in os.environ:
        kw["stale_limit"] = _parse("DTF_STALE_LIMIT", int)
    return cfg.replace(**kw) if kw else cfg


def parse_worker_ranks(raw: str) -> tuple[int, ...]:
    """Parse a ``DTF_WORKER_RANKS`` value (comma-separated ORIGINAL ranks
    in new-rank order)."""
    try:
        return tuple(int(r) for r in raw.split(","))
    except ValueError:
        raise ValueError(
            f"invalid DTF_WORKER_RANKS={raw!r}: must be comma-separated "
            "integers (original ranks in new-rank order)"
        ) from None


def cluster_from_env(base: ClusterConfig | None = None) -> ClusterConfig:
    """Apply environment overrides to a ClusterConfig, as the JAX launcher
    reads them: DTF_HEARTBEAT_PORT (empty/0 disables; any other value is
    the heartbeat detector, ROADMAP A8c, and raises), DTF_HEARTBEAT_TIMEOUT_MS,
    DTF_HEARTBEAT_HOST (A8c), and the sub-cluster a relaunch serves:
    DTF_WORKER_RANKS (original ranks in new-rank order,
    ``ClusterConfig.subset``) and DTF_WORLD_SIZE (the first N, or a
    cross-check of the ranks' count). Invalid values raise ValueError
    naming the knob."""
    import dataclasses

    def _parse(var: str, conv):
        try:
            return conv(os.environ[var])
        except ValueError as exc:
            raise ValueError(f"invalid {var}={os.environ[var]!r}: {exc}") from None

    cluster = base or ClusterConfig()
    kw = {}
    if "DTF_HEARTBEAT_PORT" in os.environ:
        raw = os.environ["DTF_HEARTBEAT_PORT"]
        kw["heartbeat_port"] = _parse("DTF_HEARTBEAT_PORT", int) if raw else None
        if kw["heartbeat_port"] == 0:
            kw["heartbeat_port"] = None
    if "DTF_HEARTBEAT_TIMEOUT_MS" in os.environ:
        kw["heartbeat_timeout_ms"] = _parse("DTF_HEARTBEAT_TIMEOUT_MS", int)
    if "DTF_HEARTBEAT_HOST" in os.environ:
        kw["heartbeat_host"] = os.environ["DTF_HEARTBEAT_HOST"] or None
    cluster = dataclasses.replace(cluster, **kw) if kw else cluster

    ranks = None
    if os.environ.get("DTF_WORKER_RANKS"):
        ranks = parse_worker_ranks(os.environ["DTF_WORKER_RANKS"])
    if os.environ.get("DTF_WORLD_SIZE"):
        raw = os.environ["DTF_WORLD_SIZE"]
        try:
            world = int(raw)
        except ValueError:
            raise ValueError(f"invalid DTF_WORLD_SIZE={raw!r}: must be an integer") from None
        if world < 1:
            raise ValueError(f"invalid DTF_WORLD_SIZE={world}: must be >= 1")
        if ranks is None:
            ranks = tuple(range(world))
        elif len(ranks) != world:
            raise ValueError(
                f"DTF_WORLD_SIZE={world} contradicts DTF_WORKER_RANKS="
                f"{ranks} (length {len(ranks)})"
            )
    if ranks is not None:
        if not cluster.worker_svrs:
            raise ValueError(
                "DTF_WORLD_SIZE/DTF_WORKER_RANKS set but the base "
                "ClusterConfig lists no worker_svrs to select from"
            )
        cluster = cluster.subset(ranks)
    return cluster


def build_strategy(config: TrainConfig, *, mesh=None, device=None):
    """The strategy ``config`` asks for over ``mesh`` (default: the
    initialized process group's ``make_mesh()``, or one rank on
    ``device``). A mesh of one rank that the caller did not pass gives
    :class:`SingleDevice`, as the JAX launcher does for one device."""
    if config.dp_mode not in ("replicated", "zero"):
        raise ValueError(
            f"unknown dp_mode {config.dp_mode!r} for the classifier path; "
            "use 'replicated' or 'zero' ('tp'/'ep'/'pp' are LM-trainer "
            "modes — train/lm_trainer.py)"
        )
    if config.dp_mode == "zero" and not config.sync:
        raise ValueError("dp_mode='zero' requires sync=True (async keeps per-chip copies)")
    from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh
    from distributed_tensorflow_tpu_torch.parallel.strategy import (
        AsyncDataParallel,
        SingleDevice,
        SyncDataParallel,
    )

    if mesh is None:
        mesh = make_mesh(device=device)
        if mesh.size == 1:
            return SingleDevice(mesh.device)
    if config.sync:
        if config.dp_mode == "zero":
            from distributed_tensorflow_tpu_torch.parallel.fsdp import ShardedDataParallel

            return ShardedDataParallel(mesh)
        return SyncDataParallel(mesh)
    return AsyncDataParallel(mesh, avg_every=config.async_avg_every)


class _RematAdapter:
    """Checkpoints the model's ``apply`` (and ``apply_logits``): the
    activations are recomputed in the backward instead of kept, the
    gradients unchanged (the JAX ``_RematAdapter``, ``jax.checkpoint``
    there, ``torch.utils.checkpoint`` here). Any family: with the
    transformer's flash attention the recompute runs the flash forward
    (``dtf::FlashAttention``) again."""

    def __init__(self, model):
        self._model = model
        if hasattr(model, "apply_logits"):
            self.apply_logits = self._checkpointed(model.apply_logits)

    @staticmethod
    def _checkpointed(fn):
        from torch.utils.checkpoint import checkpoint

        def run(params, x, **kw):  # kw: the tensor-parallel axis (tp=)
            leaves = tuple(params)
            return checkpoint(lambda x, *ps: fn(type(params)(*ps), x, **kw), x, *leaves,
                              use_reentrant=False)

        return run

    def __getattr__(self, name):
        return getattr(self._model, name)

    def apply(self, params, x, **kw):
        return self._checkpointed(self._model.apply)(params, x, **kw)


class _LogitsAdapter:
    """Presents ``apply_logits`` as ``apply`` so the logits-based stable
    loss composes with the strategy (accuracy's argmax is unchanged)."""

    def __init__(self, model):
        self._model = model

    def __getattr__(self, name):
        return getattr(self._model, name)

    def apply(self, params, x, **kw):
        return self._model.apply_logits(params, x, **kw)


def build_trainer(
    config: TrainConfig | None = None,
    *,
    context=None,
    model=None,
    datasets=None,
    strategy=None,
    optimizer=None,
    loss_fn=None,
    data_dir: str = "MNIST_data",
    print_fn=print,
    device=None,
    summary_writer=None,
):
    """The Trainer for ``config``: the strategy (:func:`build_strategy`),
    the registry's ``config.model`` in the config's compute dtype (unless
    ``model`` is given; checkpointed when ``config.remat`` is truthy, where
    "selective" is plain remat: the classifiers carry no operator for a
    selective policy to save), the MNIST loader (synthetic when
    ``data_dir`` holds no IDX files), the configured optimizer,
    ``accumulate(clip(make(name, schedule)))`` as the JAX launcher composes
    it, and the loss. ``context`` (``cluster.bootstrap``) says whether this
    process is the chief. On the chief, unless ``summary_writer`` is given,
    a ``utils/summary.SummaryWriter`` writes the run's tfevents into
    ``config.logs_path`` (none when it is empty). ``device`` defaults to
    cuda (this rank's card) and raises without one."""
    from distributed_tensorflow_tpu_torch.data.mnist import read_data_sets
    from distributed_tensorflow_tpu_torch.models import build_model
    from distributed_tensorflow_tpu_torch.ops import losses as losses_lib
    from distributed_tensorflow_tpu_torch.ops import optim as optim_lib
    from distributed_tensorflow_tpu_torch.train.trainer import Trainer

    config = config or TrainConfig()
    if config.matmul_dtype:
        raise ValueError(
            "matmul_dtype is an LM-family knob (models/gpt.GPTLM / LMTrainer); the "
            "classifier models have no quantized path"
        )
    is_chief = context.is_chief if context is not None else True
    if model is None:
        model = build_model(config.model, compute_dtype=getattr(torch, config.compute_dtype))
    if config.remat:
        model = _RematAdapter(model)
    datasets = datasets or read_data_sets(data_dir, one_hot=True)
    strategy = strategy or build_strategy(config, device=device)
    if optimizer is None:
        # The schedule counts optimizer applies: an epoch's steps
        # (num_examples // (batch_size × replicas), or // batch_size under
        # per_worker_epoch), once every accumulate_steps of them.
        denom = config.batch_size * (1 if config.per_worker_epoch else strategy.num_replicas)
        applies_per_epoch = max(1, datasets.train.num_examples // denom)
        total_applies = max(1, config.epochs * applies_per_epoch // config.accumulate_steps)
        lr = optim_lib.schedule(config.lr_schedule, config.learning_rate, total_applies,
                                warmup_steps=config.warmup_steps)
        optimizer = optim_lib.accumulate(
            optim_lib.clip(optim_lib.make(config.optimizer, lr), config.grad_clip_norm),
            config.accumulate_steps,
        )
    if loss_fn is None:
        if config.loss == "stable":
            if not hasattr(model, "apply_logits"):
                raise ValueError(f"loss='stable' needs apply_logits on {type(model).__name__}")
            model = _LogitsAdapter(model)
            loss_fn = losses_lib.stable_cross_entropy
        else:
            loss_fn = losses_lib.cross_entropy
    if summary_writer is None and is_chief and config.logs_path:
        from distributed_tensorflow_tpu_torch.utils.summary import SummaryWriter

        summary_writer = SummaryWriter(config.logs_path)
    return Trainer(
        model, datasets, config, strategy=strategy, optimizer=optimizer,
        loss_fn=loss_fn, is_chief=is_chief, print_fn=print_fn,
        summary_writer=summary_writer,
    )


def run(
    cluster: ClusterConfig | None = None,
    config: TrainConfig | None = None,
    argv=None,
    **kw,
) -> dict | None:
    """End-to-end entry of a task: parse ``--job_name`` / ``--task_index``,
    bootstrap (joining the process group), train. Returns the final
    metrics dict, or None for a ps task. ``kw`` goes to
    :func:`build_trainer` (``device="cpu"`` runs the ranks on the CPU over
    gloo)."""
    from distributed_tensorflow_tpu_torch.cluster import bootstrap_from_argv

    cluster = cluster_from_env(cluster or ClusterConfig())
    ctx = bootstrap_from_argv(cluster, argv, device=kw.get("device"))
    if ctx.should_exit:
        return None
    try:
        trainer = build_trainer(config_from_env(config), context=ctx, **kw)
        print("Ready to go")  # reference tfdist_between.py:76
        return trainer.run()
    finally:
        ctx.close()


if __name__ == "__main__":
    build_trainer(config_from_env(TrainConfig())).run()
