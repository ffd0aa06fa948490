"""The classifier training loop of the port (the MLP, CNN, LSTM and
transformer families alike).

Counterpart of ``distributed_tensorflow_tpu/train/trainer.py`` ``Trainer``,
strategy-agnostic (``parallel/strategy.py``). It keeps the reference loop's
contract: ``epochs`` × ``num_train_examples // global_batch`` steps (or
``// batch_size`` a worker under ``per_worker_epoch``), the global batch
being ``batch_size × num_replicas``; the Step/Epoch/Batch/Cost/AvgTime line
every ``log_frequency`` batches; the full test-set accuracy and wall time
per epoch and a final-cost line, printed by the chief only (every rank
evaluates: under async and ZeRO the eval is a collective). Under async
with ``avg_every`` the copies are exchanged after step ``i`` when ``(i +
1) % avg_every == 0``, on every path. Three paths:

- the eager per-batch loop (``run_epoch``), the default on the CPU;
- the indexed scanned epoch (``_run_epoch_scanned``): the training arrays
  staged on the device once, one device loop per epoch over a host
  permutation, costs fetched once per epoch; the default on ``cuda``, as
  ``scan_epoch=None`` resolves on an accelerator in the JAX package;
- the whole run (``run_compiled``, ``TrainConfig.compiled_run``) with
  ``engine="xla"`` (PyTorch ops and autograd) or ``engine="pallas"`` (the
  CUDA whole-epoch kernel of ``ops/fused_mlp.py``, one launch per epoch).

Every path but the kernel's takes any optimizer of ``ops/optim.py``
(momentum, Adam, AdamW, schedules, clipping, accumulation) and carries its
state in ``TrainState.opt_state``; ``engine="pallas"`` refuses them, with
the JAX package's wording and probes, before any launch.

Telemetry, as the JAX trainer wires it (JAX :52-74): every line is rendered
from a ``step`` / ``epoch`` / ``final`` event of ``journal`` (default the
process's, ``observability/journal.py``); ``metrics`` gets the
``step_time_ms`` histogram (an epoch's mean) and ``epochs_total`` and is
flushed into the journal at the end with the journal itself; a
``SpanRecorder`` on the journal records each device loop's dispatch up to
its one fetch; ``run`` and ``run_compiled`` sit in one ambient trace id.
On the chief, ``summary_writer`` (``utils/summary.SummaryWriter``) takes
the step's graph once (:meth:`Trainer.write_graph`), a ``cost`` scalar at
each logged step and ``accuracy`` each epoch: the values the lines print,
already on the host (the JAX trainer writes every step's cost). With
``TrainConfig.profile_dir``, :meth:`Trainer.run` profiles its first epoch
(``utils/profiler.py``).

Checkpoints and recovery, as the JAX trainer wires them (JAX :99-160,
:255-300, :558-812, :961-1045): with ``TrainConfig.checkpoint_dir`` (or a
``supervisor=``) the trainer restores the newest valid checkpoint at
construction, across strategies through the layout sidecar and the
canonical form (an async checkpoint's copies merged at their mean, the
global batch of a resized world kept), saves each epoch (each dispatch) in
JAX's layout (the dense canonical state, or async's copies stacked
``[n, ...]``: every rank gathers, the chief writes), reports progress, stops
at a boundary when asked, and runs ``run()`` under the preemption guard.
``TrainConfig.max_rollbacks`` arms the anomaly rollback (``Rollback:``
lines); ``epochs_per_dispatch`` runs the whole-run program a chunk of
epochs a dispatch (:meth:`Trainer.run_compiled` with ``epoch_offset`` and
``finalize``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.config import TrainConfig
from distributed_tensorflow_tpu_torch.observability import journal as obs_journal
from distributed_tensorflow_tpu_torch.observability import tracing
from distributed_tensorflow_tpu_torch.observability.metrics import TIME_MS_EDGES, MetricsRegistry
from distributed_tensorflow_tpu_torch.observability.spans import SpanRecorder
from distributed_tensorflow_tpu_torch.ops import losses as losses_lib
from distributed_tensorflow_tpu_torch.ops import optim as optim_lib
from distributed_tensorflow_tpu_torch.ops.optim import tree_map
from distributed_tensorflow_tpu_torch.parallel.strategy import (
    AsyncDataParallel,
    SingleDevice,
    Strategy,
    TrainState,
    merge_stacked_leaf,
)
from distributed_tensorflow_tpu_torch.train.resilience import (
    AnomalyError,
    AnomalyGuard,
    arm_stall_dump,
    preemption_guard,
)
from distributed_tensorflow_tpu_torch.train.supervisor import (
    Supervisor,
    checkpoint_steps,
    layout_shape,
)
from distributed_tensorflow_tpu_torch.utils.logging import StepLogger
from distributed_tensorflow_tpu_torch.utils.summary import lifecycle_event

# JAX Trainer keyword -> (values that switch it off, ROADMAP item).
NOT_PORTED: dict = {}



class Trainer:
    def __init__(
        self,
        model,
        datasets,
        config: TrainConfig | None = None,
        *,
        strategy: Strategy | None = None,
        loss_fn=None,
        optimizer=None,
        summary_writer=None,
        supervisor: Supervisor | None = None,
        is_chief: bool = True,
        print_fn=print,
        device=None,
        journal=None,
        metrics: MetricsRegistry | None = None,
        **not_ported,
    ):
        for name, value in not_ported.items():
            if name not in NOT_PORTED:
                raise TypeError(f"Trainer() got an unexpected keyword argument {name!r}")
            off, item = NOT_PORTED[name]
            if value not in off:
                raise NotImplementedError(
                    f"Trainer({name}=...) is not ported yet (ROADMAP {item})"
                )
        self.model = model
        self.datasets = datasets
        self.config = config or TrainConfig()
        if strategy is None:
            strategy = SingleDevice(device)
        elif device is not None and strategy.device != torch.device(device):
            raise ValueError(f"device={device!r} but the strategy is on {strategy.device}")
        self.strategy = strategy
        self.device = strategy.device
        self.loss_fn = loss_fn or losses_lib.cross_entropy
        self.optimizer = optimizer or optim_lib.sgd(self.config.learning_rate)
        self.summary_writer = summary_writer
        self.is_chief = is_chief
        self.print_fn = print_fn
        self.journal = journal if journal is not None else obs_journal.get_journal()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.spans = SpanRecorder(journal=self.journal)
        self._graph_written = False

        self.state = self.strategy.init_state(self.model, self.optimizer, self.config.seed)
        self.train_step = self.strategy.make_train_step(self.model, self.loss_fn, self.optimizer)
        self.eval_fn = self.strategy.make_eval_fn(self.model)
        self._exchange = None
        if isinstance(self.strategy, AsyncDataParallel) and self.strategy.avg_every:
            self._exchange = self.strategy.make_exchange_fn()
        # The reference gave each of N workers a batch of batch_size, so N
        # replicas consume N × batch_size a step; a restore across a world
        # size change keeps the checkpoint's (_adopt_batch_policy).
        self.global_batch = self.config.batch_size * self.strategy.num_replicas
        # Completed epochs, kept in the layout sidecar (the step counter
        # cannot give it once async incarnations of different widths mixed).
        self.epochs_completed = 0
        self._world_changed = False

        # Supervisor duties: restore-or-init against checkpoint_dir.
        self.supervisor = supervisor
        if self.supervisor is None and self.config.checkpoint_dir:
            self.supervisor = Supervisor(
                is_chief=is_chief,
                checkpoint_dir=self.config.checkpoint_dir,
                keep_last_n=self.config.keep_last_n,
                io_retries=self.config.checkpoint_retries,
                io_backoff=self.config.checkpoint_retry_backoff,
                async_checkpoint=self.config.async_checkpoint,
            )
        self.start_step = 0
        if self.supervisor is not None:
            self.supervisor.attach_observability(self.journal, self.metrics, self.spans)
            # The newest step that is not known-corrupt.
            step = self.supervisor.newest_restorable_step()
            src = self.supervisor.saved_layout(step) if step is not None else None
            if src is not None and not self._layout_compatible(src):
                # Written under another strategy's layout: read it in its
                # shapes, fold it to the canonical form, re-lay it out.
                raw = self.supervisor.restore_raw(step, self._disk_template(src),
                                                  device=self.device)
                self.state = self.strategy.from_canonical(self._canonicalize_from(raw, src))
                self.start_step = step
            else:
                # verified_step: the probe above already checked its files.
                self.state, self.start_step = self._restore_own(verified_step=step)
            if src is not None:
                self._adopt_batch_policy(src)
            self.epochs_completed = self._epochs_from_restore(src)

        # Scanned epochs: None resolves by device, as the JAX package
        # resolves by backend (the per-batch loop pays a host round trip
        # per batch on an accelerator); the explicit-collective sync step
        # has no scanned path.
        scan_epoch = self.config.scan_epoch
        if scan_epoch is None:
            scan_epoch = self.device.type != "cpu" and not getattr(self.strategy, "explicit", False)
        self._indexed_fn = None
        self._scan_rng = None
        if scan_epoch:
            self._indexed_fn = self.strategy.make_indexed_scanned_train_fn(
                self.model, self.loss_fn, self.optimizer
            )
            self._scan_rng = np.random.default_rng(self.config.seed)
            if self.start_step and self._world_changed and not self.config.per_worker_epoch:
                self._fast_forward_permutations()
        self._epoch_costs = None  # the last scanned epoch's costs (the guard reads them)
        self._stage_cache: dict = {}
        self._compiled_run_fns: dict = {}
        self._pallas_checked = False
        self.last_cost = None
        self.history: list[dict] = []
        if self.config.log_placement and self.is_chief:
            from distributed_tensorflow_tpu_torch.utils import placement

            placement.describe_state(self.strategy, self.state.params, print_fn=self.print_fn)

    # -- checkpoints and restores across strategies -----------------------

    def _layout_compatible(self, src: dict) -> bool:
        """True when the saved state's shapes are this strategy's: every
        sync-family layout shares the canonical shapes; async matches only
        async at the same replica count (the sidecar's shape keys only)."""
        mine = self.strategy.layout_meta()
        if mine["mode"] != "async":
            return src.get("mode") != "async"
        return layout_shape(src) == layout_shape(mine)

    def _layout_meta(self) -> dict:
        """The layout sidecar: the strategy's shape topology plus the
        restore policy (world size, global batch, completed epochs)."""
        meta = dict(self.strategy.layout_meta())
        meta["world"] = int(self.strategy.num_replicas)
        meta["global_batch"] = int(self.global_batch)
        meta["epochs"] = int(self.epochs_completed)
        return meta

    def _disk_state(self) -> TrainState:
        """The state as the checkpoint holds it, in the JAX package's layout:
        async's copies gathered and stacked ``[n, ...]`` with every copy's
        step count, any other strategy's canonical dense state (gathered
        from the blocks under ZeRO or tensor parallelism). A collective:
        every rank calls it, the chief writes."""
        state = self.state
        if isinstance(self.strategy, AsyncDataParallel):
            from distributed_tensorflow_tpu_torch.ops.collectives import all_gather_raw

            mesh = self.strategy.mesh
            stack = lambda t: tree_map(  # noqa: E731
                lambda a: all_gather_raw(a.detach().unsqueeze(0), mesh, "data", 0)
                if isinstance(a, torch.Tensor) else a, t)
            return TrainState(stack(state.params), stack(state.opt_state), tuple(state.step))
        return self.strategy.to_canonical(state)

    def _disk_template(self, src: dict) -> TrainState:
        """A state of the structure (and shapes) a checkpoint written under
        layout ``src`` holds, for this model and optimizer: the canonical
        one, or async's stacked ``[n, ...]`` copies."""
        params = self.model.init(self.config.seed, device="cpu")
        opt = self.optimizer.init(params)
        if src.get("mode") == "async":
            n = int(src["replicas"])
            stack = lambda t: tree_map(  # noqa: E731
                lambda a: a.unsqueeze(0).expand((n,) + tuple(a.shape))
                if isinstance(a, torch.Tensor) else a, t)
            return TrainState(stack(params), stack(opt), (0,) * n)
        return TrainState(params, opt, 0)

    def _from_disk(self, raw: TrainState) -> TrainState:
        """A checkpoint of this strategy's own layout as this rank's state:
        under async the rank's row of the stacked copies, else the
        canonical state laid out by the strategy."""
        if isinstance(self.strategy, AsyncDataParallel):
            r = self.strategy.mesh.axis_index("data")
            row = lambda t: tree_map(  # noqa: E731
                lambda a: a[r].clone() if isinstance(a, torch.Tensor) else a, t)
            return TrainState(row(raw.params), row(raw.opt_state), tuple(raw.step))
        return self.strategy.from_canonical(raw)

    def _restore_own(self, fresh: TrainState | None = None,
                     verified_step: int | None = None) -> tuple[TrainState, int]:
        """``Supervisor.prepare_or_restore`` in this strategy's own layout
        (newest valid step first); with no checkpoint, ``fresh`` (default
        the current state) and step 0."""
        self.supervisor.wait_pending()
        if not checkpoint_steps(self.supervisor.checkpoint_dir):
            return (self.state if fresh is None else fresh), 0
        raw, step = self.supervisor.prepare_or_restore(
            self._disk_template(self._layout_meta()), verified_step=verified_step,
            device=self.device)
        return self._from_disk(raw), step

    def _epochs_from_restore(self, src: dict | None) -> int:
        """Completed epochs at the restored step: the sidecar's count, or
        (an older sidecar) derived from the step counter."""
        if not self.start_step:
            return 0
        if src is not None and src.get("epochs") is not None:
            return int(src["epochs"])
        spe = self.datasets.train.num_examples // max(1, self.global_batch)
        incr = 1
        if src is not None and src.get("mode") == "async":
            incr = int(src.get("replicas", src.get("world", 1)))
        return self.start_step // max(1, spe * incr)

    def _adopt_batch_policy(self, src: dict) -> None:
        """The global batch across a resize (JAX :258-308): a restore onto
        another world size keeps the checkpoint's global batch, each
        replica's shard growing; refused under ``per_worker_epoch`` (the
        reference's convention ties the batch to the worker count) and when
        the batch does not shard over the new world."""
        saved = src.get("global_batch")
        saved_world = src.get("world")
        self._world_changed = (saved_world is not None
                               and int(saved_world) != self.strategy.num_replicas)
        if saved is None or int(saved) == self.global_batch:
            return
        saved = int(saved)
        n = self.strategy.num_replicas
        if self.config.per_worker_epoch:
            raise ValueError(
                f"checkpoint was written with global_batch={saved} "
                f"(world={saved_world}) but per_worker_epoch ties the "
                f"effective batch to the worker count (now {n}); the "
                "reference convention cannot preserve the global batch "
                "across a resize — resume with per_worker_epoch=False or "
                "restore onto the original world size"
            )
        if saved % n:
            raise ValueError(
                f"checkpoint global_batch={saved} does not shard over "
                f"{n} replicas; resume on a world size dividing it (or "
                "accept a new trajectory by clearing the sidecar)"
            )
        if self.is_chief:
            lifecycle_event("restore", print_fn=self.print_fn, journal=self.journal,
                            global_batch=saved, from_world=saved_world, world=n,
                            config_batch=self.config.batch_size,
                            config_global=self.global_batch, per_replica=saved // n)
        self.global_batch = saved

    def _fast_forward_permutations(self) -> None:
        """Replay the host permutation stream up to the restored epoch (a
        restore across a world change only), so the resumed run draws the
        batches the uninterrupted one would."""
        train = self.datasets.train
        need = (train.num_examples // self.global_batch) * self.global_batch
        draws_per_epoch = max(1, -(-need // train.num_examples))
        for _ in range(self.epochs_completed * draws_per_epoch):
            self._scan_rng.permutation(train.num_examples)

    def _canonicalize_from(self, state: TrainState, src: dict) -> TrainState:
        """A source-layout state → the canonical dense form: async's copies
        merged (``merge_stacked_leaf``) and their step counts summed."""
        step = self.strategy.global_step(state)
        if src.get("mode") != "async":
            return TrainState(state.params, state.opt_state, step)
        return TrainState(tree_map(merge_stacked_leaf, state.params),
                          tree_map(merge_stacked_leaf, state.opt_state), step)

    def _save(self) -> None:
        """A checkpoint at the current step (every rank gathers; the chief
        writes)."""
        self.supervisor.save(self._disk_state(), self.strategy.global_step(self.state),
                             layout=self._layout_meta())

    # -- pieces -----------------------------------------------------------

    def _stage_cached(self, name: str, arr) -> torch.Tensor:
        """Host array → device tensor, staged once and reused across epochs
        and calls (keyed by name, checked by identity)."""
        hit = self._stage_cache.get(name)
        if hit is None or hit[0] is not arr:
            staged = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
            self._stage_cache[name] = hit = (arr, staged)
        return hit[1]

    def evaluate(self) -> float:
        test = self.datasets.test
        return float(
            self.eval_fn(
                self.state,
                self._stage_cached("test_x", test.images),
                self._stage_cached("test_y", test.labels),
            )
        )

    def run_epoch(self, epoch: int, logger: StepLogger) -> None:
        """One epoch of the eager per-batch loop: ``next_batch`` on the
        host, one step per batch; the host syncs only when a line is due."""
        self._epoch_costs = None  # the eager path: the guard judges last_cost only
        if self._indexed_fn is not None:
            return self._run_epoch_scanned(epoch, logger)
        cfg = self.config
        train = self.datasets.train
        global_batch = self.global_batch
        batch_count = self._batch_count()
        logger.reset_window()
        t_epoch = time.time()
        if cfg.prefetch:
            from distributed_tensorflow_tpu_torch.data.prefetch import prefetch_batches

            batches = prefetch_batches(train.next_batch, global_batch, batch_count,
                                       self.strategy.prepare_batch, depth=cfg.prefetch)
        else:
            batches = (self.strategy.prepare_batch(*train.next_batch(global_batch))
                       for _ in range(batch_count))
        for i, (bx, by) in enumerate(batches):
            self.state, cost = self.train_step(self.state, bx, by)
            self.last_cost = cost
            if self._exchange is not None and (i + 1) % self.strategy.avg_every == 0:
                self.state = self._exchange(self.state)
            if logger.is_due(i + 1, batch_count):
                step = self.strategy.global_step(self.state)
                host_cost = self.strategy.cost_scalar(cost)
                logger.maybe_log_step(step=step, epoch=epoch, batch=i, batch_count=batch_count,
                                      cost=host_cost)
                self._add_scalar("cost", host_cost, step)
        self._observe_step_time((time.time() - t_epoch) * 1000 / max(batch_count, 1))

    def _run_epoch_scanned(self, epoch: int, logger: StepLogger) -> None:
        """One device loop over the epoch (train/scan.py): the training
        arrays stay on the device, the only per-epoch upload is the
        [steps, batch] permutation drawn from the host RNG, and the costs
        come back in one fetch, from which the step lines are emitted."""
        train = self.datasets.train
        xs = self._stage_cached("train_x", train.images)
        ys = self._stage_cached("train_y", train.labels)
        steps = self._batch_count()
        # Under per_worker_epoch the stream wraps over fresh permutations
        # (DataSet.next_batch's tail carry); every rank draws the same.
        need = steps * self.global_batch
        chunks, total = [], 0
        while total < need:
            chunks.append(self._scan_rng.permutation(train.num_examples))
            total += chunks[-1].size
        perm = np.concatenate(chunks)[:need] if len(chunks) > 1 else chunks[0][:need]
        idxs = torch.from_numpy(perm.reshape(steps, self.global_batch)).to(self.device)
        step_before = self.strategy.global_step(self.state)
        mark = self.spans.mark()
        t0 = time.time()
        self.state, costs = self._indexed_fn(self.state, xs, ys, idxs)
        # The fetch waits for the device; the span runs from the dispatch to it.
        costs = self.spans.dispatch_fetch("epoch_scan", costs, start=mark, epoch=int(epoch))
        elapsed = time.time() - t0
        self.last_cost = costs[-1]
        self._epoch_costs = costs  # the anomaly guard sees every step's cost
        avg_ms = elapsed * 1000 / len(costs)
        self._observe_step_time(avg_ms)
        self._emit_step_logs(costs, epoch, step_before, avg_ms, logger,
                             step_incr=self._step_incr(step_before, len(costs)))

    def _batch_count(self) -> int:
        """Steps an epoch: a pass over the data globally, or under
        ``per_worker_epoch`` (the reference's convention) one a worker."""
        train = self.datasets.train
        if self.config.per_worker_epoch:
            return train.num_examples // self.config.batch_size
        return train.num_examples // self.global_batch

    def _step_incr(self, step_before: int, batch_count: int) -> int:
        """Global-step advance per batch (num_replicas under async, 1
        under sync), from the counter itself."""
        return (self.strategy.global_step(self.state) - step_before) // max(batch_count, 1)

    def run_compiled(self, epochs: int | None = None, *, epoch_offset: int = 0,
                     finalize: bool = True) -> dict:
        """The whole run in one call (train/compiled_run.py, or the epoch
        kernel with ``engine="pallas"``): the same lines as :meth:`run`,
        emitted afterwards from the fetched ``[epochs, steps]`` costs and
        ``[epochs]`` accuracies, with a uniform AvgTime. With a supervisor
        the dispatch ends in a save (skipped, with a ``rollback_compiled``
        line, when a cost is not finite and the anomaly guard is armed).
        ``epoch_offset`` shifts the epoch numbers and ``finalize=False``
        leaves out the final line: the ``epochs_per_dispatch`` tier calls it
        a chunk at a time (JAX :554-764). One trace id (the caller's, when
        it runs inside one); a finalizing call returns once its save is on
        disk."""
        with tracing.trace(tracing.current_trace()):
            try:
                return self._run_compiled(epochs, epoch_offset=epoch_offset, finalize=finalize)
            finally:
                if finalize and self.supervisor is not None:
                    self.supervisor.wait_pending()
                    self._barrier()

    def _run_compiled(self, epochs: int | None = None, *, epoch_offset: int = 0,
                      finalize: bool = True) -> dict:
        cfg = self.config
        epochs = cfg.epochs if epochs is None else epochs
        use_kernel = cfg.engine == "pallas"
        if use_kernel and not self._pallas_checked:
            self._check_pallas_engine()
            self._pallas_checked = True
        steps_per_epoch = (
            self.datasets.train.num_examples // cfg.batch_size if cfg.per_worker_epoch else None
        )
        key = (cfg.engine, epochs, self.global_batch, steps_per_epoch)
        run_fn = self._compiled_run_fns.get(key)
        if run_fn is None:
            if use_kernel:
                from distributed_tensorflow_tpu_torch.ops.fused_mlp import (
                    make_fused_compiled_run_fn,
                )

                run_fn = make_fused_compiled_run_fn(
                    batch_size=self.global_batch,
                    epochs=epochs,
                    in_dim=self.model.in_dim,
                    hidden_dim=self.model.hidden_dim,
                    out_dim=self.model.out_dim,
                    learning_rate=cfg.learning_rate,
                    steps_per_epoch=steps_per_epoch,
                )
            else:
                run_fn = self.strategy.make_compiled_run_fn(
                    self.model, self.loss_fn, self.optimizer,
                    batch_size=self.global_batch, epochs=epochs,
                    steps_per_epoch=steps_per_epoch,
                )
            self._compiled_run_fns[key] = run_fn
        self._maybe_write_graph()
        logger = StepLogger(freq=cfg.log_frequency, print_fn=self.print_fn, journal=self.journal)
        train, test = self.datasets.train, self.datasets.test
        step_before = self.strategy.global_step(self.state)
        # Seeded by the global step too, so a repeated run draws fresh
        # epoch permutations instead of replaying the first run's.
        generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed * 2**32 + step_before
        )
        t0 = time.time()
        args = (
            self._stage_cached("train_x", train.images),
            self._stage_cached("train_y", train.labels),
            self._stage_cached("test_x", test.images),
            self._stage_cached("test_y", test.labels),
            generator,
        )
        mark = self.spans.mark()
        if use_kernel:
            from distributed_tensorflow_tpu_torch.ops.fused_mlp import from_fused, to_fused

            fused, metrics = run_fn(to_fused(self.state.params), *args)
            self.state = TrainState(
                from_fused(fused), self.state.opt_state,
                self.state.step + metrics["costs"].numel(),
            )
        else:
            self.state, metrics = run_fn(self.state, *args)
        # The one fetch of the run; the span runs from the dispatch to it.
        costs = self.spans.dispatch_fetch("compiled_run", metrics["costs"], start=mark,
                                          epochs=int(epochs), engine=cfg.engine)
        accs = metrics["accuracy"].cpu().numpy()
        elapsed = time.time() - t0
        batch_count = costs.shape[1]
        if costs.size:
            self.last_cost = costs[-1, -1]
        avg_ms = elapsed * 1000 / max(epochs * batch_count, 1)
        self._observe_step_time(avg_ms)
        incr = self._step_incr(step_before, epochs * batch_count)
        for epoch in range(epochs):
            self._emit_step_logs(
                costs[epoch], epoch_offset + epoch, step_before + epoch * batch_count * incr,
                avg_ms, logger, step_incr=incr,
            )
            if self.is_chief:
                step_now = step_before + (epoch + 1) * batch_count * incr
                logger.log_epoch(test_accuracy=float(accs[epoch]))
                self._add_scalar("accuracy", float(accs[epoch]), step_now)
                self.history.append({
                    "epoch": epoch_offset + epoch + 1,
                    "accuracy": float(accs[epoch]),
                    "step": step_now,
                })
        self.epochs_completed += epochs
        if self.supervisor is not None:
            self.supervisor.report_progress(self.strategy.global_step(self.state))
            if cfg.max_rollbacks and costs.size and not np.isfinite(costs).all():
                # One dispatch cannot roll back inside itself; a poisoned
                # state must not land over the last good checkpoint (run()'s
                # per-epoch and chunked paths restore and retry).
                if self.is_chief:
                    lifecycle_event("rollback_compiled", print_fn=self.print_fn,
                                    journal=self.journal)
            else:
                self._save()
        final_cost = float(costs[-1, -1]) if costs.size else float("nan")
        if finalize and self.is_chief:
            logger.log_final(cost=final_cost)
            self._flush_telemetry()
        return {
            "accuracy": float(accs[-1]) if accs.size else 0.0,
            "final_cost": final_cost,
            "global_step": self.strategy.global_step(self.state),
        }

    def _run_chunked(self, epochs: int) -> dict:
        """The k-epochs-per-dispatch tier (``config.epochs_per_dispatch``):
        the whole-run program a chunk at a time, with each chunk's epoch
        lines, a checkpoint after each dispatch and ``should_stop`` at the
        boundaries (JAX :766-819). A chunk whose last cost is not finite is
        rolled back and retried on the next data window (NaN only: the
        spike baseline needs run()'s per-epoch history)."""
        import math

        k = self.config.epochs_per_dispatch
        guard = AnomalyGuard.from_config(self.config)
        res = {"accuracy": 0.0, "final_cost": float("nan"),
               "global_step": self.strategy.global_step(self.state)}
        done = 0
        while done < epochs:
            n = min(k, epochs - done)
            last = done + n >= epochs
            step_before = self.strategy.global_step(self.state)
            res = self.run_compiled(n, epoch_offset=done, finalize=last)
            if (guard is not None and not math.isfinite(res["final_cost"])
                    and res["global_step"] > step_before):
                # The poisoned chunk's epochs never reached a checkpoint.
                self.epochs_completed = max(0, self.epochs_completed - n)
                self._anomaly_rollback(guard, "nan", done)
                continue
            done += n
            if self.supervisor is not None and self.supervisor.should_stop:
                if not last and self.is_chief:
                    StepLogger(freq=self.config.log_frequency, print_fn=self.print_fn,
                               journal=self.journal).log_final(cost=res["final_cost"])
                    if self.summary_writer is not None:
                        self.summary_writer.flush()
                break
        return res

    def _anomaly_rollback(self, guard: AnomalyGuard, kind: str, epoch: int) -> None:
        """Restore the newest valid checkpoint after an anomalous epoch and
        leave the data stream where it is, so the retry trains on the next
        window (with no checkpoint yet, the seed's fresh state). Raises
        :class:`AnomalyError` once ``max_rollbacks`` is spent (JAX
        :961-1012)."""
        detected_step = self.strategy.global_step(self.state)
        if self.supervisor is None or guard.exhausted:
            raise AnomalyError(
                f"anomalous cost (kind={kind}) at epoch {epoch} step "
                f"{detected_step} with no rollback budget left "
                f"({guard.rollbacks}/{guard.max_rollbacks} used"
                + ("" if self.supervisor else "; no supervisor") + ")"
            )
        guard.rollbacks += 1
        self.metrics.counter("rollbacks_total").inc()
        fresh = self.strategy.init_state(self.model, self.optimizer, self.config.seed)
        self.state, restored_step = self._restore_own(fresh)
        self.last_cost = None
        try:
            side = self.supervisor.saved_layout(restored_step)
        except ValueError:
            side = None
        if side is not None and side.get("epochs") is not None:
            self.epochs_completed = int(side["epochs"])
        if self.is_chief:
            lifecycle_event(
                "rollback",
                print_fn=self.print_fn,
                journal=self.journal,
                writer=self.summary_writer,
                scalar=("rollback", float(restored_step), detected_step),
                anomaly=kind,
                epoch=epoch,
                detected_step=detected_step,
                restored_step=restored_step,
                rollback=guard.rollbacks,
                max_rollbacks=guard.max_rollbacks,
            )

    def _check_pallas_engine(self) -> None:
        """engine="pallas" runs the fused epoch kernel, which hard-codes the
        reference workload's math (MLP sigmoid/softmax, naive CE, plain
        constant-lr SGD, one device). Anything else must use the generic
        engine: raise rather than silently change the math."""
        from distributed_tensorflow_tpu_torch.models.mlp import MLP, MLPParams

        cfg = self.config
        problems = []
        if not isinstance(self.model, MLP):
            problems.append(f"model {type(self.model).__name__} (need MLP)")
        if not isinstance(self.strategy, SingleDevice):
            problems.append(
                f"strategy {type(self.strategy).__name__} (need SingleDevice; "
                "use ops.fused_mlp.make_fused_async_epoch_fn for DP)"
            )
        if (
            cfg.optimizer != "sgd"
            or cfg.lr_schedule not in (None, "constant")  # optim treats both as constant
            or cfg.warmup_steps
        ):
            problems.append("optimizer config (need plain constant-lr sgd)")
        if cfg.loss != "naive":
            problems.append("loss config (need the reference's naive CE)")
        if cfg.accumulate_steps != 1 or cfg.grad_clip_norm:
            problems.append("accumulation/clipping (unsupported in the kernel)")
        # The objects themselves may be passed to Trainer directly, so they
        # must also behave as sgd(lr) and the naive CE. Two updates expose
        # momentum/adam/schedules/accumulation (all of which match plain
        # SGD on a single first step).
        probe = MLPParams(*(torch.tensor(v) for v in ([[0.5, -1.5]], [2.0], [[0.25]], [-1.0])))

        def two_updates(opt):
            s = opt.init(probe)
            p1, s = opt.update(probe, s, probe)
            p2, _ = opt.update(MLPParams(*(0.5 * t for t in probe)), s, p1)
            return torch.cat([t.flatten() for t in (*p1, *p2)])

        try:
            opt_ok = torch.allclose(
                two_updates(self.optimizer), two_updates(optim_lib.sgd(cfg.learning_rate))
            )
        except (AttributeError, TypeError, ValueError, RuntimeError):
            opt_ok = False
        if not opt_ok:
            problems.append(
                "optimizer (need plain constant-lr sgd semantics: no "
                "momentum/adam, schedule, warmup, clipping, or accumulation)"
            )
        y_probe = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
        p_probe = torch.tensor([[0.7, 0.3], [0.2, 0.8]])
        try:
            loss_ok = torch.allclose(
                torch.as_tensor(self.loss_fn(p_probe, y_probe)),
                losses_lib.cross_entropy(p_probe, y_probe),
            )
        except (AttributeError, TypeError, ValueError, RuntimeError):
            loss_ok = False
        if not loss_ok:
            problems.append("loss (need the reference's naive CE)")
        if problems:
            raise ValueError(
                "engine='pallas' requires the reference workload shape; got "
                + "; ".join(problems)
            )

    def _emit_step_logs(self, costs, epoch: int, step_offset: int, avg_ms: float,
                        logger: StepLogger, step_incr: int = 1) -> None:
        """Reference-cadence step lines from a device loop's fetched
        per-step costs (the scanned and whole-run paths); ``step_incr`` is
        the global-step advance a batch."""
        batch_count = len(costs)
        for i in range(batch_count):
            if logger.is_due(i + 1, batch_count):
                step = step_offset + (i + 1) * step_incr
                logger.log_step_line(
                    step=step,
                    epoch=epoch,
                    batch=i,
                    batch_count=batch_count,
                    cost=float(costs[i]),
                    avg_ms=avg_ms,
                )
                self._add_scalar("cost", float(costs[i]), step)

    # -- telemetry --------------------------------------------------------

    def _add_scalar(self, tag: str, value: float, step: int) -> None:
        """A tfevents scalar on the chief (``value`` already on the host)."""
        if self.summary_writer is not None and self.is_chief:
            self.summary_writer.add_scalar(tag, value, step)

    def _observe_step_time(self, avg_ms: float) -> None:
        """An epoch's mean step time into the ``step_time_ms`` histogram
        (JAX :896-903)."""
        self.metrics.histogram("step_time_ms", edges=TIME_MS_EDGES).observe(float(avg_ms))

    def _flush_telemetry(self) -> None:
        """The end of a run on the chief (JAX :756-759): the summaries to
        disk, the metrics snapshot into the journal, the journal synced."""
        if self.summary_writer is not None:
            self.summary_writer.flush()
        self.metrics.flush_to(self.journal, component="trainer")
        self.journal.flush()

    def _maybe_write_graph(self) -> None:
        # Once per trainer: TensorBoard expects one graph a run, and run()
        # may be called again.
        if self.summary_writer is not None and self.is_chief and not self._graph_written:
            self.write_graph()
            self._graph_written = True

    def write_graph(self) -> None:
        """The step the run takes, as the TensorBoard graph (the reference
        passed its TF graph to the FileWriter, ``tfsingle.py:69``; JAX
        :944 dumps the step's jaxpr). The train step is traced by
        ``make_fx`` on fake tensors over a zeros batch, so nothing runs on
        the device and the data stream does not move; a compiled run on
        ``engine="pallas"`` is its epoch kernel, one node
        (``mlp_epoch_kernel`` over the parameters and the epoch's
        batches)."""
        from types import SimpleNamespace

        from distributed_tensorflow_tpu_torch.utils.summary import kernel_graph_def

        train = self.datasets.train
        shape = lambda a, rows: (rows,) + tuple(a.shape[1:])  # noqa: E731
        if self.config.compiled_run and self.config.engine == "pallas":
            # The kernel's inputs as ops/fused_mlp.make_fused_compiled_run_fn
            # stages them: the epoch's batches in bf16.
            p, steps = self.state.params, self._batch_count()
            staged = lambda a: SimpleNamespace(  # noqa: E731
                shape=(steps,) + shape(a, self.global_batch), dtype="bfloat16")
            self.summary_writer.add_graph_def(kernel_graph_def(
                "mlp_epoch_kernel", {"w1": p.w1, "b1": p.b1, "w2": p.w2, "b2": p.b2,
                                     "xs": staged(train.images), "ys": staged(train.labels)}))
            return
        bx, by = self.strategy.prepare_batch(
            np.zeros(shape(train.images, self.global_batch), np.float32),
            np.zeros(shape(train.labels, self.global_batch), np.float32),
        )
        self.summary_writer.add_graph(self.train_step, self.state, bx, by)

    # -- the loop ---------------------------------------------------------

    def run(self, epochs: int | None = None) -> dict:
        """The run: ``epochs`` epochs (default the config's), each evaluated,
        under one ambient trace id and the preemption contract: SIGTERM or
        SIGINT asks for a stop, the loop leaves at the next epoch (or
        dispatch) boundary with a final save, and the process can exit 0.
        Returns once every save is on disk (JAX :1014-1044)."""
        arm_stall_dump()  # $DTF_STALL_DUMP, or nothing
        with tracing.trace(tracing.current_trace()), preemption_guard(
            self.supervisor, enabled=self.config.handle_preemption, print_fn=self.print_fn,
            journal=self.journal,
        ):
            try:
                return self._run(epochs)
            finally:
                if self.supervisor is not None:
                    self.supervisor.wait_pending()
                    self._barrier()

    def _barrier(self) -> None:
        """On several ranks, wait for every rank: after the chief's final
        save has committed, so a rank that restores next reads it."""
        import torch.distributed as dist

        if self.strategy.mesh.size > 1 and dist.is_initialized():
            dist.barrier()

    def _run(self, epochs: int | None = None) -> dict:
        cfg = self.config
        if cfg.compiled_run:
            return self.run_compiled(epochs)
        epochs = cfg.epochs if epochs is None else epochs
        if cfg.epochs_per_dispatch:
            return self._run_chunked(epochs)
        self._maybe_write_graph()
        logger = StepLogger(freq=cfg.log_frequency, print_fn=self.print_fn, journal=self.journal)
        guard = AnomalyGuard.from_config(cfg)
        accuracy = 0.0
        epoch, profiled = 0, False
        while epoch < epochs:
            if epoch == 0 and cfg.profile_dir and not profiled:
                from distributed_tensorflow_tpu_torch.utils import profiler

                profiled = True
                with profiler.trace(cfg.profile_dir, self.spans, device=self.device):
                    self.run_epoch(epoch, logger)
            else:
                self.run_epoch(epoch, logger)
            if guard is not None:
                # Judged before the eval and the save: an anomalous state
                # neither reaches the checkpoints nor counts as a good
                # epoch; every rank reaches the same verdict.
                cost = (self.strategy.cost_scalar(self.last_cost)
                        if self.last_cost is not None else float("nan"))
                kind = guard.classify(cost, costs=self._epoch_costs)
                if kind is not None:
                    self._anomaly_rollback(guard, kind, epoch)
                    continue  # this epoch index again, on the next window
                guard.record(cost)
            self.epochs_completed += 1
            self.metrics.counter("epochs_total").inc()
            # Every rank evaluates (a collective under async and ZeRO);
            # the chief logs and records it.
            accuracy = self.evaluate()
            if self.is_chief:
                logger.log_epoch(test_accuracy=accuracy)
                self._add_scalar("accuracy", accuracy, self.strategy.global_step(self.state))
                self.history.append({
                    "epoch": epoch + 1,
                    "accuracy": accuracy,
                    "step": self.strategy.global_step(self.state),
                })
            if self.supervisor is not None:
                # Progress first (the work is done; the save may be slow).
                self.supervisor.report_progress(self.strategy.global_step(self.state))
                self._save()
                if self.supervisor.should_stop:
                    break
            epoch += 1
        final_cost = (
            self.strategy.cost_scalar(self.last_cost)
            if self.last_cost is not None
            else float("nan")
        )
        if self.is_chief:
            logger.log_final(cost=final_cost)
            self._flush_telemetry()
        return {
            "accuracy": accuracy,
            "final_cost": final_cost,
            "global_step": self.strategy.global_step(self.state),
        }
