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

Not ported yet, and refused when asked for: the supervisor and
checkpointing, anomaly rollback and ``epochs_per_dispatch`` (ROADMAP A8a).
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
from distributed_tensorflow_tpu_torch.parallel.strategy import (
    AsyncDataParallel,
    SingleDevice,
    Strategy,
    TrainState,
)
from distributed_tensorflow_tpu_torch.utils.logging import StepLogger

# JAX Trainer keyword -> (values that switch it off, ROADMAP item).
NOT_PORTED = {
    "supervisor": ((None,), "A8a"),
}


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
        # replicas consume N × batch_size a step.
        self.global_batch = self.config.batch_size * self.strategy.num_replicas

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
        self._stage_cache: dict = {}
        self._compiled_run_fns: dict = {}
        self._pallas_checked = False
        self.last_cost = None
        self.history: list[dict] = []
        if self.config.log_placement and self.is_chief:
            from distributed_tensorflow_tpu_torch.utils import placement

            placement.describe_state(self.strategy, self.state.params, print_fn=self.print_fn)

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

    def run_compiled(self, epochs: int | None = None) -> dict:
        """The whole run in one call (train/compiled_run.py, or the epoch
        kernel with ``engine="pallas"``): the same lines as :meth:`run`,
        emitted afterwards from the fetched ``[epochs, steps]`` costs and
        ``[epochs]`` accuracies, with a uniform AvgTime. One trace id (the
        caller's, when it runs inside one)."""
        with tracing.trace(tracing.current_trace()):
            return self._run_compiled(epochs)

    def _run_compiled(self, epochs: int | None = None) -> dict:
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
                costs[epoch], epoch, step_before + epoch * batch_count * incr, avg_ms, logger,
                step_incr=incr,
            )
            if self.is_chief:
                step_now = step_before + (epoch + 1) * batch_count * incr
                logger.log_epoch(test_accuracy=float(accs[epoch]))
                self._add_scalar("accuracy", float(accs[epoch]), step_now)
                self.history.append({
                    "epoch": epoch + 1,
                    "accuracy": float(accs[epoch]),
                    "step": step_now,
                })
        final_cost = float(costs[-1, -1]) if costs.size else float("nan")
        if self.is_chief:
            logger.log_final(cost=final_cost)
            self._flush_telemetry()
        return {
            "accuracy": float(accs[-1]) if accs.size else 0.0,
            "final_cost": final_cost,
            "global_step": self.strategy.global_step(self.state),
        }

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
        under one ambient trace id (JAX :1022-1034)."""
        with tracing.trace(tracing.current_trace()):
            return self._run(epochs)

    def _run(self, epochs: int | None = None) -> dict:
        cfg = self.config
        if cfg.compiled_run:
            return self.run_compiled(epochs)
        epochs = cfg.epochs if epochs is None else epochs
        self._maybe_write_graph()
        logger = StepLogger(freq=cfg.log_frequency, print_fn=self.print_fn, journal=self.journal)
        accuracy = 0.0
        for epoch in range(epochs):
            if epoch == 0 and cfg.profile_dir:
                from distributed_tensorflow_tpu_torch.utils import profiler

                with profiler.trace(cfg.profile_dir, self.spans, device=self.device):
                    self.run_epoch(epoch, logger)
            else:
                self.run_epoch(epoch, logger)
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
