"""The MLP training loop of the port.

Counterpart of ``distributed_tensorflow_tpu/train/trainer.py`` ``Trainer``
on one device. It keeps the reference loop's contract: ``epochs`` ×
``num_train_examples // batch_size`` SGD steps, the Step/Epoch/Batch/
Cost/AvgTime line every ``log_frequency`` batches, the full test-set
accuracy and wall time per epoch, and a final-cost line. Three paths:

- the eager per-batch loop (``run_epoch``), the default on the CPU;
- the indexed scanned epoch (``_run_epoch_scanned``): the training arrays
  staged on the device once, one device loop per epoch over a host
  permutation, costs fetched once per epoch; the default on ``cuda``, as
  ``scan_epoch=None`` resolves on an accelerator in the JAX package;
- the whole run (``run_compiled``, ``TrainConfig.compiled_run``) with
  ``engine="xla"`` (PyTorch ops and autograd) or ``engine="pallas"`` (the
  CUDA whole-epoch kernel of ``ops/fused_mlp.py``, one launch per epoch).

Not ported yet, and refused when asked for: the supervisor and
checkpointing, anomaly rollback, ``epochs_per_dispatch``, prefetch,
summaries, the journal and metrics (ROADMAP A8), other strategies and
models (A6).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.config import TrainConfig
from distributed_tensorflow_tpu_torch.ops import losses as losses_lib
from distributed_tensorflow_tpu_torch.ops import optim as optim_lib
from distributed_tensorflow_tpu_torch.parallel.strategy import SingleDevice, TrainState
from distributed_tensorflow_tpu_torch.utils.logging import StepLogger

# JAX Trainer keyword -> (values that switch it off, ROADMAP item).
NOT_PORTED = {
    "summary_writer": ((None,), "A8"),
    "supervisor": ((None,), "A8"),
    "journal": ((None,), "A8"),
    "metrics": ((None,), "A8"),
    "is_chief": ((True,), "A6"),
}


class Trainer:
    def __init__(
        self,
        model,
        datasets,
        config: TrainConfig | None = None,
        *,
        strategy: SingleDevice | None = None,
        loss_fn=None,
        optimizer=None,
        print_fn=print,
        device=None,
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
        self.print_fn = print_fn

        self.state = self.strategy.init_state(self.model, self.optimizer, self.config.seed)
        self.train_step = self.strategy.make_train_step(self.model, self.loss_fn, self.optimizer)
        self.eval_fn = self.strategy.make_eval_fn(self.model)
        self.global_batch = self.config.batch_size * self.strategy.num_replicas

        # Scanned epochs: None resolves by device, as the JAX package
        # resolves by backend (the per-batch loop pays a host round trip
        # per batch on an accelerator).
        scan_epoch = self.config.scan_epoch
        if scan_epoch is None:
            scan_epoch = self.device.type != "cpu"
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
        train = self.datasets.train
        batch_count = train.num_examples // self.global_batch
        logger.reset_window()
        for i in range(batch_count):
            bx, by = self.strategy.prepare_batch(*train.next_batch(self.global_batch))
            self.state, cost = self.train_step(self.state, bx, by)
            self.last_cost = cost
            if logger.is_due(i + 1, batch_count):
                logger.maybe_log_step(
                    step=self.strategy.global_step(self.state),
                    epoch=epoch,
                    batch=i,
                    batch_count=batch_count,
                    cost=self.strategy.cost_scalar(cost),
                )

    def _run_epoch_scanned(self, epoch: int, logger: StepLogger) -> None:
        """One device loop over the epoch (train/scan.py): the training
        arrays stay on the device, the only per-epoch upload is the
        [steps, batch] permutation drawn from the host RNG, and the costs
        come back in one fetch, from which the step lines are emitted."""
        train = self.datasets.train
        xs = self._stage_cached("train_x", train.images)
        ys = self._stage_cached("train_y", train.labels)
        steps = train.num_examples // self.global_batch
        perm = self._scan_rng.permutation(train.num_examples)[: steps * self.global_batch]
        idxs = torch.from_numpy(perm.reshape(steps, self.global_batch)).to(self.device)
        step_before = self.strategy.global_step(self.state)
        t0 = time.time()
        self.state, costs = self._indexed_fn(self.state, xs, ys, idxs)
        costs = costs.cpu().numpy()  # the fetch waits for the device
        elapsed = time.time() - t0
        self.last_cost = costs[-1]
        avg_ms = elapsed * 1000 / len(costs)
        self._emit_step_logs(costs, epoch, step_before, avg_ms, logger)

    def run_compiled(self, epochs: int | None = None) -> dict:
        """The whole run in one call (train/compiled_run.py, or the epoch
        kernel with ``engine="pallas"``): the same lines as :meth:`run`,
        emitted afterwards from the fetched ``[epochs, steps]`` costs and
        ``[epochs]`` accuracies, with a uniform AvgTime."""
        cfg = self.config
        epochs = cfg.epochs if epochs is None else epochs
        use_kernel = cfg.engine == "pallas"
        if use_kernel and not self._pallas_checked:
            self._check_pallas_engine()
            self._pallas_checked = True
        key = (cfg.engine, epochs, self.global_batch)
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
                )
            else:
                run_fn = self.strategy.make_compiled_run_fn(
                    self.model, self.loss_fn, self.optimizer,
                    batch_size=self.global_batch, epochs=epochs,
                )
            self._compiled_run_fns[key] = run_fn
        logger = StepLogger(freq=cfg.log_frequency, print_fn=self.print_fn)
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
        if use_kernel:
            from distributed_tensorflow_tpu_torch.ops.fused_mlp import from_fused, to_fused

            fused, metrics = run_fn(to_fused(self.state.params), *args)
            self.state = TrainState(
                from_fused(fused), self.state.opt_state,
                self.state.step + metrics["costs"].numel(),
            )
        else:
            self.state, metrics = run_fn(self.state, *args)
        costs = metrics["costs"].cpu().numpy()  # the one fetch of the run
        accs = metrics["accuracy"].cpu().numpy()
        elapsed = time.time() - t0
        batch_count = costs.shape[1]
        if costs.size:
            self.last_cost = costs[-1, -1]
        avg_ms = elapsed * 1000 / max(epochs * batch_count, 1)
        for epoch in range(epochs):
            self._emit_step_logs(
                costs[epoch], epoch, step_before + epoch * batch_count, avg_ms, logger
            )
            logger.log_epoch(test_accuracy=float(accs[epoch]))
            self.history.append({
                "epoch": epoch + 1,
                "accuracy": float(accs[epoch]),
                "step": step_before + (epoch + 1) * batch_count,
            })
        final_cost = float(costs[-1, -1]) if costs.size else float("nan")
        logger.log_final(cost=final_cost)
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
            problems.append(f"strategy {type(self.strategy).__name__} (need SingleDevice)")
        if cfg.optimizer != "sgd":
            problems.append("optimizer config (need plain constant-lr sgd)")
        if cfg.loss != "naive":
            problems.append("loss config (need the reference's naive CE)")
        # The objects themselves may be passed to Trainer directly, so they
        # must also behave as sgd(lr) and the naive CE. Two applies expose
        # an optimizer with state (one apply of any of them matches SGD).
        probe = MLPParams(*(torch.tensor(v) for v in ([[0.5, -1.5]], [2.0], [[0.25]], [-1.0])))

        def two_updates(opt):
            p1 = opt.apply(probe, probe)
            p2 = opt.apply(p1, MLPParams(*(0.5 * t for t in probe)))
            return torch.cat([t.flatten() for t in (*p1, *p2)])

        try:
            opt_ok = torch.allclose(
                two_updates(self.optimizer), two_updates(optim_lib.sgd(cfg.learning_rate))
            )
        except (AttributeError, TypeError, ValueError, RuntimeError):
            opt_ok = False
        if not opt_ok:
            problems.append("optimizer (need plain constant-lr sgd semantics)")
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
                        logger: StepLogger) -> None:
        """Reference-cadence step lines from a device loop's fetched
        per-step costs (the scanned and whole-run paths)."""
        batch_count = len(costs)
        for i in range(batch_count):
            if logger.is_due(i + 1, batch_count):
                logger.log_step_line(
                    step=step_offset + i + 1,
                    epoch=epoch,
                    batch=i,
                    batch_count=batch_count,
                    cost=float(costs[i]),
                    avg_ms=avg_ms,
                )

    # -- the loop ---------------------------------------------------------

    def run(self, epochs: int | None = None) -> dict:
        cfg = self.config
        if cfg.compiled_run:
            return self.run_compiled(epochs)
        epochs = cfg.epochs if epochs is None else epochs
        logger = StepLogger(freq=cfg.log_frequency, print_fn=self.print_fn)
        accuracy = 0.0
        for epoch in range(epochs):
            self.run_epoch(epoch, logger)
            accuracy = self.evaluate()
            logger.log_epoch(test_accuracy=accuracy)
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
        logger.log_final(cost=final_cost)
        return {
            "accuracy": accuracy,
            "final_cost": final_cost,
            "global_step": self.strategy.global_step(self.state),
        }
