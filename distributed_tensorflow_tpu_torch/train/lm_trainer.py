"""The GPT training loop of the port, on one device.

Counterpart of ``distributed_tensorflow_tpu/train/lm_trainer.py``
``LMTrainer`` in its single mode (``mesh=None``): the reference loop's
contract over token batches.

- ``epochs`` × ``num_train // batch_size`` steps over a
  :class:`~data.tokens.TokenDataset` (``next_batch`` semantics);
- the ``Step/Epoch/Batch/Cost/AvgTime`` line every ``log_frequency``
  batches, a held-out **perplexity** per epoch (``Test-Perplexity:``,
  exp of the mean next-token CE over the validation split in
  ``eval_batch``-row chunks), ``Final Cost:`` and ``Done``;
- ragged corpora (datasets with ``lengths``) through the masked loss.

One loop runs the step function (``models/gpt.make_lm_train_step``): the
token arrays are staged on the device once, each epoch's ``[steps,
batch]`` indices are drawn from the dataset's own ``next_indices`` stream
(the batches ``next_batch`` would give), each step gathers its batch on
the device, and a cost is fetched to the host only where a log line is
due. In PyTorch the JAX package's eager and scanned epochs both come down
to this loop, so ``TrainConfig.scan_epoch`` is accepted and changes
nothing. ``TrainConfig.remat=True`` checkpoints every block, on a copy of
the model.

Not ported yet, and refused when asked for: ``mesh`` and the parallel
modes (ROADMAP A6/A7), the supervisor and checkpoints, summaries, the
journal and metrics, ``epochs_per_dispatch`` and the anomaly guard (A8),
a tokenizer shipped with checkpoints (A3/A8), the DiLoCo ``delta_exchange``
(A7), and ``compiled_run`` for the LM (A4 "Left").
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.config import TrainConfig
from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.models.gpt import make_lm_train_step
from distributed_tensorflow_tpu_torch.ops import optim as optim_lib
from distributed_tensorflow_tpu_torch.parallel.strategy import TrainState
from distributed_tensorflow_tpu_torch.utils.logging import StepLogger

# JAX LMTrainer keyword -> (values that leave it off, ROADMAP item).
NOT_PORTED = {
    "mesh": ((None,), "A6/A7"),
    "summary_writer": ((None,), "A8"),
    "supervisor": ((None,), "A8"),
    "journal": ((None,), "A8"),
    "metrics": ((None,), "A8"),
    "tokenizer": ((None,), "A3/A8"),
    "delta_exchange": ((None,), "A7"),
    "is_chief": ((True,), "A6/A7"),
    "async_update_scale": ((None,), "A7"),
    "data_axis": (("data",), "A6/A7"),
    "tp_axis": (("model",), "A7"),
    "expert_axis": (("expert",), "A7"),
    "stage_axis": (("stage",), "A7"),
    "pp_microbatches": ((4,), "A7"),
    "seq_axis": (("seq",), "A7"),
    "sp_attention": ((None,), "A7"),
}


class LMTrainer:
    def __init__(
        self,
        model,
        datasets,
        config: TrainConfig | None = None,
        *,
        optimizer=None,
        eval_batch: int = 256,
        print_fn=print,
        device=None,
        **not_ported,
    ):
        for name, value in not_ported.items():
            if name not in NOT_PORTED:
                raise TypeError(f"LMTrainer() got an unexpected keyword argument {name!r}")
            off, item = NOT_PORTED[name]
            if value not in off:
                raise NotImplementedError(
                    f"LMTrainer({name}=...) is not ported yet (ROADMAP {item})"
                )
        self.config = config or TrainConfig()
        if self.config.compiled_run:
            raise NotImplementedError(
                "compiled_run for the LM trainer is not ported yet (ROADMAP A4 \"Left\")"
            )
        # The config's remat lands on a shallow copy, so the caller's model
        # object keeps its own setting (as in the JAX trainer).
        if self.config.remat and not model.remat:
            model = copy.copy(model)
            model.remat = self.config.remat
        self.model = model
        self.datasets = datasets
        self.device = resolve_device(device)
        self.optimizer = optimizer or optim_lib.make(
            self.config.optimizer, self.config.learning_rate
        )
        self.eval_batch = eval_batch
        self.print_fn = print_fn
        self._ragged = datasets.train.lengths is not None
        self._step = make_lm_train_step(self.model, self.optimizer)
        self.state = self._init_state(self.model.init(seed=self.config.seed, device=self.device))
        self._stage_cache: dict = {}
        self.last_cost = None
        self.history: list[dict] = []

    # -- pieces -----------------------------------------------------------

    def _init_state(self, params) -> TrainState:
        """A fresh state at ``params``: the optimizer's initial state, step 0."""
        return TrainState(params, self.optimizer.init(params), 0)

    @property
    def global_step(self) -> int:
        return int(self.state.step)

    def _stage(self, name: str, arr) -> torch.Tensor:
        """Host array → device tensor, staged once and reused across epochs
        and evals (keyed by name, checked by identity)."""
        hit = self._stage_cache.get(name)
        if hit is None or hit[0] is not arr:
            staged = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
            self._stage_cache[name] = hit = (arr, staged)
        return hit[1]

    def _train_step(self, toks, lens):
        """One update on a device batch; returns the cost (on the device)."""
        params, opt_state, cost = self._step(
            self.state.params, self.state.opt_state, toks, lens
        )
        self.state = TrainState(params, opt_state, self.state.step + 1)
        return cost

    def _ce_count(self, params, toks, lens):
        """(CE · target count, target count) of one token block, masked when
        ragged: the eval arithmetic of :meth:`evaluate`."""
        if self._ragged:
            ce = self.model.loss(params, toks, lens)
            count = int(torch.clamp(lens.long() - 1, min=0).sum())
        else:
            ce = self.model.loss(params, toks)
            count = toks.shape[0] * (toks.shape[1] - 1)
        return ce * count, count

    @torch.no_grad()
    def evaluate(self, split: str = "validation") -> float:
        """Held-out perplexity = exp(total next-token CE / total targets),
        over the whole split in ``eval_batch``-row chunks."""
        ds = getattr(self.datasets, split)
        toks = self._stage(f"{split}_tokens", ds.tokens)
        lens = self._stage(f"{split}_lengths", ds.lengths) if self._ragged else None
        b = min(self.eval_batch, ds.num_examples)
        total, count = 0.0, 0
        for lo in range(0, ds.num_examples, b):
            hi = min(lo + b, ds.num_examples)
            s, c = self._ce_count(
                self.state.params, toks[lo:hi], None if lens is None else lens[lo:hi]
            )
            total += float(s)
            count += c
        return float(np.exp(total / max(count, 1)))

    # -- the loop ---------------------------------------------------------

    def run_epoch(self, epoch: int, logger: StepLogger) -> None:
        cfg = self.config
        train = self.datasets.train
        steps = train.num_examples // cfg.batch_size
        step_before = self.global_step
        toks_all = self._stage("train_tokens", train.tokens)
        lens_all = self._stage("train_lengths", train.lengths) if self._ragged else None
        idxs = np.stack([train.next_indices(cfg.batch_size) for _ in range(steps)])
        idxs = torch.from_numpy(idxs.astype(np.int64)).to(self.device)
        logger.reset_window()
        cost = None
        for i in range(steps):
            lens = None if lens_all is None else lens_all.index_select(0, idxs[i])
            cost = self._train_step(toks_all.index_select(0, idxs[i]), lens)
            if logger.is_due(i + 1, steps):  # the fetch waits for the device
                logger.maybe_log_step(
                    step=step_before + i + 1, epoch=epoch, batch=i,
                    batch_count=steps, cost=float(cost),
                )
        if cost is not None:
            self.last_cost = float(cost)

    def run(self, epochs: int | None = None) -> dict:
        cfg = self.config
        epochs = cfg.epochs if epochs is None else epochs
        logger = StepLogger(freq=cfg.log_frequency, print_fn=self.print_fn)
        perplexity = float("nan")
        for epoch in range(epochs):
            self.run_epoch(epoch, logger)
            perplexity = self.evaluate("validation")
            logger.log_epoch_metric("Test-Perplexity", perplexity)
            self.history.append(
                {"epoch": epoch + 1, "perplexity": perplexity, "step": self.global_step}
            )
        final_cost = float(self.last_cost) if self.last_cost is not None else float("nan")
        logger.log_final(cost=final_cost)
        return {
            "perplexity": perplexity,
            "final_cost": final_cost,
            "global_step": self.global_step,
        }
