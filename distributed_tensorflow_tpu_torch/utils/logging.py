"""stdout log lines in the reference's exact wording and cadence.

Counterpart of ``distributed_tensorflow_tpu/utils/logging.py``
``StepLogger``:

- every ``freq`` batches: ``Step: N,  Epoch: E,  Batch: B of T,  Cost: C,
  AvgTime: Xms`` (reference ``tfdist_between.py:102-106``)
- every epoch: ``Test-Accuracy: A`` / ``Total Time: Ts``, or for the LM
  ``Test-Perplexity: P`` / ``Total Time: Ts`` (``log_epoch_metric``)
- at the end: ``Final Cost: C`` / ``Done``

Each line is rendered FROM a journal event: ``StepLogger`` builds the
typed event (``step`` / ``epoch`` / ``final``), emits it through its
journal (the process default, a no-op ``NullJournal`` unless one was
configured) and prints ``observability.format``'s rendering of it, so the
bytes are the JAX package's and the journal is a superset of stdout. The
logger takes host numbers only: the trainers fetch a cost once where a
line is due and hand the float over.
"""

from __future__ import annotations

import time

from distributed_tensorflow_tpu_torch.observability import format as obs_format
from distributed_tensorflow_tpu_torch.observability import journal as obs_journal


class StepLogger:
    """Hot-loop logger with the reference's cadence and wording."""

    def __init__(self, freq: int = 100, print_fn=print, journal=None):
        self.freq = freq
        self._print = print_fn
        self.journal = journal if journal is not None else obs_journal.get_journal()
        self._begin_time = time.time()
        self._window_start = time.time()
        self._window_count = 0

    def reset_window(self) -> None:
        self._window_start = time.time()
        self._window_count = 0

    def is_due(self, count: int, batch_count: int) -> bool:
        """The reference's cadence; the trainer gates its host sync on it."""
        return count % self.freq == 0 or count == batch_count

    def _emit(self, kind: str, **fields) -> dict:
        """Journal the event and print its rendering."""
        return obs_format.emit_line(kind, journal=self.journal, print_fn=self._print, **fields)

    def log_step_line(self, *, step, epoch, batch, batch_count, cost, avg_ms) -> None:
        # The event carries the printed (1-based) epoch and batch numbers.
        self._emit(
            "step", step=int(step), epoch=int(epoch) + 1, batch=int(batch) + 1,
            batch_count=int(batch_count), cost=float(cost), avg_ms=float(avg_ms),
        )

    def maybe_log_step(self, *, step, epoch, batch, batch_count, cost) -> None:
        count = batch + 1
        if self.is_due(count, batch_count):
            elapsed = time.time() - self._window_start
            # Average over the batches of this window (the last may be partial).
            window = max(count - self._window_count, 1)
            self.log_step_line(
                step=step, epoch=epoch, batch=batch, batch_count=batch_count,
                cost=cost, avg_ms=float(elapsed * 1000 / window),
            )
            self._window_count = count
            self._window_start = time.time()

    def log_epoch(self, *, test_accuracy: float) -> None:
        self._emit(
            "epoch", metric="Test-Accuracy", value=float(test_accuracy),
            total_time_s=float(time.time() - self._begin_time),
        )

    def log_epoch_metric(self, name: str, value: float) -> None:
        """Epoch line for a metric other than accuracy (the LM's
        perplexity), shaped as the reference's Test-Accuracy / Total Time
        pair."""
        self._emit(
            "epoch", metric=str(name), value=float(value),
            total_time_s=float(time.time() - self._begin_time),
        )

    def log_final(self, *, cost: float) -> None:
        self._emit("final", cost=float(cost))
