"""stdout log lines in the reference's exact wording and cadence.

Counterpart of ``distributed_tensorflow_tpu/utils/logging.py``
``StepLogger``, with its own copy of the three renderers it needs from
``observability/format.py`` (``_step``, ``_epoch``, ``_final``), so the
lines are byte-identical to the JAX package's:

- every ``freq`` batches: ``Step: N,  Epoch: E,  Batch: B of T,  Cost: C,
  AvgTime: Xms``
- every epoch: ``Test-Accuracy: A`` / ``Total Time: Ts``
- at the end: ``Final Cost: C`` / ``Done``

The JAX logger also journals each line as an event; the port has no
journal yet (ROADMAP A8).
"""

from __future__ import annotations

import time


def _step(ev: dict) -> str:
    # %-formatting reproduces the reference's %2d/%3d/%3.2f padding.
    return (
        "Step: %d,  Epoch: %2d,  Batch: %3d of %3d,  Cost: %.4f,"
        "  AvgTime: %3.2fms"
        % (ev["step"], ev["epoch"], ev["batch"], ev["batch_count"],
           ev["cost"], ev["avg_ms"])
    )


def _epoch(ev: dict) -> list[str]:
    metric = ev.get("metric", "Test-Accuracy")
    if metric == "Test-Accuracy":
        head = "Test-Accuracy: %2.2f" % ev["value"]
    else:
        head = "%s: %.4f" % (metric, ev["value"])
    return [head, "Total Time: %3.2fs" % ev["total_time_s"]]


def _final(ev: dict) -> list[str]:
    return ["Final Cost: %.4f" % ev["cost"], "Done"]


RENDERERS = {"step": _step, "epoch": _epoch, "final": _final}


def render(kind: str, ev: dict) -> list[str]:
    out = RENDERERS[kind](ev)
    return [out] if isinstance(out, str) else list(out)


class StepLogger:
    """Hot-loop logger with the reference's cadence and wording."""

    def __init__(self, freq: int = 100, print_fn=print):
        self.freq = freq
        self._print = print_fn
        self._begin_time = time.time()
        self._window_start = time.time()
        self._window_count = 0

    def reset_window(self) -> None:
        self._window_start = time.time()
        self._window_count = 0

    def is_due(self, count: int, batch_count: int) -> bool:
        """The reference's cadence; the trainer gates its host sync on it."""
        return count % self.freq == 0 or count == batch_count

    def _emit(self, kind: str, **fields) -> None:
        for line in render(kind, fields):
            self._print(line)

    def log_step_line(self, *, step, epoch, batch, batch_count, cost, avg_ms) -> None:
        # Printed epoch and batch numbers are 1-based.
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

    def log_final(self, *, cost: float) -> None:
        self._emit("final", cost=float(cost))
