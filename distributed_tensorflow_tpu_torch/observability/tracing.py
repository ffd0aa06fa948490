"""Trace ids: join every journal event of one logical operation.

Counterpart of ``distributed_tensorflow_tpu/observability/tracing.py``. A
trace id names one operation (a serving request, a trainer run, a gang
incarnation), and every journal event that belongs to it carries
``trace=<id>``. Two ways to propagate it:

- **explicit**: a component that interleaves many operations on one thread
  stores ``new_trace_id()`` per operation and passes ``trace=...`` to its
  emits;
- **ambient**: ``with tracing.trace():`` installs a thread-local current
  trace, and every journal emit on that thread is tagged with it by
  :meth:`journal.NullJournal.emit`. An explicit ``trace=`` field wins.

Ids are 16 hex characters from ``os.urandom``: unique across ranks with no
shared counter. Standard library only.
"""

from __future__ import annotations

import binascii
import os
import threading

_local = threading.local()


def new_trace_id() -> str:
    """A fresh 64-bit trace id (16 hex characters)."""
    return binascii.hexlify(os.urandom(8)).decode("ascii")


def current_trace() -> str | None:
    """The innermost ambient trace id on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


class trace:
    """Context manager installing an ambient trace id on this thread::

        with tracing.trace() as tid:       # or tracing.trace("fixed-id")
            journal.emit("step", ...)       # carries trace=tid

    Nests (an inner trace shadows an outer one) and never leaks across
    threads (each has its own stack)."""

    def __init__(self, trace_id: str | None = None):
        self.trace_id = trace_id if trace_id is not None else new_trace_id()

    def __enter__(self) -> str:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self.trace_id)
        return self.trace_id

    def __exit__(self, *exc) -> None:
        _local.stack.pop()
