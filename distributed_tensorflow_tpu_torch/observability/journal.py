"""Structured event journal: typed, append-only JSONL.

Counterpart of ``distributed_tensorflow_tpu/observability/journal.py``. The
reference's only machine surface was stdout (``tfdist_between.py:98-110``);
here every structured signal (the Step/Epoch/Final lines, metrics
snapshots, host spans, communication accounting, fired failpoints) is ONE
JSON object a line in ``<logdir>/events.jsonl``, tagged with wall time,
rank/world, a run id and, when a trace is active, the trace id
(:mod:`~.tracing`).

One event is one ``os.write()`` of one ``\\n``-terminated line on an
``O_APPEND`` descriptor, so concurrent writers interleave whole lines,
never bytes (a buffered stream would split a write past its buffer).
:func:`read_events` skips a torn final line (a writer killed mid-append)
and raises on a torn line anywhere else.

Rotation (off by default): ``EventJournal(rotate_bytes=N)`` renames the
active file to ``events.jsonl.<k>`` (``.1`` oldest) when an append would
push it past N bytes; :func:`read_events` and :func:`journal_segments` span
the chain. It is a single-writer feature. The ``journal.append`` and
``journal.rotate`` failpoints (``train/failpoints.py``) sit before the
write and at the rotation.

The trainers print their lines through :mod:`~.format` FROM these events,
so the journal is a superset of stdout. A field that is a tensor on a
device is refused (a journal write must never be what synchronizes the
card): callers journal values they have already fetched. Standard library
only: importing this imports no ``torch``.
"""

from __future__ import annotations

import json
import os
import re
import time

from distributed_tensorflow_tpu_torch.observability import tracing
from distributed_tensorflow_tpu_torch.train import failpoints

_SEGMENT = re.compile(r"\.(\d+)$")


class NullJournal:
    """The unconfigured default: ``emit`` builds and returns the event
    dict (so renderers can still format lines from it) but writes
    nothing. Trainers construct their log lines through this path even
    when no journal is attached — one code path, zero I/O."""

    path = None

    def emit(self, kind: str, **fields) -> dict:
        ev = {"ts": time.time(), "kind": kind}
        ambient = tracing.current_trace()
        if ambient is not None and "trace" not in fields:
            ev["trace"] = ambient
        ev.update(fields)
        return ev

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "NullJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class EventJournal(NullJournal):
    """Append-only JSONL event stream.

    Every event carries ``ts`` (wall clock), ``kind``, and — when set —
    ``rank``/``world``/``run`` tags, the ambient trace id
    (:mod:`~.tracing`, unless an explicit ``trace=`` field overrides),
    then the caller's fields. Field values must be JSON-serializable (the
    writer coerces numpy scalars and host tensors through ``item()`` and
    refuses a tensor on a device)."""

    def __init__(
        self,
        path: str,
        *,
        rank: int | None = None,
        world: int | None = None,
        run_id: str | None = None,
        rotate_bytes: int = 0,
        fsync: bool = False,
        clock=time.time,
    ):
        self.path = path
        self.rank = rank
        self.world = world
        self.run_id = run_id
        # Opt-in (DTF_JOURNAL_FSYNC=1): fsync after every append, so a
        # kill inside emit() cannot lose the final line. Off by default:
        # the bytes are the same, only their durability timing changes.
        self.fsync = bool(fsync)
        self.rotate_bytes = int(rotate_bytes)
        if self.rotate_bytes < 0:
            raise ValueError(
                f"rotate_bytes must be >= 0 (0 disables), got {rotate_bytes}"
            )
        self._clock = clock
        self._fd = None
        self._size = 0
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)

    @classmethod
    def in_dir(cls, logdir: str, **kw) -> "EventJournal":
        """The conventional location: ``<logdir>/events.jsonl``."""
        return cls(os.path.join(logdir, "events.jsonl"), **kw)

    def _file(self) -> int:
        if self._fd is None:
            # O_APPEND: the kernel serializes whole-buffer appends, so
            # multi-process journals interleave whole lines — provided
            # each line is ONE os.write (see the module docstring).
            self._fd = os.open(
                self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
            )
            self._size = os.fstat(self._fd).st_size
        return self._fd

    @staticmethod
    def _default(o):
        # numpy scalars/arrays (and host tensors) without importing either:
        # anything exposing item() (0-d) or tolist() degrades to plain
        # Python. A tensor on a device is refused: its item() would wait
        # for the card, so a journal write would be what pulls the value.
        device = getattr(o, "device", None)
        if getattr(device, "type", "cpu") != "cpu":
            raise TypeError(
                f"event field on {device} is not journaled: fetch it to the "
                "host first (a journal write must not synchronize the device)"
            )
        if hasattr(o, "item") and getattr(o, "ndim", 1) == 0:
            return o.item()
        if hasattr(o, "tolist"):
            return o.tolist()
        raise TypeError(
            f"event field of type {type(o).__name__} is not JSON-serializable"
        )

    def _rotate(self) -> None:
        """Retire the active file as the next ``.k`` segment (``.1`` is
        the oldest). Single-writer only — see the module docstring."""
        failpoints.fire("journal.rotate")
        os.close(self._fd)
        self._fd = None
        taken = [
            int(_SEGMENT.search(seg).group(1))
            for seg in journal_segments(self.path)
            if seg != self.path
        ]
        os.replace(self.path, f"{self.path}.{max(taken, default=0) + 1}")

    def emit(self, kind: str, **fields) -> dict:
        # Failpoint before any I/O; fire() guards its own reentrancy, so
        # the `failpoint` event it journals cannot recurse through here.
        failpoints.fire("journal.append")
        ev: dict = {"ts": self._clock(), "kind": kind}
        if self.rank is not None:
            ev["rank"] = int(self.rank)
        if self.world is not None:
            ev["world"] = int(self.world)
        if self.run_id is not None:
            ev["run"] = self.run_id
        ambient = tracing.current_trace()
        if ambient is not None and "trace" not in fields:
            ev["trace"] = ambient
        ev.update(fields)
        data = (json.dumps(ev, default=self._default) + "\n").encode("utf-8")
        fd = self._file()
        if (
            self.rotate_bytes
            and self._size
            and self._size + len(data) > self.rotate_bytes
        ):
            self._rotate()
            fd = self._file()
        os.write(fd, data)  # ONE write = one line: the atomicity contract
        self._size += len(data)
        if self.fsync:
            self.flush()
        return ev

    def flush(self) -> None:
        if self._fd is not None:
            try:
                os.fsync(self._fd)
            except OSError:  # pragma: no cover — exotic filesystems
                pass

    def close(self) -> None:
        if self._fd is not None:
            self.flush()
            os.close(self._fd)
            self._fd = None


def journal_segments(path: str) -> list[str]:
    """The on-disk chain of one journal, oldest→newest: rotated segments
    ``<path>.1..N`` (numeric order) then the active ``<path>``. Files
    that do not exist are omitted (a never-rotated journal is just
    ``[path]``)."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path)
    nums = []
    if os.path.isdir(parent):
        for name in os.listdir(parent):
            if name.startswith(base + "."):
                m = _SEGMENT.search(name)
                if m and name == f"{base}.{m.group(1)}":
                    nums.append(int(m.group(1)))
    chain = [f"{path}.{n}" for n in sorted(nums)]
    if os.path.exists(path):
        chain.append(path)
    return chain


def _parse_segment(path: str, out: list, *, kind: str | None) -> None:
    with open(path, encoding="utf-8") as f:
        lines = f.read().split("\n")
    # A complete file ends with "\n", so split leaves a trailing "".
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            ev = json.loads(line)
        except ValueError:
            if i == len(lines) - 1:
                continue  # torn tail: the writer died mid-line
            raise ValueError(f"{path}:{i + 1}: corrupt event line") from None
        if kind is None or ev.get("kind") == kind:
            out.append(ev)


def read_events(path: str, *, kind: str | None = None) -> list[dict]:
    """Parse an ``events.jsonl`` (or a logdir containing one), spanning
    rotated segments (``events.jsonl.1..N`` oldest-first, then the active
    file) transparently. A torn final line — a writer killed mid-append —
    is skipped silently; a torn line anywhere else raises (that is
    corruption, not a crash tail). ``kind`` filters."""
    if os.path.isdir(path):
        path = os.path.join(path, "events.jsonl")
    segments = journal_segments(path)
    if not segments:
        # Preserve the single-file error shape for a missing journal.
        with open(path, encoding="utf-8"):
            pass  # pragma: no cover — open() raises above
    out: list[dict] = []
    for seg in segments:
        _parse_segment(seg, out, kind=kind)
    return out


def append_event(path: str, kind: str, **fields) -> dict:
    """One-shot append (open → emit → close) for a tool that records a
    single measurement: a crash between points never holds a descriptor
    open."""
    j = EventJournal(path)
    try:
        return j.emit(kind, **fields)
    finally:
        j.close()


# -- module default (process-wide wiring) -----------------------------------

_default: NullJournal = NullJournal()


def configure(
    logdir: str | None = None,
    *,
    path: str | None = None,
    rank: int | None = None,
    world: int | None = None,
    run_id: str | None = None,
    rotate_bytes: int = 0,
    fsync: bool = False,
) -> NullJournal:
    """Install the process-default journal (``<logdir>/events.jsonl``, or
    an explicit ``path``). Components that were not handed a journal
    explicitly fall back to this one; with neither, emission is a no-op
    (:class:`NullJournal`)."""
    global _default
    if _default is not None:
        _default.close()
    if path is None and logdir is None:
        _default = NullJournal()
    else:
        if path is None:
            path = os.path.join(logdir, "events.jsonl")
        _default = EventJournal(
            path, rank=rank, world=world, run_id=run_id,
            rotate_bytes=rotate_bytes, fsync=fsync,
        )
    return _default


def rank_journal_path(logdir: str, rank: int) -> str:
    """The per-rank journal convention for a gang sharing a logdir:
    ``<logdir>/events-rank<k>.jsonl``. One file per rank keeps rotation
    legal (single writer) and gives :mod:`observability.aggregate` clean
    per-rank timelines to merge; the launcher keeps the plain
    ``events.jsonl``."""
    return os.path.join(logdir, f"events-rank{int(rank)}.jsonl")


def configure_from_env(
    rank: int | None = None, *, announce: bool = True, environ=None
) -> NullJournal:
    """Arm the process-default journal from the environment a launcher
    sets (``cluster.bootstrap`` calls this for every worker):

    - ``DTF_EVENTS_PATH`` — explicit journal path, or
    - ``DTF_JOURNAL_DIR`` — logdir; the journal lands at
      :func:`rank_journal_path` when a rank is known (the ``rank``
      argument, else ``DTF_RANK``), else ``events.jsonl``.

    ``DTF_WORLD_SIZE``/``DTF_RUN_ID`` tag events;
    ``DTF_JOURNAL_ROTATE_BYTES`` arms rotation;
    ``DTF_JOURNAL_FSYNC=1`` arms fsync after every append. With neither
    path knob
    set this is a no-op returning the current default — safe to call
    unconditionally. ``announce=True`` emits a ``worker_start`` event
    (pid + rank), which is how a per-rank journal shows its own restarts:
    every incarnation of the worker announces itself."""
    env = os.environ if environ is None else environ
    path = env.get("DTF_EVENTS_PATH")
    logdir = env.get("DTF_JOURNAL_DIR")
    if not path and not logdir:
        return _default
    if rank is None and env.get("DTF_RANK"):
        rank = int(env["DTF_RANK"])
    if not path:
        path = (
            rank_journal_path(logdir, rank)
            if rank is not None
            else os.path.join(logdir, "events.jsonl")
        )
    world = int(env["DTF_WORLD_SIZE"]) if env.get("DTF_WORLD_SIZE") else None
    j = configure(
        path=path,
        rank=rank,
        world=world,
        run_id=env.get("DTF_RUN_ID"),
        rotate_bytes=int(env.get("DTF_JOURNAL_ROTATE_BYTES", "0") or 0),
        fsync=env.get("DTF_JOURNAL_FSYNC", "") in ("1", "true"),
    )
    if announce:
        j.emit("worker_start", pid=os.getpid())
    return j


def get_journal() -> NullJournal:
    return _default


def emit(kind: str, **fields) -> dict:
    """Emit through the process-default journal."""
    return _default.emit(kind, **fields)
