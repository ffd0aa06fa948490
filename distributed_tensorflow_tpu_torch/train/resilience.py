"""Resilience layer of the port: durable checkpoints, preemption, anomaly
rollback.

Counterpart of ``distributed_tensorflow_tpu/train/resilience.py``, with the
same contracts:

- **Durable checkpoints.** Every ``step_N`` save commits a manifest
  sidecar (``step_N.manifest.json``, written atomically through a tmp name
  and ``os.replace``) carrying a CRC32C of each state leaf in memory and
  the size and CRC32C of each file on disk. A checkpoint whose manifest
  does not verify is known-bad, and restore falls back to the newest step
  that verifies (``Supervisor.prepare_or_restore``); a step with no
  manifest is trusted. The CRC is the port's native runtime
  (``runtime/native.py``, built from ``runtime/csrc/dtf_crc32c.cc``), with
  the pure table of ``utils/summary.py`` as the fallback: both give the
  same value, so a manifest written with one verifies with the other.
- **Preemption.** :func:`preemption_guard` turns SIGTERM/SIGINT into
  ``Supervisor.request_stop``, so both trainers leave their loop at the
  next epoch or dispatch boundary with a final save, and the process exits
  0; the first signal also persists the newest host snapshot
  (``Supervisor.emergency_save``), and a second signal takes the previous
  disposition.
- **Anomaly rollback.** :class:`AnomalyGuard` judges each epoch's cost
  (NaN/inf, or a spike against the median of a trailing window); the
  trainers restore the newest valid checkpoint, leave the data stream where
  it is (the offending window is skipped, never replayed) and retry, up to
  ``max_rollbacks`` times, each with a ``Rollback:`` line and a
  ``rollback`` tfevents scalar.

Checkpoint I/O retries with exponential backoff (:func:`retry_io`).

**Leaf names.** :func:`named_leaves` walks a port state as the JAX
package's ``jtu.keystr`` walks its pytree: a NamedTuple field is
``.field``, a tuple or list entry ``[i]``, a dict entry ``['key']``; None
is no leaf. The parameters of a ``TrainState`` are ``.params.w1``,
``.params.blocks.wq``, ..., and the step is ``.step``, an int32 scalar (an
int32 ``[n]`` vector of every copy's count under async), as in JAX. So for
one state (``convert.py`` carries it across), the port's ``.params.*`` and
``.step`` records equal JAX's ``leaf_checksums`` bit for bit. The optimizer
slots keep the port's names: ``ops/optim.AdamState`` gives
``.opt_state.count``, ``.opt_state.mu.*`` and ``.opt_state.nu.*`` where
optax has ``.opt_state[0].count``, ``.opt_state[0].mu.*`` and
``.opt_state[0].nu.*``; a host int of the state (the accumulator's
``mini_step``) is an int64 scalar. A leaf's CRC is over its raw bytes
(a bf16 or fp8 tensor through a byte view, never a float round trip) and
its dtype is numpy's name (``float32``, ``bfloat16``, ``float8_e4m3fn``).
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import threading
import time
from collections.abc import Mapping

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.train import failpoints

MANIFEST_FORMAT = "dtf-checkpoint-manifest-v1"

# ---------------------------------------------------------------------------
# CRC32C: the native runtime, the pure-Python table as the fallback.
# ---------------------------------------------------------------------------

_crc_impl = None


def _crc32c_bytes(data: bytes) -> int:
    """CRC32C of a byte string: the native runtime when its library loads,
    else the pure-Python table of utils/summary.py (the same value)."""
    global _crc_impl
    if _crc_impl is None:
        try:
            from distributed_tensorflow_tpu_torch.runtime.native import crc32c

            crc32c(b"probe")  # load (or build) the library now
            _crc_impl = crc32c
        except (ImportError, OSError):
            from distributed_tensorflow_tpu_torch.utils.summary import crc32c

            _crc_impl = crc32c
    return _crc_impl(data)


_buf_impl = None


def host_bytes(a) -> np.ndarray:
    """The raw bytes of a tensor (any device, any dtype: bf16 and fp8
    through a byte view, no float round trip), a numpy array or a scalar,
    as a contiguous uint8 array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def crc32c_array(a) -> int:
    """CRC32C of an array's buffer (row-major): a tensor (fetched to the
    host), a numpy array or a scalar. The native buffer kernel reads it in
    place when the library is there."""
    global _buf_impl
    host = host_bytes(a)
    if _buf_impl is None:
        try:
            from distributed_tensorflow_tpu_torch.runtime.native import crc32c_buffer

            crc32c_buffer(np.zeros(1, np.uint8))  # load (or build) the library now
            _buf_impl = crc32c_buffer
        except (ImportError, OSError):
            _buf_impl = lambda arr: _crc32c_bytes(arr.tobytes())  # noqa: E731
    return _buf_impl(host)


def crc32c_file(path: str) -> int:
    with open(path, "rb") as f:
        return _crc32c_bytes(f.read())


# ---------------------------------------------------------------------------
# Leaf names (the JAX keystr walk) and dtype names.
# ---------------------------------------------------------------------------


def named_leaves(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``[(keystr, leaf), ...]`` of a state in the JAX ``keystr`` order
    and spelling (module docstring). A ``TrainState``'s step becomes an
    int32 scalar (a tuple of counts an int32 vector); a host int elsewhere
    stays an int (stored as an int64 scalar); None is no leaf. A flat
    ``{name: leaf}`` mapping whose keys are already keystrs is taken as
    it is."""
    if isinstance(tree, Mapping) and all(isinstance(k, str) and k[:1] in ".["
                                         for k in tree):
        return list(tree.items())
    out: list = []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            sub = getattr(tree, name)
            path = f"{prefix}.{name}"
            if name == "step" and prefix == "" and tree._fields[:2] == ("params", "opt_state"):
                out.append((path, _step_array(sub)))
            else:
                out.extend(named_leaves(sub, path))
    elif isinstance(tree, (tuple, list)):
        for i, sub in enumerate(tree):
            out.extend(named_leaves(sub, f"{prefix}[{i}]"))
    elif isinstance(tree, Mapping):
        for k, sub in tree.items():
            out.extend(named_leaves(sub, f"{prefix}[{k!r}]"))
    elif tree is not None:
        out.append((prefix, tree))
    return out


def _step_array(step) -> np.ndarray:
    """A TrainState's step as JAX holds it: an int32 scalar, or an int32
    [n] vector of every copy's count (async)."""
    if isinstance(step, torch.Tensor):
        return step.detach().cpu().numpy().astype(np.int32)
    return np.asarray(step, dtype=np.int32)


def dtype_name(a) -> str:
    """numpy's name of a leaf's dtype (``float32``, ``bfloat16``,
    ``float8_e4m3fn``; torch's ``torch.`` prefix dropped)."""
    if isinstance(a, torch.Tensor):
        return str(a.dtype).removeprefix("torch.")
    if isinstance(a, (bool, int)) and not isinstance(a, np.generic):
        return "int64"
    return str(np.asarray(a).dtype)


def _shape(a) -> list:
    return list(a.shape) if hasattr(a, "shape") else []


# ---------------------------------------------------------------------------
# Manifest write / verify.
# ---------------------------------------------------------------------------


def write_json_atomic(path: str, obj: dict) -> None:
    """Atomic JSON write (tmp name + ``os.replace``): a reader never sees
    a torn file, and a writer killed mid-write leaves only a ``.tmp``. The
    checkpoint manifests and the layout sidecars write through here.

    Failpoints: ``atomic.write`` at entry (+ tear of the committed file),
    ``atomic.write.commit`` between the tmp write and the replace (a kill
    there leaves only a ``.tmp`` orphan for :func:`sweep_tmp_orphans`)."""
    failpoints.fire("atomic.write")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f)
    failpoints.fire("atomic.write.commit")
    os.replace(tmp, path)
    failpoints.tear("atomic.write", path)


def sweep_tmp_orphans(dirpath: str, *, age_s: float = 60.0, now=None) -> list[str]:
    """Remove stale ``.tmp`` orphans left by writers killed mid-write.
    Age-guarded: only files whose mtime is older than ``age_s`` go, so a
    live writer's file is never swept. Returns the removed paths."""
    removed: list[str] = []
    cutoff = (time.time() if now is None else now) - age_s
    try:
        names = os.listdir(dirpath)
    except OSError:
        return removed
    for name in names:
        if ".tmp" not in name:
            continue
        p = os.path.join(dirpath, name)
        try:
            if os.path.getmtime(p) <= cutoff and os.path.isfile(p):
                os.remove(p)
                removed.append(p)
        except OSError:
            continue  # a racing writer committed or removed it
    return removed


def manifest_path(checkpoint_dir: str, step: int) -> str:
    return os.path.join(checkpoint_dir, f"step_{step}.manifest.json")


def leaf_checksums(state) -> tuple[dict, bool]:
    """Per-leaf CRC32C of a state: ``{keystr: {crc32c, shape, dtype}}``
    (:func:`named_leaves`). Every leaf of a port state is whole on this
    process (a multi-rank save gathers first), so the second value, JAX's
    "complete" flag, is True."""
    leaves: dict = {}
    for name, leaf in named_leaves(state):
        leaves[name] = {
            "crc32c": crc32c_array(leaf),
            "shape": _shape(leaf) if hasattr(leaf, "shape") else list(np.shape(leaf)),
            "dtype": dtype_name(leaf),
        }
    return leaves, True


def _file_records(root: str) -> dict:
    out: dict = {}
    for dirpath, _, files in os.walk(root):
        for fname in files:
            p = os.path.join(dirpath, fname)
            out[os.path.relpath(p, root)] = {
                "size": os.path.getsize(p),
                "crc32c": crc32c_file(p),
            }
    return out


def write_manifest(checkpoint_dir: str, step: int, state=None) -> dict:
    """Commit the durability record of ``step_N``: the size and CRC of
    every file in the step's directory, the CRC of each leaf of the state
    in memory (when given) and the layout sidecar's record when there is
    one. Its presence marks a committed checkpoint.

    Failpoint ``ckpt.manifest``: fire at entry, tear of the committed
    manifest after (restore must then fall back to the newest step that
    verifies)."""
    failpoints.fire("ckpt.manifest")
    step_dir = os.path.join(checkpoint_dir, f"step_{step}")
    manifest: dict = {
        "format": MANIFEST_FORMAT,
        "step": int(step),
        "files": _file_records(step_dir),
        "sidecars": {},
    }
    layout_side = os.path.join(checkpoint_dir, f"step_{step}.layout.json")
    if os.path.exists(layout_side):
        manifest["sidecars"][os.path.basename(layout_side)] = {
            "size": os.path.getsize(layout_side),
            "crc32c": crc32c_file(layout_side),
        }
    if state is not None:
        manifest["leaves"], manifest["leaves_complete"] = leaf_checksums(state)
    write_json_atomic(manifest_path(checkpoint_dir, step), manifest)
    failpoints.tear("ckpt.manifest", manifest_path(checkpoint_dir, step))
    return manifest


def load_manifest(checkpoint_dir: str, step: int) -> dict | None:
    """The committed manifest of ``step_N``, or None when there is none. A
    manifest that is there but does not parse raises ValueError."""
    path = manifest_path(checkpoint_dir, step)
    try:
        with open(path) as f:
            return json.load(f)
    except OSError:
        return None
    except ValueError as exc:
        raise ValueError(f"corrupt checkpoint manifest {path}: {exc}") from exc


def verify_files(checkpoint_dir: str, step: int) -> bool | None:
    """``step_N``'s bytes on disk against its manifest: True (verified),
    False (known-bad: a missing, truncated or flipped file, or a corrupt
    manifest), None (no manifest: unverifiable; callers decide)."""
    try:
        manifest = load_manifest(checkpoint_dir, step)
    except ValueError:
        return False
    if manifest is None:
        return None
    step_dir = os.path.join(checkpoint_dir, f"step_{step}")
    for rel, rec in manifest.get("files", {}).items():
        p = os.path.join(step_dir, rel)
        if not os.path.isfile(p) or os.path.getsize(p) != rec["size"]:
            return False
        if crc32c_file(p) != rec["crc32c"]:
            return False
    for name, rec in manifest.get("sidecars", {}).items():
        p = os.path.join(checkpoint_dir, name)
        if not os.path.isfile(p) or os.path.getsize(p) != rec["size"]:
            return False
        if crc32c_file(p) != rec["crc32c"]:
            return False
    return True


def verify_leaves(state, manifest: dict) -> bool:
    """The restored state's per-leaf CRCs against the manifest: catches a
    corruption the file pass cannot see and skew between manifest and
    data. Leaves the manifest does not record pass."""
    recorded = manifest.get("leaves")
    if not recorded:
        return True
    for name, leaf in named_leaves(state):
        rec = recorded.get(name)
        if rec is None:
            continue
        if crc32c_array(leaf) != rec["crc32c"]:
            return False
    return True


# ---------------------------------------------------------------------------
# The async checkpoint writer: the background half of the save pipeline.
# ---------------------------------------------------------------------------


class AsyncCheckpointWriter:
    """Depth-1 background checkpoint writer. The training loop hands a
    write closure over a host snapshot to :meth:`submit` and goes on; one
    daemon thread serializes, checksums and commits exactly as the
    synchronous path does (the closure is that path).

    At most one write in flight and one queued: a submit while a write is
    queued but not started replaces it (``superseded`` counts the drops),
    so a slow disk gets the newest snapshot, never a backlog.
    :meth:`wait_pending` blocks until everything submitted has committed:
    the final-save drain, and the barrier every restore entry point takes
    (a step directory in flight has no manifest yet).

    A write that raises does not kill the writer: the error is kept and
    raised at the next :meth:`wait_pending` / :meth:`raise_deferred`.
    Failpoint ``ckpt.async`` fires on the writer thread before each write
    (``raise``: the queued step never lands; ``kill``: the crash mid-write;
    ``delay`` makes supersession deterministic in tests)."""

    def __init__(self, *, name: str = "ckpt-writer"):
        self._cond = threading.Condition()
        self._pending = None  # (tag, fn) queued, not yet started
        self._in_flight = False
        self._error: BaseException | None = None
        self._closed = False
        self.superseded = 0
        self._thread = threading.Thread(target=self._worker, name=name, daemon=True)
        self._thread.start()

    def submit(self, fn, *, tag=None) -> None:
        """Queue ``fn``, replacing a queued write not started yet; never
        blocks on I/O."""
        with self._cond:
            if self._closed:
                raise RuntimeError("AsyncCheckpointWriter is closed")
            if self._pending is not None:
                self.superseded += 1
            self._pending = (tag, fn)
            self._cond.notify_all()

    def _worker(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    self._cond.wait()
                if self._pending is None:
                    return
                _tag, fn = self._pending
                self._pending = None
                self._in_flight = True
            try:
                failpoints.fire("ckpt.async")
                fn()
            except BaseException as exc:  # noqa: BLE001 — raised at the next wait
                with self._cond:
                    self._error = exc
            finally:
                with self._cond:
                    self._in_flight = False
                    self._cond.notify_all()

    def raise_deferred(self) -> None:
        """Raise (and clear) a kept writer error; does not block."""
        with self._cond:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def wait_pending(self) -> None:
        """Block until every submitted write has committed, then raise a
        kept writer error."""
        with self._cond:
            while self._pending is not None or self._in_flight:
                self._cond.wait()
        self.raise_deferred()

    @property
    def busy(self) -> bool:
        with self._cond:
            return self._pending is not None or self._in_flight

    def close(self) -> None:
        """Drain and stop the writer thread."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self.wait_pending()
        self._thread.join(timeout=30)


# ---------------------------------------------------------------------------
# Progress heartbeat file and the stall dump.
# ---------------------------------------------------------------------------


def touch_heartbeat(path: str) -> bool:
    """Bump a worker heartbeat file's mtime (creating it at the first
    beat). Returns False, never raises, on an I/O failure: a heartbeat
    must not kill the run it watches."""
    if not path:
        return False
    try:
        os.utime(path)
        return True
    except FileNotFoundError:
        try:
            with open(path, "a", encoding="utf-8"):
                pass
            return True
        except OSError:
            return False
    except OSError:
        return False


_stall_dump_file = None  # the fd faulthandler writes to, kept open


def arm_stall_dump(path: str | None = None) -> str | None:
    """Register a ``faulthandler`` dump of every thread's stack on SIGUSR1,
    appended to ``path`` (default ``$DTF_STALL_DUMP``; unset or empty =
    not armed). Returns the armed path or None."""
    global _stall_dump_file
    if path is None:
        path = os.environ.get("DTF_STALL_DUMP", "")
    if not path:
        return None
    import faulthandler

    try:
        f = open(path, "a", encoding="utf-8")
        faulthandler.register(signal.SIGUSR1, file=f, all_threads=True, chain=False)
    except (OSError, ValueError, AttributeError):  # pragma: no cover — no SIGUSR1
        return None
    _stall_dump_file = f
    return path


def disarm_stall_dump() -> None:
    """Unregister the SIGUSR1 dump and close its file; safe when never
    armed."""
    global _stall_dump_file
    import faulthandler

    try:
        faulthandler.unregister(signal.SIGUSR1)
    except (ValueError, AttributeError):  # pragma: no cover — no SIGUSR1
        pass
    if _stall_dump_file is not None:
        try:
            _stall_dump_file.close()
        except OSError:  # pragma: no cover
            pass
        _stall_dump_file = None


# ---------------------------------------------------------------------------
# Bounded retry with exponential backoff: the one retry implementation.
# ---------------------------------------------------------------------------


def backoff_delay(attempt: int, *, backoff: float, max_backoff: float = 30.0,
                  jitter: float = 0.0, rng=None) -> float:
    """The delay before retry ``attempt + 1``: ``min(backoff * 2**attempt,
    max_backoff)``, times ``1 + jitter*u`` with ``u`` uniform in [0, 1)."""
    if rng is None:
        import random as _random

        rng = _random
    delay = min(backoff * (2**attempt), max_backoff)
    if jitter:
        delay *= 1.0 + jitter * rng.random()
    return delay


def retry(fn, *, attempts: int = 3, backoff: float = 0.25, max_backoff: float = 30.0,
          jitter: float = 0.0, retry_on: tuple = (OSError,), describe: str = "operation",
          on_retry=None, sleep=time.sleep, rng=None):
    """``fn`` with bounded retry and exponential backoff (:func:`backoff_delay`);
    the last failure re-raises. ``on_retry(exc, attempt, delay)`` fires
    before each sleep; ``sleep`` and ``rng`` are injectable."""
    last = None
    for attempt in range(max(1, attempts)):
        try:
            return fn()
        except retry_on as exc:  # noqa: PERF203 — a retry loop
            last = exc
            if attempt + 1 >= attempts:
                raise
            delay = backoff_delay(attempt, backoff=backoff, max_backoff=max_backoff,
                                  jitter=jitter, rng=rng)
            if on_retry is not None:
                on_retry(exc, attempt, delay)
            sleep(delay)
    raise last  # pragma: no cover — the loop raises


def retry_io(fn, *, attempts: int = 3, backoff: float = 0.25, retry_on: tuple = (OSError,),
             describe: str = "checkpoint I/O", jitter: float = 0.0, rng=None, sleep=time.sleep):
    """The checkpoint-I/O form of :func:`retry` (jitter off by default)."""
    return retry(fn, attempts=attempts, backoff=backoff, retry_on=retry_on, describe=describe,
                 jitter=jitter, rng=rng, sleep=sleep)


# ---------------------------------------------------------------------------
# Preemption: SIGTERM/SIGINT → request_stop → boundary exit + final save.
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def preemption_guard(supervisor, *, enabled: bool = True, print_fn=print, journal=None):
    """SIGTERM/SIGINT handlers for the length of a run: the first signal
    calls ``supervisor.request_stop()`` (the loop leaves at the next
    boundary, whose save is the final checkpoint), persists the newest
    host snapshot through ``supervisor.emergency_save()`` (the
    ``Preemption:`` line then carries ``saved_step``), and puts the previous
    handlers back, so a second signal takes the old disposition.

    The handler prints the ``Preemption:`` line with no journal I/O (a
    signal can land in the middle of a journal write) and journals the
    event when the guard exits. A no-op (yields None) when disabled or with
    no supervisor; off the main thread, where Python delivers no signals,
    it emits one ``Preemption: disarmed (non-main thread)`` line."""
    from distributed_tensorflow_tpu_torch.observability import format as obs_format
    from distributed_tensorflow_tpu_torch.observability import journal as obs_journal

    if not enabled or supervisor is None:
        yield None
        return
    if threading.current_thread() is not threading.main_thread():
        j = journal if journal is not None else obs_journal.get_journal()
        obs_format.emit_line("preemption", journal=j, print_fn=print_fn,
                             disarmed="non-main thread")
        yield None
        return
    prev: dict = {}

    def _restore():
        while prev:
            sig, old = prev.popitem()
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):  # pragma: no cover
                pass

    pending: list[dict] = []

    def _handler(signum, frame):
        supervisor.request_stop()
        saved_step = None
        emergency = getattr(supervisor, "emergency_save", None)
        if emergency is not None:
            try:
                saved_step = emergency()
            except Exception:  # noqa: BLE001 — best effort in a handler
                saved_step = None
        extra = {} if saved_step is None else {"saved_step": int(saved_step)}
        ev = obs_format.emit_line("preemption", journal=obs_journal.NullJournal(),
                                  print_fn=print_fn, signal=int(signum), **extra)
        pending.append({k: v for k, v in ev.items() if k not in ("ts", "kind")})
        _restore()

    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[sig] = signal.signal(sig, _handler)
            except (ValueError, OSError):  # pragma: no cover
                pass
        yield _handler
    finally:
        _restore()
        if pending:
            j = journal if journal is not None else obs_journal.get_journal()
            for fields in pending:
                j.emit("preemption", **fields)


# ---------------------------------------------------------------------------
# The anomaly guard (NaN/inf, and a spike against a trailing window).
# ---------------------------------------------------------------------------


class AnomalyError(RuntimeError):
    """An anomalous cost with no rollback budget (or no checkpoint) left."""


class AnomalyGuard:
    """Per-epoch cost monitor. :meth:`classify` returns ``"nan"`` for any
    non-finite cost of the epoch, ``"spike"`` when the epoch's cost is past
    ``spike_threshold`` times the median of the last ``window`` good
    epochs (once a full window is there), else None. :meth:`record` feeds
    the window with the epochs that passed only."""

    def __init__(self, *, window: int = 8, spike_threshold: float = 3.0,
                 max_rollbacks: int = 3):
        self.window = max(1, int(window))
        self.spike_threshold = float(spike_threshold)
        self.max_rollbacks = int(max_rollbacks)
        self.history: list[float] = []
        self.rollbacks = 0

    @classmethod
    def from_config(cls, config) -> "AnomalyGuard | None":
        """``max_rollbacks=0`` turns the guard off; ``spike_threshold=0``
        keeps the NaN/inf check only."""
        if not getattr(config, "max_rollbacks", 0):
            return None
        return cls(window=config.anomaly_window, spike_threshold=config.spike_threshold,
                   max_rollbacks=config.max_rollbacks)

    def classify(self, cost: float, costs=None) -> str | None:
        vals = np.asarray(costs if costs is not None else [cost], np.float64)
        if not np.all(np.isfinite(vals)) or not np.isfinite(cost):
            return "nan"
        if self.spike_threshold > 0 and len(self.history) >= self.window:
            ref = float(np.median(self.history[-self.window:]))
            if ref > 0 and cost > self.spike_threshold * ref:
                return "spike"
        return None

    def record(self, cost: float) -> None:
        self.history.append(float(cost))

    @property
    def exhausted(self) -> bool:
        return self.rollbacks >= self.max_rollbacks
