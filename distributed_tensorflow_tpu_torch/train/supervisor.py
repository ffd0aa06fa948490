"""Supervisor of the port: chief election, restore-or-init, orderly
shutdown, and the durable checkpoints under them.

Counterpart of ``distributed_tensorflow_tpu/train/supervisor.py`` (the
reference's ``tf.train.Supervisor``, ``tfdist_between.py:78,83``), with the
same contracts: chief-only writes; restore-or-init against a checkpoint
directory, newest step first, falling back past a step that fails
verification or restore (a ``RuntimeWarning`` naming it) and raising when
checkpoints exist and none restores; retention that never removes the last
valid step; the layout sidecar; the async save with :meth:`Supervisor.
wait_pending` as the read barrier; the emergency save; the stop flags.

**The on-disk format.** The JAX package writes through orbax, which the
card does not have; the port writes its own, with torch. ``step_N/`` holds
``state.pt``: the state as one flat ``{keystr: CPU tensor}`` dict
(``resilience.named_leaves``: ``.params.w1``, ``.opt_state.mu.w1``,
``.step``, ...) written by ``torch.save``, read back with
``torch.load(weights_only=True)`` and placed on the trainer's device.
Beside it go ``step_N.layout.json`` and ``step_N.manifest.json``, as in
JAX. The state is what the JAX package's checkpoint of the same mode holds,
leaf for leaf and shape for shape (the trainers gather a sharded or
per-rank state first), so the layout sidecar and the manifest's leaf
records compare with JAX's; the files do not: a JAX checkpoint does not
restore here, nor a port checkpoint there. ``torch.save`` of one dict
gives the same bytes each time, so a sync and an async save of one state
give equal file CRCs, not only equal leaf CRCs.

The async snapshot owns its memory: a CPU leaf is cloned (``.cpu()`` of a
CPU tensor is the tensor itself, and the fused MLP path updates its state
in place), a card leaf is copied to fresh host memory by a blocking copy
that has finished when the snapshot is taken. The emergency save of the
signal handler reads only that host snapshot.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import threading
import time
import warnings
from collections.abc import Mapping

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.train import resilience

_STEP_DIR = re.compile(r"^step_(\d+)$")
STATE_FILE = "state.pt"

# Layout-sidecar keys that describe the saved state's SHAPES; everything
# else in the sidecar (world, global_batch, epochs, sync_every) is restore
# policy and must not break same-layout checks. "delta_dtype"/"overlap" are
# shape keys: the DiLoCo residual and in-flight delta are extra nodes of its
# state, present only when the lever is on.
LAYOUT_SHAPE_KEYS = ("mode", "replicas", "stages", "delta_dtype", "overlap")


def layout_shape(layout: dict | None) -> dict:
    """The shape-determining slice of a layout sidecar
    (:data:`LAYOUT_SHAPE_KEYS`)."""
    return {k: v for k, v in (layout or {}).items() if k in LAYOUT_SHAPE_KEYS}


def checkpoint_steps(checkpoint_dir: str | None) -> list[int]:
    """Every ``step_N`` under ``checkpoint_dir``, ascending. Read-only."""
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(checkpoint_dir)
                  if (m := _STEP_DIR.match(d)))


def latest_checkpoint_step(checkpoint_dir: str | None, *, verify: bool = False) -> int | None:
    """Newest ``step_N`` under ``checkpoint_dir``, or None; never creates
    the directory. ``verify=True`` returns the newest step whose files
    pass the manifest check (skipping corrupt, partial and manifest-less
    steps)."""
    steps = checkpoint_steps(checkpoint_dir)
    if not verify:
        return steps[-1] if steps else None
    for step in reversed(steps):
        if resilience.verify_files(checkpoint_dir, step) is True:
            return step
    return None


# ---------------------------------------------------------------------------
# The flat {keystr: tensor} form of a state.
# ---------------------------------------------------------------------------


def flatten_state(state, *, own: bool = False) -> dict:
    """``{keystr: CPU tensor}`` of a state (``resilience.named_leaves``).
    ``own=True`` makes every tensor a copy no one else writes: a CPU leaf
    is cloned, a card leaf copied to host memory (a blocking copy, done on
    return)."""
    out = {}
    for name, leaf in resilience.named_leaves(state):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if t.device.type == "cpu":
                t = t.clone() if own else t
            else:
                t = t.to("cpu")
        elif isinstance(leaf, np.ndarray):
            t = torch.from_numpy(leaf.copy())
        elif isinstance(leaf, int):
            t = torch.tensor(leaf, dtype=torch.int64)
        else:
            raise TypeError(f"checkpoint leaf {name} of type {type(leaf).__name__}")
        out[name] = t
    return out


def unflatten_state(template, flat: Mapping, *, device=None, check_shapes: bool = True):
    """The state of ``template``'s structure from a flat dict: each tensor
    leaf on the template leaf's device (or ``device``), each host int an
    int, a TrainState's ``.step`` an int (a tuple of ints for an [n]
    vector). The dict must hold exactly the template's leaves; with
    ``check_shapes`` each tensor's shape must be the template's (a
    restore into the same layout), else the file's shapes are taken."""
    want = {name for name, _ in resilience.named_leaves(template)}
    if set(flat) != want:
        missing, extra = sorted(want - set(flat)), sorted(set(flat) - want)
        raise ValueError(f"checkpoint leaves differ from the state's: missing {missing[:4]}"
                         f"{'...' if len(missing) > 4 else ''}, unexpected {extra[:4]}"
                         f"{'...' if len(extra) > 4 else ''}")

    def leaf(name, like):
        t = flat[name]
        if isinstance(like, torch.Tensor):
            if check_shapes and tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"checkpoint leaf {name} has shape {tuple(t.shape)}, the "
                                 f"state's {tuple(like.shape)}")
            if t.dtype != like.dtype:
                raise ValueError(f"checkpoint leaf {name} is {t.dtype}, the state's {like.dtype}")
            dev = device if device is not None else (
                like.device if like.device.type != "meta" else "cpu")
            return t.to(dev)
        if isinstance(like, int):
            return int(t)
        return t

    def build(node, prefix):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            vals = []
            for name in node._fields:
                path = f"{prefix}.{name}"
                if name == "step" and prefix == "" and node._fields[:2] == ("params", "opt_state"):
                    s = flat[path]
                    vals.append(int(s) if s.dim() == 0 else tuple(int(x) for x in s.tolist()))
                else:
                    vals.append(build(getattr(node, name), path))
            return type(node)(*vals)
        if isinstance(node, (tuple, list)):
            return type(node)(build(sub, f"{prefix}[{i}]") for i, sub in enumerate(node))
        if isinstance(node, Mapping):
            return {k: build(sub, f"{prefix}[{k!r}]") for k, sub in node.items()}
        if node is None:
            return None
        return leaf(prefix, node)

    return build(template, "")


def read_state(step_dir: str) -> dict:
    """The flat dict of a step directory (``torch.load(weights_only=True)``
    on the CPU)."""
    return torch.load(os.path.join(step_dir, STATE_FILE), map_location="cpu",
                      weights_only=True)


class Supervisor:
    def __init__(
        self,
        *,
        is_chief: bool = True,
        checkpoint_dir: str | None = None,
        keep_last_n: int | None = None,
        io_retries: int = 3,
        io_backoff: float = 0.25,
        async_checkpoint: bool = False,
    ):
        self.is_chief = is_chief
        self.checkpoint_dir = os.path.abspath(checkpoint_dir) if checkpoint_dir else None
        self.keep_last_n = keep_last_n
        self.io_retries = max(1, int(io_retries))
        self.io_backoff = float(io_backoff)
        # The async pipeline: save takes a host snapshot and returns; a
        # depth-1 writer commits the same byte sequence the sync path
        # writes. Off for a bare Supervisor (inference, probes);
        # TrainConfig.async_checkpoint (default on) sets it for trainers.
        self.async_checkpoint = bool(async_checkpoint)
        self._writer = None
        self._write_lock = threading.Lock()
        self._saving = False  # a sync save on the main thread in progress
        self._last_snapshot = None  # (flat host state, step, layout), newest
        self._heartbeat_file = os.environ.get("DTF_HEARTBEAT_FILE") or None
        self._stop_requested = False
        self._heartbeat = None
        self._stall_timeout_ms = 0
        self._progress_fn = None
        self._journal = None
        self._metrics = None
        self._spans = None
        if self.checkpoint_dir:
            os.makedirs(self.checkpoint_dir, exist_ok=True)

    @property
    def _enabled(self) -> bool:
        return self.checkpoint_dir is not None

    def attach_observability(self, journal=None, metrics=None, spans=None) -> None:
        """Checkpoint telemetry: each save and restore emits a
        ``checkpoint_save`` / ``checkpoint_restore`` journal event, feeds
        the metrics registry (save count, bytes, the duration histogram;
        restore count) and records a host span. Each sink is optional."""
        self._journal = journal
        self._metrics = metrics
        self._spans = spans

    def _span(self, name: str, **args):
        if self._spans is None:
            return contextlib.nullcontext()
        return self._spans.span(name, cat="checkpoint", **args)

    def attach_heartbeat(self, heartbeat, *, stall_timeout_ms: int = 0) -> None:
        """Failure-reactive stopping: ``should_stop`` turns true when the
        attached detector (anything with ``failed_count()`` and, for
        ``stall_timeout_ms > 0``, ``stalled_count(ms)``) reports a failed
        or stalled worker."""
        self._heartbeat = heartbeat
        self._stall_timeout_ms = int(stall_timeout_ms)

    def attach_progress(self, progress_fn) -> None:
        """The progress reporter :meth:`report_progress` calls."""
        self._progress_fn = progress_fn

    def report_progress(self, progress: int) -> None:
        """Advance the attached progress reporter (a no-op without one).
        When ``$DTF_HEARTBEAT_FILE`` names a path, also bump that file's
        mtime and journal a ``heartbeat`` event: the watchdog's evidence
        that this member is alive and advancing."""
        if self._progress_fn is not None:
            self._progress_fn(int(progress))
        if self._heartbeat_file:
            resilience.touch_heartbeat(self._heartbeat_file)
            if self._journal is not None:
                self._journal.emit("heartbeat", rank=int(os.environ.get("DTF_RANK", "0") or 0),
                                   step=int(progress))

    # -- checkpoint / restore ---------------------------------------------

    def latest_step(self, *, verify: bool = False) -> int | None:
        self.wait_pending()
        return latest_checkpoint_step(self.checkpoint_dir, verify=verify)

    def newest_restorable_step(self) -> int | None:
        """Newest step that is not known-bad: verified where it has a
        manifest, trusted where it has none. Drains the writer first (a
        step in flight has no manifest yet and would read as trusted)."""
        self.wait_pending()
        for step in reversed(checkpoint_steps(self.checkpoint_dir)):
            if resilience.verify_files(self.checkpoint_dir, step) is False:
                warnings.warn(
                    f"checkpoint step_{step} fails manifest verification; "
                    "falling back to the previous step",
                    RuntimeWarning,
                    stacklevel=2,
                )
                continue
            return step
        return None

    def _retry(self, fn, describe: str):
        return resilience.retry_io(fn, attempts=self.io_retries, backoff=self.io_backoff,
                                   describe=describe)

    def save(self, state, step: int, layout: dict | None = None) -> None:
        """Chief-only checkpoint write (a no-op on other ranks). ``state``
        is in the on-disk layout (the trainers gather first). ``layout``
        goes to the ``step_N.layout.json`` sidecar, which a restore across
        modes reads.

        The write runs under retry with backoff, then the manifest commits
        atomically, then retention removes steps past ``keep_last_n``
        (never the last valid one). Async: the boundary pays the host
        snapshot only; the writer runs the same :meth:`_write_step`, so the
        files are the sync path's; the snapshot is kept for the emergency
        save, and an earlier writer error is raised here."""
        if not (self.is_chief and self._enabled):
            return
        resilience.failpoints.fire("ckpt.save")
        if self.async_checkpoint:
            flat = flatten_state(state, own=True)
            self._last_snapshot = (flat, int(step), layout)
            if self._writer is None:
                self._writer = resilience.AsyncCheckpointWriter()
            else:
                self._writer.raise_deferred()
            self._writer.submit(lambda: self._write_step(flat, int(step), layout), tag=int(step))
            return
        self._saving = True
        try:
            self._write_step(flatten_state(state), int(step), layout)
        finally:
            self._saving = False

    def _write_step(self, flat: dict, step: int, layout: dict | None, *,
                    quiet: bool = False) -> None:
        """The one write sequence of both modes: ``state.pt`` under retry,
        the layout sidecar, the manifest, the telemetry, the retention
        sweep (after the manifest, so a step not yet committed never
        competes with the newest valid one). ``quiet`` (the emergency save
        from a signal handler) skips span, journal and metrics."""
        path = os.path.join(self.checkpoint_dir, f"step_{step}")

        def _write():
            os.makedirs(path, exist_ok=True)
            torch.save(flat, os.path.join(path, STATE_FILE))

        with self._write_lock:
            t0 = time.perf_counter()
            span = contextlib.nullcontext() if quiet else self._span("checkpoint_save",
                                                                      step=int(step))
            with span:
                self._retry(_write, f"save step_{step}")
                if layout is not None:
                    resilience.write_json_atomic(f"{path}.layout.json", layout)
                manifest = self._retry(
                    lambda: resilience.write_manifest(self.checkpoint_dir, step, flat),
                    f"manifest step_{step}",
                )
            duration_s = time.perf_counter() - t0
            nbytes = sum(r["size"] for r in manifest.get("files", {}).values()) + sum(
                r["size"] for r in manifest.get("sidecars", {}).values())
            if not quiet and self._journal is not None:
                self._journal.emit("checkpoint_save", step=int(step), bytes=int(nbytes),
                                   duration_s=round(duration_s, 6))
            if not quiet and self._metrics is not None:
                self._metrics.counter("checkpoint_saves_total").inc()
                self._metrics.counter("checkpoint_bytes_total").inc(nbytes)
                self._metrics.histogram("checkpoint_save_s").observe(duration_s)
            self._retention_sweep()

    def wait_pending(self) -> None:
        """Drain the async writer (every submitted write committed, or its
        error raised); a no-op in sync mode. The final-save barrier and the
        read barrier of every restore entry point."""
        w = self._writer
        if w is not None:
            w.wait_pending()

    def emergency_save(self) -> int | None:
        """Persist the newest host snapshot now (the preemption handler's
        hook): drain the writer, then write the snapshot synchronously if
        it is still not on disk. A no-op (None) when the signal interrupted
        a sync save. Returns the snapshot's step when it is durable after
        the call, else None."""
        if not (self.is_chief and self._enabled) or self._saving:
            return None
        snap = self._last_snapshot
        if snap is None:
            return None
        flat, step, layout = snap
        try:
            self.wait_pending()
        except Exception:  # noqa: BLE001 — the writer died; write it here
            pass
        if resilience.verify_files(self.checkpoint_dir, step) is not True:
            try:
                self._write_step(flat, step, layout, quiet=True)
            except Exception:  # noqa: BLE001 — best effort in a handler
                return None
        return int(step)

    def _retention_sweep(self) -> None:
        """Delete the steps past the ``keep_last_n`` newest, but never the
        newest valid step when none of the kept ones is valid."""
        n = self.keep_last_n
        if not n or n < 1:
            return
        steps = checkpoint_steps(self.checkpoint_dir)
        doomed = steps[:-n]
        if not doomed:
            return
        kept_valid = any(resilience.verify_files(self.checkpoint_dir, s) is True
                         for s in steps[-n:])
        protected: set[int] = set()
        if not kept_valid:
            for s in reversed(doomed):
                if resilience.verify_files(self.checkpoint_dir, s) is True:
                    protected.add(s)
                    break
        for s in doomed:
            if s in protected:
                continue
            shutil.rmtree(os.path.join(self.checkpoint_dir, f"step_{s}"), ignore_errors=True)
            for side in (f"step_{s}.layout.json", f"step_{s}.manifest.json"):
                try:
                    os.remove(os.path.join(self.checkpoint_dir, side))
                except OSError:
                    pass

    def saved_layout(self, step: int) -> dict | None:
        """The layout sidecar of ``step_N``, or None when there is none
        (then the layout is taken as this trainer's). A sidecar that does
        not parse raises ValueError."""
        if not self.checkpoint_dir:
            return None
        path = os.path.join(self.checkpoint_dir, f"step_{step}.layout.json")
        try:
            with open(path) as f:
                raw = f.read()
        except OSError:
            return None
        try:
            return json.loads(raw)
        except ValueError as exc:
            raise ValueError(f"corrupt checkpoint layout sidecar {path}: {exc}") from exc

    def restore_raw(self, step: int, abstract, *, device=None):
        """``step_N`` in the structure of ``abstract`` (a state of the
        SOURCE layout's structure, e.g. async's per-copy trees) with the
        file's shapes: the restore across modes, whose caller
        canonicalizes the result. On ``device`` (default each template
        leaf's device)."""
        if not self._enabled:
            raise RuntimeError("no checkpoint directory")
        self.wait_pending()
        path = os.path.join(self.checkpoint_dir, f"step_{step}")
        flat = self._retry(lambda: read_state(path), f"restore step_{step}")
        return unflatten_state(abstract, flat, device=device, check_shapes=False)

    def prepare_or_restore(self, state, *, verified_step: int | None = None, device=None):
        """Restore-or-init (the reference's ``prepare_or_wait_for_session``):
        returns ``(state, start_step)``, the given fresh state and 0 when
        there is no checkpoint.

        Candidates newest first; a step whose manifest fails, whose load
        raises (a torn file, a missing or misshapen leaf) or whose restored
        leaves mismatch their recorded CRCs is skipped with a
        ``RuntimeWarning`` naming it. When checkpoints exist and every one
        fails, it raises rather than start over at step 0.
        ``verified_step`` marks a step whose files the caller verified
        this session (the CRC pass is not repeated for it). The restored
        tensors go to ``device`` (default each leaf of ``state``'s)."""
        if not self._enabled:
            return state, 0
        self.wait_pending()
        candidates = list(reversed(checkpoint_steps(self.checkpoint_dir)))
        for step in candidates:
            if step != verified_step and resilience.verify_files(
                    self.checkpoint_dir, step) is False:
                warnings.warn(
                    f"checkpoint step_{step} fails manifest verification; trying the previous step",
                    RuntimeWarning,
                    stacklevel=2,
                )
                continue
            path = os.path.join(self.checkpoint_dir, f"step_{step}")
            try:
                resilience.failpoints.fire("ckpt.restore")
                flat = self._retry(lambda: read_state(path), f"restore step_{step}")
                restored = unflatten_state(state, flat, device=device)
            except Exception as exc:  # noqa: BLE001 — fall back, per the contract
                warnings.warn(
                    f"checkpoint step_{step} failed to restore "
                    f"({type(exc).__name__}: {exc}); trying the previous step",
                    RuntimeWarning,
                    stacklevel=2,
                )
                continue
            try:
                manifest = resilience.load_manifest(self.checkpoint_dir, step)
            except ValueError:
                manifest = None
            if manifest is not None and not resilience.verify_leaves(flat, manifest):
                warnings.warn(
                    f"checkpoint step_{step} restored with leaf CRC mismatches; "
                    "trying the previous step",
                    RuntimeWarning,
                    stacklevel=2,
                )
                continue
            if self._journal is not None:
                self._journal.emit("checkpoint_restore", step=int(step),
                                   fallback=step != candidates[0])
            if self._metrics is not None:
                self._metrics.counter("checkpoint_restores_total").inc()
            return restored, step
        if candidates:
            raise RuntimeError(
                f"no restorable checkpoint in {self.checkpoint_dir}: all "
                f"{len(candidates)} candidate step(s) "
                f"({', '.join(f'step_{s}' for s in candidates)}) failed "
                "verification or restore — see the RuntimeWarnings above; "
                "refusing to silently re-initialize at step 0 over an "
                "existing run's progress"
            )
        return state, 0

    # -- orderly shutdown (the reference's sv.request_stop / sv.stop) -----

    def request_stop(self) -> None:
        self._stop_requested = True

    @property
    def should_stop(self) -> bool:
        if self._stop_requested:
            return True
        if self._heartbeat is not None:
            if self._heartbeat.failed_count() > 0:
                self._stop_requested = True
            elif (self._stall_timeout_ms > 0 and hasattr(self._heartbeat, "stalled_count")
                  and self._heartbeat.stalled_count(self._stall_timeout_ms) > 0):
                self._stop_requested = True
        return self._stop_requested

    def stop(self) -> None:
        try:
            self.wait_pending()
        finally:
            self._stop_requested = True
