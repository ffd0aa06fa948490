"""Deterministic fault injection: named failpoints at the durability seams.

Counterpart of ``distributed_tensorflow_tpu/train/failpoints.py``, with the
same registry (:data:`REGISTERED`), grammar and behaviour, so a schedule
one package accepts the other accepts too. Faults are armed through the
``DTF_FAILPOINTS`` environment variable or :func:`configure` / :func:`arm`.

Spec grammar (comma-separated entries)::

    DTF_FAILPOINTS="name:kind[=arg][@N[+]],..."

    kind  = raise | torn | delay | kill
    =arg  = delay seconds (delay only; default 0.01)
    @N    = fire on the Nth hit of the name (1-based; default 1)
    +     = keep firing on every hit >= N (default: the Nth hit only)

Fault kinds at a hit:

- ``raise``: raise :class:`FailpointError` (an ``OSError``, so a seam's
  retry treats it as a real I/O error);
- ``delay``: ``time.sleep(arg)``;
- ``kill``: SIGKILL this process (after flushing the journal);
- ``torn``: truncate the committed file to half its bytes, at a
  tear-capable seam (:func:`tear`, called after the commit).

A site calls :func:`fire` once an operation (which counts a hit and acts on
raise/delay/kill) and, at a tear-capable seam, :func:`tear` after its
commit, which reads the hit count ``fire`` just advanced and never counts
one of its own. Each fired fault is journaled as a ``failpoint`` event.

With nothing armed, :func:`fire` and :func:`tear` return after one falsy
check. Hit counters sit under a lock; no clock, no RNG: the same schedule
faults the same operation every run. Standard library only.
"""

from __future__ import annotations

import os
import signal
import threading
import time

ENV_VAR = "DTF_FAILPOINTS"

_KINDS = ("raise", "torn", "delay", "kill")

# The seam inventory: every name a ``fire``/``tear`` call site uses in the
# JAX package, with where it sits, so a schedule one package accepts the
# other accepts too. A name whose call site the port does not have yet
# (the checkpoint, delta, fleet and elastic seams) is armed like any other
# and never fires. Arming an unknown name raises at configure time: a
# mistyped schedule must be loud, not silently inert.
REGISTERED = {
    "atomic.write": (
        "resilience.write_json_atomic entry (+ tear of the committed "
        "file): checkpoint manifests, layout sidecars, fleet mailbox JSON"
    ),
    "atomic.write.commit": (
        "resilience.write_json_atomic between the tmp write and the "
        "atomic replace — kill here leaves a .tmp orphan, no commit"
    ),
    "ckpt.save": "supervisor.Supervisor.save entry (before the orbax write)",
    "ckpt.restore": (
        "supervisor.Supervisor.prepare_or_restore, per candidate step "
        "before its restore attempt"
    ),
    "ckpt.manifest": (
        "resilience.write_manifest (+ tear of the committed manifest "
        "sidecar)"
    ),
    "ckpt.async": (
        "resilience.AsyncCheckpointWriter worker, before executing a "
        "queued write — raise: the writer dies before serializing (the "
        "queued step never lands, error deferred to wait_pending); "
        "kill: crash mid-async-write; delay: makes supersession "
        "deterministic"
    ),
    "delta.post": (
        "local_sgd.DeltaExchange.post entry (+ tear of the committed "
        "npz post)"
    ),
    "delta.post.commit": (
        "DeltaExchange.post between the tmp write and the atomic "
        "replace — kill here leaves a .tmp orphan in the mailbox"
    ),
    "delta.load": (
        "DeltaExchange._load entry — raise is a transient unreadable "
        "peer post (retried next boundary, watermark unmoved)"
    ),
    "fleet.submit": (
        "serve_fleet.MailboxClient.submit entry (+ tear of the "
        "committed request file)"
    ),
    "fleet.result": (
        "serve_fleet.MailboxClient.put_result entry (+ tear of the "
        "committed result file)"
    ),
    "fleet.read": (
        "serve_fleet._read_dir entry (take_inbox and poll_results both "
        "pass through it)"
    ),
    "fleet.migrate": (
        "serve_fleet.MigrationStore.post entry (+ tear of the committed "
        "KV-migration npz envelope) — a torn post is quarantined once at "
        "load and the request falls back to re-prefill on the decode "
        "replica"
    ),
    "journal.append": "observability EventJournal.emit, before the os.write",
    "journal.rotate": "observability EventJournal._rotate entry",
    "elastic.relaunch": "elastic.ElasticAgent.start entry (every spawn)",
    "elastic.health": "elastic.HttpHealth.probe entry (every probe)",
}


class FailpointError(OSError):
    """The injected fault. Subclasses ``OSError`` deliberately: the
    seams under test retry/skip on OSError, so an injected transient
    exercises the SAME recovery path a real filesystem hiccup would."""


class _Spec:
    __slots__ = ("name", "kind", "hit", "persistent", "arg")

    def __init__(self, name, kind, hit, persistent, arg):
        self.name = name
        self.kind = kind
        self.hit = hit
        self.persistent = persistent
        self.arg = arg

    def matches(self, count: int) -> bool:
        return count >= self.hit if self.persistent else count == self.hit

    def describe(self) -> str:
        out = f"{self.name}:{self.kind}"
        if self.kind == "delay":
            out += f"={self.arg}"
        out += f"@{self.hit}" + ("+" if self.persistent else "")
        return out


_lock = threading.Lock()
_specs: dict[str, list[_Spec]] = {}
_hits: dict[str, int] = {}
_in_fire = threading.local()


def _parse_entry(entry: str) -> _Spec:
    entry = entry.strip()
    if ":" not in entry:
        raise ValueError(
            f"failpoint entry {entry!r}: expected 'name:kind[=arg][@N[+]]'"
        )
    name, _, rest = entry.partition(":")
    name = name.strip()
    if name not in REGISTERED:
        raise ValueError(
            f"unknown failpoint name {name!r} — registered names: "
            f"{', '.join(sorted(REGISTERED))}"
        )
    hit, persistent = 1, False
    if "@" in rest:
        rest, _, hit_s = rest.partition("@")
        hit_s = hit_s.strip()
        if hit_s.endswith("+"):
            persistent = True
            hit_s = hit_s[:-1]
        hit = int(hit_s)
        if hit < 1:
            raise ValueError(f"failpoint {entry!r}: @N must be >= 1")
    kind, _, arg_s = rest.partition("=")
    kind = kind.strip()
    if kind not in _KINDS:
        raise ValueError(
            f"failpoint {entry!r}: kind must be one of {_KINDS}, got "
            f"{kind!r}"
        )
    arg = 0.01
    if arg_s:
        if kind != "delay":
            raise ValueError(
                f"failpoint {entry!r}: only 'delay' takes '=arg'"
            )
        arg = float(arg_s)
    return _Spec(name, kind, hit, persistent, arg)


def configure(spec: str | None) -> None:
    """Replace the armed registry from a spec string (the env grammar);
    ``None``/empty disarms everything. Hit counters reset — a schedule
    is deterministic from the moment it arms."""
    global _specs, _hits
    with _lock:
        new: dict[str, list[_Spec]] = {}
        for entry in (spec or "").split(","):
            if not entry.strip():
                continue
            s = _parse_entry(entry)
            new.setdefault(s.name, []).append(s)
        _specs = new
        _hits = {}


def arm(entry: str) -> None:
    """Arm one additional entry (``name:kind[=arg][@N[+]]``) on top of
    whatever is already armed; its name's hit counter resets."""
    s = _parse_entry(entry)
    with _lock:
        _specs.setdefault(s.name, []).append(s)
        _hits.pop(s.name, None)


def reset() -> None:
    """Re-arm from the environment (``DTF_FAILPOINTS``), clearing any
    programmatic arms and all hit counters."""
    configure(os.environ.get(ENV_VAR))


def active() -> dict[str, list[str]]:
    """``{name: [spec, ...]}`` of everything armed (for reports/tests)."""
    with _lock:
        return {
            name: [s.describe() for s in specs]
            for name, specs in _specs.items()
        }


def hit_count(name: str) -> int:
    """How many times ``fire(name)`` has been hit since arming."""
    if name not in REGISTERED:
        raise ValueError(f"unknown failpoint name {name!r}")
    with _lock:
        return _hits.get(name, 0)


def _emit_event(name: str, kind: str, hit: int) -> None:
    # Through the process-default journal (a NullJournal when
    # unconfigured). The _in_fire guard already keeps the journal seam's
    # own failpoint from recursing through here. Imported here, not at the
    # top: the journal imports this module.
    try:
        from distributed_tensorflow_tpu_torch.observability import (
            journal as obs_journal,
        )

        obs_journal.emit(
            "failpoint", name=name, fault=kind, hit=int(hit)
        )
    except Exception:  # pragma: no cover — never let telemetry mask a fault
        pass


def fire(name: str) -> None:
    """Hit the named failpoint: count the hit and act on any armed
    raise/delay/kill spec whose ``@N`` matches (``torn`` specs are inert
    here — they act in :func:`tear`, after the site's commit). No-op
    (one falsy check) when nothing is armed."""
    if not _specs:
        return
    if getattr(_in_fire, "active", False):
        return  # reentrant (a failpoint event's own journal append)
    with _lock:
        specs = _specs.get(name)
        if specs is None:
            return
        _hits[name] = count = _hits.get(name, 0) + 1
        matched = [s for s in specs if s.kind != "torn" and s.matches(count)]
    if not matched:
        return
    _in_fire.active = True
    try:
        for s in matched:
            _emit_event(name, s.kind, count)
            if s.kind == "delay":
                time.sleep(s.arg)
            elif s.kind == "raise":
                raise FailpointError(
                    f"injected failpoint {s.describe()} (hit {count})"
                )
            elif s.kind == "kill":
                _flush_journal()
                os.kill(os.getpid(), signal.SIGKILL)
    finally:
        _in_fire.active = False


def tear(name: str, path: str) -> bool:
    """Tear-capable seams call this AFTER their atomic commit, with the
    committed path: when a ``torn`` spec for ``name`` matches the hit
    counter the site's :func:`fire` just advanced, the committed file is
    truncated to half its bytes (the storage-corruption model the CRC
    envelopes must catch). Returns True when it tore. Never counts a
    hit of its own — a site's fire() and tear() describe ONE operation."""
    if not _specs:
        return False
    with _lock:
        specs = _specs.get(name)
        if specs is None:
            return False
        count = _hits.get(name, 0)
        matched = [
            s for s in specs if s.kind == "torn" and s.matches(count)
        ]
    if not matched:
        return False
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(1, size // 2))
    _in_fire.active = True
    try:
        _emit_event(name, "torn", count)
    finally:
        _in_fire.active = False
    return True


def _flush_journal() -> None:
    try:
        from distributed_tensorflow_tpu_torch.observability import (
            journal as obs_journal,
        )

        obs_journal.get_journal().flush()
    except Exception:  # pragma: no cover
        pass


# Arm from the environment at import: a subprocess worker receives its
# schedule through DTF_FAILPOINTS with no code of its own. In-process
# callers use configure()/arm()/reset().
reset()
