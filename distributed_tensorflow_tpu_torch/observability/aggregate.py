"""Gang-wide journal aggregation: N ranks' journals → one timeline.

Counterpart of ``distributed_tensorflow_tpu/observability/aggregate.py``.
It discovers every journal under a gang's logdir (the launcher's
``events.jsonl`` and the per-rank ``events-rank<k>.jsonl`` that
``journal.configure_from_env`` creates, rotated segments included), aligns
their clocks, and merges them into one fleet timeline, with a chrome trace
that gives each journal a track of its own.

Clock alignment: each journal's events carry their own host's wall clock.
Shared gang lifecycle events (``restart``, ``resize``, ... or an explicit
``gang_sync``) with the same identifying fields name one physical instant
wherever they were journaled, so a journal's clock offset is the median of
``ts_self − ts_reference`` over its shared anchors. A journal that shares
no anchor with the reference (one host: the workers journal steps) gets
offset 0. Standard library only.
"""

from __future__ import annotations

import os
import re
import statistics

from distributed_tensorflow_tpu_torch.observability.journal import (
    journal_segments,
    read_events,
)

# Kinds that name ONE physical gang-wide instant in every journal that
# records them — the skew anchors, and the events mirrored onto every
# rank track in the chrome trace. The serving-fleet router's lifecycle
# kinds ride along: they are recorded only in the router's journal, so
# they never act as cross-journal anchors, but they ARE fleet-wide
# moments the merged trace should show on every track.
GANG_KINDS = (
    "restart",
    "restart_exhausted",
    "resize",
    "resize_denied",
    "gang_sync",
    "replica_dead",
    "replica_relaunch",
    "replica_benched",
    "fleet_below_floor",
    "breaker_open",
    "breaker_half_open",
    "breaker_close",
    # The disaggregated fleet's role map is a one-shot
    # router-journal lifecycle moment, mirrored like the other fleet
    # kinds. Per-request migration kinds (request_migrated,
    # kv_migration) stay OUT, like request_route.
    "fleet_roles",
    # The progress watchdog's "stall" is a true gang moment — the
    # launcher's verdict on a frozen member, recorded once, mirrored on
    # every track. "heartbeat" rides in GANG_KINDS for the report's
    # per-rank last-progress join, but it is a PER-RANK stream, not a
    # shared instant — it is excluded from the skew anchors
    # (_ANCHOR_KINDS) and rendered as a local instant in the chrome
    # trace: per-rank kinds must never anchor
    # (colliding keys would poison estimate_skew).
    "stall",
    "heartbeat",
)

# The skew-anchor subset of GANG_KINDS: kinds where ONE physical instant
# is recorded in MULTIPLE journals. Per-rank streams (heartbeat) never
# qualify.
_ANCHOR_KINDS = tuple(k for k in GANG_KINDS if k != "heartbeat")

_RANK_FILE = re.compile(r"^events-rank(\d+)\.jsonl$")


def discover_journals(logdir: str) -> dict:
    """Map journal label → path for every journal under ``logdir``:
    ``events.jsonl`` → ``driver``, ``events-rank<k>.jsonl`` → ``rank<k>``,
    any other ``events-*.jsonl`` → its stem. Rotated segments belong to
    their base journal (``read_events`` spans them), so they do not
    appear as separate entries."""
    out: dict = {}
    for name in sorted(os.listdir(logdir)):
        path = os.path.join(logdir, name)
        if not os.path.isfile(path):
            continue
        if name == "events.jsonl":
            out["driver"] = path
        elif (m := _RANK_FILE.match(name)):
            out[f"rank{int(m.group(1))}"] = path
        elif name.startswith("events-") and name.endswith(".jsonl"):
            out[name[len("events-") : -len(".jsonl")]] = path
    return out


def _anchor_key(ev: dict):
    """Identity of a gang-wide event across journals: the kind plus its
    stable ordinal fields (restart ordinal, world size, an explicit sync
    id) — wall time deliberately excluded (it is what we are solving
    for). ``member`` is in it: two stall verdicts on different
    members are different instants and must never alias. The per-rank
    auto-tags (``rank``, ``step``) stay OUT of the key — rank journals
    stamp ``rank=`` on every event they record, so keying on either
    would split the launcher's copy of a shared anchor from the ranks'
    copies (heartbeats, the stream those tags would disambiguate, are
    excluded from anchoring wholesale via ``_ANCHOR_KINDS``)."""
    return (
        ev.get("kind"),
        ev.get("restart"),
        ev.get("restarts"),
        ev.get("world"),
        ev.get("from_world"),
        ev.get("sync"),
        ev.get("member"),
    )


def estimate_skew(journals: dict) -> dict:
    """Per-journal clock offset (seconds, to SUBTRACT) from shared gang
    anchors. The reference journal is the one holding the most anchor
    events (ties: label order, so ``driver`` wins over ``rank0``); its
    offset is 0 by construction."""
    anchors = {
        label: {
            _anchor_key(e): e["ts"]
            for e in evs
            if e.get("kind") in _ANCHOR_KINDS
            and isinstance(e.get("ts"), (int, float))
        }
        for label, evs in journals.items()
    }
    if not anchors:
        return {}
    ref = min(anchors, key=lambda lb: (-len(anchors[lb]), lb))
    offsets = {}
    for label, own in anchors.items():
        shared = [
            own[k] - anchors[ref][k] for k in own if k in anchors[ref]
        ]
        offsets[label] = (
            float(statistics.median(shared)) if label != ref and shared else 0.0
        )
    return offsets


def merge(source) -> dict:
    """Merge a gang's journals into one fleet timeline.

    ``source`` is a logdir (journals discovered per
    :func:`discover_journals`) or an explicit ``{label: path}`` /
    ``{label: events-list}`` mapping. Returns::

        {"ranks": [label, ...],            # track order: "driver" first
         "skew_s": {label: offset},
         "events": [...]}                  # ts skew-adjusted, sorted;
                                           # each event carries _src

    The per-event ``_src`` label keys the chrome-trace track and the
    fleet report; the original journals are untouched."""
    if isinstance(source, str):
        paths = discover_journals(source)
        if not paths:
            raise FileNotFoundError(f"no events*.jsonl journals under {source}")
        journals = {lb: read_events(p) for lb, p in paths.items()}
    else:
        journals = {
            lb: (read_events(v) if isinstance(v, str) else list(v))
            for lb, v in source.items()
        }
    skew = estimate_skew(journals)
    ranks = sorted(
        journals,
        key=lambda lb: (lb != "driver", _rank_ordinal(lb), lb),
    )
    merged = []
    for label, evs in journals.items():
        off = skew.get(label, 0.0)
        for ev in evs:
            e = dict(ev)
            e["_src"] = label
            if isinstance(e.get("ts"), (int, float)) and off:
                e["ts"] = e["ts"] - off
            merged.append(e)
    merged.sort(key=lambda e: (e.get("ts") or 0.0))
    return {"ranks": ranks, "skew_s": skew, "events": merged}


def _rank_ordinal(label: str) -> int:
    m = re.match(r"rank(\d+)$", label)
    return int(m.group(1)) if m else 1 << 30


def gang_chrome_trace(merged: dict) -> dict:
    """The fleet timeline in the chrome trace event format: one PROCESS
    track per journal (pid = track index, named via ``process_name``
    metadata), ``span`` events as complete ("X") slices anchored on the
    skew-adjusted WALL clock (a journal's ``ts_us`` is process-local
    perf_counter time and never comparable across ranks — the span's
    journal-event ``ts`` is its close wall time, so start = ts − dur),
    and lifecycle moments as instant ("i") events. Gang-wide kinds
    (:data:`GANG_KINDS`) are mirrored onto EVERY rank track — a gang
    restart IS an event on each rank — plus worker_start / checkpoint /
    rollback / preemption / serving admissions and completions on their
    own rank's track."""
    ranks = merged["ranks"]
    pids = {label: i for i, label in enumerate(ranks)}
    events = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pids[label],
            "tid": 0,
            "args": {"name": label},
        }
        for label in ranks
    ]
    stamped = [
        e for e in merged["events"] if isinstance(e.get("ts"), (int, float))
    ]
    if not stamped:
        return {"traceEvents": events, "displayTimeUnit": "ms"}
    t0 = min(e["ts"] for e in stamped)

    def us(ts: float) -> float:
        return (ts - t0) * 1e6

    local_instants = (
        "worker_start",
        "checkpoint_save",
        "checkpoint_restore",
        "rollback",
        "rollback_compiled",
        "preemption",
        "restore",
        "request_submit",
        "admission",
        "completion",
        # Injected-fault and corrupt-mailbox-recovery events stay
        # PER-RANK instants (never GANG_KINDS — multiple ranks can record
        # the same kind with colliding anchor keys, which would poison
        # estimate_skew's shared-lifecycle-anchor matching).
        "failpoint",
        "mailbox_corrupt",
        # A heartbeat belongs to the rank that beat — checked
        # BEFORE the GANG_KINDS mirror below (it is in GANG_KINDS only
        # for the report's last-progress join, never a fleet-wide
        # instant to stamp on every track).
        "heartbeat",
    )
    for ev in stamped:
        kind = ev.get("kind")
        pid = pids.get(ev["_src"], 0)
        args = {
            k: v for k, v in ev.items() if k not in ("_src", "kind", "ts")
        }
        if kind in local_instants:
            events.append(
                {
                    "name": kind,
                    "cat": "lifecycle",
                    "ph": "i",
                    "s": "p",
                    "ts": us(ev["ts"]),
                    "pid": pid,
                    "tid": 0,
                    "args": args,
                }
            )
        elif kind == "span":
            dur = float(ev.get("dur_us", 0.0))
            events.append(
                {
                    "name": ev.get("name", "?"),
                    "cat": ev.get("cat", "host"),
                    "ph": "X",
                    "ts": us(ev["ts"]) - dur,
                    "dur": dur,
                    "pid": pid,
                    "tid": 0,
                    "args": dict(ev.get("args", {})),
                }
            )
        elif kind in GANG_KINDS:
            for label in ranks:  # the gang moment, visible on every track
                events.append(
                    {
                        "name": kind,
                        "cat": "lifecycle",
                        "ph": "i",
                        "s": "g",
                        "ts": us(ev["ts"]),
                        "pid": pids[label],
                        "tid": 0,
                        "args": args,
                    }
                )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def fleet_summary(merged: dict) -> dict:
    """The gang report's payload: per-rank event counts and wall
    spans, the estimated skew, and the merged lifecycle history (each
    entry tagged with the journal that recorded it)."""
    from distributed_tensorflow_tpu_torch.observability import format as obs_format

    ts_newest = max(
        (
            e["ts"]
            for e in merged["events"]
            if isinstance(e.get("ts"), (int, float))
        ),
        default=None,
    )
    per_rank: dict = {}
    for label in merged["ranks"]:
        evs = [e for e in merged["events"] if e["_src"] == label]
        ts = [
            e["ts"] for e in evs if isinstance(e.get("ts"), (int, float))
        ]
        kinds: dict = {}
        for e in evs:
            kinds[e.get("kind", "?")] = kinds.get(e.get("kind", "?"), 0) + 1
        per_rank[label] = {
            "events": len(evs),
            "kinds": dict(sorted(kinds.items())),
            "wall_span_s": round(max(ts) - min(ts), 3) if ts else 0.0,
        }
        # The last-progress age from the rank's
        # newest heartbeat event, measured against the merged timeline's
        # end — a member whose age keeps growing while the gang's clock
        # advances is stalling, visible here BEFORE the verdict fires.
        beats = [
            e
            for e in evs
            if e.get("kind") == "heartbeat"
            and isinstance(e.get("ts"), (int, float))
        ]
        if beats and ts_newest is not None:
            last = max(beats, key=lambda e: e["ts"])
            per_rank[label]["last_progress"] = {
                "step": last.get("step"),
                "age_s": round(ts_newest - last["ts"], 3),
            }
    # Tag each replica's rank row with
    # its role from the router's one-shot fleet_roles event, so the
    # report reads "replica0 [prefill]: ..." without a separate join.
    for ev in merged["events"]:
        if ev.get("kind") == "fleet_roles":
            for name, role in (ev.get("roles") or {}).items():
                if name in per_rank:
                    per_rank[name]["role"] = role
    lifecycle = []
    for ev in merged["events"]:
        kind = ev.get("kind")
        # heartbeat is a per-rank stream (summarized as last_progress
        # above) — listing every beat would drown the lifecycle history.
        if kind == "heartbeat":
            continue
        if kind in GANG_KINDS or kind in (
            "preemption", "rollback", "restore", "weight_swap", "serve_drain",
            "failpoint", "mailbox_corrupt",
        ):
            try:
                line = obs_format.render(kind, ev)[0]
            except KeyError:
                line = f"{kind}: {ev}"
            lifecycle.append(
                {"ts": ev.get("ts"), "src": ev["_src"], "kind": kind,
                 "line": line}
            )
    ts_all = [
        e["ts"]
        for e in merged["events"]
        if isinstance(e.get("ts"), (int, float))
    ]
    return {
        "ranks": per_rank,
        "skew_s": {k: round(v, 6) for k, v in merged["skew_s"].items()},
        "events": len(merged["events"]),
        "wall_span_s": round(max(ts_all) - min(ts_all), 3) if ts_all else 0.0,
        "lifecycle": lifecycle,
        "worker_starts": {
            label: per_rank[label]["kinds"].get("worker_start", 0)
            for label in merged["ranks"]
        },
    }
