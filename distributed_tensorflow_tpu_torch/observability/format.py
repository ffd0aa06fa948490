"""Event → log-line renderers: the one place that knows the line formats.

Counterpart of ``distributed_tensorflow_tpu/observability/format.py``, with
every renderer, so a line of the port is byte-for-byte the JAX package's
for the same event. The reference's log contract (``tfdist_between.py:98-
115``: Step/Epoch/Batch/Cost/AvgTime, Test-Accuracy / Total Time, Final
Cost / Done) and the lifecycle lines (``Restart:``, ``Resize:``,
``Rollback:``, ``Preemption:``, ``Restore:``, ...) are rendered HERE, from
journal events: a call site emits an event (:func:`emit_line`) and prints
its rendering, never a hand-built string. ``%``-formatting reproduces the
reference's ``%2d``/``%3d``/``%3.2f`` padding.
"""

from __future__ import annotations

_FAILSTOP_TAIL = (
    "failing stop (checkpoints intact; newest valid step restores on the "
    "next launch)"
)


def _step(ev: dict) -> str:
    # The exact bytes of the reference's per-freq line
    # (tfdist_between.py:102-106): five %-formatted pieces joined with
    # single spaces.
    return (
        "Step: %d,  Epoch: %2d,  Batch: %3d of %3d,  Cost: %.4f,"
        "  AvgTime: %3.2fms"
        % (ev["step"], ev["epoch"], ev["batch"], ev["batch_count"],
           ev["cost"], ev["avg_ms"])
    )


def _epoch(ev: dict) -> list[str]:
    # Test-Accuracy keeps the reference's %2.2f (tfdist_between.py:109);
    # other per-epoch metrics (the LM's Test-Perplexity) use the %.4f
    # shape StepLogger.log_epoch_metric introduced.
    metric = ev.get("metric", "Test-Accuracy")
    if metric == "Test-Accuracy":
        head = "Test-Accuracy: %2.2f" % ev["value"]
    else:
        head = "%s: %.4f" % (metric, ev["value"])
    return [head, "Total Time: %3.2fs" % ev["total_time_s"]]


def _final(ev: dict) -> list[str]:
    return ["Final Cost: %.4f" % ev["cost"], "Done"]


def _restart(ev: dict) -> str:
    line = (
        f"Restart: restart={ev['restart']}/{ev['max_restarts']} "
        f"cause[{ev['cause']}] backoff_s={ev['backoff_s']:.1f}"
    )
    # Which members relaunched alone (independent members); absent on a
    # gang restart, whose line is unchanged.
    if ev.get("independent"):
        line += f" independent=True members=[{','.join(ev['members'])}]"
    return line


def _restart_exhausted(ev: dict) -> str:
    return (
        f"Restart: budget exhausted restarts={ev['restarts']}/"
        f"{ev['max_restarts']} cause[{ev['cause']}] — " + _FAILSTOP_TAIL
    )


def _resize(ev: dict) -> str:
    return (
        f"Resize: world={ev['world']} from={ev['from_world']} "
        f"min_workers={ev['min_workers']} direction={ev['direction']} "
        f"dropped=[{','.join(ev['dropped'])}] "
        f"rejoined=[{','.join(ev['rejoined'])}] "
        f"restart={ev['restart']}/{ev['max_restarts']}"
    )


def _resize_denied(ev: dict) -> str:
    return (
        f"Resize: denied world={ev['world']} "
        f"min_workers={ev['min_workers']} restarts={ev['restarts']}/"
        f"{ev['max_restarts']} cause[{ev['cause']}] — " + _FAILSTOP_TAIL
    )


def _rollback(ev: dict) -> str:
    # The anomaly class rides the event as "anomaly" (the journal's own
    # type key is "kind").
    return (
        f"Rollback: kind={ev['anomaly']} epoch={ev['epoch']} "
        f"detected_step={ev['detected_step']} "
        f"restored_step={ev['restored_step']} "
        f"rollback={ev['rollback']}/{ev['max_rollbacks']} "
        "data_window=skipped"
    )


def _rollback_compiled(ev: dict) -> str:
    return (
        "Rollback: kind=nan dispatch=compiled save=skipped "
        "(state not checkpointed; last good step kept)"
    )


def _preemption(ev: dict) -> str:
    # A guard asked for off the main thread never arms: say so once.
    if ev.get("disarmed"):
        return f"Preemption: disarmed ({ev['disarmed']})"
    line = (
        f"Preemption: signal={ev['signal']} stop_requested=1 — finishing "
        "the current epoch, saving, exiting (signal again to force)"
    )
    # The step the handler persisted at once (an emergency snapshot);
    # absent when nothing newer than disk existed.
    if ev.get("saved_step") is not None:
        line += f" saved_step={ev['saved_step']}"
    return line


def _heartbeat(ev: dict) -> str:
    # Normally journal-only (emitted without a print_fn); rendered when a
    # journal is replayed.
    return f"Heartbeat: rank={ev.get('rank')} step={ev.get('step')}"


def _stall(ev: dict) -> str:
    # The progress watchdog's verdict: alive but not advancing.
    return (
        f"Stall: member={ev['member']} "
        f"heartbeat_age_s={ev['age_s']:.1f} "
        f"stall_after_s={ev['stall_after_s']:.1f} — killing and "
        "recovering through the elastic path"
    )


def _restore(ev: dict) -> str:
    return (
        f"Restore: global_batch={ev['global_batch']} preserved "
        f"(world={ev['from_world']}->{ev['world']}, config batch "
        f"{ev['config_batch']}x{ev['world']}={ev['config_global']} "
        f"overridden, per-replica batch {ev['per_replica']})"
    )


def _replica_dead(ev: dict) -> str:
    return (
        f"Replica: dead name={ev['replica']} verdict={ev['verdict']} "
        f"rerouted={ev['rerouted']} restart={ev['attempt']}/"
        f"{ev['max_restarts']}"
    )


def _replica_relaunch(ev: dict) -> str:
    return (
        f"Replica: relaunch name={ev['replica']} "
        f"restart={ev['attempt']}/{ev['max_restarts']} "
        f"backoff_s={ev['backoff_s']:.1f}"
    )


def _replica_benched(ev: dict) -> str:
    return (
        f"Replica: benched name={ev['replica']} restarts={ev['restarts']}/"
        f"{ev['max_restarts']} — fleet continues on the remaining replicas"
    )


def _fleet_below_floor(ev: dict) -> str:
    return (
        f"Fleet: below floor replicas={ev['replicas']} "
        f"min_replicas={ev['min_replicas']} cause[{ev['cause']}] — "
        "failing stop (unserved requests stay with the caller; nothing "
        "durable is lost)"
    )


def _serve_drain(ev: dict) -> str:
    return (
        f"Drain: admission closed residents={ev.get('residents')} "
        f"queued={ev.get('queued')}"
    )


def _weight_swap(ev: dict) -> str:
    return (
        f"Swap: weights step={ev.get('step')} from_step={ev.get('from_step')}"
        f" source={ev.get('source')}"
    )


def _mailbox_corrupt(ev: dict) -> str:
    # A committed but corrupt post (CRC-checked mailboxes).
    # "skipped" = delta mailbox (watermark advanced past it, never
    # consumed); "quarantined" = fleet mailbox (removed, never delivered).
    line = (
        f"Mailbox: corrupt mailbox={ev['mailbox']} file={ev['file']} "
        f"reason={ev['reason']} action={ev['action']}"
    )
    if "peer" in ev:
        line += f" peer={ev['peer']} round={ev['round']}"
    if "box" in ev:
        line += f" box={ev['box']}"
    return line


def _breaker_open(ev: dict) -> str:
    # The router's circuit breaker: routes divert at once, before the
    # health verdict; nothing is charged to the restart budget.
    return (
        f"Breaker: open replica={ev['replica']} failures={ev['failures']} "
        f"reason[{ev['reason']}] reset_s={ev['reset_s']:.1f}"
    )


def _breaker_half_open(ev: dict) -> str:
    return f"Breaker: half-open replica={ev['replica']} — probing one request"


def _breaker_close(ev: dict) -> str:
    return f"Breaker: close replica={ev['replica']}"


def _fleet_roles(ev: dict) -> str:
    # The disaggregated fleet's role map, recorded once by the router.
    roles = ev.get("roles") or {}
    body = " ".join(f"{k}={v}" for k, v in sorted(roles.items()))
    return f"Fleet: roles {body} migrate_dir={ev.get('migrate_dir')}"


def _request_migrated(ev: dict) -> str:
    return (
        f"Migrate: trace={ev.get('trace')} from={ev.get('from_replica')} "
        f"post={ev.get('post')} blocks={ev.get('blocks')} "
        f"nbytes={ev.get('nbytes')}"
    )


def _kv_migration(ev: dict) -> str:
    line = f"KV-migration: phase={ev.get('phase')} trace={ev.get('trace')}"
    for k in ("slot", "blocks", "nbytes", "wall_ms", "file", "reason"):
        if k in ev:
            line += f" {k}={ev[k]}"
    return line


def _failpoint(ev: dict) -> str:
    # An injected fault fired (train/failpoints.py).
    return (
        f"Failpoint: name={ev['name']} fault={ev['fault']} hit={ev['hit']}"
    )


RENDERERS = {
    "step": _step,
    "epoch": _epoch,
    "final": _final,
    "restart": _restart,
    "restart_exhausted": _restart_exhausted,
    "resize": _resize,
    "resize_denied": _resize_denied,
    "rollback": _rollback,
    "rollback_compiled": _rollback_compiled,
    "preemption": _preemption,
    "heartbeat": _heartbeat,
    "stall": _stall,
    "restore": _restore,
    "replica_dead": _replica_dead,
    "replica_relaunch": _replica_relaunch,
    "replica_benched": _replica_benched,
    "fleet_below_floor": _fleet_below_floor,
    "serve_drain": _serve_drain,
    "weight_swap": _weight_swap,
    "mailbox_corrupt": _mailbox_corrupt,
    "failpoint": _failpoint,
    "breaker_open": _breaker_open,
    "breaker_half_open": _breaker_half_open,
    "breaker_close": _breaker_close,
    "fleet_roles": _fleet_roles,
    "request_migrated": _request_migrated,
    "kv_migration": _kv_migration,
}


def render(kind: str, ev: dict) -> list[str]:
    """The stdout line(s) for an event of ``kind`` (most kinds render one
    line; epoch/final render two, matching the reference's pairs)."""
    out = RENDERERS[kind](ev)
    return [out] if isinstance(out, str) else list(out)


def emit_line(
    kind: str,
    *,
    journal=None,
    print_fn=None,
    **fields,
) -> dict:
    """The event-first logging primitive: journal the event (NullJournal
    when none attached — the dict is still built), then print the line(s)
    RENDERED FROM IT. Returns the event. Every structured stdout line of
    the port goes through here."""
    if journal is None:
        from distributed_tensorflow_tpu_torch.observability import journal as _j

        journal = _j.get_journal()
    ev = journal.emit(kind, **fields)
    if print_fn is not None:
        for line in render(kind, ev):
            print_fn(line)
    return ev
