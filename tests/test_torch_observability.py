"""PyTorch port: the telemetry layer (``observability/``, ``utils/logging``,
``utils/summary.lifecycle_event``) against the JAX package's.

The same inputs go through both packages: the journal's events (less
``ts``, with rotation and a torn tail), the Prometheus text and snapshot of
the same seeded observations, every renderer of ``observability/format``,
the span recorder's barrier contract, the gang aggregation, the exporter
and the per-rank journal knobs, bit for bit. Then a small CPU run of each
trainer through both packages, with a journal attached: the MLP
``Trainer`` and a 2-layer ``LMTrainer`` in ``dp`` (a mesh of one rank in
both) and ``diloco`` (the one-device gang of 4 workers): the same sequence
of event kinds with the same keys, the step and epoch numbers and
``comm_stats`` integers equal, the costs within the trainers' parity
tolerance (2e-4, their printed four places), and the stdout lines equal
once AvgTime and Total Time are masked.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (sets torch's thread count for xdist workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "distributed_tensorflow_tpu_torch")


def _both():
    from distributed_tensorflow_tpu import observability as jobs
    from distributed_tensorflow_tpu_torch import observability as tobs

    return jobs, tobs


def _less_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


# -- the journal ----------------------------------------------------------------------


def _journal_script(obs, path, rotate_bytes=0):
    j = obs.EventJournal(path, rank=1, world=4, run_id="r9", rotate_bytes=rotate_bytes)
    rng = np.random.default_rng(3)
    for i in range(12):
        j.emit("step", step=i, cost=float(rng.standard_normal()), arr=np.arange(3),
               scalar=np.float32(0.5), tag="x" * int(rng.integers(0, 40)))
    with obs.tracing.trace("t-1"):
        j.emit("restart", restart=1)
        j.emit("span", name="s", trace="explicit")
    j.close()


@pytest.mark.parametrize("rotate_bytes", [0, 700], ids=["one-file", "rotated"])
def test_journal_events_match_jax(rotate_bytes, tmp_path):
    """Tags, numpy coercion, the ambient and an explicit trace, rotation:
    the events less ``ts`` equal the JAX journal's, segment by segment."""
    jobs, tobs = _both()
    out = {}
    for name, obs in (("jax", jobs), ("port", tobs)):
        d = tmp_path / name
        d.mkdir()
        _journal_script(obs, str(d / "events.jsonl"), rotate_bytes)
        out[name] = (_less_ts(obs.read_events(str(d))),
                     [os.path.basename(p) for p in obs.journal_segments(str(d / "events.jsonl"))])
    assert out["port"] == out["jax"]
    evs, segments = out["port"]
    assert len(evs) == 14 and evs[0]["rank"] == 1 and evs[0]["arr"] == [0, 1, 2]
    assert evs[12]["trace"] == "t-1" and evs[13]["trace"] == "explicit"
    assert len(segments) == (1 if not rotate_bytes else len(segments)) and (
        rotate_bytes == 0 or len(segments) > 2)


def test_journal_tolerates_torn_tail_but_not_mid_corruption(tmp_path):
    jobs, tobs = _both()
    for obs in (jobs, tobs):
        path = str(tmp_path / f"{obs.__name__}.jsonl")
        j = obs.EventJournal(path)
        j.emit("a")
        j.emit("b")
        j.close()
        with open(path, "a") as f:
            f.write('{"kind": "torn-mid-wri')  # killed mid-append, no newline
        assert [e["kind"] for e in obs.read_events(path)] == ["a", "b"]
        with open(path, "a") as f:
            f.write('\n{"kind": "c"}\n')  # the torn line is now mid-file
        with pytest.raises(ValueError, match="corrupt event line"):
            obs.read_events(path)


def test_null_journal_builds_events_without_io(tmp_path):
    _, obs = _both()
    ev = obs.NullJournal().emit("step", step=1)
    assert ev["kind"] == "step" and ev["step"] == 1 and "ts" in ev
    assert not os.listdir(tmp_path)


def test_append_event_one_shot(tmp_path):
    _, obs = _both()
    path = str(tmp_path / "events.jsonl")
    obs.append_event(path, "bench_point", tool="t", value=1.0)
    obs.append_event(path, "bench_point", tool="t", value=2.0)
    assert [e["value"] for e in obs.read_events(path)] == [1.0, 2.0]


def test_configure_default_journal(tmp_path):
    _, obs = _both()
    try:
        obs.configure(str(tmp_path), rank=0)
        assert obs.emit("step", step=3)["rank"] == 0
        assert obs.read_events(str(tmp_path))[0]["step"] == 3
    finally:
        obs.configure()
    assert isinstance(obs.get_journal(), obs.NullJournal)


def test_journal_takes_host_values_and_refuses_a_device_tensor(tmp_path, monkeypatch):
    """Host tensors and numpy coerce through ``item()`` / ``tolist()``; a
    tensor on a device is refused before anything is written (its
    ``item()`` would synchronize the card: the trainers journal values
    they have already fetched)."""
    _, obs = _both()
    j = obs.EventJournal.in_dir(str(tmp_path))
    j.emit("x", a=torch.tensor(1.5), b=torch.arange(3), c=np.float64(2.0))

    class OnDevice:  # what a CUDA tensor looks like to the coercion
        device = torch.device("cuda", 0)
        ndim = 0

        def item(self):  # pragma: no cover - must not be reached
            raise AssertionError("item() called")

    with pytest.raises(TypeError, match="fetch it to the host first"):
        j.emit("y", v=OnDevice())
    j.close()
    assert _less_ts(obs.read_events(str(tmp_path))) == [
        {"kind": "x", "a": 1.5, "b": [0, 1, 2], "c": 2.0}]


@pytest.mark.cuda
def test_journal_refuses_a_cuda_tensor(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, obs = _both()
    j = obs.EventJournal.in_dir(str(tmp_path))
    with pytest.raises(TypeError, match="cuda"):
        j.emit("y", v=torch.ones((), device="cuda"))
    j.close()


def _env_cases(tmp):
    return [
        ({"DTF_EVENTS_PATH": f"{tmp}/explicit.jsonl", "DTF_RUN_ID": "run7"}, None),
        ({"DTF_JOURNAL_DIR": tmp, "DTF_RANK": "2", "DTF_WORLD_SIZE": "4"}, None),
        ({"DTF_JOURNAL_DIR": tmp}, 5),
        ({"DTF_JOURNAL_DIR": tmp}, None),
        ({"DTF_JOURNAL_DIR": tmp, "DTF_JOURNAL_ROTATE_BYTES": "64",
          "DTF_JOURNAL_FSYNC": "1"}, 1),
        ({}, None),
    ]


def test_configure_from_env_matches_jax(tmp_path):
    """DTF_EVENTS_PATH, DTF_JOURNAL_DIR (per-rank file from the argument or
    DTF_RANK), DTF_WORLD_SIZE, DTF_RUN_ID, DTF_JOURNAL_ROTATE_BYTES and
    DTF_JOURNAL_FSYNC arm the same journal as JAX's, announced by the same
    ``worker_start`` event; no knob is a no-op."""
    from distributed_tensorflow_tpu.observability import journal as jj
    from distributed_tensorflow_tpu_torch.observability import journal as tj

    for i, (env, rank) in enumerate(_env_cases(str(tmp_path))):
        got = {}
        for name, mod in (("jax", jj), ("port", tj)):
            d = tmp_path / f"{name}{i}"
            d.mkdir()
            e = {k: v.replace(str(tmp_path), str(d)) for k, v in env.items()}
            try:
                j = mod.configure_from_env(rank, environ=e)
                if isinstance(j, mod.EventJournal):
                    j.emit("step", step=1, pad="p" * 80)
                    got[name] = (os.path.relpath(j.path, d), j.rank, j.world, j.run_id,
                                 j.rotate_bytes, j.fsync)
                    j.close()
                    got[name] += (_less_ts(mod.read_events(j.path)),)
                else:
                    got[name] = type(j).__name__
            finally:
                mod.configure()
        if isinstance(got["jax"], tuple):  # the pid differs between processes only
            assert got["port"][-1][0]["pid"] == os.getpid()
        assert got["port"] == got["jax"], env


def test_journal_fsync_opt_in(tmp_path):
    _, obs = _both()
    from distributed_tensorflow_tpu_torch.observability.journal import EventJournal

    j = EventJournal(str(tmp_path / "events.jsonl"), fsync=True)
    j.emit("step", value=1)
    j.emit("step", value=2)
    j.close()
    assert [e["value"] for e in obs.read_events(str(tmp_path))] == [1, 2]
    assert EventJournal(str(tmp_path / "x.jsonl")).fsync is False


# -- metrics ----------------------------------------------------------------------------


def test_metrics_counter_gauge_histogram():
    _, obs = _both()
    r = obs.MetricsRegistry()
    c = r.counter("requests_total")
    c.inc()
    c.inc(2)
    assert c.value == 3
    with pytest.raises(ValueError):
        c.inc(-1)
    g = r.gauge("queue_depth")
    g.set(5)
    g.dec()
    assert g.value == 4
    h = r.histogram("lat_s", edges=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 100.0):
        h.observe(v)
    assert h.counts == [1, 2, 0, 1] and h.count == 4
    assert h.quantile(0.5) == 1.0
    assert r.counter("requests_total") is c
    with pytest.raises(TypeError):
        r.gauge("requests_total")


def _fill(obs, rng):
    r = obs.MetricsRegistry()
    for name in ("x_total", "bytes_total"):
        r.counter(name).inc(float(rng.integers(0, 10**9)))
    r.gauge("world_size", labels={"gang": "g0"}).set(float(rng.integers(1, 9)))
    r.gauge("slots_busy", labels={"b": "2", "a": "1"}).set(float(rng.random()))
    h = r.histogram("step_time_ms", edges=obs.TIME_MS_EDGES)
    lat = r.histogram("lat_s", labels={"route": "r"})
    for v in np.exp(rng.normal(0, 3, 200)):
        h.observe(float(v))
        lat.observe(float(v) / 1000)
    return r


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_and_snapshot_match_jax(seed):
    """Seeded observations into both registries: the Prometheus text byte
    for byte, the snapshot and the quantiles equal."""
    jobs, tobs = _both()
    j, t = _fill(jobs, np.random.default_rng(seed)), _fill(tobs, np.random.default_rng(seed))
    assert t.prometheus_text() == j.prometheus_text()
    assert t.snapshot() == j.snapshot()
    for q in (0.0, 0.5, 0.95, 1.0):
        assert (t.histogram("lat_s", labels={"route": "r"}).quantile(q)
                == j.histogram("lat_s", labels={"route": "r"}).quantile(q))
    assert "# TYPE x_total counter" in t.prometheus_text()


def test_metrics_flush_to_journal(tmp_path):
    _, obs = _both()
    r = obs.MetricsRegistry()
    r.counter("epochs_total").inc(2)
    j = obs.EventJournal.in_dir(str(tmp_path))
    r.flush_to(j, component="trainer")
    j.close()
    (ev,) = obs.read_events(str(tmp_path), kind="metrics")
    assert ev["component"] == "trainer" and ev["metrics"]["epochs_total"][0]["value"] == 2


# -- spans ------------------------------------------------------------------------------


def test_dispatch_span_requires_d2h_fetch():
    """A dispatch span refuses to close without a fetch; the fetch of a
    tensor comes back as host numpy, the span's args say ``barrier: d2h``."""
    _, obs = _both()
    rec = obs.SpanRecorder()
    with pytest.raises(RuntimeError, match="without a D2H fetch"):
        with rec.dispatch("train_step"):
            pass
    with rec.dispatch("train_step") as sp:
        out = sp.fetch(torch.tensor([1.5, 2.5]) * 2)
    assert isinstance(out, np.ndarray) and out.tolist() == [3.0, 5.0]
    with rec.dispatch("scalar") as sp:
        assert float(sp.fetch(np.float32(1.5))) == 1.5
    spans = [s for s in rec.spans if s["args"].get("barrier") == "d2h"]
    assert [s["name"] for s in spans] == ["train_step", "scalar"]
    with pytest.raises(ValueError):
        obs.force_host(None)


def test_dispatch_span_error_is_recorded_not_masked():
    _, obs = _both()
    rec = obs.SpanRecorder()
    with pytest.raises(RuntimeError, match="boom"):
        with rec.dispatch("bad"):
            raise RuntimeError("boom")
    assert rec.spans[-1]["args"]["error"] is True


def test_dispatch_fetch_with_a_tensor_and_autograd():
    """``dispatch_fetch`` detaches a tensor that requires grad, copies it
    to the host, and records the span from the mark."""
    _, obs = _both()
    rec = obs.SpanRecorder()
    mark = rec.mark()
    x = torch.arange(4.0, requires_grad=True) * 1
    host = rec.dispatch_fetch("scan", x, start=mark, epoch=0)
    assert host.tolist() == [0.0, 1.0, 2.0, 3.0]
    assert rec.spans[-1]["args"] == {"epoch": 0, "barrier": "d2h"}
    assert rec.spans[-1]["dur_us"] >= 0


@pytest.mark.cuda
def test_dispatch_fetch_of_a_cuda_tensor_waits_for_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, obs = _both()
    rec = obs.SpanRecorder()
    mark = rec.mark()
    x = torch.randn(2048, 2048, device="cuda")
    y = x @ x
    host = rec.dispatch_fetch("mm", y.sum(), start=mark)
    assert isinstance(host, np.ndarray) and np.isfinite(host)
    assert rec.spans[-1]["args"]["barrier"] == "d2h"


def test_chrome_trace_export_loads(tmp_path):
    _, obs = _both()
    from distributed_tensorflow_tpu_torch.observability.spans import chrome_trace

    j = obs.EventJournal.in_dir(str(tmp_path))
    rec = obs.SpanRecorder(journal=j)
    with rec.span("compile", cat="host"):
        pass
    with rec.dispatch("step") as sp:
        sp.fetch(1.0)
    out = rec.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(out) as f:
        trace = json.load(f)
    assert trace["displayTimeUnit"] == "ms"
    assert [e["name"] for e in trace["traceEvents"]] == ["compile", "step"]
    for e in trace["traceEvents"]:
        assert e["ph"] == "X" and isinstance(e["ts"], float) and isinstance(e["dur"], float)
    j.close()
    again = chrome_trace(obs.read_events(str(tmp_path), kind="span"))
    assert [e["name"] for e in again["traceEvents"]] == ["compile", "step"]


# -- format: every renderer, byte for byte --------------------------------------------

_RENDER_CASES = {
    "step": dict(step=7, epoch=1, batch=7, batch_count=550, cost=2.345678, avg_ms=0.1234),
    "step-wide": ("step", dict(step=55000, epoch=100, batch=550, batch_count=550, cost=12.0,
                               avg_ms=1234.5)),
    "epoch": dict(metric="Test-Accuracy", value=0.8163, total_time_s=21.456),
    "epoch-perplexity": ("epoch", dict(metric="Test-Perplexity", value=12.3456789,
                                       total_time_s=3.0)),
    "final": dict(cost=0.54321),
    "restart": dict(restart=2, max_restarts=3, cause="worker0=rc=1", backoff_s=1.25),
    "restart-independent": ("restart", dict(restart=1, max_restarts=3, cause="w1=dead",
                                            backoff_s=0.5, independent=True,
                                            members=["worker1", "worker3"])),
    "restart_exhausted": dict(restarts=3, max_restarts=3, cause="worker1=dead"),
    "resize": dict(world=1, from_world=2, min_workers=1, direction="shrink",
                   dropped=["worker1"], rejoined=[], restart=1, max_restarts=3),
    "resize_denied": dict(world=0, min_workers=1, restarts=2, max_restarts=3,
                          cause="worker0=dead"),
    "rollback": dict(anomaly="spike", epoch=4, detected_step=400, restored_step=300,
                     rollback=1, max_rollbacks=3),
    "rollback_compiled": {},
    "preemption": dict(signal=15),
    "preemption-saved": ("preemption", dict(signal=15, saved_step=70)),
    "preemption-disarmed": ("preemption", dict(disarmed="non-main thread")),
    "heartbeat": dict(rank=2, step=400),
    "stall": dict(member="worker1", age_s=42.125, stall_after_s=30.0),
    "restore": dict(global_batch=200, from_world=2, world=1, config_batch=100,
                    config_global=100, per_replica=200),
    "replica_dead": dict(replica="r1", verdict="rc=-9", rerouted=3, attempt=1, max_restarts=2),
    "replica_relaunch": dict(replica="r1", attempt=1, max_restarts=2, backoff_s=0.25),
    "replica_benched": dict(replica="r1", restarts=2, max_restarts=2),
    "fleet_below_floor": dict(replicas=1, min_replicas=2, cause="r0=dead"),
    "serve_drain": dict(residents=3, queued=1),
    "weight_swap": dict(step=120, from_step=60, source="ckpt"),
    "mailbox_corrupt": dict(mailbox="delta", file="w0_r3.npz", reason="crc",
                            action="skipped", peer=0, round=3),
    "mailbox_corrupt-fleet": ("mailbox_corrupt", dict(mailbox="fleet",
                                                      file="00000002-t1.json", reason="json",
                                                      action="quarantined", box="outbox")),
    "failpoint": dict(name="delta.post", fault="torn", hit=2),
    "breaker_open": dict(replica="r2", failures=3, reason="2 route timeout(s)", reset_s=5.0),
    "breaker_half_open": dict(replica="r2"),
    "breaker_close": dict(replica="r2"),
    "fleet_roles": dict(roles={"r1": "decode", "r0": "prefill"}, migrate_dir="/m"),
    "request_migrated": dict(trace="t1", from_replica="r0", post="p.npz", blocks=4, nbytes=99),
    "kv_migration": dict(phase="import", trace="t1", slot=2, blocks=4, nbytes=99, wall_ms=1.5),
}


@pytest.mark.parametrize("case", sorted(_RENDER_CASES))
def test_renderer_matches_jax(case):
    """Each renderer of ``observability/format`` on the same event gives
    the JAX package's line(s) byte for byte, and the port has every JAX
    kind."""
    from distributed_tensorflow_tpu.observability import format as jf
    from distributed_tensorflow_tpu_torch.observability import format as tf

    spec = _RENDER_CASES[case]
    kind, fields = spec if isinstance(spec, tuple) else (case, spec)
    assert set(tf.RENDERERS) == set(jf.RENDERERS)
    ev = {"kind": kind, **fields}
    assert tf.render(kind, ev) == jf.render(kind, ev)


def test_every_renderer_has_a_case():
    from distributed_tensorflow_tpu_torch.observability import format as tf

    kinds = {s[0] if isinstance(s, tuple) else c for c, s in _RENDER_CASES.items()}
    assert kinds == set(tf.RENDERERS)


def test_step_logger_byte_parity_and_events_match_jax(tmp_path):
    """The same calls on both packages' ``StepLogger`` with a journal: the
    same printed lines (Total Time masked) and the same events less ``ts``
    (``total_time_s`` and ``avg_ms`` are wall clock and set equal here)."""
    from distributed_tensorflow_tpu.utils.logging import StepLogger as JLogger
    from distributed_tensorflow_tpu_torch.utils.logging import StepLogger

    jobs, tobs = _both()
    out = {}
    for name, cls, obs in (("jax", JLogger, jobs), ("port", StepLogger, tobs)):
        j = obs.EventJournal.in_dir(str(tmp_path / name))
        lines = []
        lg = cls(freq=2, print_fn=lines.append, journal=j)
        lg._begin_time = 1000.0
        for i in range(5):
            lg.log_step_line(step=i + 1, epoch=0, batch=i, batch_count=5, cost=2.0 / (i + 1),
                             avg_ms=0.25 * i)
        lg.log_epoch(test_accuracy=0.8156)
        lg.log_epoch_metric("Test-Perplexity", 12.3456)
        lg.log_final(cost=0.0123)
        j.close()
        evs = [{k: (0.0 if k == "total_time_s" else v) for k, v in e.items() if k != "ts"}
               for e in obs.read_events(str(tmp_path / name))]
        out[name] = ([re.sub(r"Total Time: *[0-9.]+s", "T", x) for x in lines], evs)
    assert out["port"] == out["jax"]
    lines = out["port"][0]
    assert lines[0].startswith("Step: 1,  Epoch:  1,  Batch:   1 of   5,")
    assert "Test-Accuracy: 0.82" in lines and lines[-1] == "Done"


def test_lifecycle_event_lands_in_stdout_journal_and_tfevents(tmp_path, monkeypatch):
    """``utils/summary.lifecycle_event`` of both packages, at a pinned wall
    time: the printed line, the journal events less ``ts`` and the tfevents
    file's bytes equal."""
    from distributed_tensorflow_tpu.utils import summary as js
    from distributed_tensorflow_tpu_torch.utils import summary as ts

    jobs, tobs = _both()
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    out = {}
    for name, obs, summ in (("jax", jobs, js), ("port", tobs, ts)):
        d = tmp_path / name
        j = obs.EventJournal.in_dir(str(d))
        w = summ.SummaryWriter(str(d))
        lines = []
        cases = [("restart", ("restart", 1.0, 1), _RENDER_CASES["restart"]),
                 ("resize", ("world_size", 1.0, 1), _RENDER_CASES["resize"]),
                 ("rollback", ("rollback", 300.0, 400), _RENDER_CASES["rollback"])]
        for kind, scalar, fields in cases:
            summ.lifecycle_event(kind, print_fn=lines.append, journal=j, writer=w,
                                 scalar=scalar, **fields)
        w.close()
        j.close()
        with open(w.path, "rb") as f:
            out[name] = (lines, _less_ts(obs.read_events(str(d))), f.read())
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == "Restart: restart=2/3 cause[worker0=rc=1] backoff_s=1.2"


_STRUCTURED_LITERAL = re.compile(
    r"""["']f?(Restart|Resize|Rollback|Preemption|Restore|Stall|Heartbeat|Failpoint):|"""
    r"""f["'](Restart|Resize|Rollback|Preemption|Restore|Stall|Heartbeat|Failpoint):"""
)


def test_no_structured_line_literals_outside_format():
    """The lifecycle lines' wording lives in the port's
    ``observability/format.py`` only: everything else emits an event."""
    offenders = []
    for dirpath, _, files in os.walk(PKG):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, PKG)
            if rel == os.path.join("observability", "format.py"):
                continue
            with open(path, encoding="utf-8") as f:
                for lineno, line in enumerate(f, 1):
                    if _STRUCTURED_LITERAL.search(line):
                        offenders.append(f"{rel}:{lineno}: {line.strip()}")
    assert not offenders, "\n".join(offenders)


# -- tracing, aggregation, the exporter ---------------------------------------------------


def test_tracing_ambient_nesting_and_explicit_override():
    _, obs = _both()
    t = obs.tracing
    assert t.current_trace() is None
    with t.trace() as outer:
        assert re.fullmatch(r"[0-9a-f]{16}", outer)
        with t.trace("inner"):
            assert obs.NullJournal().emit("x")["trace"] == "inner"
            assert obs.NullJournal().emit("x", trace="mine")["trace"] == "mine"
        assert obs.NullJournal().emit("x")["trace"] == outer
    assert "trace" not in obs.NullJournal().emit("x")
    assert t.new_trace_id() != t.new_trace_id()


def _gang_events(t0):
    """Three journals: a driver with restarts, two ranks with their own
    copies of the restart (one skewed by 2 s), spans, a heartbeat and an
    injected fault."""
    drv = [{"ts": t0 + 1, "kind": "restart", "restart": 1, "max_restarts": 2,
            "cause": "rank1=rc=1", "backoff_s": 0.5},
           {"ts": t0 + 5, "kind": "gang_sync", "sync": 7}]
    r0 = [{"ts": t0 + 0.5, "kind": "worker_start", "pid": 1, "rank": 0},
          {"ts": t0 + 1.0, "kind": "restart", "restart": 1, "max_restarts": 2,
           "cause": "rank1=rc=1", "backoff_s": 0.5, "rank": 0},
          {"ts": t0 + 2, "kind": "span", "name": "epoch_scan", "cat": "dispatch",
           "ts_us": 5.0, "dur_us": 1500.0, "args": {"epoch": 0}, "rank": 0},
          {"ts": t0 + 3, "kind": "heartbeat", "step": 10, "rank": 0}]
    r1 = [{"ts": t0 + 3.0, "kind": "restart", "restart": 1, "max_restarts": 2,
           "cause": "rank1=rc=1", "backoff_s": 0.5, "rank": 1},
          {"ts": t0 + 7.0, "kind": "gang_sync", "sync": 7, "rank": 1},
          {"ts": t0 + 8.0, "kind": "failpoint", "name": "delta.post", "fault": "torn",
           "hit": 2, "rank": 1}]
    return {"driver": drv, "rank0": r0, "rank1": r1}


def test_aggregate_merge_trace_and_summary_match_jax(tmp_path):
    """The same three journals (files under a logdir, discovered) through
    both aggregators: the skew estimate, the merged timeline, the gang
    chrome trace and the fleet summary equal."""
    from distributed_tensorflow_tpu.observability import aggregate as ja
    from distributed_tensorflow_tpu_torch.observability import aggregate as ta

    jobs, tobs = _both()
    names = {"driver": "events.jsonl", "rank0": "events-rank0.jsonl",
             "rank1": "events-rank1.jsonl"}
    for label, evs in _gang_events(1000.0).items():
        with open(tmp_path / names[label], "w") as f:
            f.writelines(json.dumps(e) + "\n" for e in evs)
    assert ta.discover_journals(str(tmp_path)) == ja.discover_journals(str(tmp_path))
    got, want = ta.merge(str(tmp_path)), ja.merge(str(tmp_path))
    assert got == want
    assert got["ranks"] == ["driver", "rank0", "rank1"] and got["skew_s"]["rank1"] == 2.0
    assert ta.gang_chrome_trace(got) == ja.gang_chrome_trace(want)
    assert ta.fleet_summary(got) == ja.fleet_summary(want)
    trace = ta.gang_chrome_trace(got)
    lanes = {e["args"]["name"] for e in trace["traceEvents"] if e["ph"] == "M"}
    assert lanes == {"driver", "rank0", "rank1"}


def test_exporter_serves_metrics_and_healthz():
    from urllib.request import urlopen

    _, obs = _both()
    reg = obs.MetricsRegistry()
    reg.gauge("world_size").set(2)
    reg.counter("epochs_total").inc(3)
    calls = []

    def health():
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("raced a shutdown")
        return {"ok": 1}

    with obs.MetricsExporter(reg, port=0, health_fn=health) as exp:
        assert exp.port and exp.url.startswith("http://127.0.0.1:")
        assert urlopen(exp.url + "/metrics").read().decode() == reg.prometheus_text()
        hz = json.loads(urlopen(exp.url + "/healthz").read())
        assert hz["status"] == "ok" and hz["ok"] == 1
        hz = json.loads(urlopen(exp.url + "/healthz").read())
        assert hz["error"].startswith("RuntimeError")
        with pytest.raises(Exception):
            urlopen(exp.url + "/nope")
    assert exp.port is None


def test_observability_imports_and_runs_without_jax_or_torch(tmp_path):
    """The port's ``observability`` package, ``utils/summary`` and
    ``utils/logging`` import and run in a process where both ``jax`` and
    ``torch`` are poisoned stubs: journal, metrics, spans, render, the
    step logger, tfevents, lifecycle lines, tracing, aggregation and the
    exporter."""
    stub = tmp_path / "stubs"
    stub.mkdir()
    for mod in ("jax", "torch"):
        (stub / f"{mod}.py").write_text(f'raise ImportError("{mod} deliberately unavailable")\n')
    script = textwrap.dedent(
        """
        import json, sys
        from urllib.request import urlopen
        import distributed_tensorflow_tpu_torch.observability as obs
        from distributed_tensorflow_tpu_torch.observability import aggregate, tracing
        from distributed_tensorflow_tpu_torch.observability import format as F
        from distributed_tensorflow_tpu_torch.train import failpoints
        from distributed_tensorflow_tpu_torch.utils import summary
        from distributed_tensorflow_tpu_torch.utils.logging import StepLogger

        for mod in ("jax", "torch"):
            try:
                __import__(mod)
            except ImportError:
                pass
            else:
                raise SystemExit(f"stub failed: {mod} imported")
        d = %(d)r
        j = obs.configure(d)  # the process default: failpoint events land here too
        lines = []
        lg = StepLogger(freq=1, print_fn=lines.append, journal=j)
        lg.log_step_line(step=1, epoch=0, batch=0, batch_count=2, cost=1.5, avg_ms=2.0)
        summary.lifecycle_event("restart", print_fn=lines.append, journal=j, restart=1,
                                max_restarts=2, cause="x=rc=1", backoff_s=0.5)
        r = obs.MetricsRegistry()
        r.counter("c_total").inc()
        r.flush_to(j)
        rec = obs.SpanRecorder(journal=j)
        with rec.span("host_work"):
            pass
        with rec.dispatch("d") as sp:
            sp.fetch(1.0)
        failpoints.configure("journal.append:delay=0@1")
        j.emit("gang_sync", sync=1)
        failpoints.configure(None)
        obs.configure()
        kinds = [e["kind"] for e in obs.read_events(d)]
        assert kinds == ["step", "restart", "metrics", "span", "span", "failpoint",
                         "gang_sync"], kinds
        assert lines[0].startswith("Step: 1,") and lines[1].startswith("Restart: restart=1/2")
        w = summary.SummaryWriter(d)
        w.add_scalar("cost", 1.5, 1)
        w.close()
        assert summary.crc32c(b"123456789") == 0xE3069283
        with tracing.trace("t-nt"):
            assert obs.NullJournal().emit("x")["trace"] == "t-nt"
        rj = obs.EventJournal(obs.rank_journal_path(d, 0), rank=0)
        rj.emit("worker_start", pid=1)
        rj.close()
        merged = aggregate.merge(d)
        assert set(merged["ranks"]) == {"driver", "rank0"}
        assert aggregate.gang_chrome_trace(merged)["traceEvents"]
        with obs.MetricsExporter(r, health_fn=lambda: {"ok": 1}) as exp:
            assert "c_total 1" in urlopen(exp.url + "/metrics").read().decode()
        print("NO-JAX-NO-TORCH-OK")
        """
        % {"d": str(tmp_path)}
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{stub}{os.pathsep}{REPO}"
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=120, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "NO-JAX-NO-TORCH-OK" in out.stdout


# -- the trainers through both packages ---------------------------------------------------

_MASK = re.compile(r"AvgTime: *[0-9.]+ms|Total Time: *[0-9.]+s")
_VALUE = re.compile(r"((?:Cost|Test-Accuracy|Test-Perplexity): )(-?[0-9.]+)")


def _split_lines(lines):
    """Lines with AvgTime and Total Time masked and each printed cost,
    accuracy and perplexity taken out (compared within a tolerance), and
    those values."""
    masked, values = [], []
    for ln in lines:
        m = _VALUE.search(ln)
        if m:
            values.append(float(m.group(2)))
        masked.append(_VALUE.sub(r"\1#", _MASK.sub("T", ln)))
    return masked, values


def _shape(events):
    """Each event's kind and sorted keys, ``ts`` and ``trace`` aside."""
    return [(e["kind"], sorted(k for k in e if k not in ("ts", "trace"))) for e in events]


def test_mlp_trainer_journal_matches_jax(small_datasets, tmp_path):
    """The MLP ``Trainer`` (eager, f32, two epochs) from the same weights
    through both packages with a journal and a metrics registry: the same
    kinds and keys in the same order, the same step and epoch numbers, the
    costs and accuracies within 1.5e-4 (the trainers' parity tolerance),
    the metrics snapshot's counts equal, one trace id a run."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu.data import mnist as jm
    from distributed_tensorflow_tpu.models.mlp import MLP as JMLP
    from distributed_tensorflow_tpu.models.mlp import MLPParams as JParams
    from distributed_tensorflow_tpu.train.trainer import Trainer as JTrainer
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.convert import mlp_params_from_numpy
    from distributed_tensorflow_tpu_torch.data import mnist as tm
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.train.trainer import Trainer

    from _torch_parity import mlp_numpy_params

    d = small_datasets
    arrays = (d.train.images[:2000], d.train.labels[:2000], d.test.images[:500],
              d.test.labels[:500])

    def data(mod):
        x, y, tx, ty = arrays
        return mod.Datasets(train=mod.DataSet(x, y, seed=1),
                            validation=mod.DataSet(tx[:10], ty[:10], seed=3),
                            test=mod.DataSet(tx, ty, seed=2))

    tree = mlp_numpy_params(seed=11)
    jobs, tobs = _both()
    jj, tj = (o.EventJournal.in_dir(str(tmp_path / n)) for o, n in ((jobs, "j"), (tobs, "t")))
    jlines, tlines = [], []
    jtr = JTrainer(JMLP(compute_dtype=jnp.float32), data(jm),
                   JConfig(epochs=2, log_frequency=6, logs_path="", scan_epoch=False),
                   print_fn=lambda *a: jlines.append(" ".join(map(str, a))), journal=jj)
    jtr.state = jtr.state._replace(params=JParams(*(jnp.asarray(tree[k]) for k in JParams._fields)))
    jtr.run()
    ttr = Trainer(MLP(compute_dtype=torch.float32), data(tm),
                  TrainConfig(epochs=2, log_frequency=6, logs_path=""), print_fn=tlines.append,
                  device="cpu", journal=tj)
    ttr.state = ttr.state._replace(params=mlp_params_from_numpy(tree, device="cpu"))
    ttr.run()
    jj.close()
    tj.close()
    je, te = jobs.read_events(str(tmp_path / "j")), tobs.read_events(str(tmp_path / "t"))
    assert _shape(te) == _shape(je)
    assert [e["kind"] for e in te] == ["step"] * 4 + ["epoch"] + ["step"] * 4 + ["epoch",
                                                                                 "final", "metrics"]
    for a, b in zip(te, je):
        if a["kind"] == "step":
            assert (a["step"], a["epoch"], a["batch"], a["batch_count"]) == (
                b["step"], b["epoch"], b["batch"], b["batch_count"])
            assert abs(a["cost"] - b["cost"]) <= 1.5e-4
        elif a["kind"] in ("epoch", "final"):
            assert abs(a.get("value", a.get("cost")) - b.get("value", b.get("cost"))) <= 1.5e-4
    ts, js_ = te[-1]["metrics"], je[-1]["metrics"]
    assert set(ts) == set(js_) == {"epochs_total", "step_time_ms"}
    assert ts["epochs_total"][0]["value"] == js_["epochs_total"][0]["value"] == 2
    assert ts["step_time_ms"][0]["count"] == js_["step_time_ms"][0]["count"] == 2
    assert len({e["trace"] for e in te}) == 1 and te[0]["trace"]
    (tm_, tc), (jm_, jc) = _split_lines(tlines), _split_lines(jlines)
    assert tm_ == jm_ and len(tc) == 4 + 1 + 4 + 1 + 1
    np.testing.assert_allclose(tc, jc, atol=1.5e-4)


def _lm_pair(tmp_path, name, mesh_kind, cfg):
    """A 2-layer GPT through both packages' LMTrainer from the same numpy
    parameters (``_torch_local_sgd.data``'s tree and batches), SGD 0.05,
    each with a journal and a metrics registry."""
    import jax
    from jax.sharding import Mesh as JMesh

    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu.data.tokens import TokenDataset as JDS
    from distributed_tensorflow_tpu.data.tokens import TokenDatasets as JDSS
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu.train import LMTrainer as JTrainer
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import TokenDataset, TokenDatasets
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    from _torch_local_sgd import MODEL, TRAIN_CFG, data
    from _torch_parity import jax_model, jax_params, torch_params

    tree, _, inp = data()
    jobs, tobs = _both()
    out = {}
    base = dict(TRAIN_CFG, epochs=2, log_frequency=2, **cfg)
    for who in ("jax", "port"):
        d = tmp_path / f"{name}-{who}"
        lines = []
        if who == "jax":
            j, reg = jobs.EventJournal.in_dir(str(d)), jobs.MetricsRegistry()
            ds = JDSS(JDS(inp["train"], seed=1), JDS(inp["val"], seed=2), JDS(inp["val"], seed=3))
            mesh = JMesh(np.array(jax.devices()[:1]), ("data",)) if mesh_kind else None
            jcfg = {k: v for k, v in base.items() if k != "compute_dtype"}
            tr = JTrainer(jax_model(**MODEL), ds, JConfig(**jcfg, scan_epoch=False, logs_path=""),
                          mesh=mesh, optimizer=joptim.make("sgd", 0.05), print_fn=lines.append,
                          journal=j, metrics=reg)
            tr.state = tr._init_state(jax_params(tree))
        else:
            j, reg = tobs.EventJournal.in_dir(str(d)), tobs.MetricsRegistry()
            ds = TokenDatasets(TokenDataset(inp["train"], seed=1),
                               TokenDataset(inp["val"], seed=2), TokenDataset(inp["val"], seed=3))
            mesh = Mesh({"data": 1}) if mesh_kind else None
            tr = LMTrainer(GPTLM(**MODEL, compute_dtype=torch.float32), ds, TrainConfig(**base),
                           device="cpu", print_fn=lines.append, optimizer=optim.make("sgd", 0.05),
                           mesh=mesh, journal=j, metrics=reg)
            tr.state = tr._init_state(torch_params(tree))
        tr.run()
        j.close()
        out[who] = (tr, (jobs if who == "jax" else tobs).read_events(str(d)), lines,
                    reg.prometheus_text())
    return out


@pytest.mark.parametrize("mode", ["dp", "diloco"])
def test_lm_trainer_journal_and_comm_stats_match_jax(mode, tmp_path):
    """The LM trainer in ``dp`` (a mesh of one rank) and ``diloco`` (the
    one-device gang of 4 workers, H=2, int8 deltas) through both packages:
    the same event kinds and keys in the same order, equal step and epoch
    numbers and ``comm_stats`` integers (rounds, dense and payload bytes,
    workers), costs within 2e-4 (the LM parity tests' four places), the
    masked stdout lines equal, and the three communication counters in
    the Prometheus text equal."""
    from _torch_local_sgd import DILOCO, N

    cfg = {} if mode == "dp" else dict(dp_mode="diloco", diloco_workers=N,
                                       delta_dtype="int8", **DILOCO)
    pair = _lm_pair(tmp_path, mode, mode == "dp", cfg)
    (jtr, je, jl, jtext), (ttr, te, tl, ttext) = pair["jax"], pair["port"]
    assert ttr.mode == jtr.mode == mode
    assert _shape(te) == _shape(je)
    kinds = [e["kind"] for e in te]
    assert kinds.count("comm_stats") == 2 and kinds[-2:] == ["final", "metrics"]
    for a, b in zip(te, je):
        if a["kind"] == "comm_stats":
            keys = ("epoch", "mode", "steps", "sync_every", "sync_rounds", "allreduce_bytes",
                    "payload_bytes", "delta_dtype", "overlap", "workers")
            assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
        elif a["kind"] == "step":
            assert (a["step"], a["epoch"], a["batch"]) == (b["step"], b["epoch"], b["batch"])
            assert abs(a["cost"] - b["cost"]) <= 2e-4
    cs = [e for e in te if e["kind"] == "comm_stats"]
    steps = cs[0]["steps"]
    assert steps == ttr.datasets.train.num_examples // ttr.config.batch_size
    if mode == "diloco":
        assert [c["sync_rounds"] for c in cs] == [steps // 2] * 2 and cs[0]["workers"] == N
        assert cs[0]["payload_bytes"] < cs[0]["allreduce_bytes"] / 3.9
    else:
        assert [c["sync_rounds"] for c in cs] == [steps] * 2 and cs[0]["workers"] == 1
        assert cs[0]["payload_bytes"] == cs[0]["allreduce_bytes"]
    for name in ("sync_rounds_total", "allreduce_bytes_total", "payload_bytes_total",
                 "epochs_total"):
        line = re.compile(rf"^{name} .*$", re.M)
        assert line.search(ttext).group(0) == line.search(jtext).group(0)
    (tm_, tc), (jm_, jc) = _split_lines(tl), _split_lines(jl)
    assert tm_ == jm_
    # Costs to their four printed places, perplexities within rtol 1e-4
    # (the LM parity tests' tolerances).
    np.testing.assert_allclose(tc, jc, atol=2e-4, rtol=1e-4)
