"""PyTorch port: the failpoint seam (``train/failpoints.py``) against the JAX
package's.

The same schedules parse to the same armed specs (or the same errors), the
same ``fire`` / ``tear`` sequences give the same hit counts, faults and
journaled ``failpoint`` events, and the registry is JAX's name for name,
so a ``DTF_FAILPOINTS`` schedule one package accepts the other accepts
too. The seams whose call sites the port has (``journal.append``,
``journal.rotate``) fire in its journal; the checkpoint and mailbox seams
(``atomic.*``, ``ckpt.*``, ``delta.*``) are held in
tests/test_torch_resilience.py and tests/test_torch_local_sgd.py.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _mods():
    from distributed_tensorflow_tpu.observability import journal as jj
    from distributed_tensorflow_tpu.train import failpoints as jf
    from distributed_tensorflow_tpu_torch.observability import journal as tj
    from distributed_tensorflow_tpu_torch.train import failpoints as tf

    return (jf, jj), (tf, tj)


@pytest.fixture(autouse=True)
def _disarmed():
    for fp, _ in _mods():
        fp.configure(None)
    yield
    for fp, _ in _mods():
        fp.configure(None)


def _fp():
    return _mods()[1][0]


# -- the grammar ----------------------------------------------------------------------


def test_registry_is_the_jax_registry():
    (jf, _), (tf, _) = _mods()
    assert tf.REGISTERED == jf.REGISTERED
    assert tf.ENV_VAR == jf.ENV_VAR == "DTF_FAILPOINTS"
    assert issubclass(tf.FailpointError, OSError)


def test_parse_grammar_roundtrips():
    fp = _fp()
    fp.configure("ckpt.manifest:torn@2, delta.load:raise ,"
                 "journal.append:delay=0.05@3+,atomic.write.commit:kill")
    assert fp.active() == {
        "ckpt.manifest": ["ckpt.manifest:torn@2"],
        "delta.load": ["delta.load:raise@1"],
        "journal.append": ["journal.append:delay=0.05@3+"],
        "atomic.write.commit": ["atomic.write.commit:kill@1"],
    }


def test_parse_multiple_specs_per_name():
    fp = _fp()
    fp.configure("ckpt.manifest:torn@3,ckpt.manifest:torn@4")
    assert fp.active()["ckpt.manifest"] == ["ckpt.manifest:torn@3", "ckpt.manifest:torn@4"]


_BAD = ["no.such.seam:raise", "delta.load:explode", "delta.load:raise@0",
        "delta.load:raise=1.0", "delta.load", "delta.load:delay=x", "delta.load:raise@two"]


@pytest.mark.parametrize("spec", _BAD)
def test_bad_entries_fail_as_in_jax(spec):
    """A malformed entry raises ValueError in both packages, with the same
    message."""
    (jf, _), (tf, _) = _mods()
    with pytest.raises(ValueError) as want:
        jf.configure(spec)
    with pytest.raises(ValueError) as got:
        tf.configure(spec)
    assert str(got.value) == str(want.value)


def _random_schedule(rng) -> str:
    names = sorted(_fp().REGISTERED)
    entries = []
    for _ in range(int(rng.integers(1, 6))):
        kind = ["raise", "torn", "delay", "kill"][int(rng.integers(0, 4))]
        e = f"{names[int(rng.integers(0, len(names)))]}:{kind}"
        if kind == "delay" and rng.random() < 0.5:
            e += f"={rng.random():.3f}"
        if rng.random() < 0.7:
            e += f"@{int(rng.integers(1, 9))}" + ("+" if rng.random() < 0.4 else "")
        entries.append(e)
    return " , ".join(entries)


@pytest.mark.parametrize("seed", range(4))
def test_random_schedules_parse_as_in_jax(seed, monkeypatch):
    """Seeded random schedules, through ``configure`` and through the
    environment (``reset``): the same armed specs in both packages."""
    (jf, _), (tf, _) = _mods()
    rng = np.random.default_rng(seed)
    for _ in range(20):
        spec = _random_schedule(rng)
        jf.configure(spec)
        tf.configure(spec)
        assert tf.active() == jf.active(), spec
    monkeypatch.setenv("DTF_FAILPOINTS", spec)
    jf.reset()
    tf.reset()
    assert tf.active() == jf.active() != {}


def test_reset_rearms_from_env(monkeypatch):
    fp = _fp()
    monkeypatch.setenv(fp.ENV_VAR, "delta.load:raise@2")
    fp.reset()
    assert fp.active() == {"delta.load": ["delta.load:raise@2"]}
    monkeypatch.delenv(fp.ENV_VAR)
    fp.reset()
    assert fp.active() == {}


def test_arm_stacks_and_resets_that_names_counter():
    fp = _fp()
    fp.configure("delta.load:raise@5")
    fp.fire("delta.load")
    assert fp.hit_count("delta.load") == 1
    fp.arm("delta.load:delay=0@9")
    assert fp.hit_count("delta.load") == 0
    assert len(fp.active()["delta.load"]) == 2


# -- fault kinds and hits ---------------------------------------------------------------


def test_default_off_is_a_noop_and_never_counts():
    fp = _fp()
    for _ in range(3):
        fp.fire("delta.load")
    assert fp.hit_count("delta.load") == 0
    assert fp.tear("delta.post", "/nonexistent") is False
    with pytest.raises(ValueError):
        fp.hit_count("no.such.seam")


def test_raise_on_nth_hit_only():
    fp = _fp()
    fp.configure("delta.load:raise@3")
    fp.fire("delta.load")
    fp.fire("delta.load")
    with pytest.raises(fp.FailpointError, match=r"delta.load:raise@3 \(hit 3\)"):
        fp.fire("delta.load")
    fp.fire("delta.load")
    assert fp.hit_count("delta.load") == 4


def test_persistent_raise_every_hit_from_n():
    fp = _fp()
    fp.configure("delta.load:raise@2+")
    fp.fire("delta.load")
    for _ in range(3):
        with pytest.raises(fp.FailpointError):
            fp.fire("delta.load")


def test_delay_sleeps_arg_seconds():
    fp = _fp()
    fp.configure("journal.rotate:delay=0.05")
    t0 = time.perf_counter()
    fp.fire("journal.rotate")
    assert time.perf_counter() - t0 >= 0.05


def test_tear_truncates_committed_file_on_matching_hit(tmp_path):
    fp = _fp()
    p = str(tmp_path / "post.npz")
    fp.configure("delta.post:torn@2")
    with open(p, "wb") as f:
        f.write(b"x" * 100)
    fp.fire("delta.post")
    assert fp.tear("delta.post", p) is False
    assert os.path.getsize(p) == 100
    fp.fire("delta.post")
    assert fp.tear("delta.post", p) is True
    assert os.path.getsize(p) == 50
    assert fp.hit_count("delta.post") == 2


def _drive(fp, jmod, d, rng_seed, path):
    """A seeded sequence of fire/tear calls under one schedule, journaling
    into ``d``: returns (the outcome of each call, the hit counts, the
    journal's events less ``ts``)."""
    rng = np.random.default_rng(rng_seed)
    schedule = ("delta.load:raise@2+,delta.post:torn@3,delta.post:delay=0@1+,"
                "fleet.read:raise@4,ckpt.save:delay=0@2,atomic.write:torn@1+")
    j = jmod.configure(d)
    out = []
    try:
        fp.configure(schedule)
        for _ in range(40):
            name = ["delta.load", "delta.post", "fleet.read", "ckpt.save", "atomic.write",
                    "elastic.health"][int(rng.integers(0, 6))]
            try:
                fp.fire(name)
                res = "ok"
            except fp.FailpointError as e:
                res = f"raise {str(e).split(' (hit')[0]}"
            if name in ("delta.post", "atomic.write"):
                with open(path, "wb") as f:
                    f.write(b"y" * 64)
                res += f" tear={fp.tear(name, path)} size={os.path.getsize(path)}"
            out.append((name, res))
        hits = {n: fp.hit_count(n) for n in sorted(fp.REGISTERED)}
    finally:
        fp.configure(None)
        j.close()
        jmod.configure()
    return out, hits, [{k: v for k, v in e.items() if k != "ts"}
                       for e in jmod.read_events(d)]


@pytest.mark.parametrize("seed", range(3))
def test_fire_sequence_hits_and_events_match_jax(seed, tmp_path):
    """The same schedule and the same seeded sequence of hits through both
    packages: the same raises and tears, the same hit counts, the same
    ``failpoint`` events in the process journal."""
    (jf, jj), (tf, tj) = _mods()
    got = {}
    for name, fp, jmod in (("jax", jf, jj), ("port", tf, tj)):
        got[name] = _drive(fp, jmod, str(tmp_path / name), seed, str(tmp_path / f"{name}.bin"))
    assert got["port"] == got["jax"]
    events = got["port"][2]
    assert events and {e["kind"] for e in events} == {"failpoint"}
    assert {e["fault"] for e in events} >= {"raise", "torn"}


def test_kill_sigkills_the_process():
    code = (
        "from distributed_tensorflow_tpu_torch.train import failpoints\n"
        "failpoints.configure('elastic.relaunch:kill')\n"
        "failpoints.fire('elastic.relaunch')\n"
        "print('UNREACHED')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == -9
    assert "UNREACHED" not in proc.stdout


def test_env_schedule_arms_a_subprocess_at_import(tmp_path):
    """``DTF_FAILPOINTS`` arms the seam when the module is imported: a
    worker gets its schedule with no code of its own, and the kill kind
    flushes the worker's journal first."""
    code = (
        "from distributed_tensorflow_tpu_torch import observability as obs\n"
        f"j = obs.configure({str(tmp_path)!r})\n"
        "j.emit('step', step=1)\n"
        "j.emit('step', step=2)\n"
        "print('UNREACHED')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["DTF_FAILPOINTS"] = "journal.append:kill@2"
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == -9 and "UNREACHED" not in proc.stdout
    from distributed_tensorflow_tpu_torch import observability as obs

    evs = obs.read_events(str(tmp_path))
    assert [(e["kind"], e.get("step", e.get("fault"))) for e in evs] == [
        ("step", 1), ("failpoint", "kill")]


# -- the journal's own seams ---------------------------------------------------------------


def test_fired_failpoint_journals_event_without_recursion(tmp_path):
    """A delay on ``journal.append`` fires on every emit, the failpoint
    event's own append included; the reentrancy guard keeps that inner
    append from counting or recursing. Events equal JAX's."""
    (jf, jj), (tf, tj) = _mods()
    got = {}
    for name, fp, jmod in (("jax", jf, jj), ("port", tf, tj)):
        d = str(tmp_path / name)
        j = jmod.configure(d)
        try:
            fp.configure("journal.append:delay=0@1")
            j.emit("gang_sync", sync=1)
            j.emit("gang_sync", sync=2)
            hits = fp.hit_count("journal.append")
        finally:
            fp.configure(None)
            j.close()
            jmod.configure()
        got[name] = ([{k: v for k, v in e.items() if k != "ts"} for e in jmod.read_events(d)],
                     hits)
    assert got["port"] == got["jax"]
    events, hits = got["port"]
    assert [e["kind"] for e in events] == ["failpoint", "gang_sync", "gang_sync"]
    assert events[0] == {"kind": "failpoint", "name": "journal.append", "fault": "delay",
                         "hit": 1}
    assert hits == 2


def test_journal_append_raise_writes_nothing(tmp_path):
    (tf, tj) = _mods()[1]
    j = tj.EventJournal.in_dir(str(tmp_path))
    tf.configure("journal.append:raise@2")
    j.emit("a")
    with pytest.raises(tf.FailpointError):
        j.emit("b")
    j.emit("c")
    j.close()
    assert [e["kind"] for e in tj.read_events(str(tmp_path))] == ["a", "c"]


def test_journal_rotate_fires_its_failpoint(tmp_path):
    """``journal.rotate`` fires once a rotation; a raise there leaves the
    active file unrotated and its events readable."""
    (tf, tj) = _mods()[1]
    j = tj.EventJournal(str(tmp_path / "events.jsonl"), rotate_bytes=120)
    tf.configure("journal.rotate:delay=0@1+")
    for i in range(8):
        j.emit("step", step=i, pad="p" * 30)
    rotations = tf.hit_count("journal.rotate")
    assert rotations >= 2
    assert len(tj.journal_segments(j.path)) == rotations + 1
    tf.configure("journal.rotate:raise@1")
    with pytest.raises(tf.FailpointError):
        j.emit("step", step=8, pad="p" * 30)
    j.close()
    assert [e["step"] for e in tj.read_events(j.path)] == list(range(8))


def test_failpoint_line_and_gang_timeline():
    """The ``Failpoint:`` line, and a failpoint on a rank's journal is a
    per-rank instant of the gang trace and a line of the fleet summary,
    never a skew anchor."""
    from distributed_tensorflow_tpu_torch.observability import aggregate
    from distributed_tensorflow_tpu_torch.observability import format as tf_format

    assert tf_format.render("failpoint", {"name": "delta.post", "fault": "torn", "hit": 2}) == [
        "Failpoint: name=delta.post fault=torn hit=2"]
    t0 = 1000.0
    merged = aggregate.merge({"rank0": [
        {"ts": t0, "kind": "worker_start", "pid": 1},
        {"ts": t0 + 1, "kind": "failpoint", "name": "delta.post", "fault": "torn", "hit": 2},
    ]})
    names = [e["name"] for e in aggregate.gang_chrome_trace(merged)["traceEvents"]
             if e.get("ph") == "i"]
    assert "failpoint" in names and "failpoint" not in aggregate.GANG_KINDS
    summary = aggregate.fleet_summary(merged)
    assert [x["kind"] for x in summary["lifecycle"]] == ["failpoint"]
    assert summary["lifecycle"][0]["line"].startswith("Failpoint: ")
