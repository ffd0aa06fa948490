"""PyTorch port: the summaries (``utils/summary.py``), the profiler
(``utils/profiler.py``), the timing barriers (``utils/sync.py``) and their
wiring into the trainers and the launcher, against the JAX package where
both have the same surface.

Bit for bit: ``crc32c`` and the masked CRC over seeded random byte strings,
the tfevents bytes of the same scalars at a pinned wall time, the
two-point median over the same timings, ``DTF_LOGS``. The graph dump is the
step the trainer runs, traced on fake tensors: its ``GraphDef`` decodes, its
edges point at nodes that exist, the flash operator is one node each way,
the trace launches nothing and leaves the data stream where it was, and a
run with every sink attached computes what a run without them computes.
"""

from __future__ import annotations

import json
import os
import re
import struct
import time

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (sets torch's thread count for xdist workers)

# -- the wire format --------------------------------------------------------------------


def _records(path):
    """The TFRecords of a tfevents file, each CRC checked."""
    from distributed_tensorflow_tpu_torch.utils.summary import _masked_crc

    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return out
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == _masked_crc(header)
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            assert dcrc == _masked_crc(data)
            out.append(data)


def _varint(buf, i):
    shift = out = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return out, i


def _fields(buf):
    """A protobuf message's (field, wire type, value) triples."""
    i, out = 0, []
    while i < len(buf):
        key, i = _varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        else:
            n, i = _varint(buf, i)
            v, i = buf[i:i + n], i + n
        out.append((field, wire, v))
    return out


def _event(record):
    """Decoded ``Event``: wall_time, step, and the scalar (tag, value), the
    file version or the graph_def bytes it carries."""
    ev = {}
    for f, _, v in _fields(record):
        if f == 1:
            ev["wall_time"] = struct.unpack("<d", v)[0]
        elif f == 2:
            ev["step"] = v
        elif f == 3:
            ev["version"] = v.decode()
        elif f == 4:
            ev["graph"] = v
        elif f == 5:
            (_, _, value), = _fields(v)
            tag = val = None
            for g, _, w in _fields(value):
                if g == 1:
                    tag = w.decode()
                elif g == 2:
                    val = struct.unpack("<f", w)[0]
            ev["scalar"] = (tag, val)
    return ev


def _graph_nodes(graph_def):
    """``[(name, op, inputs, attrs)]`` of a serialized GraphDef."""
    nodes = []
    for f, _, v in _fields(graph_def):
        if f != 1:
            continue
        name = op = None
        inputs, attrs = [], {}
        for g, _, w in _fields(v):
            if g == 1:
                name = w.decode()
            elif g == 2:
                op = w.decode()
            elif g == 3:
                inputs.append(w.decode())
            elif g == 5:
                entry = dict((h, x) for h, _, x in _fields(w))
                attrs[entry[1].decode()] = dict((h, x) for h, _, x in _fields(entry[2]))[2].decode()
        nodes.append((name, op, inputs, attrs))
    return nodes


def _writer_events(path):
    return [_event(r) for r in _records(path)]


# -- CRC32C and the tfevents bytes ---------------------------------------------------------


def test_crc32c_known_vectors():
    from distributed_tensorflow_tpu_torch.utils.summary import crc32c

    # RFC 3720 test vectors.
    assert crc32c(b"") == 0x00000000
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(bytes(32)) == 0x8A9136AA
    assert crc32c(bytes([0xFF] * 32)) == 0x62A8AB43


@pytest.mark.parametrize("seed", range(3))
def test_crc32c_and_masked_crc_match_jax(seed):
    """Seeded random byte strings of random lengths: ``crc32c`` and the
    TFRecord-masked CRC equal the JAX package's (whose masked CRC takes its
    native runtime where built, the pure table otherwise)."""
    from distributed_tensorflow_tpu.utils import summary as js
    from distributed_tensorflow_tpu_torch.utils import summary as ts

    rng = np.random.default_rng(seed)
    for _ in range(50):
        data = rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8).tobytes()
        assert ts.crc32c(data) == js.crc32c(data)
        assert ts._masked_crc(data) == js._masked_crc(data) == js._masked_crc_py(data)


def test_tfevents_bytes_match_jax_at_a_pinned_wall_time(tmp_path, monkeypatch):
    """The same scalars (seeded values, tags and steps) at a pinned wall
    time: the port's file is the JAX writer's byte for byte."""
    from distributed_tensorflow_tpu.utils import summary as js
    from distributed_tensorflow_tpu_torch.utils import summary as ts

    monkeypatch.setattr(time, "time", lambda: 1700000123.5)
    rng = np.random.default_rng(7)
    scalars = [(["cost", "accuracy", "perplexity"][int(rng.integers(0, 3))],
                float(rng.standard_normal() * 10), int(rng.integers(0, 10**6)))
               for _ in range(40)]
    blobs = {}
    for name, mod in (("jax", js), ("port", ts)):
        w = mod.SummaryWriter(str(tmp_path / name))
        for tag, value, step in scalars:
            w.add_scalar(tag, value, step)
        w.add_scalars({"a": 1.0, "b": 2.0}, 9)
        w.close()
        with open(w.path, "rb") as f:
            blobs[name] = f.read()
    assert blobs["port"] == blobs["jax"]
    evs = _writer_events(str(next((tmp_path / "port").iterdir())))
    assert evs[0] == {"wall_time": 1700000123.5, "version": "brain.Event:2"}
    assert [e["scalar"][0] for e in evs[1:]] == [t for t, _, _ in scalars] + ["a", "b"]
    assert evs[1]["step"] == scalars[0][2]


def test_two_writers_of_one_second_keep_their_own_files(tmp_path, monkeypatch):
    """The file name carries the pid and a count a process, so two writers
    of one logdir and one second never share a file."""
    from distributed_tensorflow_tpu_torch.utils.summary import SummaryWriter

    monkeypatch.setattr(time, "time", lambda: 1700000000.0)
    a, b = SummaryWriter(str(tmp_path)), SummaryWriter(str(tmp_path))
    a.add_scalar("x", 1.0, 1)
    b.add_scalar("x", 2.0, 1)
    a.close()
    b.close()
    assert a.path != b.path and f".{os.getpid()}." in a.path
    assert [e["scalar"][1] for e in _writer_events(b.path)[1:]] == [2.0]


# -- the graph ---------------------------------------------------------------------------


def test_add_graph_writes_one_graph_event_that_decodes(tmp_path):
    """A function's graph: placeholders for its tensors, one node an op
    with its output shape, every edge to a node that exists; a ``None``
    argument stays out of the signature."""
    from distributed_tensorflow_tpu_torch.utils.summary import SummaryWriter

    def fn(w, b, skip, x):
        assert skip is None
        return torch.tanh(x @ w + b).sum()

    w = SummaryWriter(str(tmp_path))
    w.add_graph(fn, torch.ones(4, 3), torch.ones(3), None, torch.ones(2, 4))
    w.close()
    graphs = [e["graph"] for e in _writer_events(w.path) if "graph" in e]
    assert len(graphs) == 1
    nodes = _graph_nodes(graphs[0])
    names = {n for n, _, _, _ in nodes}
    ops = [op for _, op, _, _ in nodes]
    assert ops.count("Placeholder") == 3
    assert {"aten.mm", "aten.add", "aten.tanh", "aten.sum"} <= set(ops)
    assert all(i in names for _, _, inputs, _ in nodes for i in inputs)
    mm = next(n for n in nodes if n[1] == "aten.mm")
    assert mm[3]["output"] == "float32[2, 3]"


def test_kernel_graph_def_is_one_named_node():
    from distributed_tensorflow_tpu_torch.utils.summary import kernel_graph_def

    nodes = _graph_nodes(kernel_graph_def("mlp_epoch_kernel", {"w1": torch.ones(784, 100),
                                                                "xs": torch.ones(3, 2)}))
    assert nodes[-1] == ("mlp_epoch_kernel", "mlp_epoch_kernel", ["w1", "xs"], {})
    assert nodes[0] == ("w1", "Placeholder", [], {"output": "float32[784, 100]"})


def _mlp_data(n=600):
    from distributed_tensorflow_tpu_torch.data import mnist as tm

    rng = np.random.default_rng(0)
    x = rng.random((n, 784), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return tm.Datasets(train=tm.DataSet(x, y, seed=1), validation=tm.DataSet(x[:10], y[:10]),
                       test=tm.DataSet(x[:200], y[:200], seed=2))


@pytest.mark.parametrize("path", ["eager", "scanned", "compiled"])
def test_mlp_trainer_summaries(path, tmp_path):
    """The chief writes the step's graph once (``run`` twice), a ``cost``
    scalar at each logged step equal to the printed cost, an ``accuracy``
    each epoch; the eager, scanned and compiled paths alike. The costs
    equal a run's without the writer."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.train.trainer import Trainer
    from distributed_tensorflow_tpu_torch.utils.summary import SummaryWriter

    kw = {"eager": dict(scan_epoch=False), "scanned": dict(scan_epoch=True),
          "compiled": dict(compiled_run=True)}[path]
    cfg = TrainConfig(epochs=2, log_frequency=2, logs_path="", **kw)
    runs = {}
    for with_writer in (True, False):
        lines = []
        w = SummaryWriter(str(tmp_path)) if with_writer else None
        tr = Trainer(MLP(), _mlp_data(), cfg, print_fn=lines.append, device="cpu",
                     summary_writer=w)
        tr.run()
        tr.run(epochs=1)
        runs[with_writer] = (lines, w)
    lines, w = runs[True]
    assert runs[False][0] and [re.sub(r"AvgTime.*|Total Time.*", "", x) for x in lines] == [
        re.sub(r"AvgTime.*|Total Time.*", "", x) for x in runs[False][0]]
    w.close()
    evs = _writer_events(w.path)
    graphs = [e for e in evs if "graph" in e]
    assert len(graphs) == 1
    ops = {op for _, op, _, _ in _graph_nodes(graphs[0]["graph"])}
    assert {"aten.mm", "aten.sigmoid", "aten._softmax"} <= ops
    costs = [e["scalar"] + (e["step"],) for e in evs if e.get("scalar", ("",))[0] == "cost"]
    printed = [(float(m.group(2)), int(m.group(1))) for m in
               (re.search(r"Step: (\d+),.*Cost: ([0-9.]+)", x) for x in lines) if m]
    assert len(costs) == len(printed) == 3 * 3  # batches 2, 4 and 6 of 6, three epochs
    assert [(round(v, 4), s) for _, v, s in costs] == printed
    accs = [e for e in evs if e.get("scalar", ("",))[0] == "accuracy"]
    assert [e["step"] for e in accs] == [6, 12, 18]


def test_non_chief_writes_nothing_and_pallas_graph_is_the_kernel(tmp_path):
    """A non-chief trainer writes no graph and no scalar; a compiled run on
    ``engine="pallas"`` dumps its epoch kernel as one node over the
    parameters and the epoch's bf16 batches."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.train.trainer import Trainer
    from distributed_tensorflow_tpu_torch.utils.summary import SummaryWriter

    w = SummaryWriter(str(tmp_path / "worker"))
    Trainer(MLP(), _mlp_data(), TrainConfig(epochs=1, logs_path=""), print_fn=lambda *a: None,
            device="cpu", summary_writer=w, is_chief=False).run()
    w.close()
    assert len(_records(w.path)) == 1  # the file version alone
    w = SummaryWriter(str(tmp_path / "pallas"))
    tr = Trainer(MLP(), _mlp_data(), TrainConfig(epochs=1, compiled_run=True, engine="pallas",
                                                 logs_path=""),
                 print_fn=lambda *a: None, device="cpu", summary_writer=w)
    tr.write_graph()
    w.close()
    (graph,) = [e["graph"] for e in _writer_events(w.path) if "graph" in e]
    nodes = _graph_nodes(graph)
    assert nodes[-1][:3] == ("mlp_epoch_kernel", "mlp_epoch_kernel",
                             ["w1", "b1", "w2", "b2", "xs", "ys"])
    assert dict((n, a["output"]) for n, op, _, a in nodes if op == "Placeholder") == {
        "w1": "float32[784, 100]", "b1": "float32[100]", "w2": "float32[100, 10]",
        "b2": "float32[10]", "xs": "bfloat16[6, 100, 784]", "ys": "bfloat16[6, 100, 10]"}


def _lm(tmp_path, **sinks):
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import copy_corpus
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    model = GPTLM(vocab_size=61, max_len=16, model_dim=32, num_heads=4, num_layers=2,
                  attention_impl="flash", flash_min_len=0, compute_dtype=torch.float32)
    ds = copy_corpus(num=256, half_len=8, vocab=61, n_val=32, n_test=32, seed=0)
    lines = []
    tr = LMTrainer(model, ds, TrainConfig(epochs=2, batch_size=64, optimizer="adam",
                                          learning_rate=3e-3, log_frequency=2), device="cpu",
                   print_fn=lines.append, eval_batch=16, **sinks)
    return tr, lines


def test_lm_graph_traces_the_step_without_running_it(tmp_path):
    """The LM trainer's graph is its step: ``dtf.FlashAttention`` and
    ``dtf.FlashAttentionBackward`` one node a layer, the optimizer's update
    in aten ops. The trace runs no operator (no flash launch counted, the
    parameters untouched) and draws no index from the data stream."""
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.utils.summary import SummaryWriter

    w = SummaryWriter(str(tmp_path))
    tr, _ = _lm(tmp_path, summary_writer=w)
    before = dict(_build.LAUNCHES)
    embed = tr.state.params.embed.clone()
    train = tr.datasets.train
    stream = (train._index, train._epochs_completed, train._perm.copy())
    tr.write_graph()
    w.close()
    assert _build.LAUNCHES == before and torch.equal(tr.state.params.embed, embed)
    assert (train._index, train._epochs_completed) == stream[:2]
    assert np.array_equal(train._perm, stream[2])
    (graph,) = [e["graph"] for e in _writer_events(w.path) if "graph" in e]
    ops = [op for _, op, _, _ in _graph_nodes(graph)]
    assert ops.count("dtf.FlashAttention") == ops.count("dtf.FlashAttentionBackward") == 2
    assert "aten.mm" in ops or "aten.bmm" in ops


def test_lm_run_with_every_sink_equals_the_run_without(tmp_path):
    """``run`` then ``run_compiled`` with a summary writer, a journal, a
    metrics registry and ``profile_dir``, against the same runs with none
    (one thread: the CPU's threaded sums do not repeat bit for bit): the
    same costs and perplexities bit for bit, the same parameters; the
    tfevents hold one graph, the logged costs and each epoch's
    perplexity; the profile's Chrome trace loads."""
    import dataclasses

    from distributed_tensorflow_tpu_torch import observability as obs
    from distributed_tensorflow_tpu_torch.utils.summary import SummaryWriter

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for on in (True, False):
            sinks = {}
            if on:
                sinks = dict(summary_writer=SummaryWriter(str(tmp_path / "tb")),
                             journal=obs.EventJournal.in_dir(str(tmp_path / "j")),
                             metrics=obs.MetricsRegistry())
            tr, lines = _lm(tmp_path, **sinks)
            if on:
                tr.config = dataclasses.replace(tr.config, profile_dir=str(tmp_path / "prof"))
            a = tr.run()
            b = tr.run_compiled(1)
            out[on] = (tr, lines, a, b, sinks)
    finally:
        torch.set_num_threads(threads)
    (tr, lines, a, b, sinks), (tr0, lines0, a0, b0, _) = out[True], out[False]
    mask = lambda ls: [re.sub(r"AvgTime.*|Total Time.*", "", x) for x in ls]  # noqa: E731
    assert mask(lines) == mask(lines0) and (a, b) == (a0, b0)
    assert all(torch.equal(x, y) for x, y in zip(tr.state.params.embed, tr0.state.params.embed))
    sinks["summary_writer"].close()
    sinks["journal"].close()
    evs = _writer_events(sinks["summary_writer"].path)
    assert sum("graph" in e for e in evs) == 1
    tags = [e["scalar"][0] for e in evs if "scalar" in e]
    assert tags.count("perplexity") == 3 and tags.count("cost") == 3 * 2
    kinds = [e["kind"] for e in obs.read_events(str(tmp_path / "j"))]
    assert kinds.count("final") == 2 and kinds.count("metrics") == 2
    spans = [e["name"] for e in obs.read_events(str(tmp_path / "j"), kind="span")]
    assert spans == ["torch_profiler_trace", "lm_compiled_run"]
    (trace,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / trace) as f:
        assert json.load(f)["traceEvents"]
    snap = sinks["metrics"].snapshot()
    assert snap["epochs_total"][0]["value"] == 2 and snap["step_time_ms"][0]["count"] == 3


# -- the profiler and the barriers -----------------------------------------------------------


def test_profiler_trace_on_the_cpu_and_start_server(tmp_path):
    """On the CPU the trace records host ops (no device asked for), writes a
    Chrome trace into the logdir and records the capture window as a
    ``torch_profiler_trace`` span; ``start_server`` has no PyTorch
    counterpart and raises."""
    from distributed_tensorflow_tpu_torch.observability import SpanRecorder
    from distributed_tensorflow_tpu_torch.utils import profiler

    rec = SpanRecorder()
    with profiler.trace(str(tmp_path / "p"), rec, device="cpu") as prof:
        with profiler.annotate("region", rec):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(prof.path) == str(tmp_path / "p") and prof.device_events == 0
    with open(prof.path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names and "region" in names
    assert [s["name"] for s in rec.spans] == ["region", "torch_profiler_trace"]
    with pytest.raises(NotImplementedError, match="no PyTorch counterpart"):
        profiler.start_server(9999)


@pytest.mark.cuda
def test_profiler_sees_the_flash_kernels_on_the_card(tmp_path):
    """On the card the trace holds the port's kernels by name, as many as
    their wrappers counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention
    from distributed_tensorflow_tpu_torch.utils import profiler

    q, k, v = (torch.randn(2, 128, 4, 64, device="cuda", requires_grad=True) for _ in range(3))
    flash_attention(q, k, v, causal=True).sum().backward()  # builds and warms
    before = dict(_build.LAUNCHES)
    with profiler.trace(str(tmp_path), device="cuda") as prof:
        flash_attention(q, k, v, causal=True).sum().backward()
    assert prof.lead_in_lost < profiler.LEAD_IN
    got = prof.count("flash_fwd_kernel", "kv_kernel", "dq_reduce_kernel")
    assert got["flash_fwd_kernel"] == _build.LAUNCHES["flash_fwd"] - before["flash_fwd"] == 1
    fused = _build.LAUNCHES["flash_bwd_fused"] - before["flash_bwd_fused"]
    assert got["kv_kernel"] == got["dq_reduce_kernel"] == fused == 1


def test_two_point_seconds_matches_jax():
    """The same timings through both packages' two-point median (the port's
    ``bench.py`` takes it from ``utils/sync``); clamped at 1e-12."""
    from distributed_tensorflow_tpu.utils.sync import two_point_seconds as jtp
    from distributed_tensorflow_tpu_torch import bench
    from distributed_tensorflow_tpu_torch.utils.sync import two_point_seconds as ttp

    assert bench.two_point_seconds is ttp
    rng = np.random.default_rng(5)
    for reps in (1, 3, 5, 7):
        shorts, longs = rng.random(reps).tolist(), (rng.random(reps) * 3).tolist()

        def timers():
            s, l_ = iter(shorts), iter(longs)
            return (lambda: next(s)), (lambda: next(l_))

        assert ttp(*timers(), span=4, reps=reps) == jtp(*timers(), span=4, reps=reps)
    assert ttp(lambda: 1.0, lambda: 0.5, span=1, reps=3) == 1e-12


def test_timed_fetch_and_d2h_barrier_on_host_tensors():
    from distributed_tensorflow_tpu_torch.utils.sync import d2h_barrier, timed_fetch

    secs, out = timed_fetch(lambda a: (a * 2, {"k": a}), torch.arange(3.0))
    assert secs >= 0 and out[0].tolist() == [0.0, 2.0, 4.0]
    d2h_barrier({"a": torch.ones(2), "b": [torch.zeros(1), 3, None]})


@pytest.mark.cuda
def test_timed_fetch_waits_for_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from distributed_tensorflow_tpu_torch.utils.sync import d2h_barrier, timed_fetch

    x = torch.randn(4096, 4096, device="cuda")
    secs, y = timed_fetch(lambda a: a @ a, x)
    d2h_barrier(y)
    assert secs > 0 and torch.isfinite(y).all()


# -- the launcher ------------------------------------------------------------------------------


def test_dtf_logs_as_jax_reads_it(monkeypatch):
    """``DTF_LOGS`` sets ``logs_path``, empty turns the summaries off, as
    the JAX launcher reads it; the default is JAX's ``./logs``."""
    from distributed_tensorflow_tpu.launch import config_from_env as jenv
    from distributed_tensorflow_tpu_torch.launch import config_from_env

    assert config_from_env().logs_path == jenv().logs_path == "./logs"
    for value in ("/tmp/tb", ""):
        monkeypatch.setenv("DTF_LOGS", value)
        assert config_from_env().logs_path == jenv().logs_path == value


def test_build_trainer_writes_summaries_on_the_chief_only(tmp_path):
    """``build_trainer`` gives the chief a ``SummaryWriter`` on
    ``logs_path`` (JAX ``launch.py:369-370``), a worker none, and an empty
    ``logs_path`` none."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.launch import build_trainer

    ctx = lambda chief: type("Ctx", (), {"is_chief": chief})()  # noqa: E731
    cfg = TrainConfig(epochs=1, logs_path=str(tmp_path / "tb"))
    chief = build_trainer(cfg, datasets=_mlp_data(), device="cpu", context=ctx(True),
                          print_fn=lambda *a: None)
    assert chief.summary_writer is not None and chief.summary_writer.path.startswith(
        str(tmp_path / "tb"))
    chief.run()
    assert any("graph" in e for e in _writer_events(chief.summary_writer.path))
    assert build_trainer(cfg, datasets=_mlp_data(), device="cpu", context=ctx(False)
                         ).summary_writer is None
    assert build_trainer(TrainConfig(logs_path=""), datasets=_mlp_data(), device="cpu"
                         ).summary_writer is None


def test_trainer_profile_dir_profiles_the_first_epoch(tmp_path):
    from distributed_tensorflow_tpu_torch import observability as obs
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.train.trainer import Trainer

    j = obs.EventJournal.in_dir(str(tmp_path))
    Trainer(MLP(), _mlp_data(), TrainConfig(epochs=2, logs_path="",
                                            profile_dir=str(tmp_path / "prof")),
            print_fn=lambda *a: None, device="cpu", journal=j).run()
    j.close()
    assert len(os.listdir(tmp_path / "prof")) == 1
    spans = obs.read_events(str(tmp_path), kind="span")
    assert [s["name"] for s in spans] == ["torch_profiler_trace"]
    assert spans[0]["args"]["logdir"] == str(tmp_path / "prof")
