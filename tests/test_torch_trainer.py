"""PyTorch port: the MNIST loader, the step logger, the Trainer and the
launcher, against the JAX package on the same data; the refusals of what
this slice does not port; the device rule of the entry points."""

from __future__ import annotations

import gzip
import re
import struct

import numpy as np
import pytest
import torch

from _torch_parity import mlp_numpy_params


def _pair_datasets(images, labels, test_images, test_labels):
    """The same arrays as a JAX and a port ``Datasets`` (train seed 1,
    test seed 2), each with its own next_batch stream."""
    from distributed_tensorflow_tpu.data import mnist as jm
    from distributed_tensorflow_tpu_torch.data import mnist as tm

    def make(mod):
        return mod.Datasets(
            train=mod.DataSet(images, labels, seed=1),
            validation=mod.DataSet(test_images[:10], test_labels[:10], seed=3),
            test=mod.DataSet(test_images, test_labels, seed=2),
        )

    return make(jm), make(tm)


@pytest.fixture(scope="module")
def small_pair(small_datasets):
    d = small_datasets
    return (d.train.images[:2000], d.train.labels[:2000],
            d.test.images[:500], d.test.labels[:500])


def test_synthetic_read_data_sets_is_bitwise_the_jax_one(datasets):
    from distributed_tensorflow_tpu_torch.data.mnist import read_data_sets

    ours = read_data_sets("MNIST_data", one_hot=True)
    for split in ("train", "validation", "test"):
        a, b = getattr(ours, split), getattr(datasets, split)
        for arr in ("images", "labels"):
            x, y = getattr(a, arr), getattr(b, arr)
            assert x.dtype == y.dtype and x.shape == y.shape, (split, arr)
            assert x.tobytes() == y.tobytes(), (split, arr)
    assert ours.train.num_examples == 55000 and ours.test.num_examples == 10000


def test_next_batch_streams_equal():
    """Tail-carry reshuffle included: 7 batches of 300 over 1000 rows."""
    from distributed_tensorflow_tpu.data.mnist import DataSet as JDataSet
    from distributed_tensorflow_tpu_torch.data.mnist import DataSet

    rng = np.random.default_rng(0)
    x = rng.random((1000, 784), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 1000)]
    a, b = DataSet(x, y, seed=5), JDataSet(x, y, seed=5)
    for _ in range(7):
        (ax, ay), (bx, by) = a.next_batch(300), b.next_batch(300)
        assert np.array_equal(ax, bx) and np.array_equal(ay, by)
    assert a.epochs_completed == b.epochs_completed == 2
    with pytest.raises(ValueError, match="labels"):
        DataSet(x, y[:10])


def test_idx_parser_matches_jax(tmp_path):
    """Real MNIST IDX files (gz and plain) read identically by both packages."""
    from distributed_tensorflow_tpu.data.mnist import read_data_sets as jread
    from distributed_tensorflow_tpu_torch.data.mnist import read_data_sets

    rng = np.random.default_rng(1)

    def write(name, magic, dims, data, gz):
        raw = struct.pack(">I" + "I" * len(dims), magic, *dims) + data.tobytes()
        path = tmp_path / (name + (".gz" if gz else ""))
        path.write_bytes(gzip.compress(raw) if gz else raw)

    for name, n, gz in (("train-images-idx3-ubyte", 5010, True),
                        ("t10k-images-idx3-ubyte", 20, False)):
        write(name, 2051, (n, 28, 28), rng.integers(0, 256, n * 784, dtype=np.uint8), gz)
    for name, n, gz in (("train-labels-idx1-ubyte", 5010, True),
                        ("t10k-labels-idx1-ubyte", 20, False)):
        write(name, 2049, (n,), rng.integers(0, 10, n, dtype=np.uint8), gz)
    ours, ref = read_data_sets(str(tmp_path)), jread(str(tmp_path))
    for split in ("train", "validation", "test"):
        for arr in ("images", "labels"):
            x, y = getattr(getattr(ours, split), arr), getattr(getattr(ref, split), arr)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (split, arr)
    assert ours.train.num_examples == 10


def test_stage_epoch_matches_jax():
    from distributed_tensorflow_tpu.train.scan import stage_epoch as jstage
    from distributed_tensorflow_tpu_torch.train.scan import stage_epoch

    rng = np.random.default_rng(2)
    x = rng.random((250, 784), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 250)]
    for seed in (None, 4):
        a = stage_epoch(x, y, 60, rng=None if seed is None else np.random.default_rng(seed))
        b = jstage(x, y, 60, rng=None if seed is None else np.random.default_rng(seed))
        for u, v in zip(a, b):
            assert u.shape == (4, 60, u.shape[-1]) and np.array_equal(u, np.asarray(v))


def test_step_logger_lines_are_byte_identical():
    """The step, epoch and final lines (rendered by the port's
    ``observability/format.py``, which ``utils/logging.StepLogger`` prints
    through) are the JAX package's byte for byte."""
    from distributed_tensorflow_tpu.observability import format as jformat
    from distributed_tensorflow_tpu_torch.observability import format as tlog

    events = [
        ("step", dict(step=7, epoch=1, batch=7, batch_count=550, cost=2.345678, avg_ms=0.1234)),
        ("step", dict(step=55000, epoch=100, batch=550, batch_count=550, cost=12.0,
                      avg_ms=1234.5)),
        ("epoch", dict(metric="Test-Accuracy", value=0.8163, total_time_s=21.456)),
        ("final", dict(cost=0.54321)),
    ]
    for kind, ev in events:
        assert tlog.render(kind, ev) == jformat.render(kind, ev)


_NUM = re.compile(r"-?\d+\.\d+")


def _masked(lines):
    """Lines with AvgTime and Total Time (wall clock) masked, and every
    other decimal number split out for a tolerance check."""
    out, nums = [], []
    for ln in lines:
        ln = re.sub(r"AvgTime: +[\d.]+ms", "AvgTime: #ms", ln)
        ln = re.sub(r"Total Time: +[\d.]+s", "Total Time: #s", ln)
        nums += [float(v) for v in _NUM.findall(ln)]
        out.append(_NUM.sub("#", ln))
    return out, nums


def test_eager_trainer_prints_the_jax_trainers_lines(small_pair):
    """compute_dtype=float32, the same initial weights and data: the eager
    loop prints the JAX Trainer's lines, with AvgTime and Total Time masked
    and the printed costs and accuracies equal to their last digit (f32
    sums in another order may move a printed cost by one unit)."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu.models.mlp import MLP as JMLP
    from distributed_tensorflow_tpu.models.mlp import MLPParams as JParams
    from distributed_tensorflow_tpu.train.trainer import Trainer as JTrainer
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.convert import mlp_params_from_numpy
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.train.trainer import Trainer

    tree = mlp_numpy_params(seed=11)
    jds, tds = _pair_datasets(*small_pair)
    jlines, tlines = [], []
    jtr = JTrainer(JMLP(compute_dtype=jnp.float32), jds,
                   JConfig(epochs=2, log_frequency=6, logs_path="", scan_epoch=False),
                   print_fn=lambda *a: jlines.append(" ".join(map(str, a))))
    jtr.state = jtr.state._replace(params=JParams(*(jnp.asarray(tree[k]) for k in JParams._fields)))
    jres = jtr.run()
    ttr = Trainer(MLP(compute_dtype=torch.float32), tds,
                  TrainConfig(epochs=2, log_frequency=6), print_fn=tlines.append, device="cpu")
    ttr.state = ttr.state._replace(params=mlp_params_from_numpy(tree, device="cpu"))
    tres = ttr.run()
    (jm, jn), (tm, tn) = _masked(jlines), _masked(tlines)
    assert tm == jm and len(tm) == 2 * (4 + 2) + 2  # 20 batches: steps 6,12,18,20
    np.testing.assert_allclose(tn, jn, atol=1.5e-4)
    assert tres["global_step"] == jres["global_step"] == 40
    np.testing.assert_allclose(tres["final_cost"], jres["final_cost"], rtol=1e-5)


def test_scanned_trainer_matches_the_eager_one(small_pair):
    """scan_epoch=True (the default on cuda) draws the eager loop's batches
    (the same seed-1 permutation stream) and updates identically."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.launch import build_trainer

    res, lines = {}, {}
    for scan in (False, True):
        _, tds = _pair_datasets(*small_pair)
        out = []
        tr = build_trainer(TrainConfig(epochs=1, scan_epoch=scan, log_frequency=5,
                                       compute_dtype="float32"),
                           datasets=tds, print_fn=out.append, device="cpu")
        assert (tr._indexed_fn is not None) == scan
        res[scan], lines[scan] = tr.run(), _masked(out)
    assert lines[True] == lines[False]
    assert res[True] == res[False]


def test_pallas_engine_learns_like_the_xla_engine(small_pair):
    """engine="pallas" (the epoch kernel's plain version on the CPU) behind
    the Trainer: the same surface as engine="xla" and comparable learning
    (different shuffle draws, as test_compiled_run.py holds the JAX pair)."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.train.trainer import Trainer

    def run(engine):
        _, tds = _pair_datasets(*small_pair)
        lines = []
        tr = Trainer(MLP(), tds, TrainConfig(epochs=3, compiled_run=True, engine=engine,
                                             log_frequency=8),
                     print_fn=lines.append, device="cpu")
        return tr.run(), lines, tr

    res_p, lines_p, tr_p = run("pallas")
    res_x, lines_x, _ = run("xla")
    assert res_p["global_step"] == res_x["global_step"] == 3 * 20
    assert _masked(lines_p)[0] == _masked(lines_x)[0]
    assert lines_p[-1] == "Done" and any(ln.startswith("Test-Accuracy:") for ln in lines_p)
    assert np.isfinite(res_p["final_cost"]) and np.isfinite(res_x["final_cost"])
    assert abs(res_p["final_cost"] - res_x["final_cost"]) < 0.35 * max(
        res_p["final_cost"], res_x["final_cost"]
    ), (res_p, res_x)
    assert tr_p.state.params.b1.ndim == 1  # a regular MLPParams again
    again = tr_p.run_compiled(1)
    assert again["global_step"] == 4 * 20 and len(tr_p.history) == 4


class _Momentum:
    """An optimizer with state: one update matches SGD, two do not."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return None

    def update(self, grads, v, params):
        v = grads if v is None else type(grads)(*(0.9 * a + g for a, g in zip(v, grads)))
        return type(params)(*(p - self.lr * a for p, a in zip(params, v))), v


@pytest.mark.parametrize("case", ["optimizer_config", "loss_config", "optimizer_object",
                                  "loss_object", "model"])
def test_pallas_engine_refuses_unsupported_workloads(case, small_pair):
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.ops import losses
    from distributed_tensorflow_tpu_torch.train.trainer import Trainer

    _, tds = _pair_datasets(*small_pair)
    cfg = dict(compiled_run=True, engine="pallas")
    kw = {}
    model = MLP()
    if case == "optimizer_config":
        cfg["optimizer"] = "adam"
    elif case == "loss_config":
        cfg["loss"] = "stable"
    elif case == "optimizer_object":
        kw["optimizer"] = _Momentum(0.001)
    elif case == "loss_object":
        kw["loss_fn"] = losses.stable_cross_entropy
    else:
        from distributed_tensorflow_tpu_torch.launch import _LogitsAdapter

        model = _LogitsAdapter(MLP())  # an MLP's attributes, not an MLP
    tr = Trainer(model, tds, TrainConfig(**cfg), print_fn=lambda *a: None, device="cpu", **kw)
    with pytest.raises(ValueError, match="pallas"):
        tr.run_compiled(1)


def test_not_ported_features_are_refused(monkeypatch, small_pair):
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.launch import build_trainer, config_from_env
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.train.trainer import Trainer

    _, tds = _pair_datasets(*small_pair)
    # Lifted by the checkpoint slice: the checkpoint fields are taken, with
    # the JAX package's validation.
    for kw in (dict(checkpoint_dir="/tmp/x"), dict(epochs_per_dispatch=10),
               dict(max_rollbacks=1)):
        assert TrainConfig(**kw).replace(**kw) == TrainConfig(**kw)
    for kw, msg in ((dict(epochs_per_dispatch=-1), "epochs_per_dispatch"),
                    (dict(max_rollbacks=-1), "max_rollbacks"),
                    (dict(keep_last_n=-1), "keep_last_n"), (dict(anomaly_window=0),
                                                            "anomaly_window")):
        with pytest.raises(ValueError, match=msg):
            TrainConfig(**kw)
    # Lifted by the observability slice: logs_path and profile_dir keep the
    # JAX defaults ("./logs", None); "" turns the summaries off.
    assert TrainConfig().logs_path == "./logs" and TrainConfig().profile_dir is None
    assert TrainConfig(logs_path="").logs_path == ""
    # Lifted by the local-SGD slice: dp_mode="diloco" is an LM mode, which the
    # classifier path refuses as JAX's launcher does.
    with pytest.raises(ValueError, match="unknown dp_mode 'diloco' for the classifier path"):
        build_trainer(TrainConfig(dp_mode="diloco"), datasets=tds, device="cpu")
    # Lifted by the MoE/quantized slice: matmul_dtype is validated as in the
    # JAX TrainConfig, and the classifier path refuses it as JAX's launcher.
    assert TrainConfig(matmul_dtype="int8").matmul_dtype == "int8"
    with pytest.raises(ValueError, match="matmul_dtype must be None, 'int8', or 'fp8'"):
        TrainConfig(matmul_dtype="int4")
    with pytest.raises(ValueError, match="LM-family knob"):
        build_trainer(TrainConfig(matmul_dtype="fp8"), datasets=tds, device="cpu")
    # Lifted by the optimizer wrappers: the schedule fields are accepted.
    assert TrainConfig(lr_schedule="cosine", warmup_steps=5, accumulate_steps=2,
                       grad_clip_norm=1.0).lr_schedule == "cosine"
    # Lifted by the data-parallel slice: sync=False (async, one rank here),
    # prefetch and a non-chief context are accepted and train.
    out = []
    tr = build_trainer(TrainConfig(epochs=1, sync=False, async_avg_every=3, prefetch=2,
                                   log_frequency=50),
                       context=type("Ctx", (), {"is_chief": False})(), datasets=tds,
                       device="cpu", print_fn=out.append)
    res = tr.run()
    assert res["global_step"] == tds.train.num_examples // 100 and np.isfinite(res["final_cost"])
    assert out and not any(ln.startswith(("Test-Accuracy", "Final Cost")) for ln in out)
    assert TrainConfig(checkpoint_dir="").checkpoint_dir == ""
    with pytest.raises(TypeError):
        TrainConfig(no_such_field=1)
    with pytest.raises(ValueError, match="engine"):
        TrainConfig(engine="tpu")
    import inspect

    assert "supervisor" in inspect.signature(Trainer).parameters
    # Lifted by the observability slice: the trainer takes the journal, the
    # metrics registry and the summary writer (tests/test_torch_summary.py
    # and test_torch_observability.py run them).
    assert {"summary_writer", "journal", "metrics"} <= set(inspect.signature(Trainer).parameters)
    monkeypatch.setenv("DTF_CHECKPOINT", "/tmp/ckpt")
    assert config_from_env().checkpoint_dir == "/tmp/ckpt"  # lifted by the checkpoint slice
    monkeypatch.delenv("DTF_CHECKPOINT")
    monkeypatch.setenv("DTF_MAX_RESTARTS", "2")
    with pytest.raises(NotImplementedError, match="A8c"):
        config_from_env()
    monkeypatch.delenv("DTF_MAX_RESTARTS")
    monkeypatch.setenv("DTF_EPOCHS", "3")
    monkeypatch.setenv("DTF_COMPILED", "1")
    monkeypatch.setenv("DTF_LR", "0.5")
    assert config_from_env() == TrainConfig(epochs=3, compiled_run=True, learning_rate=0.5)
    monkeypatch.setenv("DTF_EPOCHS", "many")
    with pytest.raises(ValueError, match="DTF_EPOCHS"):
        config_from_env()


@pytest.mark.parametrize("entry", ["mlp_init", "single_device", "trainer", "build_trainer",
                                   "convert", "bench"])
def test_entry_points_refuse_cpu_without_asking(entry, monkeypatch, small_pair):
    """Without CUDA and without device="cpu", every entry point of the
    slice raises: nothing falls back to the CPU silently."""
    from distributed_tensorflow_tpu_torch import bench
    from distributed_tensorflow_tpu_torch.convert import mlp_params_from_numpy
    from distributed_tensorflow_tpu_torch.launch import build_trainer
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.parallel.strategy import SingleDevice
    from distributed_tensorflow_tpu_torch.train.trainer import Trainer

    _, tds = _pair_datasets(*small_pair)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "mlp_init": lambda: MLP().init(seed=1),
        "single_device": lambda: SingleDevice(),
        "trainer": lambda: Trainer(MLP(), tds),
        "build_trainer": lambda: build_trainer(datasets=tds),
        "convert": lambda: mlp_params_from_numpy(mlp_numpy_params()),
        "bench": lambda: bench.main([], datasets=tds),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_composed_optimizer_trainer_matches_the_jax_trainer(optimizer, small_pair):
    """build_trainer with a schedule, warmup, clipping and accumulation on
    top of a stateful optimizer, from the same initial weights and data:
    the eager loop prints the JAX Trainer's lines (costs and accuracies to
    their last printed digit, as above; Adam's m/√v magnifies the f32
    sums' order a little more, hence 3e-4), and the scanned epoch gives
    the eager one's results exactly."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu.launch import build_trainer as jbuild
    from distributed_tensorflow_tpu.models.mlp import MLPParams as JParams
    from distributed_tensorflow_tpu.parallel.strategy import SingleDevice as JSingle
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.convert import mlp_params_from_numpy
    from distributed_tensorflow_tpu_torch.launch import build_trainer

    tree = mlp_numpy_params(seed=12)
    kw = dict(epochs=2, log_frequency=6, optimizer=optimizer, learning_rate=0.01,
              lr_schedule="cosine", warmup_steps=5, grad_clip_norm=1.0, accumulate_steps=2,
              compute_dtype="float32")
    jds, _ = _pair_datasets(*small_pair)
    jlines = []
    jtr = jbuild(JConfig(**kw, logs_path="", scan_epoch=False), datasets=jds,
                 strategy=JSingle(), print_fn=lambda *a: jlines.append(" ".join(map(str, a))))
    jtr.state = jtr.state._replace(params=JParams(*(jnp.asarray(tree[k]) for k in JParams._fields)))
    jres = jtr.run()
    out = {}
    for scan in (False, True):
        _, tds = _pair_datasets(*small_pair)
        lines = []
        ttr = build_trainer(TrainConfig(**kw, scan_epoch=scan), datasets=tds,
                            print_fn=lines.append, device="cpu")
        params = mlp_params_from_numpy(tree, device="cpu")
        ttr.state = ttr.state._replace(params=params, opt_state=ttr.optimizer.init(params))
        out[scan] = (ttr.run(), lines)
    (jm, jn), (tm, tn) = _masked(jlines), _masked(out[False][1])
    assert tm == jm
    np.testing.assert_allclose(tn, jn, atol=3e-4)
    assert out[False][0]["global_step"] == jres["global_step"] == 40
    np.testing.assert_allclose(out[False][0]["final_cost"], jres["final_cost"], rtol=1e-4)
    assert out[True][0] == out[False][0] and _masked(out[True][1]) == _masked(out[False][1])
