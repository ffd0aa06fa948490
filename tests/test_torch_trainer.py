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
    from distributed_tensorflow_tpu.observability import format as jformat
    from distributed_tensorflow_tpu_torch.utils import logging as tlog

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
    """An optimizer with state: one apply matches SGD, two do not."""

    def __init__(self, lr):
        self.lr, self.v = lr, None

    def apply(self, params, grads):
        self.v = grads if self.v is None else type(grads)(
            *(0.9 * v + g for v, g in zip(self.v, grads)))
        return type(params)(*(p - self.lr * v for p, v in zip(params, self.v)))


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
    for kw, item in ((dict(checkpoint_dir="/tmp/x"), "A8"), (dict(epochs_per_dispatch=10), "A8"),
                     (dict(prefetch=2), "A8"), (dict(max_rollbacks=1), "A8"),
                     (dict(logs_path="./logs"), "A8"), (dict(sync=False), "A6"),
                     (dict(model="cnn"), "A6"), (dict(lr_schedule="cosine"), "A4")):
        with pytest.raises(NotImplementedError, match=item):
            TrainConfig(**kw)
    # Refused whatever the value, even one that switches the feature off.
    with pytest.raises(NotImplementedError, match="A8"):
        TrainConfig(logs_path="")
    with pytest.raises(TypeError):
        TrainConfig(no_such_field=1)
    with pytest.raises(ValueError, match="engine"):
        TrainConfig(engine="tpu")
    for name in ("supervisor", "summary_writer", "journal", "metrics"):
        with pytest.raises(NotImplementedError, match="A8"):
            Trainer(MLP(), tds, device="cpu", **{name: object()})
    with pytest.raises(NotImplementedError, match="A6"):
        build_trainer(context=object(), datasets=tds, device="cpu")
    monkeypatch.setenv("DTF_CHECKPOINT", "/tmp/ckpt")
    with pytest.raises(NotImplementedError, match="A8"):
        config_from_env()
    monkeypatch.delenv("DTF_CHECKPOINT")
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
