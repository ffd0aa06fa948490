"""PyTorch port: the resilience layer (``train/resilience.py``), the
Supervisor's durability (``train/supervisor.py``) and the host CRC32C
library (``runtime/native.py``), mirroring the JAX package's
``tests/test_resilience.py`` case for case, and held against the JAX
package where both compute the same thing:

- the CRC32C (native, pure, and JAX's) bit for bit on every length 0-4096
  at every alignment, and over arrays of float32, bfloat16, int8, uint8;
- ``leaf_checksums`` of one state in both packages (the MLP under SGD and
  Adam, a 2-layer GPT): the ``.params.*`` and ``.step`` records equal;
- ``backoff_delay``'s sequence, ``AnomalyGuard.classify``, the
  ``Rollback:`` and ``Preemption:`` lines;
- the restore decisions (which step, a fallback or not, what is raised,
  the ``checkpoint_restore`` events) under a truncated, flipped or missing
  file, a corrupt manifest or sidecar, the failpoints ``ckpt.save``,
  ``ckpt.manifest``, ``ckpt.async`` and ``atomic.write.commit``, and
  retention at ``keep_last_n`` 1-3 with the newest steps corrupt.

The two packages' checkpoint FILES differ (orbax there, ``torch.save``
here): a JAX checkpoint does not restore in the port, nor the reverse.
"""

from __future__ import annotations

import glob
import os
import signal
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.config import TrainConfig
from distributed_tensorflow_tpu_torch.data.mnist import DataSet, Datasets
from distributed_tensorflow_tpu_torch.models.mlp import MLP
from distributed_tensorflow_tpu_torch.parallel.strategy import TrainState
from distributed_tensorflow_tpu_torch.train import failpoints
from distributed_tensorflow_tpu_torch.train import resilience as R
from distributed_tensorflow_tpu_torch.train.supervisor import (
    Supervisor,
    checkpoint_steps,
    latest_checkpoint_step,
)
from distributed_tensorflow_tpu_torch.train.trainer import Trainer

_QUIET = dict(print_fn=lambda *a, **k: None)


@pytest.fixture(scope="module", autouse=True)
def _no_persistent_cache():
    """The JAX half of the parity tests restores orbax checkpoints, which
    the JAX tests run with the persistent compile cache off
    (tests/test_resilience.py)."""
    import jax

    old = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", old)


@pytest.fixture(autouse=True)
def _disarmed():
    failpoints.reset()
    yield
    failpoints.reset()


def _state(v: float) -> TrainState:
    return TrainState({"w": torch.full((4, 3), float(v)), "b": torch.zeros(3)},
                      {"mu": torch.ones(4, 3)}, int(v))


def _largest_file(step_dir: str) -> str:
    files = [p for p in glob.glob(os.path.join(step_dir, "**"), recursive=True)
             if os.path.isfile(p)]
    assert files, f"no files under {step_dir}"
    return max(files, key=os.path.getsize)


def _truncate(path: str) -> None:
    with open(path, "r+b") as f:
        f.truncate(max(1, os.path.getsize(path) // 2))


def _flip_byte(path: str) -> None:
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))


# ---------------------------------------------------------------------------
# The CRC32C: native, pure, JAX's.
# ---------------------------------------------------------------------------

_CRC_BYTES = np.random.default_rng(7).integers(0, 256, 4096 + 8, dtype=np.uint8).tobytes()


def _prefix_crcs(data: bytes) -> list[int]:
    """The pure table's CRC (utils/summary.py's ``_CRC_TABLE`` step) of
    every prefix of ``data``, in one pass."""
    from distributed_tensorflow_tpu_torch.utils.summary import _CRC_TABLE

    out, crc = [0], 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
        out.append(crc ^ 0xFFFFFFFF)
    return out


@pytest.mark.parametrize("align", range(8))
def test_crc32c_every_length_at_every_alignment(align):
    """Every length 0-4096 starting ``align`` bytes into an 8-aligned
    buffer: the library's dispatching CRC, each of its bodies (byte
    table, slicing-by-8, the crc32 instruction where the CPU has it), the
    pure table and the JAX package's CRC agree bit for bit; so does the
    buffer kernel read in place from a numpy view at that offset."""
    from distributed_tensorflow_tpu.runtime import native as jnative
    from distributed_tensorflow_tpu.utils.summary import crc32c as jcrc
    from distributed_tensorflow_tpu_torch.runtime import native
    from distributed_tensorflow_tpu_torch.utils.summary import crc32c as pure

    assert native.backend() == "native"
    buf = np.frombuffer(_CRC_BYTES, np.uint8)
    data = _CRC_BYTES[align:align + 4096]
    want = _prefix_crcs(data)
    for n in range(4097):
        piece = data[:n]
        got = native.crc32c(piece)
        assert got == want[n], n
        assert native.crc32c_buffer(buf[align:align + n]) == got, n
        if n % 97 == 0 or n < 64:
            bodies = native.crc32c_bodies(piece)
            assert set(bodies.values()) == {got}, (n, bodies)
            assert pure(piece) == got == jcrc(piece), n
            try:
                assert jnative.crc32c(piece) == got, n
            except ImportError:  # the JAX package's library not built here
                pass
    assert R._crc32c_bytes(data) == want[-1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "uint8"])
def test_crc32c_array_matches_jax_on_raw_bytes(dtype):
    """An array's CRC is over its raw bytes, a bf16 tensor through a byte
    view (no float round trip): the port's ``crc32c_array`` of a tensor
    equals the JAX package's of the same values as a JAX/numpy array."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.train import resilience as JR

    rng = np.random.default_rng(3)
    x = rng.standard_normal((13, 7)).astype(np.float32) * 50
    if dtype in ("int8", "uint8"):
        x = rng.integers(-128 if dtype == "int8" else 0, 128 if dtype == "int8" else 256,
                         (13, 7)).astype(dtype)
        t, j = torch.from_numpy(x), x
    elif dtype == "bfloat16":
        t = torch.from_numpy(x).to(torch.bfloat16)
        j = jnp.asarray(x, jnp.bfloat16)
        assert R.host_bytes(t).tobytes() == np.asarray(j).tobytes()
    else:
        t, j = torch.from_numpy(x), x
    assert R.crc32c_array(t) == JR.crc32c_array(j)
    assert R.dtype_name(t) == str(np.asarray(j).dtype)
    assert R.crc32c_array(t[:, ::2].contiguous()) == JR.crc32c_array(np.asarray(j)[:, ::2])


def test_crc_falls_back_to_the_pure_table_without_the_library(monkeypatch):
    """``DTF_NO_NATIVE`` disables the library: ``load_library`` raises
    ImportError, ``backend()`` says "python", and the manifest CRCs come
    from the pure table with the same values (JAX resilience.py:69-107)."""
    from distributed_tensorflow_tpu_torch.runtime import native
    from distributed_tensorflow_tpu_torch.utils.summary import crc32c as pure

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("DTF_NO_NATIVE", "1")
    with pytest.raises(ImportError, match="DTF_NO_NATIVE"):
        native.load_library()
    assert native.backend() == "python"
    monkeypatch.setattr(R, "_crc_impl", None)
    monkeypatch.setattr(R, "_buf_impl", None)
    data = _CRC_BYTES[:1000]
    assert R._crc32c_bytes(data) == pure(data)
    assert R._crc_impl is pure
    assert R.crc32c_array(np.frombuffer(data, np.uint8)) == pure(data)


# ---------------------------------------------------------------------------
# Manifest primitives.
# ---------------------------------------------------------------------------


def test_manifest_write_verify_roundtrip(tmp_path):
    d = str(tmp_path)
    step_dir = os.path.join(d, "step_7")
    os.makedirs(step_dir)
    with open(os.path.join(step_dir, "data.bin"), "wb") as f:
        f.write(b"payload" * 333)
    state = {".w": np.arange(12, dtype=np.float32).reshape(3, 4)}
    manifest = R.write_manifest(d, 7, state)
    assert manifest["format"] == R.MANIFEST_FORMAT == "dtf-checkpoint-manifest-v1"
    assert os.path.exists(R.manifest_path(d, 7))
    assert R.verify_files(d, 7) is True
    assert R.verify_leaves(state, manifest) is True
    assert not glob.glob(os.path.join(d, "*.tmp.*"))  # atomic commit: no litter


def test_manifest_detects_truncation_flip_and_missing(tmp_path):
    d = str(tmp_path)
    step_dir = os.path.join(d, "step_1")
    os.makedirs(step_dir)
    payload = os.path.join(step_dir, "data.bin")
    with open(payload, "wb") as f:
        f.write(b"x" * 4096)
    R.write_manifest(d, 1, {".w": np.zeros(3, np.float32)})
    _truncate(payload)
    assert R.verify_files(d, 1) is False
    with open(payload, "wb") as f:
        f.write(b"x" * 4096)
    assert R.verify_files(d, 1) is True
    _flip_byte(payload)
    assert R.verify_files(d, 1) is False
    os.remove(payload)
    assert R.verify_files(d, 1) is False


def test_manifest_absent_and_corrupt(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_3"))
    assert R.verify_files(d, 3) is None  # no manifest: unverifiable
    with open(R.manifest_path(d, 3), "w") as f:
        f.write("{not json")
    assert R.verify_files(d, 3) is False  # a corrupt manifest is known-bad
    with pytest.raises(ValueError, match="corrupt checkpoint manifest"):
        R.load_manifest(d, 3)


def test_leaf_crc_catches_value_corruption(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_2"))
    state = {".w": np.arange(6, dtype=np.float32)}
    manifest = R.write_manifest(d, 2, state)
    state[".w"][3] = 17.0
    assert R.verify_leaves(state, manifest) is False


def test_retry_io_bounded_backoff():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert R.retry_io(flaky, attempts=3, backoff=0.001) == "ok"
    assert len(calls) == 3

    def dead():
        raise OSError("gone")

    with pytest.raises(OSError):
        R.retry_io(dead, attempts=2, backoff=0.001)


def test_backoff_sequence_matches_jax():
    """``backoff_delay`` and ``retry``'s sleeps, with and without seeded
    jitter, equal the JAX package's bit for bit."""
    import random

    from distributed_tensorflow_tpu.train import resilience as JR

    for backoff, cap, jitter in ((0.25, 30.0, 0.0), (0.1, 1.0, 0.5), (2.0, 5.0, 1.0)):
        a, b = random.Random(5), random.Random(5)
        got = [R.backoff_delay(k, backoff=backoff, max_backoff=cap, jitter=jitter, rng=a)
               for k in range(12)]
        want = [JR.backoff_delay(k, backoff=backoff, max_backoff=cap, jitter=jitter, rng=b)
                for k in range(12)]
        assert got == want
    sleeps = {}
    for name, mod in (("port", R), ("jax", JR)):
        seen = []

        def dead():
            raise OSError("gone")

        with pytest.raises(OSError):
            mod.retry(dead, attempts=5, backoff=0.5, jitter=0.3, rng=random.Random(1),
                      sleep=seen.append, on_retry=lambda e, k, d: None)
        sleeps[name] = seen
    assert sleeps["port"] == sleeps["jax"] and len(sleeps["port"]) == 4


# ---------------------------------------------------------------------------
# Leaf records against the JAX package's.
# ---------------------------------------------------------------------------


def _jax_mlp_state(opt_name):
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.models import MLP as JMLP
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu.parallel.strategy import TrainState as JState

    from _torch_parity import mlp_numpy_params

    tree = mlp_numpy_params(hidden=16, seed=4)
    params = JMLP(hidden_dim=16, compute_dtype=jnp.float32).init(1)._replace(
        **{k: jnp.asarray(v) for k, v in tree.items()})
    opt = joptim.make(opt_name, 1e-3)
    return tree, JState(params, opt.init(params), jnp.asarray(37, jnp.int32))


@pytest.mark.parametrize("what", ["mlp-sgd", "mlp-adam", "gpt-2layer"])
def test_leaf_checksums_match_jax(what):
    """One state carried across by ``convert.py``: the port's
    ``leaf_checksums`` records of ``.params.*`` and ``.step`` equal the JAX
    package's bit for bit (CRC, shape, dtype); Adam's slots equal under the
    documented renaming ``.opt_state[0].X`` → ``.opt_state.X``."""
    from distributed_tensorflow_tpu.train import resilience as JR
    from distributed_tensorflow_tpu_torch import convert
    from distributed_tensorflow_tpu_torch.ops import optim

    if what.startswith("mlp"):
        name = what.split("-")[1]
        tree, jstate = _jax_mlp_state(name)
        params = convert.mlp_params_from_numpy(tree, device="cpu")
        opt = optim.make(name, 1e-3).init(params)
        if name == "adam":
            opt = convert.mlp_opt_state_from_numpy(jstate.opt_state, device="cpu")
    else:
        import jax.numpy as jnp
        from distributed_tensorflow_tpu.ops import optim as joptim
        from distributed_tensorflow_tpu.parallel.strategy import TrainState as JState

        from _torch_parity import jax_model, jax_params, numpy_params

        jm = jax_model(num_layers=2)
        tree = numpy_params(jm, seed=2)
        jp = jax_params(tree)
        jstate = JState(jp, joptim.make("adam", 1e-3).init(jp), jnp.asarray(37, jnp.int32))
        params = convert.gpt_params_from_numpy(tree, device="cpu")
        opt = optim.make("adam", 1e-3).init(params)
    port, complete = R.leaf_checksums(TrainState(params, opt, 37))
    want, jcomplete = JR.leaf_checksums(jstate)
    assert complete and jcomplete
    keep = lambda recs: {k: v for k, v in recs.items()  # noqa: E731
                         if k.startswith(".params") or k == ".step"}
    assert keep(port) == keep(want) and len(keep(port)) >= 5
    assert port[".step"] == {"crc32c": R.crc32c_array(np.int32(37)), "shape": [],
                             "dtype": "int32"}
    if what == "mlp-adam":
        renamed = {k.replace(".opt_state[0].", ".opt_state."): v for k, v in want.items()
                   if k.startswith(".opt_state[0].")}
        assert renamed == {k: v for k, v in port.items() if k.startswith(".opt_state")}


# ---------------------------------------------------------------------------
# Supervisor durability: the verify probe, fallback restore, retention.
# ---------------------------------------------------------------------------


def test_latest_checkpoint_step_verify_mode(tmp_path):
    d = str(tmp_path / "ck")
    sup = Supervisor(is_chief=True, checkpoint_dir=d)
    for s in (1, 2, 3):
        sup.save(_state(s), s)
    assert latest_checkpoint_step(d) == 3
    assert latest_checkpoint_step(d, verify=True) == 3
    _truncate(_largest_file(os.path.join(d, "step_3")))
    assert latest_checkpoint_step(d) == 3
    assert latest_checkpoint_step(d, verify=True) == 2


def test_prepare_or_restore_falls_back_past_truncated_latest(tmp_path):
    d = str(tmp_path / "ck")
    sup = Supervisor(is_chief=True, checkpoint_dir=d)
    for s in (1, 2, 3):
        sup.save(_state(s), s)
    _truncate(_largest_file(os.path.join(d, "step_3")))
    with pytest.warns(RuntimeWarning, match="step_3"):
        restored, step = sup.prepare_or_restore(_state(0))
    assert step == 2 and restored.step == 2
    assert float(restored.params["w"][0, 0]) == 2.0


def test_prepare_or_restore_falls_back_past_flipped_byte(tmp_path):
    d = str(tmp_path / "ck")
    sup = Supervisor(is_chief=True, checkpoint_dir=d)
    sup.save(_state(1), 1)
    sup.save(_state(2), 2)
    _flip_byte(_largest_file(os.path.join(d, "step_2")))
    with pytest.warns(RuntimeWarning, match="step_2"):
        restored, step = sup.prepare_or_restore(_state(0))
    assert step == 1
    assert float(restored.params["w"][0, 0]) == 1.0


def test_prepare_or_restore_raises_when_all_corrupt(tmp_path):
    """Checkpoints exist and none restores: it raises rather than start
    over at step 0; an empty directory is the ordinary fresh start."""
    d = str(tmp_path / "ck")
    sup = Supervisor(is_chief=True, checkpoint_dir=d)
    sup.save(_state(1), 1)
    _truncate(_largest_file(os.path.join(d, "step_1")))
    with pytest.raises(RuntimeError, match="no restorable checkpoint"):
        with pytest.warns(RuntimeWarning):
            sup.prepare_or_restore(_state(0))
    sup2 = Supervisor(is_chief=True, checkpoint_dir=str(tmp_path / "empty"))
    fresh = _state(0)
    restored, step = sup2.prepare_or_restore(fresh)
    assert step == 0 and restored is fresh


def _mlp_datasets(rows=500, seed=0, poison_calls=()):
    rng = np.random.default_rng(seed)
    imgs = rng.random((rows, 784), dtype=np.float32)
    labs = np.eye(10, dtype=np.float32)[rng.integers(0, 10, rows)]
    return Datasets(train=_PoisonedDataSet(imgs, labs, seed=1, poison_calls=poison_calls),
                    validation=None, test=DataSet(imgs[:100], labs[:100], seed=2))


def test_trainer_restores_newest_valid_not_corrupt_latest(tmp_path):
    """A run whose latest checkpoint is corrupted restores from the newest
    valid step and continues."""
    ds = _mlp_datasets()
    ck = str(tmp_path / "ck")
    cfg = TrainConfig(epochs=2, scan_epoch=False, log_frequency=10**9, logs_path="",
                      checkpoint_dir=ck)
    model = MLP(hidden_dim=8, compute_dtype=torch.float32)
    Trainer(model, ds, cfg, device="cpu", **_QUIET).run()
    steps = checkpoint_steps(ck)
    assert len(steps) == 2
    _truncate(_largest_file(os.path.join(ck, f"step_{steps[-1]}")))
    with pytest.warns(RuntimeWarning, match=f"step_{steps[-1]}"):
        tr = Trainer(model, ds, cfg, device="cpu", **_QUIET)
    assert tr.start_step == steps[0]
    res = tr.run(epochs=1)
    assert res["global_step"] > steps[0]


def test_retention_keeps_last_n(tmp_path):
    d = str(tmp_path / "ck")
    sup = Supervisor(is_chief=True, checkpoint_dir=d, keep_last_n=2)
    for s in (1, 2, 3, 4):
        sup.save(_state(s), s, layout={"mode": "sync"})
    assert checkpoint_steps(d) == [3, 4]
    assert not os.path.exists(os.path.join(d, "step_1.layout.json"))
    assert not os.path.exists(R.manifest_path(d, 1))
    assert latest_checkpoint_step(d, verify=True) == 4
    _, step = sup.prepare_or_restore(_state(0))
    assert step == 4


def test_retention_never_gcs_last_valid(tmp_path):
    d = str(tmp_path / "ck")
    sup = Supervisor(is_chief=True, checkpoint_dir=d)
    sup.save(_state(4), 4)
    sup.save(_state(5), 5)
    _truncate(_largest_file(os.path.join(d, "step_5")))
    sup.keep_last_n = 1
    sup._retention_sweep()
    assert checkpoint_steps(d) == [4, 5]
    assert latest_checkpoint_step(d, verify=True) == 4
    sup2 = Supervisor(is_chief=True, checkpoint_dir=str(tmp_path / "ck2"), keep_last_n=1)
    sup2.save(_state(1), 1)
    sup2.save(_state(2), 2)
    assert checkpoint_steps(str(tmp_path / "ck2")) == [2]


def test_save_retries_transient_io_error(tmp_path, monkeypatch):
    from distributed_tensorflow_tpu_torch.train import supervisor as sup_mod

    d = str(tmp_path / "ck")
    sup = Supervisor(is_chief=True, checkpoint_dir=d, io_retries=3, io_backoff=0.001)
    real_save, calls = torch.save, []

    def flaky_save(obj, path):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("transient filesystem hiccup")
        return real_save(obj, path)

    monkeypatch.setattr(sup_mod.torch, "save", flaky_save)
    sup.save(_state(5), 5)
    assert len(calls) == 2
    assert latest_checkpoint_step(d, verify=True) == 5


def test_saved_layout_missing_none_corrupt_raises(tmp_path):
    d = str(tmp_path / "ck")
    sup = Supervisor(is_chief=True, checkpoint_dir=d)
    sup.save(_state(1), 1, layout={"mode": "sync"})
    assert sup.saved_layout(1) == {"mode": "sync"}
    assert sup.saved_layout(999) is None
    with open(os.path.join(d, "step_1.layout.json"), "w") as f:
        f.write("{truncated")
    with pytest.raises(ValueError, match="layout sidecar"):
        sup.saved_layout(1)


def test_merge_of_copies_keeps_integer_leaves_exact():
    """A restore across modes merges stacked copies: float leaves at their
    mean, integer leaves from copy 0 where the float mean would lose the
    value (2^24 + 1 has no float32), differing integer copies refused."""
    from types import SimpleNamespace

    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    big = (1 << 24) + 1
    raw = TrainState((torch.stack([torch.ones(3), 3 * torch.ones(3)]),),
                     (torch.full((2,), big, dtype=torch.int32),), 4)
    c = LMTrainer._state_to_canonical(SimpleNamespace(), raw, {"mode": "async"})
    assert torch.equal(c.params[0], torch.full((3,), 2.0))
    assert int(c.opt_state[0]) == big and c.step == 4
    mixed = raw._replace(opt_state=(torch.tensor([1, 2], dtype=torch.int32),))
    with pytest.raises(ValueError, match="differs across replicas"):
        LMTrainer._state_to_canonical(SimpleNamespace(), mixed, {"mode": "async"})


# ---------------------------------------------------------------------------
# The anomaly guard and rollback.
# ---------------------------------------------------------------------------


def test_anomaly_guard_classification():
    g = R.AnomalyGuard(window=3, spike_threshold=2.0, max_rollbacks=2)
    assert g.classify(float("nan")) == "nan"
    assert g.classify(float("inf")) == "nan"
    assert g.classify(1.0, costs=np.array([1.0, np.nan, 1.0])) == "nan"
    assert g.classify(50.0) is None
    for c in (1.0, 1.1, 0.9):
        g.record(c)
    assert g.classify(5.0) == "spike"
    assert g.classify(1.5) is None
    g0 = R.AnomalyGuard(window=1, spike_threshold=0.0, max_rollbacks=1)
    g0.record(1.0)
    assert g0.classify(1e9) is None
    assert g0.classify(float("nan")) == "nan"
    assert R.AnomalyGuard.from_config(TrainConfig()) is None
    assert R.AnomalyGuard.from_config(TrainConfig(max_rollbacks=2)) is not None


def test_anomaly_guard_matches_jax_over_cost_sequences():
    """The same seeded cost sequences (spikes, NaNs, infs, a window
    filling) classify the same in both packages, recording the epochs
    that pass."""
    from distributed_tensorflow_tpu.train import resilience as JR

    rng = np.random.default_rng(11)
    for trial in range(20):
        window, thr = int(rng.integers(1, 5)), float(rng.choice([0.0, 1.5, 3.0]))
        a = R.AnomalyGuard(window=window, spike_threshold=thr, max_rollbacks=2)
        b = JR.AnomalyGuard(window=window, spike_threshold=thr, max_rollbacks=2)
        for _ in range(30):
            cost = float(rng.choice([rng.uniform(0.5, 2), rng.uniform(5, 50), np.nan, np.inf]))
            costs = None if rng.random() < 0.5 else np.append(rng.uniform(0.5, 2, 3), cost)
            ka, kb = a.classify(cost, costs=costs), b.classify(cost, costs=costs)
            assert ka == kb, (trial, cost)
            if ka is None:
                a.record(cost)
                b.record(cost)
        assert a.history == b.history


class _PoisonedDataSet(DataSet):
    """NaN-poisons the ``next_batch`` draws whose 1-based call index is
    listed: a window of the host data stream goes bad."""

    def __init__(self, *args, poison_calls=(), **kw):
        super().__init__(*args, **kw)
        self.calls = 0
        self._poison = set(poison_calls)

    def next_batch(self, batch_size):
        x, y = super().next_batch(batch_size)
        self.calls += 1
        if self.calls in self._poison:
            x = np.full_like(x, np.nan)
        return x, y


class _RecordingWriter:
    """A summary writer that records (tag, value, step)."""

    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def add_graph(self, *a, **k):
        pass

    def flush(self):
        pass


def test_trainer_nan_rollback_and_recovery(tmp_path):
    """An injected NaN data window (every draw of epoch 2) restores the
    epoch-1 checkpoint, skips the window, and the run recovers with 4 good
    epochs; the rollback scalar is at the detection step and no poisoned
    state reaches the checkpoints."""
    steps = 10
    ds = _mlp_datasets(rows=1000, poison_calls=range(steps + 1, 2 * steps + 1))
    ck = str(tmp_path / "ck")
    lines = []
    tr = Trainer(MLP(hidden_dim=16, compute_dtype=torch.float32), ds,
                 TrainConfig(epochs=4, scan_epoch=False, log_frequency=10**9, logs_path="",
                             checkpoint_dir=ck, learning_rate=0.01, max_rollbacks=2,
                             spike_threshold=0.0),
                 summary_writer=_RecordingWriter(), device="cpu",
                 print_fn=lambda *a: lines.append(" ".join(map(str, a))))
    res = tr.run()
    roll = [ln for ln in lines if ln.startswith("Rollback:")]
    assert len(roll) == 1, lines
    assert "kind=nan" in roll[0] and f"restored_step={steps}" in roll[0]
    assert "data_window=skipped" in roll[0]
    assert ("rollback", float(steps), 2 * steps) in tr.summary_writer.scalars
    assert np.isfinite(res["final_cost"]) and res["global_step"] == 4 * steps
    assert ds.train.calls == 5 * steps  # the window was skipped, not replayed
    assert tr.metrics.counter("rollbacks_total").value == 1
    for s in checkpoint_steps(ck):
        assert R.verify_files(ck, s) is True


def test_trainer_spike_rollback(tmp_path):
    script = [1.0, 1.1, 60.0, 0.9, 0.8]

    class ScriptedTrainer(Trainer):
        def run_epoch(self, epoch, logger):
            super().run_epoch(epoch, logger)
            if script:
                self.last_cost = torch.tensor(script.pop(0))
                self._epoch_costs = None

    lines = []
    tr = ScriptedTrainer(MLP(hidden_dim=8, compute_dtype=torch.float32), _mlp_datasets(),
                         TrainConfig(epochs=4, scan_epoch=False, log_frequency=10**9,
                                     logs_path="", checkpoint_dir=str(tmp_path / "ck"),
                                     max_rollbacks=1, anomaly_window=2, spike_threshold=3.0),
                         device="cpu", print_fn=lambda *a: lines.append(" ".join(map(str, a))))
    res = tr.run()
    roll = [ln for ln in lines if ln.startswith("Rollback:")]
    assert len(roll) == 1 and "kind=spike" in roll[0], lines
    assert np.isfinite(res["final_cost"])


def test_chunked_tier_rolls_back_at_chunk_boundary(tmp_path):
    calls = {"n": 0}

    class FlakyChunk(Trainer):
        def run_compiled(self, epochs=None, *, epoch_offset=0, finalize=True):
            res = super().run_compiled(epochs, epoch_offset=epoch_offset, finalize=finalize)
            calls["n"] += 1
            if calls["n"] == 2:  # the second chunk "goes NaN"
                res = dict(res, final_cost=float("nan"))
            return res

    lines = []
    tr = FlakyChunk(MLP(hidden_dim=8, compute_dtype=torch.float32), _mlp_datasets(rows=300),
                    TrainConfig(epochs=4, epochs_per_dispatch=1, scan_epoch=False,
                                log_frequency=10**9, logs_path="",
                                checkpoint_dir=str(tmp_path / "ck"), max_rollbacks=1,
                                spike_threshold=0.0),
                    device="cpu", print_fn=lambda *a: lines.append(" ".join(map(str, a))))
    res = tr.run()
    roll = [ln for ln in lines if ln.startswith("Rollback:") and "kind=nan" in ln]
    assert len(roll) == 1, lines
    assert calls["n"] == 5
    assert np.isfinite(res["final_cost"])


def test_rollback_budget_exhausted_raises(tmp_path):
    tr = Trainer(MLP(hidden_dim=8, compute_dtype=torch.float32),
                 _mlp_datasets(rows=1000, poison_calls=range(1, 200)),
                 TrainConfig(epochs=5, scan_epoch=False, log_frequency=10**9, logs_path="",
                             checkpoint_dir=str(tmp_path / "ck"), max_rollbacks=2,
                             spike_threshold=0.0), device="cpu", **_QUIET)
    with pytest.raises(R.AnomalyError, match="no rollback budget"):
        tr.run()


def test_anomaly_without_supervisor_raises():
    tr = Trainer(MLP(hidden_dim=8, compute_dtype=torch.float32),
                 _mlp_datasets(rows=1000, poison_calls=range(1, 100)),
                 TrainConfig(epochs=3, scan_epoch=False, log_frequency=10**9, logs_path="",
                             max_rollbacks=2, spike_threshold=0.0), device="cpu", **_QUIET)
    with pytest.raises(R.AnomalyError, match="no supervisor"):
        tr.run()


def test_rollback_line_and_run_match_jax(tmp_path):
    """A NaN window through both packages' Trainers (the same data, the
    same initial parameters, SGD): the same ``Rollback:`` line bit for
    bit, the same restored step and number of good epochs, the final costs
    within the Trainer parity tolerance."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu.data import mnist as jm
    from distributed_tensorflow_tpu.models import MLP as JMLP
    from distributed_tensorflow_tpu.train import Trainer as JTrainer

    from _torch_parity import mlp_numpy_params

    steps = 10
    rng = np.random.default_rng(0)
    imgs = rng.random((1000, 784), dtype=np.float32)
    labs = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 1000)]
    poison = range(steps + 1, 2 * steps + 1)

    class JPoisoned(jm.DataSet):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.calls = 0

        def next_batch(self, b):
            x, y = super().next_batch(b)
            self.calls += 1
            return (np.full_like(x, np.nan) if self.calls in poison else x), y

    kw = dict(epochs=3, scan_epoch=False, log_frequency=10**9, logs_path="",
              learning_rate=0.05, max_rollbacks=2, spike_threshold=0.0)
    tree = mlp_numpy_params(hidden=16, seed=1)
    lines = {}
    jlines, plines = [], []
    jt = JTrainer(JMLP(hidden_dim=16, compute_dtype=jnp.float32),
                  jm.Datasets(JPoisoned(imgs, labs, seed=1), None, jm.DataSet(imgs[:100],
                                                                              labs[:100], seed=2)),
                  JConfig(checkpoint_dir=str(tmp_path / "j"), **kw),
                  print_fn=lambda *a: jlines.append(" ".join(map(str, a))))
    jt.state = jt.state._replace(params=jt.state.params._replace(
        **{k: jnp.asarray(v) for k, v in tree.items()}))
    jres = jt.run()
    from distributed_tensorflow_tpu_torch.convert import mlp_params_from_numpy

    pt = Trainer(MLP(hidden_dim=16, compute_dtype=torch.float32),
                 Datasets(_PoisonedDataSet(imgs, labs, seed=1, poison_calls=poison), None,
                          DataSet(imgs[:100], labs[:100], seed=2)),
                 TrainConfig(checkpoint_dir=str(tmp_path / "p"), **kw), device="cpu",
                 print_fn=lambda *a: plines.append(" ".join(map(str, a))))
    pt.state = pt.state._replace(params=mlp_params_from_numpy(tree, device="cpu"))
    pres = pt.run()
    for name, ls in (("jax", jlines), ("port", plines)):
        lines[name] = [ln for ln in ls if ln.startswith("Rollback:")]
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 1, lines
    assert lines["port"][0] == (f"Rollback: kind=nan epoch=1 detected_step={2 * steps} "
                                f"restored_step={steps} rollback=1/2 data_window=skipped")
    assert pres["global_step"] == jres["global_step"] == 3 * steps
    assert checkpoint_steps(str(tmp_path / "p")) == checkpoint_steps(str(tmp_path / "j"))
    assert abs(pres["final_cost"] - jres["final_cost"]) <= 1e-4 * max(1.0, abs(jres["final_cost"]))


# ---------------------------------------------------------------------------
# Preemption.
# ---------------------------------------------------------------------------


def test_preemption_guard_flips_request_stop_and_restores():
    class Sup:
        def __init__(self):
            self.stopped = False

        def request_stop(self):
            self.stopped = True

    before = signal.getsignal(signal.SIGTERM)
    sup = Sup()
    lines = []
    with R.preemption_guard(sup, print_fn=lines.append):
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert sup.stopped
        assert signal.getsignal(signal.SIGTERM) == before
    assert signal.getsignal(signal.SIGTERM) == before
    assert lines and lines[0].startswith("Preemption: signal=")
    with R.preemption_guard(None) as h:
        assert h is None
    with R.preemption_guard(sup, enabled=False) as h:
        assert h is None


def test_preemption_lines_match_jax(tmp_path):
    """The handler's ``Preemption:`` line (with and without
    ``saved_step``) and the disarmed line are the JAX package's bit for
    bit, and the journaled event carries the same fields."""
    from distributed_tensorflow_tpu.train import resilience as JR
    from distributed_tensorflow_tpu_torch import observability as obs

    out = {}
    for name, mod in (("port", R), ("jax", JR)):
        class Sup:
            def request_stop(self):
                pass

            def emergency_save(self):
                return 12

        lines = []
        with mod.preemption_guard(Sup(), print_fn=lines.append) as h:
            h(signal.SIGTERM, None)
        with mod.preemption_guard(type("S", (), {"request_stop": lambda s: None})(),
                                  print_fn=lines.append) as h:
            h(signal.SIGINT, None)
        holder = []
        t = threading.Thread(target=lambda: holder.append(
            mod.preemption_guard(Sup(), print_fn=lines.append).__enter__()))
        t.start()
        t.join()
        out[name] = lines
    assert out["port"] == out["jax"] and len(out["port"]) == 3
    first, second, third = out["port"]
    assert first.startswith(f"Preemption: signal={int(signal.SIGTERM)} ")
    assert first.endswith(" saved_step=12") and "saved_step" not in second
    assert second.startswith(f"Preemption: signal={int(signal.SIGINT)} ")
    assert third == "Preemption: disarmed (non-main thread)"
    j = obs.EventJournal.in_dir(str(tmp_path))
    with R.preemption_guard(type("S", (), {"request_stop": lambda s: None})(),
                            print_fn=lambda *a: None, journal=j) as h:
        h(signal.SIGTERM, None)
    j.close()
    ev = [e for e in obs.read_events(str(tmp_path)) if e["kind"] == "preemption"]
    assert len(ev) == 1 and ev[0]["signal"] == int(signal.SIGTERM)


def test_sigterm_mid_run_exits_at_boundary_with_final_save(tmp_path):
    ck = str(tmp_path / "ck")
    lines = []
    tr = Trainer(MLP(hidden_dim=8, compute_dtype=torch.float32), _mlp_datasets(rows=1000),
                 TrainConfig(epochs=10**6, scan_epoch=False, log_frequency=10**9, logs_path="",
                             checkpoint_dir=ck), device="cpu",
                 print_fn=lambda *a: lines.append(" ".join(map(str, a))))
    pid = os.getpid()
    timer = threading.Timer(1.0, lambda: os.kill(pid, signal.SIGTERM))
    timer.start()
    try:
        res = tr.run()
    finally:
        timer.cancel()
    assert any(ln.startswith("Preemption: signal=") for ln in lines)
    step = latest_checkpoint_step(ck, verify=True)
    assert step is not None and step > 0
    assert res["global_step"] == step


# ---------------------------------------------------------------------------
# The LM trainer's tokenizer.json guard.
# ---------------------------------------------------------------------------


def test_lm_tokenizer_json_refuses_mismatch(tmp_path):
    """``tokenizer.json`` is written beside the checkpoints, the same vocab
    again is a no-op, another vocab is refused; the file's bytes are the
    JAX package's for the same tokenizer."""
    from distributed_tensorflow_tpu.data.text import BPETokenizer as JTok
    from distributed_tensorflow_tpu_torch.data.text import BPETokenizer
    from distributed_tensorflow_tpu_torch.data.tokens import copy_corpus
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    tok_a = BPETokenizer([(65, 66), (67, 68)])
    tok_b = BPETokenizer([(65, 66), (97, 98)])
    ck = str(tmp_path / "ck")
    cfg = TrainConfig(epochs=1, batch_size=64, log_frequency=10**9, logs_path="",
                      checkpoint_dir=ck)
    model = GPTLM(vocab_size=61, max_len=16, model_dim=32, num_heads=4, num_layers=1,
                  compute_dtype=torch.float32)
    corpus = lambda: copy_corpus(num=256, half_len=8, vocab=61, n_val=64, n_test=64,  # noqa: E731
                                 seed=0)
    LMTrainer(model, corpus(), cfg, tokenizer=tok_a, device="cpu", **_QUIET)
    path = os.path.join(ck, "tokenizer.json")
    assert BPETokenizer.load(path).merges == tok_a.merges
    JTok([(65, 66), (67, 68)]).save(str(tmp_path / "jax.json"))
    with open(path, "rb") as f, open(tmp_path / "jax.json", "rb") as g:
        assert f.read() == g.read()
    LMTrainer(model, corpus(), cfg, tokenizer=tok_a, device="cpu", **_QUIET)
    with pytest.raises(ValueError, match="tokenizer mismatch"):
        LMTrainer(model, corpus(), cfg, tokenizer=tok_b, device="cpu", **_QUIET)
    assert BPETokenizer.load(path).merges == tok_a.merges


# ---------------------------------------------------------------------------
# The async checkpoint pipeline.
# ---------------------------------------------------------------------------


def test_async_writer_supersedes_queued():
    gate, executed = threading.Event(), []

    def slow(tag):
        def _run():
            gate.wait(10)
            executed.append(tag)

        return _run

    w = R.AsyncCheckpointWriter()
    try:
        w.submit(slow(1), tag=1)
        deadline = time.time() + 5
        while w._pending is not None and time.time() < deadline:
            time.sleep(0.001)
        w.submit(lambda: executed.append(2), tag=2)
        w.submit(lambda: executed.append(3), tag=3)  # supersedes 2
        gate.set()
        w.wait_pending()
        assert executed == [1, 3]
        assert w.superseded == 1
    finally:
        gate.set()
        w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.submit(lambda: None)


def test_async_writer_defers_error_to_wait():
    w = R.AsyncCheckpointWriter()
    try:
        w.submit(lambda: (_ for _ in ()).throw(OSError("disk gone")))
        with pytest.raises(OSError, match="disk gone"):
            w.wait_pending()
        w.wait_pending()
        done = []
        w.submit(lambda: done.append(1))
        w.wait_pending()
        assert done == [1]
    finally:
        w.close()


def test_async_save_state_identical_to_sync(tmp_path):
    """A sync and an async save of one state: equal leaf records, each
    verifying, bitwise restores that verify against the other's manifest,
    equal sidecars, and (``torch.save`` is deterministic, unlike orbax's
    content-hashed files) equal FILE records: the same bytes on disk."""
    d1, d2 = str(tmp_path / "sync"), str(tmp_path / "async")
    s_sync = Supervisor(is_chief=True, checkpoint_dir=d1)
    s_async = Supervisor(is_chief=True, checkpoint_dir=d2, async_checkpoint=True)
    st = _state(5)
    s_sync.save(st, 5, layout={"mode": "sync"})
    s_async.save(st, 5, layout={"mode": "sync"})
    s_async.wait_pending()
    m1, m2 = R.load_manifest(d1, 5), R.load_manifest(d2, 5)
    assert m1["leaves"] == m2["leaves"]
    assert m1["files"] == m2["files"] and m1["sidecars"] == m2["sidecars"]
    assert R.verify_files(d1, 5) is True and R.verify_files(d2, 5) is True
    st1, r1 = Supervisor(checkpoint_dir=d1).prepare_or_restore(_state(0))
    st2, r2 = Supervisor(checkpoint_dir=d2, async_checkpoint=True).prepare_or_restore(_state(0))
    assert (r1, r2) == (5, 5) and st1.step == st2.step == 5
    for k in ("w", "b"):
        assert torch.equal(st1.params[k], st2.params[k]) and torch.equal(st1.params[k],
                                                                         st.params[k])
    assert R.verify_leaves(st1, m2) is True and R.verify_leaves(st2, m1) is True
    assert Supervisor(checkpoint_dir=d2).saved_layout(5) == {"mode": "sync"}


def test_async_snapshot_owns_its_memory(tmp_path):
    """An async save of CPU tensors that the caller then overwrites in
    place (as the fused MLP path does) commits the values of the save
    boundary: the snapshot is a copy."""
    from distributed_tensorflow_tpu_torch.train.supervisor import read_state

    d = str(tmp_path / "ck")
    sup = Supervisor(is_chief=True, checkpoint_dir=d, async_checkpoint=True)
    st = _state(3)
    failpoints.configure("ckpt.async:delay=0.2")
    sup.save(st, 3)
    st.params["w"].fill_(99.0)
    sup.wait_pending()
    assert torch.equal(read_state(os.path.join(d, "step_3"))[".params['w']"],
                       torch.full((4, 3), 3.0))
    assert R.verify_files(d, 3) is True


def test_async_reads_drain_writes(tmp_path):
    d = str(tmp_path / "ck")
    sup = Supervisor(is_chief=True, checkpoint_dir=d, async_checkpoint=True)
    try:
        failpoints.configure("ckpt.async:delay=0.3")
        sup.save(_state(7), 7)
        assert sup.newest_restorable_step() == 7
        assert sup.latest_step(verify=True) == 7
    finally:
        failpoints.configure(None)
        sup.stop()


def test_async_gc_ordered_behind_writes_and_supersession(tmp_path):
    d = str(tmp_path / "ck")
    sup = Supervisor(is_chief=True, checkpoint_dir=d, keep_last_n=1, async_checkpoint=True)
    try:
        failpoints.configure("ckpt.async:delay=0.05@1+")
        for s in (1, 2, 3, 4):
            sup.save(_state(s), s)
        sup.wait_pending()
    finally:
        failpoints.configure(None)
        sup.stop()
    steps = checkpoint_steps(d)
    assert steps and steps[-1] == 4
    assert latest_checkpoint_step(d, verify=True) == 4
    assert len(steps) <= 2


def test_ckpt_async_failpoint_raise_and_fallback_restore(tmp_path):
    d = str(tmp_path / "ck")
    sup = Supervisor(is_chief=True, checkpoint_dir=d, async_checkpoint=True)
    sup.save(_state(1), 1)
    sup.wait_pending()
    try:
        failpoints.configure("ckpt.async:raise")
        sup.save(_state(2), 2)
        with pytest.raises(failpoints.FailpointError):
            sup.wait_pending()
    finally:
        failpoints.configure(None)
        sup.stop()
    assert checkpoint_steps(d) == [1]
    _, step = Supervisor(checkpoint_dir=d).prepare_or_restore(_state(0))
    assert step == 1


def test_ckpt_manifest_torn_falls_back_with_warning(tmp_path):
    d = str(tmp_path / "ck")
    sup = Supervisor(is_chief=True, checkpoint_dir=d)
    try:
        failpoints.configure("ckpt.manifest:torn@2")
        sup.save(_state(1), 1)
        sup.save(_state(2), 2)
    finally:
        failpoints.configure(None)
    assert R.verify_files(d, 2) is False
    with pytest.warns(RuntimeWarning, match="step_2"):
        _, step = Supervisor(checkpoint_dir=d).prepare_or_restore(_state(0))
    assert step == 1


# ---------------------------------------------------------------------------
# The emergency snapshot and the watchdog primitives.
# ---------------------------------------------------------------------------


def test_emergency_save_persists_uncommitted_snapshot(tmp_path):
    from distributed_tensorflow_tpu_torch.train.supervisor import flatten_state

    d = str(tmp_path / "ck")
    sup = Supervisor(is_chief=True, checkpoint_dir=d, async_checkpoint=True)
    sup.save(_state(1), 1)
    sup.wait_pending()
    assert sup.emergency_save() == 1
    sup._last_snapshot = (flatten_state(_state(2), own=True), 2, None)
    assert sup.emergency_save() == 2
    assert R.verify_files(d, 2) is True
    sup._saving = True
    assert sup.emergency_save() is None
    sup._saving = False
    sup.stop()
    s2 = Supervisor(is_chief=True, checkpoint_dir=str(tmp_path / "ck2"), async_checkpoint=True)
    assert s2.emergency_save() is None


def test_preemption_handler_reports_saved_step(tmp_path):
    from distributed_tensorflow_tpu_torch.train.supervisor import flatten_state

    d = str(tmp_path / "ck")
    sup = Supervisor(is_chief=True, checkpoint_dir=d, async_checkpoint=True)
    sup._last_snapshot = (flatten_state(_state(3), own=True), 3, None)
    lines = []
    with R.preemption_guard(sup, print_fn=lines.append) as handler:
        handler(signal.SIGTERM, None)
    assert sup.should_stop
    assert lines and lines[0].endswith(" saved_step=3")
    assert R.verify_files(d, 3) is True
    sup.stop()


def test_preemption_guard_disarmed_off_main_thread():
    sup = Supervisor()
    lines, holder = [], {}

    def _run():
        with R.preemption_guard(sup, print_fn=lines.append) as h:
            holder["h"] = h

    t = threading.Thread(target=_run)
    t.start()
    t.join()
    assert holder["h"] is None
    assert lines == ["Preemption: disarmed (non-main thread)"]


def test_touch_heartbeat_creates_bumps_never_raises(tmp_path):
    p = str(tmp_path / "w0.heartbeat")
    assert R.touch_heartbeat(p) is True
    t0 = os.path.getmtime(p)
    time.sleep(0.02)
    assert R.touch_heartbeat(p) is True
    assert os.path.getmtime(p) >= t0
    assert R.touch_heartbeat("") is False
    assert R.touch_heartbeat(str(tmp_path / "no" / "dir" / "x")) is False


def test_arm_stall_dump_dumps_all_threads_on_sigusr1(tmp_path):
    p = str(tmp_path / "w0.stalldump")
    try:
        assert R.arm_stall_dump(p) == p
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.1)
        with open(p) as f:
            dump = f.read()
        assert "Thread" in dump or "Stack" in dump
    finally:
        R.disarm_stall_dump()
    old = os.environ.pop("DTF_STALL_DUMP", None)
    try:
        assert R.arm_stall_dump() is None
    finally:
        if old is not None:
            os.environ["DTF_STALL_DUMP"] = old


def test_report_progress_beats_heartbeat_file(tmp_path, monkeypatch):
    from distributed_tensorflow_tpu_torch import observability as obs

    p = str(tmp_path / "w0.heartbeat")
    monkeypatch.setenv("DTF_HEARTBEAT_FILE", p)
    monkeypatch.setenv("DTF_RANK", "2")
    sup = Supervisor()
    j = obs.EventJournal.in_dir(str(tmp_path / "j"))
    sup.attach_observability(j)
    sup.report_progress(3)
    assert os.path.exists(p)
    t0 = os.path.getmtime(p)
    time.sleep(0.02)
    sup.report_progress(4)
    assert os.path.getmtime(p) >= t0
    j.close()
    beats = [(e["rank"], e["step"]) for e in obs.read_events(str(tmp_path / "j"))
             if e["kind"] == "heartbeat"]
    assert beats == [(2, 3), (2, 4)]
    monkeypatch.delenv("DTF_HEARTBEAT_FILE")
    sup2 = Supervisor()
    sup2.report_progress(1)
    assert sup2._heartbeat_file is None


def test_checkpoint_telemetry_events_counters_and_span(tmp_path):
    """``attach_observability``: a save journals ``checkpoint_save`` with
    the bytes the manifest recorded, counts saves and bytes, observes the
    duration and records a ``checkpoint_save`` span; a restore journals
    ``checkpoint_restore`` and counts it."""
    from distributed_tensorflow_tpu_torch import observability as obs
    from distributed_tensorflow_tpu_torch.observability.spans import SpanRecorder

    j = obs.EventJournal.in_dir(str(tmp_path / "j"))
    reg = obs.MetricsRegistry()
    spans = SpanRecorder(journal=j)
    d = str(tmp_path / "ck")
    sup = Supervisor(checkpoint_dir=d)
    sup.attach_observability(j, reg, spans)
    sup.save(_state(2), 2, layout={"mode": "sync"})
    sup.prepare_or_restore(_state(0))
    j.close()
    evs = obs.read_events(str(tmp_path / "j"))
    save = [e for e in evs if e["kind"] == "checkpoint_save"]
    m = R.load_manifest(d, 2)
    nbytes = sum(r["size"] for r in m["files"].values()) + sum(
        r["size"] for r in m["sidecars"].values())
    assert len(save) == 1 and save[0]["step"] == 2 and save[0]["bytes"] == nbytes
    assert [(e["step"], e["fallback"]) for e in evs if e["kind"] == "checkpoint_restore"] == [
        (2, False)]
    assert reg.counter("checkpoint_saves_total").value == 1
    assert reg.counter("checkpoint_bytes_total").value == nbytes
    assert reg.counter("checkpoint_restores_total").value == 1
    assert [e["name"] for e in evs if e["kind"] == "span"] == ["checkpoint_save"]


# ---------------------------------------------------------------------------
# The same restore decisions as the JAX package.
# ---------------------------------------------------------------------------


def _corrupt_schedule(kind, d, steps):
    """Apply corruption ``kind`` to the newest step of ``d``."""
    s = steps[-1]
    if kind == "truncated":
        _truncate(_largest_file(os.path.join(d, f"step_{s}")))
    elif kind == "flipped":
        _flip_byte(_largest_file(os.path.join(d, f"step_{s}")))
    elif kind == "missing":
        os.remove(_largest_file(os.path.join(d, f"step_{s}")))
    elif kind == "manifest":
        with open(R.manifest_path(d, s), "w") as f:
            f.write("{torn")
    elif kind == "sidecar":
        with open(os.path.join(d, f"step_{s}.layout.json"), "w") as f:
            f.write("{torn")


def _decisions(pkg, kind, root, keep=None):
    """Run one schedule through ``pkg``'s Supervisor: three saves of
    steps 1-3 (with a layout), the corruption or failpoint, then a fresh
    Supervisor's probe and restore. Returns the decisions: the steps on
    disk, the verify results, the newest restorable step, the restored
    step (or the error's type), the warnings' steps and the restore
    events."""
    import re

    if pkg == "jax":
        import jax.numpy as jnp
        from distributed_tensorflow_tpu import observability as jobs
        from distributed_tensorflow_tpu.parallel.strategy import TrainState as JState
        from distributed_tensorflow_tpu.train import failpoints as fp
        from distributed_tensorflow_tpu.train import resilience as mod
        from distributed_tensorflow_tpu.train.supervisor import Supervisor as Sup
        from distributed_tensorflow_tpu.train.supervisor import checkpoint_steps as steps_of

        def state(v):
            return JState({"w": jnp.full((4, 3), float(v)), "b": jnp.zeros((3,))},
                          {"mu": jnp.ones((4, 3))}, jnp.asarray(int(v), jnp.int32))
        obs_mod = jobs
    else:
        from distributed_tensorflow_tpu_torch import observability as obs_mod
        from distributed_tensorflow_tpu_torch.train import failpoints as fp

        mod, Sup, steps_of, state = R, Supervisor, checkpoint_steps, _state
    d = os.path.join(root, pkg)
    out = {}
    sup = Sup(is_chief=True, checkpoint_dir=d, keep_last_n=keep, io_backoff=0.001,
              async_checkpoint=kind == "ckpt.async")
    fp.reset()
    if kind.startswith(("ckpt.", "atomic.")):
        fault = {"ckpt.save": "ckpt.save:raise@3", "ckpt.manifest": "ckpt.manifest:torn@3",
                 "ckpt.async": "ckpt.async:raise@3",
                 "atomic.write.commit": "atomic.write.commit:raise@5"}[kind]
        fp.configure(fault)
    errors = []
    for s in (1, 2, 3):
        try:
            sup.save(state(s), s, layout={"mode": "sync"})
            sup.wait_pending()
        except Exception as exc:  # noqa: BLE001 — recorded as a decision
            errors.append((s, type(exc).__name__))
    fp.reset()
    out["save_errors"] = errors
    if keep is not None:
        for s in steps_of(d)[-2:]:
            _truncate(_largest_file(os.path.join(d, f"step_{s}")))
    elif not kind.startswith(("ckpt.", "atomic.")):
        _corrupt_schedule(kind, d, steps_of(d))
    out["steps"] = steps_of(d)
    out["verify"] = [mod.verify_files(d, s) for s in steps_of(d)]
    j = obs_mod.EventJournal.in_dir(os.path.join(root, pkg + "-j"))
    reader = Sup(checkpoint_dir=d)
    reader.attach_observability(j)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["restorable"] = reader.newest_restorable_step()
        try:
            _, out["restored"] = reader.prepare_or_restore(state(0))
        except Exception as exc:  # noqa: BLE001 — the decision is the error
            out["restored"] = type(exc).__name__
    out["warned"] = sorted({int(m) for w in caught
                            for m in re.findall(r"step_(\d+)", str(w.message))})
    try:
        out["layout"] = reader.saved_layout(out["steps"][-1]) if out["steps"] else None
    except ValueError as exc:
        out["layout"] = f"ValueError: {'corrupt checkpoint layout sidecar' in str(exc)}"
    j.close()
    jdir = os.path.join(root, pkg + "-j")
    evs = obs_mod.read_events(jdir) if os.path.exists(os.path.join(jdir, "events.jsonl")) else []
    out["events"] = [(e["step"], e["fallback"]) for e in evs if e["kind"] == "checkpoint_restore"]
    return out


@pytest.mark.parametrize("kind,keep", [
    ("truncated", None), ("flipped", None), ("missing", None), ("manifest", None),
    ("sidecar", None), ("ckpt.save", None), ("ckpt.manifest", None), ("ckpt.async", None),
    ("atomic.write.commit", None), ("retention", 1), ("retention", 2), ("retention", 3),
])
def test_restore_decisions_match_jax(kind, keep, tmp_path):
    """Each corruption or failpoint schedule through both packages'
    Supervisors: the same save errors, steps on disk, verify verdicts,
    newest restorable step, restored step (or error), warned steps,
    sidecar verdict and ``checkpoint_restore`` events. Retention at
    ``keep_last_n`` 1-3 truncates the two newest steps after the saves."""
    port = _decisions("port", kind, str(tmp_path), keep)
    want = _decisions("jax", kind, str(tmp_path), keep)
    assert port == want
    if kind == "truncated":
        assert port["restored"] == 2 and port["events"] == [(2, True)]
    if kind == "ckpt.save":
        assert port["save_errors"] == [(3, "FailpointError")]
