"""PyTorch port: the classifier families (CNN, LSTM, transformer), the
model registry, the Trainer over every family and ``inference.Predictor``,
against the JAX package on the CPU, from the same seeded numpy weights and
inputs (``tests/_torch_parity.py`` ``CLASSIFIERS``: narrow widths; the CNN
with an odd and an even kernel).

Tolerances:

- f32 forwards (probabilities and logits) within 1e-5: the same
  arithmetic, sums in another order (measured ~1e-7);
- bf16 forwards within 1e-3: the operands round alike, but an f32 sum in
  another order that lands beside a bf16 rounding point (a conv's output,
  rounded once a window) moves it one bf16 ulp;
- gradients of the naive cross-entropy, per leaf against its largest
  magnitude: f32 within 1e-5 (measured ~2e-6), bf16 within 2e-2 (each
  cast rounds the cotangent to bf16, so a neighbouring bf16 value moves a
  gradient by 2^-8 of it, and the transformer's embed leaf sums 28 rows
  of them; measured 2e-3);
- Trainer runs (f32, 6 SGD steps at lr 0.1): the printed lines equal with
  AvgTime and Total Time masked, their numbers within 1.5e-4 (the printed
  costs' last digit, as tests/test_torch_trainer.py holds the MLP), the
  final parameters within rtol 1e-4, atol 1e-5.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from _torch_parity import (
    classifier_models,
    classifier_numpy_params,
    jax_classifier_params,
    max_err,
    torch_classifier_params,
)
from test_torch_trainer import _masked

FAMILIES = ("cnn", "cnn_even", "lstm", "transformer")
FWD_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 784), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return x, y


def _pair(family, dtype="float32", seed=0, **extra):
    jm, tm = classifier_models(family, dtype, **extra)
    tree = classifier_numpy_params(jm, seed)
    return jm, jax_classifier_params(jm, tree), tm, torch_classifier_params(tm, tree), tree


def _shaped(family, x):
    """The family's own input shape: NHWC images, [B, T, F] rows."""
    if family.startswith("cnn"):
        return x.reshape(-1, 28, 28, 1)
    if family == "lstm":
        return x.reshape(-1, 28, 28)
    return x


# -- the families --------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_jax(family, dtype):
    """``apply`` (and ``apply_logits`` where the family has it) on flat
    and shaped inputs."""
    import jax.numpy as jnp

    jm, jp, tm, tp, _ = _pair(family, dtype)
    x, _ = _data(5, seed=1)
    for xin in (x, _shaped(family, x)):
        fns = ("apply", "apply_logits") if hasattr(jm, "apply_logits") else ("apply",)
        for fn in fns:
            want = np.asarray(getattr(jm, fn)(jp, jnp.asarray(xin)))
            got = getattr(tm, fn)(tp, torch.from_numpy(xin))
            assert got.dtype == torch.float32 and tuple(got.shape) == (5, 10)
            assert max_err(want, got.numpy()) < FWD_TOL[dtype] * max(1.0, np.abs(want).max()), fn
    assert hasattr(tm, "apply_logits") == hasattr(jm, "apply_logits")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_gradients_match_jax(family, dtype):
    """Gradients of the reference's naive cross-entropy, autograd against
    ``jax.grad``, leaf by leaf."""
    import jax
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops import cross_entropy as jce
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy

    jm, jp, tm, tp, _ = _pair(family, dtype, seed=2)
    x, y = _data(6, seed=3)
    jg = jax.grad(lambda p: jce(jm.apply(p, jnp.asarray(x)), jnp.asarray(y)))(jp)
    leaves = [t.clone().requires_grad_(True) for t in tp]
    cost = cross_entropy(tm.apply(type(tp)(*leaves), torch.from_numpy(x)), torch.from_numpy(y))
    for name, g in zip(tp._fields, torch.autograd.grad(cost, leaves)):
        want = np.asarray(getattr(jg, name))
        assert max_err(want, g.numpy()) <= GRAD_TOL[dtype] * np.abs(want).max(), name


def _datasets(mod, x, y, tx, ty):
    return mod.Datasets(train=mod.DataSet(x, y, seed=1),
                        validation=mod.DataSet(tx[:10], ty[:10], seed=3),
                        test=mod.DataSet(tx, ty, seed=2))


@pytest.mark.parametrize("family", ["cnn", "lstm", "transformer"])
def test_trainer_steps_match_the_jax_trainer(family):
    """One epoch of 6 SGD steps through each package's ``Trainer`` (the
    eager loop, f32), from the same weights on the same data."""
    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu.data import mnist as jmnist
    from distributed_tensorflow_tpu.train.trainer import Trainer as JTrainer
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data import mnist as tmnist
    from distributed_tensorflow_tpu_torch.train.trainer import Trainer

    jm, jp, tm, tp, _ = _pair(family, seed=4)
    x, y = _data(300, seed=5)
    tx, ty = _data(40, seed=6)
    jlines, tlines = [], []
    jtr = JTrainer(jm, _datasets(jmnist, x, y, tx, ty),
                   JConfig(epochs=1, batch_size=50, learning_rate=0.1, log_frequency=2,
                           logs_path="", scan_epoch=False, compute_dtype="float32"),
                   print_fn=lambda *a: jlines.append(" ".join(map(str, a))))
    jtr.state = jtr.state._replace(params=jp)
    jres = jtr.run()
    ttr = Trainer(tm, _datasets(tmnist, x, y, tx, ty),
                  TrainConfig(epochs=1, batch_size=50, learning_rate=0.1, log_frequency=2,
                              compute_dtype="float32"),
                  print_fn=tlines.append, device="cpu")
    ttr.state = ttr.state._replace(params=tp)
    tres = ttr.run()
    (jmask, jn), (tmask, tn) = _masked(jlines), _masked(tlines)
    assert tmask == jmask and len([ln for ln in tmask if ln.startswith("Step")]) == 3
    np.testing.assert_allclose(tn, jn, atol=1.5e-4)
    assert tres["global_step"] == jres["global_step"] == 6
    np.testing.assert_allclose(tres["final_cost"], jres["final_cost"], rtol=1e-5)
    for name, t in zip(ttr.state.params._fields, ttr.state.params):
        np.testing.assert_allclose(t.numpy(), np.asarray(getattr(jtr.state.params, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("family,extra", [
    ("cnn", {}), ("lstm", {}), ("transformer", {}),
    ("transformer", dict(attention_impl="flash", flash_min_len=0)),
], ids=["cnn", "lstm", "transformer", "transformer-flash"])
def test_remat_gradients_equal_the_plain_ones(family, extra):
    """``TrainConfig(remat=True)`` checkpoints the family's forward
    (``launch._RematAdapter``; with flash attention the recompute runs
    ``dtf::FlashAttention`` again): the same gradients bit for bit."""
    from distributed_tensorflow_tpu_torch.launch import _RematAdapter
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
    from distributed_tensorflow_tpu_torch.parallel.strategy import loss_and_grads

    _, _, tm, tp, _ = _pair(family, seed=7, **extra)
    x, y = (torch.from_numpy(a) for a in _data(4, seed=8))
    c0, g0 = loss_and_grads(tm, cross_entropy, tp, x, y)
    c1, g1 = loss_and_grads(_RematAdapter(tm), cross_entropy, tp, x, y)
    assert torch.equal(c0, c1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# -- the registry, the config and the refusals ----------------------------------


@pytest.mark.parametrize("name", ["mlp", "cnn", "lstm", "transformer"])
def test_registry_builds_every_family_and_the_trainer_takes_it(name, monkeypatch):
    """``build_model`` gives the JAX registry's class for each name, and
    ``TrainConfig(model=)`` / ``DTF_MODEL`` take each name through
    ``build_trainer`` (one eager step on a tiny dataset)."""
    from distributed_tensorflow_tpu.models import MODEL_REGISTRY as JREG
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data import mnist as tmnist
    from distributed_tensorflow_tpu_torch.launch import build_trainer, config_from_env
    from distributed_tensorflow_tpu_torch.models import MODEL_REGISTRY, build_model
    from distributed_tensorflow_tpu_torch.models.base import Model

    assert sorted(MODEL_REGISTRY) == sorted(JREG)
    model = build_model(name, compute_dtype=torch.float32)
    assert type(model).__name__ == JREG[name][1] and isinstance(model, Model)
    monkeypatch.setenv("DTF_MODEL", name)
    cfg = config_from_env(TrainConfig(epochs=1, batch_size=20, log_frequency=10**6))
    assert cfg.model == name
    x, y = _data(20, seed=9)
    tr = build_trainer(cfg, datasets=_datasets(tmnist, x, y, x, y), device="cpu",
                       print_fn=lambda *a: None)
    assert type(tr.model).__name__ == JREG[name][1]
    assert tr.model.compute_dtype == torch.bfloat16
    res = tr.run()
    assert res["global_step"] == 1 and np.isfinite(res["final_cost"])


def test_registry_refuses_an_unknown_name_with_the_jax_message():
    from distributed_tensorflow_tpu.models import build_model as jbuild
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.launch import build_trainer
    from distributed_tensorflow_tpu_torch.models import build_model

    with pytest.raises(ValueError) as want:
        jbuild("resnet")
    with pytest.raises(ValueError) as got:
        build_model("resnet")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        build_trainer(TrainConfig(model="resnet"), device="cpu", datasets=object())


def test_importing_the_serving_stack_pulls_in_no_classifier():
    import subprocess
    import sys

    code = ("import sys, distributed_tensorflow_tpu_torch.serve, "
            "distributed_tensorflow_tpu_torch.models as m; "
            "print(sorted(k for k in sys.modules if k.startswith(m.__name__ + '.')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    assert not any(f"models.{n}'" in out for n in ("cnn", "rnn", "transformer")), out


@pytest.mark.parametrize("what", ["cnn_specs", "lstm_specs", "sequence_parallel",
                                  "from_checkpoint", "stable_transformer", "pallas_cnn"])
def test_refusals(what, tmp_path):
    """What this slice leaves out raises naming its ROADMAP item; the
    transformer's stable loss and the fused engine on a non-MLP keep the
    JAX package's wording. The sequence-parallel forward, once refused, now
    runs: on a mesh of one rank it is the dense forward, with each of its
    attentions. ``Predictor.from_checkpoint``, once refused, probes the
    directory without making it and raises ``FileNotFoundError`` on none
    (tests/test_torch_checkpoint.py restores through it)."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data import mnist as tmnist
    from distributed_tensorflow_tpu_torch.inference import Predictor
    from distributed_tensorflow_tpu_torch.launch import build_trainer
    from distributed_tensorflow_tpu_torch.models import build_model

    x, y = _data(20, seed=10)
    ds = _datasets(tmnist, x, y, x, y)
    if what == "sequence_parallel":
        from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh

        model = build_model("transformer", compute_dtype=torch.float32)
        params = model.init(1, device="cpu")
        xs = torch.from_numpy(x[:4])
        mesh = make_mesh((1,), ("seq",), device="cpu")
        want = model.apply(params, xs)
        for attention in ("ring", "ring_flash", "ulysses"):
            got = model.apply_sequence_parallel(params, xs, mesh, attention=attention)
            assert torch.allclose(got, want, rtol=1e-5, atol=1e-6), attention
        with pytest.raises(ValueError, match="unknown attention 'dense'"):
            model.apply_sequence_parallel(params, xs, mesh, attention="dense")
        return
    if what == "stable_transformer":
        with pytest.raises(ValueError, match="loss='stable' needs apply_logits on "
                                             "TransformerClassifier$"):
            build_trainer(TrainConfig(model="transformer", loss="stable"), datasets=ds,
                          device="cpu")
        return
    if what == "pallas_cnn":
        tr = build_trainer(TrainConfig(model="cnn", engine="pallas", compiled_run=True,
                                       batch_size=20), datasets=ds, device="cpu")
        with pytest.raises(ValueError, match=r"engine='pallas' requires the reference workload "
                                             r"shape; got model CNN \(need MLP\)"):
            tr.run()
        return
    if what in ("cnn_specs", "lstm_specs"):  # ported: JAX's layouts, as tuples
        from distributed_tensorflow_tpu.models import build_model as jbuild

        family = what.split("_")[0]
        got = build_model(family).partition_specs()
        want = jbuild(family).partition_specs()
        assert got._fields == want._fields
        assert all(tuple(b) == a for a, b in zip(got, want))
        return
    if what == "from_checkpoint":  # ported: a missing directory is probed, never made
        missing = str(tmp_path / "ckpt")
        with pytest.raises(FileNotFoundError, match="no checkpoint under"):
            Predictor.from_checkpoint(build_model("cnn"), missing)
        assert not (tmp_path / "ckpt").exists()
        return
    raise AssertionError(what)


def test_constructors_check_as_jax_does():
    from distributed_tensorflow_tpu_torch.models import build_model

    with pytest.raises(ValueError, match="image_size 30 must be divisible by 4"):
        build_model("cnn", image_size=30)
    with pytest.raises(ValueError, match=r"channels must be \(c1, c2\)"):
        build_model("cnn", channels=(4, 8, 16))
    with pytest.raises(ValueError, match="unknown attention_impl 'ring'"):
        build_model("transformer", attention_impl="ring")


@pytest.mark.parametrize("name", ["cnn", "lstm", "transformer"])
def test_init_is_deterministic_and_shaped_as_jax(name):
    """``init`` gives the JAX package's shapes and constant leaves (zero
    biases and head, the LSTM's +1 forget gate, unit layernorm scales), the
    same draws for the same seed and other draws for another."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.models import build_model as jbuild
    from distributed_tensorflow_tpu_torch.models import build_model

    jp = jbuild(name, compute_dtype=jnp.float32).init(seed=1)
    tm = build_model(name)
    a, b, c = (tm.init(seed=s, device="cpu") for s in (1, 1, 2))
    assert a._fields == jp._fields
    for k in a._fields:
        want = np.asarray(getattr(jp, k))
        t = getattr(a, k)
        assert tuple(t.shape) == want.shape and t.dtype == torch.float32, k
        assert torch.equal(t, getattr(b, k)), k
        if len(np.unique(want)) <= 2:  # a constant leaf (the forget gate's row of ones)
            assert np.array_equal(t.numpy(), want), k
        else:
            assert not torch.equal(t, getattr(c, k)), k
            # The draws' scale is the JAX init's (within the sampling error).
            np.testing.assert_allclose(t.std().item(), want.std(), rtol=0.35, err_msg=k)


# -- carrying parameters and optimizer states ----------------------------------


@pytest.mark.parametrize("family", ["cnn", "lstm", "transformer"])
def test_convert_round_trips_are_bitwise(family):
    """Each family's params (the JAX NamedTuple in, numpy out) and an Adam
    state over them (optax's, after one update) cross bit for bit."""
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu_torch import convert
    from distributed_tensorflow_tpu_torch.ops.optim import AdamState

    _, jp, _, _, tree = _pair(family, seed=11)
    frm = getattr(convert, f"{family}_params_from_numpy")
    to = getattr(convert, f"{family}_params_to_numpy")
    tp = frm(jp, device="cpu")
    assert type(tp).__name__ == type(jp).__name__
    back = to(tp)
    for k, v in tree.items():
        assert back[k].tobytes() == v.tobytes(), k
    opt = joptim.make("adam", 0.01)
    st = opt.init(jp)
    _, st = opt.update(jp, st, jp)
    ts = convert.mlp_opt_state_from_numpy(st, device="cpu", cls=type(tp))
    assert isinstance(ts, AdamState) and int(ts.count) == 1
    out = convert.mlp_opt_state_to_numpy(ts)
    adam = convert._adam_like(st)
    for part in ("mu", "nu"):
        for k in tree:
            assert out[part][k].tobytes() == np.asarray(getattr(adam[part], k)).tobytes()


# -- inference.Predictor (the cases of tests/test_inference.py) -----------------


@pytest.fixture(scope="module")
def trained():
    """The MLP after 3 SGD steps on one batch, as tests/test_inference.py
    trains it (f32 here, so that chunked and direct agree closely)."""
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
    from distributed_tensorflow_tpu_torch.parallel.strategy import SingleDevice

    rng = np.random.default_rng(0)
    x = rng.random((256, 784), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 256)]
    model, strat, opt = MLP(compute_dtype=torch.float32), SingleDevice("cpu"), optim.sgd(0.001)
    state = strat.init_state(model, opt, seed=1)
    step = strat.make_train_step(model, cross_entropy, opt)
    for _ in range(3):
        state, _ = step(state, *strat.prepare_batch(x, y))
    return model, strat, state, x, y


@pytest.mark.parametrize("n", [1, 63, 64, 65, 200])
def test_predictor_chunked_matches_direct(trained, n):
    from distributed_tensorflow_tpu_torch.inference import Predictor

    model, strat, state, x, _ = trained
    pred = Predictor.from_state(model, state, strategy=strat, batch_size=64, device="cpu")
    with torch.no_grad():
        direct = model.apply(state.params, torch.from_numpy(x[:n])).numpy()
    got = pred.predict_proba(x[:n])
    assert isinstance(got, np.ndarray) and got.shape == (n, 10)
    np.testing.assert_allclose(got, direct, rtol=1e-5, atol=1e-7)
    assert pred.predict(x[:n]).shape == (n,)


def test_predictor_refuses_a_bad_batch_size_and_an_empty_batch(trained):
    from distributed_tensorflow_tpu_torch.inference import Predictor

    model, strat, state, _, _ = trained
    with pytest.raises(ValueError, match="batch_size must be >= 1"):
        Predictor(model, state.params, batch_size=0, device="cpu")
    pred = Predictor.from_state(model, state, strategy=strat, device="cpu")
    with pytest.raises(ValueError, match="empty batch"):
        pred.predict_proba(np.zeros((0, 784), np.float32))


def test_predictor_accuracy_matches_the_eval_fn(trained):
    from distributed_tensorflow_tpu_torch.inference import Predictor

    model, strat, state, x, y = trained
    pred = Predictor.from_state(model, state, strategy=strat, batch_size=100, device="cpu")
    eval_acc = float(strat.make_eval_fn(model)(state, torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(pred.accuracy(x, y), eval_acc, atol=1e-6)


def test_predictor_async_state_refused_without_strategy_and_served_with_it(trained):
    """An async state (a step tuple: every rank's count) holds one rank's
    copy: refused without the strategy, served through its
    ``effective_params`` with it (a world of one rank here; the 2-rank
    world is tests/test_torch_dp_classifiers.py)."""
    from distributed_tensorflow_tpu_torch.inference import Predictor
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.ops.losses import cross_entropy
    from distributed_tensorflow_tpu_torch.parallel.strategy import AsyncDataParallel

    model, _, _, x, y = trained
    strat = AsyncDataParallel(device="cpu")
    opt = optim.sgd(0.001)
    state = strat.init_state(model, opt, seed=1)
    with pytest.raises(ValueError, match="per-rank"):
        Predictor.from_state(model, state, device="cpu")
    state, _ = strat.make_train_step(model, cross_entropy, opt)(
        state, *strat.prepare_batch(x[:64], y[:64]))
    pred = Predictor.from_state(model, state, strategy=strat, batch_size=100, device="cpu")
    eval_acc = float(strat.make_eval_fn(model)(state, torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(pred.accuracy(x, y), eval_acc, atol=1e-6)


@pytest.mark.parametrize("name", ["mlp", "cnn", "lstm", "transformer"])
def test_predictor_serves_every_model_family(name):
    """Each family at the registry's default widths, f32, as the JAX test
    serves it; the probabilities equal the JAX Predictor's on the same
    weights."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.inference import Predictor as JPredictor
    from distributed_tensorflow_tpu.models import build_model as jbuild
    from distributed_tensorflow_tpu_torch.inference import Predictor
    from distributed_tensorflow_tpu_torch.models import build_model

    jm = jbuild(name, compute_dtype=jnp.float32)
    tree = classifier_numpy_params(jm, seed=12)
    tm = build_model(name, compute_dtype=torch.float32)
    x = np.random.default_rng(0).random((20, 784), dtype=np.float32)
    probs = Predictor(tm, torch_classifier_params(tm, tree), batch_size=16,
                      device="cpu").predict_proba(x)
    assert probs.shape == (20, 10)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    want = JPredictor(jm, jax_classifier_params(jm, tree), batch_size=16).predict_proba(x)
    np.testing.assert_allclose(probs, want, atol=1e-5)


def test_predictor_runs_on_cuda_unless_asked(trained, monkeypatch):
    from distributed_tensorflow_tpu_torch.inference import Predictor

    model, _, state, _, _ = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(model, state.params)
