"""PyTorch port: the token corpora and the LM trainer against the JAX
package — bitwise index streams and corpora, the staged loop ≡ an eager
``next_batch`` loop, the log
surface and history, the copy-task oracle, two epochs against the JAX
``LMTrainer`` from the same params, ragged corpora, and the refusals of
what this slice does not port."""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (sets torch's thread count for xdist workers)

COPY = dict(num=768, half_len=8, vocab=61, n_val=128, n_test=128, seed=0)


def _model(**kw):
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    kw.setdefault("compute_dtype", torch.float32)
    return GPTLM(**{**dict(vocab_size=61, max_len=16, model_dim=32, num_heads=4,
                           num_layers=2), **kw})


def _cfg(**kw):
    from distributed_tensorflow_tpu_torch.config import TrainConfig

    return TrainConfig(**{**dict(epochs=2, batch_size=64, optimizer="adam",
                                 learning_rate=3e-3, log_frequency=4), **kw})


def _corpus(**kw):
    from distributed_tensorflow_tpu_torch.data.tokens import copy_corpus

    return copy_corpus(**{**COPY, **kw})


def _ragged(mod, seed=0):
    """A ragged copy corpus (``x · x`` right-padded past lengths 4..16) as
    the JAX or the port module builds it from the same arrays."""
    rng = np.random.default_rng(seed)
    half = rng.integers(0, 61, (512, 8))
    toks = np.concatenate([half, half], axis=1).astype(np.int32)
    lens = rng.integers(4, 17, 512).astype(np.int32)
    for i, n in enumerate(lens):
        toks[i, n:] = 0
    return mod._split(toks, lens, 64, 64, seed)


@pytest.mark.parametrize("kind", ["copy", "markov"])
def test_token_corpora_and_streams_are_bitwise(kind):
    """The same arguments give the JAX package's arrays bit for bit, and
    ``next_indices`` / ``next_batch`` the same stream across reshuffles."""
    from distributed_tensorflow_tpu.data import tokens as jt
    from distributed_tensorflow_tpu_torch.data import tokens as tt

    args = (dict(num=300, half_len=5, vocab=17, n_val=40, n_test=20, seed=3)
            if kind == "copy" else
            dict(num=300, seq_len=12, vocab=23, n_val=40, n_test=20, seed=4))
    fn = "copy_corpus" if kind == "copy" else "markov_corpus"
    a, b = getattr(jt, fn)(**args), getattr(tt, fn)(**args)
    for split in ("train", "validation", "test"):
        np.testing.assert_array_equal(getattr(a, split).tokens, getattr(b, split).tokens)
    for _ in range(25):  # 240 train rows, batches of 32: several reshuffles
        np.testing.assert_array_equal(a.train.next_indices(32), b.train.next_indices(32))
    np.testing.assert_array_equal(a.train.next_batch(7), b.train.next_batch(7))
    assert a.train.epochs_completed == b.train.epochs_completed > 2
    ra, rb = _ragged(jt), _ragged(tt)
    for x, y in zip(ra.train.next_batch(100), rb.train.next_batch(100)):
        np.testing.assert_array_equal(x, y)


def test_log_surface_and_history():
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    lines = []
    tr = LMTrainer(_model(), _corpus(), _cfg(scan_epoch=True), device="cpu",
                   print_fn=lambda *a: lines.append(" ".join(map(str, a))))
    res = tr.run()
    # 512 train / 64 = 8 steps an epoch, freq 4 → 2 step lines an epoch.
    step_lines = [ln for ln in lines if ln.startswith("Step:")]
    assert len(step_lines) == 4
    assert re.fullmatch(r"Step: 4,  Epoch:  1,  Batch:   4 of   8,  Cost: \d\.\d{4},"
                        r"  AvgTime: \d+\.\d{2}ms", step_lines[0])
    assert sum(ln.startswith("Test-Perplexity:") for ln in lines) == 2
    assert lines[-2] == f"Final Cost: {res['final_cost']:.4f}" and lines[-1] == "Done"
    assert res["global_step"] == 16 == tr.global_step
    assert [h["epoch"] for h in tr.history] == [1, 2]
    assert [h["step"] for h in tr.history] == [8, 16]
    assert res["perplexity"] == tr.history[-1]["perplexity"] < 61  # below uniform


def test_epoch_metric_line_is_byte_identical_to_jax():
    from distributed_tensorflow_tpu.utils.logging import StepLogger as JLogger
    from distributed_tensorflow_tpu_torch.utils.logging import StepLogger

    out = {}
    for name, cls in (("jax", JLogger), ("port", StepLogger)):
        lines = []
        lg = cls(freq=4, print_fn=lines.append)
        lg._begin_time = 1000.0
        lg.log_epoch_metric("Test-Perplexity", 12.3456789)
        out[name] = lines
    assert out["jax"][0] == out["port"][0] == "Test-Perplexity: 12.3457"
    assert out["jax"][1].startswith("Total Time: ") and out["port"][1].startswith("Total Time: ")


def test_scanned_equals_eager():
    """The trainer's one loop (tokens staged once, indices from
    ``next_indices``, batches gathered on the device) takes the batches of
    an eager loop over ``next_batch`` with the same step function, so the
    parameters and costs agree exactly (on one thread: the CPU's threaded
    products need not repeat bit for bit). ``scan_epoch`` changes nothing."""
    from distributed_tensorflow_tpu_torch.models.gpt import make_lm_train_step
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trs = []
        for scan in (True, False):
            tr = LMTrainer(_model(), _corpus(), _cfg(scan_epoch=scan), device="cpu",
                           print_fn=lambda *a: None)
            tr.run()
            trs.append(tr)
        model, cfg, ds = _model(), _cfg(), _corpus()
        opt = trs[0].optimizer
        step = make_lm_train_step(model, opt)
        params = model.init(seed=cfg.seed, device="cpu")
        opt_state = opt.init(params)
        for _ in range(cfg.epochs * (ds.train.num_examples // cfg.batch_size)):
            toks = torch.from_numpy(ds.train.next_batch(cfg.batch_size))
            params, opt_state, cost = step(params, opt_state, toks, None)
    finally:
        torch.set_num_threads(threads)
    for tr in trs:
        assert tr.last_cost == float(cost)
        for x, y in zip(tr.state.params.blocks + (tr.state.params.embed,),
                        params.blocks + (params.embed,)):
            assert torch.equal(x, y)
    assert [h["perplexity"] for h in trs[0].history] == [h["perplexity"] for h in trs[1].history]


def test_copy_task_oracle_with_flash():
    """tests/test_lm_trainer.py's oracle on the CPU through the flash
    attention Function: perplexity falls below 0.75 of the first epoch's
    and below 40 (uniform is 61)."""
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    tr = LMTrainer(_model(attention_impl="flash", flash_min_len=0), _corpus(),
                   _cfg(epochs=6), device="cpu", print_fn=lambda *a: None)
    tr.run()
    ppls = [h["perplexity"] for h in tr.history]
    assert ppls[-1] < 0.75 * ppls[0] and ppls[-1] < 40, ppls


def _costs(lines):
    return [float(m.group(1)) for m in
            (re.search(r"Cost: ([0-9.]+)", ln) for ln in lines) if m]


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_two_epochs_match_jax_lm_trainer(impl):
    """The port's LMTrainer and the JAX one, from the same params (the JAX
    init carried over) on the same corpus: every step's printed cost, each
    epoch's perplexity and the final parameters (f32; sums in another
    order, Adam at lr 3e-3 over 16 steps)."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu.data.tokens import copy_corpus as jcopy
    from distributed_tensorflow_tpu.models.gpt import GPTLM as JGPT
    from distributed_tensorflow_tpu.train import LMTrainer as JTrainer
    from distributed_tensorflow_tpu_torch.convert import gpt_params_from_numpy
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    kw = dict(vocab_size=61, max_len=16, model_dim=32, num_heads=4, num_layers=2)
    if impl == "flash":
        kw.update(attention_impl="flash", flash_min_len=0)
    cfg = dict(epochs=2, batch_size=64, optimizer="adam", learning_rate=3e-3,
               log_frequency=1)
    jl, tl = [], []
    jtr = JTrainer(JGPT(**kw, compute_dtype=jnp.float32), jcopy(**COPY),
                   JConfig(**cfg, scan_epoch=False), print_fn=jl.append)
    ttr = LMTrainer(_model(**kw), _corpus(), _cfg(**cfg, scan_epoch=False), device="cpu",
                    print_fn=tl.append)
    ttr.state = ttr._init_state(gpt_params_from_numpy(jtr.state.params, device="cpu"))
    jtr.run()
    ttr.run()
    jc, tc = _costs(jl), _costs(tl)
    assert len(jc) == len(tc) == 16 + 1  # 16 step lines and the final cost
    assert max(abs(a - b) for a, b in zip(jc, tc)) <= 2e-4  # printed to 4 places
    for a, b in zip(jtr.history, ttr.history):
        assert a["step"] == b["step"]
        assert abs(a["perplexity"] - b["perplexity"]) <= 1e-4 * a["perplexity"]
    jp = jtr.state.params
    assert np.abs(np.asarray(jp.embed) - ttr.state.params.embed.numpy()).max() < 1e-4
    assert np.abs(np.asarray(jp.blocks.wq) - ttr.state.params.blocks.wq.numpy()).max() < 1e-4


def test_ragged_corpus_trains_through_the_masked_loss():
    """Datasets with ``lengths`` train on the masked loss and evaluate on
    the real targets only; the masked loss matches the JAX trainer's eval
    arithmetic on the same params."""
    from distributed_tensorflow_tpu.data import tokens as jt
    from distributed_tensorflow_tpu_torch.data import tokens as tt
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    ds = _ragged(tt)
    lines = []
    tr = LMTrainer(_model(), ds, _cfg(epochs=2, batch_size=32), device="cpu",
                   print_fn=lines.append)
    before = tr.evaluate()
    tr.run()
    assert tr._ragged and lines[-1] == "Done"
    ppl = tr.history[-1]["perplexity"]
    assert np.isfinite(ppl) and ppl < before
    # Pad content does not reach the loss: noise past each length changes nothing.
    val = ds.validation
    noisy = val.tokens.copy()
    for i, n in enumerate(val.lengths):
        noisy[i, n:] = 60
    ds2 = tt.TokenDatasets(ds.train, tt.TokenDataset(noisy, val.lengths), ds.test)
    tr.datasets = ds2
    assert tr.evaluate() == ppl
    count = int((val.lengths - 1).sum())
    s, c = tr._ce_count(tr.state.params, torch.from_numpy(val.tokens), torch.from_numpy(val.lengths))
    assert c == count and abs(float(np.exp(float(s) / c)) - ppl) < 1e-3 * ppl
    assert _ragged(jt).validation.lengths.tolist() == val.lengths.tolist()


@pytest.mark.parametrize("name,value,item", [
    ("mesh", object(), "A7"), ("summary_writer", object(), "A8"),
    ("supervisor", object(), "A8"), ("journal", object(), "A8"),
    ("metrics", object(), "A8"),
    ("delta_exchange", object(), "A7"), ("is_chief", False, "A7"),
    ("tp_axis", "tensor", "A7"), ("sp_attention", "ulysses", "A7"),
])
def test_refused_trainer_knobs(name, value, item):
    """What is still refused names its ROADMAP item (the parallel modes now
    A7c-A7d, which the match on "A7" takes). Lifted by the sequence-parallel
    slice: ``mesh`` (a ``parallel.mesh.Mesh``; anything else is refused),
    ``is_chief`` (False keeps the epoch and final lines off) and
    ``sp_attention`` (checked, used only under dp_mode="sp", as in JAX);
    by the tensor-parallel slice: ``tp_axis`` (used only under
    dp_mode="tp", whose mesh must have the axis, as in JAX). The local-SGD
    slice moved ``delta_exchange`` (the DiLoCo mailbox gang) to A8a. Lifted
    by the observability slice: ``summary_writer``, ``journal`` and
    ``metrics`` (a ``SummaryWriter``, an ``EventJournal`` and a
    ``MetricsRegistry``; ``object()`` stands for the parameter only), which
    the run writes to. Lifted by the checkpoint slice: ``supervisor`` (a
    ``train.supervisor.Supervisor``, which the run saves through) and
    ``delta_exchange`` (a ``local_sgd.DeltaExchange``, refused outside
    dp_mode="diloco" with JAX's wording)."""
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    if name in ("summary_writer", "journal", "metrics"):
        import tempfile

        from distributed_tensorflow_tpu_torch import observability as obs
        from distributed_tensorflow_tpu_torch.utils.summary import SummaryWriter

        with tempfile.TemporaryDirectory() as d:
            sink = {"summary_writer": lambda: SummaryWriter(d),
                    "journal": lambda: obs.EventJournal.in_dir(d),
                    "metrics": obs.MetricsRegistry}[name]()
            tr = LMTrainer(_model(), _corpus(), _cfg(), device="cpu", print_fn=lambda *a: None,
                           **{name: sink})
            tr.run(epochs=1)
            if name == "summary_writer":
                sink.close()
                assert any(f.startswith("events.out.tfevents.") for f in os.listdir(d))
            elif name == "journal":
                sink.close()
                kinds = [e["kind"] for e in obs.read_events(d)]
                assert kinds[-3:] == ["epoch", "final", "metrics"] and "step" in kinds
            else:
                assert sink.counter("epochs_total").value == 1
        return
    if name == "mesh":
        with pytest.raises(TypeError, match="mesh must be a parallel.mesh.Mesh"):
            LMTrainer(_model(), _corpus(), _cfg(), device="cpu", mesh=value)
        return
    if name == "is_chief":
        lines = []
        LMTrainer(_model(), _corpus(), _cfg(), device="cpu", is_chief=value,
                  print_fn=lines.append).run(epochs=1)
        assert lines and all(x.startswith("Step: ") for x in lines)
        return
    if name == "tp_axis":
        from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh

        assert LMTrainer(_model(), _corpus(), _cfg(), device="cpu",
                         tp_axis=value).mode == "single"
        with pytest.raises(ValueError, match="dp_mode='tp' needs a 'tensor' mesh axis"):
            LMTrainer(_model(), _corpus(), _cfg(dp_mode="tp"), device="cpu", tp_axis=value,
                      mesh=Mesh({"data": 1, "model": 1}))
        return
    if name == "sp_attention":
        assert LMTrainer(_model(), _corpus(), _cfg(), device="cpu",
                         sp_attention=value).mode == "single"
        with pytest.raises(ValueError, match="unknown sp_attention 'dense'"):
            LMTrainer(_model(), _corpus(), _cfg(), device="cpu", sp_attention="dense")
        return
    if name in ("delta_exchange", "supervisor"):
        import tempfile

        from distributed_tensorflow_tpu_torch.train.local_sgd import DeltaExchange
        from distributed_tensorflow_tpu_torch.train.supervisor import (
            Supervisor,
            checkpoint_steps,
        )

        with tempfile.TemporaryDirectory() as d:
            if name == "supervisor":
                tr = LMTrainer(_model(), _corpus(), _cfg(logs_path=""), device="cpu",
                               print_fn=lambda *a: None, supervisor=Supervisor(checkpoint_dir=d))
                tr.run(epochs=1)
                assert checkpoint_steps(d) == [tr.global_step]
            else:
                with pytest.raises(ValueError, match="delta_exchange is the diloco mailbox "
                                                     "gang: it requires dp_mode='diloco'"):
                    LMTrainer(_model(), _corpus(), _cfg(), device="cpu",
                              delta_exchange=DeltaExchange(d, 0, 1))
        return
    with pytest.raises(NotImplementedError, match=re.escape(item)):
        LMTrainer(_model(), _corpus(), _cfg(), device="cpu", **{name: value})


@pytest.mark.parametrize("kw,item", [
    (dict(epochs_per_dispatch=2), "A8"), (dict(checkpoint_dir="/tmp/ckpt"), "A8"),
    (dict(max_rollbacks=1), "A8"),
])
def test_refused_config(kw, item, tmp_path):
    """Once refused naming A8a, each is taken now and acts: the chunked
    tier, the checkpoint directory (a step saved an epoch) and the anomaly
    guard's budget."""
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer
    from distributed_tensorflow_tpu_torch.train.supervisor import checkpoint_steps

    if "checkpoint_dir" in kw:
        kw = dict(checkpoint_dir=str(tmp_path / "ckpt"))
    tr = LMTrainer(_model(), _corpus(), _cfg(logs_path="", **kw), device="cpu",
                   print_fn=lambda *a: None)
    res = tr.run()
    assert res["global_step"] == 2 * (_corpus().train.num_examples // 64)
    if "checkpoint_dir" in kw:
        assert checkpoint_steps(kw["checkpoint_dir"]) == [res["global_step"] // 2,
                                                          res["global_step"]]


@pytest.mark.parametrize("kw", [
    dict(compiled_run=True), dict(remat="selective"), dict(lr_schedule="cosine"),
    dict(tokenizer=True),
], ids=["compiled_run", "selective", "lr_schedule", "tokenizer"])
def test_lifted_refusals_are_accepted(kw):
    """What this trainer refused before the optimizer wrappers, selective
    remat, the compiled run and the text data: each is accepted and runs
    one epoch (the tokenizer is kept on the trainer). As in the JAX
    trainer, the config's schedule, clipping and accumulation fields act
    only through an ``optimizer=`` composed from them (as
    ``launch.build_trainer`` composes the MLP Trainer's): the trainer
    itself builds the plain ``make(optimizer, learning_rate)``."""
    from distributed_tensorflow_tpu_torch.data.text import ByteTokenizer
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    tok = ByteTokenizer() if kw.pop("tokenizer", None) else None
    cfg = _cfg(epochs=1, **kw)
    tr = LMTrainer(_model(attention_impl="flash", flash_min_len=0), _corpus(), cfg,
                   device="cpu", tokenizer=tok, print_fn=lambda *a: None)
    assert tr.tokenizer is tok
    assert tr.model.remat == cfg.remat
    assert tr.optimizer == optim.make(cfg.optimizer, cfg.learning_rate)
    res = tr.run()
    assert res["global_step"] == 8 and np.isfinite(res["final_cost"])


def test_config_remat_lands_on_a_copy_and_misc_refusals():
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    model = _model()
    tr = LMTrainer(model, _corpus(), _cfg(remat=True), device="cpu")
    assert tr.model.remat is True and model.remat is False and tr.model is not model
    with pytest.raises(ValueError, match="remat"):
        _cfg(remat="yes")
    with pytest.raises(TypeError, match="unexpected keyword"):
        LMTrainer(model, _corpus(), _cfg(), device="cpu", no_such_knob=1)


def test_lm_trainer_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMTrainer(_model(), _corpus(), _cfg())


def test_mlp_trainer_takes_stateful_optimizers():
    """The MLP Trainer carries momentum/adam/adamw state through its step
    (it refused them before the optimizer state was threaded through)."""
    from distributed_tensorflow_tpu_torch.data.mnist import DataSet, Datasets
    from distributed_tensorflow_tpu_torch.launch import build_trainer

    rng = np.random.default_rng(0)
    x = rng.random((300, 784), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 300)]
    ds = Datasets(train=DataSet(x[:200], y[:200], seed=1),
                  validation=DataSet(x[200:], y[200:], seed=3),
                  test=DataSet(x[200:], y[200:], seed=2))
    for name in ("momentum", "adam", "adamw"):
        tr = build_trainer(_cfg(optimizer=name, epochs=1, batch_size=50), datasets=ds,
                           device="cpu", print_fn=lambda *a: None)
        res = tr.run(1)
        assert res["global_step"] == 4 and np.isfinite(res["final_cost"])
        assert int(tr.state.opt_state.count) == 4
