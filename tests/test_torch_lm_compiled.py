"""PyTorch port: ``LMTrainer.run_compiled`` (the JAX ``_build_compiled_run_fn``
path) against ``run()`` bit for bit, its log surface, the chunked
held-out eval and its edges, ragged corpora, no host read inside the run,
and its perplexities against the JAX package's ``run_compiled``."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import _torch_parity  # noqa: F401  (sets torch's thread count for xdist workers)

COPY = dict(num=768, half_len=8, vocab=61, n_val=128, n_test=128, seed=0)


def _model(**kw):
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    return GPTLM(**{**dict(vocab_size=61, max_len=16, model_dim=32, num_heads=4,
                           num_layers=2, compute_dtype=torch.float32), **kw})


def _cfg(**kw):
    from distributed_tensorflow_tpu_torch.config import TrainConfig

    return TrainConfig(**{**dict(epochs=2, batch_size=64, optimizer="adam",
                                 learning_rate=3e-3, log_frequency=4), **kw})


def _corpus():
    from distributed_tensorflow_tpu_torch.data.tokens import copy_corpus

    return copy_corpus(**COPY)


def _ragged(seed=0):
    from distributed_tensorflow_tpu_torch.data import tokens as tt

    rng = np.random.default_rng(seed)
    half = rng.integers(0, 61, (512, 8))
    toks = np.concatenate([half, half], axis=1).astype(np.int32)
    lens = rng.integers(4, 17, 512).astype(np.int32)
    for i, n in enumerate(lens):
        toks[i, n:] = 0
    return tt._split(toks, lens, 64, 64, seed)


def _trainer(data=_corpus, model_kw=None, **kw):
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    lines = []
    cfg = kw.pop("cfg", {})
    tr = LMTrainer(_model(**(model_kw or {})), data(), _cfg(**cfg), device="cpu",
                   print_fn=lambda *a: lines.append(" ".join(map(str, a))), **kw)
    return tr, lines


@pytest.fixture
def one_thread():
    """The CPU's threaded products need not repeat bit for bit across
    calls: the bitwise comparisons run on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", ["dense", "flash-selective", "ragged", "schedule"])
def test_run_compiled_equals_run_bitwise(case, one_thread):
    """The same index stream and step: parameters, every cost and each
    epoch's perplexity bit for bit (eval_batch 64 divides the 128-row
    split), the same log lines but for AvgTime."""
    kw = {}
    if case == "flash-selective":
        kw = dict(model_kw=dict(attention_impl="flash", flash_min_len=0),
                  cfg=dict(remat="selective"))
    elif case == "ragged":
        kw = dict(data=_ragged)
    elif case == "schedule":
        from distributed_tensorflow_tpu_torch.ops import optim

        kw = dict(optimizer=optim.accumulate(optim.clip(
            optim.make("adamw", optim.schedule("cosine", 3e-3, 8, warmup_steps=2)), 1.0), 2))
    out = []
    for compiled in (False, True):
        costs = []
        tr, lines = _trainer(eval_batch=64, **kw)
        step = tr._train_step

        def keep(toks, lens, step=step, costs=costs):
            costs.append(step(toks, lens))
            return costs[-1]

        tr._train_step = keep
        res = tr.run_compiled() if compiled else tr.run()
        out.append((tr, res, torch.stack(costs),
                    [ln.split("AvgTime:")[0] for ln in lines if not ln.startswith("Total")]))
    (a, ra, ca, la), (b, rb, cb, lb) = out
    assert ra == rb and a.global_step == b.global_step == 2 * (len(a.datasets.train.tokens) // 64)
    assert torch.equal(ca, cb)
    assert a.history == b.history and la == lb
    for x, y in zip(a.state.params.blocks + (a.state.params.embed,),
                    b.state.params.blocks + (b.state.params.embed,)):
        assert torch.equal(x, y)


def test_run_compiled_log_surface():
    """tests/test_lm_trainer.py:543: 8 steps at freq 4 a epoch, one
    Test-Perplexity line an epoch, Final Cost and Done."""
    tr, lines = _trainer()
    res = tr.run_compiled(epochs=2)
    assert sum(ln.startswith("Step:") for ln in lines) == 4
    assert re.fullmatch(r"Step: 12,  Epoch:  2,  Batch:   4 of   8,  Cost: \d\.\d{4},"
                        r"  AvgTime: \d+\.\d{2}ms", [ln for ln in lines if "Step:" in ln][2])
    assert sum(ln.startswith("Test-Perplexity:") for ln in lines) == 2
    assert lines[-2] == f"Final Cost: {res['final_cost']:.4f}" and lines[-1] == "Done"
    assert [h["step"] for h in tr.history] == [8, 16] and res["global_step"] == 16


def test_run_compiled_chunked_eval_and_edges(one_thread):
    """tests/test_lm_trainer.py:555: eval_batch smaller than the split runs
    the eval chunked and equals evaluate() where it divides the split; one
    that does not covers the split trimmed to a chunk multiple; epochs=0 is
    a no-op; compiled_run=True makes run() the compiled run."""
    tr, _ = _trainer(eval_batch=32, cfg=dict(epochs=1))
    tr.run_compiled(epochs=1)
    assert tr.history[-1]["perplexity"] == tr.evaluate("validation")
    # 128 rows in chunks of 48: the first 96 rows (two chunks) only.
    tr48, _ = _trainer(eval_batch=48, cfg=dict(epochs=1))
    tr48.run_compiled(epochs=1)
    val = tr48.datasets.validation
    toks = torch.from_numpy(val.tokens)
    total, count = 0.0, 0
    for lo in (0, 48):
        s, c = tr48._ce_count(tr48.state.params, toks[lo:lo + 48], None)
        total, count = total + float(s), count + c
    assert tr48.history[-1]["perplexity"] == float(np.exp(total / count))
    assert tr48.history[-1]["perplexity"] != tr48.evaluate("validation")
    tr0, lines = _trainer()
    res = tr0.run_compiled(epochs=0)
    assert res["global_step"] == 0 and np.isfinite(res["perplexity"]) and lines[-1] == "Done"
    trc, lines = _trainer(cfg=dict(compiled_run=True, epochs=1))
    assert trc.run()["global_step"] == 8 and len(trc.history) == 1


class _CountHostReads(TorchDispatchMode):
    """Counts ops that read a tensor's value on the host (``.item()``,
    ``float()``, ``int()``, ``bool()``: ``aten._local_scalar_dense``)."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads += 1
        return func(*args, **(kwargs or {}))


def test_run_compiled_reads_nothing_on_the_host_inside_its_loop():
    """The costs and eval sums come back in the one fetch after the loop:
    no ``.item()``/``float()`` of a device tensor while it runs, where
    run() reads a cost at every due log line and each eval chunk's sum."""
    counts = {}
    for label in ("run_compiled", "run"):
        tr, _ = _trainer(cfg=dict(log_frequency=1))
        tr.evaluate = lambda split="validation": 0.0  # the final full-split evaluate
        mode = _CountHostReads()
        with mode:
            getattr(tr, label)()
        counts[label] = mode.reads
    assert counts["run_compiled"] == 0
    assert counts["run"] >= 16


def test_perplexities_match_jax_run_compiled():
    """The port's run_compiled and the JAX one, from the same params (the
    JAX init carried over) on the same corpus and index stream: each
    epoch's in-run perplexity within 1e-4 relative and the final
    parameters within 1e-4 (f32; sums in another order, Adam at lr 3e-3
    over 16 steps), as the run() comparison in test_torch_lm_trainer.py."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu.data.tokens import copy_corpus as jcopy
    from distributed_tensorflow_tpu.models.gpt import GPTLM as JGPT
    from distributed_tensorflow_tpu.train import LMTrainer as JTrainer
    from distributed_tensorflow_tpu_torch.convert import gpt_params_from_numpy

    kw = dict(vocab_size=61, max_len=16, model_dim=32, num_heads=4, num_layers=2,
              attention_impl="flash", flash_min_len=0)
    cfg = dict(epochs=2, batch_size=64, optimizer="adam", learning_rate=3e-3, log_frequency=4)
    jtr = JTrainer(JGPT(**kw, compute_dtype=jnp.float32), jcopy(**COPY), JConfig(**cfg),
                   eval_batch=64, print_fn=lambda *a: None)
    ttr, _ = _trainer(model_kw=kw, cfg=cfg, eval_batch=64)
    ttr.state = ttr._init_state(gpt_params_from_numpy(jtr.state.params, device="cpu"))
    jres, tres = jtr.run_compiled(epochs=2), ttr.run_compiled(epochs=2)
    for a, b in zip(jtr.history, ttr.history):
        assert a["step"] == b["step"]
        assert abs(a["perplexity"] - b["perplexity"]) <= 1e-4 * a["perplexity"]
    assert abs(jres["perplexity"] - tres["perplexity"]) <= 1e-4 * jres["perplexity"]
    jp = jtr.state.params
    assert np.abs(np.asarray(jp.embed) - ttr.state.params.embed.numpy()).max() < 1e-4
    assert np.abs(np.asarray(jp.blocks.wq) - ttr.state.params.blocks.wq.numpy()).max() < 1e-4
