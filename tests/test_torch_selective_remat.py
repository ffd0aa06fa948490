"""PyTorch port: selective remat (``GPTLM(remat="selective")``) against
plain remat and against the JAX package's selective policy, and the pin
that it saves work: the flash forward runs once a layer a step instead of
twice (the port's counterpart of the JAX FLOP pin, tests/test_gpt.py:1379)."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from _torch_parity import jax_model, jax_params, numpy_params, torch_model, torch_params

FLASH = {"attention_impl": "flash", "flash_min_len": 0}
KINDS = {"dense": {}, "gqa": {"num_kv_heads": 2}, "window": {"window": 8}}


def _leaves(tree):
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves

    return tree_leaves(tree)


def _tokens(seed, b=2, l=16):
    return np.random.default_rng(seed).integers(0, 97, (b, l)).astype(np.int32)


@pytest.fixture
def forward_calls(monkeypatch):
    """Counts the flash forward's runs (the plain version on the CPU; the
    kernel on the card runs at the same call)."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    calls = []
    real = fa._flash_forward

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(fa, "_flash_forward", counted)
    return calls


def _grads(remat, tree, toks, **kw):
    from distributed_tensorflow_tpu_torch.models.gpt import lm_value_and_grad

    loss, g = lm_value_and_grad(torch_model("float32", remat=remat, **kw), torch_params(tree),
                                torch.from_numpy(toks))
    return loss, _leaves(g)


@pytest.mark.parametrize("kind", list(KINDS))
def test_selective_equals_plain_remat_bitwise_and_runs_the_forward_once(kind, forward_calls):
    """Over 2 layers: "selective" gives remat=True's loss and gradients
    bit for bit, and runs the flash forward n times a step where True runs
    it 2n (and no remat n)."""
    tree = numpy_params(jax_model("float32", **KINDS[kind]), seed=30)
    toks = _tokens(31)
    n = 2
    out = {}
    for remat, runs in ((False, n), (True, 2 * n), ("selective", n)):
        forward_calls.clear()
        out[remat] = _grads(remat, tree, toks, **FLASH, **KINDS[kind])
        assert len(forward_calls) == runs, (remat, len(forward_calls))
    assert torch.equal(out[True][0], out["selective"][0])
    for a, b in zip(out[True][1], out["selective"][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", list(KINDS))
def test_selective_gradients_match_jax(kind):
    """The port's "selective" against the JAX package's remat="selective"
    (its rebuild composition over the Pallas kernel in interpret mode) on
    the same params and tokens: rtol 1e-5 / atol 1e-6, the JAX test's own
    tolerance between its two remat modes (tests/test_gpt.py:1359)."""
    import jax
    import jax.numpy as jnp

    tree = numpy_params(jax_model("float32", **KINDS[kind]), seed=32)
    toks = _tokens(33)
    jm = jax_model("float32", remat="selective", **FLASH, **KINDS[kind])
    jl, jg = jax.value_and_grad(jm.loss)(jax_params(tree), jnp.asarray(toks))
    tl, tg = _grads("selective", tree, toks, **FLASH, **KINDS[kind])
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(jg), tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)


def test_selective_on_the_dense_path_is_plain_remat(forward_calls):
    """attention_impl="xla", or L below flash_min_len: no flash operator to
    save, so "selective" recomputes everything, as remat=True does."""
    tree = numpy_params(jax_model("float32"), seed=34)
    toks = _tokens(35)
    for kw in ({}, {"attention_impl": "flash", "flash_min_len": 64}):
        a = _grads(True, tree, toks, **kw)
        b = _grads("selective", tree, toks, **kw)
        assert torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    assert not forward_calls


def test_callable_policy_and_bad_values(forward_calls):
    """A callable remat is a torch.utils.checkpoint policy_fn: one that
    saves every operator runs the forward once and gives plain remat's
    gradients; anything but False/True/"selective"/a callable raises."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    def save_all(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE

    tree = numpy_params(jax_model("float32"), seed=36)
    toks = _tokens(37)
    ref = _grads(True, tree, toks, **FLASH)
    forward_calls.clear()
    got = _grads(save_all, tree, toks, **FLASH)
    assert len(forward_calls) == 2
    assert torch.equal(ref[0], got[0]) and all(torch.equal(x, y) for x, y in zip(ref[1], got[1]))
    for bad in ("sometimes", 2, None):
        with pytest.raises(ValueError, match="remat must be"):
            GPTLM(remat=bad)
    with pytest.raises(ValueError, match="remat must be"):
        TrainConfig(remat=save_all)  # a policy goes on the model, as in JAX


def test_selective_train_step_through_lm_trainer():
    """TrainConfig(remat="selective") reaches the trainer's model copy and
    trains to the same parameters as remat=True, bit for bit."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import copy_corpus
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    out = []
    for remat in (True, "selective"):
        tr = LMTrainer(torch_model("float32", max_len=16, **FLASH),
                       copy_corpus(num=256, half_len=8, vocab=61, n_val=32, n_test=32),
                       TrainConfig(epochs=1, batch_size=32, optimizer="adam",
                                   learning_rate=3e-3, remat=remat),
                       device="cpu", print_fn=lambda *a: None)
        res = tr.run()
        assert tr.model.remat == remat
        out.append((res, _leaves(tr.state.params)))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.cuda
def test_selective_launches_on_the_card():
    """On the card: B3 launches n times a step under "selective" and 2n
    under True, the backward kernels n times each, the gradients equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM, lm_value_and_grad
    from distributed_tensorflow_tpu_torch.ops import _build

    model = dict(vocab_size=97, max_len=128, model_dim=128, num_heads=2, num_layers=2,
                 compute_dtype=torch.bfloat16, **FLASH)
    toks = torch.from_numpy(np.random.default_rng(38).integers(0, 97, (2, 128))).cuda()
    params = GPTLM(**model).init(seed=1, device="cuda")
    out = {}
    for remat, fwd in ((True, 4), ("selective", 2)):
        _build.reset_launches()
        out[remat] = lm_value_and_grad(GPTLM(**model, remat=remat), params, toks)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["flash_fwd"] == fwd
        assert _build.LAUNCHES["flash_bwd_fused"] == 2
    for a, b in zip(_leaves(out[True][1]), _leaves(out["selective"][1])):
        assert torch.equal(a, b)
