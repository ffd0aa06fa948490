"""PyTorch port: the GPT training half against the JAX package — the loss
and full-model gradients (``jax.value_and_grad(model.loss)``), remat,
the optimizers against optax, the single-device train step, and a step
from a JAX Adam state carried across by ``convert``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import (
    SMALL,
    jax_model,
    jax_params,
    max_err,
    numpy_params,
    torch_model,
    torch_params,
)

FLASH = {"attention_impl": "flash", "flash_min_len": 0}
# Loss, and each gradient leaf against its largest magnitude. f32: the
# same math with sums in another order. bf16: both round the operands
# and the products' cotangents to bf16 at the same points, but an f32 sum
# in another order can land on the neighbouring bf16 value (2^-8
# relative), which then propagates through the layers.
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# Parameters after a few Adam steps at lr 3e-3 (see test_train_step_matches_jax).
ADAM_PARAM_TOL = 5e-5


def _tokens(seed, b=3, l=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, SMALL["vocab_size"], (b, l)).astype(np.int32)
    lens = np.array([l, 7, 15][:b], np.int32)
    return toks, lens


def _jax_value_and_grad(jm, tree, toks, lens):
    import jax
    import jax.numpy as jnp

    args = (jnp.asarray(toks),) + (() if lens is None else (jnp.asarray(lens),))
    loss, g = jax.value_and_grad(jm.loss)(jax_params(tree), *args)
    return float(loss), g


def _leaves(tree):
    """(name, array) of every leaf of a GPT params tree, JAX or port."""
    d = tree._asdict()
    out = [(k, d[k]) for k in ("embed", "pos", "lnf_scale", "lnf_bias")]
    out += [(f"blocks.{k}", v) for k, v in d["blocks"]._asdict().items()]
    return out


def _assert_grads_close(jg, tg, tol):
    for (name, a), (_, b) in zip(_leaves(jg), _leaves(tg)):
        a = np.asarray(a, np.float32)
        b = b.float().numpy()
        scale = max(float(np.abs(a).max()), 1e-6)
        assert max_err(a, b) <= tol * scale, f"{name}: {max_err(a, b)} vs {tol * scale}"


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "lengths"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype, impl, ragged):
    """``loss`` and the gradient of every leaf
    against ``jax.value_and_grad(model.loss)`` (the JAX flash path runs its
    Pallas kernels in interpret mode, the port's its plain versions under
    the autograd Function)."""
    from distributed_tensorflow_tpu_torch.models.gpt import lm_value_and_grad

    kw = FLASH if impl == "flash" else {}
    jm, tm = jax_model(dtype, **kw), torch_model(dtype, **kw)
    tree = numpy_params(jm, seed=3)
    toks, lens = _tokens(4)
    lens = lens if ragged else None
    jl, jg = _jax_value_and_grad(jm, tree, toks, lens)
    tt = torch.from_numpy(toks)
    tl = None if lens is None else torch.from_numpy(lens)
    tloss, tg = lm_value_and_grad(tm, torch_params(tree), tt, tl)
    assert abs(float(tloss) - jl) <= LOSS_TOL[dtype] * max(1.0, abs(jl))
    assert float(tm.loss(torch_params(tree), tt, tl)) == float(tloss)
    _assert_grads_close(jg, tg, GRAD_TOL[dtype])


def test_masked_loss_ignores_pad_tokens():
    """With ``lengths`` the loss reads no token at or past a row's length
    (causal attention keeps pads out of real positions), and equals the
    JAX ``_ce_from_logits`` on the same logits."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.models.gpt import _ce_from_logits
    from distributed_tensorflow_tpu_torch.models.gpt import ce_from_logits

    tm = torch_model("float32")
    params = torch_params(numpy_params(jax_model("float32"), seed=5))
    toks, lens = _tokens(6)
    noisy = toks.copy()
    for b, n in enumerate(lens):
        noisy[b, n:] = (noisy[b, n:] + 11) % SMALL["vocab_size"]
    tl = torch.from_numpy(lens)
    a = tm.loss(params, torch.from_numpy(toks), tl)
    b = tm.loss(params, torch.from_numpy(noisy), tl)
    assert float(a) == float(b)
    assert float(tm.loss(params, torch.from_numpy(toks))) != float(a)
    logits = np.random.default_rng(7).standard_normal((3, 24, 97)).astype(np.float32)
    ref = float(_ce_from_logits(jnp.asarray(logits), jnp.asarray(toks), jnp.asarray(lens)))
    got = float(ce_from_logits(torch.from_numpy(logits), torch.from_numpy(toks), tl))
    assert abs(got - ref) < 1e-5


@pytest.mark.parametrize("fused", [None, True, False])
def test_flash_fused_reaches_the_backward(monkeypatch, fused):
    """``GPTLM(flash_fused=)`` is the one selector of the attention
    backward: every layer's backward receives it, and the gradients do not
    depend on it (on the CPU all three run the plain backward)."""
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM, lm_value_and_grad
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    seen = []
    real = fa.flash_bwd

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    monkeypatch.setattr(fa, "flash_bwd", spy)
    params = torch_params(numpy_params(jax_model("float32"), seed=8))
    toks = torch.from_numpy(_tokens(9)[0])
    loss, grads = lm_value_and_grad(torch_model("float32", flash_fused=fused, **FLASH),
                                    params, toks)
    assert seen == [fused] * SMALL["num_layers"]
    ref_loss, ref = lm_value_and_grad(torch_model("float32", **FLASH), params, toks)
    assert torch.equal(loss, ref_loss)
    for (name, a), (_, b) in zip(_leaves(grads), _leaves(ref)):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="flash_fused"):
        GPTLM(flash_fused="split")


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_remat_gradients_equal_no_remat(impl):
    """``remat=True`` (each block under ``torch.utils.checkpoint``) gives
    the same loss and gradients, bit for bit, as ``remat=False``."""
    from distributed_tensorflow_tpu_torch.models.gpt import lm_value_and_grad

    kw = FLASH if impl == "flash" else {}
    params = torch_params(numpy_params(jax_model("float32"), seed=10))
    toks, lens = _tokens(11)
    out = [lm_value_and_grad(torch_model("float32", remat=r, **kw), params,
                             torch.from_numpy(toks), torch.from_numpy(lens))
           for r in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for (name, a), (_, b) in zip(_leaves(out[0][1]), _leaves(out[1][1])):
        assert torch.equal(a, b), name


def test_remat_policies_are_accepted():
    """"selective" and a checkpoint policy callable are accepted (they were
    refused before selective remat); anything else raises."""
    from torch.utils.checkpoint import CheckpointPolicy

    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.PREFER_RECOMPUTE

    for ok in ("selective", policy):
        assert GPTLM(remat=ok).remat is ok
    with pytest.raises(ValueError, match="remat"):
        GPTLM(remat="full")


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw"])
def test_optimizers_match_optax(name):
    """Five updates from the same parameters on the same gradients: the
    port's optimizer against optax's (``ops/optim.make`` against the JAX
    package's ``make``), leaf by leaf, state included. f32 with the same
    order of operations; the bias correction's power may differ by an ulp."""
    import jax
    import jax.numpy as jnp
    import optax
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu_torch.ops import optim

    lr = 1e-2
    tree = numpy_params(jax_model("float32"), seed=12)
    jp, tp = jax_params(tree), torch_params(tree)
    jopt, topt = joptim.make(name, lr), optim.make(name, lr)
    js, ts = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(13)
    for _ in range(5):
        gtree = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), jp)
        upd, js = jopt.update(jax.tree.map(jnp.asarray, gtree), js, jp)
        jp = optax.apply_updates(jp, upd)
        tg = torch_params({**gtree._asdict(), "blocks": gtree.blocks._asdict()})
        tp, ts = topt.update(tg, ts, tp)
    for (nm, a), (_, b) in zip(_leaves(jp), _leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7, err_msg=nm)
    if name in ("adam", "adamw"):
        assert int(ts.count) == int(js[0].count) == 5
        for (nm, a), (_, b) in zip(_leaves(js[0].nu), _leaves(ts.nu)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, err_msg=nm)


def test_optimizer_defaults_are_optax():
    from distributed_tensorflow_tpu_torch.ops import optim

    a = optim.make("adam", 1e-3)
    assert (a.b1, a.b2, a.eps, a.eps_root, a.weight_decay) == (0.9, 0.999, 1e-8, 0.0, None)
    assert optim.make("adamw", 1e-3).weight_decay == 1e-4
    assert optim.make("momentum", 1e-3).momentum == 0.9
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.make("lamb", 1e-3)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_train_step_matches_jax(impl):
    """Three steps of ``make_lm_train_step`` with Adam against the JAX
    step on the same params and batches: losses and parameters (f32)."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.models.gpt import make_lm_train_step as jstep_of
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu_torch.models.gpt import make_lm_train_step
    from distributed_tensorflow_tpu_torch.ops import optim

    kw = FLASH if impl == "flash" else {}
    jm, tm = jax_model("float32", **kw), torch_model("float32", **kw)
    tree = numpy_params(jm, seed=14)
    jp, tp = jax_params(tree), torch_params(tree)
    jopt, topt = joptim.make("adam", 3e-3), optim.make("adam", 3e-3)
    js, ts = jopt.init(jp), topt.init(tp)
    jstep, tstep = jstep_of(jm, jopt), make_lm_train_step(tm, topt)
    for i in range(3):
        toks, _ = _tokens(20 + i, b=4, l=16)
        jp, js, jl = jstep(jp, js, jnp.asarray(toks))
        tp, ts, tl = tstep(tp, ts, torch.from_numpy(toks))
        assert abs(float(tl) - float(jl)) < 1e-5
    for (nm, a), (_, b) in zip(_leaves(jp), _leaves(tp)):
        # Adam's update mu/(sqrt(nu)+eps) is O(1) whatever the gradient's
        # size, so where a gradient is tiny its f32 rounding (a large
        # relative error) moves the parameter by a small share of lr=3e-3.
        assert max_err(a, b.numpy()) < ADAM_PARAM_TOL, nm


def test_step_from_a_carried_jax_adam_state():
    """JAX trains two steps; its params and ``ScaleByAdamState`` cross to
    the port through ``convert``; step 3 on both sides agrees."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.models.gpt import make_lm_train_step as jstep_of
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu_torch.convert import (
        adam_state_from_numpy,
        adam_state_to_numpy,
        gpt_params_from_numpy,
    )
    from distributed_tensorflow_tpu_torch.models.gpt import make_lm_train_step
    from distributed_tensorflow_tpu_torch.ops import optim

    jm, tm = jax_model("float32"), torch_model("float32")
    jp = jax_params(numpy_params(jm, seed=15))
    jopt = joptim.make("adam", 3e-3)
    js = jopt.init(jp)
    jstep = jstep_of(jm, jopt)
    batches = [_tokens(30 + i, b=4, l=16)[0] for i in range(3)]
    for toks in batches[:2]:
        jp, js, _ = jstep(jp, js, jnp.asarray(toks))
    tp = gpt_params_from_numpy(jp, device="cpu")
    ts = adam_state_from_numpy(js[0], device="cpu")
    assert int(ts.count) == 2 and ts.count.dtype == torch.int32
    back = adam_state_to_numpy(ts)
    for (nm, a), (_, b) in zip(_leaves(js[0].mu), _leaves(
            adam_state_from_numpy(back, device="cpu").mu)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=nm)
    jp, js, jl = jstep(jp, js, jnp.asarray(batches[2]))
    tp, ts, tl = make_lm_train_step(tm, optim.make("adam", 3e-3))(
        tp, ts, torch.from_numpy(batches[2]))
    assert abs(float(tl) - float(jl)) < 1e-5 and int(ts.count) == 3
    for (nm, a), (_, b) in zip(_leaves(jp), _leaves(tp)):
        assert max_err(a, b.numpy()) < ADAM_PARAM_TOL, nm


def test_train_step_refuses_parallel_layouts():
    """The tensor-parallel step (``tp_axis``, and ``seq_axis``, its
    dp×tp×sp form), once refused naming ROADMAP A7b, now runs on a mesh
    (``tests/test_torch_tp.py``); without one it is refused in the JAX
    package's words. The data-parallel step (``mesh``), once refused, now
    runs: on a mesh of one rank it is the single-device step bit for bit,
    and a mesh without the axis is refused as JAX's."""
    from distributed_tensorflow_tpu_torch.models.gpt import make_lm_train_step
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves
    from distributed_tensorflow_tpu_torch.parallel.mesh import make_mesh

    tm = torch_model("float32")
    with pytest.raises(ValueError, match="tp_axis requires a mesh"):
        make_lm_train_step(tm, optim.adam(1e-3), tp_axis="model")
    with pytest.raises(ValueError, match="composes on the GSPMD tp path"):
        make_lm_train_step(tm, optim.adam(1e-3), seq_axis="seq")
    mesh = make_mesh((1,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="mesh has no 'batch' axis"):
        make_lm_train_step(tm, optim.adam(1e-3), mesh, "batch")
    opt = optim.adam(1e-3)
    params = tm.init(3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 97, (4, 16)).astype(np.int64))
    a = make_lm_train_step(tm, opt, mesh)(params, opt.init(params), toks)
    b = make_lm_train_step(tm, opt)(params, opt.init(params), toks)
    assert torch.equal(a[2], b[2])
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a[0]), tree_leaves(b[0])))
