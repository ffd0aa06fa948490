"""PyTorch port, the local-SGD / DiLoCo outer loop (``train/local_sgd.py``)
against the JAX package's (``distributed_tensorflow_tpu/train/local_sgd.py``):
the pure functions (``outer_update`` / ``outer_apply`` in their Nesterov and
heavy-ball forms, the identity corner, ``compress_delta``'s error-feedback
algebra, ``outer_round_step`` under each lever, ``sync_rounds_between``,
``params_nbytes``, ``delta_payload_nbytes``, ``staleness_weight``,
``streaming_schedule``), the one-device gang (``make_lm_diloco_vmapped``)
against JAX's with each lever, the mesh gang (``make_lm_diloco_parts``) on
the 4-rank gloo world of ``tests/_torch_local_sgd.py`` against the
one-device gang and JAX's on 4 of the 8 virtual devices, and
``LMTrainer(dp_mode="diloco")`` on both engines against JAX's; the mode
checks, the ``TrainConfig`` fields and ``DTF_*`` knobs, the refusal tables,
the numpy round trip of a ``DiLoCoState`` and the port's ``examples/lm.py``.
The sizes are the JAX tests' (vocab 61, L=16, d=32, 4 heads, 2 layers, f32).

Tolerances. The pure functions: JAX's (``tests/test_local_sgd.py``: rtol
1e-6) and bit for bit where JAX pins bitwise (the identity corner,
``outer_apply`` as ``outer_update``'s tail, the residual algebra). The
engines and trainers step by SGD (Adam's first steps are the gradient's
sign, which a last-bit difference flips where a gradient is near 0), and
after 4 steps the copies, θ, momentum, residual and in-flight state hold
JAX's own bound between its two engines (``tests/test_local_sgd.py:524``),
rtol 1e-5, atol 1e-6, against JAX and between the port's mesh and
one-device gangs. Under ``delta_dtype`` a code of the quantized delta may
land one step apart where the two sums of the mean straddle a rounding
midpoint (Δ = θ − mean cancels, so the mean's last bit is ~1e-3 of a code
at these sizes, and about one element in a thousand lands a code apart):
at most 1% of a tensor's elements (two in a small one) may pass the bound, each by at most one code, ``2·outer_lr·(1 + μ)·max|residual|``
of its tensor (the residual is at most half a code). The trainers' printed costs
within 2e-4 (four places) and perplexities within rtol 1e-4.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time

import numpy as np
import pytest
import torch

from _torch_local_sgd import DILOCO, LEVERS, MODEL, N, TRAIN_CFG, data, local_sgd_world
from _torch_parity import jax_model, jax_params, numpy_params, torch_params

SGD = ("sgd", 0.05)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return local_sgd_world(tmp_path_factory)


def leaves(tree):
    """A GPT tree's leaves in a fixed order: numpy dicts, the port's or JAX's
    NamedTuples, or a stack of them."""
    if hasattr(tree, "_asdict"):
        tree = {k: (v._asdict() if hasattr(v, "_asdict") else v)
                for k, v in tree._asdict().items()}
    arr = lambda a: a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)  # noqa
    return [arr(tree[k]) for k in sorted(k for k in tree if k != "blocks")] + \
        [arr(tree["blocks"][k]) for k in sorted(tree["blocks"])]


def close(got, want, rtol=1e-5, atol=1e-6, what="", resid=None, factor=0.0):
    """Leaf by leaf within ``atol + rtol·|want|``; with ``resid`` (the
    residual tree of a quantized delta) at most 1% of a leaf's elements
    (2 in a small leaf) may pass that, each by at most ``factor ·
    max|residual|`` of the leaf (one code of the quantized delta)."""
    rs = leaves(resid) if resid is not None else [None] * len(leaves(want))
    for i, (a, b, r) in enumerate(zip(leaves(got), leaves(want), rs)):
        if r is None:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{what} leaf {i}")
            continue
        d, tol = np.abs(a - b), atol + rtol * np.abs(b)
        far = d > tol
        assert far.sum() <= max(2, 1e-2 * far.size), f"{what} leaf {i}: {far.sum()} past"
        assert np.all(d <= tol + factor * np.abs(r).max()), f"{what} leaf {i}: {d.max()}"


def trees(seed):
    """(a numpy GPT tree, as JAX params, as the port's) from a seed."""
    t = numpy_params(jax_model(**MODEL), seed=seed)
    return t, jax_params(t), torch_params(t)


# -- the pure functions ---------------------------------------------------------------


@pytest.mark.parametrize("mu,eta,nesterov", [(0.9, 0.7, True), (0.9, 0.7, False),
                                             (0.5, 2.0, False), (0.0, 0.7, True)])
def test_outer_update_and_apply_match_jax(mu, eta, nesterov):
    """``outer_update`` (Nesterov and heavy-ball) against JAX's and numpy's
    recurrence, and ``outer_apply`` on θ − mean its tail bit for bit."""
    from distributed_tensorflow_tpu.train import local_sgd as jl
    from distributed_tensorflow_tpu_torch.train import local_sgd as tl

    (t, jt, tt), (p, jp, tp), (m, jm, tm) = trees(1), trees(2), trees(3)
    kw = dict(outer_lr=eta, outer_momentum=mu, nesterov=nesterov)
    got_t, got_m = tl.outer_update(tt, tp, tm, **kw)
    want_t, want_m = jl.outer_update(jt, jp, jm, **kw)
    close(got_t, want_t, 1e-6, 1e-7, "theta")
    close(got_m, want_m, 1e-6, 1e-7, "momentum")
    for a, b, c, gt, gm in zip(leaves(t), leaves(p), leaves(m), leaves(got_t), leaves(got_m)):
        d = a - b
        new_m = mu * c + d
        np.testing.assert_allclose(gm, new_m, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(gt, a - eta * ((d + mu * new_m) if nesterov else new_m),
                                   rtol=1e-6, atol=1e-6)
    delta = torch_params(dict(_sub(t, p)))
    tail_t, tail_m = tl.outer_apply(tt, delta, tm, **kw)
    assert all(np.array_equal(a, b) for a, b in zip(leaves(tail_t), leaves(got_t)))
    assert all(np.array_equal(a, b) for a, b in zip(leaves(tail_m), leaves(got_m)))


def _sub(a, b):
    return {k: ({n: a[k][n] - b[k][n] for n in a[k]} if k == "blocks" else a[k] - b[k])
            for k in a}


def test_outer_update_identity_corner_is_exactly_the_mean():
    """``outer_lr=1, outer_momentum=0``: θ' IS ``mean_params`` (not θ − (θ −
    mean), which reassociates), and m' records Δ = θ − mean bit for bit, as
    JAX's."""
    from distributed_tensorflow_tpu.train import local_sgd as jl
    from distributed_tensorflow_tpu_torch.train import local_sgd as tl

    (t, jt, tt), (p, jp, tp), (_, jm, tm) = trees(4), trees(5), trees(6)
    got_t, got_m = tl.outer_update(tt, tp, tm, outer_lr=1.0, outer_momentum=0.0)
    want_t, want_m = jl.outer_update(jt, jp, jm, outer_lr=1.0, outer_momentum=0.0)
    assert got_t is tp
    assert all(np.array_equal(a, b) for a, b in zip(leaves(got_t), leaves(want_t)))
    assert all(np.array_equal(a, b) for a, b in zip(leaves(got_m), leaves(want_m)))
    assert all(np.array_equal(a, b) for a, b in zip(leaves(got_m), leaves(_sub(t, p))))


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_compress_delta_error_feedback_algebra(dtype):
    """Δ̂ = Q(Δ + r) per tensor and r' = (Δ + r) − Δ̂ exactly (nothing is
    lost, only deferred), Δ̂ bit for bit ``quantize_tensor``'s round trip;
    against JAX's: int8 bit for bit, fp8 within one code (XLA's double-
    rounded midpoints, ``tests/test_torch_quantized.py``)."""
    from distributed_tensorflow_tpu.train import local_sgd as jl
    from distributed_tensorflow_tpu_torch.ops.quantized import dequantize_tensor, quantize_tensor
    from distributed_tensorflow_tpu_torch.train import local_sgd as tl

    (d, jd, td), (r, _, _) = trees(7), trees(8)
    r = {k: ({n: 0.01 * v for n, v in r[k].items()} if k == "blocks" else 0.01 * r[k])
         for k in r}
    jr, tr = jax_params(r), torch_params(r)
    dhat, new_r = tl.compress_delta(td, tr, dtype)
    for a, b, q, nr in zip(leaves(td), leaves(tr), leaves(dhat), leaves(new_r)):
        corr = torch.from_numpy(a) + torch.from_numpy(b)
        want = dequantize_tensor(*quantize_tensor(corr, dtype))
        assert torch.equal(torch.from_numpy(q), want)
        assert torch.equal(torch.from_numpy(nr), corr - want)
    jdhat, jnew_r = jl.compress_delta(jd, jr, dtype)
    if dtype == "int8":
        assert all(np.array_equal(a, b) for a, b in zip(leaves(dhat), leaves(jdhat)))
        assert all(np.array_equal(a, b) for a, b in zip(leaves(new_r), leaves(jnew_r)))
    else:
        close(dhat, jdhat, 0.0, 0.0, "fp8 dhat", resid=new_r, factor=2.0)


LEVER_CASES = {"off": (None, False), "int8": ("int8", False), "fp8": ("fp8", False),
               "overlap": (None, True), "int8-overlap": ("int8", True)}


@pytest.mark.parametrize("lever", list(LEVER_CASES))
def test_outer_round_step_matches_jax(lever):
    """``outer_round_step`` under each lever against JAX's: θ', m', the
    residual and the in-flight delta and landing (the port's ``InFlight``
    for JAX's dict); with a lever off its field stays None."""
    from distributed_tensorflow_tpu.train import local_sgd as jl
    from distributed_tensorflow_tpu_torch.train import local_sgd as tl

    dtype, overlap = LEVER_CASES[lever]
    (_, jt, tt), (_, jp, tp), (m, jm, tm) = trees(9), trees(10), trees(11)
    small = lambda tree, s: {k: ({n: s * v for n, v in tree[k].items()}  # noqa: E731
                                 if k == "blocks" else s * tree[k]) for k in tree}
    res = small(numpy_params(jax_model(**MODEL), seed=12), 1e-3) if dtype else None
    fl = (small(m, 0.1), numpy_params(jax_model(**MODEL), seed=13)) if overlap else None
    kw = dict(outer_lr=0.7, outer_momentum=0.9, delta_dtype=dtype, overlap=overlap)
    got = tl.outer_round_step(tt, tp, tm, res and torch_params(res),
                              fl and tl.InFlight(torch_params(fl[0]), torch_params(fl[1])), **kw)
    want = jl.outer_round_step(jt, jp, jm, res and jax_params(res),
                               fl and {"delta": jax_params(fl[0]), "landing": jax_params(fl[1])},
                               **kw)
    q = dict(resid=got[2], factor=2 * 0.7 * 1.9) if dtype == "fp8" else {}
    close(got[0], want[0], 1e-6, 1e-6, "theta", **q)
    close(got[1], want[1], 1e-6, 1e-6, "momentum", **q)
    assert (got[2] is None) == (want[2] is None) == (dtype is None)
    assert (got[3] is None) == (want[3] is None) == (not overlap)
    if dtype:
        close(got[2], want[2], 1e-6, 1e-6, "residual", **({} if dtype == "int8" else
                                                         dict(resid=got[2], factor=2.0)))
    if overlap:
        close(got[3].delta, want[3]["delta"], 1e-6, 1e-7, "inflight delta")
        close(got[3].landing, want[3]["landing"], 1e-6, 1e-7, "landing")


def test_counting_helpers_match_jax():
    """``sync_rounds_between``, ``resolve_outer_lr``, ``params_nbytes`` and
    ``delta_payload_nbytes`` (meta tensors as JAX's ShapeDtypeStructs),
    ``staleness_weight`` and ``streaming_schedule`` give JAX's values."""
    import jax

    from distributed_tensorflow_tpu.train import local_sgd as jl
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.train import local_sgd as tl

    for args in ((0, 8, 1), (0, 8, 4), (3, 8, 4), (4, 7, 4), (0, 550, 8), (5, 5, 3)):
        assert tl.sync_rounds_between(*args) == jl.sync_rounds_between(*args)
    with pytest.raises(ValueError, match="sync_every"):
        tl.sync_rounds_between(0, 8, 0)
    assert tl.resolve_outer_lr(None, 4) == jl.resolve_outer_lr(None, 4) == 4.0
    assert tl.resolve_outer_lr(0.7, 4) == 0.7
    jshape = jax.eval_shape(lambda: jax_model(**MODEL).init(seed=0))
    meta = GPTLM(**MODEL, compute_dtype=torch.float32).init(device="meta")
    assert tl.params_nbytes(meta) == jl.params_nbytes(jshape) == 27680 * 4
    for dt in (None, "int8", "fp8"):
        assert tl.delta_payload_nbytes(meta, dt) == jl.delta_payload_nbytes(jshape, dt)
    dense, q = tl.params_nbytes(meta), tl.delta_payload_nbytes(meta, "int8")
    assert 3.9 < dense / q <= 4.0
    with pytest.raises(ValueError, match="delta_dtype"):
        tl.delta_payload_nbytes(meta, "int4")
    for age, lim in ((0, 0), (1, 0), (1, 2), (2, 2), (3, 2), (-1, 2)):
        assert tl.staleness_weight(age, lim) == jl.staleness_weight(age, lim)
    for h, parts in ((8, None), (8, 3), (1, None), (2, 40), (16, 5)):
        plan = tl.streaming_schedule(meta, h, parts)
        assert plan == jl.streaming_schedule(jshape, h, parts)
        assert sum(p["nbytes"] for p in plan) == dense
    with pytest.raises(ValueError, match="sync_every"):
        tl.streaming_schedule(meta, 0)


# -- the one-device gang --------------------------------------------------------------


def _engine_kw(lever):
    return {**DILOCO, **LEVERS[lever]}


def _port_vmapped(lever, steps=4, opt=SGD[0], lr=SGD[1], **kw):
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.train.local_sgd import make_lm_diloco_vmapped

    tree, _, inp = data()
    model, o = GPTLM(**MODEL, compute_dtype=torch.float32), optim.make(opt, lr)
    init, mapped = make_lm_diloco_vmapped(model, o, N, **(kw or _engine_kw(lever)))
    params = torch_params(tree)
    p, d, count = init(params, o.init(params))
    out = []
    for i in range(steps):
        p, d, loss = mapped(p, d, torch.from_numpy(inp["steps"][i]), None, count)
        count += 1
        out.append((p, d, float(loss)))
    return out


def _jax_vmapped(lever, steps=4):
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu.train.local_sgd import make_lm_diloco_vmapped

    tree, _, inp = data()
    model, o = jax_model(**MODEL), joptim.make(*SGD)
    init, mapped = make_lm_diloco_vmapped(model, o, N, **_engine_kw(lever))
    p, d, count = init(jax_params(tree), o.init(jax_params(tree)))
    step = jax.jit(mapped)
    for i in range(steps):
        p, d, loss = step(p, d, jnp.asarray(inp["steps"][i]), None, count + i)
    return p, d, float(loss)


def _quant(lever, d):
    """The far-element rule's arguments under a quantized delta."""
    if LEVERS[lever].get("delta_dtype") is None:
        return {}
    kw = _engine_kw(lever)
    return dict(resid=d.residual, factor=2 * kw["outer_lr"] * (1 + kw["outer_momentum"]))


@pytest.mark.parametrize("lever", list(LEVERS))
def test_vmapped_engine_matches_jax(lever):
    """The one-device gang (4 workers, H=2, outer_lr 0.7, μ 0.9; μ 0.4 under
    overlap; SGD) over 4 steps against JAX's ``make_lm_diloco_vmapped``: the
    stacked copies, θ, momentum, the residual and the in-flight state, the
    loss; constant-rate SGD keeps no inner state."""
    p, d, loss = _port_vmapped(lever)[-1]
    jp, jd, jloss = _jax_vmapped(lever)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    q = _quant(lever, d)
    close(p, jp, what="copies", **({} if not q else dict(q, resid=_stack_like(d.residual))))
    close(d.theta, jd.theta, what="theta", **q)
    close(d.momentum, jd.momentum, what="momentum", **q)
    assert (d.residual is None) == (jd.residual is None)
    assert (d.inflight is None) == (jd.inflight is None)
    if d.residual is not None:
        close(d.residual, jd.residual, what="residual", **dict(q, factor=2.0))
    if d.inflight is not None:
        close(d.inflight.delta, jd.inflight["delta"], what="inflight delta")
        close(d.inflight.landing, jd.inflight["landing"], what="landing")
    assert d.inner == ()


def _stack_like(tree):
    from distributed_tensorflow_tpu_torch.ops.optim import tree_map

    return tree_map(lambda t: t.expand(N, *t.shape), tree)


def test_vmapped_h1_identity_equals_single_device_sgd():
    """H=1, outer_lr=1, μ=0, SGD (JAX ``tests/test_local_sgd.py:197``): the
    mean of the locally updated copies is the single-device step on the
    global batch up to the order of the sums; every copy jumped to the new
    anchor, which IS θ."""
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM, make_lm_train_step
    from distributed_tensorflow_tpu_torch.ops import optim

    tree, _, inp = data()
    p, d, loss = _port_vmapped(None, steps=1, opt="sgd", lr=0.01, sync_every=1, outer_lr=1.0,
                               outer_momentum=0.0)[0]
    params = torch_params(tree)
    o = optim.sgd(0.01)
    ref_p, _, ref_loss = make_lm_train_step(GPTLM(**MODEL, compute_dtype=torch.float32), o)(
        params, o.init(params), torch.from_numpy(inp["steps"][0]))
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-6)
    close(_row(p, 0), ref_p, 1e-5, 1e-7, "copy 0 vs single")
    for w in range(1, N):
        assert all(np.array_equal(a, b) for a, b in zip(leaves(_row(p, w)), leaves(_row(p, 0))))
    assert all(np.array_equal(a, b) for a, b in zip(leaves(_row(p, 0)), leaves(d.theta)))


def _row(p, w):
    from distributed_tensorflow_tpu_torch.ops.optim import tree_map

    return tree_map(lambda t: t[w], p)


def test_vmapped_copies_diverge_then_converge_on_round_boundary():
    """H=2 (JAX ``tests/test_local_sgd.py:227``): after a step inside a
    round the copies differ, at the boundary they rejoin the anchor; the
    anchor moved and the momentum is nonzero; with the levers off the
    state's residual and in-flight fields are None."""
    (p1, d1, _), (p2, d2, _) = _port_vmapped("off", steps=2)

    def spread(p):
        e = p.embed.numpy()
        return float(np.max(np.abs(e - e.mean(axis=0))))

    assert spread(p1) > 0 and spread(p2) == 0.0
    tree, _, _ = data()
    assert any(not np.array_equal(a, b) for a, b in zip(leaves(d2.theta), leaves(tree)))
    assert any(np.abs(x).max() > 0 for x in leaves(d2.momentum))
    assert d2.residual is None and d2.inflight is None


def test_vmapped_overlap_applies_one_round_late_with_merge():
    """H=1, μ=0, η=1, overlap (JAX ``tests/test_local_sgd.py:910``): the first
    boundary applies the zero in-flight delta (θ unchanged) and the copies
    merge toward θ, landing at their mean; the next applies the stashed
    delta: θ' = θ − Δ_0. The initial landing is a copy of θ, never the same
    tensors."""
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.train.local_sgd import make_lm_diloco_vmapped

    tree, _, inp = data()
    o = optim.sgd(0.01)
    init, mapped = make_lm_diloco_vmapped(GPTLM(**MODEL, compute_dtype=torch.float32), o, N,
                                          sync_every=1, outer_lr=1.0, outer_momentum=0.0,
                                          overlap=True)
    params = torch_params(tree)
    p, d, _ = init(params, o.init(params))
    assert all(a.data_ptr() != b.data_ptr() and torch.equal(a, b)
               for a, b in zip(leaves_t(d.theta), leaves_t(d.inflight.landing)))
    p1, d1, _ = mapped(p, d, torch.from_numpy(inp["steps"][0]), None, 0)
    assert all(np.array_equal(a, b) for a, b in zip(leaves(d1.theta), leaves(tree)))
    assert any(np.abs(x).max() > 0 for x in leaves(d1.inflight.delta))
    close(_mean(p1), d1.inflight.landing, 1e-6, 1e-7, "landing")
    _, d2, _ = mapped(p1, d1, torch.from_numpy(inp["steps"][1]), None, 1)
    want = [a - b for a, b in zip(leaves(d1.theta), leaves(d1.inflight.delta))]
    for a, b in zip(leaves(d2.theta), want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def leaves_t(tree):
    from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves

    return tree_leaves(tree)


def _mean(p):
    from distributed_tensorflow_tpu_torch.ops.optim import tree_map

    return tree_map(lambda t: t.mean(0), p)


# -- the mesh gang --------------------------------------------------------------------


@pytest.mark.parametrize("lever", list(LEVERS))
def test_mesh_engine_equals_the_one_device_engine(world, lever):
    """The two engines are one math (JAX ``tests/test_local_sgd.py:524``): each
    rank's copy of the mesh gang is the one-device gang's copy of its index
    after every step, and θ, momentum, residual and in-flight state agree;
    the initial landing is a copy of θ, never an alias."""
    ref = _port_vmapped(lever)
    for r, rank in enumerate(world[3]):
        got = rank[f"diloco_{lever}"]
        assert got["landing_is_copy"]
        for i, (p, d, _) in enumerate(ref):
            q = _quant(lever, d)
            close(got["params"][i], _row(p, r), what=f"rank {r} step {i}", **q)
        st = got["state"]
        close(st["theta"], d.theta, what="theta", **q)
        close(st["momentum"], d.momentum, what="momentum", **q)
        assert (st["residual"] is None) == (d.residual is None)
        if d.residual is not None:
            close(st["residual"], d.residual, what="residual", **dict(q, factor=2.0))
        if d.inflight is not None:
            close(st["inflight"]["delta"], d.inflight.delta, what="inflight")
            close(st["inflight"]["landing"], d.inflight.landing, what="landing")
        assert st["inner"] == {}


@pytest.mark.parametrize("lever", ["off", "overlap"])
def test_mesh_engine_matches_jax(world, lever):
    """The mesh gang against JAX's ``make_lm_diloco_parts`` on its 4-device
    mesh: every rank's copy, θ and momentum."""
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu.parallel import make_mesh
    from distributed_tensorflow_tpu.train.local_sgd import make_lm_diloco_parts

    tree, _, inp = data()
    mesh = make_mesh((N,), ("data",), devices=jax.devices()[:N])
    o = joptim.make(*SGD)
    init, mapped = make_lm_diloco_parts(jax_model(**MODEL), o, mesh, **_engine_kw(lever))
    p, d, count = init(jax_params(tree), o.init(jax_params(tree)))
    step = jax.jit(mapped)
    for i in range(4):
        p, d, _ = step(p, d, jnp.asarray(inp["steps"][i]), None, count + i)
    for r, rank in enumerate(world[3]):
        got = rank[f"diloco_{lever}"]
        close(got["params"][-1], jax.tree.map(lambda x: np.asarray(x)[r], p), what=f"rank {r}")
        close(got["state"]["theta"], d.theta, what="theta")
        close(got["state"]["momentum"], d.momentum, what="momentum")


def test_mesh_h1_identity_is_the_async_exchange_and_sync_dp(world):
    """The equality chain (JAX ``tests/test_local_sgd.py:458``, :492): at
    H=1, outer_lr=1, μ=0 the mesh gang's step IS the async exchange
    (``avg_every=1, update_scale=1``) bit for bit, copies and losses, and
    under SGD the sync dp step up to the order of the sums."""
    for rank in world[3]:
        d, a, s = rank["diloco_h1"], rank["async_sgd1"], rank["dp_sgd"]
        assert d["losses"] == a["losses"]
        for i in range(2):
            assert all(np.array_equal(x, y) for x, y in zip(leaves(d["params"][i]),
                                                            leaves(a["params"][i])))
            close(d["params"][i], s["params"][i], 1e-5, 1e-7, f"step {i} vs dp")
        assert d["reduces"] == a["reduces"]


def test_mesh_runs_one_all_reduce_a_round(world):
    """The exchange is a host ``if`` on the step count: one all-reduce of
    the parameters' flat bucket on a round's last step, none between
    (whatever the lever: the compressed delta is computed from that one
    mean)."""
    for rank in world[3]:
        for lever in LEVERS:
            calls = rank[f"diloco_{lever}"]["reduces"]
            assert [len(c) for c in calls] == [0, 1, 0, 1]
            assert calls[1] == [27680]
        assert [len(c) for c in rank["tr_diloco"]["reduces"]] == [0, 1, 0, 1]


# -- the trainers ---------------------------------------------------------------------


def _costs(lines):
    return [float(m.group(1)) for m in (re.search(r"Cost: ([0-9.]+)", x) for x in lines) if m]


def _jax_trainer(mesh=None, **cfg):
    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu.data.tokens import TokenDataset as JDS
    from distributed_tensorflow_tpu.data.tokens import TokenDatasets as JDSS
    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu.train import LMTrainer as JTrainer

    tree, _, inp = data()
    ds = JDSS(JDS(inp["train"], seed=1), JDS(inp["val"], seed=2), JDS(inp["val"], seed=3))
    lines = []
    base = {k: v for k, v in TRAIN_CFG.items() if k != "compute_dtype"}
    jtr = JTrainer(jax_model(**MODEL), ds, JConfig(**{**base, **cfg}, scan_epoch=False,
                                                   logs_path=""),
                   mesh=mesh, optimizer=joptim.make(*SGD), print_fn=lines.append)
    jtr.state = jtr._init_state(jax_params(tree))
    return jtr, jtr.run(), lines


def _port_trainer(**cfg):
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import TokenDataset, TokenDatasets
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import optim
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    tree, _, inp = data()
    ds = TokenDatasets(TokenDataset(inp["train"], seed=1), TokenDataset(inp["val"], seed=2),
                       TokenDataset(inp["val"], seed=3))
    lines = []
    tr = LMTrainer(GPTLM(**MODEL, compute_dtype=torch.float32), ds,
                   TrainConfig(**{**TRAIN_CFG, **cfg}), device="cpu", print_fn=lines.append,
                   optimizer=optim.make(*SGD))
    tr.state = tr._init_state(torch_params(tree))
    return tr, tr.run(), lines


TRAINER_LEVERS = {"off": {}, "int8-overlap": dict(delta_dtype="int8", delta_overlap=True,
                                                  outer_momentum=0.4)}


@pytest.mark.parametrize("lever", list(TRAINER_LEVERS))
def test_trainer_one_device_gang_matches_jax(lever):
    """LMTrainer(mesh=None, dp_mode="diloco", diloco_workers=4) against JAX's
    trainer: the same lines (costs to four places), the perplexity at the
    mean of the copies, the copies, θ and momentum; the canonical round
    trip merges the copies and starts a fresh outer round."""
    cfg = dict(dp_mode="diloco", diloco_workers=N, **{**DILOCO, **TRAINER_LEVERS[lever]})
    tr, got, lines = _port_trainer(**cfg)
    jtr, want, jlines = _jax_trainer(**cfg)
    assert tr.mode == "diloco" and tr.global_step == 4
    assert [x.split(":")[0] for x in lines] == [x.split(":")[0] for x in jlines]
    assert max(abs(a - b) for a, b in zip(_costs(lines), _costs(jlines))) <= 2e-4
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=1e-4)
    q = {} if lever == "off" else dict(resid=tr.state.opt_state.residual,
                                       factor=2 * cfg["outer_lr"] * (1 + cfg["outer_momentum"]))
    close(tr.state.params, jtr.state.params, what="copies",
          **({} if not q else dict(q, resid=_stack_like(tr.state.opt_state.residual))))
    close(tr.state.opt_state.theta, jtr.state.opt_state.theta, what="theta", **q)
    close(tr.state.opt_state.momentum, jtr.state.opt_state.momentum, what="momentum", **q)
    c = tr.to_canonical()
    close(c.params, _mean(tr.state.params), 0.0, 0.0, "merged")
    back = tr.from_canonical(c)
    assert all(torch.equal(a, b) for a, b in zip(leaves_t(back.opt_state.theta),
                                                 leaves_t(c.params)))
    assert all(not a.any() for a in leaves_t(back.opt_state.momentum))
    assert back.params.embed.shape == (N, 61, 32) and back.step == 4


def test_trainer_mesh_gang_matches_jax_and_the_one_device_gang(world):
    """LMTrainer(mesh=..., dp_mode="diloco") (4 ranks, H=2, outer_lr 0.7,
    μ 0.9, int8 deltas, SGD) against JAX's on its 4-device mesh and against
    the port's one-device gang: the lines, perplexity, merged parameters,
    θ, momentum, residual; a fresh outer round from the canonical state; no
    host read inside run_compiled (with overlap)."""
    import jax

    from distributed_tensorflow_tpu.parallel import make_mesh

    cfg = dict(dp_mode="diloco", delta_dtype="int8", **DILOCO)
    got = world[3][0]["tr_diloco"]
    jtr, want, jlines = _jax_trainer(make_mesh((N,), ("data",), devices=jax.devices()[:N]), **cfg)
    assert got["mode"] == "diloco"
    assert [x.split(":")[0] for x in got["lines"]] == [x.split(":")[0] for x in jlines]
    assert max(abs(a - b) for a, b in zip(_costs(got["lines"]), _costs(jlines))) <= 2e-4
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=1e-4)
    q = dict(resid=got["state"]["residual"], factor=2 * 0.7 * 1.9)
    close(got["params"], jax.tree.map(lambda x: np.asarray(x).mean(0), jtr.state.params),
          what="merged", **q)
    close(got["state"]["theta"], jtr.state.opt_state.theta, what="theta", **q)
    close(got["state"]["momentum"], jtr.state.opt_state.momentum, what="momentum", **q)
    tr, _, lines = _port_trainer(diloco_workers=N, **cfg)
    close(got["params"], tr.to_canonical().params, what="vs one device", **q)
    close(got["state"]["residual"], tr.state.opt_state.residual, what="residual",
          **dict(q, factor=2.0))
    for rank in world[3]:
        assert rank["tr_diloco"]["round_trip"]
        assert all(rank["tr_diloco"]["fresh_outer"].values())
        assert rank["tr_diloco_compiled"]["reads"] == 0
        assert rank["tr_diloco_compiled"]["mode"] == "diloco"


def test_trainer_one_device_h1_trajectory_matches_single_sgd():
    """The trainer-level degeneration (JAX ``tests/test_local_sgd.py:259``):
    one epoch at the identity outer settings under SGD equals the
    single-device trainer on the same stream, at the mean of the copies."""
    a, _, la = _sgd_trainer()
    b, _, lb = _sgd_trainer(dp_mode="diloco", diloco_workers=N, sync_every=1, outer_lr=1.0)
    close(_mean(b.state.params), a.state.params, 1e-5, 1e-6, "diloco H=1 vs single")
    assert max(abs(x - y) for x, y in zip(_costs(la), _costs(lb))) <= 1e-4


def _sgd_trainer(**cfg):
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import copy_corpus
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    lines = []
    tr = LMTrainer(GPTLM(**MODEL, compute_dtype=torch.float32),
                   copy_corpus(num=768, half_len=8, vocab=61, n_val=64, n_test=64, seed=0),
                   TrainConfig(epochs=1, batch_size=64, optimizer="sgd", learning_rate=0.01,
                               log_frequency=5, **cfg), device="cpu", print_fn=lines.append)
    return tr, tr.run(), lines


def test_trainer_one_device_run_compiled_equals_run():
    """run_compiled under the one-device gang with int8 deltas: no host read
    inside its loop, and run()'s updates bit for bit (the copies and the
    residual)."""
    from test_torch_lm_compiled import _CountHostReads

    cfg = dict(dp_mode="diloco", diloco_workers=N, delta_dtype="int8", **DILOCO)
    a, _, _ = _port_trainer(**cfg)
    tr, _, _ = _port_trainer(**cfg, epochs=0)  # built, not run
    tr.evaluate = lambda split="validation": 0.0  # the final full-split evaluate
    mode = _CountHostReads()
    with mode:
        tr.run_compiled(epochs=1)
    assert mode.reads == 0 and tr.global_step == a.global_step == 4
    for x, y in ((tr.state.params, a.state.params),
                 (tr.state.opt_state.residual, a.state.opt_state.residual)):
        assert all(torch.equal(u, v) for u, v in zip(leaves_t(x), leaves_t(y)))


# -- checks, fields, knobs and refusals ------------------------------------------------


def test_diloco_mode_validation_matches_jax():
    """The diloco mode's checks in JAX's words (``tests/test_local_sgd.py:376``,
    :1023): no mesh and no emulated gang, sync=False, a batch the gang does
    not divide, a mesh without the data axis; the fields' bounds; a lever
    without dp_mode="diloco" is refused as silently ignored."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import copy_corpus
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    model = GPTLM(**MODEL, compute_dtype=torch.float32)
    ds = copy_corpus(num=256, half_len=8, vocab=61, n_val=16, n_test=16, seed=0)

    def make(mesh=None, **kw):
        return LMTrainer(model, ds, TrainConfig(**{"batch_size": 64, **kw}), device="cpu",
                         mesh=mesh)

    with pytest.raises(ValueError, match="needs a mesh"):
        make(dp_mode="diloco")
    with pytest.raises(ValueError, match="sync=False"):
        make(dp_mode="diloco", diloco_workers=4, sync=False)
    with pytest.raises(ValueError, match="must divide"):
        make(dp_mode="diloco", diloco_workers=3)
    with pytest.raises(ValueError, match="needs a 'data' mesh axis"):
        make(Mesh({"model": 2}), dp_mode="diloco")
    assert make(Mesh({"data": 1}), dp_mode="diloco").mode == "diloco"
    for kw, msg in ((dict(sync_every=0), "sync_every"), (dict(outer_momentum=1.0), "outer_momentum"),
                    (dict(outer_lr=0.0), "outer_lr"), (dict(diloco_workers=-1), "diloco_workers"),
                    (dict(delta_dtype="int4", dp_mode="diloco"), "delta_dtype"),
                    (dict(delta_dtype="int8"), "silently ignored"),
                    (dict(delta_overlap=True), "silently ignored")):
        with pytest.raises(ValueError, match=msg):
            TrainConfig(**kw)


def test_diloco_fields_have_the_jax_defaults():
    """The six fields exist with the JAX ``TrainConfig`` defaults, and so
    does the mailbox gang's ``stale_limit`` (since the checkpoint slice),
    with every checkpoint and recovery field."""
    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu_torch.config import TrainConfig

    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    for name in ("sync_every", "outer_lr", "outer_momentum", "diloco_workers", "delta_dtype",
                 "delta_overlap"):
        assert pf[name] == jf[name], name
    for name in ("stale_limit", "checkpoint_dir", "keep_last_n", "checkpoint_retries",
                 "checkpoint_retry_backoff", "async_checkpoint", "handle_preemption",
                 "max_rollbacks", "anomaly_window", "spike_threshold", "epochs_per_dispatch"):
        assert pf[name] == jf[name], name


def test_config_from_env_diloco_knobs(monkeypatch):
    """DTF_SYNC_EVERY, DTF_OUTER_LR (empty: the worker-count default),
    DTF_OUTER_MOMENTUM and DTF_DELTA_DTYPE (empty: off) land as JAX's
    launcher lands them; a typo names the knob; a lever on a job that is not
    diloco fails; DTF_STALE_LIMIT, once refused, lands as JAX's launcher
    lands it."""
    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu.launch import config_from_env as jenv
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.launch import config_from_env

    monkeypatch.setenv("DTF_SYNC_EVERY", "8")
    monkeypatch.setenv("DTF_OUTER_LR", "0.7")
    monkeypatch.setenv("DTF_OUTER_MOMENTUM", "0.9")
    base, jbase = TrainConfig(dp_mode="diloco", diloco_workers=4), JConfig(
        dp_mode="diloco", diloco_workers=4)
    monkeypatch.setenv("DTF_DELTA_DTYPE", "int8")
    cfg, jcfg = config_from_env(base), jenv(jbase)
    for name in ("sync_every", "outer_lr", "outer_momentum", "delta_dtype"):
        assert getattr(cfg, name) == getattr(jcfg, name)
    assert (cfg.sync_every, cfg.outer_lr, cfg.delta_dtype) == (8, 0.7, "int8")
    monkeypatch.setenv("DTF_OUTER_LR", "")
    monkeypatch.setenv("DTF_DELTA_DTYPE", "")
    cfg = config_from_env(base)
    assert cfg.outer_lr is None and cfg.delta_dtype is None
    monkeypatch.setenv("DTF_SYNC_EVERY", "nope")
    with pytest.raises(ValueError, match="DTF_SYNC_EVERY"):
        config_from_env(base)
    monkeypatch.setenv("DTF_SYNC_EVERY", "2")
    monkeypatch.setenv("DTF_DELTA_DTYPE", "int4")
    with pytest.raises(ValueError, match="delta_dtype"):
        config_from_env(base)
    monkeypatch.setenv("DTF_DELTA_DTYPE", "fp8")
    with pytest.raises(ValueError, match="silently ignored"):
        config_from_env()
    monkeypatch.setenv("DTF_DELTA_DTYPE", "")
    monkeypatch.setenv("DTF_STALE_LIMIT", "3")
    assert config_from_env(base).stale_limit == jenv(jbase).stale_limit == 3
    monkeypatch.setenv("DTF_STALE_LIMIT", "soon")
    with pytest.raises(ValueError, match="DTF_STALE_LIMIT"):
        config_from_env(base)


def _refusals():
    from distributed_tensorflow_tpu_torch import config, launch
    from distributed_tensorflow_tpu_torch.train import lm_trainer, trainer

    return ([("config", k, v) for k, v in config.NOT_PORTED.items()]
            + [("env", k, v) for k, v in launch.NOT_PORTED_ENV.items()]
            + [("trainer", k, v[1]) for k, v in lm_trainer.NOT_PORTED.items()]
            + [("mlp-trainer", k, v[1]) for k, v in trainer.NOT_PORTED.items()])


@pytest.mark.parametrize("table,name,item", _refusals(),
                         ids=[f"{t}-{n}" for t, n, _ in _refusals()])
def test_refused_names_raise_naming_their_item(table, name, item, monkeypatch):
    """Each name the refusal tables still hold (``config.NOT_PORTED``,
    ``launch.NOT_PORTED_ENV``, ``lm_trainer.NOT_PORTED``,
    ``trainer.NOT_PORTED``) raises ``NotImplementedError`` naming its
    ROADMAP item, A8c now (the observability slice, A8b, and the checkpoint
    slice, A8a, took their names out of every table: ``config.NOT_PORTED``
    and both trainers' are empty); no dp_mode is refused any more."""
    from distributed_tensorflow_tpu_torch import config
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.data.tokens import copy_corpus
    from distributed_tensorflow_tpu_torch.launch import config_from_env
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer
    from distributed_tensorflow_tpu_torch.train.trainer import Trainer

    assert item == "A8c"
    assert config.DP_MODES_NOT_PORTED == {} and config.NOT_PORTED == {}
    msg = rf"\(ROADMAP {item}\)"
    if table == "config":
        with pytest.raises(NotImplementedError, match=rf"TrainConfig.{name} is not ported yet {msg}"):
            TrainConfig(**{name: 1})
    elif table == "env":
        monkeypatch.setenv(name, "1")
        with pytest.raises(NotImplementedError, match=rf"{name} is not ported yet {msg}"):
            config_from_env()
    elif table == "mlp-trainer":
        from distributed_tensorflow_tpu_torch.models.mlp import MLP

        with pytest.raises(NotImplementedError, match=rf"Trainer\({name}=\.\.\.\) .*{msg}"):
            Trainer(MLP(), object(), device="cpu", **{name: object()})
    else:
        ds = copy_corpus(num=256, half_len=8, vocab=61, n_val=16, n_test=16, seed=0)
        with pytest.raises(NotImplementedError, match=rf"LMTrainer\({name}=\.\.\.\) .*{msg}"):
            LMTrainer(GPTLM(**MODEL, compute_dtype=torch.float32), ds, TrainConfig(batch_size=64),
                      device="cpu", **{name: object()})


def test_every_jax_dp_mode_is_taken():
    """The port's TrainConfig takes every dp_mode the JAX LM trainer takes."""
    from distributed_tensorflow_tpu_torch.config import TrainConfig

    for mode in ("replicated", "zero", "tp", "ep", "pp", "sp", "diloco"):
        assert TrainConfig(dp_mode=mode).dp_mode == mode


# -- the numpy round trip and the example ---------------------------------------------


def test_diloco_state_convert_round_trip(world):
    """A JAX ``DiLoCoState`` as numpy → the port's and back, bit for bit: on
    the mesh each rank's inner state its row (gathered back), the outer
    state whole; with a lever off its field None and kept None. A JAX
    one-device gang's state after a step likewise, on one device."""
    import jax

    from distributed_tensorflow_tpu.ops import optim as joptim
    from distributed_tensorflow_tpu.train.local_sgd import make_lm_diloco_vmapped
    from distributed_tensorflow_tpu_torch.convert import (
        diloco_state_from_numpy,
        diloco_state_to_numpy,
    )

    tree, (mu, nu), inp, res = world
    for rank in res:
        for lever in ("off", "on"):
            got = rank["convert"][f"diloco_{lever}"]
            assert rank["convert"][f"diloco_{lever}_count"] == 7
            assert got["inner"]["count"].tolist() == [7] * N
            assert all(np.array_equal(a, b) for a, b in zip(leaves(got["theta"]), leaves(tree)))
            assert all(np.array_equal(a, b) for a, b in zip(leaves(got["momentum"]), leaves(mu)))
            if lever == "off":
                assert got["residual"] is None and got["inflight"] is None
            else:
                assert all(np.array_equal(a, b) for a, b in zip(leaves(got["residual"]),
                                                                leaves(nu)))
                assert all(np.array_equal(a, b) for a, b in
                           zip(leaves(got["inflight"]["landing"]), leaves(tree)))
    o = joptim.make("adam", 1e-3)
    init, mapped = make_lm_diloco_vmapped(jax_model(**MODEL), o, N, sync_every=1,
                                          delta_dtype="int8", overlap=True)
    p, d, count = init(jax_params(tree), o.init(jax_params(tree)))
    _, d, _ = jax.jit(mapped)(p, d, jax.numpy.asarray(inp["steps"][0]), None, count)
    st = diloco_state_from_numpy(d, device="cpu")
    assert st.inner.count.tolist() == [1] * N and st.inflight is not None
    back = diloco_state_to_numpy(st)
    assert back["inner"]["count"].tolist() == [1] * N
    for a, b in ((back["theta"], d.theta), (back["momentum"], d.momentum),
                 (back["residual"], d.residual), (back["inflight"]["delta"], d.inflight["delta"]),
                 (back["inflight"]["landing"], d.inflight["landing"]),
                 (back["inner"]["mu"], d.inner[0].mu)):
        assert all(np.array_equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def test_examples_lm_runs_on_the_cpu_and_refuses_a_checkpoint(monkeypatch):
    """The port's ``examples/lm.py``: one epoch of the copy task on the CPU
    prints the trainer's lines, three continuations and the copy accuracy,
    ending in Done; ``DTF_LM_CKPT``, once refused, checkpoints each epoch
    into its directory and a second run resumes from the newest step."""
    from distributed_tensorflow_tpu_torch.examples import lm

    lines = []
    out = lm.main(1, 8, "cpu", print_fn=lines.append)
    assert lines[-1] == "Done" and any(x.startswith("Test-Perplexity: ") for x in lines)
    assert any(x.startswith("beam-4 continuation:") for x in lines)
    assert out["global_step"] == (4096 - 2 * 256) // 64
    assert out["perplexity"] < 61
    import tempfile

    from distributed_tensorflow_tpu_torch.train.supervisor import checkpoint_steps

    with tempfile.TemporaryDirectory() as d:
        monkeypatch.setenv("DTF_LM_CKPT", d)
        first = lm.main(1, 2, "cpu", print_fn=lines.append)
        assert checkpoint_steps(d) == [first["global_step"]] == [out["global_step"]]
        again = lm.main(1, 2, "cpu", print_fn=lines.append)  # resumed: one more epoch
        assert again["global_step"] == 2 * first["global_step"]
        assert checkpoint_steps(d) == [first["global_step"], again["global_step"]]


@pytest.mark.cuda
def test_one_device_gang_runs_the_flash_kernels_on_the_card():
    """The one-device gang on the card with flash attention: each worker's
    inner step launches B3 a layer and B4 a layer (2 workers, 2 layers, 2
    steps: 8 of each), and its copies, θ and residual hold the same gang's
    on the CPU (the kernels' split-TF32 products against the plain
    versions' f32: within 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import _build, optim
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.optim import tree_map
    from distributed_tensorflow_tpu_torch.train.local_sgd import make_lm_diloco_vmapped

    model = GPTLM(**MODEL, compute_dtype=torch.float32, attention_impl="flash", flash_min_len=0)
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, 61, (2, 8, 16)).astype(np.int64))
    out = {}
    for dev in ("cpu", "cuda"):
        o = optim.sgd(0.05)
        init, mapped = make_lm_diloco_vmapped(model, o, 2, sync_every=2, outer_lr=0.7,
                                              outer_momentum=0.9, delta_dtype="int8")
        params = model.init(seed=3, device=dev)
        p, d, count = init(params, o.init(params))
        _build.reset_launches()
        for i in range(2):
            p, d, _ = mapped(p, d, toks[i].to(dev), None, count + i)
        out[dev] = (tree_map(lambda t: t.cpu(), p), tree_map(lambda t: t.cpu(), d.theta),
                    dict(_build.LAUNCHES))
    bwd = "flash_bwd_fused" if fa.resolve_fused(None, 4 * 4, 16, 8) else "flash_bwd_dq"
    assert out["cuda"][2]["flash_fwd"] == out["cuda"][2][bwd] == 2 * 2 * 2
    close(out["cuda"][0], out["cpu"][0], 0.0, 1e-4, "copies")
    close(out["cuda"][1], out["cpu"][1], 0.0, 1e-4, "theta")


# -- the DiLoCo mailbox gang (local_sgd.DeltaExchange; JAX tests/test_local_sgd.py:788-1465) --


def _exchange(tmp_path, rank, world=2, **kw):
    from distributed_tensorflow_tpu_torch.train.local_sgd import DeltaExchange

    kw.setdefault("stale_limit", 2)
    return DeltaExchange(str(tmp_path), rank, world, **kw)


def _jexchange(tmp_path, rank, world=2, **kw):
    from distributed_tensorflow_tpu.train.local_sgd import DeltaExchange

    kw.setdefault("stale_limit", 2)
    return DeltaExchange(str(tmp_path), rank, world, **kw)


def _gang_corpus(seed=0):
    from distributed_tensorflow_tpu_torch.data.tokens import copy_corpus

    return copy_corpus(num=768, half_len=8, vocab=61, n_val=64, n_test=64, seed=seed)


def _mailbox_member(tmp_path, rank, seed=0, journal=None, world=2, **cfg):
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    kw = dict(epochs=1, batch_size=64, log_frequency=10**9, logs_path="", optimizer="adam",
              learning_rate=3e-3, dp_mode="diloco", diloco_workers=1, sync_every=5,
              outer_lr=1.0, delta_dtype="int8", stale_limit=2)
    kw.update(cfg)
    return LMTrainer(GPTLM(**MODEL, compute_dtype=torch.float32), _gang_corpus(seed),
                     TrainConfig(**kw), device="cpu", print_fn=lambda *a: None, journal=journal,
                     delta_exchange=_exchange(tmp_path, rank, world=world,
                                              stale_limit=kw["stale_limit"],
                                              delta_dtype=kw["delta_dtype"]))


class _Journal:
    def __init__(self):
        self.events = []

    def emit(self, kind, **fields):
        self.events.append({"kind": kind, **fields})
        return {"kind": kind, **fields}

    def flush(self):
        pass


def test_np_mailbox_codec_matches_jax_quantizer():
    """The wire codec (``_np_encode_delta`` / ``_np_decode_delta``) over
    the port's quantizer equals the in-graph quantizer's dequantized values
    and the JAX package's codec: the same stored codes (fp8 as uint8), the
    same scales, the same dequantized values; None is the identity."""
    from distributed_tensorflow_tpu.train.local_sgd import _np_decode_delta as jdec
    from distributed_tensorflow_tpu.train.local_sgd import _np_encode_delta as jenc
    from distributed_tensorflow_tpu_torch.ops.quantized import dequantize_tensor, quantize_tensor
    from distributed_tensorflow_tpu_torch.train.local_sgd import (
        _np_decode_delta,
        _np_encode_delta,
    )

    x = np.random.default_rng(5).standard_normal((16, 8)).astype(np.float32)
    for dt in ("int8", "fp8"):
        want = dequantize_tensor(*quantize_tensor(torch.from_numpy(x), dt)).numpy()
        stored, scales, deq = _np_encode_delta([x], dt)
        js, jsc, jdq = jenc([x], dt)
        assert stored[0].dtype == js[0].dtype == (np.uint8 if dt == "fp8" else np.int8)
        assert np.array_equal(stored[0], js[0]) and np.array_equal(scales, jsc)
        assert np.array_equal(deq[0], want) and np.array_equal(deq[0], jdq[0])
        assert np.array_equal(_np_decode_delta(stored, scales, dt)[0], want)
        assert np.array_equal(jdec(stored, scales, dt)[0], want)
    stored, scales, deq = _np_encode_delta([x], None)
    assert scales is None and np.array_equal(deq[0], x)


def test_delta_exchange_post_gather_weights(tmp_path):
    a = _exchange(tmp_path, 0)
    b = _exchange(tmp_path, 1)
    rng = np.random.default_rng(6)
    la = [rng.standard_normal((4, 3)).astype(np.float32)]
    lb = [rng.standard_normal((4, 3)).astype(np.float32)]
    a.post(0, la)
    mean, tw, contrib = b.weighted_delta(0, lb)
    assert contrib == [(1, 0, 1.0), (0, 0, 1.0)] and tw == 2.0
    np.testing.assert_allclose(mean[0], (la[0] + lb[0]) / 2, rtol=1e-6)
    mean2, tw2, contrib2 = b.weighted_delta(1, lb)  # consumed: never applied twice
    assert contrib2 == [(1, 0, 1.0)] and tw2 == 1.0
    np.testing.assert_allclose(mean2[0], lb[0], rtol=1e-6)
    b2 = _exchange(tmp_path, 1)  # a fresh member sees it age-discounted
    mean3, tw3, contrib3 = b2.weighted_delta(2, lb)
    assert contrib3 == [(1, 0, 1.0), (0, 2, pytest.approx(1 / 3))]
    assert tw3 == pytest.approx(1 + 1 / 3)
    np.testing.assert_allclose(mean3[0], (lb[0] + la[0] / 3) / (1 + 1 / 3), rtol=1e-6)
    b3 = _exchange(tmp_path, 1)  # past the window: dropped, never a stall
    _, tw4, contrib4 = b3.weighted_delta(3, lb)
    assert contrib4 == [(1, 0, 1.0)] and tw4 == 1.0
    a.post(1, la)
    a.post(2, la)
    _, tw5, contrib5 = b.weighted_delta(2, lb)  # catch-up: each missed round once
    assert contrib5 == [(1, 0, 1.0), (0, 1, 0.5), (0, 0, 1.0)] and tw5 == pytest.approx(2.5)
    b.post(7, lb)
    _, _, contrib6 = _exchange(tmp_path, 0).weighted_delta(5, la)  # ahead: age 0
    assert (1, 0, 1.0) in contrib6


def test_delta_exchange_quantized_wire_and_gc(tmp_path):
    a = _exchange(tmp_path, 0, delta_dtype="int8")
    b = _exchange(tmp_path, 1, delta_dtype="int8")
    x = np.random.default_rng(7).standard_normal((64, 32)).astype(np.float32)
    deq = a.post(0, [x])
    got = b.gather(0)
    assert [(r, age, w) for r, age, w, _ in got] == [(0, 0, 1.0)]
    assert np.array_equal(got[0][3][0], deq[0])
    f = _exchange(tmp_path, 1)
    f.post(0, [x])
    assert a.payload_nbytes(0) < 0.5 * f.payload_nbytes(0)
    for r in range(1, 6):
        a.post(r, [x])
    rounds = a._rounds_of(0)
    assert min(rounds) >= 5 - a.stale_limit - 1 and max(rounds) == 5
    open(os.path.join(str(tmp_path), a._fname(0, 9) + ".tmp123"), "wb").close()
    assert a._rounds_of(0) == rounds


def test_delta_exchange_truncated_post_skipped_never_consumed(tmp_path):
    j = _Journal()
    a = _exchange(tmp_path, 0, stale_limit=4)
    b = _exchange(tmp_path, 1, stale_limit=4, journal=j)
    la = [np.full((4, 3), 2.0, np.float32)]
    for r in range(3):
        a.post(r, la)
    torn = os.path.join(str(tmp_path), a._fname(0, 1))
    with open(torn, "r+b") as f:
        f.truncate(os.path.getsize(torn) // 2)
    got = b.gather(2)
    assert [(r, age) for r, age, _, _ in got] == [(0, 2), (0, 0)]
    assert b.corrupt_posts == 1
    assert j.events == [{"kind": "mailbox_corrupt", "mailbox": "delta", "file": a._fname(0, 1),
                         "reason": "crc", "action": "skipped", "peer": 0, "round": 1}]
    assert b.gather(2) == [] and b._consumed == {0: 2}


def test_delta_exchange_crc_mismatch_is_corrupt(tmp_path):
    a = _exchange(tmp_path, 0, stale_limit=2)
    b = _exchange(tmp_path, 1, stale_limit=2)
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.savez(os.path.join(str(tmp_path), a._fname(0, 0)), a0=x, n=np.asarray(1, np.int64),
             crc=np.asarray(a._payload_crc([x], None) ^ 1, np.int64))
    assert b.gather(0) == []
    assert b.corrupt_posts == 1 and b._consumed == {0: 0}


def test_delta_exchange_legacy_post_without_crc_accepted(tmp_path):
    a = _exchange(tmp_path, 0, stale_limit=2)
    b = _exchange(tmp_path, 1, stale_limit=2)
    x = np.full((4, 3), 5.0, np.float32)
    np.savez(os.path.join(str(tmp_path), a._fname(0, 0)), a0=x, n=np.asarray(1, np.int64))
    got = b.gather(0)
    assert len(got) == 1 and np.array_equal(got[0][3][0], x)


def test_delta_exchange_sweeps_orphans_and_fires_its_failpoints(tmp_path):
    """Construction sweeps ``.tmp`` orphans older than the age guard (a
    fresh one stays); ``delta.post:torn`` tears a committed post, which a
    peer skips and counts; ``delta.post.commit:raise`` leaves no post."""
    from distributed_tensorflow_tpu_torch.train import failpoints

    old = os.path.join(str(tmp_path), "w0000_r0000000001.npz.tmp99")
    fresh = os.path.join(str(tmp_path), "w0000_r0000000002.npz.tmp98")
    for p in (old, fresh):
        open(p, "wb").close()
    os.utime(old, (time.time() - 3600, time.time() - 3600))
    a = _exchange(tmp_path, 0, stale_limit=4)
    assert not os.path.exists(old) and os.path.exists(fresh)
    b = _exchange(tmp_path, 1, stale_limit=4)
    x = [np.ones((8, 8), np.float32)]
    try:
        failpoints.configure("delta.post:torn@2")
        for r in range(3):
            a.post(r, x)
        failpoints.configure("delta.post.commit:raise")
        with pytest.raises(failpoints.FailpointError):
            a.post(3, x)
    finally:
        failpoints.reset()
    assert a._rounds_of(0) == [0, 1, 2]
    assert [(r, age) for r, age, _, _ in b.gather(2)] == [(0, 2), (0, 0)]
    assert b.corrupt_posts == 1


@pytest.mark.parametrize("delta_dtype", [None, "int8", "fp8"])
def test_posts_read_across_packages(tmp_path, delta_dtype):
    """A post by the port read by the JAX package's ``DeltaExchange._load``
    and the reverse: the same npz keys, the same stored codes (fp8 as
    uint8), scales and CRC envelope, the same decoded leaves."""
    rng = np.random.default_rng(9)
    leaves_ = [rng.standard_normal((6, 5)).astype(np.float32),
               rng.standard_normal(7).astype(np.float32)]
    port = _exchange(tmp_path, 0, delta_dtype=delta_dtype)
    jax_ = _jexchange(tmp_path, 1, delta_dtype=delta_dtype)
    deq_p = port.post(3, leaves_)
    deq_j = jax_.post(3, leaves_)
    for a, b in zip(deq_p, deq_j):
        assert np.array_equal(a, b)
    with np.load(os.path.join(str(tmp_path), port._fname(0, 3))) as zp, \
            np.load(os.path.join(str(tmp_path), jax_._fname(1, 3))) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zp.files:
            assert zp[k].dtype == zj[k].dtype and np.array_equal(zp[k], zj[k]), k
    for reader, rank in ((jax_, 0), (port, 1)):
        got = reader._load(rank, 3)
        assert all(np.array_equal(a, b) for a, b in zip(got, deq_p))


def test_trainer_mailbox_gang_members_share_rounds(tmp_path):
    """Two members one after the other (10 steps at H=5): member 0 alone in
    each round; member 1's first boundary takes both of member 0's posts
    (ahead of its round: age 0, each once), its second runs alone; every
    round journals a ``delta_exchange`` event with its payload and time,
    and ``mailbox_rounds_total`` counts them."""
    j = _Journal()
    w0 = _mailbox_member(tmp_path, 0, 0, journal=j)
    r0 = w0.run()
    assert np.isfinite(r0["perplexity"])
    dx0 = [e for e in j.events if e["kind"] == "delta_exchange"]
    assert [e["round"] for e in dx0] == [0, 1]
    assert all(e["contributors"] == [[0, 0, 1.0]] for e in dx0)
    assert all(e["payload_nbytes"] > 0 and e["wall_ms"] >= 0 for e in dx0)
    w1 = _mailbox_member(tmp_path, 1, 1, journal=j)
    r1 = w1.run()
    assert np.isfinite(r1["perplexity"])
    dx1 = [e for e in j.events if e["kind"] == "delta_exchange" and e["rank"] == 1]
    assert [len(e["contributors"]) for e in dx1] == [3, 1]
    assert w1.metrics.counter("mailbox_rounds_total").value == 2


def test_mixed_gang_of_a_jax_and_a_port_member(tmp_path):
    """A JAX member, then a port member, on one directory: the port member
    reads the JAX member's posts and the contributor pattern is the JAX
    gang's ([1, 1] for the first member, [3, 1] for the second)."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.config import TrainConfig as JConfig
    from distributed_tensorflow_tpu.data import copy_corpus as jcorpus
    from distributed_tensorflow_tpu.models.gpt import GPTLM as JGPT
    from distributed_tensorflow_tpu.train import LMTrainer as JLM

    jj, pj = _Journal(), _Journal()
    jt = JLM(JGPT(**MODEL, compute_dtype=jnp.float32),
             jcorpus(num=768, half_len=8, vocab=61, n_val=64, n_test=64, seed=0),
             JConfig(epochs=1, batch_size=64, log_frequency=10**9, logs_path="",
                     optimizer="adam", learning_rate=3e-3, dp_mode="diloco", diloco_workers=1,
                     sync_every=5, outer_lr=1.0, delta_dtype="int8", stale_limit=2,
                     scan_epoch=False),
             print_fn=lambda *a: None, journal=jj,
             delta_exchange=_jexchange(tmp_path, 0, stale_limit=2, delta_dtype="int8"))
    jt.run()
    _mailbox_member(tmp_path, 1, 1, journal=pj).run()
    pat = lambda j: [len(e["contributors"]) for e in j.events  # noqa: E731
                     if e["kind"] == "delta_exchange"]
    assert pat(jj) == [1, 1] and pat(pj) == [3, 1]
    second = [e for e in pj.events if e["kind"] == "delta_exchange"][0]
    assert second["contributors"] == [[1, 0, 1.0], [0, 0, 1.0], [0, 0, 1.0]]


def test_trainer_mailbox_default_outer_lr_scales_by_contributors(tmp_path):
    """``outer_lr=None`` scales by the round's total weight: a member alone
    in a world of 4 applies its delta once (η = 1)."""
    j = _Journal()
    tr = _mailbox_member(tmp_path, 0, journal=j, world=4, outer_lr=None, delta_dtype=None,
                         outer_momentum=0.0)
    theta0 = [t.clone() for t in leaves_t(tr.state.opt_state.theta)]
    tr.run()
    dx = [e for e in j.events if e["kind"] == "delta_exchange"]
    assert dx and all(e["total_weight"] == 1.0 and e["outer_lr"] == 1.0 for e in dx)
    now = leaves_t(tr.state.opt_state.theta)
    assert all(torch.isfinite(t).all() for t in now)
    assert max(float((a - b).abs().max()) for a, b in zip(now, theta0)) < 1.0


def test_trainer_mailbox_validation(tmp_path):
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    ex = _exchange(tmp_path, 0, stale_limit=2, delta_dtype="int8")
    mk = lambda cfg, e=ex: LMTrainer(  # noqa: E731
        GPTLM(**MODEL, compute_dtype=torch.float32), _gang_corpus(), cfg, device="cpu",
        print_fn=lambda *a: None, delta_exchange=e)
    base = dict(epochs=1, batch_size=64)
    with pytest.raises(ValueError, match="dp_mode='diloco'"):
        mk(TrainConfig(**base), _exchange(tmp_path / "p", 0, stale_limit=0))
    with pytest.raises(ValueError, match="stale_limit"):
        mk(TrainConfig(**base, dp_mode="diloco", diloco_workers=1, delta_dtype="int8"))
    good = TrainConfig(**base, dp_mode="diloco", diloco_workers=1, delta_dtype="int8",
                       stale_limit=2)
    with pytest.raises(ValueError, match="delta_dtype"):
        mk(good.replace(delta_dtype="fp8"))
    with pytest.raises(ValueError, match="diloco_workers=1"):
        mk(good.replace(diloco_workers=4))
    with pytest.raises(ValueError, match="delta_overlap"):
        mk(good.replace(delta_overlap=True))
    with pytest.raises(ValueError, match="epochs_per_dispatch"):
        mk(good.replace(epochs_per_dispatch=1))
    tr = mk(good, _exchange(tmp_path / "q", 0, stale_limit=2, delta_dtype="int8"))
    with pytest.raises(ValueError, match="run_compiled"):
        tr.run_compiled()
    assert tr.delta_exchange.journal is tr.journal and tr.delta_exchange.metrics is tr.metrics


def test_mailbox_member_checkpoints_one_copy_and_resumes(tmp_path):
    """A mailbox member checkpoints its one stacked copy (``replicas`` 1
    in the sidecar, JAX's meta) and a new member on the same checkpoint
    resumes it bit for bit."""
    ck = str(tmp_path / "ck")
    a = _mailbox_member(tmp_path / "box", 0, checkpoint_dir=ck)
    a.run()
    meta = a.supervisor.saved_layout(a.supervisor.latest_step())
    assert meta == {"mode": "diloco", "replicas": 1, "sync_every": 5, "delta_dtype": "int8",
                    "world": 1, "global_batch": 64}
    b = _mailbox_member(tmp_path / "box2", 0, checkpoint_dir=ck)
    assert b.start_step == a.global_step
    assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(leaves_t(a.state), leaves_t(b.state)))


def _diloco_ckpt(tmp_path, **kw):
    from distributed_tensorflow_tpu_torch.config import TrainConfig
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.train.lm_trainer import LMTrainer

    cfg = dict(epochs=1, batch_size=64, log_frequency=10**9, logs_path="", optimizer="adam",
               learning_rate=3e-3, dp_mode="diloco", diloco_workers=4, sync_every=3,
               outer_lr=1.0, outer_momentum=0.9, checkpoint_dir=str(tmp_path))
    cfg.update(kw)
    return LMTrainer(GPTLM(**MODEL, compute_dtype=torch.float32), _gang_corpus(),
                     TrainConfig(**cfg), device="cpu", print_fn=lambda *a: None)


def test_ckpt_same_world_resume_bitwise_even_under_new_sync_every(tmp_path):
    """The one-device gang saved mid-round resumes bit for bit (copies
    apart, momentum nonzero) under another ``sync_every`` (a policy key
    of the sidecar, not a shape key)."""
    a = _diloco_ckpt(tmp_path)
    a.run()
    assert a.supervisor.saved_layout(a.supervisor.latest_step()) == {
        "mode": "diloco", "replicas": 4, "sync_every": 3, "world": 1, "global_batch": 64}
    assert any(not torch.equal(x[0], x[1]) for x in leaves_t(a.state.params) if x.dim() > 1)
    assert any(float(x.abs().max()) > 0 for x in leaves_t(a.state.opt_state.momentum))
    b = _diloco_ckpt(tmp_path, sync_every=5)
    assert b.start_step == a.global_step
    assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(leaves_t(a.state), leaves_t(b.state)))


def test_ckpt_corrupt_sidecar_falls_back_then_fails_loud(tmp_path):
    """The newest step's sidecar corrupt: its manifest fails, the restore
    falls back to the step before (a warning names the skipped one); both
    corrupt: it raises rather than start over."""
    import warnings

    a = _diloco_ckpt(tmp_path, epochs=2)
    a.run()
    from distributed_tensorflow_tpu_torch.train.supervisor import checkpoint_steps

    steps = checkpoint_steps(str(tmp_path))
    assert len(steps) == 2
    with open(os.path.join(str(tmp_path), f"step_{steps[-1]}.layout.json"), "w") as f:
        f.write("{not json")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        b = _diloco_ckpt(tmp_path)
    assert b.start_step == steps[0]
    assert any(f"step_{steps[-1]}" in str(x.message) for x in w)
    with open(os.path.join(str(tmp_path), f"step_{steps[0]}.layout.json"), "w") as f:
        f.write("{not json")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="no restorable checkpoint"):
            _diloco_ckpt(tmp_path)
