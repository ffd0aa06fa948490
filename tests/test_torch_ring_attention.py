"""PyTorch port, sequence-parallel attention: ``ring_attention``,
``ring_flash_attention`` and ``ulysses_attention`` on gloo worlds of 2 and
4 ranks (``tests/_torch_dist.py``, one process a rank, one world for
every case) against the JAX package on the 8 virtual CPU devices of
``tests/conftest.py``: every case's values and gradients of sum(out · ct)
against JAX ``dense_attention`` on the gathered sequence (the function
JAX's own ring tests hold its ring to), and one case of each variant
against the JAX function itself under ``shard_map`` on a mesh of the same
size (the Pallas kernels of JAX's ring-flash in interpret mode). Cases:
causal, non-causal, windowed (the bounded ring: its hop count and
permutes against JAX's ppermutes), GQA and ``kv_lens``. Also the ring
collectives against JAX's, and the async strategy's ring exchange.

Rows that see no key (a window with ``kv_lens``) give 0 in the ring and
the mean of the values in dense attention (as in JAX): the cotangent is 0
there and the outputs are compared on the other rows.

Tolerances: outputs within rtol 2e-4, atol 2e-5 (the JAX ring tests'
against dense attention); gradients within rtol 1e-4, atol 2e-5 (the
port's flash backward tests'); collectives within 1e-6.
"""

from __future__ import annotations

import numpy as np
import pytest

from _torch_dist import run_world_once
from _torch_parity import mlp_numpy_params

B, L, H, HKV, D = 2, 32, 4, 2, 8
LENS = (13, 29)
# (variant, causal, window, GQA, kv_lens): the window 5 needs 2 hops at
# L_loc 8 and 16, the window 12 3 hops at L_loc 8.
CASES = (
    ("ring", True, None, False, False),
    ("ring", False, None, True, False),
    ("ring", True, 5, False, False),
    ("ring", True, 12, True, True),
    ("ring_flash", True, None, False, False),
    ("ring_flash", False, None, True, True),
    ("ring_flash", True, 5, False, False),
    ("ring_flash", True, 12, True, False),
    ("ring_flash", True, 6, True, True),
    ("ring_flash", True, None, True, True),
    ("ulysses", True, None, False, False),
    ("ulysses", True, 5, False, False),
    ("ulysses", False, None, True, False),
)


def _name(c):
    v, causal, w, gqa, lens = c
    return f"{v}-{'causal' if causal else 'full'}-w{w}-{'gqa' if gqa else 'mha'}" + \
        ("-lens" if lens else "")


def _inputs(n):
    rng = np.random.default_rng(40 + n)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"q": f(B, L, H, D), "k": f(B, L, H, D), "v": f(B, L, H, D),
            "k_gqa": f(B, L, HKV, D), "v_gqa": f(B, L, HKV, D), "ct": _ct(f(B, L, H, D)),
            "lens": np.asarray(LENS, np.int32), "coll": f(n, 5, 3),
            **mlp_numpy_params(in_dim=6, hidden=4, out=3, seed=n)}


def _live():
    """[B, L] bool: rows that see a key in every case (the smallest window
    with kv_lens is 6: row i of batch b sees none from LENS[b] + 5 on)."""
    return np.arange(L)[None, :] < np.asarray(LENS)[:, None] + 5


def _ct(ct):
    return ct * _live()[:, :, None, None]


def _cases(n):
    # Ulysses needs the axis size to divide the KV heads too.
    return [c for c in CASES if not (c[0] == "ulysses" and c[3] and HKV % n)]


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def world(request, tmp_path_factory):
    n = request.param
    inp = _inputs(n)
    cases = [dict(name=_name(c), variant=c[0], causal=c[1], window=c[2], gqa=c[3], lens=c[4])
             for c in _cases(n)]
    out = run_world_once("ring", n, tmp_path_factory, inp, {"cases": cases})
    for r in out:
        assert not r["jax_loaded"] and not r["jax_package_loaded"]
    return n, inp, [r["result"] for r in out]


def _jax_mesh(n):
    import jax

    from distributed_tensorflow_tpu.parallel import make_mesh

    return make_mesh((n,), ("seq",), devices=jax.devices()[:n])


def _qkv(inp, gqa):
    import jax.numpy as jnp

    sfx = "_gqa" if gqa else ""
    return [jnp.asarray(inp[t]) for t in ("q", "k" + sfx, "v" + sfx)]


def _kw(inp, case):
    import jax.numpy as jnp

    kw = dict(causal=case[1], window=case[2])
    if case[4]:
        kw["kv_lens"] = jnp.asarray(inp["lens"])
    return kw


def _dense(inp, case):
    """JAX dense attention on the whole sequence: the output and the
    gradients of sum(out · ct)."""
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.ops.ring_attention import dense_attention

    kw = _kw(inp, case)
    out, vjp = jax.vjp(lambda q, k, v: dense_attention(q, k, v, **kw), *_qkv(inp, case[3]))
    return [np.asarray(a) for a in (out, *vjp(jnp.asarray(inp["ct"])))]


def _gathered(res, case):
    return [np.concatenate([r[_name(case)][f] for r in res], axis=1)
            for f in ("out", "dq", "dk", "dv")]


@pytest.mark.parametrize("case", CASES, ids=[_name(c) for c in CASES])
def test_sp_attention_matches_jax(world, case):
    """Each rank's output block and its q/k/v gradient blocks, gathered in
    rank order, against JAX dense attention on the whole sequence."""
    n, inp, res = world
    if case not in _cases(n):
        assert case[0] == "ulysses" and HKV % n  # refused: n does not divide Hkv
        return
    want, got = _dense(inp, case), _gathered(res, case)
    live = _live()
    np.testing.assert_allclose(got[0][live], want[0][live], rtol=2e-4, atol=2e-5,
                               err_msg="out")
    for g, w, nm in zip(got[1:], want[1:], ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=2e-5, err_msg=nm)


# One case of each variant against the JAX function itself, each at one
# mesh size: the windowed GQA ring with kv_lens and the causal Ulysses at
# n=2, the windowed ring-flash (its offset hops) at n=4.
JAX_SP_CASES = {2: (CASES[3], CASES[10]), 4: (CASES[6],)}


def test_sp_attention_matches_jax_sp(world):
    """The gathered output against the JAX sequence-parallel function under
    shard_map on a mesh of the same size (``JAX_SP_CASES``)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from distributed_tensorflow_tpu.ops import ring_attention as jra

    n, inp, res = world
    for case in JAX_SP_CASES[n]:
        fn = {"ring": jra.ring_attention, "ring_flash": jra.ring_flash_attention,
              "ulysses": jra.ulysses_attention}[case[0]]
        kw = _kw(inp, case)
        lens = kw.pop("kv_lens", None)
        body = ((lambda q, k, v, jl: fn(q, k, v, "seq", kv_lens=jl, **kw)) if lens is not None
                else (lambda q, k, v, jl: fn(q, k, v, "seq", **kw)))
        out = jax.shard_map(body, mesh=_jax_mesh(n), in_specs=(P(None, "seq"),) * 3 + (P(),),
                            out_specs=P(None, "seq"), check_vma=case[0] != "ring_flash")(
            *_qkv(inp, case[3]), lens if lens is not None else inp["lens"])
        live = _live()
        np.testing.assert_allclose(_gathered(res, case)[0][live], np.asarray(out)[live],
                                   rtol=2e-4, atol=2e-5, err_msg=_name(case))


def test_window_bounds_ring_traffic(world):
    """The bounded ring: a window's KV blocks take window_hops − 1 permutes
    (each one send of the k/v pair), JAX's jaxpr of the same function has
    that many ppermute pairs, and the hops run are the diagonal on every
    rank and the offset hop on every rank but the first (whose past block
    wrapped round from the future: skipped)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from distributed_tensorflow_tpu.ops import ring_attention as jra
    from distributed_tensorflow_tpu_torch.ops.ring_attention import window_hops

    n, inp, res = world
    l_loc = L // n
    for w in (None, 1, 5, 12, 16, 64):
        assert window_hops(w, l_loc, n) == jra._window_hops(w, l_loc, n)
    for case in CASES:
        if case[0] == "ulysses":
            continue
        hops = window_hops(case[2], l_loc, n)
        assert all(r[_name(case)]["permutes"] == hops - 1 for r in res), _name(case)

    def count(fn):
        jaxpr = jax.make_jaxpr(jax.shard_map(
            fn, mesh=_jax_mesh(n), in_specs=(P(None, "seq"),) * 3, out_specs=P(None, "seq"),
            check_vma=False))(*(jnp.zeros((B, L, H, D), jnp.float32),) * 3)
        return str(jaxpr).count("ppermute")

    jw = count(lambda q, k, v: jra.ring_flash_attention(q, k, v, "seq", causal=True, window=5))
    assert jw == 2 * (window_hops(5, l_loc, n) - 1)  # a (k, v) pair a hop
    hops = [r[_name(("ring_flash", True, 5, False, False))]["hops"] for r in res]
    assert [h["diag"] for h in hops] == [1] * n
    assert [h["offset"] for h in hops] == [0] + [1] * (n - 1)
    assert [h["skip"] for h in hops] == [1] + [0] * (n - 1)
    full = [r[_name(("ring_flash", True, None, False, False))]["hops"] for r in res]
    assert [(h["diag"], h["full"], h["skip"]) for h in full] == [
        (1, i, n - 1 - i) for i in range(n)]


def test_ring_collectives_match_jax(world):
    """ring_all_reduce / ring_all_mean / ring_all_gather against the JAX
    ring collectives on a mesh of the same size."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from distributed_tensorflow_tpu.ops import collectives as jc

    n, inp, res = world
    x = inp["coll"]

    def jax_fn(fn):
        return np.asarray(jax.shard_map(lambda a: fn(a[0], "seq")[None], mesh=_jax_mesh(n),
                                        in_specs=P("seq"), out_specs=P("seq"))(jnp.asarray(x)))

    want = {"reduce": jax_fn(jc.ring_all_reduce), "mean": jax_fn(jc.ring_all_mean),
            "gather": jax_fn(jc.ring_all_gather)}
    for r, out in enumerate(res):
        for k in ("reduce", "mean", "gather"):
            np.testing.assert_allclose(out["coll"][k], want[k][r], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        np.testing.assert_array_equal(out["coll"]["gather"], x)
        np.testing.assert_allclose(out["coll"]["reduce"], x.sum(0), rtol=1e-6, atol=1e-6)


def test_async_ring_exchange(world):
    """AsyncDataParallel.make_exchange_fn("ring"): every copy at the mean
    of the copies, as the one all-reduce exchange gives it, the step
    kept. (Each rank adds the chunks in the order they reach it, its own
    first, so at 4 ranks the copies agree within rounding, not bit for
    bit: as JAX's ring_all_reduce.)"""
    n, inp, res = world
    for out in res:
        ex = out["exchange"]
        assert ex["step"] == 3
        for k in ("w1", "b1", "w2", "b2"):
            want = inp[k] + 0.1 * (n + 1) / 2
            np.testing.assert_allclose(ex["ring"][k], want, rtol=1e-6, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(ex["ring"][k], ex["auto"][k], rtol=1e-6, atol=1e-7)
