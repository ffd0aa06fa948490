"""PyTorch port: the paged KV cache against the JAX package — the host pool
(``serve_pool.py``), the block-table primitives (``ops/paged_attention.py``),
``extend_paged`` / ``decode_paged`` / ``verify_paged`` (the JAX XLA engine
is the oracle of the decode and verify kernels), and the pool's numpy
round trip."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import (
    jax_model,
    jax_params,
    max_err,
    numpy_params,
    torch_model,
    torch_params,
)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # of the reference's largest magnitude
S, BS = 4, 4  # slots, block size; SMALL's max_len 64 makes 16 blocks a slot
NB = 72  # pool blocks: 4 x 16 reserved plus spare


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float64)
    return max_err(got, ref) <= tol * max(1.0, float(np.abs(ref).max()))


def _scrambled_tables(seed, slots=S, width=16, nb=NB):
    """Distinct, non-contiguous block ids per slot."""
    perm = np.random.default_rng(seed).permutation(nb)[: slots * width]
    return perm.reshape(slots, width).astype(np.int32)


# -- serve_pool ----------------------------------------------------------------


def test_serve_pool_ops_match_jax_module():
    """One seeded schedule of alloc/retain/release/match/insert/evict gives
    the same block ids, refcounts and free lists in both copies."""
    from distributed_tensorflow_tpu import serve_pool as jsp
    from distributed_tensorflow_tpu_torch import serve_pool as tsp

    rng = np.random.default_rng(0)
    pools = []
    for mod in (jsp, tsp):
        alloc = mod.BlockAllocator(40)
        pools.append((alloc, mod.PrefixCache(alloc, 4)))
    prompts = [rng.integers(0, 6, int(rng.integers(1, 30))) for _ in range(12)]
    held = [[], []]
    for step in range(300):
        op = int(rng.integers(0, 5))
        pr = prompts[int(rng.integers(0, len(prompts)))]
        n = int(rng.integers(1, 6))
        want = int(rng.integers(1, 8))
        outs = []
        for k, (alloc, cache) in enumerate(pools):
            if op == 0 and alloc.can_alloc(n):
                ids = alloc.alloc(n)
                held[k].extend(ids)
                outs.append(ids)
            elif op == 1:
                ids = cache.match(pr)
                for b in ids:
                    alloc.retain(b)
                held[k].extend(ids)
                outs.append(ids)
            elif op == 2 and held[k]:
                b = held[k].pop(0)
                outs.append(alloc.release(b))
            elif op == 3 and alloc.can_alloc(len(pr) // 4):
                ids = alloc.alloc(len(pr) // 4)
                held[k].extend(ids)
                outs.append((ids, cache.insert(pr, ids, len(pr) // 4)))
            elif op == 4:
                outs.append((cache.evictable_blocks(), cache.evict(want)))
            outs.append((alloc.free_blocks, list(alloc._free),
                         [alloc.refcount(b) for b in range(40)], len(cache),
                         cache.matchable_blocks(len(pr))))
        assert outs[: len(outs) // 2] == outs[len(outs) // 2:], step
    assert jsp.blocks_for(33, 16) == tsp.blocks_for(33, 16) == 3


@pytest.mark.parametrize("max_draft,ngram", [(4, 2), (3, 1), (5, 3)])
def test_lookup_draft_matches_jax(max_draft, ngram):
    from distributed_tensorflow_tpu.serve_pool import lookup_draft as jdraft
    from distributed_tensorflow_tpu_torch.serve_pool import lookup_draft as tdraft

    rng = np.random.default_rng(max_draft * 10 + ngram)
    for _ in range(50):
        n = int(rng.integers(0, 60))
        pattern = rng.integers(0, 9, int(rng.integers(1, 9)))
        ctx = np.resize(pattern, n) if rng.random() < 0.5 else rng.integers(0, 5, n)
        assert tdraft(ctx, max_draft, ngram) == jdraft(ctx, max_draft, ngram)


# -- ops/paged_attention ---------------------------------------------------------


def test_gather_scatter_match_jax_bitwise():
    """Scatter with invalid rows dropped (pad positions, non-admitted
    slots, the sentinel's job in JAX), and the gather, bit for bit."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops import paged_attention as jpa
    from distributed_tensorflow_tpu_torch.ops import paged_attention as tpa

    rng = np.random.default_rng(1)
    n, hkv, dh, l = 2, 2, 8, 6
    pool = rng.standard_normal((n, NB, BS, hkv, dh)).astype(np.float32)
    kvs = rng.standard_normal((n, S, l, hkv, dh)).astype(np.float32)
    tables = _scrambled_tables(2)
    positions = (np.array([0, 5, 13, 40])[:, None] + np.arange(l)).astype(np.int32)
    valid = np.ones((S, l), bool)
    valid[1, 3:] = False  # pad rows
    valid[2] = False  # a slot not admitted
    want = jpa.scatter_token_kv_all_layers(
        jnp.asarray(pool), jnp.asarray(kvs), jnp.asarray(tables),
        jnp.asarray(positions), jnp.asarray(valid))
    got = torch.from_numpy(pool.copy())
    out = tpa.scatter_token_kv_all_layers(
        got, torch.from_numpy(kvs), torch.from_numpy(tables),
        torch.from_numpy(positions), torch.from_numpy(valid))
    assert out is got  # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), pool)
    # The last block of the pool is never written by a -1 wrap.
    np.testing.assert_array_equal(got.numpy()[:, -1], pool[:, -1])
    one = tpa.scatter_token_kv(got[0], torch.from_numpy(kvs[0]), torch.from_numpy(tables),
                               torch.from_numpy(positions), torch.from_numpy(valid))
    assert one.data_ptr() == got[0].data_ptr()
    view = tpa.gather_block_view(got[1], torch.from_numpy(tables))
    np.testing.assert_array_equal(
        view.numpy(), np.asarray(jpa.gather_block_view(want[1], jnp.asarray(tables))))
    with pytest.raises(IndexError):  # a valid position past the table raises
        tpa.scatter_token_kv(got[0], torch.from_numpy(kvs[0])[:, :1], torch.from_numpy(tables),
                             torch.full((S, 1), 16 * BS), torch.ones(S, 1, dtype=torch.bool))


def test_paged_extend_attention_matches_jax():
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops import paged_attention as jpa
    from distributed_tensorflow_tpu_torch.ops import paged_attention as tpa

    rng = np.random.default_rng(3)
    l, hq, hkv, dh, c = 5, 4, 2, 8, 24
    q = rng.standard_normal((S, l, hq, dh)).astype(np.float32)
    kn, vn = (rng.standard_normal((S, l, hkv, dh)).astype(np.float32) for _ in range(2))
    kv_, vv_ = (rng.standard_normal((S, c, hkv, dh)).astype(np.float32) for _ in range(2))
    plens = np.array([0, 4, 9, 19], np.int32)
    slens = np.array([5, 1, 3, 5], np.int32)
    pos = (plens[:, None] + np.arange(l)).astype(np.int32)
    args = (q, kn, vn, kv_, vv_, pos, plens, slens)
    want = jpa.paged_extend_attention(*(jnp.asarray(a) for a in args))
    got = tpa.paged_extend_attention(*(torch.from_numpy(a) for a in args))
    assert _close(got.numpy(), want, 1e-5)


# -- the model's paged surface ----------------------------------------------------

CASES = (
    ("float32", {}),
    ("bfloat16", {}),
    ("float32", {"num_kv_heads": 2, "pos_embedding": "rope"}),
)


def _pair(dtype, kw, seed):
    """JAX and port models with the same perturbed weights, and a filled
    pool (garbage that the masks must keep out) with scrambled tables."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu_torch.convert import paged_cache_from_numpy

    jm, tm = jax_model(dtype, **kw), torch_model(dtype, **kw)
    tree = numpy_params(jm, seed=seed)
    jc = jm.empty_paged_cache(S, NB, BS)
    rng = np.random.default_rng(seed)
    garbage = rng.standard_normal(jc.k.shape).astype(np.float32)
    jc = jc._replace(k=jnp.asarray(garbage, jc.k.dtype), v=jnp.asarray(-garbage, jc.v.dtype),
                     block_tables=jnp.asarray(_scrambled_tables(seed)))
    tc = paged_cache_from_numpy(jc._asdict(), device="cpu")
    assert tc.k.dtype == tm.compute_dtype
    return jm, tm, jax_params(tree), torch_params(tree), jc, tc


def _check_pool(jc, tc, tol):
    for a, b in ((jc.k, tc.k), (jc.v, tc.v)):
        assert _close(b.float().numpy(), np.asarray(a.astype("float32")), tol)


def _extend_both(jm, tm, jp, tp, jc, tc, toks, slens, plens, admit):
    import jax.numpy as jnp

    jl, jc = jm.extend_paged(jp, jc, *(jnp.asarray(a) for a in (toks, slens, plens, admit)))
    tl, tc = tm.extend_paged(tp, tc, *(torch.from_numpy(a) for a in (toks, slens, plens, admit)))
    return jl, jc, tl, tc


@pytest.mark.parametrize("dtype,kw", CASES)
def test_extend_paged_matches_jax(dtype, kw):
    """Plain ragged prefill (prefix 0), then an extend over a block-aligned
    cached prefix; one slot is not admitted the second time."""
    jm, tm, jp, tp, jc, tc = _pair(dtype, kw, seed=4)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 97, (S, 12)).astype(np.int32)
    slens = np.array([12, 8, 3, 9], np.int32)
    plens = np.zeros(S, np.int32)
    admit = np.ones(S, bool)
    jl, jc, tl, tc = _extend_both(jm, tm, jp, tp, jc, tc, toks, slens, plens, admit)
    real = np.arange(12)[None, :] < slens[:, None]
    assert _close(tl.numpy()[real], np.asarray(jl)[real], TOL[dtype])
    _check_pool(jc, tc, TOL[dtype])
    toks2 = rng.integers(0, 97, (S, 5)).astype(np.int32)
    slens2 = np.array([5, 2, 4, 1], np.int32)
    plens2 = np.array([8, 8, 0, 4], np.int32)  # block-aligned prefixes
    admit2 = np.array([True, True, True, False])
    jl, jc, tl, tc = _extend_both(jm, tm, jp, tp, jc, tc, toks2, slens2, plens2, admit2)
    real = np.arange(5)[None, :] < slens2[:, None]
    assert _close(tl.numpy()[real], np.asarray(jl)[real], TOL[dtype])
    _check_pool(jc, tc, TOL[dtype])


@pytest.mark.parametrize("engine", ["fused", "fused-layer"])
@pytest.mark.parametrize("dtype,kw", CASES)
def test_decode_paged_matches_jax_xla(dtype, kw, engine):
    import jax.numpy as jnp

    jm, tm, jp, tp, jc, tc = _pair(dtype, kw, seed=6)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 97, (S, 10)).astype(np.int32)
    slens = np.array([10, 4, 7, 1], np.int32)
    jl, jc, tl, tc = _extend_both(jm, tm, jp, tp, jc, tc, toks, slens, np.zeros(S, np.int32),
                                  np.ones(S, bool))
    jc = jc._replace(lengths=jnp.asarray(slens))
    tc = tc._replace(lengths=torch.from_numpy(slens.copy()))
    last = np.asarray(jl)[np.arange(S), slens - 1].argmax(-1).astype(np.int32)
    jt, tt = last, torch.from_numpy(last.copy())
    act = np.array([True, True, False, True])  # slot 2 rides along inactive
    for _ in range(3):
        jl, jc = jm.decode_paged(jp, jnp.asarray(jt), jc, jnp.asarray(act), engine="xla")
        tl, tc = tm.decode_paged(tp, tt, tc, torch.from_numpy(act), engine=engine)
        assert _close(tl.numpy()[act], np.asarray(jl)[act], TOL[dtype])
        jt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        if dtype == "float32":  # greedy streams equal
            np.testing.assert_array_equal(jt[act], tl.argmax(-1).numpy()[act])
        tt = torch.from_numpy(jt.copy())  # both continue from the reference stream
    np.testing.assert_array_equal(np.asarray(jc.lengths), tc.lengths.numpy())
    _check_pool(jc, tc, TOL[dtype])


@pytest.mark.parametrize("engine", ["fused", "fused-layer"])
@pytest.mark.parametrize("dtype,kw", CASES)
def test_verify_paged_matches_jax(dtype, kw, engine):
    """The verify extend at prefixes that are not block-aligned, suffix
    lengths 1..L, one inactive slot, against JAX ``verify_paged`` (which
    runs ``extend_paged`` off the TPU)."""
    import jax.numpy as jnp

    jm, tm, jp, tp, jc, tc = _pair(dtype, kw, seed=8)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 97, (S, 11)).astype(np.int32)
    plens = np.array([11, 6, 9, 3], np.int32)
    _, jc, _, tc = _extend_both(jm, tm, jp, tp, jc, tc, toks, plens, np.zeros(S, np.int32),
                                np.ones(S, bool))
    L = 4
    draft = rng.integers(0, 97, (S, L)).astype(np.int32)
    slens = np.array([1, 4, 2, 3], np.int32)
    act = np.array([True, True, True, False])
    jl, jc = jm.verify_paged(jp, jc, *(jnp.asarray(a) for a in (draft, slens, plens, act)),
                             engine="xla")
    tl, tc = tm.verify_paged(tp, tc, *(torch.from_numpy(a) for a in (draft, slens, plens, act)),
                             engine=engine)
    real = (np.arange(L)[None, :] < slens[:, None]) & act[:, None]
    assert _close(tl.numpy()[real], np.asarray(jl)[real], TOL[dtype])
    _check_pool(jc, tc, TOL[dtype])


def test_paged_plain_equals_slab_plain_bitwise():
    """The same logical cache in a slab and, through scrambled tables, in a
    pool: the paged megakernel's plain version equals the slab one bit for
    bit, outputs and committed rows."""
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    g = torch.Generator().manual_seed(0)
    n, hq, hkv, dh, d, f, c = 2, 4, 2, 8, 32, 128, 64
    w = {nm: torch.randn(n, d, d, generator=g) * d ** -0.5 for nm in ("wq", "wo")}
    w.update({nm: torch.randn(n, d, hkv * dh, generator=g) * d ** -0.5 for nm in ("wk", "wv")})
    w.update(w_up=torch.randn(n, d, f, generator=g) * d ** -0.5,
             w_down=torch.randn(n, f, d, generator=g) * f ** -0.5,
             b_up=torch.randn(n, f, generator=g) * 0.05, b_down=torch.randn(n, d, generator=g) * 0.05)
    for nm in ("ln1", "ln2"):
        w[f"{nm}_scale"] = 1 + 0.1 * torch.randn(n, d, generator=g)
        w[f"{nm}_bias"] = 0.05 * torch.randn(n, d, generator=g)
    ck = torch.randn(n, S, c, hkv, dh, generator=g).bfloat16()
    cv = torch.randn(n, S, c, hkv, dh, generator=g).bfloat16()
    tables = torch.from_numpy(_scrambled_tables(10))
    pk = torch.zeros(n, NB, BS, hkv, dh, dtype=torch.bfloat16)
    pv = torch.zeros_like(pk)
    for s in range(S):
        pk[:, tables[s].long()] = ck[:, s].reshape(n, 16, BS, hkv, dh)
        pv[:, tables[s].long()] = cv[:, s].reshape(n, 16, BS, hkv, dh)
    lengths = torch.tensor([5, 63, 20, 33])
    act = torch.tensor([True, True, False, True])
    h = torch.randn(S, d, generator=g)
    kw = dict(num_heads=hq, compute_dtype=torch.bfloat16)
    hs, _, _ = fd.decode_token_slab_plain(h, w, ck, cv, lengths, act, **kw)
    hp, _, _ = fd.decode_token_paged_plain(h, w, pk, pv, tables, lengths, act, **kw)
    assert torch.equal(hs, hp)
    for s in range(S):
        assert torch.equal(pk[:, tables[s].long()].reshape(n, c, hkv, dh), ck[:, s])
        assert torch.equal(pv[:, tables[s].long()].reshape(n, c, hkv, dh), cv[:, s])


def test_verify_plain_writes_only_real_rows_of_active_slots():
    """Every pool byte outside positions prefix..prefix+suffix-1 of the
    active slots is unchanged; a dead row (no valid key) gives 0."""
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    g = torch.Generator().manual_seed(1)
    n, hq, dh, d = 1, 2, 8, 16
    w = {nm: torch.randn(n, d, d, generator=g) * 0.2 for nm in ("wq", "wk", "wv", "wo")}
    w.update(w_up=torch.randn(n, d, 4 * d, generator=g) * 0.2,
             w_down=torch.randn(n, 4 * d, d, generator=g) * 0.1,
             b_up=torch.zeros(n, 4 * d), b_down=torch.zeros(n, d),
             ln1_scale=torch.ones(n, d), ln1_bias=torch.zeros(n, d),
             ln2_scale=torch.ones(n, d), ln2_bias=torch.zeros(n, d))
    tables = torch.from_numpy(_scrambled_tables(11))
    pk0 = torch.randn(n, NB, BS, hq, dh, generator=g)
    pk, pv = pk0.clone(), -pk0.clone()
    plens = torch.tensor([6, 0, 13, 9])
    slens = torch.tensor([3, 0, 4, 2])
    act = torch.tensor([True, True, True, False])
    h = torch.randn(S, 4, d, generator=g)
    out = fd.verify_tokens_paged(h, w, pk, pv, tables, plens, slens, act, num_heads=hq,
                                 compute_dtype=torch.float32)
    written = torch.zeros(NB, BS, dtype=torch.bool)
    for s in range(S):
        for li in range(int(slens[s])):
            if act[s]:
                p = int(plens[s]) + li
                written[tables[s, p // BS], p % BS] = True
    assert int(written.sum()) == 7
    assert torch.equal(pk[:, ~written], pk0[:, ~written])
    assert torch.equal(pv[:, ~written], -pk0[:, ~written])
    assert not torch.equal(pk[:, written], pk0[:, written])
    assert torch.isfinite(out).all()


def test_verify_short_prefix_check_refuses_wrong_suffix_masks():
    """``chip_smoke.py``'s short-prefix verify check, at small widths: the
    plain version passes against itself, and plain versions with the
    suffix's causal block strict (lj < li) or dropped fail its limits (the
    check raises if they pass)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    g = torch.Generator().manual_seed(2)
    n, s, hq, dh, mb = 2, len(cs.VERIFY_SHORT_PLENS), 2, 16, 4
    d = hq * dh
    nb = s * mb + 3

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    w = {"ln1_scale": 1 + r(n, d, scale=0.1), "ln1_bias": r(n, d, scale=0.05),
         "ln2_scale": 1 + r(n, d, scale=0.1), "ln2_bias": r(n, d, scale=0.05),
         "b_up": r(n, 4 * d, scale=0.05), "b_down": r(n, d, scale=0.05)}
    for nm, shape in (("wq", (n, d, d)), ("wk", (n, d, d)), ("wv", (n, d, d)),
                      ("wo", (n, d, d)), ("w_up", (n, d, 4 * d)), ("w_down", (n, 4 * d, d))):
        w[nm] = r(*shape, scale=shape[1] ** -0.5).bfloat16()
    tables = torch.randperm(nb, generator=g)[: s * mb].reshape(s, mb).int()
    pk = r(n, nb, cs.BLOCK, hq, dh).bfloat16()
    pv = r(n, nb, cs.BLOCK, hq, dh).bfloat16()
    active = torch.ones(s, dtype=torch.bool)
    active[-1] = False
    hv = r(s, 5, d)
    kw = dict(num_heads=hq, compute_dtype=torch.bfloat16)
    assert cs.verify_short_prefixes(hv, w, pk, pv, tables, active, kw) == 0.0


def test_paged_cache_numpy_round_trip_bitwise():
    import jax.numpy as jnp
    from distributed_tensorflow_tpu_torch.convert import (
        paged_cache_from_numpy,
        paged_cache_to_numpy,
    )

    jm = jax_model("bfloat16")
    jc = jm.empty_paged_cache(S, NB, BS)
    rng = np.random.default_rng(12)
    jc = jc._replace(k=jnp.asarray(rng.standard_normal(jc.k.shape), jnp.bfloat16),
                     v=jnp.asarray(rng.standard_normal(jc.v.shape), jnp.bfloat16),
                     block_tables=jnp.asarray(_scrambled_tables(12)),
                     lengths=jnp.asarray([3, 0, 17, 64], jnp.int32))
    tc = paged_cache_from_numpy(jc._asdict(), device="cpu")
    assert tc.k.dtype == torch.bfloat16 and tc.block_tables.dtype == torch.int32
    back = paged_cache_to_numpy(tc)
    for name in ("k", "v", "block_tables", "lengths"):
        np.testing.assert_array_equal(
            back[name], np.asarray(getattr(jc, name).astype(back[name].dtype)))
    again = paged_cache_from_numpy(back, device="cpu", dtype=torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(again[:4], tc[:4]))
    assert again.k_scale is None and tc.k_scale is None
    # An int8 pool (codes and scale pools) round-trips too.
    q = torch_model().empty_paged_cache(2, 8, 4, kv_dtype="int8", device="cpu")
    q = q._replace(k=torch.randint(-127, 128, q.k.shape, dtype=torch.int8),
                   k_scale=torch.rand(q.k_scale.shape))
    again = paged_cache_from_numpy(paged_cache_to_numpy(q), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again, q))
