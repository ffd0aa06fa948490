"""PyTorch port: single-token slot decode (plain megakernel and plain
per-layer versions) against the JAX package's XLA engine, which the JAX
package itself names as the parity oracle of its decode kernels."""

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

TOL = {"float32": 1e-4, "bfloat16": 1e-2}  # as in test_torch_gpt.py

CASES = (
    ("float32", "fused", {}),
    ("float32", "fused-layer", {}),
    ("bfloat16", "fused", {}),
    ("bfloat16", "fused-layer", {}),
    ("float32", "fused", {"num_kv_heads": 2, "pos_embedding": "rope"}),
)


@pytest.mark.parametrize("dtype,engine,kw", CASES)
def test_decode_slots_matches_jax_xla(dtype, engine, kw):
    import jax.numpy as jnp

    jm, tm = jax_model(dtype, **kw), torch_model(dtype, **kw)
    tree = numpy_params(jm, seed=6)
    jp, tp = jax_params(tree), torch_params(tree)
    rng = np.random.default_rng(7)
    s, l = 4, 16
    toks = rng.integers(0, 97, (s, l)).astype(np.int32)
    lens = np.array([5, 16, 3, 9], np.int32)
    admit = np.ones(s, bool)
    jl, jc = jm.prefill_slots(jp, jm.empty_slot_cache(s), jnp.asarray(toks),
                              jnp.asarray(lens), jnp.asarray(admit))
    tl, tc = tm.prefill_slots(tp, tm.empty_slot_cache(s, device="cpu"),
                              torch.from_numpy(toks), torch.from_numpy(lens),
                              torch.from_numpy(admit))
    act = np.array([True, True, False, True])  # row 2 rides along inactive
    jt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    tt = tl.argmax(-1).to(torch.int32)
    for _ in range(5):
        jl, jc = jm.decode_slots(jp, jnp.asarray(jt), jc, jnp.asarray(act), engine="xla")
        tl, tc = tm.decode_slots(tp, tt, tc, torch.from_numpy(act), engine=engine)
        assert max_err(np.asarray(jl)[act], tl.numpy()[act]) < TOL[dtype]
        jt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        tt = tl.argmax(-1).to(torch.int32)
        if dtype == "float32":  # greedy streams equal
            np.testing.assert_array_equal(jt[act], tt.numpy()[act])
        else:  # continue both from the reference stream
            tt = torch.from_numpy(jt)
    np.testing.assert_array_equal(np.asarray(jc.lengths), tc.lengths.numpy())
    assert max_err(np.asarray(jc.k.astype(jnp.float32)), tc.k.float().numpy()) < TOL[dtype]
    assert max_err(np.asarray(jc.v.astype(jnp.float32)), tc.v.float().numpy()) < TOL[dtype]


def test_engines_agree_and_inactive_rows_untouched():
    tm = torch_model("bfloat16")
    tp = torch_params(numpy_params(jax_model("bfloat16"), seed=8))
    s = 3
    cache = tm.empty_slot_cache(s, device="cpu")
    toks = torch.randint(0, 97, (s, 8), generator=torch.Generator().manual_seed(0))
    _, cache = tm.prefill_slots(tp, cache, toks, torch.tensor([8, 4, 6]),
                                torch.ones(s, dtype=torch.bool))
    act = torch.tensor([True, False, True])
    tok = torch.tensor([1, 2, 3])
    outs = {}
    for eng in ("fused", "fused-layer"):
        c = cache._replace(k=cache.k.clone(), v=cache.v.clone(), lengths=cache.lengths.clone())
        lg, c = tm.decode_slots(tp, tok, c, act, engine=eng)
        outs[eng] = (lg, c)
        torch.testing.assert_close(c.k[:, 1], cache.k[:, 1], rtol=0, atol=0)
        assert c.lengths.tolist() == [9, 4, 7]
    (la, ca), (lb, cb) = outs["fused"], outs["fused-layer"]
    assert torch.equal(ca.k, cb.k) and torch.equal(ca.v, cb.v)
    assert torch.equal(la[act], lb[act])


@pytest.mark.parametrize("lengths,full", [((8, 3), True), ((7, 3), False)])
def test_decode_slots_refuses_a_full_cache_as_jax_does(lengths, full):
    """An active slot at max_len: the JAX decode_slots (eager) and the
    port's both raise "KV cache full"; one position short, neither does."""
    import jax.numpy as jnp

    jm, tm = jax_model(max_len=8), torch_model(max_len=8)
    tree = numpy_params(jm, seed=5)
    jp, tp = jax_params(tree), torch_params(tree)
    jc = jm.empty_slot_cache(2)
    jc = jc._replace(lengths=jnp.asarray(lengths, jnp.int32))
    tc = tm.empty_slot_cache(2, device="cpu")
    tc = tc._replace(lengths=torch.tensor(lengths, dtype=torch.int32))
    tok = np.array([1, 2], np.int32)
    calls = (lambda: jm.decode_slots(jp, jnp.asarray(tok), jc, engine="xla"),
             lambda: tm.decode_slots(tp, torch.from_numpy(tok), tc))
    for call in calls:
        if full:
            with pytest.raises(ValueError, match="KV cache full"):
                call()
        else:
            call()
    if not full:  # an inactive row at max_len rides along
        tm.decode_slots(tp, torch.from_numpy(tok), tc._replace(
            lengths=torch.tensor([8, 3], dtype=torch.int32)), torch.tensor([False, True]))


@pytest.mark.parametrize("lengths,full", [((8, 3), True), ((7, 3), False)])
def test_decode_paged_refuses_a_full_cache(lengths, full):
    tm = torch_model(max_len=8)
    tp = torch_params(numpy_params(jax_model(max_len=8), seed=5))
    bs = 4
    nb = 2 * tm.paged_blocks_per_slot(bs)
    cache = tm.empty_paged_cache(2, nb, bs, device="cpu")
    tables = torch.arange(nb, dtype=torch.int32).reshape(2, -1)
    cache = cache._replace(block_tables=tables,
                           lengths=torch.tensor(lengths, dtype=torch.int32))
    tok = torch.tensor([1, 2], dtype=torch.int32)
    if full:
        with pytest.raises(ValueError, match="KV cache full"):
            tm.decode_paged(tp, tok, cache)
    else:
        _, out = tm.decode_paged(tp, tok, cache)
        assert out.lengths.tolist() == [8, 4]


def test_commit_slot_rows_semantics():
    from distributed_tensorflow_tpu_torch.ops.fused_decode import commit_slot_rows

    ck = torch.zeros(3, 4, 1, 2)
    cv = torch.zeros(3, 4, 1, 2)
    kq = torch.ones(3, 1, 2)
    lengths = torch.tensor([1, 2, 4])  # row 2 is at capacity
    commit_slot_rows(ck, cv, kq, 2 * kq, lengths, torch.tensor([True, False, True]))
    assert ck[0, 1].eq(1).all() and cv[0, 1].eq(2).all()
    assert ck[1].eq(0).all() and ck[2].eq(0).all()  # inactive / full: unwritten


def test_kernel_envelope_refusals():
    """What the kernels do not compute is refused before any build (the
    check every kernel wrapper runs first): a compute dtype other than bf16
    or f32, a cache dtype other than the compute dtype or int8/fp8 (an f32
    cache under bf16 compute, a bf16 cache under f32), a 1-byte cache
    without its scales; bf16 and f32 compute over their own caches and over
    1-byte caches pass. An unknown engine raises."""
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    with pytest.raises(NotImplementedError, match="bf16 or f32"):
        fd._check_kernel_dtypes(torch.float16, torch.float16, None, None)
    with pytest.raises(NotImplementedError, match="int8"):
        fd._check_kernel_dtypes(torch.bfloat16, torch.float16, None, None)
    with pytest.raises(NotImplementedError, match="int8"):
        fd._check_kernel_dtypes(torch.bfloat16, torch.float32, None, None)
    with pytest.raises(NotImplementedError, match="int8"):
        fd._check_kernel_dtypes(torch.float32, torch.bfloat16, None, None)
    with pytest.raises(ValueError, match="scale"):
        fd._check_kernel_dtypes(torch.bfloat16, torch.int8, None, None)
    with pytest.raises(ValueError, match="scale"):
        fd._check_kernel_dtypes(torch.float32, torch.float32, torch.zeros(1), torch.zeros(1))
    s = torch.zeros(1)
    fd._check_kernel_dtypes(torch.bfloat16, torch.bfloat16, None, None)
    fd._check_kernel_dtypes(torch.bfloat16, torch.int8, s, s)
    fd._check_kernel_dtypes(torch.bfloat16, torch.float8_e4m3fn, s, s)
    fd._check_kernel_dtypes(torch.float32, torch.float32, None, None)
    fd._check_kernel_dtypes(torch.float32, torch.int8, s, s)
    fd._check_kernel_dtypes(torch.float32, torch.float8_e4m3fn, s, s)
    with pytest.raises(ValueError, match="unknown decode engine"):
        torch_model()._resolve_decode_engine("pallas")


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,dh", [(2, 2, 64), (4, 2, 64), (2, 1, 128)])
def test_decode_kernels_match_plain_on_gpu(hq, hkv, dh):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode kernels have no CPU mode")
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    g = torch.Generator(device="cuda").manual_seed(0)
    n, s, c = 2, 3, 64
    d = hq * dh
    f = 4 * d

    def r(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(shape, device="cuda", generator=g) * scale).to(dt)

    w = {"ln1_scale": 1 + r(n, d, scale=0.1), "ln1_bias": r(n, d, scale=0.05),
         "ln2_scale": 1 + r(n, d, scale=0.1), "ln2_bias": r(n, d, scale=0.05),
         "b_up": r(n, f, scale=0.05), "b_down": r(n, d, scale=0.05)}
    for nm, shape in (("wq", (n, d, d)), ("wk", (n, d, hkv * dh)),
                      ("wv", (n, d, hkv * dh)), ("wo", (n, d, d)),
                      ("w_up", (n, d, f)), ("w_down", (n, f, d))):
        w[nm] = r(*shape, scale=shape[1] ** -0.5, dt=torch.bfloat16)
    ck = r(n, s, c, hkv, dh, dt=torch.bfloat16)
    cv = r(n, s, c, hkv, dh, dt=torch.bfloat16)
    lengths = torch.tensor([5, 63, 20], device="cuda")  # row 1 fills the cache
    act = torch.tensor([True, True, False], device="cuda")
    x = r(s, d)
    kw = dict(num_heads=hq, compute_dtype=torch.bfloat16)
    # bf16 intermediates may round to neighbouring values (see chip_smoke.py).
    tol = 2e-2

    o1, kf1, vf1, _, _ = fd.decode_block_slab(x, {k: t[0] for k, t in w.items()},
                                              ck[0], cv[0], lengths, **kw)
    o2, kf2, vf2, _, _ = fd.decode_block_slab_plain(x, {k: t[0] for k, t in w.items()},
                                                    ck[0], cv[0], lengths, **kw)
    assert (o1 - o2).abs().max().item() < tol * max(1.0, o2.abs().max().item())
    assert (kf1.float() - kf2.float()).abs().max().item() < 5e-2

    k1, v1 = ck.clone(), cv.clone()
    o1, _, _ = fd.decode_token_slab(x, w, k1, v1, lengths, act, **kw)
    k2, v2 = ck.clone(), cv.clone()
    o2, _, _ = fd.decode_token_slab_plain(x, w, k2, v2, lengths, act, **kw)
    assert (o1 - o2).abs().max().item() < tol * max(1.0, o2.abs().max().item())
    assert (k1.float() - k2.float()).abs().max().item() < 5e-2
    assert torch.equal(k1[:, 2], ck[:, 2])  # the inactive row is not written
    assert not torch.equal(k1[:, 0, 5], ck[:, 0, 5])  # the active one is


def _gpu_weights(g, n, hq, hkv, dh):
    d, f = hq * dh, 4 * hq * dh

    def r(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(shape, device="cuda", generator=g) * scale).to(dt)

    w = {"ln1_scale": 1 + r(n, d, scale=0.1), "ln1_bias": r(n, d, scale=0.05),
         "ln2_scale": 1 + r(n, d, scale=0.1), "ln2_bias": r(n, d, scale=0.05),
         "b_up": r(n, f, scale=0.05), "b_down": r(n, d, scale=0.05)}
    for nm, shape in (("wq", (n, d, d)), ("wk", (n, d, hkv * dh)),
                      ("wv", (n, d, hkv * dh)), ("wo", (n, d, d)),
                      ("w_up", (n, d, f)), ("w_down", (n, f, d))):
        w[nm] = r(*shape, scale=shape[1] ** -0.5, dt=torch.bfloat16)
    return w, r


def _pool_from_slab(ck, tables, nb, bs):
    """The slab cache [n, S, C, Hkv, Dh] copied into a pool through tables."""
    n, s, c, hkv, dh = ck.shape
    pool = torch.randn(n, nb, bs, hkv, dh, device=ck.device).to(ck.dtype)
    for i in range(s):
        pool[:, tables[i].long()] = ck[:, i].reshape(n, c // bs, bs, hkv, dh)
    return pool


def _writable(tables, starts, counts, active, nb, bs):
    """[NB, bs] mask of the pool rows a launch may write."""
    m = torch.zeros(nb, bs, dtype=torch.bool)
    for s in range(tables.shape[0]):
        if active[s]:
            for p in range(int(starts[s]), int(starts[s]) + int(counts[s])):
                m[int(tables[s, p // bs]), p % bs] = True
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [16, 8])
@pytest.mark.parametrize("hq,hkv,dh", [(2, 2, 64), (4, 2, 64), (2, 1, 128)])
def test_paged_kernels_match_plain_on_gpu(hq, hkv, dh, bs):
    """decode_block_paged, decode_token_paged and verify_tokens_paged
    against their plain versions on scrambled tables; the paged megakernel
    equal to the slab one bit for bit on the same logical cache; pool rows
    outside those a launch may write unchanged bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode kernels have no CPU mode")
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    g = torch.Generator(device="cuda").manual_seed(1)
    n, s, c = 2, 3, 64
    nb = 3 * (c // bs) + 5
    w, r = _gpu_weights(g, n, hq, hkv, dh)
    d = hq * dh
    tables = torch.randperm(nb, device="cuda")[: s * (c // bs)].reshape(s, c // bs).int()
    ck = r(n, s, c, hkv, dh, dt=torch.bfloat16)
    cv = r(n, s, c, hkv, dh, dt=torch.bfloat16)
    pk, pv = _pool_from_slab(ck, tables, nb, bs), _pool_from_slab(cv, tables, nb, bs)
    lengths = torch.tensor([5, 63, 20], device="cuda")
    act = torch.tensor([True, True, False], device="cuda")
    x = r(s, d)
    kw = dict(num_heads=hq, compute_dtype=torch.bfloat16)
    tol = 2e-2  # bf16 intermediates may round to neighbouring values

    def close(a, b):
        return (a.float() - b.float()).abs().max().item() <= tol * max(1.0, b.float().abs().max().item())

    w0 = {k: t[0] for k, t in w.items()}
    o1, k1, v1, _, _ = fd.decode_block_paged(x, w0, pk[0], pv[0], tables, lengths, **kw)
    o2, k2, v2, _, _ = fd.decode_block_paged_plain(x, w0, pk[0], pv[0], tables, lengths, **kw)
    assert close(o1, o2) and close(k1, k2) and close(v1, v2)
    os_ = fd.decode_block_slab(x, w0, ck[0], cv[0], lengths, **kw)[0]
    assert torch.equal(o1, os_)

    pk1, pv1 = pk.clone(), pv.clone()
    o1, _, _ = fd.decode_token_paged(x, w, pk1, pv1, tables, lengths, act, **kw)
    pk2, pv2 = pk.clone(), pv.clone()
    o2, _, _ = fd.decode_token_paged_plain(x, w, pk2, pv2, tables, lengths, act, **kw)
    assert close(o1, o2) and close(pk1, pk2) and close(pv1, pv2)
    ck1, cv1 = ck.clone(), cv.clone()
    os_, _, _ = fd.decode_token_slab(x, w, ck1, cv1, lengths, act, **kw)
    assert torch.equal(o1, os_)  # paged == slab, bit for bit
    assert torch.equal(_pool_from_slab(ck1, tables, nb, bs)[:, tables.long()], pk1[:, tables.long()])
    free = ~_writable(tables.cpu(), lengths, [1] * s, act, nb, bs).cuda()
    assert torch.equal(pk1[:, free], pk[:, free]) and torch.equal(pv1[:, free], pv[:, free])

    L = 5
    plens = torch.tensor([13, 0, 41], device="cuda")  # not block-aligned
    slens = torch.tensor([5, 3, 1], device="cuda")
    vact = torch.tensor([True, True, False], device="cuda")
    hv = r(s, L, d)
    pk1, pv1 = pk.clone(), pv.clone()
    o1 = fd.verify_tokens_paged(hv, w, pk1, pv1, tables, plens, slens, vact, **kw)
    pk2, pv2 = pk.clone(), pv.clone()
    o2 = fd.verify_tokens_paged_plain(hv, w, pk2, pv2, tables, plens, slens, vact, **kw)
    torch.cuda.synchronize()
    assert close(o1, o2) and close(pk1, pk2) and close(pv1, pv2)
    free = ~_writable(tables.cpu(), plens, slens, vact, nb, bs).cuda()
    assert torch.equal(pk1[:, free], pk[:, free]) and torch.equal(pv1[:, free], pv[:, free])
    assert not torch.equal(pk1, pk)


# -- the cooperative kernels' launch plan (CPU: no card needed) ----------------

GPT_M = dict(n_layers=8, d=512, hq=8, hkv=8, dh=64, f=2048)
# An H100's opt-in shared memory a block (cudaDevAttrMaxSharedMemoryPerBlockOptin).
H100_SMEM = 232448


def _plan(s, r, c, mb=0, nsm=132, occupancy=1, n_layers=8, d=512, hq=8, hkv=8, dh=64,
          f=2048, smem_limit=H100_SMEM, w_bytes=2, kv_bytes=2):
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    return fd.coop_plan(s, r, n_layers, d, hq, hkv, dh, f, c, mb, nsm, occupancy, smem_limit,
                        w_bytes=w_bytes, kv_bytes=kv_bytes)


def _check_plan(plan, s, r, c, mb, n_layers, d, hq, hkv, dh, f, nsm, occupancy, w_bytes=2):
    """What the kernel relies on: every product's tiles spread over the grid
    with each weight tile fetched once (rows of at most 128 bytes), its
    weight chunks whole k-steps dividing d and inside a weight slot, the
    regions of shared memory apart and large enough, the scratch of the
    phases' shapes and dtypes. ``w_bytes``: the compute dtype's element
    bytes."""
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    qw, kvw = hq * dh, hkv * dh
    assert plan.grid == nsm * occupancy and plan.occupancy == occupancy
    assert plan.rows == s * r and plan.m_tiles == -(-s * r // 16)
    assert plan.tasks == s * hkv and plan.syncs == 5 * n_layers - 1
    by = {p.name: p for p in plan.products}
    lay = plan.layout
    for name, k, n in (("qkv", d, qw + 2 * kvw), ("out", qw, d), ("up", d, f), ("down", f, d)):
        p = by[name]
        assert p.tile_cols in fd.TILE_COLS and n % p.tile_cols == 0
        assert p.tile_cols * w_bytes <= 128
        assert (p.k, p.n, p.tiles) == (k, n, n // p.tile_cols)
        if name == "qkv":  # a tile lies inside one of wq, wk, wv
            assert kvw % p.tile_cols == 0
        assert p.tiles_per_cta == -(-p.tiles // plan.grid)
        assert p.subtiles_per_cta == p.tiles_per_cta * p.tile_cols // fd.TILE <= fd.MAX_TILES
        assert p.subtiles_per_cta * plan.m_tiles <= fd.MAX_TILE_ROWS
        # The k-groups of a CTA's warps: every warp a group, every m-tile a
        # slot of each group.
        assert p.k_groups * plan.cs == fd.COOP_WARPS and plan.cs >= min(plan.m_tiles, 4)
        assert p.k_rows % 16 == 0 and d % p.k_rows == 0
        assert p.k_rows <= 256 or p.k_rows % 256 == 0  # whole TMA boxes
        assert p.chunk_bytes == p.tiles_per_cta * p.k_rows * p.tile_cols * w_bytes <= lay["wslot"]
    assert by["down"].chunks == -(-f // d) and by["qkv"].chunks == by["up"].chunks == 0
    red = max(p.subtiles_per_cta * p.k_groups * plan.m_tiles * 128 * 4 for p in plan.products)
    slot = s * r * (d + 16 // w_bytes) * w_bytes
    g_r = hq // hkv * r
    # The score tile: the whole extent (one block), or whole KB_STEP-key
    # chunks of it (and whole chunks of the K/V stream) with the blocks'
    # running sums.
    chunk = fd.COOP_THREADS * (4 if w_bytes == 4 else 8) // dh
    assert plan.kb == c or (plan.kb % fd.KB_STEP == 0 and plan.kb % chunk == 0 and plan.kb < c)
    scores = 4 * g_r * (plan.kb + r) + (4 * g_r * (2 + dh) if plan.kb < c else 0)
    ring = fd.RING * fd.COOP_THREADS * 16
    assert lay["w0"] == 0 and lay["wslot"] % 1024 == 0 and 2 <= lay["wslots"] <= fd.MAX_WSLOTS
    assert lay["ln"] >= lay["wslots"] * lay["wslot"] and lay["ln"] % 16 == 0
    assert lay["x0"] >= lay["ln"] + 8 * d and lay["x0"] % 128 == 0
    assert lay["slot"] == slot and slot % 16 == 0 and 1 <= lay["slots"] <= fd.MAX_SLOTS
    region = lay["bar"] - lay["x0"]
    assert region >= lay["slots"] * slot and region >= scores + ring
    assert lay["x0"] <= lay["red"] and lay["bar"] - lay["red"] >= red and lay["bar"] % 8 == 0
    assert plan.smem == lay["bar"] + 8 * (lay["slots"] + 2 * lay["wslots"] + 1) <= H100_SMEM
    ints = plan.ints()
    assert len(ints) == 21 and ints[1] == d and ints[4:8] == [p.k_rows for p in plan.products]
    assert ints[19:] == [plan.kb, plan.cs]
    assert ints[8:12] == [p.tile_cols for p in plan.products]
    assert {k: v[0] for k, v in plan.scratch.items()} == {
        "qkv": (s * r, qw + 2 * kvw), "att": (s * r, qw), "gelu": (s * r, f)}
    act = torch.float32 if w_bytes == 4 else torch.bfloat16
    assert [v[1] for v in plan.scratch.values()] == [torch.float32, act, act]


@pytest.mark.parametrize("s,r,c,mb",
                         [(8, 1, 1024, 0), (8, 1, 1024, 64), (8, 5, 1024, 64), (8, 8, 1024, 64)])
def test_coop_plan_at_gpt_m(s, r, c, mb):
    """gpt-m (8 layers, d 512, 8 x 64, F 2048), 8 slots: the decode step
    slab and paged, the verify at L = 5 and 8, on 132 SMs."""
    plan = _plan(s, r, c, mb)
    _check_plan(plan, s, r, c, mb, nsm=132, occupancy=1, **GPT_M)
    assert plan.grid == 132 and plan.syncs == 39
    # q/k/v and up in tiles of 16 columns (one a CTA, 96 and 128 CTAs), the
    # output and down projections in tiles of 8 (64 CTAs): the busiest CTA
    # takes 16 columns, as with tiles of 8 over every CTA, in half the
    # copies.
    assert [p.tile_cols for p in plan.products] == [16, 8, 16, 8]
    assert [p.tiles_per_cta for p in plan.products] == [1, 1, 1, 1]
    assert [p.tiles for p in plan.products] == [96, 64, 128, 64]
    # One weight chunk a product's x chunk: a layer is 7 chunks, and the
    # decode step's ring of 9 holds more than a layer.
    assert [p.k_rows for p in plan.products] == [512] * 4
    assert plan.layout["wslots"] == {1: 9, 5: 6, 8: 5}[r]
    # B6 stages gelu(up)'s 4 chunks of d columns at once; the verify's
    # 40 and 64 rows leave room for 3 and 2 slots.
    assert plan.layout["slots"] == {1: 4, 5: 3, 8: 2}[r]


@pytest.mark.parametrize("s,c,mb", [(8, 1024, 0), (8, 1024, 64), (8, 256, 16), (1, 768, 0)])
@pytest.mark.parametrize("width", ["gpt-m", "gpt-xl"])
def test_coop_plan_of_the_per_layer_step(s, c, mb, width):
    """The per-layer step (B5) is the cooperative kernel over one layer: at
    gpt-m its plan is the megakernel's (the same chunks, so the same sums),
    and at gpt-xl width (d 2048, 16 x 128, F 8192) a CTA's tiles of a
    layer (~760 KB) stream through a ring of chunks in shared memory."""
    dims = GPT_M if width == "gpt-m" else dict(d=2048, hq=16, hkv=16, dh=128, f=8192)
    dims = {**dims, "n_layers": 1}
    plan = _plan(s, 1, c, mb, **dims)
    _check_plan(plan, s, 1, c, mb, nsm=132, occupancy=1, **dims)
    assert plan.grid == 132 and plan.syncs == 4 and plan.tasks == s * dims["hkv"]
    per_cta = sum(p.tiles_per_cta * p.tile_cols * 2 * p.k for p in plan.products)
    if width == "gpt-m":
        mega = _plan(s, 1, c, mb)
        assert (plan.layout, plan.smem, plan.products) == (mega.layout, mega.smem, mega.products)
    else:
        # up in one tile of 64 columns a CTA (128-byte rows), q/k/v in three
        # of 16, the output and down projections in one of 16.
        assert [p.tile_cols for p in plan.products] == [16, 16, 64, 16]
        assert [p.tiles_per_cta for p in plan.products] == [3, 1, 1, 1]
        assert per_cta > 3 * H100_SMEM
        assert all(p.k_rows < p.k for p in plan.products)  # several chunks each
        assert plan.layout["wslots"] >= 4


@pytest.mark.parametrize("s,want", [(1, 1), (8, 8), (16, 16), (17, 16), (32, 16), (100, 16)])
@pytest.mark.parametrize("mb", [0, 64])
def test_block_group_at_gpt_xl_width(s, want, mb):
    """The per-layer step serves any slot count: at gpt-xl width (d 2048,
    16 x 128, F 8192) the up projection fills a CTA's tiles x m-tiles at
    one m-tile, so a launch takes at most 16 slots, and the wrapper runs
    the rest in further launches; each group's plan is one coop_plan
    takes."""
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    xl = dict(d=2048, hq=16, hkv=16, dh=128, f=8192)
    got = fd.slot_group(s, 1, *xl.values(), 1024, mb, 132, H100_SMEM)
    assert got == want
    with pytest.raises(ValueError, match="tiles x m-tiles"):
        _plan(17, 1, 1024, mb, n_layers=1, **xl)
    for g in {got, s % got or got}:
        _check_plan(_plan(g, 1, 1024, mb, n_layers=1, **xl), g, 1, 1024, mb, n_layers=1,
                    nsm=132, occupancy=1, **xl)


@pytest.mark.parametrize("s,want", [(8, 8), (64, 64), (100, 64)])
def test_block_group_at_gpt_m_and_d1024(s, want):
    """gpt-m takes the cooperative kernel's 64 rows a launch; d = 1024
    (8 x 128, F 4096) at most 32 slots; d = 512 in 16 heads of 32 (head
    dim 32 is taken) has gpt-m's products, so gpt-m's groups."""
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    assert fd.slot_group(s, 1, 512, 8, 8, 64, 2048, 1024, 0, 132, H100_SMEM) == want
    assert fd.slot_group(s, 1, 1024, 8, 8, 128, 4096, 1024, 0, 132, H100_SMEM) == min(want, 32)
    assert fd.slot_group(s, 1, 512, 16, 16, 32, 2048, 1024, 0, 132, H100_SMEM) == want


@pytest.mark.parametrize("s,r,c,mb,hq,hkv,dh,nsm,occ", [
    (3, 1, 64, 0, 4, 2, 64, 132, 1),    # GQA, 3 rows (not a multiple of 8)
    (3, 1, 64, 8, 2, 1, 128, 132, 1),   # head_dim 128, paged
    (3, 1, 64, 8, 2, 2, 64, 66, 2),     # a verify of one row, 2 CTAs a SM
    (3, 8, 64, 8, 4, 1, 64, 132, 1),    # a verify of 8 rows, GQA 4:1
    (5, 3, 128, 16, 2, 2, 128, 114, 1),  # 15 rows, another card's SM count
])
def test_coop_plan_small_shapes(s, r, c, mb, hq, hkv, dh, nsm, occ):
    d = hq * dh
    dims = dict(n_layers=2, d=d, hq=hq, hkv=hkv, dh=dh, f=4 * d)
    plan = _plan(s, r, c, mb, nsm=nsm, occupancy=occ, **dims)
    _check_plan(plan, s, r, c, mb, nsm=nsm, occupancy=occ, **dims)
    assert plan.syncs == 9 and plan.tasks == s * hkv


@pytest.mark.parametrize("kw,reason", [
    (dict(dh=256, hq=2), r"head_dim 4, 8, 16, 32, 64 or 128 \(got 256\)"),
    (dict(s=1, r=65), r"1 to 64 rows in all, slots x rows a slot \(got 1 x 65\)"),
    (dict(s=9, r=8), "1 to 64 rows in all"),
    (dict(d=640), r"model_dim \(640\) = heads x head_dim"),
    (dict(s=8, r=5, d=2048, hq=16, hkv=16, dh=128, f=8192), "over 3 m-tiles"),
    (dict(f=2040), "ffn width a multiple of 16"),
    (dict(hq=8, hkv=3), "a multiple of the KV heads"),
    (dict(nsm=20), "column tiles a CTA on a grid of 20"),
    (dict(s=1, r=64, hkv=1), "bytes of shared memory a CTA"),
    (dict(s=8, r=1, smem_limit=65536), r"\(at most 65536\)"),
    (dict(c=1000, mb=64), "whole blocks"),
    (dict(n_layers=0), "at least one layer"),
])
def test_coop_plan_refuses_with_the_reason(kw, reason):
    """Shapes outside the cooperative kernels' envelope raise ValueError
    naming what they need (the card is never asked)."""
    args = dict(s=8, r=1, c=1024, mb=0, nsm=132, occupancy=1, **GPT_M)
    args.update(kw)
    with pytest.raises(ValueError, match=reason):
        _plan(**args)


def _coop_case(g, n, s, c, hq, hkv, dh):
    """Seeded inputs on the card: weights, a slab cache, residual rows."""
    w, r = _gpu_weights(g, n, hq, hkv, dh)
    ck = r(n, s, c, hkv, dh, dt=torch.bfloat16)
    cv = r(n, s, c, hkv, dh, dt=torch.bfloat16)
    return w, r, ck, cv


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,dh,L", [(4, 2, 64, 5), (2, 1, 128, 5), (2, 2, 64, 1),
                                         (2, 2, 64, 8)])
def test_coop_kernels_match_plain_on_gpu(hq, hkv, dh, L):
    """The cooperative decode step (slab, paged) and verify against their
    plain versions: GQA, head_dim 128, cache lengths 0, 1 and C - 1 and an
    inactive slot, verify rows L = 1 and 8, a suffix shorter than L and a
    prefix of 0; two launches bitwise equal, paged equal to slab bitwise,
    no pool row outside the writable ones changed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode kernels have no CPU mode")
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    g = torch.Generator(device="cuda").manual_seed(7)
    n, s, c, bs = 2, 4, 64, 8
    d = hq * dh
    nb = s * (c // bs) + 3
    w, r, ck, cv = _coop_case(g, n, s, c, hq, hkv, dh)
    tables = torch.randperm(nb, device="cuda")[: s * (c // bs)].reshape(s, c // bs).int()
    pk, pv = _pool_from_slab(ck, tables, nb, bs), _pool_from_slab(cv, tables, nb, bs)
    lengths = torch.tensor([0, 1, c - 1, 20], device="cuda")
    act = torch.tensor([True, True, True, False], device="cuda")
    x = r(s, d)
    kw = dict(num_heads=hq, compute_dtype=torch.bfloat16)

    def close(a, b, tol=2e-2):
        return (a.float() - b.float()).abs().max().item() <= tol * max(
            1.0, b.float().abs().max().item())

    def twice(fn, *caches):
        """Two launches on copies of the same caches: equal bit for bit."""
        runs = []
        for _ in range(2):
            cs = [t.clone() for t in caches]
            runs.append((fn(*cs), *cs))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        return runs[0]

    o1, k1, v1 = twice(lambda k, v: fd.decode_token_slab(x, w, k, v, lengths, act, **kw)[0],
                       ck, cv)
    k2, v2 = ck.clone(), cv.clone()
    o2 = fd.decode_token_slab_plain(x, w, k2, v2, lengths, act, **kw)[0]
    assert close(o1, o2) and close(k1, k2, 5e-2) and close(v1, v2, 5e-2)
    assert torch.equal(k1[:, 3], ck[:, 3])  # the inactive slot is not written

    op, pk1, pv1 = twice(lambda k, v: fd.decode_token_paged(
        x, w, k, v, tables, lengths, act, **kw)[0], pk, pv)
    assert torch.equal(op, o1)  # paged == slab, bit for bit
    used = tables.long()
    assert torch.equal(pk1[:, used], _pool_from_slab(k1, tables, nb, bs)[:, used])
    free = ~_writable(tables.cpu(), lengths, [1] * s, act, nb, bs).cuda()
    assert torch.equal(pk1[:, free], pk[:, free]) and torch.equal(pv1[:, free], pv[:, free])

    plens = torch.tensor([0, 13, c - L - 1, 5], device="cuda")
    slens = torch.tensor([L, max(1, L - 2), 1, L], device="cuda")  # suffixes short of L
    vact = torch.tensor([True, True, True, False], device="cuda")
    hv = r(s, L, d)
    ov, pk3, pv3 = twice(lambda k, v: fd.verify_tokens_paged(
        hv, w, k, v, tables, plens, slens, vact, **kw), pk, pv)
    pk4, pv4 = pk.clone(), pv.clone()
    ref = fd.verify_tokens_paged_plain(hv, w, pk4, pv4, tables, plens, slens, vact, **kw)
    assert close(ov, ref) and close(pk3, pk4, 5e-2) and close(pv3, pv4, 5e-2)
    free = ~_writable(tables.cpu(), plens, slens, vact, nb, bs).cuda()
    assert torch.equal(pk3[:, free], pk[:, free]) and torch.equal(pv3[:, free], pv[:, free])


@pytest.mark.cuda
def test_coop_constants_match_the_library_on_gpu():
    """The plan's mirrors of the kernel's constants are the library's (of
    each compute dtype, whose element bytes the library reports), and the
    card's opt-in shared memory is what the plan is held to."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode kernels have no CPU mode")
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    for cd, nbytes in ((torch.bfloat16, 2), (torch.float32, 4)):
        got = fd.coop_constants("cuda", cd)
        assert {k: v for k, v in got.items() if k != "smem_limit"} == dict(
            COOP_THREADS=fd.COOP_THREADS, TILE=fd.TILE, MAX_TILES=fd.MAX_TILES,
            PV_ROWS=fd.PV_ROWS, MAX_SLOTS=fd.MAX_SLOTS, RING=fd.RING, MAX_GRID=fd.MAX_GRID,
            MAX_TILE_ROWS=fd.MAX_TILE_ROWS, MAX_WSLOTS=fd.MAX_WSLOTS, w_bytes=nbytes)
    if "H100" in torch.cuda.get_device_name(0):
        assert got["smem_limit"] == H100_SMEM
    plan = fd.launch_plan("verify_tokens_paged", 8, 5, 8, 512, 8, 8, 64, 2048, 1024, 64, "cuda")
    assert plan.smem <= got["smem_limit"]


@pytest.mark.cuda
def test_coop_kernel_replays_from_a_cuda_graph_on_gpu():
    """The grid barrier keeps its epochs on the device: a decode step
    captured in a CUDA graph and replayed three times gives the eager
    launch's result bit for bit each time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode kernels have no CPU mode")
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    g = torch.Generator(device="cuda").manual_seed(11)
    n, s, c, hq, hkv, dh = 2, 4, 64, 4, 2, 64
    w, r, ck, cv = _coop_case(g, n, s, c, hq, hkv, dh)
    lengths = torch.tensor([0, 1, c - 1, 20], device="cuda", dtype=torch.int32)
    act = torch.tensor([1, 1, 1, 0], device="cuda", dtype=torch.int32)
    x = r(s, hq * dh)
    kw = dict(num_heads=hq, compute_dtype=torch.bfloat16)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # the stream's flags exist before the capture
        want = fd.decode_token_slab(x, w, ck.clone(), cv.clone(), lengths, act, **kw)[0]
        k, v = ck.clone(), cv.clone()
        fd.decode_token_slab(x, w, k, v, lengths, act, **kw)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = fd.decode_token_slab(x, w, k, v, lengths, act, **kw)[0]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [8, 32])
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_block_kernel_at_gpt_xl_width_on_gpu(paged, s):
    """B5 at gpt-xl width (d 2048, 16 heads of 128, F 8192), which the
    weight stream serves although a layer's tiles a CTA exceed shared
    memory: within the decode tolerance of its plain version, at 8 slots
    (one launch) and at 32 (two launches of 16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode kernels have no CPU mode")
    from distributed_tensorflow_tpu_torch.ops import _build, fused_decode as fd

    g = torch.Generator(device="cuda").manual_seed(21)
    c, hq, dh, bs = 128, 16, 128, 16
    w, r = _gpu_weights(g, 1, hq, hq, dh)
    w0 = {k: t[0] for k, t in w.items()}
    ck = r(1, s, c, hq, dh, dt=torch.bfloat16)
    cv = r(1, s, c, hq, dh, dt=torch.bfloat16)
    lengths = torch.randint(0, c, (s,), device="cuda", generator=g)
    x = r(s, hq * dh)
    kw = dict(num_heads=hq, compute_dtype=torch.bfloat16)
    _build.reset_launches()
    if paged:
        nb = s * (c // bs) + 3
        tables = torch.randperm(nb, device="cuda")[: s * (c // bs)].reshape(s, c // bs).int()
        pk, pv = _pool_from_slab(ck, tables, nb, bs)[0], _pool_from_slab(cv, tables, nb, bs)[0]
        got = fd.decode_block_paged(x, w0, pk, pv, tables, lengths, **kw)
        ref = fd.decode_block_paged_plain(x, w0, pk, pv, tables, lengths, **kw)
    else:
        got = fd.decode_block_slab(x, w0, ck[0], cv[0], lengths, **kw)
        ref = fd.decode_block_slab_plain(x, w0, ck[0], cv[0], lengths, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[f"decode_block_{'paged' if paged else 'slab'}"] == -(-s // 16)
    for a, b in zip(got[:3], ref[:3]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert (a.float() - b.float()).abs().max().item() <= 2e-2 * max(
            1.0, b.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_block_kernel_layer_by_layer_equals_megakernel_on_gpu(paged):
    """One step through B5 layer by layer, each layer's fresh rows
    committed by the caller, equals one B6 launch bit for bit: h_out and
    every committed row (the sums' order depends only on the rows and K)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode kernels have no CPU mode")
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    g = torch.Generator(device="cuda").manual_seed(23)
    n, s, c, hq, hkv, dh, bs = 3, 4, 64, 4, 2, 64, 8
    w, r, ck, cv = _coop_case(g, n, s, c, hq, hkv, dh)
    lengths = torch.tensor([0, 1, c - 1, 20], device="cuda")
    act = torch.tensor([True, True, True, False], device="cuda")
    x = r(s, hq * dh)
    kw = dict(num_heads=hq, compute_dtype=torch.bfloat16)
    if paged:
        nb = s * (c // bs) + 3
        tables = torch.randperm(nb, device="cuda")[: s * (c // bs)].reshape(s, c // bs).int()
        ck, cv = _pool_from_slab(ck, tables, nb, bs), _pool_from_slab(cv, tables, nb, bs)
    k1, v1 = ck.clone(), cv.clone()
    if paged:
        want = fd.decode_token_paged(x, w, k1, v1, tables, lengths, act, **kw)[0]
    else:
        want = fd.decode_token_slab(x, w, k1, v1, lengths, act, **kw)[0]
    k2, v2, h = ck.clone(), cv.clone(), x
    for i in range(n):
        wi = {k: t[i] for k, t in w.items()}
        if paged:
            h, kq, vq, _, _ = fd.decode_block_paged(h, wi, k2[i], v2[i], tables, lengths,
                                                    **kw)
            fd.commit_paged_rows(k2[i], v2[i], kq, vq, tables, lengths, act)
        else:
            h, kq, vq, _, _ = fd.decode_block_slab(h, wi, k2[i], v2[i], lengths, **kw)
            fd.commit_slot_rows(k2[i], v2[i], kq, vq, lengths, act)
    torch.cuda.synchronize()
    assert torch.equal(h, want) and torch.equal(k2, k1) and torch.equal(v2, v1)
