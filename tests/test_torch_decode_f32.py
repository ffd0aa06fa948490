"""PyTorch port: f32 compute on the cooperative decode kernels (B5, B6, B7)
and their f32 cache, and head dims 8 and 16 on them.

On the CPU the port's plain f32 decode goes against the JAX package's XLA
engine (``decode_engine="xla"``, the oracle its own decode tests name):
slab and pool, the verify; f32, int8 and fp8 caches; RoPE and the window;
at the JAX engine's test model (``tiny()`` of tests/test_pallas_decode.py:
d=32, 4 heads of 8, RoPE), at d=64 over 4 heads (head dim 16) and at
decode-full's width (d=256, 8 heads of 32) at 2 layers; and TextServer's
greedy streams against the JAX server's. The planner's answer at an H100's
figures (132 SMs, 232,448 bytes of shared memory a block) is pinned for the
f32 models, and a head dim the kernels are not built for is refused with
the reason. On a GPU each new instantiation against its plain version, and
the bitwise invariants in f32: B5 layer by layer with the commits equals B6,
a paged launch equals the slab one, a grouped launch equals the one launch.

Tolerances: f32 logits within 1e-4 of JAX's and greedy streams bit for bit
(the JAX f32 engines pin theirs bitwise, tests/test_pallas_decode.py:9-12),
the f32 caches within 1e-5; int8/fp8 caches as test_torch_kv_quant.py (logits
within 2e-2 and 6e-2, codes within one step). On the card the f32 kernels
within 1e-4 of the largest magnitude of their plain versions (split-TF32
products: ~1e-6 a product), within test_torch_kv_quant.py's TOL over 1-byte
caches; bf16 at head dims 8 and 16 within 2e-2 (test_torch_decode.py's).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from _torch_parity import jax_model, jax_params, max_err, numpy_params, torch_model, torch_params
from test_torch_decode import H100_SMEM, _check_plan, _plan
from test_torch_kv_quant import _check_cache

TOL = {"bf16": 1e-4, "int8": 2e-2, "fp8": 6e-2}  # f32 models, by cache
# The JAX engine's test model (tests/test_pallas_decode.py:39-47 tiny()), the
# head-dim-16 model, and decode-full's width at 2 of its 4 layers
# (tools/lm_bench.py:133-136) with the parity tests' vocabulary.
MODELS = {
    "tiny": dict(model_dim=32, num_heads=4, pos_embedding="rope"),
    "dh16": dict(model_dim=64, num_heads=4),
    "full2": dict(model_dim=256, num_heads=8, max_len=1024),
}


# -- the planner at the H100's figures ------------------------------------------

def _gpt(**kw):
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    cfg = dict(vocab_size=8192, max_len=1024, model_dim=256, num_heads=8, num_layers=4,
               compute_dtype=torch.float32)
    return GPTLM(**{**cfg, **kw})


# (model knobs, slots, rows a slot, block size or None, cache, reason or
# None): decode-full in f32 on the slab, the pool and its verify at
# spec_draft=4, over f32 and 1-byte caches; gpt-m-L1024 in f32 at 8 slots;
# tiny() and d=64 over 4 heads; then what stays refused.
REASON_CASES = (
    (dict(), 8, 1, None, "bf16", None),
    (dict(), 8, 1, 16, "bf16", None),
    (dict(), 8, 5, 16, "bf16", None),
    (dict(), 8, 1, None, "int8", None),
    (dict(), 8, 5, 16, "fp8", None),
    (dict(window=256), 8, 1, None, "bf16", None),
    (dict(num_kv_heads=2), 8, 5, 16, "bf16", None),
    (dict(model_dim=512, num_layers=8), 8, 1, None, "bf16", None),
    (dict(model_dim=512, num_layers=8), 8, 5, 16, "bf16", None),
    (dict(vocab_size=97, max_len=64, model_dim=32, num_heads=4, num_layers=2,
          pos_embedding="rope"), 8, 1, None, "bf16", None),
    (dict(vocab_size=97, max_len=64, model_dim=32, num_heads=4, num_layers=2,
          pos_embedding="rope"), 8, 5, 4, "int8", None),
    (dict(max_len=64, model_dim=64, num_heads=4), 8, 1, None, "bf16", None),
    (dict(model_dim=512, num_heads=2), 8, 1, None, "bf16",
     r"head_dim 4, 8, 16, 32, 64 or 128 \(got 256\)"),
    (dict(model_dim=2048, num_heads=16), 8, 17, 16, "bf16", "17 rows a slot exceed the 16 rows"),
)


@pytest.mark.parametrize("knobs,slots,rows,bs,kv,reason", REASON_CASES)
def test_decode_unsupported_reason_of_f32_models(knobs, slots, rows, bs, kv, reason):
    """``GPTLM._decode_unsupported_reason`` of f32 models at the H100's
    figures: the planner serves decode-full (slab, pool, verify; f32, int8,
    fp8 caches; the window; GQA-2), gpt-m-L1024 at 8 slots, tiny() and the
    head-dim-16 model, and refuses a head dim it is not built for and a
    verify past the rows a launch takes, naming why."""
    import re

    got = _gpt(**knobs)._decode_unsupported_reason(slots=slots, rows=rows, block_size=bs,
                                                   kv_dtype=kv, nsm=132, smem_limit=H100_SMEM)
    if reason is None:
        assert got is None
    else:
        assert got is not None and re.search(reason, got), got


# (slots, rows a slot, model dims, KV heads, cache extent, blocks a slot,
# layers, cache bytes): decode-full f32 slab, pool and verify over f32 and
# int8 caches; gpt-m-L1024 f32; tiny() and the head-dim-16 model.
F32_PLANS = (
    (8, 1, dict(d=256, hq=8, dh=32, f=1024), 8, 1024, 0, 4, 4),
    (8, 1, dict(d=256, hq=8, dh=32, f=1024), 8, 1024, 64, 4, 1),
    (8, 5, dict(d=256, hq=8, dh=32, f=1024), 8, 1024, 64, 4, 4),
    (8, 5, dict(d=256, hq=8, dh=32, f=1024), 2, 1024, 64, 4, 4),
    (8, 1, dict(d=512, hq=8, dh=64, f=2048), 8, 1024, 0, 8, 4),
    (8, 1, dict(d=32, hq=4, dh=8, f=128), 4, 64, 0, 2, 4),
    (3, 5, dict(d=32, hq=4, dh=8, f=128), 4, 64, 16, 2, 1),
    (8, 1, dict(d=64, hq=4, dh=16, f=256), 4, 64, 0, 2, 4),
)


@pytest.mark.parametrize("s,r,dims,hkv,c,mb,n,kv_bytes", F32_PLANS)
def test_coop_plan_in_f32(s, r, dims, hkv, c, mb, n, kv_bytes):
    """The f32 plan holds test_torch_decode.py's layout checks with 4-byte
    weights (tiles of at most 32 columns: the TMA box's 128-byte row),
    4-byte staged rows and f32 scratch; every shape here is one launch
    over the whole extent."""
    dims = dict(dims, hkv=hkv, n_layers=n)
    plan = _plan(s, r, c, mb, **dims, w_bytes=4, kv_bytes=kv_bytes)
    _check_plan(plan, s, r, c, mb, nsm=132, occupancy=1, **dims, w_bytes=4)
    assert plan.kb == c and all(p.tile_cols <= 32 for p in plan.products)


def test_coop_plan_refuses_mixed_dtypes():
    """Only a cache of the compute dtype or of 1-byte codes is planned."""
    with pytest.raises(ValueError, match="2 or 4 bytes over a cache of its own dtype"):
        _plan(8, 1, 1024, w_bytes=2, kv_bytes=4)
    with pytest.raises(ValueError, match="got 4 and 2 bytes"):
        _plan(8, 1, 1024, w_bytes=4, kv_bytes=2)


# -- the plain f32 decode against the JAX XLA engine ------------------------------


@functools.lru_cache(maxsize=None)
def _models(name, window=None, hkv=None):
    kw = dict(MODELS[name], window=window, num_kv_heads=hkv)
    jm, tm = jax_model(**kw), torch_model(**kw)
    tree = numpy_params(jm, seed=41)
    return jm, tm, jax_params(tree), torch_params(tree)


def _check_kv(jc, tc, kv):
    if kv == "bf16":  # the f32 model's "bf16" layout stores f32
        assert tc.k.dtype == torch.float32
        assert max_err(np.asarray(jc.k), tc.k.numpy()) < 1e-5
        assert max_err(np.asarray(jc.v), tc.v.numpy()) < 1e-5
        np.testing.assert_array_equal(np.asarray(jc.lengths), tc.lengths.numpy())
    else:
        _check_cache(jc, tc, kv)


# (model, engine, cache, window, KV heads)
SLOT_CASES = (
    ("tiny", "fused", "bf16", None, None),
    ("tiny", "fused-layer", "bf16", None, None),
    ("tiny", "fused", "int8", None, None),
    ("tiny", "fused-layer", "fp8", None, None),
    ("tiny", "fused", "bf16", 8, None),
    ("dh16", "fused", "bf16", None, 2),
    ("dh16", "fused-layer", "int8", 8, None),
    ("full2", "fused", "bf16", None, None),
    ("full2", "fused-layer", "bf16", None, 2),
    ("full2", "fused", "int8", 16, None),
)


@pytest.mark.parametrize("name,engine,kv,window,hkv", SLOT_CASES)
def test_f32_decode_slots_matches_jax_xla(name, engine, kv, window, hkv):
    """A ragged prefill into the slot cache, then twelve decode steps, one
    row inactive: logits within TOL of JAX's XLA engine, greedy tokens bit
    for bit over an f32 cache (over 1-byte codes both continue from JAX's
    pick), the cache as JAX leaves it."""
    import jax.numpy as jnp

    jm, tm, jp, tp = _models(name, window, hkv)
    rng = np.random.default_rng(12)
    s, l = 4, 14
    toks = rng.integers(0, 97, (s, l)).astype(np.int32)
    lens = np.array([5, 14, 9, 1], np.int32)
    admit = np.ones(s, bool)
    jl, jc = jm.prefill_slots(jp, jm.empty_slot_cache(s, kv), jnp.asarray(toks),
                              jnp.asarray(lens), jnp.asarray(admit))
    tl, tc = tm.prefill_slots(tp, tm.empty_slot_cache(s, kv, device="cpu"),
                              torch.from_numpy(toks), torch.from_numpy(lens),
                              torch.from_numpy(admit))
    assert max_err(jl, tl.numpy()) < TOL[kv]
    act = np.array([True, True, False, True])
    jt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    tt = tl.argmax(-1).to(torch.int32)
    for _ in range(12):
        jl, jc = jm.decode_slots(jp, jnp.asarray(jt), jc, jnp.asarray(act), engine="xla")
        tl, tc = tm.decode_slots(tp, tt, tc, torch.from_numpy(act), engine=engine)
        assert max_err(np.asarray(jl)[act], tl.numpy()[act]) < TOL[kv]
        jt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        tt = tl.argmax(-1).to(torch.int32)
        if kv == "bf16":
            np.testing.assert_array_equal(jt[act], tt.numpy()[act])
        else:
            tt = torch.from_numpy(jt.copy())
    _check_kv(jc, tc, kv)


# (model, engine, cache, window, KV heads)
PAGED_CASES = (
    ("tiny", "fused", "bf16", None, None),
    ("tiny", "fused-layer", "int8", None, 2),
    ("dh16", "fused", "fp8", None, None),
    ("dh16", "fused", "bf16", 8, 2),
    ("full2", "fused", "bf16", None, None),
)


@pytest.mark.parametrize("name,engine,kv,window,hkv", PAGED_CASES)
def test_f32_paged_decode_and_verify_match_jax_xla(name, engine, kv, window, hkv):
    """Through the block pool (blocks of 4, scrambled tables): a ragged
    extend, eight decode steps and a verify of drafts at prefixes that are
    not block-aligned (the verify kernel's plain version on "fused"),
    against the JAX XLA engine; greedy tokens bit for bit over an f32
    pool."""
    import jax.numpy as jnp

    jm, tm, jp, tp = _models(name, window, hkv)
    s, bs = 4, 4
    mb = tm.paged_blocks_per_slot(bs)
    nb = s * mb + 3
    tables = np.random.default_rng(5).permutation(nb)[: s * mb].reshape(s, mb).astype(np.int32)
    jc = jm.empty_paged_cache(s, nb, bs, kv)._replace(block_tables=jnp.asarray(tables))
    tc = tm.empty_paged_cache(s, nb, bs, kv, device="cpu")._replace(
        block_tables=torch.from_numpy(tables))
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 97, (s, 14)).astype(np.int32)
    slens = np.array([14, 3, 9, 11], np.int32)
    args = (toks, slens, np.zeros(s, np.int32), np.ones(s, bool))
    jl, jc = jm.extend_paged(jp, jc, *(jnp.asarray(a) for a in args))
    tl, tc = tm.extend_paged(tp, tc, *(torch.from_numpy(a) for a in args))
    real = np.arange(14)[None, :] < slens[:, None]
    assert max_err(np.asarray(jl)[real], tl.numpy()[real]) < TOL[kv]
    jc = jc._replace(lengths=jnp.asarray(slens))
    tc = tc._replace(lengths=torch.from_numpy(slens.copy()))
    jt = np.asarray(jl)[np.arange(s), slens - 1].argmax(-1).astype(np.int32)
    act = np.array([True, True, True, False])
    for _ in range(8):
        jl, jc = jm.decode_paged(jp, jnp.asarray(jt), jc, jnp.asarray(act), engine="xla")
        tl, tc = tm.decode_paged(tp, torch.from_numpy(jt.copy()), tc, torch.from_numpy(act),
                                 engine=engine)
        assert max_err(np.asarray(jl)[act], tl.numpy()[act]) < TOL[kv]
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        if kv == "bf16":
            np.testing.assert_array_equal(nxt[act], tl.argmax(-1).numpy()[act])
        jt = nxt
    draft = rng.integers(0, 97, (s, 5)).astype(np.int32)
    vargs = (draft, np.array([5, 1, 3, 2], np.int32), np.asarray(jc.lengths), act)
    jl, jc = jm.verify_paged(jp, jc, *(jnp.asarray(a) for a in vargs), engine="xla")
    tl, tc = tm.verify_paged(tp, tc, *(torch.from_numpy(np.array(a)) for a in vargs),
                             engine=engine)
    real = (np.arange(5)[None, :] < vargs[1][:, None]) & act[:, None]
    assert max_err(np.asarray(jl)[real], tl.numpy()[real]) < TOL[kv]
    _check_kv(jc, tc, kv)


@pytest.mark.parametrize("name,kv,paged,spec,engine", [
    ("tiny", "bf16", False, 0, "fused"),
    ("tiny", "bf16", True, 4, "fused"),
    ("dh16", "bf16", False, 0, "fused-layer"),
    ("dh16", "bf16", True, 0, "fused-layer"),
    ("full2", "bf16", False, 0, "fused"),
    ("full2", "bf16", True, 4, "fused"),
])
def test_f32_textserver_greedy_streams_match_jax(name, kv, paged, spec, engine):
    """TextServer's greedy streams of the f32 models (slab; the pool with
    the prefix cache, with and without speculation; "fused" and
    "fused-layer") equal the JAX TextServer's on its XLA engine token for
    token."""
    from distributed_tensorflow_tpu.serve import GenerationConfig as JCfg
    from distributed_tensorflow_tpu.serve import TextServer as JServer
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig, TextServer

    jm, tm, jp, tp = _models(name)
    kw = dict(slots=2, chunk=4, buckets=(8, 16), paged=paged, kv_dtype=kv,
              **({"block_size": 4, "spec_draft": spec} if paged else {}))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (5, 12, 14, 3)]
    prompts[1] = np.tile(np.array([7, 3, 9, 1], np.int32), 3)  # the drafter matches
    want = JServer(jm, jp, decode_engine="xla", **kw).generate(prompts, JCfg(max_new=16))
    srv = TextServer(tm, tp, device="cpu", decode_engine=engine, **kw)
    got = srv.generate(prompts, GenerationConfig(max_new=16))
    assert [o.tolist() for o in got] == [np.asarray(o).tolist() for o in want]
    if spec:
        assert srv.counters["spec_tokens_accepted"] > 0


# -- on the card ---------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode kernels have no CPU mode")


def _case(n, s, c, hq, hkv, dh, cd, kv, seed):
    """Seeded weights of n layers in the compute dtype ``cd``, a slab cache
    [n, s, c] of ``kv`` ("bf16": the compute dtype) with its scales, the
    same cache as a pool under scrambled tables (blocks of 16), residual
    rows."""
    from distributed_tensorflow_tpu_torch.ops.quantized import quantize_kv

    g = torch.Generator(device="cuda").manual_seed(seed)
    d, f = hq * dh, 4 * hq * dh

    def r(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(shape, device="cuda", generator=g) * scale).to(dt)

    w = {"ln1_scale": 1 + r(n, d, scale=0.1), "ln1_bias": r(n, d, scale=0.05),
         "ln2_scale": 1 + r(n, d, scale=0.1), "ln2_bias": r(n, d, scale=0.05),
         "b_up": r(n, f, scale=0.05), "b_down": r(n, d, scale=0.05)}
    for nm, (k, m) in dict(wq=(d, d), wk=(d, hkv * dh), wv=(d, hkv * dh), wo=(d, d),
                           w_up=(d, f), w_down=(f, d)).items():
        w[nm] = r(n, k, m, scale=k ** -0.5, dt=cd)
    raw = [r(n, s, c, hkv, dh) for _ in range(2)]
    if kv == "bf16":
        cache = [raw[0].to(cd), raw[1].to(cd), None, None]
    else:
        (a, sa), (b, sb) = quantize_kv(raw[0], kv), quantize_kv(raw[1], kv)
        cache = [a, b, sa, sb]
    bs, mb = 16, c // 16
    tables = torch.randperm(s * mb, device="cuda", generator=g).reshape(s, mb).int()
    pools = []
    for t in cache:
        if t is None:
            pools.append(None)
            continue
        p = torch.empty((n, s * mb, bs) + tuple(t.shape[3:]), dtype=t.dtype, device="cuda")
        for i in range(s):
            p[:, tables[i].long()] = t[:, i].reshape((n, mb, bs) + tuple(t.shape[3:]))
        pools.append(p)
    return w, r, cache, pools, tables


def _same(a, b):
    from distributed_tensorflow_tpu_torch.ops.quantized import movable

    return all(x is None or torch.equal(movable(x), movable(y)) for x, y in zip(a, b))


# (compute dtype, cache, model dims, KV heads, RoPE, window): f32 compute
# over f32, int8 and e4m3 caches at decode-full widths, with GQA-2, RoPE and
# the window; head dims 8 and 16 in bf16 and f32.
GPU_CASES = (
    ("float32", "bf16", 8, 32, 8, False, None),
    ("float32", "int8", 8, 32, 8, False, None),
    ("float32", "fp8", 8, 32, 8, True, None),
    ("float32", "bf16", 8, 32, 2, True, None),
    ("float32", "bf16", 8, 32, 8, False, 64),
    ("float32", "bf16", 4, 8, 4, True, None),
    ("bfloat16", "bf16", 4, 8, 2, True, None),
    ("float32", "int8", 4, 16, 4, False, None),
    ("bfloat16", "bf16", 4, 16, 4, False, 64),
)


@pytest.mark.cuda
@pytest.mark.parametrize("cd,kv,hq,dh,hkv,rope,window", GPU_CASES)
def test_decode_kernels_match_plain_and_keep_the_invariants_on_gpu(cd, kv, hq, dh, hkv, rope,
                                                                   window):
    """B5 (slab, paged), B6 (slab, paged) and B7 against their plain
    versions (h, the committed caches); B5 layer by layer with the commits
    == B6, paged == slab, and B6 in groups of 3 slots == one launch, bit for
    bit."""
    _cuda_or_skip()
    from distributed_tensorflow_tpu_torch.models.gpt import rolling_layout
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    n, s, c = 2, 8, 256
    cdt = getattr(torch, cd)
    w, r, cache, pools, tables = _case(n, s, c, hq, hkv, dh, cdt, kv, seed=dh + hkv)
    lengths = torch.tensor([0, 1, 17, 96, 128, 200, 254, 255], device="cuda", dtype=torch.int32)
    act = torch.ones(s, dtype=torch.bool, device="cuda")
    act[2] = False
    x = r(s, hq * dh)
    kw = dict(num_heads=hq, rope=rope, compute_dtype=cdt, window=window)
    tol = (TOL[kv] if cd == "float32" else 2e-2)
    slab = cache if window is None else [
        None if t is None else rolling_layout(t, lengths, window) for t in cache]

    def close(a, b):
        return (a.float() - b.float()).abs().max().item() <= tol * max(
            1.0, b.float().abs().max().item())

    def sc(ts, i=None):
        if ts[2] is None:
            return {}
        return dict(k_scale=ts[2] if i is None else ts[2][i],
                    v_scale=ts[3] if i is None else ts[3][i])

    def clone(ts):
        return [None if t is None else t.clone() for t in ts]

    w0 = {k: t[0] for k, t in w.items()}
    got = fd.decode_block_slab(x, w0, slab[0][0], slab[1][0], lengths, **kw, **sc(slab, 0))
    ref = fd.decode_block_slab_plain(x, w0, slab[0][0], slab[1][0], lengths, **kw,
                                     **sc(slab, 0))
    assert close(got[0], ref[0])
    gotp = fd.decode_block_paged(x, w0, pools[0][0], pools[1][0], tables, lengths, **kw,
                                 **sc(pools, 0))
    assert _same(gotp, got)  # paged == slab (B5)
    k1, k2 = clone(slab), clone(slab)
    o1 = fd.decode_token_slab(x, w, k1[0], k1[1], lengths, act, **kw, **sc(k1))[0]
    o2 = fd.decode_token_slab_plain(x, w, k2[0], k2[1], lengths, act, **kw, **sc(k2))[0]
    torch.cuda.synchronize()
    assert close(o1, o2)
    if kv == "bf16":
        assert close(k1[0], k2[0]) and close(k1[1], k2[1])
    k3 = clone(slab)
    h = x
    for i in range(n):
        wi = {k: t[i] for k, t in w.items()}
        h, kq, vq, kqs, vqs = fd.decode_block_slab(h, wi, k3[0][i], k3[1][i], lengths, **kw,
                                                   **sc(k3, i))
        ks_i, vs_i = (k3[2][i], k3[3][i]) if k3[2] is not None else (None, None)
        fd.commit_slot_rows(k3[0][i], k3[1][i], kq, vq, lengths, act, ks_i, vs_i, kqs, vqs,
                            window)
    torch.cuda.synchronize()
    assert torch.equal(h, o1) and _same(k3, k1)  # B5 layer by layer == B6
    k4 = clone(slab)
    fd.MAX_GROUP = 3
    try:
        o4 = fd.decode_token_slab(x, w, k4[0], k4[1], lengths, act, **kw, **sc(k4))[0]
    finally:
        fd.MAX_GROUP = None
    torch.cuda.synchronize()
    assert torch.equal(o4, o1) and _same(k4, k1)  # grouped == one launch
    p1 = clone(pools)
    o3 = fd.decode_token_paged(x, w, p1[0], p1[1], tables, lengths, act, **kw, **sc(p1))[0]
    torch.cuda.synchronize()
    assert torch.equal(o3, o1)  # paged == slab (B6)
    plens = torch.tensor([13, 0, 41, 70, 100, 3, 200, 250], device="cuda", dtype=torch.int32)
    slens = torch.tensor([5, 3, 1, 4, 5, 5, 2, 5], device="cuda", dtype=torch.int32)
    hv = r(s, 5, hq * dh)
    p4, p5 = clone(pools), clone(pools)
    o5 = fd.verify_tokens_paged(hv, w, p4[0], p4[1], tables, plens, slens, act, **kw, **sc(p4))
    o6 = fd.verify_tokens_paged_plain(hv, w, p5[0], p5[1], tables, plens, slens, act, **kw,
                                      **sc(p5))
    torch.cuda.synchronize()
    assert close(o5, o6)


@pytest.mark.cuda
def test_f32_textserver_serves_on_the_kernels_on_gpu():
    """A server of an f32 model is made on the card and serves through B6,
    B5 and B7 (each launched), the per-layer engine's streams equal to the
    megakernel's token for token (the same body: B5 layer by layer == B6
    bit for bit)."""
    _cuda_or_skip()
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig, TextServer

    model = GPTLM(vocab_size=97, max_len=64, model_dim=32, num_heads=4, num_layers=2,
                  pos_embedding="rope", compute_dtype=torch.float32)
    params = model.init(seed=3, device="cuda")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (5, 12, 9)]
    prompts[1] = np.tile(np.array([7, 3, 9, 1], np.int32), 3)
    cfg = GenerationConfig(max_new=12)
    outs = {}
    for name, kw, kernel in (("fused", {}, "decode_token_slab"),
                             ("fused-layer", dict(decode_engine="fused-layer"),
                              "decode_block_slab"),
                             ("spec", dict(paged=True, block_size=4, spec_draft=4),
                              "verify_tokens_paged")):
        _build.reset_launches()
        outs[name] = TextServer(model, params, slots=2, chunk=4, **kw).generate(prompts, cfg)
        assert _build.LAUNCHES[kernel] > 0, name
    assert [o.tolist() for o in outs["fused"]] == [o.tolist() for o in outs["fused-layer"]]
