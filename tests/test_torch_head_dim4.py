"""PyTorch port: head dim 4 on the cooperative decode kernels (B5, B6, B7).

The JAX engine's GQA test model (tests/test_pallas_decode.py:171-176,
``tiny(num_heads=8, num_kv_heads=2)``: d=32 over 8 heads of 4, GQA 8:2,
RoPE, f32). The planner's answer at an H100's figures (132 SMs, 232,448
bytes of shared memory a block) is pinned for it in bf16 and f32 over every
cache; on the CPU the port's plain decode (slab, pool, verify) and
TextServer's greedy streams go against the JAX package's XLA engine. On a
GPU each kernel at head dim 4, in both builds and over every cache, against
its plain version and with the bitwise invariants (test_torch_decode_f32.py's
GPU check: B5 layer by layer == B6, paged == slab, grouped == one launch).

Tolerances: test_torch_decode_f32.py's. f32 logits within 1e-4 of JAX's and
greedy tokens bit for bit over an f32 cache; int8/fp8 caches logits within
2e-2 and 6e-2, codes within one step. On the card f32 within 1e-4 of the
largest magnitude, bf16 and 1-byte caches within 2e-2.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from _torch_parity import jax_model, jax_params, max_err, numpy_params, torch_model, torch_params
from test_torch_decode import H100_SMEM, _check_plan, _plan
from test_torch_decode_f32 import TOL, _check_kv

# tests/test_pallas_decode.py:171-176: tiny(num_heads=8, num_kv_heads=2).
DH4 = dict(model_dim=32, num_heads=8, num_kv_heads=2, pos_embedding="rope")


@pytest.mark.parametrize("w_bytes,kv_bytes", [(2, 2), (2, 1), (4, 4), (4, 1)],
                         ids=["bf16", "bf16-codes", "f32", "f32-codes"])
@pytest.mark.parametrize("s,r,mb", [(8, 1, 0), (8, 1, 4), (8, 5, 4), (64, 1, 0)])
def test_slot_group_and_plan_take_head_dim_4(w_bytes, kv_bytes, s, r, mb):
    """The planner (pure Python, the H100's figures) takes head dim 4 at the
    JAX test's shape: the whole step in one launch, one K/V row a lane (384
    keys a chunk of the attention's stream), and a plan that keeps the
    kernel's invariants."""
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    dims = dict(n_layers=2, d=32, hq=8, hkv=2, dh=4, f=128)
    c = 64
    group = fd.slot_group(s, r, 32, 8, 2, 4, 128, c, mb, 132, H100_SMEM, w_bytes=w_bytes,
                          kv_bytes=kv_bytes)
    assert group == min(s, 64 // r)
    plan = _plan(group, r, c, mb, w_bytes=w_bytes, kv_bytes=kv_bytes, **dims)
    _check_plan(plan, group, r, c, mb, nsm=132, occupancy=1, w_bytes=w_bytes, **dims)
    assert plan.kb == c and plan.tasks == group * 2


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
def test_decode_unsupported_reason_takes_head_dim_4(dtype, kv):
    """``GPTLM._decode_unsupported_reason`` of the head-dim-4 model: None
    for the decode step on the slab and the pool and for a verify of 5 rows
    a slot; a head dim of 2 is refused with the new list."""
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    m = GPTLM(vocab_size=97, max_len=64, num_layers=2, compute_dtype=getattr(torch, dtype),
              **DH4)
    for rows, bs in ((1, None), (1, 4), (5, 4)):
        assert m._decode_unsupported_reason(slots=8, rows=rows, block_size=bs, kv_dtype=kv,
                                            nsm=132, smem_limit=H100_SMEM) is None
    narrow = GPTLM(vocab_size=97, max_len=64, model_dim=16, num_heads=8, num_layers=2,
                   compute_dtype=getattr(torch, dtype))
    why = narrow._decode_unsupported_reason(slots=8, kv_dtype=kv, nsm=132,
                                            smem_limit=H100_SMEM)
    assert why is not None and "head_dim 4, 8, 16, 32, 64 or 128 (got 2)" in why


@functools.lru_cache(maxsize=None)
def _models():
    jm, tm = jax_model(**DH4), torch_model(**DH4)
    tree = numpy_params(jm, seed=43)
    return jm, tm, jax_params(tree), torch_params(tree)


@pytest.mark.parametrize("engine,kv", [("fused", "bf16"), ("fused-layer", "bf16"),
                                       ("fused", "int8"), ("fused-layer", "fp8")])
def test_head_dim_4_decode_slots_matches_jax_xla(engine, kv):
    """A ragged prefill into the slot cache, then twelve decode steps with
    one row inactive, against JAX's XLA engine: f32 logits within TOL,
    greedy tokens bit for bit over the f32 cache (over 1-byte codes both
    continue from JAX's pick), the cache as JAX leaves it."""
    import jax.numpy as jnp

    jm, tm, jp, tp = _models()
    rng = np.random.default_rng(14)
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
    act = np.array([True, False, True, True])
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


@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
def test_head_dim_4_paged_decode_and_verify_match_jax_xla(kv):
    """Through the pool (blocks of 4, scrambled tables): a ragged extend,
    eight decode steps (B6's plain version) and a verify at prefixes that
    are not block-aligned (B7's plain version), against JAX's XLA engine."""
    import jax.numpy as jnp

    jm, tm, jp, tp = _models()
    s, bs = 4, 4
    mb = tm.paged_blocks_per_slot(bs)
    nb = s * mb + 3
    tables = np.random.default_rng(7).permutation(nb)[: s * mb].reshape(s, mb).astype(np.int32)
    jc = jm.empty_paged_cache(s, nb, bs, kv)._replace(block_tables=jnp.asarray(tables))
    tc = tm.empty_paged_cache(s, nb, bs, kv, device="cpu")._replace(
        block_tables=torch.from_numpy(tables))
    rng = np.random.default_rng(8)
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
    act = np.array([True, True, False, True])
    for _ in range(8):
        jl, jc = jm.decode_paged(jp, jnp.asarray(jt), jc, jnp.asarray(act), engine="xla")
        tl, tc = tm.decode_paged(tp, torch.from_numpy(jt.copy()), tc, torch.from_numpy(act),
                                 engine="fused")
        assert max_err(np.asarray(jl)[act], tl.numpy()[act]) < TOL[kv]
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        if kv == "bf16":
            np.testing.assert_array_equal(nxt[act], tl.argmax(-1).numpy()[act])
        jt = nxt
    draft = rng.integers(0, 97, (s, 5)).astype(np.int32)
    vargs = (draft, np.array([5, 2, 3, 4], np.int32), np.asarray(jc.lengths), act)
    jl, jc = jm.verify_paged(jp, jc, *(jnp.asarray(a) for a in vargs), engine="xla")
    tl, tc = tm.verify_paged(tp, tc, *(torch.from_numpy(np.array(a)) for a in vargs),
                             engine="fused")
    real = (np.arange(5)[None, :] < vargs[1][:, None]) & act[:, None]
    assert max_err(np.asarray(jl)[real], tl.numpy()[real]) < TOL[kv]
    _check_kv(jc, tc, kv)


@pytest.mark.parametrize("paged,spec,engine", [(False, 0, "fused"), (True, 4, "fused"),
                                               (True, 0, "fused-layer")])
def test_head_dim_4_textserver_greedy_streams_match_jax(paged, spec, engine):
    """TextServer's greedy streams of the head-dim-4 model (slab; the pool
    with the prefix cache, with speculation on B7's plain version; the
    per-layer engine) equal the JAX TextServer's on its XLA engine."""
    from distributed_tensorflow_tpu.serve import GenerationConfig as JCfg
    from distributed_tensorflow_tpu.serve import TextServer as JServer
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig, TextServer

    jm, tm, jp, tp = _models()
    kw = dict(slots=2, chunk=4, buckets=(8, 16), paged=paged,
              **({"block_size": 4, "spec_draft": spec} if paged else {}))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (5, 12, 14, 3)]
    prompts[1] = np.tile(np.array([7, 3, 9, 1], np.int32), 3)  # the drafter matches
    want = JServer(jm, jp, decode_engine="xla", **kw).generate(prompts, JCfg(max_new=16))
    srv = TextServer(tm, tp, device="cpu", decode_engine=engine, **kw)
    got = srv.generate(prompts, GenerationConfig(max_new=16))
    assert [o.tolist() for o in got] == [np.asarray(o).tolist() for o in want]
    if spec:
        assert srv.counters["spec_tokens_accepted"] > 0


# (compute dtype, cache, query heads, head dim, KV heads, RoPE, window): head
# dim 4 at the JAX test's GQA 8:2 in both builds over every cache, and
# without GQA with the window.
GPU_CASES = tuple((cd, kv, 8, 4, 2, True, None) for cd in ("bfloat16", "float32")
                  for kv in ("bf16", "int8", "fp8")) + (("bfloat16", "bf16", 8, 4, 8, False, 64),
                                                         ("float32", "int8", 8, 4, 8, False, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("cd,kv,hq,dh,hkv,rope,window", GPU_CASES)
def test_head_dim_4_kernels_match_plain_on_gpu(cd, kv, hq, dh, hkv, rope, window):
    """B5 (slab, paged), B6 (slab, paged) and B7 at head dim 4 against their
    plain versions, and the bitwise invariants (test_torch_decode_f32.py's
    GPU check, run here at these cases)."""
    import test_torch_decode_f32 as f32

    f32.test_decode_kernels_match_plain_and_keep_the_invariants_on_gpu(
        cd, kv, hq, dh, hkv, rope, window)
