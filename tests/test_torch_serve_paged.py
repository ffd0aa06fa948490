"""PyTorch port: the paged ``TextServer`` on the CPU — prefix caching and
prompt-lookup speculation. Greedy streams equal the JAX package's
in-process ``greedy_decode``; sampled streams equal the port's slab
server's for the same seeds; the prefix cache prefills a shared prefix
once; admission is gated on blocks; verify writes stay inside each slot's
reserved blocks."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from _torch_parity import jax_model, jax_params, numpy_params, torch_model, torch_params

SEED = 13


@functools.lru_cache(maxsize=None)
def _models():
    jm, tm = jax_model(), torch_model()
    tree = numpy_params(jm, seed=SEED)
    return jm, tm, jax_params(tree), torch_params(tree)


@functools.lru_cache(maxsize=None)
def _jax_greedy(prompt: tuple, max_new: int) -> tuple:
    import jax.numpy as jnp

    jm, _, jp, _ = _models()
    out = jm.greedy_decode(jp, jnp.asarray(prompt, jnp.int32)[None], max_new)
    return tuple(int(t) for t in np.asarray(out)[0, len(prompt):])


def _server(**kw):
    from distributed_tensorflow_tpu_torch.serve import TextServer

    _, tm, _, tp = _models()
    kw = {"slots": 3, "chunk": 4, "buckets": (8, 16, 32), "device": "cpu", **kw}
    return TextServer(tm, tp, **kw)


def _mixed():
    """Six requests, greedy and sampled alternating; two carry a repeated
    pattern so the drafter finds matches."""
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (5, 9, 17, 3, 20, 8)]
    prompts[0] = np.tile(np.array([7, 3, 9, 1], np.int32), 4)
    prompts[2] = np.tile(np.array([11, 5, 2], np.int32), 5)
    cfgs = [
        GenerationConfig(max_new=10) if i % 2 == 0 else
        GenerationConfig(max_new=10, greedy=False, temperature=0.8, top_p=0.9, seed=50 + i)
        for i in range(len(prompts))
    ]
    return prompts, cfgs


@functools.lru_cache(maxsize=None)
def _slab_streams():
    prompts, cfgs = _mixed()
    return [tuple(o.tolist()) for o in _server().generate(prompts, cfgs)]


@pytest.mark.parametrize("spec", [0, 3], ids=["chunked", "speculative"])
def test_paged_streams_match_jax_greedy_and_slab_sampled(spec):
    """Greedy and seeded sampling mixed in one pool with mid-flight
    admissions (6 requests, 3 slots): greedy streams equal JAX
    ``greedy_decode``; every stream equals the slab server's."""
    prompts, cfgs = _mixed()
    srv = _server(paged=True, block_size=4, spec_draft=spec)
    outs = srv.generate(prompts, cfgs)
    for pr, c, out in zip(prompts, cfgs, outs):
        if c.greedy:
            assert tuple(out.tolist()) == _jax_greedy(tuple(pr.tolist()), c.max_new)
    assert [tuple(o.tolist()) for o in outs] == _slab_streams()
    cnt = srv.counters
    if spec:
        assert 0 < cnt["spec_tokens_accepted"] <= cnt["spec_tokens_proposed"]
        assert srv.timing["verify_ticks"] > 0
    # Pool hygiene: after the drain only the radix's blocks stay live.
    assert srv._alloc.used_blocks == len(srv._prefix._map) == cnt["kv_blocks_used"]


def _shared(seed):
    rng = np.random.default_rng(seed)
    sysp = rng.integers(0, 97, 24).astype(np.int32)
    return [np.concatenate([sysp, rng.integers(0, 97, k).astype(np.int32)]) for k in (3, 5, 7)]


@pytest.mark.parametrize("stagger", [True, False], ids=["mid-flight", "one-round"])
def test_shared_prefix_prefills_once(stagger):
    """A 24-token system prompt (6 blocks of 4) is prefilled once and hit
    by the other two requests: hits 12, misses 8 — admitted mid-flight, or
    all cold in one round (dependents prefill in a later wave)."""
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig

    shared = _shared(9 if stagger else 11)
    srv = _server(paged=True, block_size=4)
    cfg = GenerationConfig(max_new=8)
    rids = [srv.submit(shared[0], cfg)]
    if stagger:
        srv.step()  # request 0 prefills alone
    rids += [srv.submit(p, cfg) for p in shared[1:]]
    if not stagger:
        srv.step()
        assert all(r is not None for r in srv._slot_req)  # one admission round
    while srv.step():
        pass
    for pr, rid in zip(shared, rids):
        assert tuple(srv.result(rid).tolist()) == _jax_greedy(tuple(pr.tolist()), 8)
    assert srv.counters["prefix_cache_hits"] == 12
    assert srv.counters["prefix_cache_misses"] == 8
    assert srv._alloc.used_blocks == len(srv._prefix._map) > 0


def test_admission_is_gated_on_blocks():
    """A request the pool cannot hold yet waits while a later short one is
    admitted past it; blocks return at completion; ``submit`` refuses a
    request larger than the whole pool."""
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig

    srv = _server(paged=True, block_size=4, kv_blocks=10, prefix_caching=False)
    short = GenerationConfig(max_new=4)
    a = srv.submit(np.arange(1, 4), short)  # 2 blocks
    b = srv.submit(np.arange(1, 21), GenerationConfig(max_new=16))  # 9 blocks
    c = srv.submit(np.arange(5, 8), short)  # 2 blocks
    srv.step()
    assert [r.rid for r in srv._queue] == [b]
    assert {r.rid for r in srv._slot_req if r is not None} <= {a, c}
    while srv.step():
        pass
    assert all(srv.done(r) for r in (a, b, c))
    assert srv._alloc.used_blocks == 0 and srv.counters["kv_blocks_used"] == 0
    with pytest.raises(ValueError, match="KV blocks"):
        srv.submit(np.arange(1, 30), GenerationConfig(max_new=20))


def test_verify_writes_stay_in_reserved_blocks():
    """Budgets that end exactly at a block boundary while the drafter
    proposes full drafts: every verify writes only positions of active
    slots inside the blocks reserved for them (table entries past a
    reservation are 0, and block 0 belongs to another slot here), and
    blocks no slot reserved keep their bytes."""
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig

    _, tm, _, _ = _models()
    srv = _server(paged=True, block_size=4, spec_draft=4, spec_ngram=1, kv_blocks=40,
                  prefix_caching=False)
    g = torch.Generator().manual_seed(0)
    srv._cache.k.copy_(torch.randn(srv._cache.k.shape, generator=g))
    srv._cache.v.copy_(torch.randn(srv._cache.v.shape, generator=g))
    k0 = srv._cache.k.clone()
    pattern = np.array([3, 14, 15, 9], np.int32)
    # 12 + 36 = 48 and 7 + 33 = 40 positions: whole blocks of 4.
    reqs = [(np.tile(pattern, 3), 36), (np.tile(pattern, 2)[:7], 33)]
    verify = tm.verify_paged
    checked = []

    def checking_verify(params, cache, tokens, suffix_lens, prefix_lens, admit, **kw):
        before = cache.k.clone()
        out = verify(params, cache, tokens, suffix_lens, prefix_lens, admit, **kw)
        allowed = torch.zeros(cache.k.shape[1:3], dtype=torch.bool)
        for s in range(srv.slots):
            if admit[s]:
                for p in range(int(prefix_lens[s]), int(prefix_lens[s] + suffix_lens[s])):
                    assert p // 4 < len(srv._slot_blocks[s]), "write past the reservation"
                    allowed[srv._slot_blocks[s][p // 4], p % 4] = True
        changed = (cache.k != before).flatten(3).any(-1).any(0)
        assert not (changed & ~allowed).any()
        checked.append(suffix_lens.tolist())
        return out

    tm.verify_paged = checking_verify
    try:
        rids = [srv.submit(p, GenerationConfig(max_new=m)) for p, m in reqs]
        srv.step()
        assert srv._slot_blocks[0][0] == 0  # block 0 is slot 0's
        assert srv._host_tables[1, len(srv._slot_blocks[1])] == 0  # past slot 1's
        while srv.step():
            pass
    finally:
        del tm.verify_paged
    assert max(max(c) for c in checked) == 5  # full drafts were proposed
    spare = list(range(22, 40))  # 12 + 10 blocks were handed out in order
    assert torch.equal(srv._cache.k[:, spare], k0[:, spare])
    for (p, m), rid in zip(reqs, rids):
        assert tuple(srv.result(rid).tolist()) == _jax_greedy(tuple(p.tolist()), m)


def test_sampled_only_ticks_use_the_chunk_loop():
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig

    srv = _server(paged=True, block_size=4, spec_draft=3)
    cfg = [GenerationConfig(max_new=6, greedy=False, seed=s) for s in (1, 2)]
    outs = srv.generate([np.arange(1, 6), np.arange(2, 9)], cfg)
    assert srv.timing["verify_ticks"] == 0 and srv.timing["decode_steps"] > 0
    assert [len(o) for o in outs] == [6, 6]


def test_paged_knob_validation():
    with pytest.raises(ValueError, match="requires the paged cache"):
        _server(spec_draft=2)
    with pytest.raises(ValueError, match="spec_ngram"):
        _server(paged=True, spec_draft=2, spec_ngram=0)
    srv = _server(paged=True, block_size=16)
    assert srv.kv_blocks == 3 * 4  # slots x ceil(64 / 16), the slab footprint
    assert _server(paged=True, kv_blocks=5).kv_blocks == 5
    with pytest.raises(ValueError, match="kv_blocks"):
        _server(paged=True, kv_blocks=0)
