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
    from distributed_tensorflow_tpu_torch.ops import fused_decode as fd

    h = torch.zeros(2, 32)
    ck = torch.zeros(1, 2, 8, 4, 8, dtype=torch.bfloat16)
    w = {"w_up": torch.zeros(1, 32, 128)}
    with pytest.raises(NotImplementedError, match="rope"):
        fd._kernel_args(h, w, ck, ck, 4, True, torch.bfloat16)
    with pytest.raises(NotImplementedError, match="bf16"):
        fd._kernel_args(h, w, ck.float(), ck.float(), 4, False, torch.float32)
    with pytest.raises(ValueError, match="unknown decode engine"):
        torch_model()._resolve_decode_engine("xla")


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

    o1, kf1, vf1 = fd.decode_block_slab(x, {k: t[0] for k, t in w.items()},
                                        ck[0], cv[0], lengths, **kw)
    o2, kf2, vf2 = fd.decode_block_slab_plain(x, {k: t[0] for k, t in w.items()},
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
