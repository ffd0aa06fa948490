"""PyTorch port: the GPT forward and the slot prefill against the JAX
package, on seeded numpy weights with every residual weight filled."""

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

# f32 models: same math, sums in another order. bf16 models: operands are
# rounded at the same points in both, so only the f32 sums' order differs;
# an intermediate that rounds to the neighbouring bf16 value moves a logit
# by at most a few 1e-3 at these widths.
TOL = {"float32": 1e-4, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_matches_jax(dtype):
    import jax.numpy as jnp

    jm, tm = jax_model(dtype), torch_model(dtype)
    tree = numpy_params(jm, seed=1)
    toks = np.random.default_rng(2).integers(0, 97, (3, 20)).astype(np.int32)
    a = np.asarray(jm.apply(jax_params(tree), jnp.asarray(toks)))
    b = tm.apply(torch_params(tree), torch.from_numpy(toks)).numpy()
    assert a.shape == b.shape == (3, 20, 97)
    assert max_err(a, b) < TOL[dtype]


# (dtype, model overrides) — flash prefill, and GQA+rope on the plain path.
PREFILL_CASES = (
    ("float32", {}),
    ("bfloat16", {}),
    ("float32", {"attention_impl": "flash", "flash_min_len": 0}),
    ("float32", {"num_kv_heads": 2, "pos_embedding": "rope"}),
)


@pytest.mark.parametrize("dtype,kw", PREFILL_CASES)
def test_prefill_slots_matches_jax(dtype, kw):
    import jax.numpy as jnp

    jm, tm = jax_model(dtype, **kw), torch_model(dtype, **kw)
    tree = numpy_params(jm, seed=4)
    jp, tp = jax_params(tree), torch_params(tree)
    rng = np.random.default_rng(5)
    s, l = 4, 16
    toks = rng.integers(0, 97, (s, l)).astype(np.int32)
    lens = np.array([5, 16, 1, 9], np.int32)
    admit = np.array([True, True, False, True])
    # A pre-existing state in the non-admitted row must survive bit for bit.
    jc = jm.empty_slot_cache(s)
    tc = tm.empty_slot_cache(s, device="cpu")
    old = rng.standard_normal(tc.k.shape[2:]).astype(np.float32)
    jc = jc._replace(
        k=jc.k.at[:, 2].set(jnp.asarray(old, jc.k.dtype)),
        lengths=jc.lengths.at[2].set(7),
    )
    tc.k[:, 2] = torch.from_numpy(old).to(tc.k.dtype)
    tc.lengths[2] = 7
    jl, jc = jm.prefill_slots(jp, jc, jnp.asarray(toks), jnp.asarray(lens),
                              jnp.asarray(admit))
    tl, tc = tm.prefill_slots(tp, tc, torch.from_numpy(toks),
                              torch.from_numpy(lens), torch.from_numpy(admit))
    assert max_err(np.asarray(jl)[admit], tl.numpy()[admit]) < TOL[dtype]
    jk = np.asarray(jc.k.astype(jnp.float32))
    assert max_err(jk, tc.k.float().numpy()) < TOL[dtype]
    assert max_err(np.asarray(jc.v.astype(jnp.float32)), tc.v.float().numpy()) < TOL[dtype]
    np.testing.assert_array_equal(np.asarray(jc.lengths), tc.lengths.numpy())
    kept = torch.from_numpy(old).to(tc.k.dtype).float().expand_as(tc.k[:, 2])
    np.testing.assert_array_equal(tc.k[:, 2].float().numpy(), kept.numpy())


def test_reset_slots_matches_reference():
    import jax.numpy as jnp

    jm, tm = jax_model(), torch_model()
    jc, tc = jm.empty_slot_cache(4), tm.empty_slot_cache(4, device="cpu")
    lens = np.array([3, 0, 9, 5], np.int32)
    free = np.array([True, True, False, False])
    jc = jm.reset_slots(jc._replace(lengths=jnp.asarray(lens)), jnp.asarray(free))
    tc.lengths.copy_(torch.from_numpy(lens))
    k_before = tc.k.clone()
    tc = tm.reset_slots(tc, torch.from_numpy(free))
    np.testing.assert_array_equal(np.asarray(jc.lengths), tc.lengths.numpy())
    assert tm.cache_len == jm.cache_len == 64
    assert torch.equal(tc.k, k_before)  # stale K/V stay; lengths gate them


def test_config_validation_and_unported_features():
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    with pytest.raises(ValueError, match="attention_impl"):
        GPTLM(attention_impl="ring")
    with pytest.raises(ValueError, match="num_kv_heads"):
        GPTLM(num_heads=4, num_kv_heads=3)
    with pytest.raises(ValueError, match="decode_engine"):
        GPTLM(decode_engine="pallas")
    with pytest.raises(ValueError, match="compute_dtype"):
        GPTLM(compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="rope needs an even head_dim"):
        GPTLM(model_dim=12, num_heads=4, pos_embedding="rope")
    with pytest.raises(ValueError, match="window must be >= 1"):
        GPTLM(window=0)
    # MoE blocks and matmul_dtype are ported: their values are validated as
    # in the JAX package, and the decode kernels refuse them by name.
    with pytest.raises(ValueError, match="moe_experts must be >= 2"):
        GPTLM(moe_experts=1)
    with pytest.raises(ValueError, match="requires a MoE model"):
        GPTLM(moe_top_k=2)
    with pytest.raises(ValueError, match=r"moe_top_k 5 must be in \[1, moe_experts=4\]"):
        GPTLM(moe_experts=4, moe_top_k=5)
    with pytest.raises(ValueError, match="unknown matmul_dtype"):
        GPTLM(matmul_dtype="int4")
    with pytest.raises(ValueError, match="MoE blocks route through ops/moe"):
        GPTLM(moe_experts=4, decode_engine="fused")
    with pytest.raises(ValueError, match="matmul_dtype projections route through"):
        GPTLM(matmul_dtype="int8", decode_engine="fused-layer")
    assert GPTLM(moe_experts=4, moe_top_k=2).moe_top_k == 2
    assert GPTLM(matmul_dtype="fp8").matmul_dtype == "fp8"
    with pytest.raises(ValueError, match="unknown kv dtype"):
        GPTLM().empty_slot_cache(2, "int4", device="cpu")


def test_init_shapes_match_reference():
    jm, tm = jax_model(num_kv_heads=2), torch_model(num_kv_heads=2)
    jp, tp = jm.init(seed=1), tm.init(seed=1, device="cpu")
    for k, a in jp.blocks._asdict().items():
        assert tuple(a.shape) == tuple(getattr(tp.blocks, k).shape), k
    assert tuple(jp.embed.shape) == tuple(tp.embed.shape)
    assert float(tp.blocks.wo.abs().max()) == 0.0  # residual starts at identity
    assert float(tp.blocks.w_down.abs().max()) == 0.0
