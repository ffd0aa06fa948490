"""PyTorch port: the numerics of the flash kernels' split-TF32 products.

On f32 inputs the CUDA flash kernels (``ops/csrc/flash_fwd.cu``,
``flash_bwd.cu``) run every product on the tensor cores as split-TF32:
each operand x becomes hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi),
and the product is hi·hi + hi·lo + lo·hi. A CUDA kernel cannot run here,
so this file emulates that arithmetic (the rounding bit for bit, the
three-term products summed in f64), plugs it into the plain forward and
backward at small sizes, and holds the results to the chip's f32
tolerance, 1e-5 of max(1, |ref|) (``chip_smoke.py`` REL_TOL): the forward
against the JAX package's flash function (its Pallas kernel in CPU
interpret mode), the gradients against ``flash_bwd_plain``. One TF32 pass
(hi·hi alone) misses that tolerance, which is why the kernels split.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (caps torch's threads for xdist workers)

TOL = 1e-5  # chip_smoke.py REL_TOL of the flash kernels, times max(1, |ref|)

# (L, D, kv_lens): B=2, 4 query heads over 2 KV heads, causal.
CASES = [(l, d, ragged) for l in (64, 77, 130) for d in (64, 128) for ragged in (False, True)]
IDS = [f"L{l}-D{d}-{'kvlens' if r else 'full'}" for l, d, r in CASES]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest
    on the 10 stored mantissa bits, ties away from zero (adding half an
    ulp to the magnitude's bits, then dropping the low 13)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x.float() - hi)


def product(eq: str, a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``einsum(eq, a, b)`` as the kernels compute it on f32 operands:
    split-TF32 (``passes=3``: hi·hi + hi·lo + lo·hi) or one TF32 pass
    (``passes=1``), the products summed in f64, the result f32."""
    (ah, al), (bh, bl) = split(a), split(b)
    out = torch.einsum(eq, ah.double(), bh.double())
    if passes == 3:
        out = out + torch.einsum(eq, ah.double(), bl.double())
        out = out + torch.einsum(eq, al.double(), bh.double())
    return out.float()


def _valid(l, lens):
    """[B or 1, 1, L, L] bool: causal, and keys below kv_lens."""
    v = torch.tril(torch.ones(l, l, dtype=torch.bool))[None, None]
    if lens is not None:
        v = v & (torch.arange(l)[None, :] < lens[:, None])[:, None, None, :]
    return v


def emulated_forward(q, k, v, lens, passes=3):
    """The plain forward (causal) with both products emulated."""
    from distributed_tensorflow_tpu_torch.ops.attention import NEG_INF, repeat_kv

    kr, vr = repeat_kv(k, v, q.shape[2])
    s = product("bqhd,bkhd->bhqk", q, kr, passes) / math.sqrt(q.shape[-1])
    s = torch.where(_valid(q.shape[1], lens), s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = product("bhqk,bkhd->bqhd", p, vr, passes)
    return out, lse.transpose(1, 2)


def emulated_backward(q, k, v, do, lse, delta, lens, passes=3):
    """``flash_bwd_plain``'s formulas (causal, f32) with all five products
    emulated."""
    from distributed_tensorflow_tpu_torch.ops.attention import repeat_kv

    b, l, hq, d = q.shape
    hkv = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    kr, vr = repeat_kv(k, v, hq)
    valid = _valid(l, lens)
    s = product("bqhd,bkhd->bhqk", q, kr, passes) * scale
    p = torch.where(valid, torch.exp(s - lse.transpose(1, 2)[..., None]), 0.0)
    dp = product("bqhd,bkhd->bhqk", do, vr, passes)
    ds = p * (dp - delta.transpose(1, 2)[..., None]) * scale
    dv = product("bhqk,bqhd->bkhd", p, do, passes)
    dk = product("bhqk,bqhd->bkhd", ds, q, passes)
    dq = product("bhqk,bkhd->bqhd", ds, kr, passes)
    dk = dk.reshape(b, l, hkv, hq // hkv, d).sum(3)
    dv = dv.reshape(b, l, hkv, hq // hkv, d).sum(3)
    return dq, dk, dv


def _inputs(l, d, ragged, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((2, l, 4, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, l, 2, d)).astype(np.float32) for _ in range(2))
    lens = rng.integers(1, l + 1, 2).astype(np.int32) if ragged else None
    return q, k, v, do, lens


def _rel_err(got, ref) -> float:
    """max |got - ref| over max(1, max |ref|): the chip's measure."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def _jax_forward(q, k, v, lens):
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.pallas_attention import flash_attention_with_lse

    jl = None if lens is None else jnp.asarray(lens)
    o, lse = flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=True, kv_lens=jl, interpret=True)
    return np.asarray(o), np.asarray(lse)


def _forward_errors(case, passes):
    l, d, ragged = case
    q, k, v, _, lens = _inputs(l, d, ragged, seed=l + d)
    jo, jlse = _jax_forward(q, k, v, lens)
    tl = None if lens is None else torch.from_numpy(lens)
    out, lse = emulated_forward(*(torch.from_numpy(a) for a in (q, k, v)), tl, passes)
    return _rel_err(out, jo), _rel_err(lse, jlse)


def _backward_errors(case, passes):
    from distributed_tensorflow_tpu_torch.ops.flash_attention import (
        flash_attention_plain,
        flash_bwd_plain,
    )

    l, d, ragged = case
    q, k, v, do, lens = (torch.from_numpy(a) if a is not None else None
                         for a in _inputs(l, d, ragged, seed=3 * l + d))
    o, lse = flash_attention_plain(q, k, v, causal=True, kv_lens=lens)
    delta = (do * o).sum(-1)
    ref = flash_bwd_plain(q, k, v, o, lse, do, delta, lens, True)
    got = emulated_backward(q, k, v, do, lse, delta, lens, passes)
    return [_rel_err(a, r) for a, r in zip(got, ref)]


def test_tf32_rna_rounds_as_the_instruction():
    """Round to nearest on 10 mantissa bits, ties away from zero, both
    signs; a TF32 value and the split's sum reproduce x."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, 1 + 1.5 * ulp, -(1 + ulp / 2),
                      3.0 + 2 ** -12, 1 + ulp], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + ulp, 1.0, 1 + 2 * ulp, -(1 + ulp), 3.0, 1 + ulp])
    assert torch.equal(tf32_rna(x), want)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split(r)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    # hi + lo carries ~22 significant bits of x.
    assert ((hi.double() + lo.double() - r.double()).abs() <= r.double().abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_tf32_forward_matches_jax_flash(case):
    """out and lse of the forward with split-TF32 products within the
    chip's f32 tolerance of the JAX flash function."""
    err_out, err_lse = _forward_errors(case, passes=3)
    assert err_out <= TOL and err_lse <= TOL, (err_out, err_lse)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_tf32_backward_matches_plain(case):
    """dq, dk, dv with all five products split-TF32 within the chip's f32
    tolerance of ``flash_bwd_plain`` (f32 throughout)."""
    errs = _backward_errors(case, passes=3)
    assert max(errs) <= TOL, dict(zip(("dq", "dk", "dv"), errs))


def test_single_pass_tf32_misses_the_tolerance():
    """One TF32 pass per product (what ``allow_tf32`` would run) misses the
    f32 tolerance: the kernels must split. Checked on the first case of
    each length, forward and backward."""
    worst = []
    for case in CASES[::4]:
        worst.append(max(_forward_errors(case, passes=1)))
        worst.append(max(_backward_errors(case, passes=1)))
    assert max(worst) > 10 * TOL, worst


# B4b's tiles (csrc/flash_bwd.cu q_kernel): keys a K/V tile.
DQ_KEY_TILE = 32


def emulated_dq(q, k, v, do, lse, delta, lens, bk=DQ_KEY_TILE):
    """dq as B4b computes it (causal, f32): key tile by key tile, S and dP
    split-TF32, p masked explicitly and ds formed in f32, the tile's share
    dS K split-TF32 in a fresh accumulator, added to dq in f32."""
    from distributed_tensorflow_tpu_torch.ops.attention import repeat_kv

    b, l, hq, d = q.shape
    scale = 1.0 / math.sqrt(d)
    kr, vr = repeat_kv(k, v, hq)
    valid = _valid(l, lens)
    dq = torch.zeros(b, l, hq, d)
    for k0 in range(0, l, bk):
        kt, vt = kr[:, k0:k0 + bk], vr[:, k0:k0 + bk]
        s = product("bqhd,bkhd->bhqk", q, kt) * scale
        ok = valid[..., k0:k0 + bk]
        p = torch.where(ok, torch.exp(s - lse.transpose(1, 2)[..., None]), 0.0)
        dp = product("bqhd,bkhd->bhqk", do, vt)
        ds = p * (dp - delta.transpose(1, 2)[..., None]) * scale
        dq = dq + product("bhqk,bkhd->bqhd", ds, kt)
    return dq


@pytest.mark.parametrize("d", [64, 128])
def test_dq_kernel_arithmetic_matches_jax_split_backward(d):
    """B4b's arithmetic, emulated, within the chip's f32 tolerance of the
    dq of the JAX package's split backward (``_flash_bwd_impl`` with
    ``fused=False``: its ``_dq_kernel`` in CPU interpret mode, through the
    VJP of ``flash_attention_with_lse``), at a causal, ragged GQA case
    with an lse cotangent."""
    import jax
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.pallas_attention import flash_attention_with_lse

    rng = np.random.default_rng(d + 5)
    l = 77
    q, do = (rng.standard_normal((2, l, 4, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, l, 2, d)).astype(np.float32) for _ in range(2))
    lens = np.array([29, 77], np.int32)
    dlse = rng.standard_normal((2, l, 4)).astype(np.float32)

    def f(q_, k_, v_):
        return flash_attention_with_lse(q_, k_, v_, causal=True, kv_lens=jnp.asarray(lens),
                                        interpret=True, fused=False)

    (o, lse), vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    jdq = np.asarray(vjp((jnp.asarray(do), jnp.asarray(dlse)))[0])
    o, lse = torch.from_numpy(np.asarray(o)), torch.from_numpy(np.asarray(lse))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    delta = (tdo * o).sum(-1) - torch.from_numpy(dlse)
    got = emulated_dq(tq, tk, tv, tdo, lse, delta, torch.from_numpy(lens))
    assert _rel_err(got, jdq) <= TOL, _rel_err(got, jdq)
