"""PyTorch port: the single-sequence decode API (``KVCache``, ``prefill``,
``decode_step``, ``greedy_decode``, ``sample_decode``, ``beam_decode``)
against the JAX package on seeded numpy inputs, at small widths. f32
models: greedy and beam streams token for token; random draws differ
between the frameworks, so sampling is held by its truncation on fixed
logits and by ``top_k=1`` being greedy."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from _torch_parity import jax_model, jax_params, max_err, numpy_params, torch_model, torch_params

TOL = 1e-4  # f32 logits, sums in another order (test_torch_decode.py's)


@functools.lru_cache(maxsize=None)
def _models(pos):
    kw = dict(num_kv_heads=2, pos_embedding=pos)
    jm, tm = jax_model(**kw), torch_model(**kw)
    tree = numpy_params(jm, seed=19)
    return jm, tm, jax_params(tree), torch_params(tree)


def _prompt(b=2, l=7, seed=0):
    return np.random.default_rng(seed).integers(0, 97, (b, l)).astype(np.int32)


@pytest.mark.parametrize("engine", ["fused", "fused-layer", "xla"])
@pytest.mark.parametrize("pos", ["learned", "rope"])
def test_prefill_and_decode_step_match_jax(pos, engine):
    """``prefill`` then 5 ``decode_step``s: logits within TOL of the JAX
    XLA engine's, the cache's K/V too, ``length`` counting."""
    import jax.numpy as jnp

    jm, tm, jp, tp = _models(pos)
    prompt = _prompt()
    jl, jc = jm.prefill(jp, jnp.asarray(prompt))
    tl, tc = tm.prefill(tp, torch.from_numpy(prompt))
    assert tc.length == prompt.shape[1] and tc.k.shape == tuple(jc.k.shape)
    assert max_err(jl, tl.numpy()) < TOL
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(5):
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc, engine="xla")
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, engine=engine)
        assert max_err(jl, tl.numpy()) < TOL
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    assert tc.length == int(jc.length)
    assert max_err(jc.k, tc.k.numpy()) < TOL and max_err(jc.v, tc.v.numpy()) < TOL


def test_decode_step_refuses_a_full_cache_as_jax_does():
    import jax.numpy as jnp

    jm, tm = jax_model(max_len=8), torch_model(max_len=8)
    tree = numpy_params(jm, seed=5)
    jp, tp = jax_params(tree), torch_params(tree)
    prompt = _prompt(1, 8)
    _, jc = jm.prefill(jp, jnp.asarray(prompt))
    _, tc = tm.prefill(tp, torch.from_numpy(prompt))
    for call in (lambda: jm.decode_step(jp, jnp.asarray([1]), jc, engine="xla"),
                 lambda: tm.decode_step(tp, torch.tensor([1]), tc)):
        with pytest.raises(ValueError, match="KV cache full"):
            call()


@pytest.mark.parametrize("engine", ["fused", "fused-layer", "xla"])
@pytest.mark.parametrize("pos", ["learned", "rope"])
def test_greedy_decode_matches_jax(pos, engine):
    """``greedy_decode`` equals the JAX package's token for token (f32),
    prompt included, on each engine."""
    import jax.numpy as jnp

    jm, tm, jp, tp = _models(pos)
    prompt = _prompt(3, 6, seed=1)
    want = np.asarray(jm.greedy_decode(jp, jnp.asarray(prompt), 12))
    got = tm.greedy_decode(tp, torch.from_numpy(prompt), 12, engine=engine)
    np.testing.assert_array_equal(want, got.numpy())
    assert got.dtype == torch.int32


@pytest.mark.parametrize("beam,eos,alpha", [(1, None, 0.0), (3, None, 0.0), (4, 5, 0.0),
                                             (3, 5, 0.7)])
def test_beam_decode_matches_jax(beam, eos, alpha):
    """``beam_decode`` returns the JAX package's best beam (f32), with and
    without EOS and a length penalty; beam 1 is greedy."""
    import jax.numpy as jnp

    jm, tm, jp, tp = _models("rope")
    prompt = _prompt(2, 5, seed=2)
    want = np.asarray(jm.beam_decode(jp, jnp.asarray(prompt), 9, beam, eos_id=eos,
                                     length_penalty=alpha))
    got = tm.beam_decode(tp, torch.from_numpy(prompt), 9, beam, eos_id=eos,
                         length_penalty=alpha)
    np.testing.assert_array_equal(want, got.numpy())
    if beam == 1:
        greedy = tm.greedy_decode(tp, torch.from_numpy(prompt), 9)
        assert torch.equal(got, greedy)


def _jax_filter(logits, temperature, top_k, top_p):
    """The truncation of the JAX ``sample_decode`` pick
    (``distributed_tensorflow_tpu/models/gpt.py:2356-2386``), step for step,
    without the draw."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    logits = logits.astype(jnp.float32) / temperature
    if top_k is not None:
        vals, idx = lax.top_k(logits, top_k)
        rows = jnp.arange(logits.shape[0])[:, None]
        logits = jnp.full_like(logits, -jnp.inf).at[rows, idx].set(vals)
    if top_p is not None and top_p < 1.0:
        order = jnp.argsort(logits, axis=-1)[..., ::-1]
        sorted_l = jnp.take_along_axis(logits, order, axis=-1)
        probs = jax.nn.softmax(sorted_l, axis=-1)
        keep_sorted = jnp.cumsum(probs, axis=-1) - probs < top_p
        rows = jnp.arange(logits.shape[0])[:, None]
        keep = jnp.zeros(logits.shape, bool).at[rows, order].set(keep_sorted)
        logits = jnp.where(keep, logits, -jnp.inf)
    return logits


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, None, None), (0.7, 5, None),
                                                     (1.3, None, 0.8), (0.9, 10, 0.6),
                                                     (1.0, 1, None), (2.0, None, 1.0)])
def test_sample_filter_matches_jax(temperature, top_k, top_p):
    """``filter_logits`` keeps the same tokens with the same values as the
    JAX pick's truncation, on fixed logits (ties in the rows included)."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu_torch.models.gpt import filter_logits

    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 97)).astype(np.float32) * 3
    logits[1, 10:20] = logits[1, 5]  # ties
    want = np.asarray(_jax_filter(jnp.asarray(logits), temperature, top_k, top_p))
    got = filter_logits(torch.from_numpy(logits), temperature, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(want), np.isfinite(got))
    np.testing.assert_allclose(want[np.isfinite(want)], got[np.isfinite(got)], rtol=0, atol=0)


def test_sample_decode_draws_from_its_generator():
    """``top_k=1`` samples the greedy stream; the same seed gives the same
    stream, another seed (almost surely) another; tokens stay inside the
    nucleus; the knobs are validated as in the JAX package."""
    _, tm, _, tp = _models("learned")
    prompt = torch.from_numpy(_prompt(2, 4, seed=4))
    greedy = tm.greedy_decode(tp, prompt, 10)
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    assert torch.equal(tm.sample_decode(tp, prompt, 10, gen(0), top_k=1), greedy)
    a = tm.sample_decode(tp, prompt, 10, gen(1), temperature=1.5)
    assert torch.equal(a, tm.sample_decode(tp, prompt, 10, gen(1), temperature=1.5))
    assert not torch.equal(a, tm.sample_decode(tp, prompt, 10, gen(2), temperature=1.5))
    for kw, msg in (({"temperature": 0.0}, "temperature"), ({"top_k": 0}, "top_k"),
                    ({"top_p": 0.0}, "top_p")):
        with pytest.raises(ValueError, match=msg):
            tm.sample_decode(tp, prompt, 4, gen(0), **kw)
    with pytest.raises(ValueError, match="exceeds max_len"):
        tm.greedy_decode(tp, prompt, 64)
    with pytest.raises(ValueError, match="max_new"):
        tm.greedy_decode(tp, prompt, 0)
