"""PyTorch port: the slab ``TextServer`` on the CPU — greedy streams equal the
JAX package's in-process ``greedy_decode``; sampled streams depend only on
their seed."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import jax_model, jax_params, numpy_params, torch_model, torch_params


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 97, int(rng.integers(2, 30))).astype(np.int32)
            for _ in range(n)]


def _jax_greedy(jm, jp, prompt, max_new):
    import jax.numpy as jnp

    out = jm.greedy_decode(jp, jnp.asarray(prompt)[None], max_new)
    return np.asarray(out)[0, len(prompt):]


def test_greedy_streams_equal_jax_greedy_decode():
    """More requests than slots, a shared EOS id and uneven budgets."""
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig, TextServer

    jm, tm = jax_model(), torch_model()
    tree = numpy_params(jm, seed=9)
    jp, tp = jax_params(tree), torch_params(tree)
    prompts = _prompts(5, seed=10)
    budgets = [6, 12, 3, 9, 12]
    refs = [_jax_greedy(jm, jp, p, 12) for p in prompts]
    eos = int(refs[1][4])  # a token some stream really emits
    srv = TextServer(tm, tp, slots=2, chunk=4, device="cpu")
    outs = srv.generate(
        prompts, [GenerationConfig(max_new=b, eos_id=eos) for b in budgets]
    )
    for out, ref, b in zip(outs, refs, budgets):
        want = list(ref[:b])
        if eos in want:
            want = want[: want.index(eos) + 1]
        assert out.tolist() == want
    assert srv.idle()


def test_sampled_streams_depend_only_on_their_seed():
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig, TextServer

    tm = torch_model()
    tp = torch_params(numpy_params(jax_model(), seed=11))
    prompts = _prompts(4, seed=12)
    cfg = [GenerationConfig(max_new=10, greedy=False, temperature=0.8, top_p=0.9, seed=s)
           for s in (1, 2, 3, 1)]
    a = TextServer(tm, tp, slots=4, chunk=3, device="cpu").generate(prompts, cfg)
    # Same requests in another order beside other company, fewer slots.
    order = [2, 0, 3, 1]
    extra = [np.array([5, 6, 7], np.int32)]
    b = TextServer(tm, tp, slots=4, chunk=5, device="cpu").generate(
        extra + [prompts[i] for i in order],
        [GenerationConfig(max_new=4)] + [cfg[i] for i in order],
    )[1:]
    for i, out in zip(order, b):
        np.testing.assert_array_equal(out, a[i])
    assert len(a[0]) == 10 and not np.array_equal(a[0], a[1])
    # top_p that keeps only the top token makes sampling greedy.
    g = TextServer(tm, tp, slots=2, chunk=4, device="cpu").generate(
        prompts[:2], [GenerationConfig(max_new=6, greedy=False, top_p=1e-6, seed=5),
                      GenerationConfig(max_new=6)])
    h = TextServer(tm, tp, slots=2, chunk=4, device="cpu").generate(
        prompts[:2], [GenerationConfig(max_new=6)] * 2)
    np.testing.assert_array_equal(g[0], h[0])


def test_buckets_and_admission_validation():
    from distributed_tensorflow_tpu_torch.serve import GenerationConfig, TextServer

    tm = torch_model()
    tp = tm.init(seed=0, device="cpu")
    srv = TextServer(tm, tp, slots=2, device="cpu")
    assert srv.buckets == (16, 32, 63)  # the JAX defaults at max_len 64
    assert srv.bucket_for(17) == 32 and srv.bucket_for(63) == 63
    with pytest.raises(ValueError, match="largest bucket"):
        srv.submit(np.zeros(64, np.int32))
    with pytest.raises(ValueError, match="exceeds max_len"):
        srv.submit(np.zeros(60, np.int32), GenerationConfig(max_new=10))
    with pytest.raises(ValueError, match="top_p"):
        srv.submit([1], GenerationConfig(top_p=0.0))
    with pytest.raises(ValueError, match="decode engine"):
        TextServer(tm, tp, decode_engine="pallas", device="cpu")


def test_serve_text_round_trip():
    from distributed_tensorflow_tpu_torch.data.text import ByteTokenizer
    from distributed_tensorflow_tpu_torch.serve import TextServer

    tok = ByteTokenizer()
    tm = torch_model(vocab_size=tok.vocab_size)
    tp = tm.init(seed=0, device="cpu")
    srv = TextServer(tm, tp, tok, slots=2, chunk=4, device="cpu")
    outs = srv.serve_text(["hi", "abc", "z"], max_new=5)
    assert len(outs) == 3 and all(isinstance(o, str) for o in outs)
    assert srv.stats and all(v["tokens"] >= 1 for v in srv.stats.values())
