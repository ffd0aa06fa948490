"""The one 4-rank world of the LM async, ZeRO and DiLoCo tests
(``tests/test_torch_lm_async_zero.py``, ``tests/test_torch_local_sgd.py``):
the seeded inputs at the JAX tests' sizes (``tests/test_local_sgd.py``:
vocab 61, L=16, d=32, 4 heads, 2 layers, f32), the runs
(``tests/_torch_dist.py`` ``case_local_sgd``) on a (4,) ``("data",)`` mesh,
and the fixture both modules share (``run_world_once``: one world a test
session)."""

from __future__ import annotations

import functools

import numpy as np

from _torch_dist import run_world_once
from _torch_parity import jax_model, numpy_params

N = 4
LEN = 16
MODEL = dict(vocab_size=61, max_len=LEN, model_dim=32, num_heads=4, num_layers=2)
TRAIN_CFG = dict(epochs=1, batch_size=16, log_frequency=1, compute_dtype="float32")
# DiLoCo on the mesh: 4 steps of H=2, two outer rounds, with each lever.
DILOCO = dict(sync_every=2, outer_lr=0.7, outer_momentum=0.9)
LEVERS = {"off": {}, "int8": dict(delta_dtype="int8"), "fp8": dict(delta_dtype="fp8"),
          "overlap": dict(overlap=True, outer_momentum=0.4)}
SGD1 = dict(opt="sgd", lr=0.01)
# The equivalence checks against JAX step by SGD: Adam's first steps are the
# gradient's sign, which a last-bit difference flips where a gradient is
# near 0 (at 1e-3 such an element moved 1e-4 apart run to run).
SGD = dict(opt="sgd", lr=0.05)
# name -> (kind, extra)
RUNS = {
    "async_sgd1": ("async", dict(kw=dict(avg_every=1, update_scale=1.0), steps=2, **SGD1)),
    "dp_sgd": ("dp", dict(steps=2, **SGD1)),
    "diloco_h1": ("diloco", dict(kw=dict(sync_every=1, outer_lr=1.0, outer_momentum=0.0),
                                 steps=2, **SGD1)),
    "async_avg2": ("async", dict(kw=dict(avg_every=2, update_scale=1.0), steps=4)),
    "async_scale": ("async", dict(kw=dict(avg_every=2), steps=2, **SGD)),
    **{f"diloco_{k}": ("diloco", dict(kw={**DILOCO, **v}, steps=4, **SGD))
       for k, v in LEVERS.items()},
    "tr_async": ("trainer", dict(config=dict(TRAIN_CFG, sync=False, async_avg_every=2), **SGD)),
    "tr_async_sgd1": ("trainer", dict(config=dict(TRAIN_CFG, sync=False, async_avg_every=1),
                                      trainer=dict(async_update_scale=1.0), **SGD1)),
    "tr_dp_sgd": ("trainer", dict(config=TRAIN_CFG, **SGD1)),
    "tr_zero": ("trainer", dict(config=dict(TRAIN_CFG, dp_mode="zero"), opt="adamw")),
    "tr_dp_adamw": ("trainer", dict(config=TRAIN_CFG, opt="adamw")),
    "tr_diloco": ("trainer", dict(config=dict(TRAIN_CFG, dp_mode="diloco", delta_dtype="int8",
                                              **DILOCO), **SGD)),
    "tr_async_compiled": ("trainer", dict(config=dict(TRAIN_CFG, sync=False, async_avg_every=2,
                                                      compiled_run=True), compiled=True, **SGD)),
    "tr_diloco_compiled": ("trainer", dict(config=dict(TRAIN_CFG, dp_mode="diloco",
                                                       delta_overlap=True, sync_every=2),
                                           compiled=True, **SGD)),
    "convert": ("convert", {}),
}


def _flat(tree: dict, prefix: str) -> dict:
    out = {f"{prefix}/{k}": v for k, v in tree.items() if k != "blocks"}
    out.update({f"{prefix}/blocks/{k}": v for k, v in tree["blocks"].items()})
    return out


def each(tree: dict, fn) -> dict:
    """``fn`` over a numpy GPT tree's leaves."""
    return {k: ({b: fn(w) for b, w in v.items()} if k == "blocks" else fn(v))
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def data():
    """(the GPT numpy tree, its Adam moments, the world's inputs), from
    seeds."""
    rng = np.random.default_rng(20)
    tree = numpy_params(jax_model(**MODEL), seed=201)
    mu = each(tree, lambda a: (a * 0.01).astype(np.float32))
    nu = each(tree, lambda a: np.abs(a).astype(np.float32))
    # A JAX async state: a copy a replica, each moved apart.
    stack = each(tree, lambda a: np.stack([a + 0.01 * r for r in range(N)]).astype(np.float32))
    smu = each(mu, lambda a: np.stack([a * (r + 1) for r in range(N)]).astype(np.float32))
    snu = each(nu, lambda a: np.stack([a * (r + 1) for r in range(N)]).astype(np.float32))
    inp = dict(
        **_flat(tree, "d"), **_flat(mu, "d_mu"), **_flat(nu, "d_nu"),
        **_flat(stack, "d_stack"), **_flat(smu, "d_stack_mu"), **_flat(snu, "d_stack_nu"),
        **{"adam/count": np.int32(7), "stack/count": np.full(N, 7, np.int32)},
        steps=rng.integers(0, MODEL["vocab_size"], (4, N * 4, LEN)).astype(np.int32),
        train=rng.integers(0, MODEL["vocab_size"], (64, LEN)).astype(np.int32),
        val=rng.integers(0, MODEL["vocab_size"], (16, LEN)).astype(np.int32),
    )
    return tree, (mu, nu), inp


def local_sgd_world(tmp_path_factory):
    """(GPT tree, Adam moments, inputs, each rank's results) of the test
    session's one local-SGD world."""
    tree, moments, inp = data()
    runs = [dict(name=name, kind=kind, params="d", model=MODEL, tokens="steps", **extra)
            for name, (kind, extra) in RUNS.items()]
    out = run_world_once("local_sgd", N, tmp_path_factory, inp, {"runs": runs})
    for r in out:
        assert not r["jax_loaded"] and not r["jax_package_loaded"]
    return tree, moments, inp, [r["result"] for r in out]
