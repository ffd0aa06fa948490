"""The one 4-rank world of the expert- and pipeline-parallel tests
(``tests/test_torch_ep.py``, ``tests/test_torch_pp.py``): the seeded inputs,
the runs (``tests/_torch_dist.py`` ``case_ep_pp``) on meshes of (4,)
``("expert",)`` and ``("stage",)``, (2, 2) ``("data", "expert")`` and
``("data", "stage")`` and (1, 4) ``("data", "stage")`` built from the same
ranks, and the fixture both modules share (``run_world_once``: one world a
test session)."""

from __future__ import annotations

import functools

import numpy as np

from _torch_dist import run_world_once
from _torch_parity import SMALL, jax_model, numpy_params

LEN = 16
E, S = ("expert",), ("stage",)
DE, DS = ("data", "expert"), ("data", "stage")
FLASH = dict(attention_impl="flash", flash_min_len=0)
MOE4 = dict(moe_experts=4, moe_capacity_factor=16.0)
MOE2 = dict(moe_experts=2, moe_capacity_factor=16.0)
# ops/moe.moe_ffn's layer (tests/test_moe.py's widths, at 4 experts).
MOE_D, MOE_H, MOE_E, MOE_T = 32, 64, 4, 16
PIPE_D = 32
TRAIN_CFG = dict(epochs=1, batch_size=16, log_frequency=1, compute_dtype="float32",
                 optimizer="adam", learning_rate=1e-3)
# The GPT parameter trees: prefix -> JAX model knobs (and seed).
TREES = {"e4": (MOE4, 91), "e2": (MOE2, 92), "e4l1": (dict(MOE4, num_layers=1), 93),
         "d4": (dict(num_layers=4), 94), "d8": (dict(num_layers=8), 95)}
# name -> (kind, mesh shape, axes, GPT knobs, params prefix, extra)
RUNS = {
    "moe_k1": ("moe", (4,), E, None, None, dict(k=1, caps=[1, 4, 16])),
    "moe_k2": ("moe", (4,), E, None, None, dict(k=2, caps=[2, 4, 16])),
    "ep_fwd_k1": ("ep_fwd", (4,), E, dict(MOE4, moe_top_k=1), "e4", dict(tokens="ep_toks")),
    "ep_fwd_k2": ("ep_fwd", (4,), E, dict(MOE4, moe_top_k=2), "e4", dict(tokens="ep_toks")),
    "ep_step_k1": ("ep_step", (4,), E, dict(MOE4, moe_top_k=1), "e4",
                   dict(tokens="ep_steps", steps=1)),
    "ep_step_k2": ("ep_step", (4,), E, dict(MOE4, moe_top_k=2), "e4",
                   dict(tokens="ep_steps", steps=1)),
    "ep_step_dp": ("ep_step", (2, 2), DE, MOE2, "e2", dict(tokens="ep_dp_steps", steps=1)),
    "ep_reduces": ("ep_step", (4,), E, dict(MOE4, moe_capacity_factor=2.0, num_layers=1), "e4l1",
                   dict(tokens="ep_reduce", steps=60, lr=3e-3)),
    "ep_ragged": ("ep_step", (2, 2), DE, dict(MOE2, moe_capacity_factor=4.0), "e2",
                  dict(ragged=True)),
    "ep_trainer": ("trainer", (2, 2), DE, dict(MOE2, moe_capacity_factor=4.0), "e2",
                   dict(config=dict(TRAIN_CFG, dp_mode="ep"))),
    "ep_convert": ("convert", (2, 2), DE, MOE2, "e2", {}),
    "pipe_m4": ("pipe", (4,), S, None, None, dict(m=4)),
    "pipe_m8": ("pipe", (4,), S, None, None, dict(m=8)),
    "pp_fwd_s4": ("pp_fwd", (4,), S, dict(num_layers=4), "d4", dict(tokens="pp_fwd", m=4)),
    "pp_fwd_s2": ("pp_fwd", (2, 2), DS, dict(num_layers=4), "d4", dict(tokens="pp_fwd", m=4)),
    "pp_step": ("pp_step", (4,), S, dict(num_layers=8), "d8", dict(tokens="pp_steps", steps=3,
                                                                   m=4)),
    "pp_remat_off": ("pp_step", (4,), S, dict(num_layers=4), "d4",
                     dict(tokens="pp_steps", steps=1, m=2, sgd=1e-2)),
    "pp_remat_on": ("pp_step", (4,), S, dict(num_layers=4, remat=True), "d4",
                    dict(tokens="pp_steps", steps=1, m=2, sgd=1e-2)),
    "pp_flash": ("pp_step", (4,), S, dict(FLASH, num_layers=4), "d4",
                 dict(tokens="pp_steps", steps=1, m=2, sgd=1e-2)),
    "pp_flash_selective": ("pp_step", (4,), S, dict(FLASH, num_layers=4, remat="selective"), "d4",
                           dict(tokens="pp_steps", steps=1, m=2, sgd=1e-2)),
    "pp_dp": ("pp_step", (2, 2), DS, dict(num_layers=4), "d4",
              dict(tokens="pp_dp_steps", steps=3, m=4)),
    "pp_ragged": ("pp_step", (4,), S, dict(num_layers=4), "d4", dict(ragged=True, m=2, sgd=1e-2)),
    "pp_trainer": ("trainer", (2, 2), DS, dict(num_layers=4), "d4",
                   dict(config=dict(TRAIN_CFG, dp_mode="pp"), m=4)),
    "pp_trainer_compiled": ("trainer", (1, 4), DS, dict(num_layers=4, remat=True), "d4",
                            dict(config=dict(TRAIN_CFG, dp_mode="pp", compiled_run=True), m=4)),
    "pp_convert": ("convert", (2, 2), DS, dict(num_layers=4), "d4", {}),
}


def _flat(tree: dict, prefix: str) -> dict:
    out = {f"{prefix}/{k}": v for k, v in tree.items() if k != "blocks"}
    out.update({f"{prefix}/blocks/{k}": v for k, v in tree["blocks"].items()})
    return out


def _moments(tree: dict) -> tuple:
    """Adam moments shaped like ``tree``: (0.01 · tree, |tree|)."""
    def each(fn):
        return {k: ({b: fn(w) for b, w in v.items()} if k == "blocks" else fn(v))
                for k, v in tree.items()}

    return (each(lambda a: (a * 0.01).astype(np.float32)),
            each(lambda a: np.abs(a).astype(np.float32)))


def _ragged_pair(rng, b, vocab):
    """(tokens, the same past each length shifted, lengths in 5..LEN)."""
    toks = rng.integers(0, vocab, (b, LEN)).astype(np.int32)
    lengths = rng.integers(5, LEN + 1, b).astype(np.int32)
    other = toks.copy()
    for i, n in enumerate(lengths):
        other[i, n:] = (other[i, n:] + 13) % vocab
    return toks, other, lengths


@functools.lru_cache(maxsize=None)
def data():
    """(GPT numpy trees by prefix, Adam moments by prefix, the world's
    inputs), all from seeds."""
    import jax

    from distributed_tensorflow_tpu.ops.moe import init_moe

    rng = np.random.default_rng(19)
    vocab = SMALL["vocab_size"]
    trees = {k: numpy_params(jax_model(**kw), seed=seed) for k, (kw, seed) in TREES.items()}
    moments = {k: _moments(trees[k]) for k in ("e2", "d4")}
    moe = {k: np.asarray(v) for k, v in
           init_moe(jax.random.key(0), MOE_D, MOE_H, MOE_E)._asdict().items()}
    moe["b_up"] = (0.05 * rng.standard_normal(moe["b_up"].shape)).astype(np.float32)
    moe["b_down"] = (0.05 * rng.standard_normal(moe["b_down"].shape)).astype(np.float32)
    half = rng.integers(0, vocab, (60, 16, LEN // 2))
    ep_a, ep_b, ep_lens = _ragged_pair(rng, 16, vocab)
    pp_a = rng.integers(0, vocab, (4, LEN)).astype(np.int32)
    pp_lens = np.array([16, 9, 5, 12], np.int32)
    pp_b = pp_a.copy()
    for i, n in enumerate(pp_lens):
        pp_b[i, n:] = (pp_b[i, n:] + 13) % vocab
    inp = dict(
        **{k: v for p, t in trees.items() for k, v in _flat(t, p).items()},
        **{k: v for p, (mu, nu) in moments.items()
           for k, v in {**_flat(mu, f"{p}_mu"), **_flat(nu, f"{p}_nu")}.items()},
        **{"adam/count": np.int32(7)},
        **{f"moe/{k}": v for k, v in moe.items()},
        **{"moe/x": rng.standard_normal((MOE_E * MOE_T, MOE_D)).astype(np.float32),
           "moe/w": rng.standard_normal((MOE_E * MOE_T, MOE_D)).astype(np.float32)},
        **{"pipe/w": (rng.standard_normal((4, PIPE_D, PIPE_D)) / np.sqrt(PIPE_D)).astype(
            np.float32),
           "pipe/b": (0.05 * rng.standard_normal((4, PIPE_D))).astype(np.float32),
           "pipe/x": rng.standard_normal((16, PIPE_D)).astype(np.float32),
           "pipe/c": rng.standard_normal((16, PIPE_D)).astype(np.float32)},
        ep_toks=rng.integers(0, vocab, (8, LEN)).astype(np.int32),
        ep_steps=rng.integers(0, vocab, (1, 8, LEN)).astype(np.int32),
        ep_dp_steps=rng.integers(0, vocab, (1, 16, LEN)).astype(np.int32),
        ep_reduce=np.concatenate([half, half], axis=2).astype(np.int32),
        ep_ragged_a=ep_a, ep_ragged_b=ep_b, ep_lengths=ep_lens,
        pp_fwd=rng.integers(0, vocab, (8, LEN)).astype(np.int32),
        pp_steps=rng.integers(0, vocab, (3, 8, LEN)).astype(np.int32),
        pp_dp_steps=rng.integers(0, vocab, (3, 16, LEN)).astype(np.int32),
        pp_ragged_a=pp_a, pp_ragged_b=pp_b, pp_lengths=pp_lens,
        train=rng.integers(0, vocab, (64, LEN)).astype(np.int32),
        val=rng.integers(0, vocab, (16, LEN)).astype(np.int32),
    )
    return trees, moments, inp


def ep_pp_world(tmp_path_factory):
    """(GPT trees, Adam moments, inputs, each rank's results) of the test
    session's one expert- and pipeline-parallel world."""
    trees, moments, inp = data()
    runs = []
    for name, (kind, shape, axes, knobs, prefix, extra) in RUNS.items():
        run = dict(name=name, kind=kind, shape=list(shape), axes=list(axes), params=prefix,
                   **extra)
        if knobs is not None:
            run["model"] = {**SMALL, **knobs}
        runs.append(run)
    out = run_world_once("ep_pp", 4, tmp_path_factory, inp, {"runs": runs})
    for r in out:
        assert not r["jax_loaded"] and not r["jax_package_loaded"]
    return trees, moments, inp, [r["result"] for r in out]
