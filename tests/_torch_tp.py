"""The one 4-rank world of the tensor-parallel tests
(``tests/test_torch_tp.py``, ``tests/test_torch_tp_classifiers.py``): the
seeded inputs, the runs (``tests/_torch_dist.py`` ``case_tp``) on meshes of
(2, 2) ``("data", "model")``, (1, 4) and (1, 2, 2) ``("data", "model",
"seq")`` built from the same ranks, and the fixture both modules share
(``run_world_once``: one world a test session)."""

from __future__ import annotations

import functools

import numpy as np

from _torch_dist import run_world_once
from _torch_parity import SMALL, jax_model, numpy_params

STEPS, BATCH, LEN = 3, 8, 16
FLASH = dict(attention_impl="flash", flash_min_len=0)
GQA = dict(num_kv_heads=2)
DT, DTS = ("data", "model"), ("data", "model", "seq")
TRAIN_CFG = dict(epochs=1, batch_size=BATCH, log_frequency=1, compute_dtype="float32",
                 optimizer="adam", learning_rate=1e-3, dp_mode="tp")
# The classifier families at the JAX tests' tiny widths: (registry name, knobs).
FAMILIES = {"mlp": ("mlp", {}), "cnn": ("cnn", dict(channels=(4, 8), hidden_dim=32)),
            "lstm": ("lstm", dict(hidden_dim=32))}
CLASSIFIER_LR = {"mlp": 0.001, "cnn": 0.05, "lstm": 0.5}
# name -> (kind, mesh shape, axes, GPT knobs or family, params prefix, extra)
RUNS = {
    "tp22": ("step", (2, 2), DT, {}, "p", {}),
    "tp14": ("step", (1, 4), DT, {}, "p", {}),
    "tp14_gqa_flash": ("step", (1, 4), DT, {**FLASH, **GQA}, "g", {}),
    "tp22_gqa_window_selective": ("step", (2, 2), DT,
                                  {**FLASH, **GQA, "window": 6, "remat": "selective"}, "g", {}),
    "tp22_clip": ("step", (2, 2), DT, {}, "p", {"clip": 0.05}),
    "tp122_ring": ("step", (1, 2, 2), DTS, {}, "p", {"seq": "seq"}),
    "tp122_flash_gqa": ("step", (1, 2, 2), DTS, {**FLASH, **GQA}, "g", {"seq": "seq"}),
    "tp22_ragged": ("ragged", (2, 2), DT, {**FLASH, **GQA}, "g", {}),
    "trainer_tp": ("trainer", (2, 2), DT, {}, "p", {"config": TRAIN_CFG}),
    "trainer_tp_compiled": ("trainer", (1, 4), DT, {**FLASH, **GQA}, "g",
                            {"config": {**TRAIN_CFG, "compiled_run": True}}),
    "collectives": ("collectives", (1, 4), DT, {}, "p", {}),
    "convert": ("convert", (2, 2), DT, {}, "p", {}),
    **{f"{fam}_tp": ("classifier", (2, 2), DT, fam, None, {}) for fam in FAMILIES},
    "mlp_zero_tp": ("zero", (2, 2), DT, "mlp", None, {}),
    "mlp_placement": ("placement", (2, 2), DT, "mlp", None, {}),
}


def _flat(tree: dict, prefix: str) -> dict:
    out = {f"{prefix}/{k}": v for k, v in tree.items() if k != "blocks"}
    out.update({f"{prefix}/blocks/{k}": v for k, v in tree["blocks"].items()})
    return out


@functools.lru_cache(maxsize=None)
def data():
    """(GPT numpy trees by prefix, classifier numpy trees by family, the
    world's inputs), all from seeds."""
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models import build_model

    rng = np.random.default_rng(81)
    trees = {"p": numpy_params(jax_model(), seed=81),
             "g": numpy_params(jax_model(**GQA), seed=82)}
    vocab = SMALL["vocab_size"]
    toks = rng.integers(0, vocab, (STEPS, BATCH, LEN)).astype(np.int32)
    lengths = rng.integers(5, LEN + 1, BATCH).astype(np.int32)
    ra = rng.integers(0, vocab, (BATCH, LEN)).astype(np.int32)
    rb = ra.copy()
    for b, n in enumerate(lengths):
        rb[b, n:] = (rb[b, n:] + 13) % vocab
    adam = {"mu": {k: (v * 0.01).astype(np.float32) if k != "blocks" else
                   {b: (w * 0.01).astype(np.float32) for b, w in v.items()}
                   for k, v in trees["p"].items()},
            "nu": {k: np.abs(v).astype(np.float32) if k != "blocks" else
                   {b: np.abs(w).astype(np.float32) for b, w in v.items()}
                   for k, v in trees["p"].items()}}
    classifiers = {}
    for fam, (reg, kw) in FAMILIES.items():
        p = build_model(reg, compute_dtype=jnp.float32, **kw).init(seed=1)
        classifiers[fam] = {k: np.asarray(v) + (0.05 * rng.standard_normal(np.shape(v))).astype(
            np.float32) for k, v in p._asdict().items()}
    cx = rng.random((4, 16, 784), dtype=np.float32)
    cy = np.eye(10, dtype=np.float32)[rng.integers(0, 10, (4, 16))]
    inp = dict(**_flat(trees["p"], "p"), **_flat(trees["g"], "g"),
               **_flat(adam["mu"], "adam_mu"), **_flat(adam["nu"], "adam_nu"),
               **{"adam/count": np.int32(7)}, tokens=toks, lengths=lengths, ragged_a=ra,
               ragged_b=rb, cx=cx, cy=cy,
               train=rng.integers(0, vocab, (4 * BATCH, LEN)).astype(np.int32),
               val=rng.integers(0, vocab, (16, LEN)).astype(np.int32),
               **{f"{fam}/{k}": v for fam, t in classifiers.items() for k, v in t.items()})
    return trees, classifiers, adam, inp


def tp_world(tmp_path_factory):
    """(GPT trees, classifier trees, Adam tree, inputs, each rank's results)
    of the test session's one tensor-parallel world."""
    trees, classifiers, adam, inp = data()
    runs = []
    for name, (kind, shape, axes, knobs, prefix, extra) in RUNS.items():
        run = dict(name=name, kind=kind, shape=list(shape), axes=list(axes), steps=STEPS,
                   params=prefix, **extra)
        if kind in ("classifier", "zero", "placement"):
            run.update(family=knobs, model=FAMILIES[knobs], lr=CLASSIFIER_LR[knobs])
        else:
            run["model"] = {**SMALL, **knobs}
        runs.append(run)
    out = run_world_once("tp", 4, tmp_path_factory, inp, {"runs": runs})
    for r in out:
        assert not r["jax_loaded"] and not r["jax_package_loaded"]
    return trees, classifiers, adam, inp, [r["result"] for r in out]
