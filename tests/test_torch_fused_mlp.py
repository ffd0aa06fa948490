"""PyTorch port: the fused MLP SGD kernels (B1 step, B2 epoch) and their
plain versions, held against the JAX package's Pallas kernels run in
interpret mode. The ``cuda`` cases hold the CUDA kernels against the plain
versions on the card and skip without one."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import mlp_numpy_params, mlp_numpy_batches, torch_fused

# Kernel vs plain version on the card: f32 throughout, sums in another
# order (the logits shares are summed per CTA, the products per warp), so a
# few steps agree to ~1e-6 and many steps drift apart by accumulated
# rounding. (cost share of max(1, |cost|), update share, parameter ulps):
# costs within the first of the plain costs; each parameter within
# share * max|update| + ulps * ulp(max|parameter|) of the plain one, where
# the update is (plain state - start). lr=0.001 moves N(0,1) weights by
# ~1e-4 in a few steps, so the parameters are held by their update, not
# their size; the ulp term is the rounding of w - lr*dw, which may land an
# ulp apart at each step. An update 1% off misses these limits.
FEW_STEPS_TOL = (1e-5, 1e-3, 6)
EPOCH_TOL = (1e-3, 2e-3, 32)


def _jax_fused(tree):
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.models.mlp import MLPParams
    from distributed_tensorflow_tpu.ops.pallas_mlp import to_fused

    return to_fused(MLPParams(*(jnp.asarray(tree[k]) for k in ("w1", "b1", "w2", "b2"))))


def test_plain_step_matches_pallas_step_kernel():
    """mlp_sgd_math_plain x 3 steps vs the Pallas step kernel (interpret
    mode), at test_pallas_mlp.py's tolerances."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.pallas_mlp import make_fused_train_step
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm

    tree = mlp_numpy_params(seed=0)
    xs, ys = mlp_numpy_batches(1, 100, seed=1)
    js = _jax_fused(tree)
    jstep = make_fused_train_step(batch_size=100, interpret=True)
    ts = torch_fused(tree)
    tstep = fm.make_fused_train_step(batch_size=100)
    for _ in range(3):
        js, jc = jstep(js, jnp.asarray(xs[0]), jnp.asarray(ys[0]))
        out, tc = tstep(ts, torch.from_numpy(xs[0]), torch.from_numpy(ys[0]))
        assert out is ts  # in place
        np.testing.assert_allclose(float(tc), float(jc), rtol=1e-5)
    for a, b in zip(js, ts):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
def test_plain_epoch_matches_pallas_epoch_kernel(stream):
    """fused_epoch_plain vs the Pallas whole-epoch kernel at steps=6, B=32
    (test_pallas_mlp.py's epoch-vs-scan tolerances), and the scanned
    per-step builder agrees with the epoch builder."""
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.pallas_mlp import make_fused_epoch_fn
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm

    steps, b = 6, 32
    tree = mlp_numpy_params(seed=2)
    xs, ys = mlp_numpy_batches(steps, b, seed=3)
    jrun = make_fused_epoch_fn(steps=steps, batch_size=b, learning_rate=0.01,
                               stream_dtype=getattr(jnp, stream), interpret=True)
    js, jc = jrun(_jax_fused(tree), jnp.asarray(xs), jnp.asarray(ys))
    trun = fm.make_fused_epoch_fn(steps=steps, batch_size=b, learning_rate=0.01,
                                  stream_dtype=getattr(torch, stream))
    ts, tc = trun(torch_fused(tree), torch.from_numpy(xs), torch.from_numpy(ys))
    assert tc.shape == (steps,)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)
    for a, t in zip(js, ts):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
    if stream == "float32":
        scan = fm.make_fused_scanned_fn(batch_size=b, learning_rate=0.01)
        ss, sc = scan(torch_fused(tree), torch.from_numpy(xs), torch.from_numpy(ys))
        np.testing.assert_allclose(sc.numpy(), tc.numpy(), rtol=1e-6)
        for a, t in zip(ss, ts):
            np.testing.assert_allclose(a.numpy(), t.numpy(), rtol=1e-6, atol=1e-7)


def test_fused_compiled_run_matches_jax_unshuffled():
    """make_fused_compiled_run_fn(shuffle=False), 2 epochs on a small split:
    same per-step costs and per-epoch accuracies as the JAX engine (bf16
    staging on both sides, f32 update math)."""
    import jax
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.ops.pallas_mlp import (
        make_fused_compiled_run_fn as jax_run_fn,
    )
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm

    tree = mlp_numpy_params(seed=4)
    (tx,), (ty,) = mlp_numpy_batches(1, 600, seed=5)
    (vx,), (vy,) = mlp_numpy_batches(1, 200, seed=6)
    kw = dict(batch_size=100, epochs=2, learning_rate=0.01, shuffle=False)
    js, jm = jax_run_fn(**kw, interpret=True)(
        _jax_fused(tree), *map(jnp.asarray, (tx, ty, vx, vy)), jax.random.key(0)
    )
    ts, tm = fm.make_fused_compiled_run_fn(**kw)(
        torch_fused(tree), *map(torch.from_numpy, (tx, ty, vx, vy)),
        torch.Generator().manual_seed(0),
    )
    assert tm["costs"].shape == (2, 6) and tm["accuracy"].shape == (2,)
    np.testing.assert_allclose(tm["costs"].numpy(), np.asarray(jm["costs"]), rtol=1e-5)
    np.testing.assert_allclose(tm["accuracy"].numpy(), np.asarray(jm["accuracy"]), atol=1e-6)
    for a, t in zip(js, ts):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)


def test_fused_round_trip_layout():
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.ops.fused_mlp import from_fused, to_fused

    params = MLP().init(seed=1, device="cpu")
    fused = to_fused(params)
    assert fused.b1.shape == (1, 100) and fused.b2.shape == (1, 10)
    back = from_fused(fused)
    for a, b in zip(back, params):
        assert torch.equal(a, b)
    fused.w1.add_(1.0)  # the copy never aliases the caller's tensors
    assert not torch.equal(fused.w1, params.w1)


def test_builders_refuse_mismatched_shapes():
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm

    tree = mlp_numpy_params(seed=0)
    step = fm.make_fused_train_step(batch_size=50)
    with pytest.raises(ValueError, match="batch 50"):
        step(torch_fused(tree), torch.zeros(100, 784), torch.zeros(100, 10))
    with pytest.raises(ValueError, match="stream_dtype"):
        fm.make_fused_epoch_fn(steps=2, batch_size=4, stream_dtype=torch.float16)
    run = fm.make_fused_epoch_fn(steps=2, batch_size=4)
    with pytest.raises(ValueError, match="epoch built for"):
        run(torch_fused(tree), torch.zeros(3, 4, 784), torch.zeros(3, 4, 10))


@pytest.mark.parametrize("steps,tol", [(3, FEW_STEPS_TOL), (40, EPOCH_TOL)])
@pytest.mark.parametrize("fault", ["lr_1pct", "drop_example"])
def test_update_check_rejects_an_update_one_percent_off(steps, tol, fault):
    """The limits of the card's kernel-vs-plain checks pass a run whose sums
    are in another order and refuse one whose updates are 1% off."""
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm

    tree = mlp_numpy_params(seed=15)
    xs, ys = (torch.from_numpy(a) for a in mlp_numpy_batches(steps, 100, seed=16))
    base = torch_fused(tree)
    ref, rc = fm.fused_epoch_plain(torch_fused(tree), xs, ys, learning_rate=0.001)
    # The same steps with the batch summed in two halves.
    alt, ac = torch_fused(tree), []
    for i in range(steps):
        *new, c = fm.mlp_sgd_math_plain(
            torch.cat([xs[i, 50:], xs[i, :50]]), torch.cat([ys[i, 50:], ys[i, :50]]),
            *alt, 0.001)
        alt = fm.FusedState(*new)
        ac.append(c)
    _assert_run_matches(tol, (torch.stack(ac), rc), alt, ref, base)
    bad = torch_fused(tree)
    for i in range(steps):
        x, y, lr = xs[i], ys[i], 0.001
        if fault == "lr_1pct":
            lr *= 1.01
        else:  # the gradient of 99 examples, scaled as if of 100
            x, y, lr = x[:99], y[:99], lr * 0.99
        bad = fm.FusedState(*fm.mlp_sgd_math_plain(x, y, *bad, lr)[:4])
    with pytest.raises(AssertionError):
        _assert_run_matches(tol, (rc, rc), bad, ref, base)


# The kernels' domain, checked in Python before a launch (the launcher
# checks it again): (batch, in, hidden, out, stream, message part).
OUTSIDE_DOMAIN = (
    (129, 784, 100, 10, "float32", "batches of 1..128"),
    (100, 784, 100, 33, "float32", "1..32 classes"),
    (100, 100, 100, 10, "bfloat16", "multiple of 16 bytes"),
    (100, 98, 100, 10, "float32", "multiple of 16 bytes"),
)
# Every shape a caller or a test gives the kernels, with the layout of x the
# launcher plans in an H100's shared memory: (batch, in, hidden, out,
# stream, slots, resident).
INSIDE_DOMAIN = (
    (100, 784, 100, 10, "bfloat16", 4, True),   # the trainer's epoch kernel
    (100, 784, 100, 10, "float32", 3, False),   # B1; B2 with f32 staging
    (1, 32, 100, 10, "float32", 1, True),       # chip_smoke.py's tiny probe
    (100, 100, 18, 10, "float32", 1, True),
    (100, 104, 18, 10, "bfloat16", 1, True),
    (128, 784, 100, 32, "bfloat16", 2, False),
    (1, 784, 100, 10, "bfloat16", 4, True),
)


@pytest.mark.parametrize("b,in_dim,hidden,out,stream,match", OUTSIDE_DOMAIN)
def test_kernel_domain_refuses_with_the_limit(b, in_dim, hidden, out, stream, match):
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm

    with pytest.raises(ValueError, match=match):
        fm.check_domain(b, in_dim, hidden, out, getattr(torch, stream), "fused_epoch")


@pytest.mark.parametrize("b,in_dim,hidden,out,stream", [row[:5] for row in INSIDE_DOMAIN])
def test_kernel_domain_takes_every_caller(b, in_dim, hidden, out, stream):
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm

    fm.check_domain(b, in_dim, hidden, out, getattr(torch, stream), "fused_epoch")


# -- on the card ---------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused MLP kernels have no CPU mode")


def _assert_run_matches(tol, costs, got, ref, base):
    """Costs and updated parameters of a kernel run vs the plain run from
    the same start ``base``, within ``tol`` (see FEW_STEPS_TOL)."""
    cost_share, share, ulps = tol
    kc, pc = (c.float().cpu() for c in costs)
    assert (kc - pc).abs().max().item() <= cost_share * max(1.0, pc.abs().max().item())
    for name, g, r, b in zip(("w1", "b1", "w2", "b2"), got, ref, base):
        g, r, b = g.cpu(), r.cpu(), b.cpu()
        err = (g - r).abs().max().item()
        ulp = float(np.spacing(np.float32(max(r.abs().max().item(), b.abs().max().item()))))
        limit = share * (r - b).abs().max().item() + ulps * ulp
        assert err <= limit, f"{name}: {err} > {limit}"


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [100, 18])  # 25 CTAs; 5 CTAs, the last ragged
def test_step_kernel_matches_plain_on_gpu(hidden):
    _cuda_or_skip()
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm

    tree = mlp_numpy_params(hidden=hidden, seed=7)
    xs, ys = mlp_numpy_batches(3, 100, seed=8)
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    base = torch_fused(tree, "cuda")
    k, p = torch_fused(tree, "cuda"), torch_fused(tree, "cuda")
    before = _build.LAUNCHES["fused_mlp_step"]
    kcs, pcs = [], []
    for i in range(3):
        kcs.append(fm.fused_train_step(k, xs[i], ys[i], learning_rate=0.001)[1].clone())
        pcs.append(fm.fused_train_step_plain(p, xs[i], ys[i], learning_rate=0.001)[1])
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_mlp_step"] == before + 3
    _assert_run_matches(FEW_STEPS_TOL, (torch.stack(kcs), torch.stack(pcs)), k, p, base)


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
def test_epoch_kernel_matches_plain_and_step_kernel_on_gpu(stream):
    _cuda_or_skip()
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm

    steps = 40
    tree = mlp_numpy_params(seed=9)
    xs, ys = mlp_numpy_batches(steps, 100, seed=10)
    dt = getattr(torch, stream)
    xs, ys = torch.from_numpy(xs).cuda().to(dt), torch.from_numpy(ys).cuda().to(dt)
    before = _build.LAUNCHES["fused_mlp_epoch"]
    k, kc = fm.fused_epoch(torch_fused(tree, "cuda"), xs, ys, learning_rate=0.001)
    assert _build.LAUNCHES["fused_mlp_epoch"] == before + 1
    p, pc = fm.fused_epoch_plain(torch_fused(tree, "cuda"), xs, ys, learning_rate=0.001)
    s = torch_fused(tree, "cuda")
    sc = torch.stack([
        fm.fused_train_step(s, xs[i].float(), ys[i].float(), learning_rate=0.001)[1]
        for i in range(steps)
    ])
    torch.cuda.synchronize()
    assert torch.isfinite(kc).all() and kc.shape == (steps,)
    base = torch_fused(tree, "cuda")
    _assert_run_matches(EPOCH_TOL, (kc, pc), k, p, base)
    # One device step function serves both kernels.
    _assert_run_matches(EPOCH_TOL, (kc, sc), k, s, base)


@pytest.mark.cuda
def test_compiled_run_on_gpu_matches_the_cpu_plain_version():
    """The slice's kernel path as a whole: the whole-run function with the
    epoch kernel on the card vs its plain version on the CPU, unshuffled,
    3 epochs (bf16 staging on both sides; f32 sums in another order)."""
    _cuda_or_skip()
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm

    tree = mlp_numpy_params(seed=12)
    (tx,), (ty,) = mlp_numpy_batches(1, 1000, seed=13)
    (vx,), (vy,) = mlp_numpy_batches(1, 300, seed=14)
    run = fm.make_fused_compiled_run_fn(batch_size=100, epochs=3, shuffle=False)
    out = {}
    before = _build.LAUNCHES["fused_mlp_epoch"]
    for dev in ("cuda", "cpu"):
        arrays = [torch.from_numpy(a).to(dev) for a in (tx, ty, vx, vy)]
        out[dev] = run(torch_fused(tree, dev), *arrays, torch.Generator(device=dev))
    assert _build.LAUNCHES["fused_mlp_epoch"] == before + 3
    (ks, km), (ps, pm) = out["cuda"], out["cpu"]
    # 300 test examples: one prediction apart would be 3.3e-3.
    assert (km["accuracy"].cpu() - pm["accuracy"]).abs().max().item() <= 1e-3
    _assert_run_matches(EPOCH_TOL, (km["costs"], pm["costs"]), ks, ps, torch_fused(tree))


# The new tiling's edges: (stream, batch, in, hidden, out). 784 and 100/104
# are not multiples of a chunk (256 bf16 or 128 f32 columns); hidden 18
# leaves the last CTA 2 of its 4 units; f32 at 784 streams x through a ring
# of 3 slots, bf16 at batch 128 and 32 classes through a ring of 2; batch 1
# leaves 15 of the 16 warps without an example.
TILING_EDGES = (
    ("float32", 100, 784, 100, 10),
    ("bfloat16", 100, 784, 100, 10),
    ("float32", 100, 100, 18, 10),
    ("bfloat16", 100, 104, 18, 10),
    ("float32", 1, 784, 100, 10),
    ("bfloat16", 1, 784, 18, 10),
    ("bfloat16", 128, 784, 100, 32),
    ("float32", 128, 784, 100, 32),
)


@pytest.mark.cuda
@pytest.mark.parametrize("stream,b,in_dim,hidden,out", TILING_EDGES)
def test_kernels_match_plain_at_the_tiling_edges_on_gpu(stream, b, in_dim, hidden, out):
    """Three steps of the epoch kernel (and, on f32, three launches of the
    step kernel) against the plain loop at FEW_STEPS_TOL."""
    _cuda_or_skip()
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm

    steps = 3
    tree = mlp_numpy_params(in_dim=in_dim, hidden=hidden, out=out, seed=17)
    xs, ys = mlp_numpy_batches(steps, b, in_dim=in_dim, out=out, seed=18)
    dt = getattr(torch, stream)
    xs, ys = torch.from_numpy(xs).cuda().to(dt), torch.from_numpy(ys).cuda().to(dt)
    base = torch_fused(tree, "cuda")
    k, kc = fm.fused_epoch(torch_fused(tree, "cuda"), xs, ys, learning_rate=0.001)
    p, pc = fm.fused_epoch_plain(torch_fused(tree, "cuda"), xs, ys, learning_rate=0.001)
    torch.cuda.synchronize()
    assert torch.isfinite(kc).all()
    _assert_run_matches(FEW_STEPS_TOL, (kc, pc), k, p, base)
    if stream == "float32":
        s = torch_fused(tree, "cuda")
        sc = torch.stack([fm.fused_train_step(s, xs[i], ys[i], learning_rate=0.001)[1]
                          for i in range(steps)])
        torch.cuda.synchronize()
        _assert_run_matches(FEW_STEPS_TOL, (sc, pc), s, p, base)


@pytest.mark.cuda
def test_epoch_kernel_keeps_a_nan_batch_nan_as_its_plain_version_on_gpu():
    """A NaN batch gives a NaN cost from the epoch kernel, as from its plain
    version (``torch.clamp``) and the JAX kernel (``jnp.maximum``): the
    loss's max(p, eps) keeps a NaN, so the anomaly guard can read it. The
    batches before it keep their finite costs."""
    _cuda_or_skip()
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm

    tree = mlp_numpy_params(seed=21)
    xs, ys = mlp_numpy_batches(6, 100, seed=22)
    xs[3:] = np.nan
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    _, kc = fm.fused_epoch(torch_fused(tree, "cuda"), xs, ys, learning_rate=0.001)
    _, pc = fm.fused_epoch_plain(torch_fused(tree, "cuda"), xs, ys, learning_rate=0.001)
    torch.cuda.synchronize()
    assert torch.isfinite(kc[:3]).all() and torch.isnan(kc[3:]).all()
    assert torch.isnan(pc[3:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
def test_epoch_kernel_is_deterministic_on_gpu(stream):
    """Every sum across threads and CTAs has a fixed order: two runs of the
    same epoch are bitwise equal, costs and parameters."""
    _cuda_or_skip()
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm

    tree = mlp_numpy_params(seed=19)
    xs, ys = mlp_numpy_batches(20, 100, seed=20)
    dt = getattr(torch, stream)
    xs, ys = torch.from_numpy(xs).cuda().to(dt), torch.from_numpy(ys).cuda().to(dt)
    a, ac = fm.fused_epoch(torch_fused(tree, "cuda"), xs, ys, learning_rate=0.001)
    b, bc = fm.fused_epoch(torch_fused(tree, "cuda"), xs, ys, learning_rate=0.001)
    torch.cuda.synchronize()
    assert torch.equal(ac, bc)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("b,in_dim,hidden,out,stream,slots,resident", INSIDE_DOMAIN)
def test_shared_memory_layout_on_gpu(b, in_dim, hidden, out, stream, slots, resident):
    """The launcher's plan for every caller's shape: a bf16 batch of 100 or
    fewer resident, an f32 one of 784 columns through a ring of 3 slots."""
    _cuda_or_skip()
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm

    dev = torch.cuda.current_device()
    nbytes, nbuf, res = fm.smem_layout(b, in_dim, hidden, out, getattr(torch, stream), dev)
    assert (nbuf, res) == (slots, resident) and nbytes > 0


@pytest.mark.cuda
def test_wrapper_refuses_a_batch_without_room_for_two_slots_on_gpu():
    """Batch 128 of 6000 f32 columns leaves no room for two 64 KB slots of
    x beside W1's slice: a ValueError before any launch."""
    _cuda_or_skip()
    from distributed_tensorflow_tpu_torch.ops import fused_mlp as fm

    tree = mlp_numpy_params(in_dim=6000, hidden=100, out=10, seed=21)
    xs, ys = mlp_numpy_batches(1, 128, in_dim=6000, out=10, seed=22)
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    with pytest.raises(ValueError, match="no room for two slots"):
        fm.fused_epoch(torch_fused(tree, "cuda"), xs, ys, learning_rate=0.001)
