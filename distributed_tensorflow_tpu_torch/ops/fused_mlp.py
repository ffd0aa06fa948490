"""Fused MLP training: the CUDA SGD kernels and their plain versions.

Counterpart of ``distributed_tensorflow_tpu/ops/pallas_mlp.py``:

- :func:`fused_train_step` (JAX ``make_fused_train_step``, :108) — one SGD
  step of the MLP. Kernel ``mlp_step_kernel`` in ``csrc/fused_mlp.cu``
  replaces ``_fused_train_kernel`` (:69).
- :func:`fused_epoch` (JAX ``make_fused_epoch_fn``, :264) — ``steps`` SGD
  steps in one launch over staged batches. Kernel ``mlp_epoch_kernel``
  replaces ``_epoch_kernel`` (:181).

Both compute ``_mlp_sgd_math`` (:39) in f32; :func:`mlp_sgd_math_plain` is
that function in torch ops with the same analytic gradients, and
:func:`fused_epoch_plain` is a loop of it. A CUDA tensor launches the
kernel or raises; a CPU tensor runs the plain version. Either way the
parameters of the ``FusedState`` are updated IN PLACE and the same state
is returned (the JAX step aliases its parameters; the JAX epoch function
donates them).

The JAX package pads the per-step costs into (8, 128) blocks, a TPU tiling
artefact; here they are a plain ``[steps]`` f32 tensor.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from distributed_tensorflow_tpu_torch.models.mlp import MLPParams
from distributed_tensorflow_tpu_torch.ops import _build

LOG_EPS = 1e-30
STREAM_DTYPES = (torch.float32, torch.bfloat16)


class FusedState(NamedTuple):
    """Parameters with 2-D bias rows, the kernels' layout (as the JAX one)."""

    w1: torch.Tensor  # [in, hidden]
    b1: torch.Tensor  # [1, hidden]
    w2: torch.Tensor  # [hidden, out]
    b2: torch.Tensor  # [1, out]


def to_fused(params: MLPParams) -> FusedState:
    """f32 contiguous copies (the kernels update them in place, so the
    caller's tensors are never aliased)."""
    return FusedState(
        params.w1.detach().to(torch.float32).clone().contiguous(),
        params.b1.detach().to(torch.float32).reshape(1, -1).clone(),
        params.w2.detach().to(torch.float32).clone().contiguous(),
        params.b2.detach().to(torch.float32).reshape(1, -1).clone(),
    )


def from_fused(state: FusedState) -> MLPParams:
    return MLPParams(state.w1, state.b1[0], state.w2, state.b2[0])


def mlp_sgd_math_plain(x, y, w1, b1, w2, b2, lr: float):
    """``_mlp_sgd_math`` in torch ops: forward, the naive cross entropy,
    the analytic backward and the SGD update, all f32. Returns ``(nw1,
    nb1, nw2, nb2, cost)`` as new tensors."""
    z1 = x @ w1 + b1
    h = torch.sigmoid(z1)
    logits = h @ w2 + b2
    p = torch.softmax(logits, dim=-1)
    inv_b = 1.0 / x.shape[0]
    per_example = -torch.sum(y * torch.log(torch.clamp(p, min=LOG_EPS)), dim=-1, keepdim=True)
    cost = torch.sum(per_example) * inv_b
    dlogits = (p - y) * inv_b
    dw2 = h.T @ dlogits
    db2 = torch.sum(dlogits, dim=0, keepdim=True)
    dh = dlogits @ w2.T
    dz1 = dh * h * (1.0 - h)
    dw1 = x.T @ dz1
    db1 = torch.sum(dz1, dim=0, keepdim=True)
    return w1 - lr * dw1, b1 - lr * db1, w2 - lr * dw2, b2 - lr * db2, cost


def _assign(state: FusedState, new) -> FusedState:
    for dst, src in zip(state, new):
        dst.copy_(src)
    return state


def fused_train_step_plain(state: FusedState, x, y, *, learning_rate: float):
    """Plain version of :func:`fused_train_step` (same in-place contract)."""
    *new, cost = mlp_sgd_math_plain(x.float(), y.float(), *state, learning_rate)
    return _assign(state, new), cost


def fused_epoch_plain(state: FusedState, xs, ys, *, learning_rate: float):
    """Plain version of :func:`fused_epoch`: a loop of
    :func:`mlp_sgd_math_plain` over the staged batches, each upcast to f32."""
    params = tuple(state)
    costs = torch.empty(xs.shape[0], dtype=torch.float32, device=xs.device)
    for i in range(xs.shape[0]):
        *params, costs[i] = mlp_sgd_math_plain(
            xs[i].float(), ys[i].float(), *params, learning_rate
        )
    return _assign(state, params), costs


# -- the CUDA kernels ---------------------------------------------------------


def _check(state: FusedState, x, y, what: str):
    """Validate the kernels' inputs; returns (lib, B, IN, H, OUT)."""
    b, in_dim = x.shape[-2], x.shape[-1]
    hidden, out = state.w2.shape
    want = {"w1": (in_dim, hidden), "b1": (1, hidden), "w2": (hidden, out), "b2": (1, out)}
    for name, t in state._asdict().items():
        if t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape) != want[name]:
            raise ValueError(
                f"{what}: state.{name} must be contiguous f32 of shape {want[name]}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
        if t.device != x.device:
            raise ValueError(f"{what}: state.{name} is on {t.device}, the batch on {x.device}")
    if y.shape[:-1] != x.shape[:-1] or y.shape[-1] != out or y.dtype != x.dtype:
        raise ValueError(f"{what}: labels {tuple(y.shape)} {y.dtype} do not match the batch")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"{what}: the batch must be contiguous")
    if out > 32:
        raise ValueError(f"{what}: the kernels take at most 32 classes, got {out}")
    lib = _build.load("fused_mlp")
    lib.mlp_blocks.argtypes = [ctypes.c_int]
    lib.mlp_blocks.restype = ctypes.c_int
    return lib, b, in_dim, hidden, out


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_train_step(state: FusedState, x, y, *, learning_rate: float):
    """One SGD step on the batch ``x`` [B, in], ``y`` [B, out] (f32).

    Updates ``state`` IN PLACE and returns ``(state, cost)`` with ``cost``
    a 0-d f32 tensor."""
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"fused_train_step runs on cuda or cpu, got {x.device}")
        return fused_train_step_plain(state, x, y, learning_rate=learning_rate)
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"fused_train_step takes a 2-D f32 batch, got {x.dtype} {tuple(x.shape)}")
    lib, b, in_dim, hidden, out = _check(state, x, y, "fused_train_step")
    nblk = lib.mlp_blocks(hidden)
    shares = torch.empty(nblk * b * out, dtype=torch.float32, device=x.device)
    cost = torch.empty((), dtype=torch.float32, device=x.device)
    fn = lib.mlp_step
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(
        x.data_ptr(), y.data_ptr(), *(t.data_ptr() for t in state),
        cost.data_ptr(), shares.data_ptr(), b, in_dim, hidden, out,
        learning_rate, _stream(x),
    )
    _build.check(err, "fused_train_step")
    _build.LAUNCHES["fused_mlp_step"] += 1
    return state, cost


def fused_epoch(state: FusedState, xs, ys, *, learning_rate: float):
    """``steps`` SGD steps over staged batches ``xs`` [steps, B, in], ``ys``
    [steps, B, out] (f32 or bf16, upcast in the kernel), one launch.

    Updates ``state`` IN PLACE and returns ``(state, costs [steps] f32)``."""
    if not xs.is_cuda:
        if xs.device.type != "cpu":
            raise ValueError(f"fused_epoch runs on cuda or cpu, got {xs.device}")
        return fused_epoch_plain(state, xs, ys, learning_rate=learning_rate)
    if xs.dtype not in STREAM_DTYPES or xs.dim() != 3:
        raise ValueError(
            f"fused_epoch streams [steps, B, in] f32 or bf16, got {xs.dtype} {tuple(xs.shape)}"
        )
    lib, b, in_dim, hidden, out = _check(state, xs, ys, "fused_epoch")
    steps = xs.shape[0]
    nblk = lib.mlp_blocks(hidden)
    shares = torch.empty(2 * nblk * b * out, dtype=torch.float32, device=xs.device)
    costs = torch.empty(steps, dtype=torch.float32, device=xs.device)
    fn = lib.mlp_epoch
    fn.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    err = fn(
        xs.data_ptr(), ys.data_ptr(), int(xs.dtype == torch.bfloat16),
        *(t.data_ptr() for t in state), costs.data_ptr(), shares.data_ptr(),
        steps, b, in_dim, hidden, out, learning_rate, _stream(xs),
    )
    _build.check(err, "fused_epoch")
    _build.LAUNCHES["fused_mlp_epoch"] += 1
    return state, costs


# -- builders with the JAX package's signatures -------------------------------


def make_fused_train_step(
    *,
    batch_size: int,
    in_dim: int = 784,
    hidden_dim: int = 100,
    out_dim: int = 10,
    learning_rate: float = 0.001,
):
    """``step(state, x, y) -> (state, cost)``: one kernel launch per call
    (in place, see :func:`fused_train_step`)."""

    def step(state: FusedState, x, y):
        if tuple(x.shape) != (batch_size, in_dim) or state.w2.shape != (hidden_dim, out_dim):
            raise ValueError(
                f"step built for batch {batch_size}, {in_dim}->{hidden_dim}->{out_dim}; "
                f"got x {tuple(x.shape)}, w2 {tuple(state.w2.shape)}"
            )
        return fused_train_step(state, x.float(), y.float(), learning_rate=learning_rate)

    return step


def make_fused_scanned_fn(*, batch_size: int, learning_rate: float = 0.001, **dims):
    """``run(state, xs, ys) -> (state, costs)``: the per-step kernel once
    per staged batch (the JAX ``lax.scan`` becomes a loop of launches; the
    costs stay on the device)."""
    step = make_fused_train_step(batch_size=batch_size, learning_rate=learning_rate, **dims)

    def run(state: FusedState, xs, ys):
        costs = torch.empty(xs.shape[0], dtype=torch.float32, device=xs.device)
        for i in range(xs.shape[0]):
            state, costs[i] = step(state, xs[i], ys[i])
        return state, costs

    return run


def make_fused_epoch_fn(
    *,
    steps: int,
    batch_size: int,
    in_dim: int = 784,
    hidden_dim: int = 100,
    out_dim: int = 10,
    learning_rate: float = 0.001,
    stream_dtype: torch.dtype = torch.float32,
):
    """``run(state, xs, ys) -> (state, costs)`` with every staged step in
    ONE launch; batches are streamed in ``stream_dtype`` (cast here when
    staged otherwise) and the update math stays f32."""
    if stream_dtype not in STREAM_DTYPES:
        raise ValueError(f"stream_dtype must be float32 or bfloat16, got {stream_dtype}")
    shape = (steps, batch_size, in_dim)

    def run(state: FusedState, xs, ys):
        if tuple(xs.shape) != shape or state.w2.shape != (hidden_dim, out_dim):
            raise ValueError(f"epoch built for xs {shape}; got {tuple(xs.shape)}")
        return fused_epoch(
            state,
            xs.to(stream_dtype).contiguous(),
            ys.to(stream_dtype).contiguous(),
            learning_rate=learning_rate,
        )

    return run


def make_fused_compiled_run_fn(
    *,
    batch_size: int,
    epochs: int,
    in_dim: int = 784,
    hidden_dim: int = 100,
    out_dim: int = 10,
    learning_rate: float = 0.001,
    shuffle: bool = True,
    stream_dtype: torch.dtype = torch.bfloat16,
):
    """The whole-run path with the epoch kernel:
    ``run(state, train_x, train_y, test_x, test_y, generator) -> (state,
    {"costs": [epochs, steps], "accuracy": [epochs]})``, ``state`` a
    :class:`FusedState` updated in place.

    Each epoch, on the device of ``train_x``: a permutation from
    ``generator`` (``train.compiled_run.wrapped_epoch_perm``), a gather of
    the epoch's batches into ``stream_dtype`` staging, ONE
    :func:`fused_epoch` launch, and an f32 eval of the test split. Costs
    and accuracies stay on the device; the caller fetches them once."""
    from distributed_tensorflow_tpu_torch.ops.losses import accuracy
    from distributed_tensorflow_tpu_torch.train.compiled_run import wrapped_epoch_perm

    def run(state: FusedState, train_x, train_y, test_x, test_y, generator):
        steps = train_x.shape[0] // batch_size  # the tail is dropped
        need = steps * batch_size
        run_epoch = make_fused_epoch_fn(
            steps=steps, batch_size=batch_size, in_dim=in_dim, hidden_dim=hidden_dim,
            out_dim=out_dim, learning_rate=learning_rate, stream_dtype=stream_dtype,
        )
        dev = train_x.device
        fx, fy = train_x.to(stream_dtype), train_y.to(stream_dtype)
        tx, ty = test_x.float(), test_y.float()
        costs = torch.empty((epochs, steps), dtype=torch.float32, device=dev)
        accs = torch.empty(epochs, dtype=torch.float32, device=dev)
        for e in range(epochs):
            perm = wrapped_epoch_perm(
                generator, domain=need, need=need, k=1, shuffle=shuffle, device=dev
            )
            xs = fx.index_select(0, perm).reshape(steps, batch_size, in_dim)
            ys = fy.index_select(0, perm).reshape(steps, batch_size, out_dim)
            state, costs[e] = run_epoch(state, xs, ys)
            h = torch.sigmoid(tx @ state.w1 + state.b1)
            accs[e] = accuracy(h @ state.w2 + state.b2, ty)
        return state, {"costs": costs, "accuracy": accs}

    return run
