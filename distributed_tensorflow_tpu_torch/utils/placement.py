"""Placement verification (the reference's ``log_device_placement``).

Counterpart of ``distributed_tensorflow_tpu/utils/placement.py``. The JAX
package reads each array's sharding; a tensor here lives whole on one
rank's device, so the layout is the strategy's to say
(``Strategy.placement_specs``: per leaf, the mesh axes its dims are split
over, as ``PartitionSpec`` entries: ``data`` under ZeRO, ``model`` under
tensor parallelism, both under ZeRO over a tensor-parallel base).
:func:`describe` prints one line a leaf in the JAX wording, with the
leaf's global shape; :func:`assert_replicated` checks across the ranks
that every rank holds the same leaves, and :func:`assert_sharded_over`
that a layout splits some leaf over an axis.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves
from distributed_tensorflow_tpu_torch.parallel.specs import spec_leaves


def _spec_repr(spec) -> str:
    """A spec as a JAX array's sharding prints it (trailing Nones dropped)."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    inner = ", ".join(repr(e) for e in spec)
    return f"PartitionSpec({inner}{',' if len(spec) == 1 else ''})"


def _global_shape(leaf, spec, mesh, stacked: bool) -> tuple:
    """A leaf's shape across the ranks: a copy a rank of ``data`` stacked
    on a leading axis, or each split dim its axis size times the block."""
    if stacked:
        return (1 if mesh is None else mesh.axis_size("data"), *leaf.shape)
    return tuple(s if e is None or mesh is None else s * mesh.axis_size(e)
                 for s, e in zip(leaf.shape, list(spec) + [None] * leaf.dim()))


def describe(tree, *, specs=None, mesh=None, stacked=False, print_fn=print) -> list[str]:
    """Print (and return) one line per leaf of the NamedTuple ``tree``:
    path, global shape, dtype, spec and the number of devices holding
    it. ``specs`` (default: all replicated) matches ``tree``; ``mesh``
    gives the axis sizes and the device count (default one device);
    ``stacked``: each rank holds its own copy (async), the global array
    stacks them."""
    n = 1 if mesh is None else mesh.size
    leaves = tree_leaves(tree)
    specs = [()] * len(leaves) if specs is None else spec_leaves(specs)
    lines = []
    for name, leaf, spec in zip(_paths(tree), leaves, specs):
        if not isinstance(leaf, torch.Tensor):
            lines.append(f"{name}: (non-array) {type(leaf).__name__}")
            continue
        dtype = str(leaf.dtype).replace("torch.", "")
        lines.append(
            f"{name}: shape={_global_shape(leaf, spec, mesh, stacked)} dtype={dtype} "
            f"spec={_spec_repr(spec)} devices={n}"
        )
    for line in lines:
        print_fn(line)
    return lines


def describe_state(strategy, params, *, print_fn=print) -> list[str]:
    """:func:`describe` of a strategy's parameters with its layout."""
    return describe(params, specs=strategy.placement_specs(params), mesh=strategy.mesh,
                    stacked=strategy.layout_meta()["mode"] == "async", print_fn=print_fn)


def _paths(tree, prefix: str = "") -> list[str]:
    """JAX ``keystr`` paths of a tree of NamedTuples: ``.w1``, ``.mu.w1``."""
    if isinstance(tree, tuple):
        fields = getattr(tree, "_fields", None)
        out = []
        for i, sub in enumerate(tree):
            key = f".{fields[i]}" if fields else f"[{i}]"
            out += _paths(sub, prefix + key)
        return out
    return [prefix]


def assert_replicated(tree, mesh) -> None:
    """Assert every rank of ``mesh`` holds the same leaves (the pure-DP
    invariant; tensor-parallel blocks differ). Collective: every rank
    calls it."""
    for name, leaf in zip(_paths(tree), tree_leaves(tree)):
        if not isinstance(leaf, torch.Tensor):
            continue
        hi = mesh.all_reduce_(leaf.detach().clone(), None, "max")
        lo = mesh.all_reduce_(leaf.detach().clone(), None, "min")
        if not torch.equal(hi, lo):
            raise AssertionError(
                f"{name} is not replicated: its values differ across the {mesh.size} ranks"
            )


def assert_sharded_over(specs, axis: str) -> None:
    """Assert at least one leaf of a spec tree is split over ``axis``
    (guards against silently replicated 'sharded' runs)."""
    for spec in spec_leaves(specs):
        if axis in spec:
            return
    raise AssertionError(f"no leaf is sharded over axis {axis!r}")
