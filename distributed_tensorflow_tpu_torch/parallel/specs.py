"""Sharding layouts as spec trees: the shards a rank keeps, the optimizer
slots' layouts and the update on the shards.

Counterpart of ``distributed_tensorflow_tpu/parallel/specs.py``. A layout
is a tree of the params' shape whose leaves are specs: per leaf, a tuple of
``PartitionSpec`` entries, one a dim, each None or a mesh axis the dim is
split over (trailing dims may be left out; ``()`` is replicated). The JAX
package hands such a tree to GSPMD as ``NamedSharding``s
(``as_shardings``); here a rank holds its block of each leaf as a tensor of
its own, so the torch forms are :func:`shard_tree` (a canonical tree → this
rank's blocks; the block of its index along each axis) and
:func:`gather_tree` (the blocks → the canonical tree, by all-gathers, bit
for bit). :func:`slot_specs` lays each optimizer slot out like the
parameter it tracks, matched by tree-path suffix and shape, never by shape
alone (``wq`` and ``wo`` are both d×d and split on different dims);
:func:`pinned_update` is the update on the local blocks, with the global
norm of global-norm clipping summed over every rank's blocks
(:func:`sharded_squares`).

The JAX package pads a dim that the axis size does not divide; the port
refuses such a layout (:func:`check_layout`) and says which dim.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.ops import optim as optim_lib
from distributed_tensorflow_tpu_torch.ops.collectives import all_gather_raw
from distributed_tensorflow_tpu_torch.ops.optim import tree_leaves, tree_map, tree_unflatten


def spec_leaves(specs) -> list:
    """The spec tuples of a tree of NamedTuples whose leaves are spec
    tuples (``tree_leaves`` would open the specs themselves)."""
    if hasattr(specs, "_fields"):
        return [s for sub in specs for s in spec_leaves(sub)]
    return [specs]


def aligned_specs(tree, specs) -> list:
    """The spec of each leaf of ``tree`` in ``tree_leaves`` order, walking
    ``specs`` along the tree (so an empty optimizer state has no spec)."""
    if isinstance(tree, tuple):
        return [s for sub, sp in zip(tree, specs) for s in aligned_specs(sub, sp)]
    return [specs]


def tree_paths(tree, prefix: tuple = ()) -> list:
    """Each leaf's path of keys (NamedTuple field names, else indices), in
    ``tree_leaves`` order."""
    if isinstance(tree, tuple):
        fields = getattr(tree, "_fields", None)
        return [p for i, sub in enumerate(tree)
                for p in tree_paths(sub, prefix + ((fields[i] if fields else i),))]
    return [prefix]


def _split(spec, axes):
    """(dim, axis) of each dim ``spec`` splits, over ``axes`` only when given."""
    return [(d, e) for d, e in enumerate(spec) if e is not None and (axes is None or e in axes)]


def check_layout(params, specs, mesh) -> None:
    """Refuse a layout whose axis sizes do not divide the dims they split
    (the JAX package pads them; the port does not), naming the leaf."""
    for path, leaf, spec in zip(tree_paths(params), tree_leaves(params),
                                aligned_specs(params, specs)):
        for d, e in _split(spec, None):
            if e not in mesh.shape:
                raise ValueError(f"mesh has no {e!r} axis: {dict(mesh.shape)}")
            n = mesh.axis_size(e)
            if leaf.shape[d] % n:
                raise ValueError(
                    f"{'.'.join(map(str, path))}: dim {d} of size {leaf.shape[d]} does not "
                    f"split over the {n}-way {e!r} axis; the port's sharded layouts need "
                    "the axis size to divide every dim they split (the JAX package pads it)")


def shard_leaf(t, spec, mesh, axes=None):
    """This rank's block of ``t`` under ``spec`` (only the dims split over
    ``axes`` when given), a tensor of its own."""
    parts = _split(spec, axes) if isinstance(t, torch.Tensor) else []
    for d, e in parts:
        n = mesh.axis_size(e)
        if t.shape[d] % n:
            raise ValueError(f"a size of {t.shape[d]} does not split over the {n}-way {e!r} "
                             "axis")
        m = t.shape[d] // n
        t = t.narrow(d, mesh.axis_index(e) * m, m)
    return t.clone() if parts else t


def gather_leaf(t, spec, mesh, axes=None):
    """The whole of a leaf from every rank's block (all-gathers along the
    split dims, bit for bit). A collective over those axes."""
    if isinstance(t, torch.Tensor):
        for d, e in _split(spec, axes):
            t = all_gather_raw(t, mesh, e, d)
    return t


def map_split(tree, specs, fn):
    """``fn`` on the leaves of ``tree`` that ``specs`` splits, the others as
    they are (the staged blocks and their slots of a pipeline layout)."""
    return tree_unflatten(tree, [fn(t) if sp else t for t, sp in
                                 zip(tree_leaves(tree), aligned_specs(tree, specs))])


def shard_tree(tree, specs, mesh, axes=None):
    """:func:`shard_leaf` over a tree (params, or an optimizer state with
    its :func:`slot_specs`)."""
    return tree_unflatten(tree, [shard_leaf(t, sp, mesh, axes) for t, sp in
                                 zip(tree_leaves(tree), aligned_specs(tree, specs))])


def gather_tree(tree, specs, mesh, axes=None):
    """:func:`gather_leaf` over a tree."""
    return tree_unflatten(tree, [gather_leaf(t, sp, mesh, axes) for t, sp in
                                 zip(tree_leaves(tree), aligned_specs(tree, specs))])


def slot_specs(optimizer, params, param_specs):
    """Specs for ``optimizer``'s state over ``params`` (any layout; only
    its structure and shapes are read, the state built on the meta
    device): :func:`match_slot_specs` of that state."""
    opt = optimizer.init(tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), params))
    return match_slot_specs(opt, params, param_specs)


def match_slot_specs(opt_state, params, param_specs):
    """Specs for an optimizer state over ``params`` of the same layout:
    each slot laid out like the parameter it tracks, matched by tree-path
    suffix and shape (the slot subtrees mirror the params tree),
    everything else replicated."""
    items = [(path, tuple(leaf.shape), spec) for path, leaf, spec in
             zip(tree_paths(params), tree_leaves(params), aligned_specs(params, param_specs))]

    def slot_spec(path, leaf):
        if isinstance(leaf, torch.Tensor):
            for ppath, pshape, spec in items:
                if tuple(leaf.shape) == pshape and path[-len(ppath):] == ppath:
                    return spec
        return ()

    return tree_unflatten(opt_state, [slot_spec(p, leaf) for p, leaf in
                                      zip(tree_paths(opt_state), tree_leaves(opt_state))])


def sharded_squares(mesh, specs: list):
    """The sum of squares ``global_norm`` takes for gradients laid out as
    ``specs`` (one a leaf): the leaves split over a set of axes summed,
    then added over those axes; a replicated leaf counted once."""

    def squares(grads):
        parts: dict = {}
        for g, spec in zip(tree_leaves(grads), specs):
            key = tuple(sorted({e for e in spec if e is not None}))
            parts[key] = parts.get(key, 0) + torch.sum(g * g)
        total = 0
        for axes, s in parts.items():
            if axes:
                s = mesh.all_reduce_(s.reshape(1).clone(), axes)[0]
            total = total + s
        return total

    return squares


def pinned_update(optimizer, params, opt_state, grads, mesh, specs):
    """The update on this rank's blocks: ``optimizer.update`` is elementwise
    but for global-norm clipping, whose norm sums every rank's blocks.
    Returns ``(params, opt_state)``."""
    with torch.no_grad(), optim_lib.squares_over(
            sharded_squares(mesh, aligned_specs(params, specs))):
        return optimizer.update(grads, opt_state, params)
