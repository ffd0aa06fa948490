"""A rank's share of the data.

Counterpart of ``distributed_tensorflow_tpu/data/sharded.py``. The JAX
package assembles one global array, sharded over the mesh's ``data`` axis,
from each process's rows. Here every rank draws the same global batch from
the identically seeded loader and keeps its own rows of it
(``parallel/mesh.batch_sharded``), so the same loader gives every rank its
share of the one global batch the JAX package would assemble.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.parallel.mesh import World, batch_sharded


def global_batch(world: World, x, y):
    """This rank's rows ``[r·b, (r+1)·b)`` of the host global batch ``(x,
    y)``, on the rank's device."""
    rows = batch_sharded(world, len(x))
    return (torch.as_tensor(x[rows], device=world.device),
            torch.as_tensor(y[rows], device=world.device))


def local_shard_for_process(dataset, world: World):
    """This rank's static shard of a DataSet (``data/mnist.py``
    ``DataSet.shard``), the analog of the reference's independent
    per-worker batch streams; the dataset unchanged for one rank."""
    if world.size == 1:
        return dataset
    return dataset.shard(world.size, world.rank)
