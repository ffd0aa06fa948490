"""A rank's share of the data.

Counterpart of ``distributed_tensorflow_tpu/data/sharded.py``. The JAX
package assembles one global array, sharded over the mesh's ``data`` axis,
from each process's rows. Here every rank draws the same global batch from
the identically seeded loader and keeps its own rows of it
(``parallel/mesh.batch_sharded``, by its index along the mesh's ``data``
axis), so the same loader gives every rank its
share of the one global batch the JAX package would assemble.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh, batch_sharded


def global_batch(mesh: Mesh, x, y):
    """This rank's rows ``[i·b, (i+1)·b)`` of the host global batch ``(x,
    y)`` (i its index along ``data``), on the rank's device."""
    rows = batch_sharded(mesh, len(x))
    return (torch.as_tensor(x[rows], device=mesh.device),
            torch.as_tensor(y[rows], device=mesh.device))


def local_shard_for_process(dataset, mesh: Mesh):
    """This rank's static shard of a DataSet (``data/mnist.py``
    ``DataSet.shard``) by its index along ``data``, the analog of the
    reference's independent per-worker batch streams; the dataset
    unchanged for one replica."""
    n = mesh.axis_size("data")
    if n == 1:
        return dataset
    return dataset.shard(n, mesh.axis_index("data"))
