"""Device-mesh sharding for the cell axis.

The reference's only parallelism is a dask.delayed task per grid cell
(reference: xmhw/xmhw.py:182-197, 437-454). The replacement here: all
arrays carry a trailing dense ``cell`` axis, sharded over a 1-D device mesh
with ``NamedSharding``. Every kernel in :mod:`xmhw_tpu.core` is elementwise
or scan/reduce along the *time/doy* axes only, so XLA partitions the whole
pipeline with **zero collectives** — communication happens only if/when the
caller gathers outputs to the host. This is the layout recommended by the
scaling playbook: pick the mesh, annotate shardings, let XLA do the rest.

Multi-host note: the same code runs under ``jax.distributed`` with a global
mesh; cells are globally sharded and each host feeds its addressable shard.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CELL_AXIS = "cells"


def cell_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or given) devices, axis name 'cells'."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (CELL_AXIS,))


def cell_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Shard the trailing (cell) axis; leading axes replicated."""
    spec = [None] * (ndim - 1) + [CELL_AXIS]
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_cells(arr: np.ndarray, multiple: int, fill=np.nan):
    """Pad the trailing cell axis to a multiple (NaN = land, dropped on
    output). Returns (padded, original_count)."""
    c = arr.shape[-1]
    target = -(-c // multiple) * multiple
    if target == c:
        return arr, c
    pad = [(0, 0)] * (arr.ndim - 1) + [(0, target - c)]
    return np.pad(arr, pad, constant_values=fill), c


def make_cell_array(mesh: Mesh, global_shape, fill_fn, ndim=None):
    """Build a cell-sharded GLOBAL array, each process feeding only its
    addressable shards.

    ``fill_fn(index_tuple) -> np.ndarray`` supplies the data for one
    shard (called once per addressable shard with the global index
    slices). This is the multi-host input path: under
    ``jax.distributed`` each host reads only its own cell stripes from
    disk (e.g. via stream.GridReader hyperslabs) and never materializes
    the global grid — the analogue of the reference's manual per-block
    splitting (reference: docs/dask.rst:44-86) across hosts. On a
    single process it degenerates to a plain sharded device_put.
    Exercised by tools/multihost_dryrun.py (2-process gloo CPU run).
    """
    ndim = ndim if ndim is not None else len(global_shape)
    sharding = cell_sharding(mesh, ndim)
    return jax.make_array_from_callback(tuple(global_shape), sharding,
                                        fill_fn)
