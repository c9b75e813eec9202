"""Multi-device sharding of the barrier solver.

The reference is a single-process solver shaped for an out-of-tree
row-partitioned MPI backend (``src/mgb.jl:393-403``); here the distributed
story is jax.sharding over a 1-D device mesh: the node/element axes of
every per-node grid, panel tensor, and operator-value array shard across
devices, XLA inserts the all-reduce/scatter collectives for the segment-sum
assembly and the reductions, and the small level-coefficient vectors and
dense Newton systems stay replicated.

Usage:
    mesh = make_mesh(8)
    sol = mgb_solve(prob, mesh=mesh)

Every array whose leading (or element-count) axis is divisible by the mesh
size shards along it; everything else replicates. With GSPMD the same jitted
Newton program runs un-sharded on one device and sharded on many.
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "nodes"


def make_mesh(n_devices=None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), axis_names=(AXIS,))


def node_sharding(mesh: Mesh, a, shard_sizes) -> NamedSharding:
    """Sharding for one array: the first axis whose size is in
    ``shard_sizes`` (node count, element count) and divides the mesh shards;
    everything else replicates."""
    n = mesh.devices.size
    a = np.asarray(a) if not hasattr(a, "shape") else a
    spec = [None] * a.ndim
    for ax, sz in enumerate(a.shape):
        if sz in shard_sizes and sz % n == 0:
            spec[ax] = AXIS
            break
    return NamedSharding(mesh, P(*spec))


def shard_fargs(mesh: Mesh, fargs, n_nodes: int, n_elems: int):
    """device_put a Newton fargs pytree with node/element axes sharded."""
    sizes = {n_nodes, n_elems}

    def put(a):
        return jax.device_put(a, node_sharding(mesh, a, sizes))

    return jax.tree_util.tree_map(put, fargs)
