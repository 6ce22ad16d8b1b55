"""Multi-HOST runtime: jax.distributed + global (view, tile) meshes.

The reference's only cross-process mechanism is the filesystem — run.sh
`mv`s depthmap/normalmap dirs between stages, and each DensifyPointCloud
process is single-node pthreads/OpenMP (ref: /root/reference/run.sh:1-20,
frame_main/libs/MVS/SceneDensify.cpp:3984-3992).  The batched
replacement is a multi-process JAX runtime: every host joins one
coordination service, the scene shards over a GLOBAL (view, tile) mesh
spanning all hosts' chips, and the cross-view reads of the geometric
phase / fusion become GSPMD collectives riding ICI within a host and DCN
across hosts (SURVEY §5.8).

Process-locality: the view axis is laid out so each host's local devices
form contiguous view rows — a view's sweep stays on-host; only the
neighbor-map snapshots and fusion reprojections cross hosts.

CI story (no pod slice in this container): 2 processes x 4 virtual CPU
devices each, collectives over Gloo — tests/test_multihost.py runs
scene_sweeps + the fusion filter under a global mesh and value-checks
against single-process execution.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the multi-host coordination service (idempotent).

    With no arguments, reads HCMVS_COORDINATOR / HCMVS_NUM_PROCESSES /
    HCMVS_PROCESS_ID (or defers entirely to jax's own cluster
    autodetection on managed clusters, where
    jax.distributed.initialize() needs no arguments).  Single-process
    runs (num_processes in (None, 0, 1) and no env) are a no-op.
    """
    if jax.distributed.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get(
        "HCMVS_COORDINATOR")
    if num_processes is None and "HCMVS_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["HCMVS_NUM_PROCESSES"])
    if process_id is None and "HCMVS_PROCESS_ID" in os.environ:
        process_id = int(os.environ["HCMVS_PROCESS_ID"])
    if coordinator_address is None and not num_processes:
        return                          # single-process mode
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(n_tile: int = 1) -> Mesh:
    """(view, tile) mesh over ALL processes' devices, view-major in
    process order so each view row's devices are host-local (ICI inside a
    row; the cross-view collectives are what cross hosts)."""
    devices = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n_view = len(devices) // n_tile
    devs = np.asarray(devices[:n_view * n_tile]).reshape(n_view, n_tile)
    return Mesh(devs, axis_names=("view", "tile"))


def make_global(x, sharding: NamedSharding):
    """Build a global jax.Array from process-replicated host data (every
    process passes the SAME full array; each contributes its addressable
    shards)."""
    if x is None:
        return None
    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, sharding,
                                        lambda idx: x[idx])


def distribute_scene(scene, state, mesh: Mesh):
    """Multi-host variant of parallel.sharding.shard_scene: the host-side
    scene (replicated on every process) becomes global sharded arrays."""
    from hcmvs_tpu.parallel.sharding import _match_tree, scene_shardings
    t_shard, s_shard = scene_shardings(mesh)
    scene_g = jax.tree.map(make_global, scene, _match_tree(t_shard, scene),
                           is_leaf=lambda x: x is None)
    state_g = jax.tree.map(make_global, state, _match_tree(s_shard, state),
                           is_leaf=lambda x: x is None)
    return scene_g, state_g


def fetch(x) -> np.ndarray:
    """Gather a (possibly non-addressable) global array to every host:
    reshard to fully-replicated (an all-gather collective), then read the
    now-addressable local copy."""
    if not (isinstance(x, jax.Array) and not x.is_fully_addressable):
        return np.asarray(x)
    mesh = x.sharding.mesh
    repl = NamedSharding(mesh, P())
    y = jax.jit(lambda a: a, out_shardings=repl)(x)
    return np.asarray(y.addressable_data(0))


def replicated(mesh: Mesh, x):
    """Place host data replicated over the global mesh."""
    return make_global(x, NamedSharding(mesh, P()))
