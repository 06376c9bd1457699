"""True multi-host (multi-process) execution of the sharded EM.

parallel/mesh.py validates the sharded-EM collective mechanics on a
single-process virtual mesh; this module runs the same step across
*processes*: one JAX process per host, `jax.distributed.initialize`
against a coordinator, a global mesh spanning every host's devices,
per-host incidence shards assembled into a global array with
`jax.make_array_from_process_local_data`, and the per-EC expected
counts merged by the in-step `psum`.  Invoked explicitly; it is tested
on CPU processes only, not on GPUs.

Reference behavior contract: the reference is single-node pthreads
(SURVEY.md section 2.4); here the EM sufficient statistics are the
only cross-host traffic in the hot loop.

Each host calls `em_quantify_multihost` collectively with the FULL
incidence problem (the global arrays are small host-side metadata;
read-group shards are cut identically on every host so each host only
uploads its own slice to its local devices).  The result is replicated:
every process returns the same abundance vector.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def initialize_from_env() -> int:
    """Connect this process to the multi-host cluster described by
    T1K_COORDINATOR / T1K_NUM_PROCESSES / T1K_PROCESS_ID (or JAX's own
    cluster auto-detection when unset).  Returns the process index."""
    import jax

    coord = os.environ.get("T1K_COORDINATOR")
    if coord:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["T1K_NUM_PROCESSES"]),
            process_id=int(os.environ["T1K_PROCESS_ID"]),
        )
    else:
        jax.distributed.initialize()
    return jax.process_index()


def global_data_mesh(axis: str = "dp"):
    """One data axis over every device of every process, in process-major
    order so contiguous read-group shards land on contiguous hosts."""
    import jax
    from jax.sharding import Mesh

    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devs), (axis,))


def em_quantify_multihost(
    seg_rg: np.ndarray,
    seg_ec: np.ndarray,
    counts: np.ndarray,
    rg_cnt: int,
    ec_len: np.ndarray,
    init_x: np.ndarray,
    iterations: int = 50,
    axis: str = "dp",
    mesh=None,
):
    """Collective multi-process EM quantification (plain EM updates, the
    multi-host analog of mesh.em_quantify_sharded).  Every participating
    process must call this with identical arguments; returns the
    replicated abundance vector as a NumPy array."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .mesh import partition_read_groups, sharded_em_step

    if mesh is None:
        mesh = global_data_mesh(axis)
    n = mesh.devices.size
    ec_cnt = len(init_x)
    (_, sec, _, secs_sorted, srgo, ctso, srgs, srge, secs, sece) = (
        partition_read_groups(seg_rg, seg_ec, counts, rg_cnt, n,
                              ec_cnt=ec_cnt))

    step = sharded_em_step(mesh, axis)

    def run_step(x, sec_s, secs_s, srgo_s, ctso_s, rgs_s, rge_s, ecs_s,
                 ece_s, ec_len_r):
        x1, _ = step(x, sec_s.reshape(-1), secs_s.reshape(-1),
                     srgo_s.reshape(-1), ctso_s.reshape(-1),
                     rgs_s.reshape(-1), rge_s.reshape(-1),
                     ecs_s.reshape(-1), ece_s.reshape(-1), ec_len_r)
        return x1

    import functools
    run_step = jax.jit(
        jax.shard_map(
            run_step, mesh=mesh,
            in_specs=(P(), P(axis, None), P(axis, None), P(axis, None),
                      P(axis, None), P(axis, None), P(axis, None),
                      P(axis, None), P(axis, None), P()),
            out_specs=P()),
        donate_argnums=(0,))

    def put_sharded(arr):
        """Upload the device-sharded rows: each process only touches the
        rows destined for its local devices."""
        sharding = NamedSharding(mesh, P(axis, None))
        return jax.make_array_from_process_local_data(
            sharding, arr, arr.shape)

    def put_replicated(arr):
        sharding = NamedSharding(mesh, P())
        return jax.make_array_from_process_local_data(
            sharding, arr, arr.shape)

    f32 = lambda a: np.asarray(a, np.float32)
    args = (put_sharded(sec), put_sharded(secs_sorted), put_sharded(srgo),
            put_sharded(f32(ctso)), put_sharded(srgs), put_sharded(srge),
            put_sharded(secs), put_sharded(sece))
    ec_len_d = put_replicated(f32(ec_len))
    x0 = f32(init_x)
    x = put_replicated(x0 / x0.sum())
    for _ in range(iterations):
        x = run_step(x, *args, ec_len_d)
    # fully-replicated output: every process holds the whole vector
    return np.asarray(jax.device_get(
        x.addressable_shards[0].data)).reshape(x.shape)
