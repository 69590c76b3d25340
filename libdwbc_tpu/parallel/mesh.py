"""Multi-device scaling: scenario-batch sharding over a device mesh.

The reference is a single-core controller (SURVEY.md §2.2 — no DP/TP/PP/
collectives anywhere).  This framework's scaling axis is the **scenario
batch**: thousands of control problems (contact-mode hypotheses,
disturbance rollouts, gait phases) solved per step, sharded over a 2-D mesh

    ('hyp', 'roll')  — hypothesis axis × rollout axis

with XLA collectives (argmin reductions) selecting the best hypothesis.
Every GPU of a host reaches every other at the same NVLink rate, so the
mesh is a plain reshape of the device list.  Within a scenario everything
is tiny (39-dof) — there is nothing to tensor-parallelize per problem;
devices are filled by batching, exactly the regime BASELINE.json's north
star describes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import mesh_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_hyp: int | None = None, n_roll: int | None = None, devices=None):
    """Create a 2-D ('hyp','roll') mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_hyp is None or n_roll is None:
        # squarest factorization
        n_hyp = 1
        for f in range(int(np.sqrt(n)), 0, -1):
            if n % f == 0:
                n_hyp = f
                break
        n_roll = n // n_hyp
    dev_mesh = np.asarray(devices, dtype=object).reshape(n_hyp, n_roll)
    return Mesh(dev_mesh, ("hyp", "roll"))


def sharded_batch_solver(tick_impl, mesh: Mesh):
    """Shard a (H, R, ...) scenario grid over the mesh and solve every tick,
    returning all torques plus the globally best hypothesis per metric.

    tick_impl: unbatched pure tick (q, qdot, fstars) -> TickResult.
    Returns jitted fn (q[H,R,nq], qdot[H,R,n], fstars tuple of [H,R,t])
    -> (TickResult batched, best_idx, best_cost).

    The best-hypothesis reduction is a real cross-device collective (global
    argmin over both mesh axes).
    """
    vtick = jax.vmap(jax.vmap(tick_impl, in_axes=(0, 0, 0)), in_axes=(0, 0, 0))

    def step(q, qdot, fstars):
        res = vtick(q, qdot, fstars)
        # scenario cost: command effort + constraint violation penalty
        cost = jnp.sum(res.torque_cmd**2, axis=-1) + 1e6 * res.qp_primal_res
        flat = cost.reshape(-1)
        best = jnp.argmin(flat)
        return res, best, flat[best]

    in_sharding = NamedSharding(mesh, P("hyp", "roll"))
    # prefix-pytree sharding: the fstars tuple inherits the same spec per leaf
    return jax.jit(
        step, in_shardings=(in_sharding, in_sharding, in_sharding)
    ), in_sharding


def sharded_tick_step(tick_impl, mesh: Mesh, **tick_kw):
    """One batched tick with its batch split over BOTH mesh axes.

    tick_impl: a batched tick (B, ...) -> TickResult (CompiledTick,
    MaskedTick or FusedTick — shard_map hands each device its local shard,
    so the tick is never partitioned by XLA).
    Returns jitted fn (q, qdot, fstars[, contact_mask]) -> (torque_cmd,
    best_idx, best_cost): the best scenario by command effort plus
    constraint-violation penalty, a cross-device argmin.
    """
    spec = P(("hyp", "roll"))

    def local(*args):
        r = tick_impl(*args, **tick_kw)
        cost = jnp.sum(r.torque_cmd**2, axis=-1) + 1e6 * r.qp_primal_res
        return r.torque_cmd, cost

    def step(*args):
        tau, cost = jax.shard_map(
            local, mesh=mesh, in_specs=spec, out_specs=(spec, spec),
            check_vma=False,
        )(*args)
        i = jnp.argmin(cost)
        return tau, i, cost[i]

    return jax.jit(step)


def shard_scenarios(mesh: Mesh, *arrays):
    """Device-put (H,R,...) arrays with the ('hyp','roll') sharding."""
    sh = NamedSharding(mesh, P("hyp", "roll"))
    return tuple(jax.device_put(a, sh) for a in arrays)


# ---------------------------------------------------------------------------
# Multi-host entry point (BASELINE north star: ≥80% linear solves/s scaling
# to 2+ hosts).  The reference has no distributed code at all (SURVEY.md
# §2.2); here the same ('hyp','roll') scenario mesh is laid out so that the
# 'roll' axis crosses hosts while 'hyp' stays within a host.  Per-scenario
# work never communicates; the only cross-host traffic is the scalar argmin
# reduction in sharded_batch_solver.
# ---------------------------------------------------------------------------

def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None):
    """Initialize the JAX multi-process runtime (idempotent).

    With no arguments, relies on the standard cluster env detection
    (JAX_COORDINATOR_ADDRESS & friends).  Safe to call in
    a single-process run: if no cluster is configured and no coordinator is
    given, it is a no-op returning False.
    """
    # Must not touch the backend before initialize (jax.process_count()
    # would initialise XLA and make initialize() raise).  Prefer the public
    # probe where this JAX version has one; fall back to the private client
    # state (pre-is_initialized versions) without letting an API change in
    # either spot break the import.
    try:
        if jax.distributed.is_initialized():
            return True
    except AttributeError:
        try:
            from jax._src import distributed as _dist

            if getattr(_dist.global_state, "client", None) is not None:
                return True  # already initialized
        except Exception:
            pass
    env_configured = any(
        k in __import__("os").environ
        for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
    )
    if coordinator is None and num_processes is None and not env_configured:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def make_global_mesh(n_hyp: int | None = None):
    """('hyp','roll') mesh over ALL processes' devices.

    Multi-host: 'roll' spans the processes so each host owns whole
    hypothesis columns; within a host, devices fill the 'hyp' axis.
    Single-process: identical to make_mesh().
    """
    nproc = jax.process_count()
    if nproc == 1:
        return make_mesh(n_hyp=n_hyp)
    per_host = jax.local_device_count()
    if n_hyp is None:
        n_hyp = per_host  # hypotheses within a host, rollouts across hosts
    assert per_host % n_hyp == 0, (n_hyp, per_host)
    dev_mesh = mesh_utils.create_hybrid_device_mesh(
        (n_hyp, per_host // n_hyp), (1, nproc), devices=jax.devices(),
        process_is_granule=True,
    )
    return Mesh(dev_mesh, ("hyp", "roll"))


def host_local_scenarios(mesh: Mesh, make_local):
    """Build global (H, R, ...) arrays from per-process local shards.

    make_local(h_slice, r_slice) -> tuple of np arrays for THIS process's
    block of the global scenario grid (each (h_len, r_len, ...)).  Returns
    globally-sharded jax.Arrays — the multi-host-safe replacement for
    shard_scenarios (which device_puts full arrays and only works when every
    process holds the whole grid).
    """
    sh = NamedSharding(mesh, P("hyp", "roll"))
    H = mesh.shape["hyp"]
    R = mesh.shape["roll"]

    # this process's index block: derive from its local devices' positions
    local_devs = set(jax.local_devices())
    coords = np.argwhere(
        np.vectorize(lambda d: d in local_devs)(mesh.devices)
    )
    h0, r0 = coords.min(axis=0)
    h1, r1 = coords.max(axis=0) + 1
    locals_ = make_local(slice(int(h0), int(h1)), slice(int(r0), int(r1)))

    def to_global(a):
        a = np.asarray(a)
        gshape = (H * a.shape[0] // (h1 - h0), R * a.shape[1] // (r1 - r0)) + a.shape[2:]
        return jax.make_array_from_process_local_data(sh, a, gshape)

    return tuple(to_global(a) for a in locals_)
