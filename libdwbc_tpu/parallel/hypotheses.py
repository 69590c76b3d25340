"""Contact-mode hypothesis sweep: one compiled graph, per-scenario modes.

The reference switches contact modes by resizing matrices at runtime
(``SetContact`` booleans → new J_C shape, include/dwbc.h:432-474) — one mode
per process, recompute everything on change.  This engine instead
compiles the tick for EVERY contact mode up front (a handful of static
branches) and selects per scenario with ``lax.switch``; outputs are padded
to the largest mode.  Combined with the scenario batch this realizes
BASELINE.json's 4096-hypothesis sweep: thousands of (contact-mode ×
disturbance) hypotheses evaluated per step, best one selected by a
cross-device argmin when sharded over a mesh.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..model.compile import RobotModel
from ..wbc import types as T
from ..wbc.pipeline import CompiledTick, PipelineConfig


def contact_mode_ticks(
    model: RobotModel,
    contacts: Sequence[T.ContactDef],
    task_specs,
    torque_limit,
    qp_iters: int = 12,
    dtype=jnp.float32,
    min_active: int = 1,
):
    """One CompiledTick per contact-mode subset (≥ min_active contacts)."""
    modes = []
    ticks = []
    n = len(contacts)
    for bits in itertools.product([True, False], repeat=n):
        if sum(bits) < min_active:
            continue
        active = tuple(c for c, b in zip(contacts, bits) if b)
        cfg = PipelineConfig(
            contacts=active,
            task_specs=tuple(tuple(s) for s in task_specs),
            torque_limit=torque_limit,
            qp_iters=qp_iters,
        )
        modes.append(bits)
        ticks.append(CompiledTick(model, cfg, dtype=dtype))
    return modes, ticks


def make_hypothesis_tick(model: RobotModel, modes, ticks, dtype=jnp.float32):
    """(mode_idx, q, qdot, fstars) → padded TickResult via lax.switch.

    All branches share the same kinematics code; XLA compiles each branch
    once.  Contact-force outputs are padded to the largest mode's width.
    """
    mdof = model.model_dof
    max_c = max(6 * sum(m) for m in modes)

    def branch(tick):
        def run(q, qdot, fstars):
            res = tick._tick_impl(q, qdot, fstars)
            cf = res.contact_force
            pad = max_c - cf.shape[-1]
            if pad:
                cf = jnp.concatenate(
                    [cf, jnp.zeros(cf.shape[:-1] + (pad,), dtype=cf.dtype)], axis=-1
                )
            return (
                res.torque_cmd, res.torque_grav, res.torque_task,
                res.torque_contact, cf, res.qp_gap, res.qp_primal_res,
            )
        return run

    branches = [branch(t) for t in ticks]

    def tick_fn(mode_idx, q, qdot, fstars):
        return jax.lax.switch(mode_idx, branches, q, qdot, fstars)

    return tick_fn


def hypothesis_sweep(
    model: RobotModel, modes, ticks,
    mode_idx, q, qdot, fstars,
    cost_weights=(1.0, 1e6),
):
    """Batched sweep: per-scenario contact-mode index + state + tasks.

    mode_idx (B,), q (B,nq), qdot (B,n), fstars tuple of (B,t).
    Returns (torque_cmd (B,m), cost (B,), best index) — cost is command
    effort + infeasibility penalty (the hypothesis-selection metric).
    """
    tick_fn = make_hypothesis_tick(model, modes, ticks)
    vt = jax.vmap(tick_fn, in_axes=(0, 0, 0, 0))
    tau, tg, tt, tc, cf, gap, pres = vt(mode_idx, q, qdot, fstars)
    w_eff, w_pen = cost_weights
    cost = w_eff * jnp.sum(tau**2, axis=-1) + w_pen * pres
    best = jnp.argmin(cost)
    return tau, cost, best
