"""Persistent on-device control loop: the single-lane serving shape.

The reference's 1 kHz loop is host code calling the controller every tick
(tests/test_thread.cpp). On an accelerator, a host↔device round trip and
a launch per tick would dominate the tick itself, so the serving shape
is a **persistent on-device loop**: K control ticks run inside one
`lax.scan`, with the robot state advanced on device between ticks by a
user-supplied transition function (a simulator step, a state-estimate
ingest from a device buffer, or a simple hold). The host only refills task
targets / reads torque logs at the K-tick cadence.

This is also the honest way to measure device-side tick latency (see
bench.py): the scan forces strict serialization of the ticks.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .pipeline import CompiledTick


class LoopResult(NamedTuple):
    q_final: jnp.ndarray
    qdot_final: jnp.ndarray
    torques: jnp.ndarray        # (K, ..., model_dof)
    qp_primal_res: jnp.ndarray  # (K, ...)
    qp_error: jnp.ndarray       # (K, ...) per-lane per-tick failure flags —
    # the loop serves whatever the tick produced; the caller decides the
    # hold/zero policy per flagged lane (the reference aborts and returns 0,
    # src/dwbc.cpp:836-846; RobotData.GetControlTorque does the same)


def _advance_servos(servos, tk):
    """Shift every ServoParams clock by tk (the on-device analog of the
    reference's control_time_ advancing between UpdateTaskSpace calls,
    src/dwbc.cpp:685-793).  servos is the nested per-level/per-link tuple
    accepted by CompiledTick; None entries pass through."""
    if servos is None:
        return None
    return tuple(
        None
        if lvl is None
        else tuple(None if sp is None else sp._replace(t=sp.t + tk) for sp in lvl)
        for lvl in servos
    )


def default_transition(model):
    """Semi-implicit integration of the commanded accelerations under the
    no-contact-motion assumption: q̇ ← q̇ (held), q ← q (held). A pure hold —
    use a simulator step for closed-loop rollouts."""

    def step(q, qdot, res, dt):
        return q, qdot

    return step


def forward_dynamics_transition(tick: CompiledTick):
    """Closed-loop transition using the engine's own dynamics:
    q̈ = A⁻¹(Sᵀτ + J_Cᵀf_c − B) evaluated at the current state, integrated
    semi-implicitly, with the floating base quaternion advanced on the
    manifold.  A minimal on-device simulator for rollout sweeps."""
    kin = tick.kin
    model = tick.model

    def step(q, qdot, res, dt):
        st = kin.update(q, qdot)
        tau_full = jnp.concatenate(
            [jnp.zeros(q.shape[:-1] + (6,), q.dtype), res.torque_cmd], axis=-1
        )
        # contact forces act through the contact jacobian; in this codebase's
        # convention the EoM reads A q̈ + J_Cᵀ f_c + B = Sᵀτ (support normal
        # force has f_z < 0 — see the LQP Newton-Euler rows)
        J_C = tick._contact_jacobian_from_state(st)
        rhs = tau_full - st.B - jnp.einsum(
            "...cn,...c->...n", J_C, res.contact_force
        )
        qdd = jnp.einsum("...ij,...j->...i", st.A_inv, rhs)
        qdot_new = qdot + dt * qdd
        # integrate: translation + joints linearly, quaternion on manifold
        q_new = q
        q_new = q_new.at[..., 0:3].add(dt * qdot_new[..., 0:3])
        q_new = q_new.at[..., 6 : 6 + model.model_dof].add(
            dt * qdot_new[..., 6:]
        )
        from ..kin.rotations import axis_angle_matrix, matrix_to_quat, quat_mul

        w = qdot_new[..., 3:6] * dt
        angle = jnp.linalg.norm(w, axis=-1)
        axis = w / jnp.maximum(angle, 1e-12)[..., None]
        dq = jnp.concatenate(
            [axis * jnp.sin(angle / 2)[..., None], jnp.cos(angle / 2)[..., None]],
            axis=-1,
        )
        quat = jnp.stack(
            [q[..., 3], q[..., 4], q[..., 5], q[..., model.ndof]], axis=-1
        )
        qn = quat_mul(quat, dq)
        q_new = q_new.at[..., 3].set(qn[..., 0])
        q_new = q_new.at[..., 4].set(qn[..., 1])
        q_new = q_new.at[..., 5].set(qn[..., 2])
        q_new = q_new.at[..., model.ndof].set(qn[..., 3])
        return q_new, qdot_new

    return step


def make_control_loop(
    tick,
    transition: Callable | None = None,
    K: int = 100,
    dt: float = 0.001,
    warm_start: bool = False,
    warm_iters: int | None = None,
    gap_fallback: float | None = None,
):
    """Build a jitted K-tick on-device loop.

    tick: a ``CompiledTick`` or a ``MaskedTick`` (wbc/masked.py).  For a
    MaskedTick the returned loop takes an extra ``contact_mask`` argument
    after ``fstars`` (the per-scenario candidate-contact activity mask,
    held fixed across the K ticks).

    transition(q, qdot, TickResult, dt) -> (q', qdot') runs between ticks.

    warm_start=True carries each QP's primal/dual point across ticks (the
    analog of the reference's persistent qpOASES hot-start solvers,
    include/dwbc.h:222-228): tick 0 runs at the full iteration budget, the
    remaining K−1 ticks at ``warm_iters`` (default: half the budget).

    gap_fallback (warm loops only): per-tick safety net mirroring qpOASES's
    hot-start-failure → cold re-init at 10× iterations
    (src/qp_wrapper.cpp:298-339): when any lane's warm tick leaves a real
    complementarity gap or primal violation above the threshold, the tick
    is re-solved from the warm point at the full iteration budget (a
    lax.cond — the refine branch costs nothing when not taken) and the
    refined result/warm state is selected PER LANE, so healthy lanes keep
    their warm-budget trajectory.  The trigger reads the cap-aware gap
    (ops/qp.py::_gap_row_mask): a healthy lane riding a torque limit or a
    masked-out contact row reads ~0, not 1e6 — one such lane can no longer
    pin the whole batch to the full-budget branch forever (the r04 failure
    mode).
    """
    from .masked import MaskedTick

    trans = transition or default_transition(tick.model)
    # a FusedTick built with masked=True has the MaskedTick _tick_impl
    # signature too (wbc/fused.py) — route it the same way
    masked = isinstance(tick, MaskedTick) or getattr(tick, "masked", False)

    def _tick(q, qdot, fstars, cmask, **kw):
        if masked:
            if cmask is None:
                raise ValueError("MaskedTick loop needs contact_mask")
            return tick._tick_impl(q, qdot, fstars, cmask, **kw)
        if cmask is not None:
            raise ValueError(
                "contact_mask given for a CompiledTick loop (did you mean to "
                "pass servos=...? contact_mask is only for MaskedTick)"
            )
        return tick._tick_impl(q, qdot, fstars, **kw)

    if warm_start:
        w_iters = warm_iters or max(tick.cfg.qp_iters // 2, 4)

        def loop(q0, qdot0, fstars, contact_mask=None, servos=None):
            warm0 = tick.init_warm(q0.shape[:-1])
            res0, warm = _tick(
                q0, qdot0, fstars, contact_mask, warm=warm0,
                qp_iters=tick.cfg.qp_iters, servos=servos,
            )
            q, qdot = trans(q0, qdot0, res0, dt)

            def body(carry, k):
                q, qdot, warm = carry
                sv = _advance_servos(servos, k * dt)
                res, warm = _tick(
                    q, qdot, fstars, contact_mask, warm=warm,
                    qp_iters=w_iters, servos=sv,
                )
                if gap_fallback is not None:
                    trip = jnp.maximum(res.qp_gap, res.qp_primal_res) \
                        > gap_fallback          # per-lane, (batch,) or ()

                    def _refine(res=res, warm=warm, q=q, qdot=qdot, sv=sv):
                        res2, warm2 = _tick(
                            q, qdot, fstars, contact_mask, warm=warm,
                            qp_iters=tick.cfg.qp_iters, servos=sv,
                        )
                        # select per lane: tripped lanes take the
                        # full-budget solve, healthy lanes keep their
                        # warm-budget result and warm state
                        def sel(a, b):
                            t = trip.reshape(
                                trip.shape + (1,) * (a.ndim - trip.ndim)
                            )
                            return jnp.where(t, a, b)

                        return (
                            jax.tree_util.tree_map(sel, res2, res),
                            jax.tree_util.tree_map(sel, warm2, warm),
                        )

                    res, warm = jax.lax.cond(
                        jnp.any(trip), _refine, lambda: (res, warm),
                    )
                q, qdot = trans(q, qdot, res, dt)
                return (q, qdot, warm), (
                    res.torque_cmd, res.qp_primal_res, res.qp_error
                )

            (q, qdot, _), (torques, pres, errs) = jax.lax.scan(
                body, (q, qdot, warm), 1.0 + jnp.arange(K - 1, dtype=tick.dtype)
            )
            torques = jnp.concatenate([res0.torque_cmd[None], torques], axis=0)
            pres = jnp.concatenate([res0.qp_primal_res[None], pres], axis=0)
            errs = jnp.concatenate([res0.qp_error[None], errs], axis=0)
            return LoopResult(q_final=q, qdot_final=qdot, torques=torques,
                              qp_primal_res=pres, qp_error=errs)

        return jax.jit(loop)

    def loop(q0, qdot0, fstars, contact_mask=None, servos=None):
        def body(carry, k):
            q, qdot = carry
            res = _tick(
                q, qdot, fstars, contact_mask,
                servos=_advance_servos(servos, k * dt),
            )
            q, qdot = trans(q, qdot, res, dt)
            return (q, qdot), (res.torque_cmd, res.qp_primal_res, res.qp_error)

        (q, qdot), (torques, pres, errs) = jax.lax.scan(
            body, (q0, qdot0), jnp.arange(K, dtype=tick.dtype)
        )
        return LoopResult(q_final=q, qdot_final=qdot, torques=torques,
                          qp_primal_res=pres, qp_error=errs)

    return jax.jit(loop)
