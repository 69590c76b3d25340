"""Failure detection end-to-end (VERDICT r04 item 2).

The reference's failure story is crisp: qpOASES returns a status; on
failure the wrapper retries cold at 10× iterations, and the cascade zeroes
its outputs, sets qp_error, and aborts (/root/reference/src/
qp_wrapper.cpp:298-363, src/dwbc.cpp:836-846, 1117-1125).  This repo's
batched analog:

* the gap observable is a NORMALIZED complementarity (ops/qp.py::_comp_gap)
  that cannot saturate on healthy limit-riding / masked lanes (the r04
  failure: capped duals read 6.4e6 on healthy lanes);
* every tick carries a per-lane ``qp_error`` flag (TickResult);
* ``make_control_loop(gap_fallback=...)`` re-solves at full budget and
  selects PER LANE — one bad lane cannot perturb healthy lanes' warm
  trajectories, and one healthy limit-riding lane cannot pin the batch to
  the full-budget branch;
* the facade retries at 10× then refuses: CalcTaskControlTorque returns 0
  with task/contact torques zeroed (gravity hold), qp_error_ set.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conftest import CASE_FSTAR, CASE_Q, full_q, make_standard_robot

from libdwbc_tpu.wbc.loop import make_control_loop
from libdwbc_tpu.wbc.masked import MaskedTick
from libdwbc_tpu.wbc.pipeline import CompiledTick, standard_tocabi_config


def _arm_limited_cfg(model, qp_iters=12):
    """Per-joint limits: legs/waist 300 Nm, arms 4 Nm.  The arms are on
    neither the contact chain (NwJw) nor a task map with significant arm
    columns, so an arms-raised pose whose shoulder gravity torque exceeds
    4 Nm is GENUINELY infeasible — no δf*/redistribution can rescue it."""
    cfg = standard_tocabi_config(model, qp_iters=qp_iters)
    tl = np.full(model.model_dof, 300.0)
    tl[15:23] = 4.0
    tl[25:33] = 4.0
    return dataclasses.replace(cfg, torque_limit=tl)


def _two_lane_inputs(model):
    """Lane 0: reference stance (healthy).  Lane 1: both arms raised
    sideways (|τ_grav| ≈ 16.5 Nm at the shoulder — infeasible under the
    4 Nm arm limit)."""
    q0 = full_q(CASE_Q[1])
    qa = q0.copy()
    qa[6 + 16] += 1.5
    qa[6 + 26] -= 1.5
    f1, f2 = CASE_FSTAR[1]
    q = np.stack([q0, qa])
    qd = np.zeros((2, model.ndof))
    fs = (np.tile(f1, (2, 1)), np.tile(f2, (2, 1)))
    return q, qd, fs


def test_comp_gap_eps_infeasible_row():
    """An ε-infeasible row (0·x ≤ −ε — the masked-lane / limit-roundoff
    shape) diverges its dual toward w_cap.  The normalized complementarity
    must read ~ε, not ε·λ (the r04 saturation), while pres reports ε."""
    from libdwbc_tpu.ops.qp import solve_qp

    n, m = 4, 6
    rng = np.random.default_rng(0)
    M = rng.standard_normal((n, n))
    H = (M @ M.T + np.eye(n)).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    A = np.zeros((m, n), np.float32)
    A[: m - 1] = rng.standard_normal((m - 1, n))
    ub = np.ones(m, np.float32)
    ub[m - 1] = -1e-6
    sol = solve_qp(jnp.asarray(H), jnp.asarray(g), jnp.asarray(A), None,
                   jnp.asarray(ub), iters=30)
    lam_max = float(np.max(np.asarray(sol.lam)))
    assert lam_max > 1e6, "dual should diverge on the infeasible row"
    assert float(sol.primal_res) == pytest.approx(1e-6, rel=1e-2)
    assert float(sol.gap) < 1e-4, (
        f"gap saturated on an ε-infeasible row: {float(sol.gap)}"
    )


def test_qp_error_per_lane(tocabi_model):
    """Healthy and genuinely infeasible lanes in ONE batch: qp_error must
    flag exactly the infeasible lane."""
    cfg = _arm_limited_cfg(tocabi_model)
    tick = CompiledTick(tocabi_model, cfg, dtype=jnp.float64)
    q, qd, fs = _two_lane_inputs(tocabi_model)
    r = tick(q, qd, fs)
    err = np.asarray(r.qp_error)
    pres = np.asarray(r.qp_primal_res)
    assert not err[0] and pres[0] < 1e-8
    assert err[1] and pres[1] > 1.0
    # the infeasible lane's gap reads LARGE (unconverged complementarity),
    # not saturated-by-cap nonsense; the healthy lane reads ~0
    gap = np.asarray(r.qp_gap)
    assert gap[0] < 1e-8 and gap[1] > 1.0


def test_limit_riding_lane_is_healthy(tocabi_model):
    """A lane riding its torque limit (τ_max == tlim to roundoff) in a
    masked single-support batch is HEALTHY: gap ~0, no qp_error — the
    exact regime where the r04 saturating gap read 6.4e6."""
    cfg = dataclasses.replace(
        standard_tocabi_config(tocabi_model, qp_iters=25),
        torque_limit=np.full(tocabi_model.model_dof, 45.0),
    )
    tick = MaskedTick(tocabi_model, cfg, dtype=jnp.float64)
    q = np.tile(full_q(CASE_Q[1]), (2, 1))
    qd = np.zeros((2, tocabi_model.ndof))
    f1, f2 = CASE_FSTAR[1]
    fs = (np.tile(f1, (2, 1)), np.tile(f2, (2, 1)))
    cm = np.array([[1.0, 1.0], [1.0, 0.0]])
    # warm chain at the serving budget — duals accumulate across ticks,
    # the regime that drove λ to the cap in r04
    warm = tick.init_warm((2,))
    res, warm = tick._tick_impl(
        jnp.asarray(q), jnp.asarray(qd), fs, jnp.asarray(cm),
        warm=warm, qp_iters=25,
    )
    for _ in range(4):
        res, warm = tick._tick_impl(
            jnp.asarray(q), jnp.asarray(qd), fs, jnp.asarray(cm),
            warm=warm, qp_iters=7,
        )
    tau_max = np.abs(np.asarray(res.torque_cmd)).max()
    assert tau_max == pytest.approx(45.0, abs=1e-3), "limit not riding"
    assert np.asarray(res.qp_gap).max() < 1e-6
    assert np.asarray(res.qp_primal_res).max() < 1e-8
    assert not np.asarray(res.qp_error).any()


def test_gap_fallback_per_lane(tocabi_model):
    """One poorly-converged lane in a warm loop with gap_fallback: lane 1's
    state jumps 0.05 rad between ticks (a stale warm point that 2 IPM
    iterations cannot re-converge — gap above threshold), lane 0 holds
    (healthy).  The fallback must fire AND select per lane: lane 0's
    trajectory BIT-IDENTICAL to the no-fallback loop (the refine branch
    must not touch it), lane 1's full-budget re-solve measurably different.
    Then: on an all-healthy limit-riding batch the fallback must never
    fire (loop outputs identical)."""
    cfg = standard_tocabi_config(tocabi_model, qp_iters=25)
    tick = CompiledTick(tocabi_model, cfg, dtype=jnp.float64)
    q0 = full_q(CASE_Q[1])
    q = np.tile(q0, (2, 1))
    qd = np.zeros((2, tocabi_model.ndof))
    f1, f2 = CASE_FSTAR[1]
    fs = (np.tile(f1, (2, 1)), np.tile(f2, (2, 1)))

    kick = np.zeros((2, 33))
    kick[1, :6] = 0.05          # lane 1 only: hip joints jump every tick

    def perturb(qq, qqd, res, dt):
        return qq.at[..., 6:39].add(jnp.asarray(kick)), qqd

    K = 4
    loop_fb = make_control_loop(tick, transition=perturb, K=K,
                                warm_start=True, warm_iters=2,
                                gap_fallback=1e-7)
    loop_nofb = make_control_loop(tick, transition=perturb, K=K,
                                  warm_start=True, warm_iters=2)
    r_fb = loop_fb(jnp.asarray(q), jnp.asarray(qd), fs)
    r_nofb = loop_nofb(jnp.asarray(q), jnp.asarray(qd), fs)
    # healthy lane: untouched by the refine branch (bitwise)
    np.testing.assert_array_equal(
        np.asarray(r_fb.torques)[:, 0], np.asarray(r_nofb.torques)[:, 0]
    )
    # stale lane: the fallback DID fire — the full-budget re-solve differs
    # from the 2-iter warm solve on the jumped state
    d1 = np.abs(
        np.asarray(r_fb.torques)[1:, 1] - np.asarray(r_nofb.torques)[1:, 1]
    ).max()
    assert d1 > 1e-9, "fallback never fired on the stale-warm lane"

    # all-healthy limit-riding batch: fallback must never fire
    cfg2 = dataclasses.replace(
        standard_tocabi_config(tocabi_model, qp_iters=12),
        torque_limit=np.full(tocabi_model.model_dof, 45.0),
    )
    tick2 = CompiledTick(tocabi_model, cfg2, dtype=jnp.float64)
    qh = np.tile(full_q(CASE_Q[1]), (2, 1))
    loop2_fb = make_control_loop(tick2, K=K, warm_start=True, warm_iters=6,
                                 gap_fallback=1e-3)
    loop2_nofb = make_control_loop(tick2, K=K, warm_start=True, warm_iters=6)
    r2_fb = loop2_fb(jnp.asarray(qh), jnp.asarray(qd), fs)
    r2_nofb = loop2_nofb(jnp.asarray(qh), jnp.asarray(qd), fs)
    assert not np.asarray(r2_fb.qp_error).any()
    np.testing.assert_array_equal(
        np.asarray(r2_fb.torques), np.asarray(r2_nofb.torques)
    )


def test_facade_abort_and_gravity_hold():
    """Facade parity with src/dwbc.cpp:836-846: on an infeasible cascade
    CalcTaskControlTorque returns 0, zeroes task/contact torques, sets
    qp_error_, and GetControlTorque serves gravity compensation only."""
    rd = make_standard_robot(1)
    rd.CalcContactConstraint()
    rd.CalcGravCompensation()
    # healthy first
    assert rd.CalcTaskControlTorque(True, True) == 1
    assert rd.qp_error_ == 0
    assert rd.CalcContactRedistribute(True, True) == 1

    # infeasible: 1 Nm limits everywhere
    rd2 = make_standard_robot(1)
    rd2.SetTorqueLimit(np.full(33, 1.0))
    rd2.CalcContactConstraint()
    rd2.CalcGravCompensation()
    assert rd2.CalcTaskControlTorque(True, True) == 0
    assert rd2.qp_error_ == 1
    np.testing.assert_array_equal(np.asarray(rd2.torque_task_), 0.0)
    np.testing.assert_array_equal(np.asarray(rd2.torque_contact_), 0.0)
    np.testing.assert_allclose(
        rd2.GetControlTorque(), np.asarray(rd2.torque_grav_), atol=0.0
    )
    assert rd2.GetQPStats()["qp_error"] == 1


def test_fused_masked_limit_riding_gap(tocabi_model):
    """The fused kernel's in-kernel IPM (ops/tick_kernel.py::_ipm) uses the
    same normalized complementarity: a masked single-support warm chain
    riding the torque limit must read gap ~0 (XLA backend = the same
    element-leading program of FusedTick)."""
    from libdwbc_tpu.wbc.fused import FusedTick

    cfg = dataclasses.replace(
        standard_tocabi_config(tocabi_model, qp_iters=12),
        torque_limit=np.full(tocabi_model.model_dof, 45.0),
    )
    tick = FusedTick(tocabi_model, cfg, dtype=jnp.float64,
                     masked=True)
    q = np.tile(full_q(CASE_Q[1]), (2, 1))
    qd = np.zeros((2, tocabi_model.ndof))
    f1, f2 = CASE_FSTAR[1]
    fs = (np.tile(f1, (2, 1)), np.tile(f2, (2, 1)))
    cm = jnp.asarray(np.array([[1.0, 1.0], [1.0, 0.0]]))
    warm = tick.init_warm((2,))
    res, warm = tick._tick_impl(
        jnp.asarray(q), jnp.asarray(qd), fs, cm, warm=warm, qp_iters=12,
    )
    for _ in range(3):
        res, warm = tick._tick_impl(
            jnp.asarray(q), jnp.asarray(qd), fs, cm, warm=warm, qp_iters=7,
        )
    assert np.abs(np.asarray(res.torque_cmd)).max() == pytest.approx(
        45.0, abs=1e-3
    )
    assert np.asarray(res.qp_gap).max() < 1e-6
    assert not np.asarray(res.qp_error).any()
