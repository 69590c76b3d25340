"""On-device servo inside the fused tick (ops/tick_kernel servo primitives
+ FusedTick servos= plumbing), CPU f64.

Parity targets follow the repo tolerance policy: the servo f* itself is
exact math (quintic + slerp + PD — asserted at 1e-10 vs the pipeline
servo); QP-dependent torques on weakly-active faces are only determined to
the documented cross-formulation floor, so the end-to-end checks are
(a) a gentle-state torque comparison and (b) a closed-loop tracking
rollout through make_control_loop — the functional contract.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from conftest import CASE_Q, full_q


@pytest.fixture(scope="module")
def setup(tocabi_model):
    from libdwbc_tpu.wbc.fused import FusedTick
    from libdwbc_tpu.wbc.pipeline import CompiledTick, standard_tocabi_config

    cfg = standard_tocabi_config(tocabi_model, qp_iters=25)
    ct = CompiledTick(tocabi_model, cfg, dtype=jnp.float64)
    ft = FusedTick(tocabi_model, cfg, dtype=jnp.float64)
    return tocabi_model, cfg, ct, ft


def _servos(ct, q, qd, dp, gains=400.0):
    from libdwbc_tpu.wbc.pipeline import make_servo

    st0 = ct.kin.update(jnp.asarray(q), jnp.asarray(qd))
    pelvis = make_servo(
        pos_init=np.asarray(st0.p[0]), pos_des=np.asarray(st0.p[0]) + dp,
        rot_init=np.asarray(st0.R[0]), rot_des=np.asarray(st0.R[0]),
        t=0.05, t0=0.0, tf=0.2, pos_p=gains, pos_d=gains / 10,
        rot_p=gains, rot_d=gains / 10, max_p_err=0.1, dtype=jnp.float64,
    )
    torso = make_servo(
        rot_init=np.asarray(st0.R[15]), rot_des=np.asarray(st0.R[15]),
        t=0.05, t0=0.0, tf=0.2, rot_p=gains / 2, rot_d=gains / 20,
        dtype=jnp.float64,
    )
    return ((pelvis,), (torso,))


def test_servo_fstar_exact_parity(setup):
    """The fused servo (quintic + slerp + GetPhi PD, elem-leading) produces
    the SAME f* as the pipeline servo, including a moving base (qd ≠ 0 →
    per-body velocity chain inside the kernel program)."""
    from libdwbc_tpu.wbc.pipeline import _apply_servos

    model, cfg, ct, ft = setup
    q = full_q(CASE_Q[1])
    qd = np.zeros(39)
    qd[3] = 0.05
    qd[8] = 0.1
    servos = _servos(ct, q, qd, np.array([0.02, 0.0, 0.01]))

    st = ct.kin.update(jnp.asarray(q), jnp.asarray(qd),
                       J_bodies=ct._J_bodies, points=ct._points)
    f_ref0 = _apply_servos(model, cfg, jnp.float64, st, 0, jnp.zeros(6),
                           servos[0])
    f_ref1 = _apply_servos(model, cfg, jnp.float64, st, 1, jnp.zeros(3),
                           servos[1])

    prog = ft.prog
    sv_b = ft._servos_batched(servos, 1)
    sv_el = tuple(
        tuple({k: jnp.moveaxis(v, 0, -1) for k, v in d.items()}
              if d else None for d in lvl) if lvl else None
        for lvl in sv_b
    )
    pre = prog.prestage(
        jnp.moveaxis(jnp.asarray(q)[None], 0, -1),
        qdot=jnp.moveaxis(jnp.asarray(qd)[None], 0, -1),
        servo_req=((True,), (True,)),
    )
    fs = prog._apply_servos_el(
        pre, (jnp.zeros((6, 1)), jnp.zeros((3, 1))), sv_el
    )
    assert np.abs(np.asarray(fs[0])[:, 0] - np.asarray(f_ref0)).max() < 1e-10
    assert np.abs(np.asarray(fs[1])[:, 0] - np.asarray(f_ref1)).max() < 1e-10


def test_servo_tick_gentle_state_parity(setup):
    """Full servo'd tick vs CompiledTick at a gentle state (small errors,
    constraints inactive → no weakly-active-vertex roulette)."""
    model, cfg, ct, ft = setup
    q = full_q(CASE_Q[1])
    qd = np.zeros(39)
    servos = _servos(ct, q, qd, np.array([0.002, 0.0, 0.001]), gains=100.0)
    f0 = (jnp.zeros(6), jnp.zeros(3))
    rc = ct(q, qd, f0, servos=servos)
    rf = ft(q, qd, f0, servos=servos)
    assert np.abs(np.asarray(rf.torque_grav) - np.asarray(rc.torque_grav)).max() < 1e-8
    assert np.abs(np.asarray(rf.torque_task) - np.asarray(rc.torque_task)).max() < 2e-3
    assert np.abs(np.asarray(rf.torque_cmd) - np.asarray(rc.torque_cmd)).max() < 5e-2
    assert float(rf.qp_primal_res) < 1e-9


def test_fused_servo_closed_loop_tracking(setup):
    """make_control_loop drives the FUSED tick with on-device servos: a
    pelvis step target is tracked closed-loop under the forward-dynamics
    transition with warm-started QPs — the 1 kHz serving lane's full
    functionality on the fused path."""
    from libdwbc_tpu.wbc.loop import (
        forward_dynamics_transition, make_control_loop,
    )
    from libdwbc_tpu.wbc.pipeline import make_servo

    model, cfg, ct, ft = setup
    q = full_q(CASE_Q[1])
    qd = np.zeros(39)
    st0 = ct.kin.update(jnp.asarray(q), jnp.asarray(qd))
    target = np.asarray(st0.p[0]) + [0.01, 0.0, 0.0]
    K, dt = 150, 0.001
    pelvis = make_servo(
        pos_init=np.asarray(st0.p[0]), pos_des=target,
        rot_init=np.asarray(st0.R[0]), rot_des=np.asarray(st0.R[0]),
        t0=0.0, tf=K * dt * 0.8, pos_p=400.0, pos_d=40.0,
        rot_p=400.0, rot_d=40.0, dtype=jnp.float64,
    )
    torso = make_servo(
        rot_init=np.asarray(st0.R[15]), rot_des=np.asarray(st0.R[15]),
        t0=0.0, tf=0.01, rot_p=100.0, rot_d=20.0, dtype=jnp.float64,
    )
    # the loop's transition needs CompiledTick internals for the simulator
    # step; the CONTROLLER inside the loop is the fused tick
    loop = make_control_loop(
        ft, transition=forward_dynamics_transition(ct), K=K, dt=dt,
        warm_start=True, warm_iters=10, gap_fallback=1e-6,
    )
    res = loop(
        jnp.asarray(q), jnp.asarray(qd),
        (jnp.zeros(6), jnp.zeros(3)),
        servos=((pelvis,), (torso,)),
    )
    assert np.isfinite(np.asarray(res.torques)).all()
    assert float(np.asarray(res.qp_primal_res).max()) < 1e-5
    st_end = ct.kin.update(res.q_final, res.qdot_final)
    err0 = np.linalg.norm(np.asarray(st0.p[0]) - target)
    err_end = np.linalg.norm(np.asarray(st_end.p[0]) - target)
    assert err_end < 0.5 * err0, (err0, err_end)