"""End-to-end serving demo: the integration rollout across the framework's
user-facing surfaces (VERDICT r2 item 8).

Drives a few hundred control ticks through three phases, asserting
feasibility throughout:

  A. **Batched RL serving** — ``BatchedRlWBCBridge`` (the pybind-bridge
     equivalent, /root/reference/src/pybind/rl_wbc_bridge.cpp:123-139)
     solves a fleet of drifted double-support states per step.
  B. **Weight shift** — ``CompiledTick`` + ``make_control_loop`` with the
     ON-DEVICE quintic/PD servo moving the pelvis over the left foot,
     closed-loop under the forward-dynamics transition, warm-started QPs
     with the gap fallback (the qpOASES hot-start-failure analog).
  C. **Single support + hypothesis sweep** — ``MaskedTick`` evaluates
     {double support, left-only, right-only} contact hypotheses for the
     shifted state in ONE masked batch and picks the best feasible one;
     the swing-foot servo then tracks a step trajectory in single support.

Run:  python examples/serving_demo.py  [--ticks 300]  (CPU, ~minutes; the
same code runs unchanged on a GPU at f32).
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(n_ticks=300, n_envs=32, dtype_str="float64", verbose=True,
         force_cpu=True):
    import jax

    if force_cpu:
        # env vars alone are unreliable in this image (CLAUDE.md); the demo
        # runs CPU f64 by default — pass force_cpu=False for GPU f32
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    dtype = getattr(jnp, dtype_str)

    from libdwbc_tpu.bridge import BatchedRlWBCBridge
    from libdwbc_tpu.model.compile import RobotModel
    from libdwbc_tpu.wbc import types as T
    from libdwbc_tpu.wbc.loop import (
        forward_dynamics_transition, make_control_loop,
    )
    from libdwbc_tpu.wbc.masked import MaskedTick
    from libdwbc_tpu.wbc.pipeline import (
        CompiledTick, make_servo, standard_tocabi_config,
    )

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = RobotModel.load(os.path.join(here, "models", "tocabi.npz"))

    def standing_q():
        q = np.zeros(model.nq)
        q[2] = 0.92983
        q[model.ndof] = 1.0
        q[6:18] = [0, 0, -0.24, 0.6, -0.36, 0] * 2
        q[21:29] = [0.3, 0.3, 1.5, -1.27, -1, 0, -1, 0]
        q[31:39] = [-0.3, -0.3, -1.5, 1.27, 1, 0, 1, 0]
        return q

    report = {}

    # ---------------- Phase A: batched RL bridge serving ----------------
    rng = np.random.default_rng(0)
    # the bridge is the f32 serving surface (its solve() casts to float32)
    bridge = BatchedRlWBCBridge(n_envs, qp_iters=20)
    q = standing_q()
    qpos = np.zeros((n_envs, model.nq))
    qpos[:, 0:3] = q[0:3]
    qpos[:, 3] = 1.0                      # MuJoCo quat (w,x,y,z)
    qpos[:, 7:40] = q[6:39]
    qpos[:, 7:40] += 0.01 * rng.standard_normal((n_envs, 33))
    qvel = np.zeros((n_envs, model.ndof))
    f0 = np.tile([0.0, 0.0, 0.1, 0.0, 0.0, 0.0], (n_envs, 1))
    f1 = np.tile([0.0, 0.0, 0.05], (n_envs, 1))
    taus = bridge.solve(qpos, qvel, qvel, f0, f1)
    assert np.isfinite(taus).all()
    assert np.abs(taus).max() <= 300.0 + 1e-3, "torque limit violated"
    report["A_batched_bridge"] = dict(
        envs=n_envs, tau_absmax=float(np.abs(taus).max())
    )
    if verbose:
        print("[A] batched bridge:", report["A_batched_bridge"])

    # ---------------- Phase B: on-device weight-shift rollout -----------
    cfg = standard_tocabi_config(model, qp_iters=25)
    tick = CompiledTick(model, cfg, dtype=dtype)
    qj = jnp.asarray(q, dtype)
    qdj = jnp.zeros(model.ndof, dtype)
    st0 = tick.kin.update(qj, qdj)
    p_left_foot = np.asarray(st0.p[6])
    p_pelvis = np.asarray(st0.p[0])
    shift_target = p_pelvis.copy()
    shift_target[0:2] = [p_left_foot[0], p_left_foot[1]]  # over left foot

    K = n_ticks
    dt = 0.001
    pelvis_servo = make_servo(
        pos_init=p_pelvis, pos_des=shift_target,
        rot_init=np.asarray(st0.R[0]), rot_des=np.asarray(st0.R[0]),
        t0=0.0, tf=K * dt * 0.8,
        pos_p=400.0, pos_d=40.0, rot_p=400.0, rot_d=40.0,
        max_p_err=0.2, dtype=dtype,
    )
    torso_servo = make_servo(
        rot_init=np.asarray(st0.R[15]), rot_des=np.asarray(st0.R[15]),
        t0=0.0, tf=0.01, rot_p=200.0, rot_d=20.0, dtype=dtype,
    )
    loop = make_control_loop(
        tick, transition=forward_dynamics_transition(tick), K=K, dt=dt,
        warm_start=True, warm_iters=10, gap_fallback=1e-5,
    )
    res = loop(
        qj, qdj,
        (jnp.zeros(6, dtype), jnp.zeros(3, dtype)),
        servos=((pelvis_servo,), (torso_servo,)),
    )
    torques = np.asarray(res.torques)
    pres = np.asarray(res.qp_primal_res)
    q_shifted = np.asarray(res.q_final)
    st_end = tick.kin.update(jnp.asarray(q_shifted, dtype), res.qdot_final)
    pelvis_end = np.asarray(st_end.p[0])
    err0 = np.linalg.norm(p_pelvis[0:2] - shift_target[0:2])
    err_end = np.linalg.norm(pelvis_end[0:2] - shift_target[0:2])
    assert np.isfinite(torques).all()
    assert pres.max() < 1e-4, f"infeasible tick in rollout: {pres.max()}"
    assert err_end < 0.5 * err0, (err0, err_end)
    report["B_weight_shift"] = dict(
        ticks=K, pelvis_err_start=float(err0), pelvis_err_end=float(err_end),
        qp_primal_res_max=float(pres.max()),
        tau_absmax=float(np.abs(torques).max()),
    )
    if verbose:
        print("[B] weight shift:", report["B_weight_shift"])

    # ------------- Phase C: contact-hypothesis sweep + single support ----
    # candidate contacts: both feet; masked tick evaluates all 3 support
    # hypotheses for the SHIFTED state in one batch
    mt = MaskedTick(model, cfg, dtype=dtype)
    masks = jnp.asarray(
        np.array([[1, 1], [1, 0], [0, 1]], np.float64), dtype
    )
    qb = jnp.broadcast_to(jnp.asarray(q_shifted, dtype), (3, model.nq))
    qdb = jnp.zeros((3, model.ndof), dtype)
    fb = (jnp.zeros((3, 6), dtype), jnp.zeros((3, 3), dtype))
    resm = mt._tick_impl(qb, qdb, fb, masks)
    pres_h = np.asarray(resm.qp_primal_res)
    cost_h = np.sum(np.asarray(resm.torque_cmd) ** 2, axis=-1) + 1e6 * pres_h
    best = int(np.argmin(cost_h))
    assert np.isfinite(cost_h).all()
    # with the pelvis over the LEFT foot, left-only support must be feasible
    assert pres_h[1] < 1e-4
    report["C_hypotheses"] = dict(
        best_hypothesis=["both", "left", "right"][best],
        primal_res=[float(x) for x in pres_h],
    )
    if verbose:
        print("[C] hypothesis sweep:", report["C_hypotheses"])

    # single support (left) + swing-foot step servo
    cfg_ss = standard_tocabi_config(
        model, both_feet=False, swing_task=True, qp_iters=25
    )
    tick_ss = CompiledTick(model, cfg_ss, dtype=dtype)
    st_s = tick_ss.kin.update(jnp.asarray(q_shifted, dtype), qdj)
    p_swing = np.asarray(st_s.p[12])
    K2 = max(n_ticks, 300)
    lift_target = 0.02
    # gentle lift over the whole horizon: the loop's forward-dynamics
    # transition is a crude semi-implicit integrator (see test_servo's
    # rollout), so demand smooth accelerations and >50% progress
    swing_servo = make_servo(
        pos_init=p_swing, pos_des=p_swing + [0.0, 0.0, lift_target],
        rot_init=np.asarray(st_s.R[12]), rot_des=np.asarray(st_s.R[12]),
        t0=0.0, tf=K2 * dt, pos_p=400.0, pos_d=40.0, rot_p=400.0,
        rot_d=40.0, dtype=dtype,
    )
    pelvis_hold = make_servo(
        pos_init=np.asarray(st_s.p[0]), pos_des=np.asarray(st_s.p[0]),
        rot_init=np.asarray(st_s.R[0]), rot_des=np.asarray(st_s.R[0]),
        t0=0.0, tf=0.01, pos_p=400.0, pos_d=40.0, rot_p=400.0, rot_d=40.0,
        dtype=dtype,
    )
    loop_ss = make_control_loop(
        tick_ss, transition=forward_dynamics_transition(tick_ss), K=K2,
        dt=dt, warm_start=True, warm_iters=10, gap_fallback=1e-5,
    )
    res_ss = loop_ss(
        jnp.asarray(q_shifted, dtype), qdj,
        (jnp.zeros(6, dtype), jnp.zeros(3, dtype), jnp.zeros(6, dtype)),
        servos=((pelvis_hold,), (torso_servo,), (swing_servo,)),
    )
    pres_ss = np.asarray(res_ss.qp_primal_res)
    st_f = tick_ss.kin.update(res_ss.q_final, res_ss.qdot_final)
    swing_end = np.asarray(st_f.p[12])
    lift = float(swing_end[2] - p_swing[2])
    assert np.isfinite(np.asarray(res_ss.torques)).all()
    assert pres_ss.max() < 1e-4
    # crude semi-implicit transition + short horizon: demand real progress
    # (matching tests/test_servo.py's rollout bar), not convergence
    assert lift > 0.4 * lift_target, f"swing foot did not lift: {lift}"
    report["C_single_support"] = dict(
        ticks=K2, swing_lift_m=lift, qp_primal_res_max=float(pres_ss.max())
    )
    if verbose:
        print("[C] single-support swing:", report["C_single_support"])
        print("SERVING DEMO PASSED")
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--envs", type=int, default=32)
    args = ap.parse_args()
    main(n_ticks=args.ticks, n_envs=args.envs)
