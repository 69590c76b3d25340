"""Trajectory generation + operational-space PD servo.

Vectorized equivalents of the reference's trajectory layer:
``QuinticSpline`` (src/math.cpp:127-186), ``cubic`` (187-224),
``rotationCubic`` (226-274), and the TaskLink PD servos
(``GetFstarPosPD``/``GetFstarRotPD``, src/task.cpp:268-339).  All functions
are jittable and broadcast over leading batch dims (time can be a batch of
per-scenario clocks).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..kin.rotations import get_phi, matrix_to_quat, quat_slerp, quat_to_matrix


def quintic_spline(t, t0, tf, x0, v0, a0, xf, vf, af):
    """Quintic interpolation; returns (pos, vel, acc), each shaped like
    broadcast(t, x0).  Clamps outside [t0, tf]."""
    ts = tf - t0
    ts2, ts3, ts4, ts5 = ts**2, ts**3, ts**4, ts**5
    a1, a2, a3 = x0, v0, a0 / 2.0
    # solve the 3x3 for a4..a6 in closed form
    b1 = xf - x0 - v0 * ts - a0 * ts2 / 2.0
    b2 = vf - v0 - a0 * ts
    b3 = af - a0
    a4 = (20.0 * b1 - 8.0 * b2 * ts + b3 * ts2) / (2.0 * ts3)
    a5 = (-30.0 * b1 + 14.0 * b2 * ts - 2.0 * b3 * ts2) / (2.0 * ts4)
    a6 = (12.0 * b1 - 6.0 * b2 * ts + b3 * ts2) / (2.0 * ts5)

    tc = jnp.clip(t, t0, tf) - t0
    pos = a1 + a2 * tc + a3 * tc**2 + a4 * tc**3 + a5 * tc**4 + a6 * tc**5
    vel = a2 + 2 * a3 * tc + 3 * a4 * tc**2 + 4 * a5 * tc**3 + 5 * a6 * tc**4
    acc = 2 * a3 + 6 * a4 * tc + 12 * a5 * tc**2 + 20 * a6 * tc**3

    before = t < t0
    after = t > tf
    pos = jnp.where(before, x0, jnp.where(after, xf, pos))
    vel = jnp.where(before, v0, jnp.where(after, vf, vel))
    acc = jnp.where(before, a0, jnp.where(after, af, acc))
    return pos, vel, acc


def cubic(t, t0, tf, x0, xf, v0, vf):
    """Cubic interpolation (position only), clamped (src/math.cpp:187-224)."""
    ts = tf - t0
    tc = jnp.clip(t, t0, tf) - t0
    total_x = xf - x0
    c2 = 3.0 * total_x / ts**2 - 2.0 * v0 / ts - vf / ts
    c3 = -2.0 * total_x / ts**3 + (v0 + vf) / ts**2
    x = x0 + v0 * tc + c2 * tc**2 + c3 * tc**3
    return jnp.where(t < t0, x0, jnp.where(t > tf, xf, x))


def rotation_cubic(t, t0, tf, R0, Rf):
    """Rotation interpolation with cubic time scaling
    (``rotationCubic``, src/math.cpp:226-274) via quaternion slerp."""
    tau = cubic(t, t0, tf, 0.0, 1.0, 0.0, 0.0)
    q0 = matrix_to_quat(R0)
    qf = matrix_to_quat(Rf)
    return quat_to_matrix(quat_slerp(q0, qf, tau))


class ServoGains(NamedTuple):
    pos_p: jnp.ndarray
    pos_d: jnp.ndarray
    pos_a: jnp.ndarray
    rot_p: jnp.ndarray
    rot_d: jnp.ndarray
    rot_a: jnp.ndarray


def fstar_pos_pd(
    t, t0, tf, pos_init, vel_init, pos_des, vel_des,
    current_pos, current_vel, p_gain, d_gain, a_gain,
):
    """Operational-space position PD + acceleration feedforward
    (``GetFstarPosPD``, src/task.cpp:268-294)."""
    pos_traj, vel_traj, acc_traj = quintic_spline(
        t, t0, tf, pos_init, vel_init, jnp.zeros_like(pos_init),
        pos_des, vel_des, jnp.zeros_like(pos_des),
    )
    p_err = pos_traj - current_pos
    d_err = vel_traj - current_vel
    return a_gain * acc_traj + p_gain * p_err + d_gain * d_err, p_err, d_err


def fstar_rot_pd(
    t, t0, tf, rot_init, w_init, rot_des, w_des,
    current_rot, current_w, p_gain, d_gain,
):
    """Operational-space rotation PD with slerp trajectory
    (``GetFstarRotPD``, src/task.cpp:296-339)."""
    s, sd, _ = quintic_spline(
        t, t0, tf, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0
    )
    q0 = matrix_to_quat(rot_init)
    qf = matrix_to_quat(rot_des)
    q_traj = quat_slerp(q0, qf, s)
    rot_traj = quat_to_matrix(q_traj)

    # relative rotation axis*angle for the velocity feedforward
    Rrel = rot_des @ jnp.swapaxes(rot_init, -1, -2)
    from ..kin.rotations import rotation_log

    aa = rotation_log(Rrel)
    w_traj = aa * sd[..., None] if jnp.ndim(sd) < jnp.ndim(aa) else aa * sd

    p_err = get_phi(current_rot, rot_traj)
    d_err = w_traj - current_w
    return p_gain * p_err + d_gain * d_err, p_err, d_err


def second_order_lpf(x_k, x_k1, x_k2, y_k1, y_k2, fc, d, hz):
    """Second-order low-pass filter step (src/math.cpp:330-347)."""
    omega = 2.0 * jnp.pi * fc / hz
    D = 4.0 + 4.0 * d * omega + omega * omega
    return (
        (8.0 - 2.0 * omega * omega) / D * y_k1
        - (4.0 - 4.0 * d * omega + omega * omega) / D * y_k2
        + omega * omega / D * (x_k + 2.0 * x_k1 + x_k2)
    )
