"""Fused control-tick pipeline: (q, q̇, f*) → τ as ONE XLA computation.

This is the compiled answer to the reference's per-tick call sequence
(UpdateKinematics → SetContact → CalcContactConstraint → CalcGravCompensation
→ CalcTaskControlTorque → CalcContactRedistribute, SURVEY.md §3.1).  The whole
tick — kinematics, contact-space factorization, task hierarchy, all QPs — is
traced once per static configuration and compiled to a single graph:

* no host↔device round trips inside the tick;
* trivially batchable with vmap (thousands of scenarios per step);
* shardable with shard_map across a device mesh (see parallel/).

Static configuration = (model, contact set + active pattern, task stack,
torque limits, QP iteration count).  Contact-mode switches recompile (cheap,
cached); the masked multi-mode batch path lives in parallel/hypotheses.py.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..kin.engine import FK, Kinematics
from ..model.compile import RobotModel
from . import dynamics as dyn
from . import types as T
from .hqp import (
    contact_constraint_blocks,
    solve_contact_redistribution_qp,
    solve_task_level_qp,
)


class TickResult(NamedTuple):
    torque_grav: jnp.ndarray
    torque_task: jnp.ndarray
    torque_contact: jnp.ndarray
    torque_cmd: jnp.ndarray
    contact_force: jnp.ndarray    # observed contact wrench under torque_cmd
    qp_gap: jnp.ndarray           # worst cap-aware complementarity gap across QPs
    qp_primal_res: jnp.ndarray    # worst primal violation across QPs
    contact_rank_health: jnp.ndarray  # contact-space rank indicator (tiny = degenerate)
    qp_error: jnp.ndarray         # per-lane solver-failure flag (bool) — the
    # batched analog of qpOASES' failure status (src/qp_wrapper.cpp:298-363):
    # True when any QP in the tick left a real primal violation, a real
    # complementarity gap, or a non-finite torque.  The facade refuses to
    # serve torque on it (src/dwbc.cpp:836-846 semantics); serving loops
    # should hold/zero flagged lanes.


def qp_error_flag(gap, pres, torque_cmd, cfg):
    """Per-lane failure flag from the tick diagnostics.  Thresholds sit
    orders of magnitude above any healthy solve (warm f32 gap ≲ 1e-6,
    ε-roundoff pres ≲ 1e-5) and far below garbage; non-finite torque is
    always a failure."""
    finite = jnp.all(jnp.isfinite(torque_cmd), axis=-1)
    return (~finite) | (gap > cfg.qp_fail_gap) | (pres > cfg.qp_fail_pres)


class ServoParams(NamedTuple):
    """On-device trajectory + PD servo parameters for ONE task link — the
    fused equivalent of ``TaskLink::SetTrajectoryQuintic/SetTrajectoryRotation``
    + ``GetFstarPosPD``/``GetFstarRotPD`` (src/task.cpp:223-339) and the f*
    dispatch in ``UpdateTaskSpace`` (src/dwbc.cpp:685-793).  All fields are
    dynamic (jit inputs) and broadcast over leading batch dims, so a batch
    of scenarios can each track a different trajectory/clock.

    use_pos/use_rot mirror traj_pos_set/traj_rot_set: 1.0 replaces that half
    of the provided f* with the servo output, 0.0 keeps the caller's f*.
    max_*_err implement ``SetPDerrorRegulation`` (src/task.cpp:341-346 —
    declared in the reference but never applied there; here the p/d errors
    are clamped to ±max before the gains, the evident intent).
    """

    t: jnp.ndarray          # current control time
    t0: jnp.ndarray
    tf: jnp.ndarray
    pos_init: jnp.ndarray   # (...,3)
    vel_init: jnp.ndarray
    pos_des: jnp.ndarray
    vel_des: jnp.ndarray
    rot_init: jnp.ndarray   # (...,3,3)
    w_init: jnp.ndarray     # (...,3)
    rot_des: jnp.ndarray
    w_des: jnp.ndarray
    pos_p: jnp.ndarray      # (...,3) gains
    pos_d: jnp.ndarray
    pos_a: jnp.ndarray
    rot_p: jnp.ndarray
    rot_d: jnp.ndarray
    max_p_err: jnp.ndarray  # (...,6) [pos(3); rot(3)] clamp, +inf = off
    max_d_err: jnp.ndarray
    use_pos: jnp.ndarray    # () 1.0/0.0
    use_rot: jnp.ndarray


def make_servo(
    pos_init=None, pos_des=None, vel_init=None, vel_des=None,
    rot_init=None, rot_des=None, w_init=None, w_des=None,
    t=0.0, t0=0.0, tf=1.0,
    pos_p=400.0, pos_d=40.0, pos_a=1.0, rot_p=400.0, rot_d=40.0,
    max_p_err=None, max_d_err=None, dtype=jnp.float32,
) -> ServoParams:
    """Convenience constructor with the reference demos' gain defaults.
    Scalars broadcast; omitted position/rotation halves disable that servo."""
    f = lambda v, shape: jnp.broadcast_to(jnp.asarray(v, dtype), shape)
    use_pos = pos_des is not None
    use_rot = rot_des is not None
    z3 = jnp.zeros(3, dtype)
    eye = jnp.eye(3, dtype=dtype)
    return ServoParams(
        t=jnp.asarray(t, dtype), t0=jnp.asarray(t0, dtype), tf=jnp.asarray(tf, dtype),
        pos_init=f(pos_init if pos_init is not None else 0.0, jnp.shape(pos_init) or (3,)) if use_pos else z3,
        vel_init=f(vel_init if vel_init is not None else 0.0, (3,)),
        pos_des=f(pos_des, jnp.shape(pos_des) or (3,)) if use_pos else z3,
        vel_des=f(vel_des if vel_des is not None else 0.0, (3,)),
        rot_init=jnp.asarray(rot_init, dtype) if rot_init is not None else eye,
        w_init=f(w_init if w_init is not None else 0.0, (3,)),
        rot_des=jnp.asarray(rot_des, dtype) if rot_des is not None else eye,
        w_des=f(w_des if w_des is not None else 0.0, (3,)),
        pos_p=f(pos_p, (3,)), pos_d=f(pos_d, (3,)), pos_a=f(pos_a, (3,)),
        rot_p=f(rot_p, (3,)), rot_d=f(rot_d, (3,)),
        max_p_err=f(max_p_err if max_p_err is not None else jnp.inf, (6,)),
        max_d_err=f(max_d_err if max_d_err is not None else jnp.inf, (6,)),
        use_pos=jnp.asarray(1.0 if use_pos else 0.0, dtype),
        use_rot=jnp.asarray(1.0 if use_rot else 0.0, dtype),
    )


def _clamp(x, lim):
    """±lim symmetric clamp (``SetPDerrorRegulation``, src/task.cpp:341-346);
    lim = +inf disables."""
    return jnp.clip(x, -lim, lim)


def servo_fstar(sp: ServoParams, pos, vel, rot, w):
    """Evaluate the trajectory + PD servo for one task link at its current
    state, returning the 6-row [f*_pos; f*_rot].

    On-device equivalent of ``GetFstarPosPD``/``GetFstarRotPD``
    (src/task.cpp:268-339): quintic position spline + slerp rotation
    trajectory, PD on the (clamped) errors, acceleration feedforward on the
    position half.  Broadcasts over leading batch dims including a batched
    clock sp.t."""
    from ..kin.rotations import (
        get_phi, matrix_to_quat, quat_slerp, quat_to_matrix, rotation_log,
    )
    from ..utils.traj import quintic_spline

    t = jnp.asarray(sp.t)[..., None]
    t0 = jnp.asarray(sp.t0)[..., None]
    tf = jnp.asarray(sp.tf)[..., None]
    z = jnp.zeros_like(sp.pos_init)
    pos_traj, vel_traj, acc_traj = quintic_spline(
        t, t0, tf, sp.pos_init, sp.vel_init, z, sp.pos_des, sp.vel_des, z
    )
    p_err = _clamp(pos_traj - pos, sp.max_p_err[..., 0:3])
    d_err = _clamp(vel_traj - vel, sp.max_d_err[..., 0:3])
    f_pos = sp.pos_a * acc_traj + sp.pos_p * p_err + sp.pos_d * d_err

    # rotation: slerp with quintic time scaling (src/task.cpp:296-339)
    s, sd, _ = quintic_spline(
        jnp.asarray(sp.t), jnp.asarray(sp.t0), jnp.asarray(sp.tf),
        0.0, 0.0, 0.0, 1.0, 0.0, 0.0,
    )
    q0 = matrix_to_quat(sp.rot_init)
    qf = matrix_to_quat(sp.rot_des)
    rot_traj = quat_to_matrix(quat_slerp(q0, qf, s))
    aa = rotation_log(sp.rot_des @ jnp.swapaxes(sp.rot_init, -1, -2))
    # during the blend the feedforward is the slerp rate; once the spline
    # completes (s=1, sd=0) it hands off to the terminal w_des
    w_traj = aa * jnp.asarray(sd)[..., None] + jnp.where(
        jnp.asarray(s)[..., None] >= 1.0, sp.w_des, 0.0
    )
    r_err = _clamp(get_phi(rot, rot_traj), sp.max_p_err[..., 3:6])
    wd_err = _clamp(w_traj - w, sp.max_d_err[..., 3:6])
    f_rot = sp.rot_p * r_err + sp.rot_d * wd_err
    return jnp.concatenate(
        jnp.broadcast_arrays(f_pos, f_rot), axis=-1
    )


_SIX_MODES = (T.TASK_LINK_6D, T.TASK_LINK_6D_COM_FRAME, T.TASK_LINK_6D_CUSTOM_FRAME)
_POS_MODES = (
    T.TASK_LINK_POSITION,
    T.TASK_LINK_POSITION_COM_FRAME,
    T.TASK_LINK_POSITION_CUSTOM_FRAME,
)


def _parse_task_spec(spec):
    """task_specs entry → (mode, link, task_point|None).  Entries are
    (mode, link) or (mode, link, (px, py, pz)) — the optional point is the
    body-frame task point of the reference's *_CUSTOM_FRAME modes
    (TaskLink::task_point_, include/dwbc_task.h:49-115)."""
    mode, link = spec[0], spec[1]
    point = np.asarray(spec[2], np.float64) if len(spec) > 2 else None
    return mode, link, point


def _plan_jacobians(model, cfg):
    """Static jacobian-narrowing plan shared by the fused and masked ticks:
    which body-origin jacobians (``J_bodies``) and body-fixed point jacobians
    (``points`` = contact points first, then custom-frame task points) the
    tick actually reads, plus per-level slots resolving each task spec to its
    jacobian source.  Declaring these lets ``Kinematics.update`` skip the
    other ~nbody origin jacobians and fuse every point into one masked pass.

    Repeated (link, point) pairs — a task point reused across levels, or one
    equal to a contact point — resolve to the SAME fused-pass row (no
    duplicate jacobian rows).  If the plan would narrow to every body anyway
    (len(J_bodies) == nbody), J_bodies comes back as None → the update runs
    un-narrowed in identity body order, so the downstream shape-based
    narrowing detection (st.J.shape[-3] != nbody) can never silently index a
    reordered array with raw body indices."""
    points = []

    def _point_slot(link, pt):
        entry = (int(link), tuple(float(x) for x in np.asarray(pt)))
        if entry not in points:
            points.append(entry)
        return points.index(entry)

    for c in cfg.contacts:
        _point_slot(c.link, c.contact_point)
    j_bodies: list[int] = []
    slots = []
    for level in cfg.task_specs:
        lvl_slots = []
        for spec in level:
            mode, link, point = _parse_task_spec(spec)
            if link == model.nbody:
                lvl_slots.append(("tot", None))
            elif mode in (T.TASK_LINK_6D_COM_FRAME, T.TASK_LINK_POSITION_COM_FRAME):
                lvl_slots.append(("com", link))
            elif point is not None and mode in (
                T.TASK_LINK_6D_CUSTOM_FRAME, T.TASK_LINK_POSITION_CUSTOM_FRAME,
            ):
                lvl_slots.append(("pt", _point_slot(link, point)))
            else:
                if int(link) not in j_bodies:
                    j_bodies.append(int(link))
                lvl_slots.append(("J", (link, j_bodies.index(int(link)))))
        slots.append(tuple(lvl_slots))
    if len(j_bodies) >= model.nbody:
        j_bodies = None  # narrowing buys nothing; keep identity order
    return (None if j_bodies is None else tuple(j_bodies)), tuple(points), tuple(slots)


def _resolve_task_jacobian(kin, model, cfg, task_slots, st, fk, level, dtype):
    """Assemble one level's task jacobian from the slot plan.  st may come
    from a narrowed update (st.J holds only the planned task links, st.J_pts
    the contact/custom points) or from a plain full update (profile
    harnesses, loop transitions) — both resolve."""
    narrowed = st.J.shape[-3] != model.nbody
    rows = []
    for spec, slot in zip(cfg.task_specs[level], task_slots[level]):
        mode, link, point = _parse_task_spec(spec)
        kind, payload = slot
        if kind == "tot":
            J6 = st.Jcom_total
        elif kind == "com":
            J6 = st.Jcom[..., payload, :, :]
        elif kind == "pt":
            if st.J_pts is not None:
                J6 = st.J_pts[..., payload, :, :]
            else:
                # custom-frame task point (UpdateTaskSpace's CalcPointJac
                # on task_point_, src/dwbc.cpp:694-716)
                J6 = kin.frame_point_jacobian(fk, link, jnp.asarray(point, dtype))
        else:
            blink, bidx = payload
            J6 = st.J[..., bidx if narrowed else blink, :, :]
        if mode in _SIX_MODES:
            rows.append(J6)
        elif mode in _POS_MODES:
            rows.append(J6[..., 0:3, :])
        else:
            rows.append(J6[..., 3:6, :])
    return jnp.concatenate(rows, axis=-2)


def _task_state(model, dtype, st, mode, link, point):
    """Current (pos, vel, rot, w) of a task link for the servo."""
    if link == model.nbody:
        pos, vel = st.com_pos, st.com_vel
        rot = jnp.broadcast_to(
            jnp.eye(3, dtype=dtype), st.com_pos.shape[:-1] + (3, 3)
        )
        return pos, vel, rot, jnp.zeros_like(vel)
    rot = st.R[..., link, :, :]
    wvel = st.w[..., link, :]
    if mode in (T.TASK_LINK_6D_COM_FRAME, T.TASK_LINK_POSITION_COM_FRAME):
        r = st.com_w[..., link, :] - st.p[..., link, :]
    elif point is not None:
        r = jnp.einsum("...ij,j->...i", rot, jnp.asarray(point, dtype))
    else:
        r = jnp.zeros_like(wvel)
    pos = st.p[..., link, :] + r
    vel = st.v[..., link, :] + jnp.cross(wvel, r)
    return pos, vel, rot, wvel


def _apply_servos(model, cfg, dtype, st, level: int, fstar, servos_level):
    """Replace f* rows whose task link carries a ServoParams with the
    on-device trajectory-PD output (UpdateTaskSpace's fstar dispatch,
    src/dwbc.cpp:685-793).  use_pos/use_rot blend per wrench half.
    Shared by CompiledTick and MaskedTick."""
    rows = []
    off = 0
    for spec, sp in zip(cfg.task_specs[level], servos_level):
        mode, link, point = _parse_task_spec(spec)
        nrows = 6 if mode in _SIX_MODES else 3
        f_in = fstar[..., off : off + nrows]
        off += nrows
        if sp is None:
            rows.append(f_in)
            continue
        pos, vel, rot, wvel = _task_state(model, dtype, st, mode, link, point)
        f6 = servo_fstar(sp, pos, vel, rot, wvel)
        up = sp.use_pos[..., None]
        ur = sp.use_rot[..., None]
        if mode in _SIX_MODES:
            fp = up * f6[..., 0:3] + (1.0 - up) * f_in[..., 0:3]
            fr = ur * f6[..., 3:6] + (1.0 - ur) * f_in[..., 3:6]
            rows.append(jnp.concatenate(jnp.broadcast_arrays(fp, fr), axis=-1))
        elif mode in _POS_MODES:
            rows.append(up * f6[..., 0:3] + (1.0 - up) * f_in)
        else:
            rows.append(ur * f6[..., 3:6] + (1.0 - ur) * f_in)
    batch = jnp.broadcast_shapes(*(r.shape[:-1] for r in rows))
    rows = [jnp.broadcast_to(r, batch + r.shape[-1:]) for r in rows]
    return jnp.concatenate(rows, axis=-1)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    contacts: tuple[T.ContactDef, ...]       # active contacts only
    task_specs: tuple[tuple[tuple, ...], ...]  # per level: ((mode, link[, point]), ...)
    torque_limit: np.ndarray | None
    qp_iters: int = 25
    use_hqp: bool = True
    # per-lane qp_error thresholds (see TickResult.qp_error / qp_error_flag)
    qp_fail_gap: float = 1e-3
    qp_fail_pres: float = 1e-3


class CompiledTick:
    """One compiled WBC tick for a fixed configuration."""

    def __init__(self, model: RobotModel, cfg: PipelineConfig, dtype=jnp.float32):
        self.model = model
        self.cfg = cfg
        self.kin = Kinematics(model)
        self.dtype = dtype
        self._J_bodies, self._points, self._task_slots = _plan_jacobians(model, cfg)
        self._tick = jax.jit(self._tick_impl, static_argnames=("qp_iters",))

    # -------------------------------------------------------------- pieces
    def _fk_from_state(self, st):
        return FK(
            R=st.R,
            p=st.p,
            axis_w=jnp.einsum(
                "...bij,bj->...bi", st.R, jnp.asarray(self.model.axis, self.dtype)
            ),
            com_w=st.com_w,
        )

    def _contact_jacobian_from_state(self, st):
        return self._contact_jacobian(self._fk_from_state(st))

    def _contact_jacobian_pts(self, st):
        """Contact jacobian rows from the fused-update point jacobians
        (st.J_pts slots 0..ncontacts-1) — no extra point-jacobian pass."""
        Js = []
        for i, c in enumerate(self.cfg.contacts):
            Js.append(
                dyn.contact_jacobian_rows(
                    st.J_pts[..., i, :, :], st.R[..., c.link, :, :], c.contact_type
                )
            )
        return jnp.concatenate(Js, axis=-2)

    def _contact_jacobian(self, fk: FK):
        Js = []
        for c in self.cfg.contacts:
            J = self.kin.frame_point_jacobian(
                fk, c.link, jnp.asarray(c.contact_point, self.dtype)
            )
            Js.append(
                dyn.contact_jacobian_rows(J, fk.R[..., c.link, :, :], c.contact_type)
            )
        return jnp.concatenate(Js, axis=-2)

    def _constraint_blocks(self, st):
        consts = []
        rots = []
        for c in self.cfg.contacts:
            consts.append(
                dyn.contact_constraint_block(
                    c.contact_type, c.plane_x, c.plane_y,
                    c.friction_ratio, c.friction_ratio_z, dtype=self.dtype,
                )
            )
            rots.append(
                dyn.contact_rotation_block(c.contact_type, st.R[..., c.link, :, :])
            )
        return contact_constraint_blocks(consts, rots)

    def _task_jacobian(self, st, fk, level: int):
        return _resolve_task_jacobian(
            self.kin, self.model, self.cfg, self._task_slots, st, fk, level,
            self.dtype,
        )

    def _task_state(self, st, mode, link, point):
        return _task_state(self.model, self.dtype, st, mode, link, point)

    def _apply_servos(self, st, level: int, fstar, servos_level):
        return _apply_servos(
            self.model, self.cfg, self.dtype, st, level, fstar, servos_level
        )

    # ------------------------------------------------------ warm-start carry
    def _level_dims(self):
        """Static (nv, rows) of each QP in the tick, in call order: one per
        task level then the redistribution QP."""
        cfg = self.cfg
        m = self.model.model_dof
        cdof = sum(c.contact_dof for c in cfg.contacts)
        cfree = cdof - 6
        k = sum(c.constraint_number for c in cfg.contacts)  # ZMP + cone rows
        lim_rows = 2 * m if cfg.torque_limit is not None else 0
        dims = []
        for level in cfg.task_specs:
            t = sum(
                6 if spec[0] in (T.TASK_LINK_6D, T.TASK_LINK_6D_COM_FRAME,
                                 T.TASK_LINK_6D_CUSTOM_FRAME) else 3
                for spec in level
            )
            dims.append((t + cfree, lim_rows + k))
        dims.append((cfree, lim_rows + k))
        return dims

    def init_warm(self, batch=()):
        """Cold-start warm state: one (x, λ) pair per QP in the tick
        (x = 0, λ = 1 — the solver's cold initial point up to slack floors)."""
        return tuple(
            (jnp.zeros(batch + (nv,), self.dtype), jnp.ones(batch + (rows,), self.dtype))
            for nv, rows in self._level_dims()
        )

    # ---------------------------------------------------------------- tick
    def _tick_impl(self, q, qdot, fstars, warm=None, qp_iters=None, servos=None):
        cfg = self.cfg
        m = self.model.model_dof
        st = self.kin.update(
            q, qdot, J_bodies=self._J_bodies, points=self._points
        )
        fk = FK(
            R=st.R,
            p=st.p,
            axis_w=jnp.einsum(
                "...bij,bj->...bi", st.R, jnp.asarray(self.model.axis, self.dtype)
            ),
            com_w=st.com_w,
        )

        J_C = self._contact_jacobian_pts(st)
        cs = dyn.contact_space(J_C, st.A_inv)
        torque_grav, P_C = dyn.gravity_compensation(
            st.A_inv, cs.W_inv, cs.N_C, cs.J_C_INV_T, st.G
        )

        tlim = (
            jnp.asarray(cfg.torque_limit, self.dtype)
            if cfg.torque_limit is not None
            else None
        )
        A_const, A_rot = self._constraint_blocks(st)

        batch = q.shape[:-1]
        eye_m = jnp.broadcast_to(jnp.eye(m, dtype=self.dtype), batch + (m, m))
        torque_task = jnp.zeros(batch + (m,), dtype=self.dtype)
        torque_contact = jnp.zeros(batch + (m,), dtype=self.dtype)
        gap = jnp.zeros(batch, dtype=self.dtype)
        pres = jnp.zeros(batch, dtype=self.dtype)
        iters = cfg.qp_iters if qp_iters is None else qp_iters
        warm_out = []

        prev_null = eye_m
        for h in range(len(cfg.task_specs)):
            J_task = self._task_jacobian(st, fk, h)
            tf = dyn.task_jkt(J_task, st.A_inv, cs.N_C, cs.W_inv)
            fstar = fstars[h]
            if servos is not None and servos[h] is not None:
                fstar = self._apply_servos(st, h, fstar, servos[h])
            if cfg.use_hqp:
                Ntorque = prev_null @ tf.J_kt @ tf.Lambda_task
                res = solve_task_level_qp(
                    Ntorque, fstar, torque_grav + torque_task,
                    cs.NwJw, cs.J_C_INV_T, P_C, A_const, A_rot, tlim,
                    iters=iters,
                    warm=None if warm is None else warm[h],
                )
                warm_out.append((res.x, res.lam))
                torque_h = jnp.einsum(
                    "...mt,...t->...m", tf.J_kt @ tf.Lambda_task,
                    fstar + res.f_star_delta,
                )
                torque_contact = jnp.einsum("...mc,...c->...m", cs.NwJw, res.contact_qp)
                gap = jnp.maximum(gap, res.gap)
                pres = jnp.maximum(pres, res.primal_res)
            else:
                torque_h = jnp.einsum(
                    "...mt,...t->...m", tf.J_kt @ tf.Lambda_task, fstar
                )
            if h == 0:
                torque_task = torque_h
            else:
                torque_task = torque_task + jnp.einsum(
                    "...mn,...n->...m", prev_null, torque_h
                )
            prev_null = dyn.task_null_space(
                tf.J_kt, tf.Lambda_task, J_task, cs.A_inv_N_C, prev_null
            )

        if cfg.use_hqp and cs.NwJw.shape[-1] > 0:
            torque_input = torque_grav + torque_task + torque_contact
            sol = solve_contact_redistribution_qp(
                torque_input, cs.NwJw, cs.J_C_INV_T, P_C, A_const, A_rot, tlim,
                iters=iters,
                warm=None if warm is None else warm[len(cfg.task_specs)],
            )
            warm_out.append((sol.x, sol.lam))
            torque_contact = torque_contact + jnp.einsum(
                "...mc,...c->...m", cs.NwJw, sol.x
            )
            gap = jnp.maximum(gap, sol.gap)
            pres = jnp.maximum(pres, sol.primal_res)

        torque_cmd = torque_grav + torque_task + torque_contact
        cforce = dyn.contact_force_from_torque(torque_cmd, cs.J_C_INV_T, P_C)
        result = TickResult(
            torque_grav=torque_grav,
            torque_task=torque_task,
            torque_contact=torque_contact,
            torque_cmd=torque_cmd,
            contact_force=cforce,
            qp_gap=gap,
            qp_primal_res=pres,
            contact_rank_health=cs.rank_health,
            qp_error=qp_error_flag(gap, pres, torque_cmd, cfg),
        )
        if warm is not None:
            return result, tuple(warm_out)
        return result

    def __call__(self, q, qdot, fstars, servos=None) -> TickResult:
        q = jnp.asarray(q, self.dtype)
        qdot = jnp.asarray(qdot, self.dtype)
        fstars = tuple(jnp.asarray(f, self.dtype) for f in fstars)
        return self._tick(q, qdot, fstars, servos=servos)

    def batched(self):
        """Batched tick over a leading scenario axis (jitted).

        The whole pipeline broadcasts over leading batch dims natively (no
        vmap), so every op sees the full batch.
        """
        return jax.jit(self._tick_impl, static_argnames=("qp_iters",))


def standard_tocabi_config(
    model: RobotModel,
    both_feet: bool = True,
    torque_limit: float = 300.0,
    qp_iters: int = 25,
    swing_task: bool = False,
) -> PipelineConfig:
    """Reference test configurations (dwbc_test.cpp:63-77): double-support
    stand, pelvis 6D + upper-body rotation tasks; optional swing-foot task
    (single support, 3-level hierarchy — BASELINE config 3)."""
    foot = dict(
        contact_type=T.CONTACT_6D,
        contact_point=np.array([0.03, 0.0, -0.1585]),
        contact_direction=np.array([0.0, 0.0, 1.0]),
        plane_x=0.15,
        plane_y=0.075,
        active=True,
    )
    contacts = [T.ContactDef(link=6, **foot)]
    if both_feet:
        contacts.append(T.ContactDef(link=12, **foot))
    task_specs = [((T.TASK_LINK_6D, 0),), ((T.TASK_LINK_ROTATION, 15),)]
    if swing_task:
        task_specs.append(((T.TASK_LINK_6D, 12),))  # swing right foot
    return PipelineConfig(
        contacts=tuple(contacts),
        task_specs=tuple(tuple(s) for s in task_specs),
        torque_limit=np.full(model.model_dof, torque_limit),
        qp_iters=qp_iters,
    )
