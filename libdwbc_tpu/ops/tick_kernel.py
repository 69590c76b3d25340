"""The fused WBC tick as ONE element-leading program: q → τ.

The tick's stages are many small matrix ops; as separate XLA ops their
(B, 39, 39)-ish intermediates round-trip device memory between fusions.
Here the ENTIRE tick — forward kinematics, point jacobians, the mass matrix
via a world-frame composite-rigid-body pass, A⁻¹, the contact-space
factorization, per-level JKT, constraint assembly, and the three IPM QPs —
is one program in the element-leading layout of ops/elemlin, traced as one
XLA graph (wbc/fused.py).

Reference parity: this computes exactly the quantities of the per-tick call
sequence UpdateKinematics → CalcContactConstraint → CalcGravCompensation →
CalcTaskControlTorque → CalcContactRedistribute
(/root/reference/src/dwbc.cpp:279-1620, SURVEY.md §3.1), with the same
algorithmic substitutions already golden-validated in kin/engine.py,
wbc/dynamics.py, wbc/hqp.py and ops/qp.py:

* mass matrix: composite-rigid-body at the WORLD ORIGIN — spatial inertias
  are summed up the tree in world coordinates (plain adds, no X-transforms)
  and A[i,j] = S_i·(I^C_{body(j)} S_j) over ancestor dof pairs.
  Algebraically identical to RBDL's CRBA (src/dwbc.cpp:305) and to the
  KE-metric Gram form in kin/engine.py::mass_matrix, but needs NO body
  jacobians at all — the single biggest memory/FLOP saving of the fused path;
* gravity vector: G = −A[0:3,:]ᵀ·g — the reference's COM-jacobian-transpose
  form (src/dwbc.cpp:358) collapsed through CMM[0:3] = A[0:3] (the
  cm_rot6 top rows are [I 0], src/dwbc.cpp:331-341);
* contact space / JKT / QPs: elem-leading transposes of
  wbc/dynamics.py::contact_space/task_jkt and wbc/hqp.py's assembly, with
  N_C never materialized (J A⁻¹N_C = JA⁻¹ − (JA⁻¹J_Cᵀ)J̄_cᵀ);
* IPM: the predictor–corrector recurrence of ops/qp.py (same floors,
  caps, freeze rule, warm-start split steps, NaN guard).

Everything here is layout-agnostic over trailing batch dims (CPU f64
parity tests in tests/test_fused_tick.py).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from . import elemlin as el
from ..wbc import types as T


def _np_zmp_block(lx, ly):
    Z = np.zeros((4, 6))
    Z[0, 2], Z[0, 4] = -lx, -1.0
    Z[1, 2], Z[1, 4] = -lx, 1.0
    Z[2, 2], Z[2, 3] = -ly, -1.0
    Z[3, 2], Z[3, 3] = -ly, 1.0
    return Z


def _np_force_block(mu, mu_z):
    F = np.zeros((6, 6))
    F[0, 0], F[0, 2] = 1.0, -mu
    F[1, 0], F[1, 2] = -1.0, -mu
    F[2, 1], F[2, 2] = 1.0, -mu
    F[3, 1], F[3, 2] = -1.0, -mu
    F[4, 5], F[4, 2] = 1.0, -mu_z
    F[5, 5], F[5, 2] = -1.0, -mu_z
    return F


def _np_constraint_block(c):
    """Static per-contact constraint block (wbc/dynamics.py:273-285)."""
    Z = _np_zmp_block(c.plane_x, c.plane_y)
    F = _np_force_block(c.friction_ratio, c.friction_ratio_z)
    if c.contact_type == T.CONTACT_6D:
        return np.concatenate([Z, F], axis=0)
    if c.contact_type == T.CONTACT_POINT:
        return F[:, 0:3]
    if c.contact_type == T.CONTACT_LINE:
        cols = [0, 1, 2, 4, 5]
        return np.concatenate([Z[0:2][:, cols], F[:, cols]], axis=0)
    raise ValueError(c.contact_type)


_SIX = (T.TASK_LINK_6D, T.TASK_LINK_6D_COM_FRAME, T.TASK_LINK_6D_CUSTOM_FRAME)
_POS = (T.TASK_LINK_POSITION, T.TASK_LINK_POSITION_COM_FRAME,
        T.TASK_LINK_POSITION_CUSTOM_FRAME)
_COM_FRAME = (T.TASK_LINK_6D_COM_FRAME, T.TASK_LINK_POSITION_COM_FRAME)

# elem shapes of ServoParams fields (wbc/pipeline.py::ServoParams) — used by
# wbc/fused.py to tell batched from unbatched leaves
SERVO_ELEM_SHAPES = dict(
    t=(), t0=(), tf=(), use_pos=(), use_rot=(),
    pos_init=(3,), vel_init=(3,), pos_des=(3,), vel_des=(3,),
    w_init=(3,), w_des=(3,), pos_p=(3,), pos_d=(3,), pos_a=(3,),
    rot_p=(3,), rot_d=(3,), rot_init=(3, 3), rot_des=(3, 3),
    max_p_err=(6,), max_d_err=(6,),
)


# --------------------------------------------------------------------------
# Element-leading rotation/servo primitives (mirrors of kin/rotations.py and
# wbc/pipeline.py::servo_fstar / utils/traj.py::quintic_spline)
# --------------------------------------------------------------------------

def _quat_to_matrix_el(qv):
    """(4,)+bt (x,y,z,w) → (3,3)+bt (kin/rotations.py:25-50)."""
    x, y, z, w = qv[0], qv[1], qv[2], qv[3]
    n = x * x + y * y + z * z + w * w
    s = jnp.where(n > 0, 2.0 / n, 0.0)
    xs, ys, zs = x * s, y * s, z * s
    wx, wy, wz = w * xs, w * ys, w * zs
    xx, xy, xz = x * xs, x * ys, x * zs
    yy, yz, zz = y * ys, y * zs, z * zs
    return jnp.stack([
        jnp.stack([1.0 - (yy + zz), xy - wz, xz + wy], axis=0),
        jnp.stack([xy + wz, 1.0 - (xx + zz), yz - wx], axis=0),
        jnp.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], axis=0),
    ], axis=0)


def _matrix_to_quat_el(R):
    """(3,3)+bt → (4,)+bt, 4-branch via where (kin/rotations.py:53-92)."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22
    qw0 = jnp.sqrt(jnp.maximum(1.0 + tr, 1e-30)) / 2.0
    q0 = jnp.stack([(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                    (m10 - m01) / (4 * qw0), qw0], axis=0)
    qx1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 1e-30)) / 2.0
    q1 = jnp.stack([qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1),
                    (m21 - m12) / (4 * qx1)], axis=0)
    qy2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 1e-30)) / 2.0
    q2 = jnp.stack([(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2),
                    (m02 - m20) / (4 * qy2)], axis=0)
    qz3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 1e-30)) / 2.0
    q3 = jnp.stack([(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3,
                    (m10 - m01) / (4 * qz3)], axis=0)
    use0 = (tr > 0.0)[None]
    usex = ((m00 >= m11) & (m00 >= m22))[None]
    usey = (m11 >= m22)[None]
    q = jnp.where(use0, q0, jnp.where(usex, q1, jnp.where(usey, q2, q3)))
    return q * jnp.where(q[3:4] < 0, -1.0, 1.0)


def _quat_slerp_el(q0, q1, t):
    """(4,)+bt, (4,)+bt, (*bt) → (4,)+bt (kin/rotations.py:121-133)."""
    d = jnp.sum(q0 * q1, axis=0)
    q1 = jnp.where(d[None] < 0, -q1, q1)
    d = jnp.clip(jnp.abs(d), -1.0, 1.0)
    theta = jnp.arccos(d)
    sin_theta = jnp.sin(theta)
    small = sin_theta < 1e-8
    denom = jnp.where(small, 1.0, sin_theta)
    w0 = jnp.where(small, 1.0 - t, jnp.sin((1.0 - t) * theta) / denom)
    w1 = jnp.where(small, t, jnp.sin(t * theta) / denom)
    out = w0[None] * q0 + w1[None] * q1
    return out / jnp.sqrt(jnp.sum(out * out, axis=0))[None]


def _rotation_log_el(R):
    """(3,3)+bt → angle·axis (3,)+bt (kin/rotations.py:136-151)."""
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    theta = jnp.arccos(jnp.clip((tr - 1.0) / 2.0, -1.0, 1.0))
    v = jnp.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]],
                  axis=0)
    sin_t = jnp.sin(theta)
    small = jnp.abs(sin_t) < 1e-8
    scale = jnp.where(small, 0.5, theta / (2.0 * jnp.where(small, 1.0, sin_t)))
    return v * scale[None]


def _get_phi_el(Rc, Rd):
    """0.5 Σ_i col_i(Rc) × col_i(Rd) (DWBC::GetPhi, src/math.cpp:276-291)."""
    s = el.cross(Rc[:, 0], Rd[:, 0])
    s = s + el.cross(Rc[:, 1], Rd[:, 1])
    s = s + el.cross(Rc[:, 2], Rd[:, 2])
    return 0.5 * s


def _quintic_el(t, t0, tf, x0, v0, xf, vf):
    """Quintic with zero boundary accelerations on (k,)+bt endpoints and
    (*bt) clocks (utils/traj.py::quintic_spline, a0 = af = 0)."""
    ts = tf - t0
    ts2, ts3, ts4, ts5 = ts * ts, ts**3, ts**4, ts**5
    b1 = xf - x0 - v0 * ts[None]
    b2 = vf - v0
    a4 = (20.0 * b1 - 8.0 * b2 * ts[None]) / (2.0 * ts3)[None]
    a5 = (-30.0 * b1 + 14.0 * b2 * ts[None]) / (2.0 * ts4)[None]
    a6 = (12.0 * b1 - 6.0 * b2 * ts[None]) / (2.0 * ts5)[None]
    tc = (jnp.clip(t, t0, tf) - t0)[None]
    pos = x0 + v0 * tc + a4 * tc**3 + a5 * tc**4 + a6 * tc**5
    vel = v0 + 3 * a4 * tc**2 + 4 * a5 * tc**3 + 5 * a6 * tc**4
    acc = 6 * a4 * tc + 12 * a5 * tc**2 + 20 * a6 * tc**3
    before = (t < t0)[None]
    after = (t > tf)[None]
    pos = jnp.where(before, x0, jnp.where(after, xf, pos))
    vel = jnp.where(before, v0, jnp.where(after, vf, vel))
    acc = jnp.where(before | after, 0.0, acc)
    return pos, vel, acc


def _servo_fstar_el(sp, pos, vel, rot, w):
    """Trajectory + PD servo, elem-leading mirror of
    wbc/pipeline.py::servo_fstar (quintic position spline, slerp rotation
    trajectory, SetPDerrorRegulation clamps).  sp: dict of elem-leading
    ServoParams fields.  Returns (6,)+bt [f*_pos; f*_rot]."""
    clip = lambda x, lim: jnp.clip(x, -lim, lim)
    pos_traj, vel_traj, acc_traj = _quintic_el(
        sp["t"], sp["t0"], sp["tf"],
        sp["pos_init"], sp["vel_init"], sp["pos_des"], sp["vel_des"],
    )
    p_err = clip(pos_traj - pos, sp["max_p_err"][0:3])
    d_err = clip(vel_traj - vel, sp["max_d_err"][0:3])
    f_pos = sp["pos_a"] * acc_traj + sp["pos_p"] * p_err + sp["pos_d"] * d_err

    z = jnp.zeros_like(sp["t"])[None]
    s_sc, sd_sc, _ = _quintic_el(
        sp["t"], sp["t0"], sp["tf"], z, z, z + 1.0, z
    )
    s_sc, sd_sc = s_sc[0], sd_sc[0]
    q0 = _matrix_to_quat_el(sp["rot_init"])
    qf = _matrix_to_quat_el(sp["rot_des"])
    rot_traj = _quat_to_matrix_el(_quat_slerp_el(q0, qf, s_sc))
    aa = _rotation_log_el(el.mmT(sp["rot_des"], sp["rot_init"]))
    w_traj = aa * sd_sc[None] + jnp.where(
        s_sc[None] >= 1.0, sp["w_des"], 0.0
    )
    r_err = clip(_get_phi_el(rot, rot_traj), sp["max_p_err"][3:6])
    wd_err = clip(w_traj - w, sp["max_d_err"][3:6])
    f_rot = sp["rot_p"] * r_err + sp["rot_d"] * wd_err
    return jnp.concatenate([f_pos, f_rot], axis=0)


_ROW_MASK = {
    T.CONTACT_6D: np.ones(6),
    T.CONTACT_POINT: np.array([1.0, 1, 1, 0, 0, 0]),
    T.CONTACT_LINE: np.array([1.0, 1, 1, 0, 1, 1]),
}
_CROW_MASK = {
    T.CONTACT_6D: np.ones(10),
    T.CONTACT_POINT: np.array([0.0, 0, 0, 0, 1, 1, 1, 1, 1, 1]),
    T.CONTACT_LINE: np.array([1.0, 1, 0, 0, 1, 1, 1, 1, 1, 1]),
}


class TickProgram:
    """Static plan + element-leading implementation of one tick config.

    model: RobotModel; cfg: wbc.pipeline.PipelineConfig.

    masked=True: the multi-contact-mode tick (wbc/masked.py semantics) —
    contacts are a CANDIDATE set padded to 6 rows each, and prestage takes
    a per-scenario contact_mask (nc,)+bt selecting the active subset, so a
    single kernel covers every support hypothesis in one batch.
    """

    def __init__(self, model, cfg, dtype=jnp.float32, masked=False):
        self.model = model
        self.cfg = cfg
        self.dtype = dtype
        self.masked = masked
        m = model
        self.nbody = int(m.nbody)
        self.ndof = int(m.ndof)
        self.mdof = int(m.model_dof)
        assert m.floating, "fused tick: floating-base models only"

        self.parent = [int(x) for x in m.parent]
        self.q_index = [int(x) for x in m.q_index]
        self.axis = np.asarray(m.axis, np.float64)
        self.X_rot = np.asarray(m.X_T_rot, np.float64)
        self.X_trans = np.asarray(m.X_T_trans, np.float64)
        self.com = np.asarray(m.com, np.float64)
        self.inertia = np.asarray(m.inertia, np.float64)
        self.mass = np.asarray(m.mass, np.float64)
        self.amask = np.asarray(m.ancestor_mask, np.float64)
        self.gravity = np.asarray(m.gravity, np.float64)
        self.total_mass = float(m.total_mass)

        # dof owners (body carrying each joint dof; base dofs -> body 0)
        owner = np.zeros(self.ndof, np.int32)
        for i in range(1, self.nbody):
            owner[self.q_index[i]] = i
        self.owner = [int(x) for x in owner]

        # ancestor dof lists per dof (for the CRBA fill): dofs k with
        # amask[body(j)][k] == 1 are exactly the chain dofs root→body(j)
        self.anc_dofs = [
            [k for k in range(self.ndof) if self.amask[self.owner[j], k] > 0.5]
            for j in range(self.ndof)
        ]

        # ---- unified point-jacobian plan: contacts first, then task points
        self._points: list[tuple[int, tuple[float, float, float]]] = []

        def point_slot(link, pt):
            e = (int(link), tuple(float(x) for x in np.asarray(pt)))
            if e not in self._points:
                self._points.append(e)
            return self._points.index(e)

        self.contact_slots = []
        for c in cfg.contacts:
            self.contact_slots.append(point_slot(c.link, c.contact_point))
        self.task_slots = []          # per level: list of (kind, payload, mode)
        self.uses_tot = False
        for level in cfg.task_specs:
            lv = []
            for spec in level:
                mode, link = spec[0], spec[1]
                pt = np.asarray(spec[2], np.float64) if len(spec) > 2 else None
                if link == self.nbody:
                    lv.append(("tot", None, mode))
                    self.uses_tot = True
                elif mode in _COM_FRAME:
                    lv.append(("pt", point_slot(link, self.com[link]), mode))
                elif pt is not None and mode in (
                    T.TASK_LINK_6D_CUSTOM_FRAME, T.TASK_LINK_POSITION_CUSTOM_FRAME,
                    T.TASK_LINK_ROTATION_CUSTOM_FRAME,
                ):
                    lv.append(("pt", point_slot(link, pt), mode))
                else:
                    lv.append(("pt", point_slot(link, (0.0, 0.0, 0.0)), mode))
            self.task_slots.append(lv)
        self.level_tdofs = [
            sum(6 if mode in _SIX else 3 for _, _, mode in lv)
            for lv in self.task_slots
        ]

        # contacts static data
        if masked:
            # padded layout: every candidate gets 6 jacobian rows + the full
            # (10,6) [ZMP; cone] block; per-type dead rows are statically
            # masked, per-scenario inactive contacts dynamically masked
            nc = len(cfg.contacts)
            self.cdof = 6 * nc
            self.cfree = max(self.cdof - 6, 0)
            self.const_blocks = [
                np.concatenate(
                    [_np_zmp_block(c.plane_x, c.plane_y),
                     _np_force_block(c.friction_ratio, c.friction_ratio_z)],
                    axis=0,
                )
                for c in cfg.contacts
            ]
            self.k_rows = 10 * nc
            self.type_row_masks = [_ROW_MASK[c.contact_type] for c in cfg.contacts]
            self.type_crow_masks = [_CROW_MASK[c.contact_type] for c in cfg.contacts]
        else:
            self.cdof = sum(c.contact_dof for c in cfg.contacts)
            self.cfree = max(self.cdof - 6, 0)
            self.const_blocks = [_np_constraint_block(c) for c in cfg.contacts]
            self.k_rows = sum(b.shape[0] for b in self.const_blocks)
        self.tlim = (None if cfg.torque_limit is None
                     else np.asarray(cfg.torque_limit, np.float64))

        # QP dims per level + redistribution (must mirror
        # pipeline.CompiledTick._level_dims for warm-carry compatibility)
        lim_rows = 2 * self.mdof if self.tlim is not None else 0
        self.qp_dims = [
            (t + self.cfree, lim_rows + self.k_rows) for t in self.level_tdofs
        ]
        if self.cfree > 0:
            self.qp_dims.append((self.cfree, lim_rows + self.k_rows))

    # ----------------------------------------------------------- prestage
    def prestage(self, q, cmask=None, qdot=None, servo_req=None):
        """q (nq,)+bt → dict of everything the QP chain + result need.
        cmask (nc,)+bt: per-scenario contact activity (masked mode only).
        servo_req: static per-level/per-spec booleans — compute those task
        links' (pos, vel, rot, w) for the on-device servo (needs qdot).

        Kernel-safe: all static model data enters as Python scalar literals
        (elemlin's *_ds/*_sd/svec helpers) — no captured array constants —
        and structural zeros in axes/transforms/constraint blocks cost
        nothing."""
        dtype = q.dtype
        zero = q[0] * 0.0

        # ---------------- FK (mirror of kin/engine.py::fk)
        x_, y_, z_, w_ = q[3], q[4], q[5], q[self.ndof]
        n2 = x_ * x_ + y_ * y_ + z_ * z_ + w_ * w_
        s = jnp.where(n2 > 0, 2.0 / n2, 0.0)
        xs, ys, zs = x_ * s, y_ * s, z_ * s
        wx, wy, wz = w_ * xs, w_ * ys, w_ * zs
        xx, xy, xz = x_ * xs, x_ * ys, x_ * zs
        yy, yz, zz = y_ * ys, y_ * zs, z_ * zs
        R0 = jnp.stack([
            jnp.stack([1.0 - (yy + zz), xy - wz, xz + wy], axis=0),
            jnp.stack([xy + wz, 1.0 - (xx + zz), yz - wx], axis=0),
            jnp.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], axis=0),
        ], axis=0)
        p0 = q[0:3]

        def rodrigues(a, c_, s_):
            """c·I + s·K + (1-c)aaᵀ with STATIC axis a
            (kin/rotations.py:95-103); zero entries skipped."""
            K = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]],
                          [-a[1], a[0], 0.0]])
            aaT = np.outer(a, a)
            omc = 1.0 - c_
            rows = []
            for i in range(3):
                row = []
                for j in range(3):
                    acc = None
                    if i == j:
                        acc = c_
                    if K[i, j] != 0.0:
                        t = s_ * float(K[i, j])
                        acc = t if acc is None else acc + t
                    if aaT[i, j] != 0.0:
                        t = omc * float(aaT[i, j])
                        acc = t if acc is None else acc + t
                    row.append(zero if acc is None else acc)
                rows.append(jnp.stack(row, axis=0))
            return jnp.stack(rows, axis=0)

        R = [R0]
        p = [p0]
        axis_w = [jnp.stack([zero, zero, zero], axis=0)]
        com_w = [p0 + el.mv_ds(R0, self.com[0])]
        for i in range(1, self.nbody):
            par = self.parent[i]
            qi = q[self.q_index[i]]
            Rj = rodrigues(self.axis[i], jnp.cos(qi), jnp.sin(qi))
            Ri = el.mm(R[par], el.mm_sd(self.X_rot[i], Rj))
            pi = p[par] + el.mv_ds(R[par], self.X_trans[i])
            R.append(Ri)
            p.append(pi)
            axis_w.append(el.mv_ds(Ri, self.axis[i]))
            com_w.append(pi + el.mv_ds(Ri, self.com[i]))

        # ---------------- dof frames (kin/engine.py::_dof_frames)
        ax_cols, og_cols = [], []
        for k in range(3):
            e = [0.0, 0.0, 0.0]
            e[k] = 1.0
            ax_cols.append(el.svec(e, zero))
            og_cols.append(p0)
        for k in range(3):
            ax_cols.append(R0[:, k])
            og_cols.append(p0)
        for j in range(6, self.ndof):
            b = self.owner[j]
            ax_cols.append(axis_w[b])
            og_cols.append(p[b])
        ax = jnp.stack(ax_cols, axis=1)                 # (3, ndof)+bt
        og = jnp.stack(og_cols, axis=1)

        # ---------------- point jacobians (one per planned point)
        # base-translation dofs (cols 0:3) are pure linear (jv = axis,
        # jw = 0); every other dof is revolute — handled by column splits
        # instead of an is_trans mask
        mask_cache = {}

        def link_mask(link):
            if link not in mask_cache:
                mask_cache[link] = el.svec(self.amask[link], zero)
            return mask_cache[link]

        J_pts = []
        for link, pt in self._points:
            if any(pt):
                pw = p[link] + el.mv_ds(R[link], np.asarray(pt))
            else:
                pw = p[link]
            rel = pw[:, None] - og                       # (3, ndof)+bt
            jvr = jnp.stack([
                ax[1] * rel[2] - ax[2] * rel[1],
                ax[2] * rel[0] - ax[0] * rel[2],
                ax[0] * rel[1] - ax[1] * rel[0],
            ], axis=0)
            jv = jnp.concatenate([ax[:, 0:3], jvr[:, 3:]], axis=1)
            jw = jnp.concatenate([ax[:, 0:3] * 0.0, ax[:, 3:]], axis=1)
            mask = link_mask(link)[None]
            J_pts.append(jnp.concatenate([jv * mask, jw * mask], axis=0))

        # ---------------- mass matrix: world-origin composite rigid body
        IC = [None] * self.nbody
        for i in range(self.nbody):
            mi = float(self.mass[i])
            if mi == 0.0 and not self.inertia[i].any():
                continue                                  # massless pseudo-body
            Icm = el.mmT(el.mm_ds(R[i], self.inertia[i]), R[i])
            c3 = com_w[i]
            cc = el.dot(c3, c3)
            # I_ang = Icm + m(|c|²I − ccᵀ)
            I_ang = el.diag_add(Icm - mi * el.outer(c3, c3),
                                [mi * cc, mi * cc, mi * cc])
            chat = jnp.stack([
                jnp.stack([zero, -c3[2], c3[1]], axis=0),
                jnp.stack([c3[2], zero, -c3[0]], axis=0),
                jnp.stack([-c3[1], c3[0], zero], axis=0),
            ], axis=0)
            mEye = el.smat(mi * np.eye(3), zero)
            top = jnp.concatenate([I_ang, mi * chat], axis=1)
            bot = jnp.concatenate([-mi * chat, mEye], axis=1)
            IC[i] = jnp.concatenate([top, bot], axis=0)   # (6,6)+bt
        for i in range(self.nbody - 1, 0, -1):
            if IC[i] is None:
                continue
            par = self.parent[i]
            IC[par] = IC[i] if IC[par] is None else IC[par] + IC[i]

        def S_of_dof(j):
            if j < 3:
                e = [0.0] * 6
                e[3 + j] = 1.0
                return el.svec(e, zero)
            a3 = ax[:, j]
            o3 = og[:, j]
            return jnp.concatenate([a3, el.cross(o3, a3)], axis=0)

        S = [S_of_dof(j) for j in range(self.ndof)]
        A_entries = {}
        for j in range(self.ndof):
            if IC[self.owner[j]] is None:
                continue                                  # massless subtree
            f = el.mv(IC[self.owner[j]], S[j])           # (6,)+bt
            for i in self.anc_dofs[j]:
                if i <= j:
                    A_entries[(i, j)] = el.dot(S[i], f)
        rows = []
        for i in range(self.ndof):
            row = []
            for j in range(self.ndof):
                e = A_entries.get((min(i, j), max(i, j)))
                row.append(zero if e is None else e)
            rows.append(jnp.stack(row, axis=0))
        A = jnp.stack(rows, axis=0)                      # (ndof, ndof)+bt

        # gravity vector: G = −A[0:3,:]ᵀ g  (see module docstring)
        G = None
        for i in range(3):
            gi = float(self.gravity[i])
            if gi == 0.0:
                continue
            t = A[i] * (-gi)
            G = t if G is None else G + t

        A_inv = el.psd_inverse(A)

        out = dict(health=None)

        # Jcom_total rows (only when a task targets the virtual COM link)
        if self.uses_tot:
            M = self.total_mass
            skm = el.mm(R0, A[3:6, 0:3]) / M
            cfb = jnp.stack([skm[2, 1], skm[0, 2], skm[1, 0]], axis=0)
            cfb_hat = jnp.stack([
                jnp.stack([zero, -cfb[2], cfb[1]], axis=0),
                jnp.stack([cfb[2], zero, -cfb[0]], axis=0),
                jnp.stack([-cfb[1], cfb[0], zero], axis=0),
            ], axis=0)
            CMM_bot = (el.mm(el.transpose(cfb_hat), A[0:3])
                       + el.mm(R0, A[3:6]))
            com_inertia = (el.mm(el.mm(R0, A[3:6, 3:6]), el.transpose(R0))
                           - M * el.mm(cfb_hat, el.transpose(cfb_hat)))
            # solve com_inertia X = CMM_bot (SPD 3×3, chol fwd/back subst)
            Lci = el.chol(com_inertia)
            y = el.solve_lower(Lci, CMM_bot)
            U = el.transpose(Lci)
            xs = [None] * 3
            for i2 in reversed(range(3)):
                acc = y[i2]
                for k2 in range(i2 + 1, 3):
                    acc = acc - U[i2, k2][None] * xs[k2]
                xs[i2] = acc / U[i2, i2][None]
            Jt_bot = jnp.stack(xs, axis=0)
            out["Jcom_total"] = jnp.concatenate([A[0:3] / M, Jt_bot], axis=0)

        # ---------------- servo task-link states (pipeline._task_state)
        if servo_req is not None and any(any(lv) for lv in servo_req):
            assert qdot is not None, "servo'd fused tick needs qdot"
            # per-body velocities (kin/engine.py::velocities, world frame)
            w_b = [el.mv(R0, qdot[3:6])]
            v_b = [qdot[0:3]]
            for i in range(1, self.nbody):
                par = self.parent[i]
                qd_i = qdot[self.q_index[i]]
                w_b.append(w_b[par] + axis_w[i] * qd_i[None])
                v_b.append(v_b[par] + el.cross(w_b[par], p[i] - p[par]))
            tstates = {}
            for h, lv in enumerate(servo_req):
                for j, need in enumerate(lv):
                    if not need:
                        continue
                    kind, payload, mode = self.task_slots[h][j]
                    if kind == "tot":
                        M = self.total_mass
                        skm2 = el.mm(R0, A[3:6, 0:3]) / M
                        cpos = jnp.stack(
                            [skm2[2, 1], skm2[0, 2], skm2[1, 0]], axis=0
                        ) + q[0:3]
                        cvel = el.mv(out["Jcom_total"], qdot)[0:3]
                        tstates[(h, j)] = (
                            cpos, cvel, el.eye(3, zero),
                            jnp.stack([zero, zero, zero], axis=0),
                        )
                    else:
                        link, pt = self._points[payload]
                        rot = R[link]
                        wv = w_b[link]
                        if any(pt):
                            rr = el.mv_ds(rot, np.asarray(pt))
                            ppos = p[link] + rr
                            pvel = v_b[link] + el.cross(wv, rr)
                        else:
                            ppos = p[link]
                            pvel = v_b[link]
                        tstates[(h, j)] = (ppos, pvel, rot, wv)
            out["task_states"] = tstates

        # ---------------- contact jacobian rows (per type)
        row_mask = None
        if self.masked:
            # padded 6-row blocks per candidate; LINE rotation rows go
            # contact-local so the statically-dead row is the local-x moment
            Jc_rows = []
            rm_entries = []
            for i, (slot, c) in enumerate(
                zip(self.contact_slots, self.cfg.contacts)
            ):
                J6 = J_pts[slot]
                if c.contact_type == T.CONTACT_LINE:
                    Jloc = el.mm(el.transpose(R[c.link]), J6[3:6])
                    J6 = jnp.concatenate([J6[0:3], Jloc], axis=0)
                Jc_rows.append(J6)
                tm = self.type_row_masks[i]
                for r6 in range(6):
                    rm_entries.append(
                        cmask[i] * float(tm[r6]) if tm[r6] != 0.0 else zero
                    )
            J_C = jnp.concatenate(Jc_rows, axis=0)       # (6nc, ndof)+bt
            row_mask = jnp.stack(rm_entries, axis=0)     # (6nc,)+bt
            J_C = J_C * row_mask[:, None]
        else:
            Jc_rows = []
            for slot, c in zip(self.contact_slots, self.cfg.contacts):
                J6 = J_pts[slot]
                if c.contact_type == T.CONTACT_6D:
                    Jc_rows.append(J6)
                elif c.contact_type == T.CONTACT_POINT:
                    Jc_rows.append(J6[0:3])
                else:  # CONTACT_LINE
                    Jloc = el.mm(el.transpose(R[c.link]), J6[3:6])
                    Jc_rows.append(
                        jnp.concatenate([J6[0:3], Jloc[1:3]], axis=0)
                    )
            J_C = jnp.concatenate(Jc_rows, axis=0)       # (cdof, ndof)+bt

        # ---------------- contact space (wbc/dynamics.py::contact_space /
        # wbc/masked.py::masked_contact_space).  All Gram-type products use
        # the *_sym kernels (exact symmetry by construction — the explicit
        # 0.5(M+Mᵀ) symmetrizations they replace are gone) and every SPD
        # inverse goes through the triangular-structure-aware psd_inverse;
        # together with the factored W-apply below this removed ~35% of the
        # prestage FLOPs vs the r04 kernel (sol_tick artifacts).
        JAinv = el.mm(J_C, A_inv)
        Mc = el.mmT_sym(JAinv, J_C)
        if self.masked:
            # +1 on inactive diagonal → the active block inverts exactly
            Mc = el.diag_add(Mc, [1.0 - row_mask[i] for i in range(self.cdof)])
        health = jnp.minimum(
            el.chol_health(Mc),
            el.chol_health(el.mTm_sym(J_C[:, 0:6], J_C[:, 0:6])),
        )
        Lambda_c = el.psd_inverse(Mc)
        if self.masked:
            Lambda_c = Lambda_c * row_mask[:, None] * row_mask[None]
        Jbar = el.mm(Lambda_c, JAinv)                    # J̄_cᵀ (cdof, ndof)+bt
        P_C = el.mv(Jbar, G)
        NCG = G - el.mTv(J_C, P_C)

        Wfree = (A_inv[6:, 6:]
                 - el.mTm_sym(JAinv[:, 6:], Jbar[:, 6:]))

        # W⁻¹ is never materialized: its only consumers are torque_grav and
        # the per-level W⁻¹Qᵀ — both are triangular solves against the
        # Cholesky factor of (Wfree + VVᵀ) plus a rank-cfree correction
        # (W⁻¹ = (Wfree+VVᵀ)⁻¹ − VVᵀ), which costs ~n²/RHS instead of the
        # ~2n³/3 explicit inverse.
        W_corr = None                                     # V2T or None
        if self.cfree > 0 and not self.masked:
            Ny = el.complete_basis(J_C[:, 0:6])[:, 6:]   # (cdof, cfree)+bt
            V2T = el.qr_thin(el.mTm(J_C[:, 6:], Ny))     # (mdof, cfree)+bt
            VVt = el.mmT_sym(V2T, V2T)
            L_W, idg_W = el.chol_factor(Wfree + VVt)
            W_corr = V2T
            NwJw = el.mm(V2T, el.qr_pinv(el.mm(Jbar[0:self.cfree, 6:], V2T)))
        elif self.cfree > 0:
            # masked kernel basis: rank = active_cdof − 6 ≤ cfree; dead
            # directions become ZERO columns, compacted left; NwJw
            # normalizes against the first (active_cdof − 6) ACTIVE rows of
            # J̄ᵀ via an in-graph selection (masked.py:142-155)
            Ny = el.complete_basis(J_C[:, 0:6])[:, 6:]
            V2T = el.orthonormalize_drop(el.mTm(J_C[:, 6:], Ny))
            V2T, _ = el.compact_columns(V2T)
            P_k = el.mmT_sym(V2T, V2T)
            L_W, idg_W = el.chol_factor(Wfree + P_k)
            W_corr = V2T
            c_act = jnp.sum(row_mask, axis=0)            # (*bt)
            # idx[i] = (# active rows ≤ i) − 1
            idx = []
            acc = None
            for i in range(self.cdof):
                acc = row_mask[i] if acc is None else acc + row_mask[i]
                idx.append(acc - 1.0)
            lim = c_act - 6.0
            JbV = el.mm(Jbar[:, 6:], V2T)                # (cdof, cfree)+bt
            inner_rows = []
            for t in range(self.cfree):
                accr = None
                for i in range(self.cdof):
                    w = (row_mask[i]
                         * (jnp.abs(idx[i] - t) < 0.5).astype(dtype)
                         * (t < lim).astype(dtype))
                    term = JbV[i] * w[None]
                    accr = term if accr is None else accr + term
                inner_rows.append(accr)
            inner = jnp.stack(inner_rows, axis=0)        # (cfree, cfree)+bt
            live = [
                (jnp.zeros_like(c_act) + t < lim).astype(dtype)
                for t in range(self.cfree)
            ]
            livev = jnp.stack(live, axis=0)              # (cfree,)+bt
            inner = inner * livev[:, None] * livev[None]
            inner = el.diag_add(inner, [1.0 - live[t] for t in range(self.cfree)])
            NwJw = el.mm(V2T, el.qr_pinv(inner)) * livev[None]
        else:
            L_W, idg_W = el.chol_factor(Wfree)
            NwJw = None

        def W_apply(Bm):
            """W⁻¹ @ Bm for a (mdof, t)+bt RHS (factored form above)."""
            Y = el.cho_solve_mat(L_W, idg_W, Bm)
            if W_corr is not None:
                Y = Y - el.mm(W_corr, el.mTm(W_corr, Bm))
            return Y

        torque_grav = W_apply(el.mv(A_inv[6:], NCG)[:, None])[:, 0]

        # ---------------- per-level JKT + Ntorque (dynamics.task_jkt)
        Ntorques = []
        prev_null = None                                  # None == identity
        for lv, slots in enumerate(self.task_slots):
            trows = []
            for kind, payload, mode in slots:
                J6 = out["Jcom_total"] if kind == "tot" else J_pts[payload]
                if mode in _SIX:
                    trows.append(J6)
                elif mode in _POS:
                    trows.append(J6[0:3])
                else:
                    trows.append(J6[3:6])
            J_task = jnp.concatenate(trows, axis=0)       # (t, ndof)+bt
            JtA = el.mm(J_task, A_inv)
            JAN = JtA - el.mm(el.mmT(JtA, J_C), Jbar)
            Mt = el.mmT_sym(JAN, J_task)

            def _reg(Ms):
                """κ-bounding relative ridge at f32 — the closed-form
                analog of the reference's COD threshold on these task
                operators (src/wbd.cpp:207-213); scale rationale +
                measurements in wbc/dynamics._psd_inv_reg.  f64 exact."""
                if dtype != jnp.float32:
                    return Ms
                k_ = Ms.shape[0]
                dmax = Ms[0, 0] * 0.0
                for i2 in range(k_):
                    dmax = jnp.maximum(dmax, jnp.abs(Ms[i2, i2]))
                return el.diag_add(Ms, [1e-4 * dmax] * k_)

            Lam = el.psd_inverse(_reg(Mt))
            Q = el.mm(Lam, JAN)[:, 6:]                    # (t, mdof)+bt
            WQt = W_apply(el.transpose(Q))                # (mdof, t)+bt
            QWQ = el.mm_sym(Q, WQt)
            inv_mid = el.psd_inverse(_reg(QWQ))
            J_kt = el.mm(WQt, inv_mid)
            JktLam = el.mm(J_kt, Lam)
            Ntorques.append(JktLam if prev_null is None
                            else el.mm(prev_null, JktLam))
            if lv < len(self.task_slots) - 1:
                term = el.mm(J_kt, Q)                     # (mdof, mdof)+bt
                nn = el.eye(self.mdof, zero) - term
                prev_null = nn if prev_null is None else el.mm(prev_null, nn)

        # ---------------- constraint prep: CM blocks, Atemp, bA0
        CM_blocks = []
        for c, blk in zip(self.cfg.contacts, self.const_blocks):
            RT = el.transpose(R[c.link])
            if self.masked:
                # padded (10,6) block; LINE moment rows already contact-
                # local (see jacobian assembly) → identity on the rotation
                # half (masked.py:299-306)
                if c.contact_type == T.CONTACT_LINE:
                    CMi = jnp.concatenate(
                        [el.mm_sd(blk[:, 0:3], RT),
                         el.smat(blk[:, 3:6], zero)], axis=1,
                    )
                else:
                    CMi = jnp.concatenate(
                        [el.mm_sd(blk[:, 0:3], RT),
                         el.mm_sd(blk[:, 3:6], RT)], axis=1,
                    )
            elif c.contact_type == T.CONTACT_6D:
                # A_rot = RT ⊕ RT; CM_i = blk @ A_rot: split columns
                CMi = jnp.concatenate(
                    [el.mm_sd(blk[:, 0:3], RT), el.mm_sd(blk[:, 3:6], RT)],
                    axis=1,
                )
            elif c.contact_type == T.CONTACT_POINT:
                CMi = el.mm_sd(blk, RT)
            else:  # LINE: A_rot = RT ⊕ I₂ — moment columns pass through
                CMi = jnp.concatenate(
                    [el.mm_sd(blk[:, 0:3], RT), el.smat(blk[:, 3:5], zero)],
                    axis=1,
                )
            CM_blocks.append(CMi)
        Atemp_rows, bA0_rows = [], []
        r = 0
        for c, CMi in zip(self.cfg.contacts, CM_blocks):
            dd = 6 if self.masked else c.contact_dof
            Atemp_rows.append(el.mm(CMi, Jbar[r:r + dd, 6:]))
            bA0_rows.append(el.mv(CMi, P_C[r:r + dd]))
            r += dd
        Atemp = jnp.concatenate(Atemp_rows, axis=0)       # (k_rows, mdof)+bt
        bA0 = jnp.concatenate(bA0_rows, axis=0)           # (k_rows,)+bt

        if self.masked:
            crow = []
            for i, c in enumerate(self.cfg.contacts):
                cw = self.type_crow_masks[i]
                for rr in range(10):
                    crow.append(
                        cmask[i] * float(cw[rr]) if cw[rr] != 0.0 else zero
                    )
            out["crow_mask"] = jnp.stack(crow, axis=0)    # (k_rows,)+bt

        out.update(
            torque_grav=torque_grav,
            P_C=P_C,
            Jbar_act=Jbar[:, 6:],
            NwJw=NwJw,
            Ntorques=Ntorques,
            Atemp=Atemp,
            bA0=bA0,
            health=health,
        )
        if self.masked:
            # per-lane active contact dof (Σ row_mask) — the reference's
            # `if (contact_dof > 0)` redistribution guard (contact_dof =
            # total_contact_dof - 6, i.e. total > 6)
            # (src/dwbc.cpp:1424) becomes a per-lane diagnostic gate
            out["active_cdof"] = jnp.sum(row_mask, axis=0)
        return out

    # ------------------------------------------------------------ the IPM
    def _ipm(self, Hdiag, C, d, iters, warm, mirror):
        """One-sided QP min ½xᵀdiag(Hdiag)x s.t. Cx ≤ d (g = 0 — every tick
        QP has a zero linear term).  C is the STORED rows [B; D] with the
        mirrored −B block folded (the torque-limit pairs).  Returns
        (x, s, lam, gap, pres)."""
        dtype = C.dtype
        f32 = dtype == jnp.float32
        n = C.shape[1]
        me = C.shape[0]
        mr = mirror
        m = me + mr
        ridge = 1e-6 if f32 else 1e-9
        s_floor = 1e-10 if f32 else 1e-14
        w_cap = 1e8 if f32 else 1e12
        mu_tol = 5e-8 if f32 else 1e-13

        def matvec_C(x):
            acc = jnp.sum(C * x[None], axis=1)            # (me,)+bt
            if mr == 0:
                return acc
            return jnp.concatenate([acc[:mr], -acc[:mr], acc[mr:]], axis=0)

        def _fold(v, sign):
            if mr == 0:
                return v
            head = v[:mr] + sign * v[mr:2 * mr]
            return jnp.concatenate([head, v[2 * mr:]], axis=0)

        def matvec_CT(v):
            veff = _fold(v, -1.0)
            return jnp.sum(C * veff[:, None], axis=0)

        def matvec_H(x):
            return jnp.stack(
                [(Hdiag[i] + ridge) * x[i] for i in range(n)], axis=0
            )

        def gram(w):
            Cw = C * _fold(w, 1.0)[:, None]
            K = {}
            for i in range(n):
                for j in range(i + 1):
                    K[(i, j)] = jnp.sum(Cw[:, i] * C[:, j], axis=0)
                K[(i, i)] = K[(i, i)] + (Hdiag[i] + ridge)
            return K

        def chol_d(K):
            S = dict(K)
            cols, inv_diag = [], []
            for j in range(n):
                dj = jnp.sqrt(jnp.maximum(S[(j, j)], 1e-30))
                inv_d = 1.0 / dj
                col = [None] * n
                col[j] = dj
                for i in range(j + 1, n):
                    col[i] = S[(i, j)] * inv_d
                cols.append(col)
                inv_diag.append(inv_d)
                for i in range(j + 1, n):
                    for k in range(j + 1, i + 1):
                        S[(i, k)] = S[(i, k)] - col[i] * col[k]
            return cols, inv_diag

        def cho_solve_vec(Lc, inv_diag, b):
            y = [None] * n
            for i in range(n):
                acc = b[i]
                for k in range(i):
                    acc = acc - Lc[k][i] * y[k]
                y[i] = acc * inv_diag[i]
            x = [None] * n
            for i in reversed(range(n)):
                acc = y[i]
                for k in range(i + 1, n):
                    acc = acc - Lc[i][k] * x[k]
                x[i] = acc * inv_diag[i]
            return jnp.stack(x, axis=0)

        def factor(x, s_, lam):
            s_safe = jnp.maximum(s_, s_floor)
            inv_s = 1.0 / s_safe
            r_d = matvec_H(x) + matvec_CT(lam)
            r_p = matvec_C(x) + s_ - d
            w = jnp.clip(lam * inv_s, 0.0, w_cap)
            Lc, inv_diag = chol_d(gram(w))
            return inv_s, r_d, r_p, w, Lc, inv_diag

        def newton(fac, s_, lam, sigma_mu):
            inv_s, r_d, r_p, w, Lc, inv_diag = fac
            r_c = s_ * lam - sigma_mu
            rhs = -r_d - matvec_CT(w * r_p - r_c * inv_s)
            dx = cho_solve_vec(Lc, inv_diag, rhs)
            ds = -(r_p + matvec_C(dx))
            dlam = -(r_c + lam * ds) * inv_s
            return dx, ds, dlam

        def alpha_max(v, dv):
            ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), 1e20)
            return jnp.minimum(1.0, 0.995 * jnp.min(ratio, axis=0))

        if warm is not None:
            x0, lam0_in = warm
            s0 = jnp.maximum(d - matvec_C(x0), 1e-4)
            # clip ABOVE too: a prior tick that hit an ε-infeasible row
            # (e.g. a fully-masked lane whose τ sits on the torque limit
            # to f32 roundoff: 0·x ≤ −ε) legitimately diverges its dual —
            # it must not poison this restart
            lam0 = jnp.clip(lam0_in, 1e-4, w_cap)
        else:
            x0 = jnp.zeros((n,) + d.shape[1:], dtype)
            s0 = jnp.maximum(d, 1.0)
            lam0 = jnp.ones_like(d)

        def body(_, carry):
            x, s_, lam = carry
            mu = jnp.sum(s_ * lam, axis=0) / m
            live = (mu > mu_tol).astype(dtype)
            fac = factor(x, s_, lam)
            dx_a, ds_a, dlam_a = newton(fac, s_, lam, jnp.zeros_like(s_))
            a_p = alpha_max(s_, ds_a)
            a_d = alpha_max(lam, dlam_a)
            mu_aff = jnp.sum(
                (s_ + a_p[None] * ds_a) * (lam + a_d[None] * dlam_a), axis=0
            ) / m
            sigma = (mu_aff / jnp.maximum(mu, 1e-30)) ** 3
            target = sigma[None] * mu[None] - ds_a * dlam_a
            dx, ds, dlam = newton(fac, s_, lam, target)
            if warm is not None:
                a_pc = live * alpha_max(s_, ds)
                a_dc = live * alpha_max(lam, dlam)
            else:
                a_pc = live * jnp.minimum(alpha_max(s_, ds), alpha_max(lam, dlam))
                a_dc = a_pc
            ok = jnp.sum(dx * 0.0, axis=0) == 0.0
            # dual safeguard: on an infeasible row (0·x ≤ −ε from masked
            # lanes + roundoff at an active limit) λ grows without bound;
            # cap at w_cap so gap/warm-carry stay finite — primal_res
            # still reports the ε-violation
            return (
                jnp.where(ok, x + a_pc[None] * dx, x),
                jnp.where(ok, s_ + a_pc[None] * ds, s_),
                jnp.where(ok, jnp.minimum(lam + a_dc[None] * dlam, w_cap), lam),
            )

        x, s_, lam = jax.lax.fori_loop(0, iters, body, (x0, s0, lam0))
        slack = d - matvec_C(x)
        pres = jnp.max(jnp.maximum(-slack, 0.0), axis=0)
        # normalized complementarity (ops/qp.py::_comp_gap rationale): the
        # per-row λ/(1+λ) saturation makes a divergent-dual row (ε-
        # infeasible masked/limit rows) contribute ≈|slack| = ε instead of
        # ε·w_cap, so a healthy limit-riding lane reads ~0 and cannot trip
        # the loop-level gap_fallback, while genuine non-convergence /
        # infeasibility still reads large.
        gap = jnp.sum(
            jnp.abs(slack) * (lam / (1.0 + lam)), axis=0
        ) / m
        return x, s_, lam, gap, pres

    # ----------------------------------------------------------- QP chain
    def qpchain(self, pre, fstars, warm=None, iters=25):
        """The interleaved per-level QPs + torque accumulation
        (CalcTaskControlTorque + CalcContactRedistribute,
        src/dwbc.cpp:818-873/1372-1620).  warm: list of (x, lam) per QP in
        elem-leading layout, or None (cold)."""
        dtype = pre["torque_grav"].dtype
        tg = pre["torque_grav"]
        NwJw = pre["NwJw"]
        Atemp = pre["Atemp"]
        bA0 = pre["bA0"]
        mdof = self.mdof
        use_lim = self.tlim is not None
        mirror = mdof if use_lim else 0
        tlim = el.svec(self.tlim, tg[0] * 0.0) if use_lim else None

        tau_task = jnp.zeros_like(tg)
        tau_contact = jnp.zeros_like(tg)
        gap = jnp.zeros_like(tg[0])
        pres = jnp.zeros_like(tg[0])
        warm_out = []
        crow = pre.get("crow_mask")  # masked mode: per-scenario cone rows

        def mask_cone(D, ub_c):
            """Inactive contacts' cone/ZMP rows → 0·x ≤ 1 (the elem-leading
            form of solve_qp's +inf row masking — keeps IPM scaling sane)."""
            if crow is None:
                return D, ub_c
            return D * crow[:, None], jnp.where(crow > 0.5, ub_c, 1.0)

        nlev = len(self.task_slots)
        for h in range(nlev):
            Nt = pre["Ntorques"][h]                       # (mdof, t)+bt
            t = Nt.shape[1]
            if NwJw is not None:
                blk = jnp.concatenate([Nt, NwJw], axis=1)  # (mdof, nv)+bt
            else:
                blk = Nt
            nv = blk.shape[1]
            D = -el.mm(Atemp, blk)                         # (k, nv)+bt
            tau_base = tg + tau_task + el.mv(Nt, fstars[h])
            ub_c = el.mv(Atemp, tau_base) - bA0
            D, ub_c = mask_cone(D, ub_c)
            if use_lim:
                Cs = jnp.concatenate([blk, D], axis=0)
                d = jnp.concatenate(
                    [tlim - tau_base, tlim + tau_base, ub_c], axis=0
                )
            else:
                Cs = D
                d = ub_c
            Hdiag = tuple([1.0] * t + [0.0] * (nv - t))
            x, s_, lam, g_, p_ = self._ipm(
                Hdiag, Cs, d, iters,
                None if warm is None else warm[h], mirror,
            )
            warm_out.append((x, lam))
            tau_task = tau_task + el.mv(Nt, fstars[h] + x[:t])
            if NwJw is not None:
                tau_contact = el.mv(NwJw, x[t:])
            gap = jnp.maximum(gap, g_)
            pres = jnp.maximum(pres, p_)

        if NwJw is not None:
            tau_input = tg + tau_task + tau_contact
            D = -el.mm(Atemp, NwJw)
            ub_c = el.mv(Atemp, tau_input) - bA0
            D, ub_c = mask_cone(D, ub_c)
            if use_lim:
                Cs = jnp.concatenate([NwJw, D], axis=0)
                d = jnp.concatenate(
                    [tlim - tau_input, tlim + tau_input, ub_c], axis=0
                )
            else:
                Cs = D
                d = ub_c
            Hdiag = tuple([1.0] * self.cfree)
            x, s_, lam, g_, p_ = self._ipm(
                Hdiag, Cs, d, iters,
                None if warm is None else warm[nlev], mirror,
            )
            warm_out.append((x, lam))
            tau_contact = tau_contact + el.mv(NwJw, x)
            if crow is not None:
                # single-support lanes (active_cdof ≤ 6) have NO
                # redistribution problem — the reference skips the QP
                # entirely: `if (contact_dof > 0)` with contact_dof =
                # total_contact_dof - 6, i.e. total > 6 (src/dwbc.cpp:1424);
                # here the padded QP still runs (its NwJw columns are
                # zero, τ_contact untouched) but an ε-infeasible dead
                # row (τ at the limit + f32 roundoff ⇒ 0·x ≤ −ε) must
                # not leak into the lane's diagnostics
                live_redis = (pre["active_cdof"] > 6.5).astype(g_.dtype)
                g_ = g_ * live_redis
                p_ = p_ * live_redis
            gap = jnp.maximum(gap, g_)
            pres = jnp.maximum(pres, p_)

        tau_cmd = tg + tau_task + tau_contact
        cforce = el.mv(pre["Jbar_act"], tau_cmd) - pre["P_C"]
        return dict(
            torque_grav=tg,
            torque_task=tau_task,
            torque_contact=tau_contact,
            torque_cmd=tau_cmd,
            contact_force=cforce,
            qp_gap=gap,
            qp_primal_res=pres,
            health=pre["health"],
            warm_out=tuple(warm_out),
        )

    def _apply_servos_el(self, pre, fstars, servos):
        """Replace f* rows whose task link carries servo params with the
        on-device trajectory-PD output (pipeline._apply_servos mirror).
        servos: per level, None or per-spec tuple of dict-or-None."""
        out_fs = []
        for h, slots in enumerate(self.task_slots):
            f = fstars[h]
            lvl = servos[h] if h < len(servos) else None
            if lvl is None:
                out_fs.append(f)
                continue
            rows = []
            off = 0
            for j, (kind, payload, mode) in enumerate(slots):
                nr = 6 if mode in _SIX else 3
                fj = f[off:off + nr]
                off += nr
                sp = lvl[j]
                if sp is None:
                    rows.append(fj)
                    continue
                pos, vel, rot, wv = pre["task_states"][(h, j)]
                f6 = _servo_fstar_el(sp, pos, vel, rot, wv)
                up = sp["use_pos"][None]
                ur = sp["use_rot"][None]
                if mode in _SIX:
                    rows.append(jnp.concatenate([
                        up * f6[0:3] + (1.0 - up) * fj[0:3],
                        ur * f6[3:6] + (1.0 - ur) * fj[3:6],
                    ], axis=0))
                elif mode in _POS:
                    rows.append(up * f6[0:3] + (1.0 - up) * fj)
                else:
                    rows.append(ur * f6[3:6] + (1.0 - ur) * fj)
            out_fs.append(jnp.concatenate(rows, axis=0))
        return tuple(out_fs)

    def tick(self, q, fstars, warm=None, iters=25, cmask=None, qdot=None,
             servos=None):
        """Full fused tick, element-leading: q (nq,)+bt → result dict.
        cmask (nc,)+bt required in masked mode; servos (nested dicts of
        elem-leading ServoParams fields) need qdot."""
        assert (cmask is not None) == self.masked
        servo_req = None
        if servos is not None:
            servo_req = tuple(
                tuple(False for _ in self.task_slots[h]) if lv is None
                else tuple(sp is not None for sp in lv)
                for h, lv in enumerate(servos)
            )
        pre = self.prestage(q, cmask=cmask, qdot=qdot, servo_req=servo_req)
        if servos is not None:
            fstars = self._apply_servos_el(pre, fstars, servos)
        return self.qpchain(pre, fstars, warm=warm, iters=iters)
