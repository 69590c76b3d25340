"""Batched kinematics/dynamics engine: the compiled UpdateKinematics.

Replaces the reference's per-tick RBDL calls (``RobotData::UpdateKinematics``,
/root/reference/src/dwbc.cpp:279-371) with a single pure function of
``(q, qdot)``:

* forward kinematics — unrolled fixed-topology chain (static python loop at
  trace time; XLA sees straight-line code, no dynamic control flow);
* every body Jacobian at once via **static ancestor-mask einsums** instead of
  per-body tree walks (RBDL CalcPointJacobian6D, src/link.cpp:98-107);
* the joint-space inertia matrix via the kinetic-energy metric
  ``A = Σ_b m_b Jv_b^T Jv_b + Jw_b^T I_b Jw_b`` — mathematically identical to
  the Composite-Rigid-Body Algorithm (src/dwbc.cpp:305) but expressed as three
  dense matmuls that map straight onto the MXU and batch trivially;
* bias forces (RBDL NonlinearEffects, src/dwbc.cpp:344) from the classical
  acceleration recursion with q̈=0;
* COM / centroidal-momentum-matrix / gravity vector with the same formulas
  as the reference (src/dwbc.cpp:320-358).

Conventions (RBDL parity):
* Floating-base q layout: ``[x y z, qx qy qz, θ_1..θ_m, qw]`` (quaternion w
  stored last, q size = ndof+1) — tests/dwbc_test.cpp:37-54.
* qdot layout: ``[v_world(3), ω_body(3), θ̇]`` — base linear velocity in the
  world frame, base angular velocity in the *base body* frame.
* All Jacobians are **position-rows-first** ``[Jv; Jw]`` (the reference swaps
  RBDL's rotation-first rows, src/link.cpp:102).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..model.compile import RobotModel
from ..ops import smallmat as sm
from .rotations import axis_angle_matrix, quat_to_matrix, skew


class FK(NamedTuple):
    """Forward-kinematics result (world frame). Leading batch dims allowed."""

    R: jnp.ndarray          # (nbody,3,3) body→world rotation
    p: jnp.ndarray          # (nbody,3)   body origin
    axis_w: jnp.ndarray     # (nbody,3)   world joint axis (zeros for base)
    com_w: jnp.ndarray      # (nbody,3)   body COM in world


class KinState(NamedTuple):
    """Everything UpdateKinematics produces, as one immutable pytree."""

    q: jnp.ndarray
    qdot: jnp.ndarray
    R: jnp.ndarray          # (nbody,3,3)
    p: jnp.ndarray          # (nbody,3)
    w: jnp.ndarray          # (nbody,3) body angular velocity, world frame
    v: jnp.ndarray          # (nbody,3) body-origin linear velocity, world frame
    com_w: jnp.ndarray      # (nbody,3) per-body COM, world
    J: jnp.ndarray          # (nbody,6,ndof) [Jv;Jw] at body origin — or, when
                            # ``update(J_bodies=...)`` narrowed it, only those
                            # bodies' rows (len(J_bodies),6,ndof)
    Jcom: jnp.ndarray       # (nbody,6,ndof) [Jv;Jw] at body COM
    A: jnp.ndarray          # (ndof,ndof) mass matrix
    A_inv: jnp.ndarray      # (ndof,ndof)
    B: jnp.ndarray          # (ndof,) nonlinear effects C(q,qd)qd + G (incl. gravity)
    G: jnp.ndarray          # (ndof,) gravity vector (reference's G_, COM-jacobian form)
    com_pos: jnp.ndarray    # (3,) whole-body COM, world
    com_vel: jnp.ndarray    # (3,)
    com_inertia: jnp.ndarray  # (3,3) locked inertia about COM, world frame
    CMM: jnp.ndarray        # (6,ndof) centroidal momentum matrix [linear; angular]
    Jcom_total: jnp.ndarray  # (6,ndof) COM 'link' jacobian = SI⁻¹·CMM (pos-first)
    J_pts: jnp.ndarray = None  # (P,6,ndof) jacobians of the static body-fixed
                               # ``points`` requested via ``update(points=...)``
                               # (fused into the same masked-einsum pass as
                               # J/Jcom); None when no points were requested


class Kinematics:
    """Kinematics/dynamics kernels for one compiled model.

    Methods are pure and shape-static: wrap in jit / vmap / shard_map freely.
    """

    def __init__(self, model: RobotModel):
        self.model = model
        m = model
        self.nbody = m.nbody
        self.ndof = m.ndof
        self.base_dof = 6 if m.floating else 0
        # Static constants (converted to jnp lazily per-dtype).
        # Symmetric PSD square root of each body inertia (f64, once at
        # construction): Iw = R·I·Rᵀ = (R·S)(R·S)ᵀ with S = I^{1/2}, which
        # lets the mass matrix collapse to ONE Gram GEMM (see mass_matrix).
        # eigh-based sqrt so massless pseudo-bodies (singular I) stay exact.
        ev, U = np.linalg.eigh(np.asarray(m.inertia, np.float64))
        inertia_sqrt = np.einsum(
            "bij,bj,bkj->bik", U, np.sqrt(np.maximum(ev, 0.0)), U
        )
        self._np_consts = dict(
            X_T_rot=m.X_T_rot, X_T_trans=m.X_T_trans, axis=m.axis,
            mass=m.mass, com=m.com, inertia=m.inertia,
            sqrt_mass=np.sqrt(np.maximum(np.asarray(m.mass, np.float64), 0.0)),
            inertia_sqrt=inertia_sqrt,
            amask=m.ancestor_mask, gravity=m.gravity,
        )
        self.parent = [int(x) for x in m.parent]
        self.q_index = [int(x) for x in m.q_index]
        self.total_mass = m.total_mass

    def _c(self, name, dtype):
        return jnp.asarray(self._np_consts[name], dtype=dtype)

    # ------------------------------------------------------------------ FK
    def fk(self, q) -> FK:
        dtype = q.dtype
        m = self.model
        X_rot = self._c("X_T_rot", dtype)
        X_trans = self._c("X_T_trans", dtype)
        axis = self._c("axis", dtype)
        com = self._c("com", dtype)

        if m.floating:
            quat = jnp.stack([q[..., 3], q[..., 4], q[..., 5], q[..., self.ndof]], axis=-1)
            R0 = quat_to_matrix(quat)
            p0 = q[..., 0:3]
        else:
            R0 = jnp.broadcast_to(jnp.eye(3, dtype=dtype), q.shape[:-1] + (3, 3))
            p0 = jnp.zeros(q.shape[:-1] + (3,), dtype=dtype)

        Rs = [R0]
        ps = [p0]
        axs = [jnp.zeros_like(p0)]
        for i in range(1, self.nbody):
            par = self.parent[i]
            qi = q[..., self.q_index[i]]
            Rj = axis_angle_matrix(axis[i], qi)
            Ri = Rs[par] @ (X_rot[i] @ Rj)
            pi = ps[par] + jnp.einsum("...ij,j->...i", Rs[par], X_trans[i])
            Rs.append(Ri)
            ps.append(pi)
            axs.append(jnp.einsum("...ij,j->...i", Ri, axis[i]))

        R = jnp.stack(Rs, axis=-3)
        p = jnp.stack(ps, axis=-2)
        axis_w = jnp.stack(axs, axis=-2)
        com_w = p + jnp.einsum("...bij,bj->...bi", R, com)
        return FK(R, p, axis_w, com_w)

    # ---------------------------------------------------------- velocities
    def velocities(self, fk: FK, qdot):
        """Per-body angular/origin-linear velocity (world)."""
        ws = []
        vs = []
        if self.model.floating:
            w0 = jnp.einsum("...ij,...j->...i", fk.R[..., 0, :, :], qdot[..., 3:6])
            v0 = qdot[..., 0:3]
        else:
            w0 = jnp.zeros(qdot.shape[:-1] + (3,), dtype=qdot.dtype)
            v0 = jnp.zeros_like(w0)
        ws.append(w0)
        vs.append(v0)
        for i in range(1, self.nbody):
            par = self.parent[i]
            qd = qdot[..., self.q_index[i]]
            wi = ws[par] + fk.axis_w[..., i, :] * qd[..., None]
            r = fk.p[..., i, :] - fk.p[..., par, :]
            vi = vs[par] + jnp.cross(ws[par], r, axis=-1)
            ws.append(wi)
            vs.append(vi)
        return jnp.stack(ws, axis=-2), jnp.stack(vs, axis=-2)

    # ----------------------------------------------------------- jacobians
    def _dof_frames(self, fk: FK):
        """Per-dof world axis + origin. Owner body of dof j carries its axis."""
        dtype = fk.p.dtype
        owner = np.zeros(self.ndof, dtype=np.int32)
        for i in range(1, self.nbody):
            owner[self.q_index[i]] = i
        # joint dofs
        dof_axis = fk.axis_w[..., owner, :]        # (...,ndof,3)
        dof_origin = fk.p[..., owner, :]
        if self.model.floating:
            # base translation dofs 0..2: pure linear, handled by is_trans mask
            eye = jnp.eye(3, dtype=dtype)
            R0 = fk.R[..., 0, :, :]
            base_axis = jnp.concatenate(
                [jnp.broadcast_to(eye, R0.shape[:-2] + (3, 3)),
                 jnp.swapaxes(R0, -1, -2)], axis=-2)  # rows: e_k then R0 columns
            dof_axis = jnp.concatenate([base_axis, dof_axis[..., 6:, :]], axis=-2)
            base_origin = jnp.broadcast_to(
                fk.p[..., 0:1, :], fk.p.shape[:-2] + (6, 3))
            dof_origin = jnp.concatenate([base_origin, dof_origin[..., 6:, :]], axis=-2)
            is_trans = np.zeros(self.ndof); is_trans[0:3] = 1.0
        else:
            is_trans = np.zeros(self.ndof)
        return dof_axis, dof_origin, jnp.asarray(is_trans, dtype=dtype)

    def point_jacobians(self, fk: FK, points, body_mask):
        """Jacobians [Jv;Jw] for world `points` (...,P,3) attached to bodies
        selected by `body_mask` (P,ndof) ancestor masks. Returns (...,P,6,ndof).

        A single masked cross-product pass replaces P tree walks.  Layout is
        component-major (...,P,3,ndof) throughout: the dof axis — the only
        wide one — stays minor (a (…,ndof,3) layout puts the 3 minor), and
        the output rows [Jv;Jw] concatenate
        directly with no transposes of the big temporaries.
        """
        dof_axis, dof_origin, is_trans = self._dof_frames(fk)
        ax = jnp.swapaxes(dof_axis, -1, -2)[..., None, :, :]      # (...,1,3,ndof)
        og = jnp.swapaxes(dof_origin, -1, -2)                     # (...,3,ndof)
        rel = points[..., :, :, None] - og[..., None, :, :]       # (...,P,3,ndof)
        jv_rot = jnp.cross(jnp.broadcast_to(ax, rel.shape), rel, axis=-2)
        jv = jnp.where(is_trans > 0, ax, jv_rot)
        jw = jnp.where(is_trans > 0, 0.0, ax)
        mask = body_mask[..., :, None, :]                         # (P,1,ndof)
        jv = jv * mask
        jw = jnp.broadcast_to(jw * mask, jv.shape)
        # → (...,P,6,ndof)
        return jnp.concatenate([jv, jw], axis=-2)

    def body_jacobians(self, fk: FK):
        """(J, Jcom): (...,nbody,6,ndof) at body origins and COMs."""
        amask = self._c("amask", fk.p.dtype)
        J = self.point_jacobians(fk, fk.p, amask)
        Jcom = self.point_jacobians(fk, fk.com_w, amask)
        return J, Jcom

    # ---------------------------------------------------------------- CRBA
    def mass_matrix(self, fk: FK, Jcom):
        """A = Σ_b m_b Jv^T Jv + Jw^T (R I R^T) Jw  — dense MXU-friendly form,
        algebraically equal to CRBA (src/dwbc.cpp:305).

        Computed as ONE Gram GEMM A = KᵀK with K = [√m_b·Jv_b ; (R_b·I_b^½)ᵀJw_b]
        stacked over bodies: the contraction depth becomes 6·nbody (≈210 for
        Tocabi) — deep enough to tile the MXU — instead of two shallow
        per-body einsums, and the result is exactly symmetric."""
        dtype = fk.p.dtype
        sqrt_m = self._c("sqrt_mass", dtype)
        S = self._c("inertia_sqrt", dtype)
        Jv = Jcom[..., :, 0:3, :]
        Jw = Jcom[..., :, 3:6, :]
        RS = jnp.einsum("...bij,bjk->...bik", fk.R, S)          # (...,b,3,3)
        Kv = sqrt_m[:, None, None] * Jv                          # (...,b,3,n)
        Kw = jnp.einsum("...bji,...bjn->...bin", RS, Jw)         # (RS)ᵀ Jw
        K = jnp.concatenate([Kv, Kw], axis=-2)                   # (...,b,6,n)
        Kf = K.reshape(K.shape[:-3] + (self.nbody * 6, self.ndof))
        return jnp.einsum("...kn,...km->...nm", Kf, Kf)

    # ------------------------------------------------------ bias (nonlin.)
    def bias_forces(self, fk: FK, w, v, Jcom):
        """C(q,qd)qd + G, classical Newton-Euler with q̈=0 mapped through the
        COM jacobians (RBDL NonlinearEffects parity, src/dwbc.cpp:343-344)."""
        dtype = fk.p.dtype
        mass = self._c("mass", dtype)
        inertia = self._c("inertia", dtype)
        grav = self._c("gravity", dtype)

        # Angular / origin accelerations with q̈ = 0 (unrolled recursion).
        dws = [jnp.zeros_like(w[..., 0, :])]
        dvs = [jnp.zeros_like(w[..., 0, :])]
        for i in range(1, self.nbody):
            par = self.parent[i]
            # axis changes only by parent rotation: ȧ = ω_par × a
            qd_i = None  # qd enters via w differences; use ω_par × a * q̇
            # ẇ_i = ẇ_par + ω_par × (ω_i - ω_par)   since (ω_i-ω_par) = a q̇
            dwi = dws[par] + jnp.cross(w[..., par, :], w[..., i, :] - w[..., par, :], axis=-1)
            r = fk.p[..., i, :] - fk.p[..., par, :]
            dvi = (dvs[par]
                   + jnp.cross(dws[par], r, axis=-1)
                   + jnp.cross(w[..., par, :], v[..., i, :] - v[..., par, :], axis=-1))
            dws.append(dwi)
            dvs.append(dvi)
        dw = jnp.stack(dws, axis=-2)
        dv = jnp.stack(dvs, axis=-2)

        # COM classical acceleration.
        rc = fk.com_w - fk.p
        a_com = (dv + jnp.cross(dw, rc, axis=-1)
                 + jnp.cross(w, jnp.cross(w, rc, axis=-1), axis=-1))

        Iw = jnp.einsum("...bij,bjk,...blk->...bil", fk.R, inertia, fk.R)
        f = mass[:, None] * (a_com - grav)           # (...,nbody,3)
        Iww = jnp.einsum("...bij,...bj->...bi", Iw, w)
        n = (jnp.einsum("...bij,...bj->...bi", Iw, dw)
             + jnp.cross(w, Iww, axis=-1))
        Jv = Jcom[..., :, 0:3, :]
        Jw = Jcom[..., :, 3:6, :]
        B = (jnp.einsum("...bin,...bi->...n", Jv, f)
             + jnp.einsum("...bin,...bi->...n", Jw, n))
        return B

    # ------------------------------------------------------------- update
    def update(self, q, qdot, J_bodies=None, points=None) -> KinState:
        """Full kinematics/dynamics update — one jittable graph.

        J_bodies: optional static tuple of body indices — compute body-origin
            jacobians (``KinState.J``) only for those bodies instead of all
            nbody (the COM jacobians, which the mass matrix and bias forces
            need for every body, are always complete).  The fused tick uses
            this: it reads st.J at its task links only, so forming the other
            ~30 bodies' origin jacobians is pure HBM traffic.
        points: optional static tuple of ``(body, (x,y,z))`` body-fixed
            points — their world point jacobians come back in
            ``KinState.J_pts``, computed in the SAME masked-einsum pass as
            J/Jcom (one set of component-major (…,P,3,ndof) temporaries
            instead of one per ``frame_point_jacobian`` call).
        """
        dtype = q.dtype
        fk = self.fk(q)
        w, v = self.velocities(fk, qdot)

        # One fused point-jacobian pass for COM points + requested origin
        # points + requested body-fixed points.
        amask_np = self._np_consts["amask"]
        pts = [fk.com_w]
        masks = [amask_np]
        if J_bodies is None:
            pts.append(fk.p)
            masks.append(amask_np)
            nj = self.nbody
        else:
            idx = np.asarray(J_bodies, np.int32)
            pts.append(fk.p[..., idx, :])
            masks.append(amask_np[idx])
            nj = len(J_bodies)
        if points:
            for b, lp in points:
                p_w = fk.p[..., b, :] + jnp.einsum(
                    "...ij,j->...i", fk.R[..., b, :, :],
                    jnp.asarray(np.asarray(lp, np.float64), dtype))
                pts.append(p_w[..., None, :])
                masks.append(amask_np[int(b)][None, :])
        batch = jnp.broadcast_shapes(*(p.shape[:-2] for p in pts))
        pts = [jnp.broadcast_to(p, batch + p.shape[-2:]) for p in pts]
        Jall = self.point_jacobians(
            fk, jnp.concatenate(pts, axis=-2),
            jnp.asarray(np.concatenate(masks, axis=0), dtype))
        Jcom = Jall[..., : self.nbody, :, :]
        J = Jall[..., self.nbody : self.nbody + nj, :, :]
        J_pts = Jall[..., self.nbody + nj :, :, :] if points else None

        A = self.mass_matrix(fk, Jcom)

        # Unrolled Cholesky inverse at these sizes (≤48 dof) rather than
        # XLA's LAPACK-shaped batched cholesky / cho_solve.
        if self.ndof <= 48:
            A_inv = sm.psd_inverse(A)
        else:
            eye = jnp.broadcast_to(jnp.eye(self.ndof, dtype=dtype), A.shape)
            L = jnp.linalg.cholesky(A)
            A_inv = jax.scipy.linalg.cho_solve((L, True), eye)

        B = self.bias_forces(fk, w, v, Jcom)

        M = jnp.asarray(self.total_mass, dtype=dtype)
        R0 = fk.R[..., 0, :, :]
        if self.model.floating:
            # COM from mass-matrix coupling block (src/dwbc.cpp:320-324)
            skm = R0 @ A[..., 3:6, 0:3] / M
            com_from_base = jnp.stack(
                [skm[..., 2, 1], skm[..., 0, 2], skm[..., 1, 0]], axis=-1)
            com_pos = com_from_base + q[..., 0:3]
            # CMM (src/dwbc.cpp:331-341)
            cm_rot6 = jnp.zeros(q.shape[:-1] + (6, 6), dtype=dtype)
            cm_rot6 = cm_rot6.at[..., 0:3, 0:3].set(jnp.eye(3, dtype=dtype))
            cm_rot6 = cm_rot6.at[..., 3:6, 3:6].set(R0)
            cm_rot6 = cm_rot6.at[..., 3:6, 0:3].set(
                jnp.swapaxes(skew(com_from_base), -1, -2))
            CMM = cm_rot6 @ A[..., 0:6, :]
            com_inertia = (R0 @ A[..., 3:6, 3:6] @ jnp.swapaxes(R0, -1, -2)
                           - M * skew(com_from_base) @ jnp.swapaxes(skew(com_from_base), -1, -2))
            SI = jnp.zeros(q.shape[:-1] + (6, 6), dtype=dtype)
            SI = SI.at[..., 0:3, 0:3].set(jnp.eye(3, dtype=dtype) * M)
            SI = SI.at[..., 3:6, 3:6].set(com_inertia)
            Jcom_total = sm.psd_solve(SI, CMM)  # SI is SPD block-diag
            grav = self._c("gravity", dtype)
            G = -jnp.einsum("...in,...i->...n", Jcom_total[..., 0:3, :], M * grav)
            com_vel6 = jnp.einsum("...in,...n->...i", Jcom_total, qdot)
            com_vel = com_vel6[..., 0:3]
        else:
            mass = self._c("mass", dtype)
            com_pos = jnp.einsum("b,...bi->...i", mass, fk.com_w) / M
            CMM = jnp.zeros(q.shape[:-1] + (6, self.ndof), dtype=dtype)
            com_inertia = jnp.zeros(q.shape[:-1] + (3, 3), dtype=dtype)
            Jcom_total = jnp.einsum(
                "b,...bin->...in", mass, Jcom) / M
            grav = self._c("gravity", dtype)
            G = -jnp.einsum("...in,...i->...n", Jcom_total[..., 0:3, :], M * grav)
            com_vel = jnp.einsum("...in,...n->...i", Jcom_total[..., 0:3, :], qdot)

        return KinState(
            q=q, qdot=qdot, R=fk.R, p=fk.p, w=w, v=v, com_w=fk.com_w,
            J=J, Jcom=Jcom, A=A, A_inv=A_inv, B=B, G=G,
            com_pos=com_pos, com_vel=com_vel, com_inertia=com_inertia,
            CMM=CMM, Jcom_total=Jcom_total, J_pts=J_pts,
        )

    # ------------------------------------------------- arbitrary points
    def frame_point_jacobian(self, fk: FK, body: int, local_point):
        """Jacobian [Jv;Jw] of a body-fixed point (reference GetPointJac,
        src/link.cpp:109-119). `body` static, `local_point` (…,3)."""
        p_w = fk.p[..., body, :] + jnp.einsum(
            "...ij,...j->...i", fk.R[..., body, :, :], local_point)
        amask = self._c("amask", fk.p.dtype)[body]
        J = self.point_jacobians(fk, p_w[..., None, :],
                                 amask[None, :])
        return J[..., 0, :, :]
