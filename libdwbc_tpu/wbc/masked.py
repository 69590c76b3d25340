"""Masked multi-contact-mode tick: ONE compiled graph covers every mode.

The reference switches contact modes by resizing every matrix at runtime
(``SetContact`` booleans → new J_C shape, include/dwbc.h:432-474;
``UpdateContactConstraint`` src/dwbc.cpp:433-454).  The lax.switch sweep in
``parallel/hypotheses.py`` compiles one branch per mode; this module instead
compiles a SINGLE graph over max-contact-shape padded arrays with a
per-scenario boolean contact mask — the "masking over max-contact-shape
padded arrays" design from SURVEY.md §7.  Every scenario in a batch can be
in a *different* contact mode, which is what makes dense 4096-hypothesis
sweeps one XLA computation with no branch divergence.

Masking strategy (per factorization step):

* **Λ_c** — inactive contact rows of J_C are zero; the contact Gram matrix
  gets +1 on inactive diagonal entries (block-diagonal w.r.t. the active
  set, so the active block's inverse is exact), then inactive rows/cols of
  Λ_c are re-zeroed.
* **ker(W) basis V2** — the raw kernel directions J_C[:,6:]ᵀ·Ny have rank
  = (active contact dof − 6) < padded width; a modified Gram–Schmidt with
  zero-drop produces orthonormal-or-zero columns, which are then compacted
  to the left with an in-graph permutation (cumsum one-hot) so the zero
  columns sit at deterministic tail positions.
* **W⁺** — the identity W⁺ = (W + V2ᵀV2)⁻¹ − V2ᵀV2 holds for any
  orthonormal basis of ker(W); zero padding columns contribute nothing.
* **NwJw** — the reference normalizes redistribution directions against the
  first (c−6) rows of J̄_cᵀ (src/wbd.cpp:128); the masked equivalent
  selects the first (c_act−6) *active* rows with an in-graph selection
  matrix and pads the inner system's dead rows/cols with identity before
  inversion.
* **QP constraints** — cone/ZMP rows of inactive contacts get ub = +inf
  (the solver's row masking); padded redistribution variables have zero
  columns everywhere and an identity Hessian block, so they solve to 0.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..kin.engine import FK, Kinematics
from ..model.compile import RobotModel
from ..ops import smallmat as sm
from . import dynamics as dyn
from . import types as T
from .dynamics import ContactSpace, _psd_inv
from .hqp import solve_contact_redistribution_qp, solve_task_level_qp
from .pipeline import PipelineConfig, TickResult, qp_error_flag

_BIG = 1.0e30


def _orthonormalize_drop(V):
    """Modified Gram–Schmidt over the columns of V (..., n, k): returns
    orthonormal-or-zero columns (rank-deficient inputs yield zero columns
    instead of garbage, unlike QR 'complete' factors)."""
    k = V.shape[-1]
    cols = [V[..., :, j] for j in range(k)]
    out = []
    for j in range(k):
        v = cols[j]
        for u in out:
            v = v - jnp.sum(u * v, axis=-1, keepdims=True) * u
        nrm = jnp.linalg.norm(v, axis=-1, keepdims=True)
        keep = nrm > 1e-8
        out.append(jnp.where(keep, v / jnp.where(keep, nrm, 1.0), 0.0))
    return jnp.stack(out, axis=-1)


def _compact_columns(V):
    """Shift nonzero columns of V (..., n, k) to the left, preserving order
    (in-graph: permutation built from a cumsum one-hot)."""
    k = V.shape[-1]
    nz = (jnp.linalg.norm(V, axis=-2) > 1e-10)          # (..., k)
    pos = jnp.cumsum(nz.astype(jnp.int32), axis=-1) - 1  # target slot per col
    tgt = jnp.arange(k)
    # P[j, t] = 1 if column j moves to slot t
    P = (pos[..., :, None] == tgt) & nz[..., :, None]
    return V @ P.astype(V.dtype), jnp.sum(nz, axis=-1)


def _selection_first_k(row_mask, k_limit):
    """(..., c) boolean mask + per-scenario count limit → (k, c) selection
    matrix S with S[t, i] = 1 iff row i is the t-th active row and t < limit."""
    c = row_mask.shape[-1]
    idx = jnp.cumsum(row_mask.astype(jnp.int32), axis=-1) - 1   # (..., c)
    t = jnp.arange(c)
    S = (idx[..., None, :] == t[:, None]) & row_mask[..., None, :]
    S = S & (t[:, None] < k_limit[..., None, None])
    return S.astype(jnp.float32)


def masked_contact_space(J_C, A_inv, row_mask) -> ContactSpace:
    """Contact-space factorization with per-scenario active-row masking.

    J_C: (..., c_max, n) padded stacked contact jacobian with inactive rows
    zeroed; row_mask: (..., c_max) float/bool; at least one 6D contact
    (the first 6 rows of the base block must be full rank among active rows).
    Mirrors ``CalculateContactConstraint`` (src/wbd.cpp:108-143) under masks.
    """
    c = J_C.shape[-2]
    n = J_C.shape[-1]
    dtype = J_C.dtype
    rmask = row_mask.astype(dtype)
    J_C = J_C * rmask[..., :, None]

    JAinv = J_C @ A_inv
    Mc = JAinv @ jnp.swapaxes(J_C, -1, -2)
    Mc = 0.5 * (Mc + jnp.swapaxes(Mc, -1, -2))
    # +1 on inactive diagonal → active block inverts exactly
    Mc = Mc + jnp.einsum("...i,ij->...ij", 1.0 - rmask, jnp.eye(c, dtype=dtype))
    # rank-health indicator (see dynamics.contact_space): inactive rows
    # contribute unit pivots, so only the active block drives the minimum
    health = jnp.minimum(
        dyn._chol_health(Mc),
        dyn._chol_health(
            jnp.einsum("...ci,...cj->...ij", J_C[..., :, 0:6], J_C[..., :, 0:6])
        ),
    )
    Lambda_c = _psd_inv(Mc)
    Lambda_c = Lambda_c * rmask[..., :, None] * rmask[..., None, :]
    J_C_INV_T = Lambda_c @ JAinv
    N_C = jnp.eye(n, dtype=dtype) - jnp.swapaxes(J_C, -1, -2) @ J_C_INV_T
    A_inv_N_C = A_inv @ N_C
    W = A_inv_N_C[..., 6:, 6:]
    W = 0.5 * (W + jnp.swapaxes(W, -1, -2))

    # kernel basis of W, padded width c_max-6 (unrolled basis completion —
    # same left-null span as 'complete' QR, see ops/smallmat.py)
    Ny = sm.complete_basis(J_C[..., :, 0:6])[..., :, 6:]        # (..., c, c-6)
    V2T_raw = jnp.swapaxes(J_C[..., :, 6:], -1, -2) @ Ny        # (..., n-6, c-6)
    V2T = _orthonormalize_drop(V2T_raw)
    V2T, _ = _compact_columns(V2T)
    P_k = V2T @ jnp.swapaxes(V2T, -1, -2)
    W_inv = _psd_inv(W + P_k) - P_k
    V2 = jnp.swapaxes(V2T, -1, -2)

    # NwJw with the reference's normalization against the first
    # (c_act − 6) ACTIVE rows of J̄_cᵀ (src/wbd.cpp:128)
    cfree = c - 6
    if cfree > 0:
        c_act = jnp.sum(rmask, axis=-1)
        S = _selection_first_k(row_mask.astype(bool), c_act - 6.0)[..., :cfree, :]
        S = S.astype(dtype)
        inner = S @ J_C_INV_T[..., :, 6:] @ V2T                 # (..., cfree, cfree)
        live = (jnp.arange(cfree) < (c_act - 6.0)[..., None]).astype(dtype)
        inner = inner * live[..., :, None] * live[..., None, :]
        inner = inner + jnp.einsum(
            "...i,ij->...ij", 1.0 - live, jnp.eye(cfree, dtype=dtype)
        )
        NwJw = V2T @ sm.qr_pinv(inner)
        NwJw = NwJw * live[..., None, :]
    else:
        NwJw = jnp.zeros(W.shape[:-2] + (n - 6, 0), dtype=dtype)
    return ContactSpace(
        Lambda_c, J_C_INV_T, N_C, A_inv_N_C, W, W_inv, V2, NwJw, health
    )


class MaskedTick:
    """One compiled WBC tick over ALL contact modes of a candidate set.

    cfg.contacts is the *candidate* set (e.g. two feet + two hands); the
    per-call ``contact_mask`` (..., n_candidates) selects the active subset
    per scenario.  Shares the task/QP formulation with CompiledTick.
    """

    def __init__(self, model: RobotModel, cfg: PipelineConfig, dtype=jnp.float32):
        from .pipeline import _plan_jacobians

        self.model = model
        self.cfg = cfg
        self.kin = Kinematics(model)
        self.dtype = dtype
        self._J_bodies, self._points, self._task_slots = _plan_jacobians(model, cfg)
        self._tick = jax.jit(self._tick_impl, static_argnames=("qp_iters",))

    # Static per-type masks over the 6-padded layouts.  Non-6D contacts are
    # 6D contacts with rows statically masked (the static-shape form of the
    # reference's per-type contact_dof_, contact_constraint.cpp:19-45):
    # POINT keeps the 3 position rows; LINE keeps position + the contact-
    # frame my/mz rows (local-x moment dropped — zero-width line).
    _ROW_MASK = {
        T.CONTACT_6D: np.ones(6),
        T.CONTACT_POINT: np.array([1.0, 1, 1, 0, 0, 0]),
        T.CONTACT_LINE: np.array([1.0, 1, 1, 0, 1, 1]),
    }
    # constraint rows of the padded [ZMP(4); cone(6)] block that exist for
    # the type: POINT has no CoP rows; LINE keeps only the ±my (lx) pair.
    _CROW_MASK = {
        T.CONTACT_6D: np.ones(10),
        T.CONTACT_POINT: np.array([0.0, 0, 0, 0, 1, 1, 1, 1, 1, 1]),
        T.CONTACT_LINE: np.array([1.0, 1, 0, 0, 1, 1, 1, 1, 1, 1]),
    }

    # static per-candidate constraint blocks (padded (10,6) for every type;
    # dead rows are masked via _CROW_MASK, dead wrench components are zero
    # because their jacobian rows are masked)
    def _const_mats(self):
        out = []
        for c in self.cfg.contacts:
            Z = dyn.zmp_const_matrix(c.plane_x, c.plane_y, dtype=self.dtype)
            F = dyn.force_const_matrix(
                c.friction_ratio, c.friction_ratio_z, dtype=self.dtype
            )
            out.append(jnp.concatenate([Z, F], axis=0))
        return out

    # ------------------------------------------------------ warm-start carry
    def _level_dims(self):
        """Static (nv, rows) of each QP in the masked tick, in call order —
        padded shapes: cfree = 6·nc − 6 redistribution vars, 10 constraint
        rows per candidate contact (inactive ones are ub=+inf-masked, not
        removed).  Mirrors CompiledTick._level_dims."""
        from . import types as T
        cfg = self.cfg
        m = self.model.model_dof
        cfree = 6 * len(cfg.contacts) - 6
        k = 10 * len(cfg.contacts)
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
        """Cold-start warm state: one (x, λ) pair per QP in the tick (the
        persistent hot-start solver analog, include/dwbc.h:222-228 — the
        reference keeps one live CQuadraticProgram per hierarchy across
        ticks; here the carry is explicit and batched)."""
        return tuple(
            (jnp.zeros(batch + (nv,), self.dtype), jnp.ones(batch + (rows,), self.dtype))
            for nv, rows in self._level_dims()
        )

    def _tick_impl(self, q, qdot, fstars, contact_mask, warm=None,
                   qp_iters=None, servos=None):
        cfg = self.cfg
        model = self.model
        m = model.model_dof
        nc = len(cfg.contacts)
        st = self.kin.update(
            q, qdot, J_bodies=self._J_bodies, points=self._points
        )
        fk = FK(
            R=st.R, p=st.p,
            axis_w=jnp.einsum(
                "...bij,bj->...bi", st.R, jnp.asarray(model.axis, self.dtype)
            ),
            com_w=st.com_w,
        )
        cmask = contact_mask.astype(self.dtype)            # (..., nc)
        batch = jnp.broadcast_shapes(q.shape[:-1], contact_mask.shape[:-1])

        # padded contact jacobian + row mask (dynamic active mask × static
        # per-type row mask; LINE moment rows pre-rotated into the contact
        # frame so the masked row is the local-x moment)
        Js = []
        for i, c in enumerate(cfg.contacts):
            J = st.J_pts[..., i, :, :]
            if c.contact_type == T.CONTACT_LINE:
                RT = jnp.swapaxes(st.R[..., c.link, :, :], -1, -2)
                J = jnp.concatenate(
                    [J[..., 0:3, :], RT @ J[..., 3:6, :]], axis=-2
                )
            Js.append(J)
        J_C = jnp.concatenate(Js, axis=-2)                 # (..., 6nc, n)
        type_mask = jnp.asarray(
            np.concatenate([self._ROW_MASK[c.contact_type] for c in cfg.contacts]),
            self.dtype,
        )
        row_mask = jnp.repeat(cmask, 6, axis=-1) * type_mask  # (..., 6nc)
        J_C = J_C * row_mask[..., :, None]

        cs = masked_contact_space(J_C, st.A_inv, row_mask)
        torque_grav, P_C = dyn.gravity_compensation(
            st.A_inv, cs.W_inv, cs.N_C, cs.J_C_INV_T, st.G
        )

        # constraint blocks; inactive contacts → rows masked via ub=+inf
        consts = self._const_mats()
        k_tot = sum(cm.shape[0] for cm in consts)
        A_const = jnp.zeros((k_tot, 6 * nc), dtype=self.dtype)
        r = 0
        for i, cm in enumerate(consts):
            A_const = A_const.at[r : r + cm.shape[0], 6 * i : 6 * i + 6].set(cm)
            r += cm.shape[0]
        A_rot = jnp.zeros(batch + (6 * nc, 6 * nc), dtype=self.dtype)
        eye3 = jnp.broadcast_to(jnp.eye(3, dtype=self.dtype), batch + (3, 3))
        for i, c in enumerate(cfg.contacts):
            RT = jnp.swapaxes(st.R[..., c.link, :, :], -1, -2)
            RT = jnp.broadcast_to(RT, batch + (3, 3))
            A_rot = A_rot.at[..., 6 * i : 6 * i + 3, 6 * i : 6 * i + 3].set(RT)
            # LINE moment rows are already contact-local (see jacobian
            # assembly above) → identity; 6D/POINT rotate world→local
            Rm = eye3 if c.contact_type == T.CONTACT_LINE else RT
            A_rot = A_rot.at[..., 6 * i + 3 : 6 * i + 6, 6 * i + 3 : 6 * i + 6].set(Rm)
        # per-constraint-row activity mask (k_tot,) = dynamic contact mask ×
        # static per-type constraint-row mask
        crow_mask = jnp.concatenate(
            [
                jnp.broadcast_to(cmask[..., i : i + 1], batch + (consts[i].shape[0],))
                * jnp.asarray(self._CROW_MASK[c.contact_type], self.dtype)
                for i, c in enumerate(cfg.contacts)
            ],
            axis=-1,
        )

        tlim = (
            jnp.asarray(cfg.torque_limit, self.dtype)
            if cfg.torque_limit is not None
            else None
        )

        def mask_ub(ub_rows):
            """Blocks of (torque-limit rows ..., constraint rows): lift the
            inactive constraint rows to +inf so the solver drops them."""
            return jnp.where(crow_mask > 0.5, ub_rows, _BIG)

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
                from .pipeline import _apply_servos
                fstar = _apply_servos(
                    self.model, cfg, self.dtype, st, h, fstar, servos[h]
                )
            if cfg.use_hqp:
                Ntorque = prev_null @ tf.J_kt @ tf.Lambda_task
                res = solve_task_level_qp(
                    Ntorque, fstar, torque_grav + torque_task,
                    cs.NwJw, cs.J_C_INV_T, P_C, A_const, A_rot, tlim,
                    iters=iters, constraint_row_mask=crow_mask,
                    warm=None if warm is None else warm[h],
                )
                warm_out.append((res.x, res.lam))
                torque_h = jnp.einsum(
                    "...mt,...t->...m", tf.J_kt @ tf.Lambda_task,
                    fstar + res.f_star_delta,
                )
                torque_contact = jnp.einsum(
                    "...mc,...c->...m", cs.NwJw, res.contact_qp
                )
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
                iters=iters, constraint_row_mask=crow_mask,
                warm=None if warm is None else warm[len(cfg.task_specs)],
            )
            warm_out.append((sol.x, sol.lam))
            torque_contact = torque_contact + jnp.einsum(
                "...mc,...c->...m", cs.NwJw, sol.x
            )
            # diagnostics gated by the reference's redistribution guard
            # (`if (contact_dof > 0)` with contact_dof = total_contact_dof
            # - 6, i.e. total > 6; src/dwbc.cpp:1424): single-support
            # lanes have no redistribution problem — the padded QP's dead
            # rows can be ε-infeasible (τ at the limit + roundoff) and
            # must not leak into the lane's gap/pres
            live_redis = (jnp.sum(row_mask, axis=-1) > 6.5).astype(self.dtype)
            gap = jnp.maximum(gap, sol.gap * live_redis)
            pres = jnp.maximum(pres, sol.primal_res * live_redis)

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
            qp_error=qp_error_flag(gap, pres, torque_cmd, self.cfg),
        )
        if warm is not None:
            return result, tuple(warm_out)
        return result

    def _task_jacobian(self, st, fk, level: int):
        from .pipeline import _resolve_task_jacobian

        return _resolve_task_jacobian(
            self.kin, self.model, self.cfg, self._task_slots, st, fk, level,
            self.dtype,
        )

    def __call__(self, q, qdot, fstars, contact_mask) -> TickResult:
        q = jnp.asarray(q, self.dtype)
        qdot = jnp.asarray(qdot, self.dtype)
        fstars = tuple(jnp.asarray(f, self.dtype) for f in fstars)
        contact_mask = jnp.asarray(contact_mask)
        return self._tick(q, qdot, fstars, contact_mask)
