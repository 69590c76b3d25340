"""ReducedTick: the reduced-dimension pipeline in the serving shape.

The reference's `_R` path (``ReducedDynamicsCalculate`` →
``ReducedCalcContactConstraint`` → ``ReducedCalcGravCompensation`` →
``ReducedCalcTaskSpace`` → ``ReducedCalcTaskControlTorque`` →
``ReducedCalcContactRedistribute``, /root/reference/src/dwbc.cpp:2752-3770)
exists in this repo twice: as the eager, per-call parity surface on the
``RobotData`` facade (wbc/robot.py) and — here — as ONE compiled, batched,
warm-startable graph shaped like ``CompiledTick``.

What the reduction buys, in XLA terms:

* the whole OSF cascade (W⁻¹, JKT, null projectors) runs in
  ``reduced_model_dof = co_dof + 6`` coordinates (18 for Tocabi
  double-support legs) instead of ``model_dof`` (33);
* the per-level QPs drop from ``2·model_dof`` ± torque-limit rows to
  ``2·co_dof`` — the virtual lumped-body dofs are unbounded and their rows
  are removed *statically* (``limit_rows``), not inf-masked (the reference
  instead slices torque_limit_[0:reduced_model_dof], src/dwbc.cpp:3513,
  misapplying joint limits to the virtual dofs);
* chain classification (co/nc/vc) is static per contact mode — plain index
  arrays baked into the compiled graph, no RBDL-internal surgery
  (src/dwbc.cpp:2828-2878).

Cost over the full tick: the nc-chain lumping einsums (reduced_dynamics),
a *partial* full-system contact space (Λ_c, J̄_cᵀ, N_C, A⁻¹N_C — needed
by non-contact-chain task Λ, src/dwbc.cpp:3104-3110), the nc resultant
QP (a 4th solve), and the scatter recomposition.

Throughput against the full tick on the GPU is not measured.  The
reduction shrinks FLOPs while ADDING distinct small ops, so on a batched
XLA tick that is bound by its many small ops it need not be faster (the
reference's CPU "Time-Efficient" result does not carry over by itself).
The class is the semantic/parity surface for reduced-coordinate serving;
for raw throughput serve the full tick (libdwbc_tpu.backend).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..kin.engine import FK, Kinematics
from ..model.compile import RobotModel
from . import dynamics as dyn
from . import types as T
from .hqp import solve_contact_redistribution_qp, solve_task_level_qp
from .pipeline import (
    PipelineConfig,
    TickResult,
    qp_error_flag,
    _apply_servos,
    _parse_task_spec,
    _plan_jacobians,
    _resolve_task_jacobian,
)
from .reduced import classify_chains, reduced_contact_space, reduced_dynamics


class ReducedTick:
    """One compiled reduced-coordinate WBC tick for a fixed configuration.

    API mirrors ``CompiledTick``: ``__call__(q, qdot, fstars)``,
    ``init_warm(batch)``, ``_tick_impl(..., warm=, qp_iters=, servos=)``.
    Requires a model with a non-empty non-contact chain (otherwise the
    reduction is degenerate — use CompiledTick, as the facade does,
    wbc/robot.py ReducedDynamicsCalculate).
    """

    def __init__(self, model: RobotModel, cfg: PipelineConfig, dtype=jnp.float32,
                 tangential_weight: bool = True):
        self.model = model
        self.cfg = cfg
        self.kin = Kinematics(model)
        self.dtype = dtype
        # reference parity default: the `_R` redistribution minimizes the
        # tangential contact forces (CalcContactRedistributeR weighted H,
        # src/dwbc.cpp:4814-4848); False = the full path's min-norm
        # objective (useful for full-vs-reduced similarity checks)
        self.tangential_weight = tangential_weight
        self.ridx = classify_chains(model, [c.link for c in cfg.contacts])
        if self.ridx.nc_dof == 0:
            raise ValueError(
                "every joint is on the contact chain — the reduction is "
                "degenerate (nothing to lump); use CompiledTick"
            )
        # static actuated-joint index maps (general scatter; the reference
        # assumes co joints are the first contact_dof_ actuated joints,
        # src/dwbc.cpp:3766)
        self._co_act = np.asarray(self.ridx.co_joints) - 6
        self._nc_act = np.asarray(self.ridx.nc_joints) - 6
        self._limit_rows = (
            tuple(range(self.ridx.co_dof))
            if cfg.torque_limit is not None else None
        )
        # static task classification (ReducedCalcTaskSpace,
        # src/dwbc.cpp:3165-3228)
        co_set = set(self.ridx.co_links)
        self._level_kind: list[str] = []
        for level in cfg.task_specs:
            links = [spec[1] for spec in level]
            is_cmm = any(l == model.nbody for l in links)
            is_co = any(l in co_set and l != model.nbody for l in links)
            is_nc = any(l not in co_set and l != model.nbody for l in links)
            if is_co and is_nc:
                raise NotImplementedError(
                    "a task level spanning both chains is undefined in the "
                    "reduced formulation (reference 'UNDEFINED TASK TYPE', "
                    "src/task.cpp:134-143)"
                )
            self._level_kind.append(
                "cmm" if is_cmm else ("nc" if is_nc else "co")
            )
        self._nc_levels = [
            h for h, k in enumerate(self._level_kind) if k == "nc"
        ]
        for a, b in zip(self._nc_levels, self._nc_levels[1:]):
            if b != a + 1:
                raise NotImplementedError(
                    "non-consecutive nc task levels: the second-nc null-space "
                    "correction reads the immediately previous level's nc "
                    "task (src/dwbc.cpp:3292-3335)"
                )
        # jacobian narrowing plan + guaranteed base-origin jacobian slot
        jb, self._points, self._task_slots = _plan_jacobians(model, cfg)
        if jb is not None and 0 not in jb:
            jb = jb + (0,)
        self._J_bodies = jb
        self._base_slot = None if jb is None else jb.index(0)
        self._tick = jax.jit(self._tick_impl, static_argnames=("qp_iters",))

    # ------------------------------------------------------------- helpers
    def _contact_jacobian_pts(self, st):
        Js = []
        for i, c in enumerate(self.cfg.contacts):
            Js.append(
                dyn.contact_jacobian_rows(
                    st.J_pts[..., i, :, :], st.R[..., c.link, :, :], c.contact_type
                )
            )
        return jnp.concatenate(Js, axis=-2)

    def _constraint_blocks(self, st):
        consts, rots = [], []
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
        from .hqp import contact_constraint_blocks

        return contact_constraint_blocks(consts, rots)

    def _jkt_r(self, J_task_R, csr):
        """CalculateJKT_R (src/wbd.cpp:220-226) in reduced coordinates."""
        JAN = J_task_R @ csr.A_inv_N_C
        M = JAN @ jnp.swapaxes(J_task_R, -1, -2)
        Lam = dyn._psd_inv_reg(0.5 * (M + jnp.swapaxes(M, -1, -2)))
        Q = (Lam @ JAN)[..., :, 6:]
        QT = jnp.swapaxes(Q, -1, -2)
        QWQ = Q @ csr.W_inv @ QT
        J_kt = csr.W_inv @ QT @ dyn._psd_inv_reg(
            0.5 * (QWQ + jnp.swapaxes(QWQ, -1, -2))
        )
        return J_kt, Lam

    def _reduced_tlim(self):
        """Actuated co-joint limits, reduced-coordinate order; the virtual
        lumped-body rows are dropped statically via ``limit_rows``."""
        if self.cfg.torque_limit is None:
            return None
        co = self.ridx.co_dof
        tl = np.full(co + 6, np.inf)
        tl[:co] = np.asarray(self.cfg.torque_limit)[self._co_act]
        return jnp.asarray(tl, self.dtype)

    # ----------------------------------------------------- warm-start carry
    def _level_dims(self):
        cfg = self.cfg
        co = self.ridx.co_dof
        cdof = sum(c.contact_dof for c in cfg.contacts)
        cfree = cdof - 6
        k = sum(c.constraint_number for c in cfg.contacts)
        lim_rows = 2 * co if cfg.torque_limit is not None else 0
        dims = []
        # Every entry must mirror a QP that _tick_impl actually RUNS (and
        # hence a warm_out slot it actually emits): use_hqp=False runs no
        # QPs at all, and the redistribution QP is skipped when the contact
        # free space is empty (csr.NwJw has 0 columns — single 6D contact).
        # Emitting extra slots here breaks warm-chained loops with a carry
        # structure mismatch (ADVICE r04).
        if not cfg.use_hqp:
            return dims
        for h, level in enumerate(cfg.task_specs):
            if self._level_kind[h] == "nc":
                continue
            t = sum(
                6 if spec[0] in (T.TASK_LINK_6D, T.TASK_LINK_6D_COM_FRAME,
                                 T.TASK_LINK_6D_CUSTOM_FRAME) else 3
                for spec in level
            )
            dims.append((t + cfree, lim_rows + k))
        if self._nc_levels:
            dims.append((6 + cfree, lim_rows + k))
        if cfree > 0:
            dims.append((cfree, lim_rows + k))
        return dims

    def init_warm(self, batch=()):
        return tuple(
            (jnp.zeros(batch + (nv,), self.dtype),
             jnp.ones(batch + (rows,), self.dtype))
            for nv, rows in self._level_dims()
        )

    # ---------------------------------------------------------------- tick
    def _tick_impl(self, q, qdot, fstars, warm=None, qp_iters=None, servos=None):
        cfg = self.cfg
        idx = self.ridx
        model = self.model
        dtype = self.dtype
        m_full = model.model_dof
        co, ncd = idx.co_dof, idx.nc_dof
        r_model = idx.reduced_model_dof
        ncj = jnp.asarray(idx.nc_joints)
        co_act = jnp.asarray(self._co_act)
        nc_act = jnp.asarray(self._nc_act)
        iters = cfg.qp_iters if qp_iters is None else qp_iters

        st = self.kin.update(
            q, qdot, J_bodies=self._J_bodies, points=self._points
        )
        fk = FK(
            R=st.R, p=st.p,
            axis_w=jnp.einsum(
                "...bij,bj->...bi", st.R, jnp.asarray(model.axis, dtype)
            ),
            com_w=st.com_w,
        )
        batch = q.shape[:-1]

        # ---- reduced dynamics + reduced contact space ------------------
        rd = reduced_dynamics(model, idx, st)
        J_C = self._contact_jacobian_pts(st)
        csr, J_CR = reduced_contact_space(idx, J_C, rd)

        # ---- partial FULL contact space (nc-task Λ needs A⁻¹N_C;
        # src/dwbc.cpp:3104-3110 — W/V2/NwJw deliberately not computed) ---
        JAinv = J_C @ st.A_inv
        Mc = JAinv @ jnp.swapaxes(J_C, -1, -2)
        Lambda_c = dyn._psd_inv(0.5 * (Mc + jnp.swapaxes(Mc, -1, -2)))
        J_C_INV_T_full = Lambda_c @ JAinv
        N_C_full = jnp.eye(model.ndof, dtype=dtype) - jnp.swapaxes(
            J_C, -1, -2
        ) @ J_C_INV_T_full
        A_inv_N_C_full = st.A_inv @ N_C_full
        P_C_full = jnp.einsum("...ij,...j->...i", J_C_INV_T_full, st.G)

        # ---- gravity (ReducedCalcGravCompensation, src/dwbc.cpp:3144-50)
        NG = jnp.einsum("...ij,...j->...i", csr.N_C, rd.G_R)
        tg_R = jnp.einsum(
            "...ij,...j->...i", csr.W_inv,
            jnp.einsum("...ij,...j->...i", rd.A_R_inv[..., -r_model:, :], NG),
        )
        P_CR = jnp.einsum("...ij,...j->...i", csr.J_C_INV_T, rd.G_R)
        torque_grav = jnp.zeros(batch + (m_full,), dtype=dtype)
        torque_grav = torque_grav.at[..., co_act].set(tg_R[..., :co])
        torque_grav = torque_grav.at[..., nc_act].set(
            jnp.broadcast_to(rd.G_NC, batch + (ncd,))
        )

        # ---- base-link reduced JKT (nc-task torque coupling,
        # src/dwbc.cpp:3159-3160) -----------------------------------------
        if self._base_slot is None:
            J0 = st.J[..., 0, :, :]
        else:
            J0 = st.J[..., self._base_slot, :, :]
        J_base_R = jnp.zeros(batch + (6, idx.reduced_system_dof), dtype=dtype)
        J_base_R = J_base_R.at[..., :, 0:6].set(J0[..., :, 0:6])
        J_base_R_kt, _ = self._jkt_r(J_base_R, csr)

        tlim = self._reduced_tlim()
        A_const, A_rot = self._constraint_blocks(st)
        R0 = st.R[..., 0, :, :]
        vcj = jnp.asarray(idx.vc_joints)

        torque_task_R = jnp.zeros(batch + (r_model,), dtype=dtype)
        torque_task_NC = jnp.zeros(batch + (ncd,), dtype=dtype)
        force_on_nc = jnp.zeros(batch + (6,), dtype=dtype)
        gap = jnp.zeros(batch, dtype=dtype)
        pres = jnp.zeros(batch, dtype=dtype)
        warm_out = []
        qp_i = 0

        # per-level bookkeeping for nc null-space corrections
        nulls: list = []            # reduced null projector after each level
        nc_entries: list = []       # (torque_null_h_R, torque_null_h_nc)
        prev_nc = None              # (J_task, J_task_NC, Lambda) of prev nc
        prev_null = jnp.broadcast_to(
            jnp.eye(r_model, dtype=dtype), batch + (r_model, r_model)
        )

        for h, level in enumerate(cfg.task_specs):
            kind = self._level_kind[h]
            J_task = _resolve_task_jacobian(
                self.kin, model, cfg, self._task_slots, st, fk, h, dtype
            )
            fstar = jnp.asarray(fstars[h], dtype)
            if servos is not None and servos[h] is not None:
                fstar = _apply_servos(model, cfg, dtype, st, h, fstar, servos[h])

            if kind == "nc":
                # analytic nc-chain torque + resultant-force bookkeeping
                # (src/dwbc.cpp:3292-3335)
                Lam = dyn._psd_inv_reg(
                    J_task @ A_inv_N_C_full @ jnp.swapaxes(J_task, -1, -2)
                )
                Lf = jnp.einsum("...tu,...u->...t", Lam, fstar)
                temp = jnp.einsum("...tn,...t->...n", J_task, Lf)
                torque_nc = temp[..., ncj]
                f_on = jnp.concatenate(
                    [temp[..., 0:3],
                     jnp.einsum("...ij,...j->...i", R0, temp[..., 3:6])],
                    axis=-1,
                )
                th_R = jnp.concatenate(
                    [jnp.einsum("...mt,...t->...m", J_base_R_kt, f_on)[..., :co],
                     jnp.einsum("...ij,...j->...i", rd.J_I_nc_inv_T, torque_nc)],
                    axis=-1,
                )
                if prev_nc is None:
                    force_on_nc = force_on_nc + f_on
                    nc_entries.append((
                        jnp.einsum("...mn,...n->...m", prev_null, th_R),
                        torque_nc,
                    ))
                else:
                    # second+ nc level: subtract the previous nc task's
                    # null-space force coupling (src/dwbc.cpp:3307-3335)
                    Jp, Jp_NC, Lam_p = prev_nc
                    null_force = jnp.einsum(
                        "...tu,...u->...t", Lam_p,
                        jnp.einsum(
                            "...tn,...n->...t", Jp,
                            jnp.einsum("...nm,...m->...n", A_inv_N_C_full, temp),
                        ),
                    )
                    temp2 = jnp.einsum("...tn,...t->...n", Jp, null_force)
                    t_nc_corr = torque_nc - temp2[..., ncj]
                    temp2_6 = jnp.concatenate(
                        [temp2[..., 0:3],
                         jnp.einsum("...ij,...j->...i", R0, temp2[..., 3:6])],
                        axis=-1,
                    )
                    nthr = jnp.concatenate(
                        [th_R[..., :co]
                         - jnp.einsum(
                             "...mt,...t->...m", J_base_R_kt, temp2_6
                         )[..., :co],
                         jnp.einsum(
                             "...ij,...j->...i", rd.J_I_nc_inv_T,
                             torque_nc - jnp.einsum(
                                 "...nt,...t->...n",
                                 jnp.swapaxes(Jp_NC, -1, -2), null_force
                             ),
                         )],
                        axis=-1,
                    )
                    force_on_nc = force_on_nc + f_on - temp2_6
                    nc_entries.append((
                        jnp.einsum("...mn,...n->...m", prev_null, nthr),
                        t_nc_corr,
                    ))
                prev_nc = (J_task, J_task[..., :, ncj], Lam)
                nulls.append(prev_null)  # nc tasks don't consume null space
                continue

            # ---- co / cmm task level: reduced JKT + QP ------------------
            JR = jnp.zeros(
                batch + (J_task.shape[-2], idx.reduced_system_dof), dtype=dtype
            )
            JR = JR.at[..., :, : idx.vc_dof].set(J_task[..., :, vcj])
            if kind == "cmm":
                JR = JR.at[..., :, idx.vc_dof :].set(
                    J_task[..., :, ncj] @ jnp.swapaxes(rd.J_I_nc_inv_T, -1, -2)
                )
            J_kt_R, Lam = self._jkt_r(JR, csr)
            if cfg.use_hqp:
                Ntorque = prev_null @ J_kt_R @ Lam
                res = solve_task_level_qp(
                    Ntorque, fstar, tg_R + torque_task_R,
                    csr.NwJw, csr.J_C_INV_T, P_CR, A_const, A_rot, tlim,
                    iters=iters,
                    warm=None if warm is None else warm[qp_i],
                    limit_rows=self._limit_rows,
                )
                warm_out.append((res.x, res.lam))
                qp_i += 1
                gap = jnp.maximum(gap, res.gap)
                pres = jnp.maximum(pres, res.primal_res)
                th_R = jnp.einsum(
                    "...mt,...t->...m", J_kt_R @ Lam, fstar + res.f_star_delta
                )
            else:
                th_R = jnp.einsum("...mt,...t->...m", J_kt_R @ Lam, fstar)
            torque_task_R = torque_task_R + jnp.einsum(
                "...mn,...n->...m", prev_null, th_R
            )
            prev_null = dyn.task_null_space(
                J_kt_R, Lam, JR, csr.A_inv_N_C, prev_null
            )
            nulls.append(prev_null)

        # ---- nc resultant-force QP (CalcSingleTaskTorqueWithQP_R_NC,
        # src/dwbc.cpp:3419-3428, 3601-3756) ------------------------------
        torque_task_R_qp = jnp.zeros(batch + (r_model,), dtype=dtype)
        if cfg.use_hqp and self._nc_levels:
            h0 = self._nc_levels[0]
            nprev = (
                nulls[h0 - 1] if h0 > 0
                else jnp.broadcast_to(
                    jnp.eye(r_model, dtype=dtype), batch + (r_model, r_model)
                )
            )
            res = solve_task_level_qp(
                nprev @ J_base_R_kt, force_on_nc, tg_R + torque_task_R,
                csr.NwJw, csr.J_C_INV_T, P_CR, A_const, A_rot, tlim,
                iters=iters,
                warm=None if warm is None else warm[qp_i],
                limit_rows=self._limit_rows,
            )
            warm_out.append((res.x, res.lam))
            qp_i += 1
            gap = jnp.maximum(gap, res.gap)
            pres = jnp.maximum(pres, res.primal_res)
            tq = jnp.einsum("...mt,...t->...m", J_base_R_kt, res.f_star_delta)
            torque_task_R_qp = torque_task_R_qp.at[..., :co].set(tq[..., :co])
        for th_R_nc, t_nc in nc_entries:
            torque_task_R = torque_task_R + th_R_nc
            torque_task_NC = torque_task_NC + t_nc

        # ---- recomposition (src/dwbc.cpp:3442-3443) ---------------------
        torque_task = jnp.zeros(batch + (m_full,), dtype=dtype)
        torque_task = torque_task.at[..., co_act].set(
            torque_task_R[..., :co] + torque_task_R_qp[..., :co]
        )
        torque_task = torque_task.at[..., nc_act].set(
            jnp.einsum("...ij,...i->...j", rd.J_I_nc, torque_task_R[..., co:])
            + jnp.einsum("...ij,...j->...i", rd.N_I_nc, torque_task_NC)
        )

        # ---- contact redistribution in reduced coords
        # (ReducedCalcContactRedistribute, src/dwbc.cpp:3758-3770) --------
        torque_contact = jnp.zeros(batch + (m_full,), dtype=dtype)
        if cfg.use_hqp and csr.NwJw.shape[-1] > 0:
            sol = solve_contact_redistribution_qp(
                tg_R + torque_task_R, csr.NwJw, csr.J_C_INV_T, P_CR,
                A_const, A_rot, tlim, iters=iters,
                tangential_weight=self.tangential_weight,
                warm=None if warm is None else warm[qp_i],
                limit_rows=self._limit_rows,
            )
            warm_out.append((sol.x, sol.lam))
            qp_i += 1
            gap = jnp.maximum(gap, sol.gap)
            pres = jnp.maximum(pres, sol.primal_res)
            tcR = jnp.einsum("...mc,...c->...m", csr.NwJw, sol.x)
            torque_contact = torque_contact.at[..., co_act].set(tcR[..., :co])

        torque_cmd = torque_grav + torque_task + torque_contact
        cforce = dyn.contact_force_from_torque(
            torque_cmd, J_C_INV_T_full, P_C_full
        )
        result = TickResult(
            torque_grav=torque_grav,
            torque_task=torque_task,
            torque_contact=torque_contact,
            torque_cmd=torque_cmd,
            contact_force=cforce,
            qp_gap=gap,
            qp_primal_res=pres,
            contact_rank_health=csr.rank_health,
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
