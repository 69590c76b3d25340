"""Torque-level hierarchical QP stage assembly (OSF-HQP path).

Pure-function equivalents of the reference's per-level QP builders:

* ``CalcSingleTaskTorqueWithQP`` (/root/reference/src/dwbc.cpp:941-1127):
  per hierarchy level, variables x = [δf* (task_dof); f_c,red (c-6)],
  minimize ½‖δf*‖² subject to torque limits and contact cone/ZMP constraints
  on the *resulting* torque τ_prev + N·J_ktΛ(f*+δf*) + NwJw·f_c.
* ``CalcContactRedistribute`` (src/dwbc.cpp:1372-1620): final QP over
  f_c,red only, minimizing ‖f_c,red‖² under the same constraints.

All assembly is batched matmul; the QP is solved by the fixed-iteration IPM
in ops/qp.py.  Shapes are static per (contact-mode, task-stack) config.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..ops.qp import solve_qp

_INF = 1.0e30


def contact_constraint_blocks(const_mats, rot_blocks):
    """Stack per-contact constraint blocks into (n_const, total_cdof) and the
    block-diagonal world→contact rotation (total_cdof, total_cdof).

    const_mats: list of (k_i, d_i) static blocks (per-type ZMP/cone rows,
    dynamics.contact_constraint_block); rot_blocks: list of (..., d_i, d_i)
    per-type rotations (dynamics.contact_rotation_block).  Column widths d_i
    follow each contact's dof (6/3/5 for 6D/point/line).
    Mirrors the A_const_a / A_rot assembly at src/dwbc.cpp:1018-1039.
    """
    k_tot = sum(m.shape[0] for m in const_mats)
    d_tot = sum(m.shape[1] for m in const_mats)
    batch = jnp.broadcast_shapes(*(rb.shape[:-2] for rb in rot_blocks))
    dtype = rot_blocks[0].dtype

    A_const = jnp.zeros((k_tot, d_tot), dtype=dtype)
    A_rot = jnp.zeros(batch + (d_tot, d_tot), dtype=dtype)
    r = c = 0
    for m, rb in zip(const_mats, rot_blocks):
        k_i, d_i = m.shape
        A_const = A_const.at[r : r + k_i, c : c + d_i].set(m)
        A_rot = A_rot.at[..., c : c + d_i, c : c + d_i].set(
            jnp.broadcast_to(rb, batch + (d_i, d_i))
        )
        r += k_i
        c += d_i
    return A_const, A_rot


class TaskQPResult(NamedTuple):
    f_star_delta: jnp.ndarray   # (t,)
    contact_qp: jnp.ndarray     # (c-6,)
    gap: jnp.ndarray
    primal_res: jnp.ndarray
    x: jnp.ndarray              # (t+cfree,) full primal (warm-start carry)
    lam: jnp.ndarray            # (rows,) dual (warm-start carry)


def solve_task_level_qp(
    Ntorque_task,    # (...,m,t)  task_null_prev @ J_kt @ Λ_t
    f_star,          # (...,t)
    torque_prev,     # (...,m)
    NwJw,            # (...,m,cfree)
    J_C_INV_T,       # (...,c,n)
    P_C,             # (...,c)
    A_const,         # (k,6nc) static
    A_rot,           # (...,6nc,6nc)
    torque_limit,    # (m,) or None
    iters: int = 25,
    warm=None,       # optional (x, lam) from a previous tick's solve
    constraint_row_mask=None,  # (...,k) 1=active cone/ZMP row (masked ticks)
    limit_rows=None,  # static index tuple: which torque rows get ± limit
                      # pairs (reduced path: actuated co rows only — the
                      # virtual lumped-body dofs are unbounded, so their
                      # rows are dropped statically instead of inf-masked)
) -> TaskQPResult:
    """One hierarchy level's QP (src/dwbc.cpp:941-1127)."""
    m = Ntorque_task.shape[-2]
    t = Ntorque_task.shape[-1]
    cfree = NwJw.shape[-1]
    k = A_const.shape[0]
    dtype = Ntorque_task.dtype
    nv = t + cfree

    # objective: ½‖δf*‖², f_c block of H at ZERO — exactly the reference's
    # (src/dwbc.cpp:988-991).  NOTE the zero block means that on a
    # degenerate contact set (rank-deficient redistribution space — e.g.
    # hands+feet point contacts) the f_c optimum is a whole FACE, and any
    # two solver inits/formulations land on different points of it (qpOASES
    # hot-vs-cold included).  An ε‖f_c‖² selection term was tried and
    # REJECTED: it measurably trades δf* optimality (the ½‖δf*‖² objective
    # grew 1e-5 relative, breaking the ≥-qpOASES optimality guarantee in
    # tests/test_golden_parity.py) for face determinism.  Cross-formulation
    # tests instead assert τ components by how well they're determined (see
    # CLAUDE.md "Flat-face torques").
    H = jnp.zeros((nv, nv), dtype=dtype)
    H = H.at[jnp.arange(t), jnp.arange(t)].set(1.0)
    g = jnp.zeros(nv, dtype=dtype)

    tau_base = torque_prev + jnp.einsum("...mt,...t->...m", Ntorque_task, f_star)

    rows = []
    ubs = []
    if torque_limit is not None:
        blk = jnp.concatenate([Ntorque_task, NwJw], axis=-1)          # (...,m,nv)
        tl, tb = torque_limit, tau_base
        if limit_rows is not None:
            import numpy as _np

            li = _np.asarray(limit_rows)
            blk = blk[..., li, :]
            tl = tl[..., li]
            tb = tb[..., li]
        rows.append(blk)
        rows.append(-blk)
        ubs.append(tl - tb)
        ubs.append(tl + tb)

    # contact cone/ZMP rows: -(A_const A_rot J̄ᵀ_act) [Ntorque | NwJw] x ≤ -bA
    CM = A_const @ A_rot                                              # (...,k,6nc)
    Atemp = CM @ J_C_INV_T[..., :, -m:]                               # (...,k,m)
    blk_c = -jnp.concatenate(
        [Atemp @ Ntorque_task, Atemp @ NwJw], axis=-1
    )
    rows.append(blk_c)
    bA = jnp.einsum("...kc,...c->...k", CM, P_C) - jnp.einsum(
        "...km,...m->...k", Atemp, tau_base
    )
    ub_c = -bA
    if constraint_row_mask is not None:
        # inactive contacts' rows → ub=+inf, dropped by the solver's masking
        ub_c = jnp.where(constraint_row_mask > 0.5, ub_c, _INF)
    ubs.append(ub_c)

    A = jnp.concatenate(rows, axis=-2)
    ub = jnp.concatenate(ubs, axis=-1)

    sol = solve_qp(H, g, A, None, ub, iters=iters, warm=warm)
    return TaskQPResult(
        f_star_delta=sol.x[..., :t],
        contact_qp=sol.x[..., t:],
        gap=sol.gap,
        primal_res=sol.primal_res,
        x=sol.x,
        lam=sol.lam,
    )


def solve_contact_redistribution_qp(
    torque_input,    # (...,m) τ_grav + τ_task + τ_contact so far
    NwJw,            # (...,m,cfree)
    J_C_INV_T,       # (...,c,n)
    P_C,             # (...,c)
    A_const,
    A_rot,
    torque_limit,
    iters: int = 25,
    tangential_weight: bool = False,
    warm=None,
    constraint_row_mask=None,
    limit_rows=None,  # static: which torque rows get ± limit pairs
):
    """Final redistribution QP over f_c,red (src/dwbc.cpp:1396-1561).

    tangential_weight=True uses the reduced path's objective
    (``CalcContactRedistributeR``, src/dwbc.cpp:4814-4848): minimize the
    *tangential* components of the resulting contact forces (contact-frame
    rotation with the normal row zeroed) instead of ‖f_c,red‖².
    """
    m = NwJw.shape[-2]
    cfree = NwJw.shape[-1]
    dtype = NwJw.dtype

    if tangential_weight:
        # RotW·crot: contact-frame rotation, fz rows dropped
        nc6 = A_rot.shape[-1]
        RotW = jnp.ones(nc6, dtype=dtype)
        for i in range(nc6 // 6):
            RotW = RotW.at[6 * i + 2].set(0.0)
        crot = A_rot * RotW[..., :, None]
        H_temp = crot @ J_C_INV_T[..., :, -m:] @ NwJw          # (...,nc6,cfree)
        H = jnp.swapaxes(H_temp, -1, -2) @ H_temp + 1e-8 * jnp.eye(cfree, dtype=dtype)
        cf_now = jnp.einsum(
            "...km,...m->...k", crot @ J_C_INV_T[..., :, -m:], torque_input
        ) - jnp.einsum("...kc,...c->...k", crot, P_C)
        g = jnp.einsum("...k,...km->...m", cf_now, H_temp)
    else:
        H = jnp.eye(cfree, dtype=dtype)
        g = jnp.zeros(cfree, dtype=dtype)

    rows = []
    ubs = []
    if torque_limit is not None:
        blk, tl, ti = NwJw, torque_limit, torque_input
        if limit_rows is not None:
            import numpy as _np

            li = _np.asarray(limit_rows)
            blk = blk[..., li, :]
            tl = tl[..., li]
            ti = ti[..., li]
        rows.append(blk)
        rows.append(-blk)
        ubs.append(tl - ti)
        ubs.append(tl + ti)

    CM = -(A_const @ A_rot)
    JT_act = J_C_INV_T[..., :, -m:]
    rows.append(CM @ JT_act @ NwJw)
    ub_c = jnp.einsum("...kc,...c->...k", CM, P_C) - jnp.einsum(
        "...km,...m->...k", CM @ JT_act, torque_input
    )
    if constraint_row_mask is not None:
        ub_c = jnp.where(constraint_row_mask > 0.5, ub_c, _INF)
    ubs.append(ub_c)

    A = jnp.concatenate(rows, axis=-2)
    ub = jnp.concatenate(ubs, axis=-1)
    sol = solve_qp(H, g, A, None, ub, iters=iters, warm=warm)
    return sol
