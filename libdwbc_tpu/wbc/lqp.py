"""Lexicographic QP cascade (acceleration-level LQP, the reference's HQP
class) — batched and static-shaped.

Re-derivation of ``HQP``/``HQP_Hierarch`` (/root/reference/src/dwbc_hqp.cpp)
and the problem builders ``ConfigureLQP[_R[_NC]]`` (src/dwbc.cpp:4304-4760):

Each level carries inequality ``A y + a ≤ v`` and equality ``B y + b = w``
constraints over y = [q̈; f_c].  Levels are solved sequentially in the null
space of all higher-priority equalities: Z_0 = null(B_0),
Z_i = Z_{i-1}·null(B_i Z_{i-1}); level i minimizes
``‖B_i(y + Z u) + b_i‖² + y'H y-term + ‖v‖²`` subject to its own and all
previous levels' (slack-frozen) inequalities.

Design choices:
* the cascade depth and every constraint-block shape are static → the whole
  cascade is one traced graph, no per-level host round trips;
* null bases via SVD with **statically known ranks** (the equality stacks
  have full row rank by construction) instead of rank-revealing COD
  (``getNullSpace``, src/math.cpp:349-360);
* each level's QP solved by the fixed-iteration IPM (ops/qp.py) instead of
  warm-started OSQP (src/dwbc_hqp.cpp:583-631).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import jax.numpy as jnp

from ..ops.qp import solve_qp

_INF = 1.0e30


@dataclasses.dataclass
class LQPLevel:
    """One priority level. Arrays may carry leading batch dims."""

    A: jnp.ndarray | None     # (mi, nv) inequality  A y + a ≤ v
    a: jnp.ndarray | None
    B: jnp.ndarray            # (me, nv) equality    B y + b = w
    b: jnp.ndarray
    rank: int                 # static row rank of B (after nulling)
    H: jnp.ndarray | None = None   # optional quadratic regularizer on y
    normalize: bool = True


def _row_normalize(M, v):
    n = jnp.linalg.norm(M, axis=-1, keepdims=True)
    n = jnp.where(n > 0, n, 1.0)
    return M / n, v / n[..., 0]


def _null_basis(B, rank: int):
    """Orthonormal null basis of B (static rank) via SVD."""
    _, _, Vt = jnp.linalg.svd(B, full_matrices=True)
    return jnp.swapaxes(Vt, -1, -2)[..., :, rank:]


class LQPResult(NamedTuple):
    y: jnp.ndarray            # final solution [q̈; f_c]
    v_slacks: tuple           # per-level inequality slacks
    gap: jnp.ndarray
    primal_res: jnp.ndarray


def solve_cascade(
    levels: Sequence[LQPLevel],
    y0: jnp.ndarray,
    solve_level0: bool = False,
    qp_iters: int = 25,
    timers: list | None = None,
) -> LQPResult:
    """Run the lexicographic cascade.

    y0: seed satisfying level 0's equality (the reference seeds
    y = [-A⁻¹B; 0], src/dwbc.cpp:4381, and skips solving level 0 unless
    ``solvefirst`` is used — set solve_level0=True for that behavior).

    timers: optional list — when given, each solved level appends
    ``{"level", "update_us", "solve_us"}`` with host-visible wall times for
    its QP assembly and solve (the reference's per-hierarchy
    qp_update_time_step_/qp_solve_time_step_ capture,
    include/dwbc_hqp.h:98-102, src/dwbc_hqp.cpp:277-280, 381-383).  Timing
    mode forces eager per-level synchronization — use it on the eager
    facade path, never inside jit (a traced clock would be meaningless).
    """
    nv = y0.shape[-1]
    dtype = y0.dtype
    batch = y0.shape[:-1]

    lv = []
    for L in levels:
        A, a, B, b = L.A, L.a, L.B, L.b
        if L.normalize:
            B, b = _row_normalize(B, b)
            if A is not None:
                A, a = _row_normalize(A, a)
        lv.append(dataclasses.replace(L, A=A, a=a, B=B, b=b))

    # null-space chain (static ranks)
    Zs = [_null_basis(lv[0].B, lv[0].rank)]
    for L in lv[1:]:
        Bn = L.B @ Zs[-1]
        Zs.append(Zs[-1] @ _null_basis(Bn, L.rank))

    y = y0
    v_ans = []
    gap = jnp.zeros(batch, dtype=dtype)
    pres = jnp.zeros(batch, dtype=dtype)

    def level_qp(i, y, extra_prev):
        import time as _time

        t_start = _time.perf_counter() if timers is not None else 0.0
        L = lv[i]
        Z = Zs[i - 1] if i > 0 else jnp.eye(nv, dtype=dtype)
        nu = Z.shape[-1]
        mi = L.A.shape[-2] if L.A is not None else 0
        nvar = nu + mi

        T = L.B @ Z
        t2 = jnp.einsum("...ij,...j->...i", L.B, y) + L.b
        H = jnp.zeros(batch + (nvar, nvar), dtype=dtype)
        g = jnp.zeros(batch + (nvar,), dtype=dtype)
        Huu = jnp.swapaxes(T, -1, -2) @ T
        gu = jnp.einsum("...ji,...j->...i", T, t2)
        if L.H is not None:
            Huu = Huu + jnp.swapaxes(Z, -1, -2) @ L.H @ Z
            gu = gu + jnp.einsum(
                "...ji,...j->...i", Z, jnp.einsum("...ij,...j->...i", L.H, y)
            )
        H = H.at[..., :nu, :nu].set(Huu)
        g = g.at[..., :nu].set(gu)
        if mi:
            H = H.at[..., nu:, nu:].add(jnp.eye(mi, dtype=dtype))

        rows = []
        ubs = []
        if mi:
            blk = jnp.concatenate(
                [L.A @ Z, -jnp.broadcast_to(jnp.eye(mi, dtype=dtype),
                                            batch + (mi, mi))], axis=-1
            )
            rows.append(blk)
            ubs.append(-jnp.einsum("...ij,...j->...i", L.A, y) - L.a)
            # v ≥ 0 (the reference enforces this via box bounds on qpOASES,
            # and implicitly via the ‖v‖² objective on OSQP)
            vrows = jnp.zeros(batch + (mi, nvar), dtype=dtype)
            vrows = vrows.at[..., :, nu:].set(-jnp.eye(mi, dtype=dtype))
            rows.append(vrows)
            ubs.append(jnp.zeros(batch + (mi,), dtype=dtype))
        for (Aj, aj, vj) in extra_prev:
            blk = jnp.concatenate(
                [Aj @ Z, jnp.zeros(batch + (Aj.shape[-2], mi), dtype=dtype)],
                axis=-1,
            )
            rows.append(blk)
            ubs.append(vj - jnp.einsum("...ij,...j->...i", Aj, y) - aj)

        if rows:
            Am = jnp.concatenate(rows, axis=-2)
            ub = jnp.concatenate(ubs, axis=-1)
            if timers is not None:
                import jax as _jax

                _jax.block_until_ready((H, g, Am, ub))
                t_upd = _time.perf_counter()
            sol = solve_qp(H, g, Am, None, ub, iters=qp_iters)
            x = sol.x
            if timers is not None:
                import jax as _jax

                _jax.block_until_ready(x)
                t_end = _time.perf_counter()
                timers.append(dict(
                    level=i,
                    update_us=round((t_upd - t_start) * 1e6, 1),
                    solve_us=round((t_end - t_upd) * 1e6, 1),
                ))
            sgap, spres = sol.gap, sol.primal_res
        else:
            # pure equality least squares: u = -(Huu)⁻¹ gu (regularized)
            if timers is not None:
                import jax as _jax

                _jax.block_until_ready((Huu, gu))
                t_upd = _time.perf_counter()
            Hr = Huu + 1e-10 * jnp.eye(nu, dtype=dtype)
            x = jnp.concatenate(
                [-jnp.linalg.solve(Hr, gu[..., None])[..., 0]], axis=-1
            )
            if timers is not None:
                import jax as _jax

                _jax.block_until_ready(x)
                timers.append(dict(
                    level=i,
                    update_us=round((t_upd - t_start) * 1e6, 1),
                    solve_us=round((_time.perf_counter() - t_upd) * 1e6, 1),
                ))
            sgap = jnp.zeros(batch, dtype=dtype)
            spres = jnp.zeros(batch, dtype=dtype)

        u = x[..., :nu]
        v = x[..., nu:] if mi else jnp.zeros(batch + (0,), dtype=dtype)
        y_new = y + jnp.einsum("...ij,...j->...i", Z, u)
        return y_new, v, sgap, spres

    prev_ineq = []
    for i, L in enumerate(lv):
        if i == 0 and not solve_level0:
            v = jnp.zeros(batch + (L.A.shape[-2] if L.A is not None else 0,), dtype=dtype)
            v_ans.append(v)
            if L.A is not None:
                prev_ineq.append((L.A, L.a, v))
            continue
        if i == 0:
            # solvefirst (src/dwbc_hqp.cpp:222-289): full-space LS + slacks
            y, v, sgap, spres = level_qp(0, jnp.zeros_like(y), [])
        else:
            y, v, sgap, spres = level_qp(i, y, prev_ineq)
        gap = jnp.maximum(gap, sgap)
        pres = jnp.maximum(pres, spres)
        v_ans.append(v)
        if L.A is not None:
            prev_ineq.append((L.A, L.a, v))

    return LQPResult(y=y, v_slacks=tuple(v_ans), gap=gap, primal_res=pres)


# ---------------------------------------------------------------------------
# Problem builders (ConfigureLQP, src/dwbc.cpp:4304-4430)
# ---------------------------------------------------------------------------

def build_lqp_levels(
    A_mat, B_vec, J_C, contact_const_mat, task_Js, task_fstars,
    torque_limit: float = 200.0, acc_limit: float = 5.0,
):
    """Full-coordinates LQP levels over y = [q̈ (n); f_c (c)].

    L0: τ-limits on actuated EoM rows; eq: floating-base Newton-Euler.
    L1: contact cones + joint accel limits; eq: J_C q̈ = 0.
    L2+: per task, eq J_task q̈ = f*.
    contact_const_mat: (10·nc, c) = -A_const·A_rot (getContactConstraintMatrix).
    """
    n = A_mat.shape[-1]
    c = J_C.shape[-2]
    m = n - 6
    dtype = A_mat.dtype
    nv = n + c
    batch = A_mat.shape[:-2]

    JCT = jnp.swapaxes(J_C, -1, -2)

    def z(*shape):
        return jnp.zeros(batch + shape, dtype=dtype)

    # Level 0
    B0 = jnp.concatenate([A_mat[..., 0:6, :], JCT[..., 0:6, :]], axis=-1)
    b0 = B_vec[..., 0:6]
    tl = jnp.full(batch + (m,), torque_limit, dtype=dtype)
    act = jnp.concatenate([A_mat[..., 6:, :], JCT[..., 6:, :]], axis=-1)
    A0 = jnp.concatenate([act, -act], axis=-2)
    a0 = jnp.concatenate(
        [-tl + B_vec[..., 6:], -tl - B_vec[..., 6:]], axis=-1
    )
    cost_h = z(nv, nv).at[..., :n, :n].set(
        A_mat / jnp.linalg.norm(A_mat, axis=(-2, -1), keepdims=True) * 5.0
    )

    lv0 = LQPLevel(A=A0, a=a0, B=B0, b=b0, rank=6)

    # Level 1
    k = contact_const_mat.shape[-2]
    A1 = z(k + 2 * m, nv)
    A1 = A1.at[..., :k, n:].set(contact_const_mat)
    eye_m = jnp.eye(m, dtype=dtype)
    A1 = A1.at[..., k : k + m, 6:n].set(eye_m)
    A1 = A1.at[..., k + m :, 6:n].set(-eye_m)
    a1 = z(k + 2 * m)
    a1 = a1.at[..., k:].set(-acc_limit)
    B1 = z(c, nv).at[..., :, :n].set(J_C)
    b1 = z(c)
    lv1 = LQPLevel(A=A1, a=a1, B=B1, b=b1, rank=c, H=cost_h)

    levels = [lv0, lv1]
    for Jt, fs in zip(task_Js, task_fstars):
        t = Jt.shape[-2]
        Bt = z(t, nv).at[..., :, :n].set(Jt)
        levels.append(
            LQPLevel(A=None, a=None, B=Bt, b=-fs, rank=t, H=cost_h)
        )
    return levels


def lqp_torque_from_solution(y, A_mat, B_vec, J_C):
    """Recover actuated torque from [q̈; f_c]:
    τ = (A q̈ + B + J_Cᵀ f_c) actuated rows."""
    n = A_mat.shape[-1]
    qdd = y[..., :n]
    fc = y[..., n:]
    full = (
        jnp.einsum("...ij,...j->...i", A_mat, qdd)
        + B_vec
        + jnp.einsum("...ji,...j->...i", J_C, fc)
    )
    return full[..., 6:]
