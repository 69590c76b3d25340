"""Operational-space WBC kernels (stateless, batched, jit-friendly).

Batched re-derivation of the reference's free-function layer
(/root/reference/src/wbd.cpp): contact-consistent dynamics, gravity
compensation, the dynamically-consistent task-to-torque map (J_kt), task
null-space chaining, contact force observation, and the closed-form two-foot
contact redistribution.  All functions are pure, shape-static, and carry
leading batch dimensions transparently.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..kin.rotations import skew
from ..ops import smallmat as sm
from ..ops.linalg import pinv_psd, pinv_psd_fixed_rank

# Above this size the unrolled straight-line kernels stop paying for their
# compile time and lax.linalg wins (same threshold as ops/qp.py).
_UNROLL_LIMIT = 48


class ContactSpace(NamedTuple):
    """Outputs of the contact-space factorization.

    Mirrors ``CalculateContactConstraint`` (src/wbd.cpp:108-143):
    Λ_c, J̄_cᵀ, N_C, A⁻¹N_C, W, W⁻¹, V2, NwJw.
    """

    Lambda_c: jnp.ndarray   # (c,c)
    J_C_INV_T: jnp.ndarray  # (c,n)
    N_C: jnp.ndarray        # (n,n)
    A_inv_N_C: jnp.ndarray  # (n,n)
    W: jnp.ndarray          # (n-6,n-6)
    W_inv: jnp.ndarray      # (n-6,n-6)
    V2: jnp.ndarray         # (c-6,n-6) orthonormal null rows of W
    NwJw: jnp.ndarray       # (n-6,c-6) contact-force redistribution directions
    rank_health: jnp.ndarray  # () numeric rank indicator, ~[0,1]; tiny = degenerate


def _chol_health(M):
    """Relative smallest Cholesky pivot of a PSD Gram matrix: min(diag L) /
    max(diag L) ≈ sqrt(λ_min/λ_max).  Batched, NaN-free on singular input
    (the unrolled Cholesky clamps pivots at 1e-30)."""
    if M.shape[-1] <= _UNROLL_LIMIT:
        L = sm.chol(M)
    else:
        n = M.shape[-1]
        L = jnp.linalg.cholesky(M + 1e-30 * jnp.eye(n, dtype=M.dtype))
        L = jnp.nan_to_num(L)
    d = jnp.abs(jnp.diagonal(L, axis1=-2, axis2=-1))
    return jnp.min(d, axis=-1) / jnp.maximum(jnp.max(d, axis=-1), 1e-30)


def _psd_inv(M):
    """Inverse of a symmetric positive definite matrix via Cholesky.

    Small sizes use the unrolled smallmat kernels rather than XLA's
    LAPACK-shaped cholesky/triangular_solve on tiny batched matrices."""
    if M.shape[-1] <= _UNROLL_LIMIT:
        return sm.psd_inverse(M)
    L = jnp.linalg.cholesky(M)
    eye = jnp.broadcast_to(jnp.eye(M.shape[-1], dtype=M.dtype), M.shape)
    Linv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    return jnp.swapaxes(Linv, -1, -2) @ Linv


def _psd_inv_reg(M):
    """κ-bounded SPD inverse for the TASK-SPACE operators (Λ_t, QW⁻¹Qᵀ).

    The reference guards these with a COD pseudo-inverse thresholded at
    1e-6 (``CalculateJKT``, src/wbd.cpp:207-213; COD_THRESHOLD,
    include/dwbc_math.h:13) precisely because a task can approach
    singularity in contact-consistent dynamics — at f64 its plain Λ
    inverse reaches ~4e10 on near-singular poses and the downstream
    J_kt·Λ product cancels it back down.  f32 cannot survive that
    cancellation: ~0.3% of a 0.02-rad perturbed standing batch produced
    NaN or ±1e4 Nm garbage torques (task Gram eigenvalue 3e-11 vs 2.7
    measured on such a pose).  The closed-form f32 guard is a RELATIVE
    Tikhonov ridge of 1e-4·max|diag| — chosen BELOW the smallest
    structural eigenvalue ratio seen across the DoF sweep (~1e-3) so
    well-posed directions are biased ≤1e-4 relative (measured τ bias vs
    f64 on well-posed lanes: 8e-6 Nm), and far ABOVE the f32 Gram noise
    so near-singular directions stay bounded (measured: the garbage
    lanes return to τ≈36 Nm, pres 0).  f64 stays exact — the
    golden-parity bar (1e-8..1e-12) lives there."""
    if M.dtype == jnp.float32:
        dmax = jnp.max(jnp.abs(jnp.diagonal(M, axis1=-2, axis2=-1)), axis=-1)
        M = M + (1e-4 * dmax)[..., None, None] * jnp.eye(
            M.shape[-1], dtype=M.dtype
        )
    return _psd_inv(M)


def contact_space(J_C, A_inv) -> ContactSpace:
    """Contact-consistent dynamics factorization.

    J_C: (...,c,n) stacked contact jacobians (pos-first rows); A_inv (...,n,n).

    Factorization strategy: no rank-revealing decomposition at all.
    For PSD M with principal submatrix W, x ∈ ker(W) ⟺ [0;x] ∈ ker(M);
    with M = A⁻¹N_C whose kernel is range(J_Cᵀ), the null space of W is

        ker(W) = { J_C[:,6:]ᵀ y  :  J_C[:,:6]ᵀ y = 0 },

    so V2 comes from two *small* QR factorizations (c×6 and (n-6)×(c-6)), and
    the pseudo-inverse from one Cholesky:  W⁺ = (W + V2ᵀV2)⁻¹ − V2ᵀV2
    (exact because V2 is an orthonormal kernel basis).  This replaces the
    reference's COD (src/wbd.cpp:124) and is dramatically faster than
    iterative eigendecompositions.
    """
    c = J_C.shape[-2]
    n = J_C.shape[-1]
    dtype = J_C.dtype

    JAinv = J_C @ A_inv                                  # (...,c,n)
    Mc = JAinv @ jnp.swapaxes(J_C, -1, -2)
    Mc = 0.5 * (Mc + jnp.swapaxes(Mc, -1, -2))
    # Rank-health diagnostics (the batched replacement for the
    # reference's COD rank check + "Contact Space Factorization Error"
    # abort, src/wbd.cpp:126-136 / src/dwbc.cpp:3121-3131): a batched
    # numeric indicator instead of a host-side abort.  Two failure modes:
    # a singular contact Gram (dependent/duplicate contacts) and a
    # rank-deficient J_C[:, :6] base block (the closed-form kernel basis
    # below assumes rank 6).
    health = jnp.minimum(
        _chol_health(Mc),
        _chol_health(
            jnp.einsum("...ci,...cj->...ij", J_C[..., :, 0:6], J_C[..., :, 0:6])
        ),
    )
    Lambda_c = _psd_inv(Mc)
    J_C_INV_T = Lambda_c @ JAinv
    N_C = jnp.eye(n, dtype=dtype) - jnp.swapaxes(J_C, -1, -2) @ J_C_INV_T
    A_inv_N_C = A_inv @ N_C
    W = A_inv_N_C[..., 6:, 6:]
    W = 0.5 * (W + jnp.swapaxes(W, -1, -2))

    if c > 6:
        # y-basis: left null space of J_C[:, :6].  Unrolled MGS-based basis
        # completion instead of lax.linalg 'complete' QR (NwJw and W⁻¹ are
        # invariant under orthogonal changes of the kernel basis, so any
        # orthonormal basis gives bit-comparable downstream outputs).
        Ny = sm.complete_basis(J_C[..., :, 0:6])[..., :, 6:]      # (...,c,c-6)
        V2T_raw = jnp.swapaxes(J_C[..., :, 6:], -1, -2) @ Ny      # (...,n-6,c-6)
        V2T = sm.qr_thin(V2T_raw)                                 # orthonormal cols
        W_inv = _psd_inv(W + V2T @ jnp.swapaxes(V2T, -1, -2)) - V2T @ jnp.swapaxes(V2T, -1, -2)
        V2 = jnp.swapaxes(V2T, -1, -2)
        # NwJw = V2ᵀ (J̄_cᵀ[0:c-6, 6:] V2ᵀ)⁻¹   (src/wbd.cpp:128)
        # (normal-equations inverse: the (c-6)×(c-6) system is tiny and
        # well-conditioned; avoids a batched LAPACK getrf call)
        NwJw = V2T @ sm.qr_pinv(J_C_INV_T[..., 0 : c - 6, 6:] @ V2T)
    else:
        W_inv = _psd_inv(W)
        V2 = jnp.zeros(W.shape[:-2] + (0, n - 6), dtype=dtype)
        NwJw = jnp.zeros(W.shape[:-2] + (n - 6, 0), dtype=dtype)
    return ContactSpace(
        Lambda_c, J_C_INV_T, N_C, A_inv_N_C, W, W_inv, V2, NwJw, health
    )


def gravity_compensation(A_inv, W_inv, N_C, J_C_INV_T, G):
    """τ_grav = W⁻¹ · (A⁻¹ bottom-rows · N_C G);  P_C = J̄_cᵀ G.

    (``CalculateGravityCompensation``, src/wbd.cpp:186-192.)
    """
    m = W_inv.shape[-1]
    NCG = jnp.einsum("...ij,...j->...i", N_C, G)
    torque_grav = jnp.einsum(
        "...ij,...j->...i", W_inv, jnp.einsum("...ij,...j->...i", A_inv[..., -m:, :], NCG)
    )
    P_C = jnp.einsum("...ij,...j->...i", J_C_INV_T, G)
    return torque_grav, P_C


class TaskSpaceFactors(NamedTuple):
    Lambda_task: jnp.ndarray  # (t,t)
    J_kt: jnp.ndarray         # (n-6,t)
    Q: jnp.ndarray            # (t,n-6)


def task_jkt(J_task, A_inv, N_C, W_inv, exact_pinv: bool = False) -> TaskSpaceFactors:
    """Dynamically-consistent contact-consistent task-to-torque map.

    Λ_t = (J A⁻¹N_C Jᵀ)⁻¹; Q = (Λ_t J A⁻¹N_C) right-cols;
    J_ktᵀ = W⁻¹Qᵀ(QW⁻¹Qᵀ)⁺   (``CalculateJKT``, src/wbd.cpp:207-213).

    QW⁻¹Qᵀ is PD for any independent task under contact-consistent dynamics,
    so the reference's thresholded COD pinv reduces to a Cholesky inverse;
    pass exact_pinv=True to use the thresholded eigendecomposition instead
    (needed only for deliberately singular task stacks).
    """
    JAN = J_task @ A_inv @ N_C                        # (...,t,n)
    M = JAN @ jnp.swapaxes(J_task, -1, -2)
    Lambda_task = _psd_inv_reg(0.5 * (M + jnp.swapaxes(M, -1, -2)))
    Q = (Lambda_task @ JAN)[..., :, 6:]               # (...,t,n-6)
    QT = jnp.swapaxes(Q, -1, -2)
    QWQ = Q @ W_inv @ QT
    QWQ = 0.5 * (QWQ + jnp.swapaxes(QWQ, -1, -2))
    inv_mid = pinv_psd(QWQ) if exact_pinv else _psd_inv_reg(QWQ)
    J_kt = W_inv @ QT @ inv_mid
    return TaskSpaceFactors(Lambda_task, J_kt, Q)


def task_null_space(J_kt, Lambda_task, J_task, A_inv_N_C, prev_null):
    """Null_task = prev_null (I − J_kt Λ_t J_t A⁻¹N_C right-cols).

    (``CalculateTaskNullSpace``, src/wbd.cpp:257-261.)
    """
    m = J_task.shape[-1] - 6
    eye = jnp.eye(m, dtype=J_task.dtype)
    term = J_kt @ Lambda_task @ J_task @ A_inv_N_C[..., :, -m:]
    return prev_null @ (eye - term)


def contact_force_from_torque(command_torque, J_C_INV_T, P_C):
    """f_c = J̄_cᵀ actuated-cols · τ − P_C (``CalculateContactForce``,
    src/wbd.cpp:268-271)."""
    m = command_torque.shape[-1]
    return (
        jnp.einsum("...ij,...j->...i", J_C_INV_T[..., :, -m:], command_torque) - P_C
    )


# ---------------------------------------------------------------------------
# Contact constraint inequality blocks (src/wbd.cpp:59-97)
# ---------------------------------------------------------------------------

def zmp_const_matrix(lx, ly, dtype=jnp.float64):
    """4×6 CoP box constraint block for one 6D contact with half-sizes lx, ly.
    Rows: ±My within lx·fz, ±Mx within ly·fz (``GetZMPConstMatrix``)."""
    Z = jnp.zeros((4, 6), dtype=dtype)
    Z = Z.at[0, 2].set(-lx).at[0, 4].set(-1.0)
    Z = Z.at[1, 2].set(-lx).at[1, 4].set(1.0)
    Z = Z.at[2, 2].set(-ly).at[2, 3].set(-1.0)
    Z = Z.at[3, 2].set(-ly).at[3, 3].set(1.0)
    return Z


def force_const_matrix(mu, mu_z, dtype=jnp.float64):
    """6×6 friction-cone block: |fx|,|fy| ≤ µ fz, |Mz| ≤ µ_z fz
    (``GetForceConstMatrix``)."""
    F = jnp.zeros((6, 6), dtype=dtype)
    F = F.at[0, 0].set(1.0).at[0, 2].set(-mu)
    F = F.at[1, 0].set(-1.0).at[1, 2].set(-mu)
    F = F.at[2, 1].set(1.0).at[2, 2].set(-mu)
    F = F.at[3, 1].set(-1.0).at[3, 2].set(-mu)
    F = F.at[4, 5].set(1.0).at[4, 2].set(-mu_z)
    F = F.at[5, 5].set(-1.0).at[5, 2].set(-mu_z)
    return F


# ---------------------------------------------------------------------------
# Per-contact-type jacobian rows / constraint blocks / rotation blocks
# (include/dwbc_contact_constraint.h:19-25, src/contact_constraint.cpp:9-116)
#
# The reference declares three contact types but only CONTACT_6D is fully
# implemented there (CONTACT_LINE's Update is commented out,
# contact_constraint.cpp:63-69; CONTACT_POINT's QP assembly writes 6-wide
# blocks into 3-dof column ranges, dwbc.cpp:1030-1039).  We implement the
# *declared* semantics correctly:
#
# * CONTACT_POINT (3 dof): position jacobian rows only; force-cone
#   constraints only (|fx|,|fy| ≤ µ fz + two unilateral −µ_z fz ≤ · rows —
#   the reference's 6-row cone block with the nonexistent mz column removed).
# * CONTACT_LINE (5 dof, line along the local x axis with half-length lx):
#   position rows (world frame) + moment rows about the local y and z axes
#   (rotation rows pre-rotated into the contact frame; the local-x moment
#   cannot be resisted by a zero-width line and is dropped).  Constraints:
#   CoP along the line (±my ≤ lx·fz) + the 6 cone rows.
# ---------------------------------------------------------------------------

from . import types as _T


def contact_jacobian_rows(J6, R, contact_type):
    """Per-type contact jacobian rows from the 6-row pos-first point
    jacobian J6 (…,6,n) and the contact body rotation R (…,3,3)."""
    if contact_type == _T.CONTACT_6D:
        return J6
    if contact_type == _T.CONTACT_POINT:
        return J6[..., 0:3, :]
    if contact_type == _T.CONTACT_LINE:
        Jrot_local = jnp.swapaxes(R, -1, -2) @ J6[..., 3:6, :]
        return jnp.concatenate([J6[..., 0:3, :], Jrot_local[..., 1:3, :]], axis=-2)
    raise ValueError(f"unknown contact type {contact_type}")


def contact_constraint_block(contact_type, lx, ly, mu, mu_z, dtype=jnp.float64):
    """(k, d) inequality block acting on the contact-local wrench:
    6D → (10,6); POINT → (6,3); LINE → (8,5) over [fx fy fz my mz]."""
    Z = zmp_const_matrix(lx, ly, dtype=dtype)
    F = force_const_matrix(mu, mu_z, dtype=dtype)
    if contact_type == _T.CONTACT_6D:
        return jnp.concatenate([Z, F], axis=0)
    if contact_type == _T.CONTACT_POINT:
        return F[:, 0:3]
    if contact_type == _T.CONTACT_LINE:
        cols = jnp.array([0, 1, 2, 4, 5])
        return jnp.concatenate([Z[0:2][:, cols], F[:, cols]], axis=0)
    raise ValueError(f"unknown contact type {contact_type}")


def contact_rotation_block(contact_type, R):
    """(…, d, d) world→contact-local rotation for the per-type wrench:
    6D → Rᵀ⊕Rᵀ; POINT → Rᵀ; LINE → Rᵀ⊕I₂ (line moment rows are already
    expressed in the contact frame by contact_jacobian_rows)."""
    RT = jnp.swapaxes(R, -1, -2)
    batch = R.shape[:-2]
    dtype = R.dtype
    if contact_type == _T.CONTACT_6D:
        out = jnp.zeros(batch + (6, 6), dtype=dtype)
        out = out.at[..., 0:3, 0:3].set(RT)
        out = out.at[..., 3:6, 3:6].set(RT)
        return out
    if contact_type == _T.CONTACT_POINT:
        return RT
    if contact_type == _T.CONTACT_LINE:
        out = jnp.zeros(batch + (5, 5), dtype=dtype)
        out = out.at[..., 0:3, 0:3].set(RT)
        out = out.at[..., 3, 3].set(1.0)
        out = out.at[..., 4, 4].set(1.0)
        return out
    raise ValueError(f"unknown contact type {contact_type}")


# ---------------------------------------------------------------------------
# Closed-form two-contact force redistribution (src/wbd.cpp:273-404)
# ---------------------------------------------------------------------------

def _eta_interval_update(A, B, C, eta_lb, eta_ub):
    """Intersect the eta interval with the roots of (A²−C²)η² + 2ABη + B² ≤ 0."""
    a = A * A
    b = 2.0 * A * B
    c = B * B - C * C
    disc = jnp.sqrt(jnp.maximum(b * b - 4.0 * a * c, 0.0))
    safe_a = jnp.where(jnp.abs(a) > 1e-30, a, 1.0)
    sol1 = (-b + disc) / (2.0 * safe_a)
    sol2 = (-b - disc) / (2.0 * safe_a)
    hi = jnp.maximum(sol1, sol2)
    lo = jnp.minimum(sol1, sol2)
    valid = jnp.abs(a) > 1e-30
    eta_ub = jnp.where(valid, jnp.minimum(eta_ub, hi), eta_ub)
    eta_lb = jnp.where(valid, jnp.maximum(eta_lb, lo), eta_lb)
    return eta_lb, eta_ub


def contact_redistribute_two(
    eta_cust, footlength, footwidth, mu_static, ratio_x, ratio_y, P1, P2, F12
):
    """Closed-form two-foot redistribution (``ContactRedistributetwomod``).

    F12: (...,12) stacked [f1(3) m1(3) f2(3) m2(3)] in a yaw-aligned frame;
    P1, P2: (...,3) foot positions relative to COM (same frame).
    Returns (resultant_force(6), redistributed F12(12), eta).
    """
    # Resultant wrench at COM: W = [I I; skew(P1) skew(P2)] (on 6D halves)
    f1, m1 = F12[..., 0:3], F12[..., 3:6]
    f2, m2 = F12[..., 6:9], F12[..., 9:12]
    Fr = f1 + f2
    Mr = m1 + m2 + jnp.cross(P1, f1, axis=-1) + jnp.cross(P2, f2, axis=-1)
    R = jnp.concatenate([Fr, Mr], axis=-1)

    eta_lb = 1.0 - eta_cust
    eta_ub = eta_cust * jnp.ones_like(R[..., 0])
    eta_lb = eta_lb * jnp.ones_like(R[..., 0])

    dP = P1 - P2
    # Mx bound
    A = dP[..., 2] * R[..., 1] - dP[..., 1] * R[..., 2]
    B = R[..., 3] + P2[..., 2] * R[..., 1] - P2[..., 1] * R[..., 2]
    C = ratio_y * footwidth / 2.0 * jnp.abs(R[..., 2])
    eta_lb, eta_ub = _eta_interval_update(A, B, C, eta_lb, eta_ub)
    # My bound
    A2 = -dP[..., 2] * R[..., 0] + dP[..., 0] * R[..., 2]
    B2 = R[..., 4] - P2[..., 2] * R[..., 0] + P2[..., 0] * R[..., 2]
    C2 = ratio_x * footlength / 2.0 * jnp.abs(R[..., 2])
    eta_lb, eta_ub = _eta_interval_update(A2, B2, C2, eta_lb, eta_ub)
    # Mz bound
    A3 = -dP[..., 0] * R[..., 1] + dP[..., 1] * R[..., 0]
    B3 = R[..., 5] + P2[..., 1] * R[..., 0] - P2[..., 0] * R[..., 1]
    C3 = mu_static * jnp.abs(R[..., 2])
    eta_lb, eta_ub = _eta_interval_update(A3, B3, C3, eta_lb, eta_ub)

    eta_s = (-R[..., 3] - P2[..., 2] * R[..., 1] + P2[..., 1] * R[..., 2]) / A
    eta = jnp.clip(eta_s, eta_lb, eta_ub)
    eta = jnp.where((eta > eta_cust) | (eta < 1.0 - eta_cust), 0.5, eta)

    e = eta[..., None]
    M1_lin = (A * eta * eta + B * eta)
    M2_lin = (A2 * eta * eta + B2 * eta)
    M3_lin = (A3 * eta * eta + B3 * eta)
    out1 = jnp.concatenate(
        [e * R[..., 0:3], jnp.stack([M1_lin, M2_lin, M3_lin], axis=-1)], axis=-1
    )
    one_m = (1.0 - eta)[..., None]
    M1_b = (A * eta + B)
    M2_b = (A2 * eta + B2)
    M3_b = (A3 * eta + B3)
    out2 = jnp.concatenate(
        [one_m * R[..., 0:3],
         one_m * jnp.stack([M1_b, M2_b, M3_b], axis=-1)], axis=-1
    )
    return R, jnp.concatenate([out1, out2], axis=-1), eta


def yaw_rotation(yaw):
    """Rz(yaw) (rotateWithZ, src/math.cpp:55-72)."""
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, -s, zero], axis=-1),
            jnp.stack([s, c, zero], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )
