"""Batched fixed-iteration QP solver: the qpOASES replacement.

The reference solves every per-tick QP with qpOASES' dense active-set method
(`CQuadraticProgram::SolveQPoases`, /root/reference/src/qp_wrapper.cpp:192-380)
— variable iteration counts, hot-starts, host-side branching.  None of that
maps onto XLA.  Here the same problems are solved by a **predictor–corrector
primal–dual interior-point method with a static iteration count**, followed by
an **active-set polish** step that recovers the exact vertex solution
active-set methods produce.  Everything is dense, shape-static, batched, and
differentiable.

Factorizations of these tiny systems (n ≤ 48) use the unrolled
straight-line kernels in ``ops.smallmat`` (batch dim trailing, one fused
elementwise program) rather than XLA's LAPACK-shaped batched
`cholesky`/`solve`.  The polish KKT system is reduced
analytically to an n×n PSD solve via the exact penalty identity
``((1-D) + ρI)⁻¹D = D/ρ`` instead of forming the (n+m)×(n+m) saddle system.

Problem form (qpOASES convention, two-sided linear constraints):

    min ½ xᵀHx + gᵀx   s.t.  lb ≤ A x ≤ ub,  (optional) Aeq x = beq

Infinite bounds are handled by row masking.  H may be positive
*semi*-definite (the task QPs have H = diag(I, 0), src/dwbc.cpp:990-991); a
configurable Tikhonov term reproduces qpOASES' regularisation limit.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import smallmat as sm

_BIG = 1.0e20
# Unrolled small-matrix kernels below this size (no LAPACK-call latency);
# above it their straight-line code explodes compile time and lax.linalg
# takes over.
_UNROLL_LIMIT = 48


def _chol(K, unrolled: bool):
    return sm.chol(K) if unrolled else jnp.linalg.cholesky(K)


def _cho_solve(L, b, unrolled: bool):
    if unrolled:
        return sm.cho_solve(L, b)
    vec = b.ndim == L.ndim - 1
    rhs = b[..., None] if vec else b
    out = jax.scipy.linalg.cho_solve((L, True), rhs)
    return out[..., 0] if vec else out


def _psd_solve(K, b, unrolled: bool):
    return _cho_solve(_chol(K, unrolled), b, unrolled)


class QPSolution(NamedTuple):
    x: jnp.ndarray        # (n,) primal solution
    lam: jnp.ndarray      # (2m,) multipliers for [upper; lower] rows
    gap: jnp.ndarray      # () final cap-aware complementarity gap (see below)
    primal_res: jnp.ndarray  # () final max primal violation
    polished: jnp.ndarray    # () bool: polish step accepted


def _comp_gap(slack, lam, m, axis=-1):
    """Normalized complementarity: Σ|slack_i|·λ_i/(1+λ_i) / m.

    The raw gap |Σ slack·λ|/m is useless as a failure observable on a
    divergent dual: an ε-infeasible row (0·x ≤ −ε from masked lanes, or τ
    at a torque limit + roundoff) legitimately drives λ toward the w_cap
    safeguard, and ε·1e8 read as a huge "gap" on a perfectly healthy lane
    (r04: 6.4e6 on limit-riding masked lanes — which silently broke the
    loop-level gap_fallback safety net).  The per-row normalization
    λ/(1+λ) saturates at 1, so a divergent-dual row contributes ≈|slack|
    = its actual violation (ε — tiny, and reported by primal_res anyway),
    while healthy rows (λ ≲ 1) keep their familiar slack·λ scale and a
    genuinely unconverged/infeasible solve still reads large.  Per-row
    absolute values prevent sign cancellation across rows.  This is the
    failure-detection analog of qpOASES' status return
    (src/qp_wrapper.cpp:298-363): healthy ⇒ ~0, failure ⇒ large, with no
    saturation regime in between."""
    lam = jnp.maximum(lam, 0.0)
    return jnp.sum(jnp.abs(slack) * (lam / (1.0 + lam)), axis=axis) / m


def _one_sided(A, lb, ub):
    """Convert lb ≤ Ax ≤ ub into Cx ≤ d with masked infinite rows.

    Rows with |bound| ≥ _BIG are replaced by 0·x ≤ 1 (always satisfiable,
    multipliers vanish at the central path limit).
    """
    ub_f = jnp.isfinite(ub) & (jnp.abs(ub) < _BIG)
    lb_f = jnp.isfinite(lb) & (jnp.abs(lb) < _BIG)
    C = jnp.concatenate([A * ub_f[..., :, None], -A * lb_f[..., :, None]], axis=-2)
    d = jnp.concatenate(
        [jnp.where(ub_f, ub, 1.0), jnp.where(lb_f, -lb, 1.0)], axis=-1
    )
    return C, d


@partial(jax.jit, static_argnames=("iters", "ridge"))
def solve_qp(
    H, g, A, lb, ub, Aeq=None, beq=None, iters: int = 30, ridge: float = 1.0e-9,
    warm=None,
) -> QPSolution:
    """Solve one (or a batch of) dense QPs.  All args broadcast on leading dims.

    Optional explicit equality constraints Aeq x = beq are handled inside the
    KKT system (an interior-point method cannot treat lb==ub rows — the
    feasible set has no interior).

    iters: static IPM iteration count (30 reaches ~1e-9 on well-scaled
    problems; polish then drives exact-vertex accuracy).
    """
    n = H.shape[-1]
    dtype = H.dtype
    f32 = dtype == jnp.float32
    ridge = max(ridge, 1e-6) if f32 else ridge
    if lb is None:
        # fast path: one-sided constraints Ax ≤ ub (all lower bounds -inf);
        # halves the constraint stack vs the generic two-sided conversion
        ub_f = jnp.isfinite(ub) & (jnp.abs(ub) < _BIG)
        C = A * ub_f[..., :, None]
        d = jnp.where(ub_f, ub, 1.0)
    else:
        C, d = _one_sided(A, lb, ub)
    m = C.shape[-2]
    p = Aeq.shape[-2] if Aeq is not None else 0

    Hr = H + ridge * jnp.eye(n, dtype=dtype)
    unrolled = n <= _UNROLL_LIMIT

    s_floor = 1e-10 if f32 else 1e-14
    w_cap = 1e8 if f32 else 1e12
    mu_tol = 5e-8 if f32 else 1e-13

    if warm is not None:
        # hot-start from a previous tick's primal/dual point (the analog of
        # qpOASES' persistent active set, include/dwbc.h:222-228): pull the
        # slacks/multipliers back to the interior so the IPM can move.
        x_w, lam_w = warm
        x0 = x_w * jnp.ones(
            jnp.broadcast_shapes(H.shape[:-2], A.shape[:-2]) + (n,), dtype=dtype
        )
        s_floor_w = 1e-4 if f32 else 1e-6
        s0 = jnp.maximum(d - jnp.einsum("...ij,...j->...i", C, x0), s_floor_w)
        # clip ABOVE too: a prior ε-infeasible solve legitimately diverges
        # its dual (0·x ≤ −ε rows from masked lanes + roundoff at an
        # active limit) — it must not poison this restart (cap shared with
        # the in-iteration dual safeguard; the two must never drift apart)
        lam0 = jnp.clip(lam_w, s_floor_w, w_cap)
        nu0 = jnp.zeros(x0.shape[:-1] + (p,), dtype=dtype)
    else:
        x0 = jnp.zeros(
            jnp.broadcast_shapes(H.shape[:-2], A.shape[:-2]) + (n,), dtype=dtype
        )
        s0 = jnp.maximum(d - jnp.einsum("...ij,...j->...i", C, x0), 1.0)
        lam0 = jnp.ones_like(s0)
        nu0 = jnp.zeros(x0.shape[:-1] + (p,), dtype=dtype)

    def factor_step(x, s, lam, nu):
        """Everything the predictor and corrector share at a given iterate:
        residuals, scaling w, the reduced-KKT Cholesky (and, with
        equalities, the Schur complement factor).  Factor once per
        iteration; the two Newton solves below are back-substitutions."""
        s_safe = jnp.maximum(s, s_floor)
        r_d = jnp.einsum("...ij,...j->...i", Hr, x) + g + jnp.einsum(
            "...ji,...j->...i", C, lam
        )
        if Aeq is not None:
            r_d = r_d + jnp.einsum("...ji,...j->...i", Aeq, nu)
        r_p = jnp.einsum("...ij,...j->...i", C, x) + s - d
        w = jnp.clip(lam / s_safe, 0.0, w_cap)
        # reduced system: (H + Cᵀ diag(w) C) dx + Aeqᵀ dnu = -r_d - Cᵀ(w r_p - r_c/s)
        K = Hr + jnp.einsum("...ji,...j,...jk->...ik", C, w, C)
        L = _chol(K, unrolled)
        if Aeq is not None:
            r_e = jnp.einsum("...ij,...j->...i", Aeq, x) - beq
            Kinv_At = _cho_solve(L, jnp.swapaxes(Aeq, -1, -2), unrolled)
            S = Aeq @ Kinv_At + ridge * jnp.eye(p, dtype=dtype)
            L_S = _chol(0.5 * (S + jnp.swapaxes(S, -1, -2)), unrolled)
        else:
            r_e = Kinv_At = L_S = None
        return s_safe, r_d, r_p, w, L, r_e, Kinv_At, L_S

    def newton_step(fac, s, lam, nu, sigma_mu):
        """Back-solve the perturbed KKT system for (dx, ds, dlam[, dnu])."""
        s_safe, r_d, r_p, w, L, r_e, Kinv_At, L_S = fac
        r_c = s * lam - sigma_mu
        rhs = -r_d - jnp.einsum(
            "...ji,...j->...i", C, w * r_p - r_c / s_safe
        )
        if Aeq is not None:
            Kinv_rhs = _cho_solve(L, rhs, unrolled)
            dnu = _cho_solve(
                L_S,
                jnp.einsum("...ij,...j->...i", Aeq, Kinv_rhs) + r_e,
                unrolled,
            )
            dx = Kinv_rhs - jnp.einsum("...ij,...j->...i", Kinv_At, dnu)
        else:
            dx = _cho_solve(L, rhs, unrolled)
            dnu = nu
        ds = -(r_p + jnp.einsum("...ij,...j->...i", C, dx))
        dlam = -(r_c + lam * ds) / s_safe
        return dx, ds, dlam, dnu

    def alpha_max(v, dv, tau=0.995):
        ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), _BIG)
        return jnp.minimum(1.0, tau * jnp.min(ratio, axis=-1))

    def body(carry, _):
        x, s, lam, nu = carry
        mu = jnp.sum(s * lam, axis=-1) / m
        # Freeze converged lanes: once mu is tiny the scaled Newton system is
        # too ill-conditioned to help — take a zero step (static shape, no
        # data-dependent control flow).  A warm restart never arrives frozen:
        # the warm-init floors keep mu₀ ≳ s_floor_w·d-scale ≫ mu_tol, so a
        # state change always gets live iterations (verified: residual-based
        # un-freeze gates were tried and DEGRADE converged lanes — stepping
        # the ill-conditioned KKT at mu≈1e-14 loses ~5e-6 objective vs
        # qpOASES on the stored golden QPs).
        live = (mu > mu_tol).astype(dtype)
        fac = factor_step(x, s, lam, nu)
        # predictor (affine) step
        dx_a, ds_a, dlam_a, dnu_a = newton_step(fac, s, lam, nu, jnp.zeros_like(s))
        a_p = alpha_max(s, ds_a)
        a_d = alpha_max(lam, dlam_a)
        mu_aff = jnp.sum(
            (s + a_p[..., None] * ds_a) * (lam + a_d[..., None] * dlam_a), axis=-1
        ) / m
        sigma = (mu_aff / jnp.maximum(mu, 1e-300)) ** 3
        # corrector step with Mehrotra centering + second-order term.
        target = (sigma * mu)[..., None] - ds_a * dlam_a
        dx, ds, dlam, dnu = newton_step(fac, s, lam, nu, target)
        # Non-finite guard, stricter than the fused tick's: a lane whose
        # f32 KKT factorization broke (κ(K) beyond f32 at w≈w_cap) must
        # SKIP its step — and so must a lane whose huge-but-finite step
        # would overflow the NEXT iterate.  nan_to_num-and-step-anyway was
        # measured to walk ~0.5% of a 0.02-rad perturbed f32 batch to
        # ±3e38 garbage torques; the guard keeps the last good iterate
        # with honest gap/pres instead.  (The bound 1e15·(1+|x|) is far
        # above any legal IPM step at these scales and far below f32
        # overflow amplified by one Gram product.)
        step_mag = jnp.max(jnp.abs(jnp.nan_to_num(dx, nan=jnp.inf)), axis=-1)
        x_mag = jnp.max(jnp.abs(x), axis=-1)
        ok = (
            (step_mag < 1.0e15 * (1.0 + x_mag))
            & (jnp.sum(ds * 0.0, axis=-1) == 0.0)
            & (jnp.sum(dlam * 0.0, axis=-1) == 0.0)
            & (jnp.sum(dnu * 0.0, axis=-1) == 0.0)
        )
        dx = jnp.where(ok[..., None], jnp.nan_to_num(dx), 0.0)
        ds = jnp.where(ok[..., None], jnp.nan_to_num(ds), 0.0)
        dlam = jnp.where(ok[..., None], jnp.nan_to_num(dlam), 0.0)
        dnu = jnp.where(ok[..., None], jnp.nan_to_num(dnu), 0.0)
        live = live * ok.astype(dtype)
        if warm is not None:
            # Separate primal/dual step lengths (standard Mehrotra) on WARM
            # solves only: a warm start made infeasible by a state change
            # must not have its primal feasibility restoration throttled by
            # the dual boundary (measured: restores 0.34 primal violation in
            # ≤7 iterations vs >12 with the joint step).  Cold solves keep
            # the joint step so their trajectory — and their endpoint on a
            # flat optimal face — remains exactly the golden-validated one.
            a_p = (live * alpha_max(s, ds))[..., None]
            a_d = (live * alpha_max(lam, dlam))[..., None]
        else:
            a_p = (live * jnp.minimum(alpha_max(s, ds), alpha_max(lam, dlam)))[
                ..., None
            ]
            a_d = a_p
        # λ capped at w_cap: dual safeguard — on an infeasible row the dual
        # correctly diverges; keep it finite so gap/warm-carry stay usable
        # (primal_res still reports the violation)
        return (
            x + a_p * dx, s + a_p * ds,
            jnp.minimum(lam + a_d * dlam, w_cap), nu + a_d * dnu
        ), None

    (x, s, lam, nu), _ = jax.lax.scan(body, (x0, s0, lam0, nu0), None, length=iters)

    # ------------------------------------------------------------- polish
    # Active set from the converged central path: λ dominates s on active
    # rows.  The saddle KKT with inactive multipliers pinned to zero reduces
    # exactly (via ((1-D)+ρI)⁻¹D = D/ρ) to the n×n penalty system
    #   (H + CᵀDC/ρ [+ AeqᵀAeq/ρ]) x = -g + CᵀD d/ρ [+ Aeqᵀ beq/ρ]
    act = (lam > s).astype(dtype)
    pen = 1.0e4 if f32 else 1.0 / ridge
    K_p = Hr + pen * jnp.einsum("...ji,...j,...jk->...ik", C, act, C)
    rhs_p = -g + pen * jnp.einsum("...ji,...j->...i", C, act * d)
    if Aeq is not None:
        K_p = K_p + pen * jnp.einsum("...ji,...jk->...ik", Aeq, Aeq)
        rhs_p = rhs_p + pen * jnp.einsum("...ji,...j->...i", Aeq, beq)
    rhs_p = rhs_p * jnp.ones_like(x)
    x_p = _psd_solve(0.5 * (K_p + jnp.swapaxes(K_p, -1, -2)), rhs_p, unrolled)
    lam_p = pen * act * (
        jnp.einsum("...ij,...j->...i", C, x_p) - d
    )

    def metrics(xv, lv):
        slack = d - jnp.einsum("...ij,...j->...i", C, xv)
        pres = jnp.max(jnp.maximum(-slack, 0.0), axis=-1)
        if Aeq is not None:
            eq_res = jnp.max(
                jnp.abs(jnp.einsum("...ij,...j->...i", Aeq, xv) - beq), axis=-1
            )
            pres = jnp.maximum(pres, eq_res)
        gap = _comp_gap(slack, lv, m)
        return pres, gap

    pres_i, gap_i = metrics(x, lam)
    pres_p, gap_p = metrics(x_p, jnp.maximum(lam_p, 0.0))

    def objective(xv):
        return 0.5 * jnp.sum(
            xv * jnp.einsum("...ij,...j->...i", Hr, xv), axis=-1
        ) + jnp.sum(g * xv, axis=-1)

    obj_i = objective(x)
    obj_p = objective(x_p)
    ok = (
        jnp.isfinite(x_p).all(axis=-1)
        & (pres_p + gap_p <= pres_i + gap_i + 1e-9)
        & (lam_p.min(axis=-1) >= -1e-7)
        # a feasible vertex with sign-correct multipliers can still be the
        # WRONG vertex (one weakly-active row mis-classified): its pres and
        # complementarity gap are both ≈0, so only the objective can reject
        # it.  Accept polish only when it does not lose objective.
        & (obj_p <= obj_i + 1e-9 * (1.0 + jnp.abs(obj_i)))
    )
    if f32:
        # the penalty-polish multipliers are too noisy at f32 to trust the
        # acceptance test; the IPM solution alone is already at ~1e-8 gap
        ok = jnp.zeros_like(ok)
    x_fin = jnp.where(ok[..., None], x_p, x)
    lam_fin = jnp.where(ok[..., None], jnp.maximum(lam_p, 0.0), lam)
    pres = jnp.where(ok, pres_p, pres_i)
    gap = jnp.where(ok, gap_p, gap_i)
    return QPSolution(x=x_fin, lam=lam_fin, gap=gap, primal_res=pres, polished=ok)
