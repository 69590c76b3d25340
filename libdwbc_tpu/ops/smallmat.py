"""Batched small-matrix factorizations as pure jnp programs.

XLA's LAPACK-shaped linalg (lax.linalg.cholesky / qr / triangular_solve) is
latency-heavy for tiny matrices and vectorizes poorly across large
batches.  Every matrix in the WBC pipeline is small (≤ 86×90) with a static
size, so we unroll the factorizations into straight-line elementwise/outer-
product code: every operation broadcasts over the batch, turning the batch
dimension into pure data parallelism (and leaving XLA free to fuse the
whole factorization into a handful of kernels).

All functions take (..., n, n) / (..., n, m) arrays and are differentiable.
"""

from __future__ import annotations

import jax.numpy as jnp


def chol(A):
    """Cholesky factor L (lower) of a PSD matrix, unrolled over columns.

    Uses the outer-product (right-looking) form: n steps, each a masked
    column scale + rank-1 update — ideal for batched elementwise execution.
    """
    n = A.shape[-1]
    S = A
    cols = []
    for j in range(n):
        # right-looking on the shrinking trailing submatrix: total work
        # n³/3 FMAs instead of n³ for a full-matrix rank-1 update
        d = jnp.sqrt(jnp.maximum(S[..., 0, 0], 1e-30))
        col = S[..., :, 0] / d[..., None]            # (..., n-j), col[0] = d
        S = S[..., 1:, 1:] - col[..., 1:, None] * col[..., None, 1:]
        cols.append(jnp.pad(col, [(0, 0)] * (col.ndim - 1) + [(j, 0)]))
    return jnp.stack(cols, axis=-1)


def solve_lower(L, B):
    """Solve L X = B (L lower-triangular), unrolled forward substitution.
    B: (..., n, m) or (..., n)."""
    vec = B.ndim == L.ndim - 1
    if vec:
        B = B[..., None]
    n = L.shape[-1]
    xs = []
    for i in range(n):
        acc = B[..., i, :]
        for k in range(i):
            acc = acc - L[..., i, k, None] * xs[k]
        xs.append(acc / L[..., i, i, None])
    X = jnp.stack(xs, axis=-2)
    return X[..., 0] if vec else X


def solve_upper(U, B):
    """Solve U X = B (U upper-triangular), unrolled back substitution."""
    vec = B.ndim == U.ndim - 1
    if vec:
        B = B[..., None]
    n = U.shape[-1]
    xs = [None] * n
    for i in reversed(range(n)):
        acc = B[..., i, :]
        for k in range(i + 1, n):
            acc = acc - U[..., i, k, None] * xs[k]
        xs[i] = acc / U[..., i, i, None]
    X = jnp.stack(xs, axis=-2)
    return X[..., 0] if vec else X


def psd_solve(A, B):
    """Solve A X = B for symmetric positive definite A."""
    L = chol(A)
    return solve_upper(jnp.swapaxes(L, -1, -2), solve_lower(L, B))


def psd_inverse(A):
    """Inverse of a symmetric PD matrix: A⁻¹ = L⁻ᵀ L⁻¹."""
    L = chol(A)
    n = A.shape[-1]
    eye = jnp.eye(n, dtype=A.dtype)
    Linv = solve_lower(L, jnp.broadcast_to(eye, A.shape))
    return jnp.swapaxes(Linv, -1, -2) @ Linv


def cho_solve(L, B):
    """Solve A X = B given the Cholesky factor L of A."""
    return solve_upper(jnp.swapaxes(L, -1, -2), solve_lower(L, B))


def qr_thin(A, drop_tol=None):
    """Thin QR of a tall matrix (..., m, k), k static & small, via modified
    Gram-Schmidt (unrolled).  Returns Q (..., m, k) with orthonormal columns.

    With drop_tol set, a column whose residual shrinks below
    drop_tol·‖original column‖ is ZEROED instead of normalized — otherwise
    the normalized rounding residue is pure noise that would contaminate
    every later column during orthogonalization (non-deterministically
    across compilations)."""
    k = A.shape[-1]
    cols = []
    for j in range(k):
        v = A[..., :, j]
        nrm0 = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
        for q in cols:
            v = v - jnp.sum(q * v, axis=-1, keepdims=True) * q
        # second MGS pass for orthogonality at f32
        for q in cols:
            v = v - jnp.sum(q * v, axis=-1, keepdims=True) * q
        nrm = jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), 1e-30))
        if drop_tol is None:
            cols.append(v / nrm)
        else:
            keep = nrm > drop_tol * jnp.maximum(nrm0, 1e-30)
            cols.append(jnp.where(keep, v / nrm, 0.0))
    return jnp.stack(cols, axis=-1)


def complete_basis(A):
    """Full orthonormal basis (..., m, m) whose first k columns span col(A)
    (A: (..., m, k)).  Remaining columns span the orthogonal complement —
    replaces 'complete' QR for null-space extraction.

    Deterministic completion: project out col(A) from the identity columns
    and orthonormalize, keeping the m-k most independent directions via
    Gram-Schmidt with column pivoting emulated by magnitude masking.
    """
    m, k = A.shape[-2], A.shape[-1]
    Q = qr_thin(A)
    cols = [Q[..., :, j] for j in range(k)]
    eye = jnp.eye(m, dtype=A.dtype)
    # Greedy: orthogonalize each identity column; accept in order of residual
    # norm.  For static shapes we orthogonalize all m candidates and pick the
    # m-k with the largest residuals using a fixed selection network.
    residuals = []
    for j in range(m):
        v = jnp.broadcast_to(eye[:, j], A.shape[:-2] + (m,))
        for q in cols:
            v = v - jnp.sum(q * v, axis=-1, keepdims=True) * q
        residuals.append(v)
    # choose greedily m-k times: pick argmax norm, normalize, deflate others
    chosen = []
    R = jnp.stack(residuals, axis=-1)  # (..., m, m) candidate residuals
    for _ in range(m - k):
        nrm = jnp.sum(R * R, axis=-2)                      # (..., m)
        jbest = jnp.argmax(nrm, axis=-1)
        v = jnp.take_along_axis(R, jbest[..., None, None], axis=-1)[..., 0]
        v = v / jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), 1e-30))
        chosen.append(v)
        R = R - v[..., :, None] * jnp.sum(v[..., :, None] * R, axis=-2)[..., None, :]
    return jnp.concatenate(
        [jnp.stack(cols, axis=-1), jnp.stack(chosen, axis=-1)], axis=-1
    )


def qr_inv(M):
    """Inverse of a small square matrix via MGS QR: M⁻¹ = R⁻¹Qᵀ.

    Same unrolled straight-line structure as the rest of this module but —
    unlike ``inv_via_normal`` — does NOT square the condition number
    (qr_thin runs a second MGS pass, so Q is orthonormal to working
    precision even for moderately ill-conditioned inputs)."""
    Q = qr_thin(M)
    QT = jnp.swapaxes(Q, -1, -2)
    R = QT @ M
    return solve_upper(R, QT)


def qr_pinv(M, rcond=1e-6):
    """Thresholded pseudo-inverse of a small square matrix via MGS QR —
    the unrolled analog of the reference's rank-revealing COD
    pinv with COD_THRESHOLD = 1e-6 (include/dwbc_math.h:13,
    src/math.cpp:23-53).  Directions whose R pivot falls below
    rcond·max|R_ii| are zeroed instead of inverted (rank truncation), so a
    rank-deficient input (e.g. the NwJw inner system of an over-constrained
    contact set) yields the minimum-norm solve, not garbage."""
    n = M.shape[-1]
    Q = qr_thin(M, drop_tol=1e-7)
    QT = jnp.swapaxes(Q, -1, -2)
    R = QT @ M
    d = jnp.abs(jnp.diagonal(R, axis1=-2, axis2=-1))
    live = (d > rcond * jnp.max(d, axis=-1, keepdims=True))[..., :, None]
    eye = jnp.eye(n, dtype=M.dtype)
    R = jnp.where(live, R, eye)      # dead row j ← e_j (pivot 1, solves to 0)
    B = jnp.where(live, QT, 0.0)     # dead directions output 0
    return solve_upper(R, B)


def inv_via_normal(M):
    """Inverse of a small square matrix via the normal equations:
    M⁻¹ = (MᵀM)⁻¹Mᵀ.  Squares the condition number — fine for the
    well-conditioned ≤12×12 inverses in the pipeline (use f64 or the exact
    path when conditioning is a concern)."""
    MT = jnp.swapaxes(M, -1, -2)
    G = MT @ M
    G = G + 1e-12 * jnp.trace(G, axis1=-2, axis2=-1)[..., None, None] * jnp.eye(
        M.shape[-1], dtype=M.dtype
    )
    return psd_solve(G, MT)
