"""Element-leading linear algebra: the math core of the fused tick.

Layout convention ("batch in lanes"): every value has its *element indices
leading* and the batch dimensions trailing —

    matrix: (m, n, *bt)     vector: (n, *bt)     scalar: (*bt)

bt is anything ((), (B,), ...), so the same functions trace at any batch
— that is how the fused tick is parity-tested on CPU f64 against the
reference-validated pipeline.  Only elementwise arithmetic, leading-axis
reductions, static slices and stacks/concatenations on leading axes are
used: no einsums, no gather, no lax.linalg.

Algorithms mirror ops/smallmat.py (the golden-validated unrolled kernels)
transposed into this layout; numerics are identical up to summation order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# ------------------------------------------------------------- products
def mm(A, B):
    """(m,k)+bt @ (k,n)+bt -> (m,n)+bt.  Loop over the contraction dim
    (small everywhere in the tick); each term is one full-width op."""
    k = A.shape[1]
    acc = A[:, 0][:, None] * B[0][None]
    for i in range(1, k):
        acc = acc + A[:, i][:, None] * B[i][None]
    return acc


def mmT(A, B):
    """A @ Bᵀ: (m,k)+bt, (n,k)+bt -> (m,n)+bt."""
    k = A.shape[1]
    acc = A[:, 0][:, None] * B[:, 0][None]
    for i in range(1, k):
        acc = acc + A[:, i][:, None] * B[:, i][None]
    return acc


def mTm(A, B):
    """Aᵀ @ B: (k,m)+bt, (k,n)+bt -> (m,n)+bt."""
    k = A.shape[0]
    acc = A[0][:, None] * B[0][None]
    for i in range(1, k):
        acc = acc + A[i][:, None] * B[i][None]
    return acc


def mv(A, x):
    """(m,n)+bt @ (n,)+bt -> (m,)+bt — one reduction op."""
    return jnp.sum(A * x[None], axis=1)


def mTv(A, x):
    """Aᵀ x: (m,n)+bt, (m,)+bt -> (n,)+bt."""
    return jnp.sum(A * x[:, None], axis=0)


def dot(a, b):
    """(n,)+bt · (n,)+bt -> (*bt)."""
    return jnp.sum(a * b, axis=0)


def outer(a, b):
    """(m,)+bt ⊗ (n,)+bt -> (m,n)+bt."""
    return a[:, None] * b[None]


def transpose(A):
    """(m,n)+bt -> (n,m)+bt (swap the two leading dims)."""
    return jnp.swapaxes(A, 0, 1)


def cross(a, b):
    """3-vector cross product on (3,)+bt operands."""
    return jnp.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ], axis=0)


def eye(n, ref):
    """(n,n)+bt identity whose batch dims match a reference (*bt) scalar."""
    rows = []
    z = jnp.zeros_like(ref)
    o = jnp.ones_like(ref)
    for i in range(n):
        e = [z] * n
        e[i] = o
        rows.append(jnp.stack(e, axis=0))
    return jnp.stack(rows, axis=0)


def const(x, bt_rank, dtype):
    """Static numpy constant -> jnp array with `bt_rank` trailing singleton
    batch dims, ready to broadcast against (elem...)+bt values.

    NOT usable inside a kernel (captured array constants are rejected);
    kernels use the static-operand helpers below, which embed
    constants as Python scalars and skip structural zeros."""
    import numpy as np

    a = jnp.asarray(np.asarray(x), dtype)
    return a.reshape(a.shape + (1,) * bt_rank)


# ------------------------------------------------- static-operand products
# One operand is a host-side numpy constant: its entries become Python
# scalar literals in the traced program (kernel-safe — nothing captured)
# and exact zeros/ones cost nothing.  These carry most of the FK/CRBA
# constants (joint axes, X_T transforms, inertia tensors, constraint
# blocks), which are extremely sparse.

def _zl(x):
    return jnp.zeros_like(x)


def mv_ds(A, b_np):
    """dynamic (m,n)+bt @ static (n,) -> (m,)+bt."""
    acc = None
    for k in range(len(b_np)):
        v = float(b_np[k])
        if v == 0.0:
            continue
        t = A[:, k] if v == 1.0 else A[:, k] * v
        acc = t if acc is None else acc + t
    return _zl(A[:, 0]) if acc is None else acc


def mm_ds(A, B_np):
    """dynamic (m,k)+bt @ static (k,n) -> (m,n)+bt."""
    return jnp.stack(
        [mv_ds(A, B_np[:, j]) for j in range(B_np.shape[1])], axis=1
    )


def vec_sd(A_np_row, xs):
    """static row (k,) · list of k (*bt) scalars -> (*bt)."""
    acc = None
    for k, x in enumerate(xs):
        v = float(A_np_row[k])
        if v == 0.0:
            continue
        t = x if v == 1.0 else x * v
        acc = t if acc is None else acc + t
    return _zl(xs[0]) if acc is None else acc


def mv_sd(A_np, x):
    """static (m,n) @ dynamic (n,)+bt -> (m,)+bt."""
    rows = []
    for i in range(A_np.shape[0]):
        acc = None
        for k in range(A_np.shape[1]):
            v = float(A_np[i, k])
            if v == 0.0:
                continue
            t = x[k] if v == 1.0 else x[k] * v
            acc = t if acc is None else acc + t
        rows.append(_zl(x[0]) if acc is None else acc)
    return jnp.stack(rows, axis=0)


def mm_sd(A_np, B):
    """static (m,k) @ dynamic (k,n)+bt -> (m,n)+bt."""
    rows = []
    for i in range(A_np.shape[0]):
        acc = None
        for k in range(A_np.shape[1]):
            v = float(A_np[i, k])
            if v == 0.0:
                continue
            t = B[k] if v == 1.0 else B[k] * v
            acc = t if acc is None else acc + t
        rows.append(_zl(B[0]) if acc is None else acc)
    return jnp.stack(rows, axis=0)


def svec(vals, zero):
    """static 1-D values -> (n,)+bt array built by arithmetic on a traced
    zero scalar (kernel-safe constant vector)."""
    return jnp.stack(
        [zero + float(v) if float(v) != 0.0 else zero for v in vals], axis=0
    )


def smat(M_np, zero):
    """static 2-D values -> (m,n)+bt (kernel-safe constant matrix)."""
    return jnp.stack([svec(row, zero) for row in M_np], axis=0)


def diag_add(M, vals):
    """M + diag(vals): vals is a list of (*bt) scalars or floats."""
    n = M.shape[0]
    rows = []
    for i in range(n):
        row = [M[i, j] for j in range(n)]
        row[i] = row[i] + vals[i]
        rows.append(jnp.stack(row, axis=0))
    return jnp.stack(rows, axis=0)


# ------------------------------------------------------ factorizations
def chol_factor(M):
    """Cholesky factor of (n,n)+bt SPD (lower) + reciprocal diagonal,
    slice-vectorized right-looking form — the elem-leading transpose of
    ops/smallmat.chol (identical recurrence, pivots clamped at 1e-30).

    One rsqrt per column replaces the per-element divide chain of the
    naive form (n²/2 divides per factorization); the reciprocal diagonal is
    returned so the triangular solves below can multiply instead of divide
    too."""
    n = M.shape[0]
    S = M
    cols = []
    inv_diag = []
    for j in range(n):
        s00 = jnp.maximum(S[0, 0], 1e-30)
        inv_d = jax.lax.rsqrt(s00)
        col = S[:, 0] * inv_d[None]                  # (n-j,)+bt, col[0] = d
        # the last column's empty update would create 0-sized values:
        # skip the empty trailing block
        if j < n - 1:
            ctail = col[1:]
            S = S[1:, 1:] - ctail[:, None] * ctail[None]
        inv_diag.append(inv_d)
        if j:
            col = jnp.concatenate(
                [jnp.zeros((j,) + col.shape[1:], col.dtype), col], axis=0
            )
        cols.append(col)
    return jnp.stack(cols, axis=1), inv_diag          # (n,n)+bt lower


def chol(M):
    """Cholesky factor of (n,n)+bt SPD (lower); see chol_factor."""
    return chol_factor(M)[0]


def solve_lower(L, B):
    """L X = B, B (n,m)+bt (forward substitution, unrolled rows)."""
    n = L.shape[0]
    xs = []
    for i in range(n):
        acc = B[i]
        for k in range(i):
            acc = acc - L[i, k][None] * xs[k]
        xs.append(acc / L[i, i][None])
    return jnp.stack(xs, axis=0)


def solve_lower_vec(L, b):
    """L x = b, b (n,)+bt."""
    n = L.shape[0]
    xs = []
    for i in range(n):
        acc = b[i]
        for k in range(i):
            acc = acc - L[i, k] * xs[k]
        xs.append(acc / L[i, i])
    return jnp.stack(xs, axis=0)


def solve_upper_vec(U, b):
    n = U.shape[0]
    xs = [None] * n
    for i in reversed(range(n)):
        acc = b[i]
        for k in range(i + 1, n):
            acc = acc - U[i, k] * xs[k]
        xs[i] = acc / U[i, i]
    return jnp.stack(xs, axis=0)


def cho_solve_vec(L, b):
    """Solve L Lᵀ x = b for a vector b (n,)+bt."""
    return solve_upper_vec(transpose(L), solve_lower_vec(L, b))


def tri_inv_lower(L, inv_diag):
    """Explicit inverse of a lower-triangular (n,n)+bt factor, exploiting
    the triangular structure (the naive solve_lower(L, eye) runs the full
    dense recurrence over the structurally-zero upper blocks — 3× the
    FMAs and n² divides; this is n³/6 FMAs and zero divides).

    Column j of X = L⁻¹:  X[j,j] = 1/L[j,j];
    X[i,j] = −(Σ_{k=j..i−1} L[i,k]·X[k,j]) / L[i,i]   for i > j.
    Entries above the diagonal are exact zeros."""
    n = L.shape[0]
    z = jnp.zeros_like(L[0, 0])
    X = [[None] * n for _ in range(n)]
    for j in range(n):
        X[j][j] = inv_diag[j] + z
        for i in range(j + 1, n):
            acc = L[i, j] * X[j][j]
            for k in range(j + 1, i):
                acc = acc + L[i, k] * X[k][j]
            X[i][j] = -acc * inv_diag[i]
    rows = []
    for i in range(n):
        rows.append(jnp.stack(
            [X[i][j] if j <= i else z for j in range(n)], axis=0
        ))
    return jnp.stack(rows, axis=0)


def ltl_sym(X):
    """XᵀX for a LOWER-triangular (n,n)+bt X, exploiting both the
    triangularity (k ≥ max(i,j) terms only) and the symmetry of the result
    (entries computed once, referenced twice): n³/6 FMAs vs n³ for the
    dense mTm.  The result is exactly symmetric by construction."""
    n = X.shape[0]
    E = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i, n):
            acc = None
            for k in range(j, n):
                t = X[k, i] * X[k, j]
                acc = t if acc is None else acc + t
            E[i][j] = E[j][i] = acc
    return jnp.stack(
        [jnp.stack(E[i], axis=0) for i in range(n)], axis=0
    )


def mmT_sym(A, B):
    """A @ Bᵀ for operands KNOWN to produce a symmetric result (e.g.
    (J A⁻¹) Jᵀ): computes the lower triangle only and mirrors — half the
    FMAs of mmT, and the output is exactly symmetric (no 0.5(M+Mᵀ)
    post-symmetrization needed)."""
    m, k = A.shape[0], A.shape[1]
    E = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            acc = A[i, 0] * B[j, 0]
            for t in range(1, k):
                acc = acc + A[i, t] * B[j, t]
            E[i][j] = E[j][i] = acc
    return jnp.stack(
        [jnp.stack(E[i], axis=0) for i in range(m)], axis=0
    )


def mTm_sym(A, B):
    """Aᵀ @ B with a symmetric result (e.g. Aᵀ(ΛA)): lower triangle only,
    mirrored."""
    k, m = A.shape[0], A.shape[1]
    E = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            acc = A[0, i] * B[0, j]
            for t in range(1, k):
                acc = acc + A[t, i] * B[t, j]
            E[i][j] = E[j][i] = acc
    return jnp.stack(
        [jnp.stack(E[i], axis=0) for i in range(m)], axis=0
    )


def mm_sym(A, B):
    """A @ B with a symmetric result: lower triangle only, mirrored."""
    m, k = A.shape[0], A.shape[1]
    E = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            acc = A[i, 0] * B[0, j]
            for t in range(1, k):
                acc = acc + A[i, t] * B[t, j]
            E[i][j] = E[j][i] = acc
    return jnp.stack(
        [jnp.stack(E[i], axis=0) for i in range(m)], axis=0
    )


def solve_lower_inv(L, inv_diag, B):
    """L X = B with a precomputed reciprocal diagonal (no divides)."""
    n = L.shape[0]
    xs = []
    for i in range(n):
        acc = B[i]
        for k in range(i):
            acc = acc - L[i, k][None] * xs[k]
        xs.append(acc * inv_diag[i][None])
    return jnp.stack(xs, axis=0)


def solve_upperT_inv(L, inv_diag, Y):
    """Lᵀ X = Y (back substitution on the transposed factor), reciprocal
    diagonal, matrix RHS."""
    n = L.shape[0]
    xs = [None] * n
    for i in reversed(range(n)):
        acc = Y[i]
        for k in range(i + 1, n):
            acc = acc - L[k, i][None] * xs[k]
        xs[i] = acc * inv_diag[i][None]
    return jnp.stack(xs, axis=0)


def cho_solve_mat(L, inv_diag, B):
    """Solve L Lᵀ X = B for a matrix RHS (n,m)+bt using the reciprocal
    diagonal — the factored-apply path that lets the fused tick avoid
    materializing W⁻¹ entirely."""
    return solve_upperT_inv(L, inv_diag, solve_lower_inv(L, inv_diag, B))


def psd_inverse(M):
    """(n,n)+bt SPD inverse: A⁻¹ = L⁻ᵀL⁻¹ (matches smallmat.psd_inverse up
    to summation order), via the structure-aware triangular inverse: ~2n³/3
    FMAs and n rsqrts total vs ~2n³ FMAs + n²·3/2 divides for the naive
    chol → solve_lower(·, eye) → mTm pipeline it replaces."""
    L, inv_diag = chol_factor(M)
    return ltl_sym(tri_inv_lower(L, inv_diag))


def chol_health(M):
    """min(diag L)/max(diag L) ≈ sqrt(λmin/λmax) — the rank_health
    indicator (wbc/dynamics._chol_health) in elem-leading form."""
    L = chol(M)
    d = jnp.abs(jnp.stack([L[i, i] for i in range(M.shape[0])], axis=0))
    return jnp.min(d, axis=0) / jnp.maximum(jnp.max(d, axis=0), 1e-30)


# -------------------------------------------------------- orthogonal ops
def qr_thin(A, drop_tol=None):
    """Thin QR of (m,k)+bt via double-pass MGS (mirror of smallmat.qr_thin:
    same recurrence, same drop-tol semantics)."""
    k = A.shape[1]
    cols = []
    for j in range(k):
        v = A[:, j]
        nrm0 = jnp.sqrt(dot(v, v))[None]
        for q in cols:
            v = v - dot(q, v)[None] * q
        for q in cols:
            v = v - dot(q, v)[None] * q
        nrm = jnp.sqrt(jnp.maximum(dot(v, v), 1e-30))[None]
        if drop_tol is None:
            cols.append(v / nrm)
        else:
            keep = nrm > drop_tol * jnp.maximum(nrm0, 1e-30)
            cols.append(jnp.where(keep, v / nrm, 0.0))
    return jnp.stack(cols, axis=1)


def complete_basis(A):
    """Orthonormal completion of col(A), A (m,k)+bt → (m,m)+bt whose first
    k columns span col(A) (mirror of smallmat.complete_basis: greedy
    residual-argmax selection via one-hot reduction — no gather)."""
    m, k = A.shape[0], A.shape[1]
    Q = qr_thin(A)
    cols = [Q[:, j] for j in range(k)]
    residuals = []
    for j in range(m):
        e = [jnp.zeros_like(A[0, 0])] * m
        e[j] = jnp.ones_like(A[0, 0])
        v = jnp.stack(e, axis=0)
        for q in cols:
            v = v - dot(q, v)[None] * q
        residuals.append(v)
    R = jnp.stack(residuals, axis=1)                   # (m, m)+bt candidates
    chosen = []
    for _ in range(m - k):
        nrm = jnp.sum(R * R, axis=0)                    # (m,)+bt
        # first-argmax one-hot via prefix products (no argmax/iota/gather —
        # lowering-safe in a kernel, same selection as smallmat's argmax)
        nmax = jnp.max(nrm, axis=0)
        hit = (nrm >= nmax[None]).astype(A.dtype)
        run = []
        acc = jnp.ones_like(nmax)
        for j in range(m):
            run.append(acc * hit[j])
            acc = acc * (1.0 - hit[j])
        onehot = jnp.stack(run, axis=0)                 # (m,)+bt
        v = jnp.sum(R * onehot[None], axis=1)           # selected column
        v = v / jnp.sqrt(jnp.maximum(dot(v, v), 1e-30))[None]
        chosen.append(v)
        R = R - v[:, None] * jnp.sum(v[:, None] * R, axis=0)[None]
    return jnp.concatenate(
        [jnp.stack(cols, axis=1), jnp.stack(chosen, axis=1)], axis=1
    )


def orthonormalize_drop(V, tol=1e-8):
    """MGS over columns of (n,k)+bt with rank dropout: columns whose
    residual norm falls below `tol` come back as ZERO columns (mirror of
    wbc/masked._orthonormalize_drop — rank-deficient masked kernel bases
    yield zeros, not noise)."""
    k = V.shape[1]
    out = []
    for j in range(k):
        v = V[:, j]
        for u in out:
            v = v - dot(u, v)[None] * u
        nrm = jnp.sqrt(dot(v, v))[None]
        keep = nrm > tol
        out.append(jnp.where(keep, v / jnp.where(keep, nrm, 1.0), 0.0))
    return jnp.stack(out, axis=1)


def compact_columns(V, tol=1e-10):
    """Shift nonzero columns of (n,k)+bt left, preserving order (mirror of
    wbc/masked._compact_columns, built from prefix sums — no gather).
    Returns (V_compacted, n_nonzero (*bt))."""
    k = V.shape[1]
    nz = []
    for j in range(k):
        nz.append((jnp.sqrt(dot(V[:, j], V[:, j])) > tol).astype(V.dtype))
    # pos[j] = (# nonzero among 0..j) − 1  (target slot of column j)
    pos = []
    acc = None
    for j in range(k):
        acc = nz[j] if acc is None else acc + nz[j]
        pos.append(acc - 1.0)
    cols = []
    for t in range(k):
        c = None
        for j in range(k):
            w = nz[j] * (jnp.abs(pos[j] - t) < 0.5).astype(V.dtype)
            term = V[:, j] * w[None]
            c = term if c is None else c + term
        cols.append(c)
    count = acc
    return jnp.stack(cols, axis=1), count


def qr_pinv(M, rcond=1e-6):
    """Thresholded pseudo-inverse of a small square (n,n)+bt matrix —
    mirror of smallmat.qr_pinv (MGS QR, dead pivots zeroed)."""
    n = M.shape[0]
    Q = qr_thin(M, drop_tol=1e-7)
    R = mTm(Q, M)
    d = jnp.abs(jnp.stack([R[i, i] for i in range(n)], axis=0))  # (n,)+bt
    dmax = jnp.max(d, axis=0)
    live = (d > rcond * dmax[None])                     # (n,)+bt
    liveM = live[:, None]
    Rm = jnp.where(liveM, R, eye(n, M[0, 0]))
    B = jnp.where(liveM, transpose(Q), 0.0)
    # back substitution on the matrix RHS
    n_ = n
    xs = [None] * n_
    for i in reversed(range(n_)):
        acc = B[i]
        for k in range(i + 1, n_):
            acc = acc - Rm[i, k][None] * xs[k]
        xs[i] = acc / Rm[i, i][None]
    return jnp.stack(xs, axis=0)
