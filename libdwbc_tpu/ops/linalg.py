"""Dense linear-algebra kernels for the WBC pipeline.

The reference leans on Eigen's rank-revealing complete orthogonal
decomposition (``PinvCOD``/``PinvCODWB``, /root/reference/src/math.cpp:23-53,
src/wbd.cpp:5-53) with a 1e-6 threshold.  Rank-revealing factorizations are
data-dependent — hostile to XLA.  Here we exploit two facts:

* every matrix the reference pseudo-inverts is **symmetric PSD** (W = block of
  A⁻¹N_C; QW⁻¹Qᵀ; …), so a symmetric eigendecomposition gives the
  pseudo-inverse *and* an orthonormal null basis in one shot;
* the rank is **known statically** from the contact configuration
  (the reference itself force-feeds the rank on the reduced path,
  src/dwbc.cpp:3119), so no data-dependent rank decision is needed.

The pseudo-inverse is basis-independent, so results match Eigen's COD to
roundoff; the null-space basis differs by an orthogonal transform, which every
downstream quantity (NwJw, J_kt) is invariant to.
"""

from __future__ import annotations

import jax.numpy as jnp


def pinv_psd_fixed_rank(M, rank: int):
    """Pseudo-inverse + orthonormal null basis of a symmetric PSD matrix with
    statically known rank.

    Returns (M_pinv, V2) where V2 (n-rank, n) spans ker(M) (rows orthonormal).
    Replaces ``PinvCODWB(W, Winv, V2, ...)`` (src/wbd.cpp:32-53).
    """
    n = M.shape[-1]
    s, U = jnp.linalg.eigh(M)  # ascending eigenvalues
    null_dim = n - rank
    s_range = jnp.maximum(jnp.abs(s[..., -1:]), 1e-300)
    inv_s = jnp.where(
        jnp.arange(n) >= null_dim, 1.0 / jnp.where(jnp.abs(s) > 0, s, 1.0), 0.0
    )
    M_pinv = jnp.einsum("...ik,...k,...jk->...ij", U, inv_s, U)
    V2 = jnp.swapaxes(U[..., :, :null_dim], -1, -2)
    return M_pinv, V2


def pinv_psd(M, rel_threshold: float = 1.0e-6):
    """Thresholded pseudo-inverse of a symmetric PSD matrix (data-dependent
    *values* but static shapes).  Mirrors Eigen COD threshold semantics:
    eigenvalues below ``rel_threshold * max_eig`` are treated as zero.
    Used where the reference calls ``PinvCODWB(QW⁻¹Qᵀ)`` (src/wbd.cpp:212).
    """
    s, U = jnp.linalg.eigh(M)
    cutoff = rel_threshold * jnp.max(jnp.abs(s), axis=-1, keepdims=True)
    inv_s = jnp.where(jnp.abs(s) > cutoff, 1.0 / s, 0.0)
    return jnp.einsum("...ik,...k,...jk->...ij", U, inv_s, U)


def pinv_svd(M, rel_threshold: float = 1.0e-6):
    """General pseudo-inverse via SVD with Eigen-COD-style relative threshold.
    For non-symmetric rectangular inputs (rare in the pipeline)."""
    U, s, Vt = jnp.linalg.svd(M, full_matrices=False)
    cutoff = rel_threshold * jnp.max(s, axis=-1, keepdims=True)
    inv_s = jnp.where(s > cutoff, 1.0 / s, 0.0)
    return jnp.einsum("...ji,...i,...ki->...jk", Vt, inv_s, U)


def null_space_basis(A, rank: int):
    """Orthonormal basis of ker(A) for A (m,n) with statically known rank.

    Returns Z (n, n-rank) with A @ Z ≈ 0.  Replaces ``getNullSpace``
    (src/math.cpp:349-360) in the LQP cascade, where each level's equality
    stack has a known row rank.
    """
    # right-singular vectors of the zero singular values
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    return jnp.swapaxes(Vt, -1, -2)[..., :, rank:]


def solve_psd(M, b):
    """Cholesky solve for symmetric positive definite M."""
    import jax.scipy.linalg as jsl

    L = jnp.linalg.cholesky(M)
    return jsl.cho_solve((L, True), b)
