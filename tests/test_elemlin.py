"""elemlin (element-leading math core of the fused tick) vs the
golden-validated batch-leading kernels in ops/smallmat + numpy truth."""

import numpy as np


def _to_el(a):
    """batch-leading (B, ...) -> element-leading (..., B)."""
    import jax.numpy as jnp

    return jnp.moveaxis(jnp.asarray(a), 0, -1)


def _from_el(a):
    return np.moveaxis(np.asarray(a), -1, 0)


def test_products():
    from libdwbc_tpu.ops import elemlin as el

    rng = np.random.default_rng(0)
    B = 7
    A = rng.standard_normal((B, 5, 4))
    Bm = rng.standard_normal((B, 4, 6))
    x = rng.standard_normal((B, 4))
    y = rng.standard_normal((B, 5))

    np.testing.assert_allclose(_from_el(el.mm(_to_el(A), _to_el(Bm))), A @ Bm, atol=1e-12)
    np.testing.assert_allclose(
        _from_el(el.mmT(_to_el(A), _to_el(np.swapaxes(Bm, 1, 2)))), A @ Bm, atol=1e-12
    )
    np.testing.assert_allclose(
        _from_el(el.mTm(_to_el(np.swapaxes(A, 1, 2)), _to_el(Bm))), A @ Bm, atol=1e-12
    )
    np.testing.assert_allclose(
        _from_el(el.mv(_to_el(A), _to_el(x))), (A @ x[..., None])[..., 0], atol=1e-12
    )
    np.testing.assert_allclose(
        _from_el(el.mTv(_to_el(A), _to_el(y))),
        (np.swapaxes(A, 1, 2) @ y[..., None])[..., 0], atol=1e-12,
    )
    a3 = rng.standard_normal((B, 3))
    b3 = rng.standard_normal((B, 3))
    np.testing.assert_allclose(
        _from_el(el.cross(_to_el(a3), _to_el(b3))), np.cross(a3, b3), atol=1e-12
    )


def test_chol_inverse_health():
    from libdwbc_tpu.ops import elemlin as el
    from libdwbc_tpu.ops import smallmat as sm
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    B, n = 5, 13
    M = rng.standard_normal((B, n, n))
    A = M @ np.swapaxes(M, 1, 2) + n * np.eye(n)

    L_el = _from_el(el.chol(_to_el(A)))
    L_sm = np.asarray(sm.chol(jnp.asarray(A)))
    np.testing.assert_allclose(L_el, L_sm, atol=1e-10)

    Ainv = _from_el(el.psd_inverse(_to_el(A)))
    np.testing.assert_allclose(Ainv, np.linalg.inv(A), atol=1e-8)

    h = _from_el(el.chol_health(_to_el(A)))
    d = np.abs(np.diagonal(L_sm, axis1=-2, axis2=-1))
    np.testing.assert_allclose(h, d.min(-1) / d.max(-1), atol=1e-10)

    b = rng.standard_normal((B, n))
    x = _from_el(el.cho_solve_vec(el.chol(_to_el(A)), _to_el(b)))
    np.testing.assert_allclose(x, np.linalg.solve(A, b[..., None])[..., 0], atol=1e-8)


def test_qr_and_completion():
    from libdwbc_tpu.ops import elemlin as el
    from libdwbc_tpu.ops import smallmat as sm
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    B, m, k = 4, 12, 6
    A = rng.standard_normal((B, m, k))

    Q_el = _from_el(el.qr_thin(_to_el(A)))
    Q_sm = np.asarray(sm.qr_thin(jnp.asarray(A)))
    np.testing.assert_allclose(Q_el, Q_sm, atol=1e-10)

    F_el = _from_el(el.complete_basis(_to_el(A)))
    F_sm = np.asarray(sm.complete_basis(jnp.asarray(A)))
    np.testing.assert_allclose(F_el, F_sm, atol=1e-9)

    Ms = rng.standard_normal((B, 6, 6))
    P_el = _from_el(el.qr_pinv(_to_el(Ms)))
    P_sm = np.asarray(sm.qr_pinv(jnp.asarray(Ms)))
    np.testing.assert_allclose(P_el, P_sm, atol=1e-9)
    # and it really inverts
    np.testing.assert_allclose(P_el @ Ms, np.broadcast_to(np.eye(6), (B, 6, 6)), atol=1e-7)


def test_triangular_and_symmetric_kernels():
    """Round-5 structure-aware kernels: triangular inverse, factored
    cho_solve, and the *_sym half-products must agree with their dense
    counterparts / numpy truth (they carry the fused tick's prestage)."""
    from libdwbc_tpu.ops import elemlin as el

    rng = np.random.default_rng(7)
    B, n = 4, 11
    M = rng.standard_normal((B, n, n))
    A = M @ np.swapaxes(M, 1, 2) + n * np.eye(n)

    L, idg = el.chol_factor(_to_el(A))
    L_np = np.linalg.cholesky(A)
    np.testing.assert_allclose(_from_el(L), L_np, atol=1e-10)
    np.testing.assert_allclose(
        _from_el(el.tri_inv_lower(L, idg)), np.linalg.inv(L_np), atol=1e-9
    )
    np.testing.assert_allclose(
        _from_el(el.ltl_sym(el.tri_inv_lower(L, idg))), np.linalg.inv(A),
        atol=1e-8,
    )
    Bm = rng.standard_normal((B, n, 5))
    np.testing.assert_allclose(
        _from_el(el.cho_solve_mat(L, idg, _to_el(Bm))),
        np.linalg.solve(A, Bm), atol=1e-8,
    )

    X = rng.standard_normal((B, 7, 4))
    Y = rng.standard_normal((B, 7, 4))
    # symmetric-result products: feed operands that make the result
    # genuinely symmetric and check against the dense path
    G = np.einsum("bik,bjk->bij", X, X)
    np.testing.assert_allclose(
        _from_el(el.mmT_sym(_to_el(X), _to_el(X))), G, atol=1e-12
    )
    np.testing.assert_allclose(
        _from_el(el.mTm_sym(_to_el(X.swapaxes(1, 2)), _to_el(X.swapaxes(1, 2)))),
        G, atol=1e-12,
    )
    np.testing.assert_allclose(
        _from_el(el.mm_sym(_to_el(G), _to_el(G))), G @ G, atol=1e-10
    )
    # exact symmetry by construction (the property the kernels rely on to
    # drop the 0.5(M+Mᵀ) post-symmetrizations)
    S = _from_el(el.mmT_sym(_to_el(X), _to_el(Y @ np.ones((4, 4)) * 0 + Y)))
    # (mmT_sym on non-symmetric-result operands mirrors the lower half;
    # the output must still be exactly symmetric)
    np.testing.assert_array_equal(S, S.swapaxes(1, 2))
