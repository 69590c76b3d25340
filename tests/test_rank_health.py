"""Contact-space rank-failure diagnostics.

The reference aborts with "Contact Space Factorization Error" when the COD
rank of the contact Gram is not the expected one
(/root/reference/src/wbd.cpp:126-136, src/dwbc.cpp:3121-3131).  The
batched equivalent is a numeric, batched `rank_health` indicator
returned from `contact_space`/`masked_contact_space` and threaded into
TickResult — tiny on a degenerate contact set, O(normal) otherwise.
"""

import numpy as np
import jax.numpy as jnp

from conftest import CASE_Q, full_q, make_standard_robot


def _healthy_inputs():
    rng = np.random.default_rng(0)
    n = 39
    J_C = rng.standard_normal((12, n))
    M = rng.standard_normal((n, n))
    A_inv = M @ M.T / n + np.eye(n)
    return jnp.asarray(J_C), jnp.asarray(A_inv)


def test_healthy_contact_set_reports_high_health():
    from libdwbc_tpu.wbc.dynamics import contact_space

    J_C, A_inv = _healthy_inputs()
    cs = contact_space(J_C, A_inv)
    assert float(cs.rank_health) > 1e-4


def test_duplicate_contact_rows_reported_degenerate():
    """Two identical contacts → singular contact Gram → tiny health."""
    from libdwbc_tpu.wbc.dynamics import contact_space

    J_C, A_inv = _healthy_inputs()
    J_dup = jnp.concatenate([J_C[:6], J_C[:6]], axis=0)
    cs = contact_space(J_dup, A_inv)
    assert float(cs.rank_health) < 1e-7


def test_rank_deficient_base_block_reported_degenerate():
    """J_C[:, :6] rank < 6 breaks the closed-form kernel basis — the second
    failure mode the indicator must flag."""
    from libdwbc_tpu.wbc.dynamics import contact_space

    J_C, A_inv = _healthy_inputs()
    J_bad = J_C.at[:, 5].set(0.0)  # kill one base column
    cs = contact_space(J_bad, A_inv)
    assert float(cs.rank_health) < 1e-7


def test_masked_health_matches_unmasked_active_block():
    from libdwbc_tpu.wbc.dynamics import contact_space
    from libdwbc_tpu.wbc.masked import masked_contact_space

    J_C, A_inv = _healthy_inputs()
    full = contact_space(J_C, A_inv)
    masked = masked_contact_space(J_C, A_inv, jnp.ones(12))
    np.testing.assert_allclose(
        float(masked.rank_health), float(full.rank_health), rtol=1e-6
    )


def test_threshold_separates_good_from_garbage():
    """Calibration guard (benchmarks/rank_health_calib.py): on the
    near-duplicate-contact continuum J2(α) = (1-α)J2 + αJ1 over the REAL
    Tocabi double-support geometry, a config whose f32 health clears the
    façade threshold must produce f32 torques within ~1% of f64 truth, and
    a config below it must not (measured law: err ≈ ε_dtype/health²).
    Fails if the indicator or the threshold stops separating the two."""
    from conftest import URDF
    from libdwbc_tpu.kin.engine import FK, Kinematics
    from libdwbc_tpu.model.compile import compile_urdf
    from libdwbc_tpu.wbc.dynamics import contact_space, gravity_compensation
    from libdwbc_tpu.wbc.robot import RobotData

    model = compile_urdf(URDF, floating=True)
    kin = Kinematics(model)
    q = np.zeros(model.nq)
    q[2] = 0.92983
    q[model.ndof] = 1.0
    q[6:18] = [0.0, 0.0, -0.24, 0.6, -0.36, 0.0] * 2
    st = kin.update(jnp.asarray(q), jnp.zeros(model.ndof))
    fk = FK(R=st.R, p=st.p,
            axis_w=jnp.einsum("bij,bj->bi", st.R, jnp.asarray(model.axis)),
            com_w=st.com_w)
    pt = jnp.asarray([0.03, 0.0, -0.1585])
    J1 = np.asarray(kin.frame_point_jacobian(fk, 6, pt))
    J2 = np.asarray(kin.frame_point_jacobian(fk, 12, pt))
    A_inv64, G64 = np.asarray(st.A_inv), np.asarray(st.G)
    thresh = RobotData.RANK_HEALTH_THRESHOLD_F32

    def run(alpha, dtype):
        Jc = jnp.asarray(
            np.concatenate([J1, (1 - alpha) * J2 + alpha * J1], axis=0), dtype
        )
        cs = contact_space(Jc, jnp.asarray(A_inv64, dtype))
        tg, _ = gravity_compensation(
            jnp.asarray(A_inv64, dtype), cs.W_inv, cs.N_C, cs.J_C_INV_T,
            jnp.asarray(G64, dtype),
        )
        return float(np.asarray(cs.rank_health)), np.asarray(tg, np.float64)

    # healthy side: double support (α=0) and a mildly-degraded point
    for alpha in (0.0, 0.9):
        h32, tg32 = run(alpha, jnp.float32)
        _, tg64 = run(alpha, jnp.float64)
        assert h32 > thresh, f"α={alpha}: healthy config flagged ({h32:.2e})"
        relerr = np.linalg.norm(tg32 - tg64) / np.linalg.norm(tg64)
        assert relerr < 1e-2, f"α={alpha}: {relerr:.2e}"

    # garbage side: near-duplicate contact — must be flagged, and the f32
    # result there really is garbage (that is WHY it must be flagged)
    h32_bad, tg32_bad = run(0.9957, jnp.float32)
    _, tg64_bad = run(0.9957, jnp.float64)
    assert h32_bad < thresh, f"degenerate config passed ({h32_bad:.2e})"
    relerr_bad = np.linalg.norm(tg32_bad - tg64_bad) / np.linalg.norm(tg64_bad)
    assert not np.isfinite(relerr_bad) or relerr_bad > 1e-2


def test_facade_returns_zero_on_degenerate_contact_set():
    """Numeric analog of CalcContactConstraint's int status: two 6D
    contacts on ADJACENT bodies (one revolute joint between them — jacobian
    rows span ≤7 dims, Gram rank ≤7 < 12) → status 0; healthy double
    support → status 1."""
    from libdwbc_tpu.wbc import types as T
    from libdwbc_tpu.wbc.robot import RobotData
    from conftest import URDF

    rd = make_standard_robot(1)
    assert rd.CalcContactConstraint() == 1
    assert float(np.asarray(rd.contact_rank_health)) > 1e-6

    rd2 = RobotData()
    rd2.LoadModelData(URDF, True, 0)
    pt = [0.03, 0, -0.1585]
    rd2.AddContactConstraint(5, T.CONTACT_6D, pt, [0, 0, 1], 0.15, 0.075)
    rd2.AddContactConstraint(6, T.CONTACT_6D, pt, [0, 0, 1], 0.15, 0.075)
    rd2.UpdateKinematics(full_q(CASE_Q[1]), np.zeros(39))
    rd2.SetContact(True, True)
    assert rd2.CalcContactConstraint() == 0
