"""Masked (multi-contact-mode) fused tick vs MaskedTick — CPU f64.

The fused kernel's masked mode covers every support hypothesis of a
candidate contact set in ONE program with per-scenario masks (the
BASELINE config-5 serving shape); parity here is against wbc/masked.py,
itself validated against CompiledTick per mode (tests/test_masked.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from conftest import CASE_FSTAR, CASE_Q, full_q


@pytest.fixture(scope="module")
def masked_pair(tocabi_model):
    from libdwbc_tpu.wbc.fused import FusedTick
    from libdwbc_tpu.wbc.masked import MaskedTick
    from libdwbc_tpu.wbc.pipeline import standard_tocabi_config

    cfg = standard_tocabi_config(tocabi_model, qp_iters=25)
    mt = MaskedTick(tocabi_model, cfg, dtype=jnp.float64)
    ft = FusedTick(tocabi_model, cfg, dtype=jnp.float64,
                   masked=True)
    return tocabi_model, mt, ft


def _inputs(B=3):
    q = full_q(CASE_Q[1])
    f1, f2 = CASE_FSTAR[1]
    qb = jnp.asarray(np.tile(q, (B, 1)))
    qdb = jnp.zeros((B, 39))
    fb = (jnp.asarray(np.tile(f1, (B, 1))), jnp.asarray(np.tile(f2, (B, 1))))
    masks = jnp.asarray(np.array([[1, 1], [1, 0], [0, 1]], np.float64))
    return qb, qdb, fb, masks


def test_masked_fused_cold_parity(masked_pair):
    """All three support hypotheses in one batch: τ parity at linear-algebra
    precision (identical IPM recurrence, identical masking semantics)."""
    model, mt, ft = masked_pair
    qb, qdb, fb, masks = _inputs()
    rm = mt._tick_impl(qb, qdb, fb, masks)
    rf = ft._tick_impl(qb, qdb, fb, masks)
    for k in ("torque_grav", "torque_task", "torque_contact", "torque_cmd"):
        d = np.abs(np.asarray(getattr(rf, k)) - np.asarray(getattr(rm, k))).max()
        assert d < 1e-8, (k, d)
    np.testing.assert_allclose(
        np.asarray(rf.contact_rank_health),
        np.asarray(rm.contact_rank_health), atol=1e-10,
    )
    assert float(np.asarray(rf.qp_primal_res).max()) < 1e-9


def test_masked_fused_warm_parity(masked_pair):
    """Warm-started second tick after a state drift: the serving shape.
    MaskedTick's f64 XLA QPs apply the polish step, the fused kernel does
    not — τ agrees within the cross-formulation policy, and τ_grav (pre-QP)
    stays at linear-algebra precision."""
    model, mt, ft = masked_pair
    qb, qdb, fb, masks = _inputs()
    r1f, w1f = ft._tick_impl(qb, qdb, fb, masks, warm=ft.init_warm((3,)),
                             qp_iters=25)
    r1m, w1m = mt._tick_impl(qb, qdb, fb, masks, warm=mt.init_warm((3,)),
                             qp_iters=25)
    qb2 = np.asarray(qb).copy()
    qb2[:, 6:39] += 1e-3 * np.random.default_rng(0).standard_normal((3, 33))
    r2f, _ = ft._tick_impl(jnp.asarray(qb2), qdb, fb, masks, warm=w1f,
                           qp_iters=7)
    r2m, _ = mt._tick_impl(jnp.asarray(qb2), qdb, fb, masks, warm=w1m,
                           qp_iters=7)
    assert np.abs(np.asarray(r2f.torque_grav) - np.asarray(r2m.torque_grav)).max() < 1e-8
    assert np.abs(np.asarray(r2f.torque_task) - np.asarray(r2m.torque_task)).max() < 2e-3
    assert np.abs(np.asarray(r2f.torque_cmd) - np.asarray(r2m.torque_cmd)).max() < 5e-2
    assert float(np.asarray(r2f.qp_gap).max()) < 1e-6


def test_masked_fused_matches_static_tick_per_mode(masked_pair):
    """The masked fused tick at mask [1,1] must agree with the STATIC fused
    tick (different padding/kernel-basis machinery, same problem)."""
    from libdwbc_tpu.wbc.fused import FusedTick
    from libdwbc_tpu.wbc.pipeline import standard_tocabi_config

    model, mt, ft = masked_pair
    cfg = standard_tocabi_config(model, qp_iters=25)
    ft_static = FusedTick(model, cfg, dtype=jnp.float64)
    qb, qdb, fb, masks = _inputs()
    rf = ft._tick_impl(qb[:1], qdb[:1], tuple(f[:1] for f in fb), masks[:1])
    rs = ft_static._tick_impl(qb[:1], qdb[:1], tuple(f[:1] for f in fb))
    assert np.abs(np.asarray(rf.torque_grav) - np.asarray(rs.torque_grav)).max() < 1e-9
    assert np.abs(np.asarray(rf.torque_task) - np.asarray(rs.torque_task)).max() < 2e-3
    # flat-face: full command may differ only in span(NwJw)
    assert np.abs(np.asarray(rf.torque_cmd) - np.asarray(rs.torque_cmd)).max() < 5e-2
