"""Fused-tick (ops/tick_kernel + wbc/fused) parity vs the golden-validated
XLA pipeline, CPU f64.

The fused tick is ONE element-leading program (FK → jacobians → world-frame
CRBA → A⁻¹ → contact space → JKT → 3 IPM QPs); here it runs as plain XLA
and must reproduce the CompiledTick pipeline, which is itself golden-
validated against /root/reference/tests/cases (test_golden_parity.py).

Tolerance policy (CLAUDE.md): pre-QP linear algebra ~1e-12; τ_task tight
(unit-Hessian block); τ_cmd up to the flat-face in-span indeterminacy.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from conftest import CASE_FSTAR, CASE_Q, full_q


@pytest.fixture(scope="module")
def setup(tocabi_model):
    from libdwbc_tpu.ops.tick_kernel import TickProgram
    from libdwbc_tpu.wbc.fused import FusedTick
    from libdwbc_tpu.wbc.pipeline import CompiledTick, standard_tocabi_config

    cfg = standard_tocabi_config(tocabi_model, qp_iters=25)
    tick = CompiledTick(tocabi_model, cfg, dtype=jnp.float64)
    ft = FusedTick(tocabi_model, cfg, dtype=jnp.float64)
    prog = TickProgram(tocabi_model, cfg, dtype=jnp.float64)
    return tocabi_model, cfg, tick, ft, prog


def test_prestage_linear_algebra_parity(setup):
    """Every pre-QP quantity matches the validated pipeline at ~1e-12:
    τ_grav, P_C, J̄ᵀ, NwJw, rank health, per-level Ntorque, constraint prep.
    This transitively inherits the golden-case validation of engine.update
    + contact_space (A_inv 1e-11, Lambda_contact..NwJw ≤1e-8 vs reference
    fixtures)."""
    import libdwbc_tpu.wbc.dynamics as dyn

    model, cfg, tick, ft, prog = setup
    q = jnp.asarray(full_q(CASE_Q[1]))
    qd = jnp.zeros(39)

    st = tick.kin.update(q, qd, J_bodies=tick._J_bodies, points=tick._points)
    J_C = tick._contact_jacobian_pts(st)
    cs = dyn.contact_space(J_C, st.A_inv)
    tg_ref, P_C_ref = dyn.gravity_compensation(
        st.A_inv, cs.W_inv, cs.N_C, cs.J_C_INV_T, st.G
    )

    pre = jax.jit(prog.prestage)(q)

    def chk(a, b, tol):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < tol

    chk(pre["torque_grav"], tg_ref, 1e-10)
    chk(pre["P_C"], P_C_ref, 1e-10)
    chk(pre["Jbar_act"], cs.J_C_INV_T[:, 6:], 1e-11)
    chk(pre["NwJw"], cs.NwJw, 1e-11)
    chk(pre["health"], cs.rank_health, 1e-12)

    fk = tick._fk_from_state(st)
    prev_null = jnp.eye(33, dtype=jnp.float64)
    for h in range(2):
        J_task = tick._task_jacobian(st, fk, h)
        tf = dyn.task_jkt(J_task, st.A_inv, cs.N_C, cs.W_inv)
        chk(pre["Ntorques"][h], prev_null @ tf.J_kt @ tf.Lambda_task, 1e-10)
        prev_null = dyn.task_null_space(
            tf.J_kt, tf.Lambda_task, J_task, cs.A_inv_N_C, prev_null
        )

    A_const, A_rot = tick._constraint_blocks(st)
    CM = A_const @ A_rot
    chk(pre["Atemp"], CM @ cs.J_C_INV_T[:, 6:], 1e-11)
    chk(pre["bA0"], CM @ P_C_ref, 1e-10)


def test_full_tick_cold_parity(setup):
    """Cold 25-iter tick: identical IPM recurrence → machine-precision
    τ parity with CompiledTick on the reference case-1 configuration."""
    model, cfg, tick, ft, prog = setup
    q = full_q(CASE_Q[1])
    qd = np.zeros(39)
    f1, f2 = CASE_FSTAR[1]

    r_ref = tick(q, qd, (f1, f2))
    r = ft(q, qd, (f1, f2))
    for k in ("torque_grav", "torque_task", "torque_contact", "torque_cmd"):
        assert np.abs(
            np.asarray(getattr(r, k)) - np.asarray(getattr(r_ref, k))
        ).max() < 1e-9, k
    assert float(r.qp_primal_res) < 1e-9
    assert abs(float(r.contact_rank_health)
               - float(r_ref.contact_rank_health)) < 1e-12


def test_batched_warm_serving_shape(setup):
    """The serving shape: batch of drifted states, warm carry across two
    ticks at the warm iteration budget, FusedTick vs CompiledTick.  Warm
    pytree shapes are interchangeable (drop-in contract); τ_grav/τ_task
    tight, τ_cmd within the flat-face policy."""
    model, cfg, tick, ft, prog = setup
    rng = np.random.default_rng(3)
    B = 4
    q = full_q(CASE_Q[1])
    qb = np.tile(q, (B, 1))
    qb[:, 6:39] += 0.02 * rng.standard_normal((B, 33))
    f1, f2 = CASE_FSTAR[1]
    fb = (jnp.asarray(np.tile(f1, (B, 1))), jnp.asarray(np.tile(f2, (B, 1))))
    qdb = jnp.zeros((B, 39))

    w_ft = ft.init_warm((B,))
    w_ct = tick.init_warm((B,))
    assert jax.tree_util.tree_all(
        jax.tree_util.tree_map(lambda a, b: a.shape == b.shape, w_ft, w_ct)
    )

    r1, w1 = ft._tick_impl(jnp.asarray(qb), qdb, fb, warm=w_ft, qp_iters=25)
    r1r, w1r = tick._tick_impl(jnp.asarray(qb), qdb, fb, warm=w_ct, qp_iters=25)

    qb2 = qb.copy()
    qb2[:, 6:39] += 1e-3 * rng.standard_normal((B, 33))
    r2, _ = ft._tick_impl(jnp.asarray(qb2), qdb, fb, warm=w1, qp_iters=7)
    r2r, _ = tick._tick_impl(jnp.asarray(qb2), qdb, fb, warm=w1r, qp_iters=7)

    assert np.abs(np.asarray(r2.torque_grav) - np.asarray(r2r.torque_grav)).max() < 1e-8
    assert np.abs(np.asarray(r2.torque_task) - np.asarray(r2r.torque_task)).max() < 2e-3
    # flat-face: command may differ only inside span(NwJw)
    assert np.abs(np.asarray(r2.torque_cmd) - np.asarray(r2r.torque_cmd)).max() < 5e-2
    assert float(np.asarray(r2.qp_gap).max()) < 1e-6
    assert float(np.asarray(r2.qp_primal_res).max()) < 1e-6


def test_single_support_config(setup):
    """cfree = 0 path (single 6D contact → no redistribution space): the
    fused tick's static branches must handle BASELINE config 3's shape."""
    from libdwbc_tpu.wbc.fused import FusedTick
    from libdwbc_tpu.wbc.pipeline import CompiledTick, standard_tocabi_config

    model, *_ = setup
    cfg = standard_tocabi_config(model, both_feet=False, qp_iters=25)
    tick = CompiledTick(model, cfg, dtype=jnp.float64)
    ft = FusedTick(model, cfg, dtype=jnp.float64)
    q = full_q(CASE_Q[1])
    f1, f2 = CASE_FSTAR[1]
    r_ref = tick(q, np.zeros(39), (f1, f2))
    r = ft(q, np.zeros(39), (f1, f2))
    assert np.abs(np.asarray(r.torque_cmd) - np.asarray(r_ref.torque_cmd)).max() < 1e-6
    assert r.contact_force.shape[-1] == 6


def test_fused_f32_vs_compiled_f64_full_width(tocabi_npz):
    """The committed 33-DoF Tocabi, double support, 2-level HQP: FusedTick
    at f32 against CompiledTick at f64 on 4 perturbed standing scenarios,
    within the f32 bars of the card's truth check (τ_grav 1e-2 Nm, τ_cmd
    5e-2 Nm — the QP optimum is a face)."""
    import __graft_entry__ as ge
    from libdwbc_tpu.wbc.fused import FusedTick
    from libdwbc_tpu.wbc.pipeline import CompiledTick, standard_tocabi_config

    cfg = standard_tocabi_config(tocabi_npz, qp_iters=12)
    q, qd, fs = ge._batch_inputs(tocabi_npz, 4, seed=2)
    r32 = FusedTick(tocabi_npz, cfg, dtype=jnp.float32)._tick(q, qd, fs)
    r64 = CompiledTick(tocabi_npz, cfg, dtype=jnp.float64)._tick(
        q.astype(np.float64), qd.astype(np.float64),
        tuple(f.astype(np.float64) for f in fs))
    assert r32.torque_cmd.dtype == jnp.float32
    for k, tol in (("torque_grav", 1e-2), ("torque_cmd", 5e-2)):
        d = np.abs(np.asarray(getattr(r32, k), np.float64)
                   - np.asarray(getattr(r64, k))).max()
        assert d < tol, (k, d)
    assert not np.asarray(r32.qp_error).any()
