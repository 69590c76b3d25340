"""f32 near-singular-task robustness (round-4 regression).

~0.3-0.5% of a 0.02-rad perturbed standing batch puts the 6D base task
near a contact-consistent singularity (measured task-Gram eigenvalue
3e-11 vs 2.7 on one such pose).  The reference handles this with its
COD-thresholded pinv (src/wbd.cpp:207-213, COD_THRESHOLD 1e-6); at f64
the J_kt·Λ product also self-cancels.  At f32 neither rescue exists and
both serving formulations (XLA CompiledTick and the fused element-leading
program) produced NaN or ±1e4 Nm garbage torques on those lanes — hidden
for two rounds because tests run f64 and bench.py's diag tracked lane 0
only.  Fix: the relative Tikhonov ridge in ``dynamics._psd_inv_reg`` /
the fused kernel's ``_reg`` (f32 only) + the non-finite step guard in
``ops/qp.py``.

The lane set below contains every index that failed on some
routing/backend combination before the fix.
"""

import numpy as np
import pytest

import jax.numpy as jnp

BAD_LANES = [189, 360, 473, 654, 690, 706, 740, 778, 835, 998]


def _batch(model):
    rng = np.random.default_rng(0)
    q = np.zeros(model.nq, np.float32)
    q[2] = 0.92983
    q[model.nq - 1] = 1.0
    qs = np.tile(q, (1024, 1)).astype(np.float32)
    qs[:, 6:39] += 0.02 * rng.standard_normal((1024, 33)).astype(np.float32)
    qs = qs[BAD_LANES]
    B = qs.shape[0]
    qds = np.zeros((B, model.ndof), np.float32)
    fs = tuple(
        np.tile(f, (B, 1)).astype(np.float32)
        for f in (np.array([0.1, 0.5, 0.1, 0.1, -0.1, 0.1]),
                  np.array([0.1, -0.1, 0.1]))
    )
    return qs, qds, fs


@pytest.fixture(scope="module")
def cfg33(tocabi_model):
    from libdwbc_tpu.wbc.pipeline import standard_tocabi_config

    return standard_tocabi_config(tocabi_model, qp_iters=12)


def _check(res):
    tau = np.asarray(res.torque_cmd)
    assert np.isfinite(tau).all()
    assert np.abs(tau).max() < 200.0, np.abs(tau).max()
    assert float(np.asarray(res.qp_primal_res).max()) < 1e-3
    assert float(np.asarray(res.qp_gap).max()) < 1e-2


def test_compiled_tick_f32(tocabi_model, cfg33):
    from libdwbc_tpu.wbc.pipeline import CompiledTick

    tick = CompiledTick(tocabi_model, cfg33, dtype=jnp.float32)
    qs, qds, fs = _batch(tocabi_model)
    _check(tick._tick_impl(
        jnp.asarray(qs), jnp.asarray(qds),
        tuple(jnp.asarray(f) for f in fs), qp_iters=12,
    ))


def test_fused_xla_f32(tocabi_model, cfg33):
    from libdwbc_tpu.wbc.fused import FusedTick

    tick = FusedTick(tocabi_model, cfg33, dtype=jnp.float32)
    qs, qds, fs = _batch(tocabi_model)
    _check(tick._tick_impl(
        jnp.asarray(qs), jnp.asarray(qds),
        tuple(jnp.asarray(f) for f in fs), qp_iters=12,
    ))


def test_f64_unbiased(tocabi_model, cfg33):
    """The ridge is f32-only: the f64 torques on these poses must be
    bit-identical with and without the guard active (it never triggers)."""
    from libdwbc_tpu.wbc import dynamics as dyn
    from libdwbc_tpu.wbc.pipeline import CompiledTick

    tick = CompiledTick(tocabi_model, cfg33, dtype=jnp.float64)
    qs, qds, fs = _batch(tocabi_model)
    a = tick._tick_impl(
        jnp.asarray(qs, jnp.float64), jnp.asarray(qds, jnp.float64),
        tuple(jnp.asarray(f, jnp.float64) for f in fs), qp_iters=12,
    )
    assert np.isfinite(np.asarray(a.torque_cmd)).all()
    orig = dyn._psd_inv_reg
    dyn._psd_inv_reg = dyn._psd_inv   # guard off
    try:
        tick2 = CompiledTick(tocabi_model, cfg33, dtype=jnp.float64)
        b = tick2._tick_impl(
            jnp.asarray(qs, jnp.float64), jnp.asarray(qds, jnp.float64),
            tuple(jnp.asarray(f, jnp.float64) for f in fs), qp_iters=12,
        )
    finally:
        dyn._psd_inv_reg = orig
    np.testing.assert_array_equal(
        np.asarray(a.torque_cmd), np.asarray(b.torque_cmd)
    )
