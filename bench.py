"""Benchmark: WBC solves/s on one GPU, 33-DoF Tocabi (BASELINE.json metric).

Runs the serving tick (kinematics → contact space → 2-level HQP → contact
redistribution) that libdwbc_tpu.backend selects for the GPU, batched, and
times it with block_until_ready:

* throughput: K ticks chained on device inside one lax.scan at B=1024
  (tick 0 cold at 12 IPM iterations, then warm-started at WARM_ITERS), with
  a data-dependent state perturbation between ticks so the device must run
  them in order; solves/s = B·K / median wall time of REPEATS runs;
* single-lane latency: the B=1 warm tick called from the host, one call
  per tick, p50/p99 per call (the reference's 1 kHz loop,
  tests/test_thread.cpp), plus the per-tick time of a K-tick on-device
  chain at B=1;
* torque truth: a few scenarios of the same batch on the CPU backend
  through CompiledTick, the independent XLA formulation.

Fails without a GPU.  Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

vs_baseline: the reference controller is a real-time 1 kHz single-robot
loop (tests/test_thread.cpp:107-112 — one solve per ms), so vs_baseline is
solves/s ÷ 1000: how many reference-equivalent 1 kHz control streams one
GPU sustains.
"""

import json
import os
import time

import numpy as np


def _chain(jax, jnp, tick, model, K, warm_iters):
    """jit(q0, qd0, fstars) → (q_K, (gap_max, pres_max) per tick)."""
    nd = model.model_dof

    @jax.jit
    def chained(q0, qd0, fstars_):
        warm0 = tick.init_warm(q0.shape[:-1])
        res0, warm = tick._tick_impl(q0, qd0, fstars_, warm=warm0, qp_iters=12)
        q1 = q0.at[..., 6:6 + nd].add(1e-6 * jnp.tanh(res0.torque_cmd))

        def body(carry, _):
            qq, w = carry
            res, w = tick._tick_impl(qq, qd0, fstars_, warm=w,
                                     qp_iters=warm_iters)
            qq = qq.at[..., 6:6 + nd].add(1e-6 * jnp.tanh(res.torque_cmd))
            # max over the WHOLE batch (a [0] index once hid garbage on
            # ~0.5% of lanes — the f32 near-singular-task bug)
            return (qq, w), (jnp.max(res.qp_gap), jnp.max(res.qp_primal_res))

        (qq, _), diag = jax.lax.scan(body, (q1, warm), None, length=K - 1)
        gap = jnp.concatenate([jnp.max(res0.qp_gap)[None], diag[0]])
        pres = jnp.concatenate([jnp.max(res0.qp_primal_res)[None], diag[1]])
        return qq, (gap, pres)

    return chained


def _timed(jax, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return time.perf_counter() - t0, out


def main():
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge
    import chip_smoke
    from libdwbc_tpu import runtime

    runtime.enable_compile_cache()
    runtime.require_gpu()
    card = runtime.card_line()

    model, tick = ge._model_and_tick(qp_iters=12)
    B = 1024
    K = int(os.environ.get("DWBC_BENCH_K", "256"))
    REPEATS = int(os.environ.get("DWBC_BENCH_REPEATS", "5"))
    WARM_ITERS = int(os.environ.get("DWBC_BENCH_WARM_ITERS", "7"))
    qs, qds, fs = ge._batch_inputs(model, B, seed=0)
    args = jax.device_put((qs, qds, fs))

    chained = _chain(jax, jnp, tick, model, K, WARM_ITERS)
    compile_s, _ = _timed(jax, chained, *args)
    times = []
    for _ in range(REPEATS):
        dt, (qq, diag) = _timed(jax, chained, *args)
        times.append(dt)
    dt = float(np.median(times))
    solves_per_sec = B * K / dt
    if not np.isfinite(np.asarray(qq)).all():
        raise AssertionError("non-finite state after ticks")

    # single lane: host in the loop, one call per tick
    step = jax.jit(lambda q, qd, f, w: tick._tick_impl(
        q, qd, f, warm=w, qp_iters=WARM_ITERS))
    q1, qd1, f1 = jax.device_put((qs[0], qds[0], tuple(f[0] for f in fs)))
    w1 = tick.init_warm(())
    res1, w1 = step(q1, qd1, f1, w1)
    jax.block_until_ready(res1)
    lat = []
    for _ in range(int(os.environ.get("DWBC_BENCH_SINGLE_CALLS", "500"))):
        t, (res1, w1) = _timed(jax, step, q1, qd1, f1, w1)
        lat.append(t * 1e3)
    lat = np.asarray(lat)
    chain1 = _chain(jax, jnp, tick, model, K, WARM_ITERS)
    _timed(jax, chain1, q1, qd1, f1)
    chain1_ms = min(_timed(jax, chain1, q1, qd1, f1)[0] for _ in range(3)) * 1e3

    # torque truth: CompiledTick at f64 on the CPU backend, same scenarios
    nchk = 4
    sub = (qs[:nchk], qds[:nchk], tuple(f[:nchk] for f in fs))
    g64, c64 = chip_smoke.reference_f64(model, *sub)
    r_dev = tick._tick_impl(*sub, qp_iters=12)
    dg = float(np.abs(np.asarray(r_dev.torque_grav, np.float64) - g64).max())
    dc = float(np.abs(np.asarray(r_dev.torque_cmd, np.float64) - c64).max())
    # τ_grav is pre-QP linear algebra: beyond f32 roundoff the device path
    # is numerically corrupt
    if not dg < 1e-2:
        raise AssertionError(f"device torque_grav diverges from CPU: {dg}")

    print(json.dumps({
        "metric": "wbc_solves_per_sec",
        "value": solves_per_sec,
        "unit": "solves/s",
        "vs_baseline": solves_per_sec / 1000.0,
        "device": runtime.device_info(),
        "card": card,
        "tick": type(tick).__name__,
        "batch": B,
        "chained_ticks": K,
        "bench_repeats": REPEATS,
        "run_spread": (max(times) - min(times)) / dt,
        "warm_iters": WARM_ITERS,
        "compile_and_first_run_s": compile_s,
        "single_lane_call_ms_p50": float(np.percentile(lat, 50)),
        "single_lane_call_ms_p99": float(np.percentile(lat, 99)),
        "single_lane_chained_ms_per_tick": chain1_ms / K,
        "qp_gap_max": float(np.asarray(diag[0]).max()),
        "qp_primal_res_max": float(np.asarray(diag[1]).max()),
        "tau_grav_vs_cpu": dg,
        "tau_cmd_vs_cpu": dc,
    }))


if __name__ == "__main__":
    main()
