"""Smoke test of the WBC serving path on one GPU, end to end.

    python chip_smoke.py                # one GPU
    python chip_smoke.py --four-cards   # the sharded scenario grid, 4 GPUs

One GPU, at the full width of the 33-DoF Tocabi (double support, the 2-level
HQP of standard_tocabi_config, f32), through the entry points a user calls:

  1. device: asserts JAX's platform is 'gpu'; prints device_kind and the
     card's name and power limit (nvidia-smi);
  2. compile: the serving tick (libdwbc_tpu.backend's choice) at B=1024 and
     B=1, warm-started, with compile times and memory_analysis();
  3. truth: 8 scenarios, the card's f32 tick against CompiledTick at f64 on
     the CPU backend (the reference formulation): τ_grav within 1e-2 Nm,
     τ_cmd within 5e-2 Nm;
  4. pin: CompiledTick on the card at f32 against the same f64 truth — the
     package's float32 matmul pin keeps its dots out of TF32;
  5. serve: K=256 warm-started ticks at B=1024 chained on device, and a
     make_control_loop run of 1000 ticks at B=1 with gap_fallback armed;
     both finite with zero qp_error lanes; solves/s, and p50/p99 per-call
     latency of the B=1 tick with the host in the loop;
  6. card tests: the tests marked `gpu`, in a child process that runs
     before this process touches the card.

No hand-written kernel serves (libdwbc_tpu/backend.py), so there is no
kernel-against-XLA phase.

--four-cards runs only the sharded serving-tick step over a 4-GPU mesh and
the same program on one GPU (__graft_entry__.sharded_parity, < 1e-2 Nm).

Any failure exits non-zero.  The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

TOL_GRAV = 1e-2   # Nm: f32 against f64 on ~100 Nm torques (pre-QP algebra)
TOL_CMD = 5e-2    # Nm: the QP optimum is a face; formulations may land on
                  # different points of it (CLAUDE.md "Flat-face torques")
GAP_FALLBACK = 1e-4   # above a healthy warm f32 gap (≲1e-6), below qp_fail_gap
WARM_ITERS = 7


def log(msg):
    print(msg, flush=True)


def _np(x):
    return np.asarray(x)


def _maxdiff(a, b):
    return float(np.abs(_np(a).astype(np.float64) - _np(b)).max())


def warm_step(tick):
    import jax

    return jax.jit(lambda q, qd, fs, w: tick._tick_impl(
        q, qd, fs, warm=w, qp_iters=WARM_ITERS))


def phase_compile(tick, model, batches=(1024, 1)):
    """Compile the warm serving step at each batch; returns {B: (exe, args)}."""
    import __graft_entry__ as ge

    step = warm_step(tick)
    out = {}
    for B in batches:
        q, qd, fs = ge._batch_inputs(model, B, seed=1)
        if B == 1:
            q, qd, fs = q[0], qd[0], tuple(f[0] for f in fs)
        w = tick.init_warm(q.shape[:-1])
        t0 = time.perf_counter()
        exe = step.trace(q, qd, fs, w).lower().compile()
        dt = time.perf_counter() - t0
        log(f"compile B={B}: {dt:.1f} s, memory_analysis: "
            f"{exe.memory_analysis()}")
        out[B] = (exe, (q, qd, fs, w))
    return out


def reference_f64(model, q, qd, fs):
    """CompiledTick at f64 on the CPU backend (cold, 12 IPM iterations)."""
    import jax
    import jax.numpy as jnp

    from libdwbc_tpu.wbc.pipeline import CompiledTick, standard_tocabi_config

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True):
        tick = CompiledTick(model, standard_tocabi_config(model, qp_iters=12),
                            dtype=jnp.float64)
        args = jax.device_put(
            (q.astype(np.float64), qd.astype(np.float64),
             tuple(f.astype(np.float64) for f in fs)), cpu)
        r = jax.jit(lambda *a: tick._tick_impl(*a, qp_iters=12))(*args)
        return _np(r.torque_grav), _np(r.torque_cmd)


def phase_truth(tick, model, n=8, label="truth"):
    """The tick's f32 result on the default device against the f64 CPU
    reference on n scenarios; raises beyond the tolerances."""
    import jax

    import __graft_entry__ as ge

    q, qd, fs = ge._batch_inputs(model, n, seed=2)
    r = jax.jit(lambda *a: tick._tick_impl(*a, qp_iters=12))(q, qd, fs)
    g64, c64 = reference_f64(model, q, qd, fs)
    dg, dc = _maxdiff(r.torque_grav, g64), _maxdiff(r.torque_cmd, c64)
    log(f"{label}: max|Δτ_grav| {dg:.3e} Nm, max|Δτ_cmd| {dc:.3e} Nm "
        f"(f32 {type(tick).__name__} vs f64 CompiledTick on the CPU)")
    if not (dg < TOL_GRAV and dc < TOL_CMD):
        raise AssertionError(f"{label}: τ_grav {dg} / τ_cmd {dc} beyond "
                             f"{TOL_GRAV} / {TOL_CMD}")
    return dg, dc


def phase_pin(model, n=8):
    """CompiledTick's dots on the device at f32 under the package's
    float32 matmul pin, against the f64 CPU truth."""
    import jax
    import jax.numpy as jnp

    from libdwbc_tpu.wbc.pipeline import CompiledTick, standard_tocabi_config

    prec = jax.config.jax_default_matmul_precision
    if prec != "float32":
        raise AssertionError(f"matmul precision pin is {prec!r}")
    tick = CompiledTick(model, standard_tocabi_config(model, qp_iters=12),
                        dtype=jnp.float32)
    return phase_truth(tick, model, n=n, label="pin (CompiledTick f32)")


def phase_warm_chain(tick, model, B=1024, K=256):
    """K warm-started ticks at batch B chained on device (bench.py's
    serving shape); returns solves/s.  Finite, zero qp_error lanes."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge

    nd = model.model_dof

    @jax.jit
    def chain(q0, qd0, fs):
        w0 = tick.init_warm(q0.shape[:-1])
        r0, w = tick._tick_impl(q0, qd0, fs, warm=w0, qp_iters=12)

        def body(carry, _):
            q, w = carry
            r, w = tick._tick_impl(q, qd0, fs, warm=w, qp_iters=WARM_ITERS)
            q = q.at[:, 6:6 + nd].add(1e-6 * jnp.tanh(r.torque_cmd))
            return (q, w), (jnp.sum(r.qp_error),
                            jnp.all(jnp.isfinite(r.torque_cmd)))

        (q, _), (errs, fin) = jax.lax.scan(body, (q0, w), None, length=K - 1)
        return q, jnp.sum(errs) + jnp.sum(r0.qp_error), jnp.all(fin)

    args = jax.device_put(ge._batch_inputs(model, B, seed=3))
    jax.block_until_ready(chain(*args))
    t0 = time.perf_counter()
    q, errs, fin = jax.block_until_ready(chain(*args))
    dt = time.perf_counter() - t0
    sps = B * K / dt
    log(f"warm chain: {K} ticks at B={B} in {dt * 1e3:.3f} ms → "
        f"{sps:.1f} solves/s; qp_error lanes {int(errs)}")
    if not (bool(fin) and np.isfinite(_np(q)).all()):
        raise AssertionError("warm chain: non-finite torques or state")
    if int(errs):
        raise AssertionError(f"warm chain: {int(errs)} qp_error lane-ticks")
    return sps


def phase_loop(tick, model, n_ticks=1000):
    """make_control_loop at B=1, warm-started, gap_fallback armed."""
    import jax

    import __graft_entry__ as ge
    from libdwbc_tpu.wbc.loop import make_control_loop

    loop = make_control_loop(tick, K=n_ticks, warm_start=True,
                             warm_iters=WARM_ITERS, gap_fallback=GAP_FALLBACK)
    q, qd, fs = ge._example_inputs(model)
    jax.block_until_ready(loop(q, qd, fs))
    t0 = time.perf_counter()
    out = jax.block_until_ready(loop(q, qd, fs))
    dt = time.perf_counter() - t0
    errs = int(_np(out.qp_error).sum())
    log(f"control loop: {n_ticks} ticks at B=1 in {dt * 1e3:.3f} ms "
        f"({dt / n_ticks * 1e3:.4f} ms/tick on device); qp_error ticks {errs}")
    if not np.isfinite(_np(out.torques)).all():
        raise AssertionError("control loop: non-finite torques")
    if errs:
        raise AssertionError(f"control loop: {errs} qp_error ticks")
    return dt / n_ticks


def phase_latency(compiled, n_calls=300):
    """p50/p99 per call of the B=1 warm tick, host in the loop."""
    import jax

    exe, (q, qd, fs, w) = compiled[1]
    r, w = exe(q, qd, fs, w)
    jax.block_until_ready(r)
    lat = []
    for _ in range(n_calls):
        t0 = time.perf_counter()
        r, w = exe(q, qd, fs, w)
        jax.block_until_ready(r)
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat) * 1e3
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    log(f"B=1 latency, host in the loop: p50 {p50:.4f} ms, p99 {p99:.4f} ms "
        f"over {n_calls} calls")
    return p50, p99


def phase_card_tests():
    """The tests marked `gpu`, in a child process (run before this process
    opens the card, so one process uses it at a time)."""
    env = dict(os.environ, DWBC_TEST_PLATFORM="gpu")
    rc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p",
         "no:cacheprovider", "tests/"],
        env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
    ).returncode
    if rc != 0:
        raise AssertionError(f"card tests failed (pytest rc={rc})")


def run_one_card():
    from libdwbc_tpu import runtime

    runtime.card_line()            # no NVIDIA card: fail before any phase
    phase_card_tests()
    import jax

    runtime.enable_compile_cache()
    runtime.require_gpu()
    d = jax.devices()[0]
    log(f"device: {d.platform} {d.device_kind}, {len(jax.devices())} visible")
    log(f"card: {runtime.card_line()}")

    import __graft_entry__ as ge

    model, tick = ge._model_and_tick(qp_iters=12)
    log(f"serving tick: {type(tick).__name__}")
    compiled = phase_compile(tick, model)
    phase_truth(tick, model)
    phase_pin(model)
    phase_warm_chain(tick, model)
    phase_loop(tick, model)
    phase_latency(compiled)
    log(runtime.card_line())


def run_four_cards():
    import jax

    import __graft_entry__ as ge
    from libdwbc_tpu import runtime

    runtime.enable_compile_cache()
    runtime.require_gpu()
    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, have {len(jax.devices())}")
    log(f"card: {runtime.card_line()}")
    r = ge.sharded_parity(4)
    log(f"sharded vs one card: {json.dumps(r)}")
    log(runtime.card_line())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded scenario grid on 4 GPUs")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.four_cards:
        run_four_cards()
    else:
        run_one_card()
    from libdwbc_tpu import runtime

    print(json.dumps({"ok": True, "device": runtime.device_info()}), flush=True)


if __name__ == "__main__":
    main()
