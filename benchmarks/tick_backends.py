"""Time the tick formulations against each other on one GPU.

Formulations: 'compiled' (CompiledTick, batch-major XLA) and 'fused'
(FusedTick, the element-leading program as one XLA graph).  Each runs in
its own child process, one after the other,
so that one JAX process holds the card at a time and a compile that
overruns its time limit cannot stall the rest; the parent never imports
JAX.

Per formulation, at the serving configuration (33-DoF Tocabi, double
support, 2-level HQP, f32, warm-started at 7 IPM iterations):
  * solves/s at B=1024: warm ticks called from the host, each ended with
    block_until_ready, B / median per-call time;
  * per-tick latency at B=1, host in the loop: p50/p99 per call;
  * lowering and compile seconds, and memory_analysis() of both
    executables;
  * the first warm tick's torques at B=1024, compared across formulations
    (max abs difference, Nm).

    python benchmarks/tick_backends.py [--only compiled,fused] [--timeout S]
                                       [--out DIR]

Writes <name>.json and .npz to out/tick_backends (or --out DIR); prints
one JSON line per formulation and a last line with the cross-formulation
differences.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "out", "tick_backends")


def _build(name, model, cfg):
    import jax.numpy as jnp

    from libdwbc_tpu.wbc.fused import FusedTick
    from libdwbc_tpu.wbc.pipeline import CompiledTick

    cls = {"compiled": CompiledTick, "fused": FusedTick}[name]
    return cls(model, cfg, dtype=jnp.float32)


def child(name, out_dir, n_batch_calls, n_lat_calls, warm_iters):
    sys.path.insert(0, REPO)
    import numpy as np

    import jax

    import __graft_entry__ as ge
    from libdwbc_tpu import runtime

    runtime.enable_compile_cache()
    runtime.require_gpu()
    from libdwbc_tpu.model.compile import RobotModel
    from libdwbc_tpu.wbc.pipeline import standard_tocabi_config

    model = RobotModel.load(ge.MODEL_PATH)

    tick = _build(name, model, standard_tocabi_config(model, qp_iters=12))
    rec = {"name": name, "device": runtime.device_info(),
           "card": runtime.card_line()}
    step = jax.jit(
        lambda q, qd, fs, w: tick._tick_impl(q, qd, fs, warm=w,
                                             qp_iters=warm_iters)
    )

    def compiled_for(B):
        q, qd, fs = ge._batch_inputs(model, B, seed=0)
        w = tick.init_warm((B,) if B > 1 else ())
        if B == 1:
            q, qd, fs = q[0], qd[0], tuple(f[0] for f in fs)
        t0 = time.perf_counter()
        low = step.trace(q, qd, fs, w).lower()
        t1 = time.perf_counter()
        print(json.dumps({name: {f"B{B}_lower_s": t1 - t0}}), flush=True)
        exe = low.compile()
        t2 = time.perf_counter()
        ma = exe.memory_analysis()
        rec[f"B{B}_lower_s"] = t1 - t0
        rec[f"B{B}_compile_s"] = t2 - t1
        rec[f"B{B}_memory"] = {
            k: getattr(ma, k) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")
        } if ma is not None else None
        print(json.dumps({name: {k: rec[k] for k in rec if k.startswith(f"B{B}")}}),
              flush=True)
        return exe, (q, qd, fs, w)

    exe, (q, qd, fs, w) = compiled_for(1024)
    res, w = exe(q, qd, fs, w)
    jax.block_until_ready(res.torque_cmd)
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"{name}.npz"),
             torque_cmd=np.asarray(res.torque_cmd),
             torque_grav=np.asarray(res.torque_grav),
             qp_error=np.asarray(res.qp_error))
    ts = []
    for _ in range(n_batch_calls):
        t0 = time.perf_counter()
        res, w = exe(q, qd, fs, w)
        jax.block_until_ready(res.torque_cmd)
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts)
    rec["B1024_call_ms_median"] = float(np.median(ts) * 1e3)
    rec["B1024_solves_per_s"] = float(1024 / np.median(ts))
    rec["B1024_qp_error_lanes"] = int(np.asarray(res.qp_error).sum())
    print(json.dumps({name: {"B1024_solves_per_s": rec["B1024_solves_per_s"]}}),
          flush=True)

    exe1, (q1, qd1, fs1, w1) = compiled_for(1)
    res1, w1 = exe1(q1, qd1, fs1, w1)
    jax.block_until_ready(res1.torque_cmd)
    lat = []
    for _ in range(n_lat_calls):
        t0 = time.perf_counter()
        res1, w1 = exe1(q1, qd1, fs1, w1)
        jax.block_until_ready(res1.torque_cmd)
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat) * 1e3
    rec["B1_ms_p50"] = float(np.percentile(lat, 50))
    rec["B1_ms_p99"] = float(np.percentile(lat, 99))
    rec["B1_finite"] = bool(np.isfinite(np.asarray(res1.torque_cmd)).all())
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="compiled,fused")
    ap.add_argument("--child")
    ap.add_argument("--out", default=OUT, help="directory for the results")
    ap.add_argument("--batch-calls", type=int, default=50)
    ap.add_argument("--latency-calls", type=int, default=300)
    ap.add_argument("--warm-iters", type=int, default=7)
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds allowed to each formulation's process")
    args = ap.parse_args()
    if args.child:
        child(args.child, args.out, args.batch_calls, args.latency_calls,
              args.warm_iters)
        return
    names = args.only.split(",")
    for name in names:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", name,
               "--out", args.out, "--batch-calls", str(args.batch_calls),
               "--latency-calls", str(args.latency_calls),
               "--warm-iters", str(args.warm_iters)]
        t0 = time.perf_counter()
        try:
            rc = subprocess.run(cmd, timeout=args.timeout).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        print(json.dumps({"formulation": name, "rc": rc,
                          "wall_s": time.perf_counter() - t0}), flush=True)
    import numpy as np

    got = {n: np.load(os.path.join(args.out, f"{n}.npz")) for n in names
           if os.path.exists(os.path.join(args.out, f"{n}.npz"))}
    diffs = {}
    for a in got:
        for b in got:
            if a < b:
                for k in ("torque_grav", "torque_cmd"):
                    diffs[f"{k}:{a}-{b}"] = float(
                        np.abs(got[a][k] - got[b][k]).max())
    print(json.dumps({"max_abs_diff_nm": diffs}), flush=True)


if __name__ == "__main__":
    main()
