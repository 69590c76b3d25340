"""Scenario-batch scaling harness over a device mesh.

Measures solves/s at 1..N devices with the scenario grid sharded over the
('hyp','roll') mesh (BASELINE north-star: ≥80% linear scaling to 2+ hosts).
With --devices native it uses the machine's accelerators (one process
drives them all); by default it runs on N virtual CPU devices to validate
the machinery — absolute numbers there measure host cores, not device
scaling.  --spawn2 starts a second process and therefore stays on the CPU:
a second JAX process cannot share a GPU that the first one holds.

Usage: python benchmarks/scaling.py [-n 8] [-B 512] [--devices cpu|native]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", "--max-devices", type=int, default=8)
    ap.add_argument("-B", "--batch-per-device", type=int, default=256)
    ap.add_argument("--devices", choices=["cpu", "native"], default="cpu")
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host run: jax.distributed.initialize via the "
                         "standard env (JAX_COORDINATOR_ADDRESS) or the "
                         "explicit options below, global ('hyp','roll') mesh, "
                         "per-process local shards. Launch one copy of this "
                         "script per host.")
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address host:port (explicit multi-"
                         "process launch instead of cluster env detection)")
    ap.add_argument("--nprocs", type=int, default=None)
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--cpu-devices", type=int, default=None,
                    help="virtual CPU devices per process (loopback "
                         "validation runs; sets gloo CPU collectives)")
    ap.add_argument("--out", default=None, help="write result JSON here")
    ap.add_argument("--spawn2", action="store_true",
                    help="launch TWO local CPU-only processes over loopback "
                         "(2 virtual CPU devices each): the minimal real "
                         "multi-process validation")
    args = ap.parse_args()

    if args.spawn2:
        return _spawn2(args)

    if args.distributed:
        if args.cpu_devices:
            os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        if args.cpu_devices:
            jax.config.update("jax_platforms", "cpu")
            jax.config.update("jax_num_cpu_devices", args.cpu_devices)
            jax.config.update("jax_cpu_collectives_implementation", "gloo")

        from libdwbc_tpu.parallel.mesh import init_distributed

        init_distributed(coordinator=args.coordinator,
                         num_processes=args.nprocs, process_id=args.pid)
        return _run_distributed(args)
    if args.devices == "cpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.max_devices)
    else:
        import jax

    import jax.numpy as jnp
    import numpy as np

    from libdwbc_tpu.model.compile import RobotModel
    from libdwbc_tpu.parallel.mesh import make_mesh, sharded_batch_solver
    from libdwbc_tpu.wbc.pipeline import CompiledTick, standard_tocabi_config

    model = RobotModel.load(
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "models", "tocabi.npz")
    )
    cfg = standard_tocabi_config(model, qp_iters=8)
    tick = CompiledTick(model, cfg, dtype=jnp.float32)

    rng = np.random.default_rng(0)
    base_q = np.zeros(model.nq, np.float32)
    base_q[2] = 0.92983
    base_q[model.ndof] = 1.0
    base_q[6:18] = np.array([0, 0, -0.24, 0.6, -0.36, 0] * 2, np.float32)

    results = []
    n = 1
    while n <= args.max_devices:
        devs = jax.devices()[:n]
        mesh = make_mesh(devices=devs)
        step, sh = sharded_batch_solver(tick._tick_impl, mesh)
        H = mesh.shape["hyp"]
        R = mesh.shape["roll"] * args.batch_per_device
        qs = np.tile(base_q, (H, R, 1))
        qs[..., 6:39] += 0.01 * rng.standard_normal((H, R, 33)).astype(np.float32)
        qds = np.zeros((H, R, model.ndof), np.float32)
        fs = (
            np.tile(np.array([0.1, 0.3, 0.1, 0, 0, 0], np.float32), (H, R, 1)),
            np.tile(np.array([0.05, 0, 0], np.float32), (H, R, 1)),
        )
        a = (
            jax.device_put(qs, sh), jax.device_put(qds, sh),
            tuple(jax.device_put(f, sh) for f in fs),
        )
        res, best, cost = step(*a)
        jax.block_until_ready(res.torque_cmd)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            res, best, cost = step(*a)
        jax.block_until_ready(res.torque_cmd)
        dt = (time.perf_counter() - t0) / args.iters
        sps = H * R / dt
        results.append(dict(devices=n, grid=[H, R], solves_per_sec=round(sps, 1)))
        n *= 2

    base = results[0]["solves_per_sec"]
    for r in results:
        r["scaling_efficiency"] = round(
            r["solves_per_sec"] / (base * r["devices"]), 3
        )
        print(json.dumps(r))


def _run_distributed(args):
    """Multi-host measurement: one global ('hyp','roll') mesh over every
    process's devices; each process builds only its local scenario shard.
    Per-host efficiency = global solves/s ÷ (hosts × single-host solves/s
    measured the same way) — report the raw number here; compare runs at 1
    and N hosts for the BASELINE ≥80% bar."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from libdwbc_tpu.model.compile import RobotModel
    from libdwbc_tpu.parallel.mesh import (
        host_local_scenarios, make_global_mesh, sharded_batch_solver,
    )
    from libdwbc_tpu.wbc.pipeline import CompiledTick, standard_tocabi_config

    model = RobotModel.load(
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "models", "tocabi.npz")
    )
    cfg = standard_tocabi_config(model, qp_iters=8)
    tick = CompiledTick(model, cfg, dtype=jnp.float32)
    mesh = make_global_mesh()
    step, _ = sharded_batch_solver(tick._tick_impl, mesh)

    H = mesh.shape["hyp"]
    R = mesh.shape["roll"] * args.batch_per_device
    rng = np.random.default_rng(jax.process_index())
    base_q = np.zeros(model.nq, np.float32)
    base_q[2] = 0.92983
    base_q[model.ndof] = 1.0
    base_q[6:18] = np.array([0, 0, -0.24, 0.6, -0.36, 0] * 2, np.float32)

    def make_local(hs, rs):
        h = hs.stop - hs.start
        r = (rs.stop - rs.start) * args.batch_per_device
        qs = np.tile(base_q, (h, r, 1))
        qs[..., 6:39] += 0.01 * rng.standard_normal((h, r, 33)).astype(np.float32)
        qds = np.zeros((h, r, model.ndof), np.float32)
        f0 = np.tile(np.array([0.1, 0.3, 0.1, 0, 0, 0], np.float32), (h, r, 1))
        f1 = np.tile(np.array([0.05, 0, 0], np.float32), (h, r, 1))
        return qs, qds, f0, f1

    qs, qds, f0, f1 = host_local_scenarios(mesh, make_local)
    res, best, cost = step(qs, qds, (f0, f1))
    jax.block_until_ready(res.torque_cmd)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        res, best, cost = step(qs, qds, (f0, f1))
    jax.block_until_ready(res.torque_cmd)
    dt = (time.perf_counter() - t0) / args.iters
    # best/cost come from a CROSS-HOST argmin collective (DCN) — read them
    # on every process (they are fully replicated) to prove the reduction
    out = dict(
        hosts=jax.process_count(),
        process_id=jax.process_index(),
        devices=len(jax.devices()),
        local_devices=jax.local_device_count(),
        mesh={k: int(v) for k, v in mesh.shape.items()},
        grid=[int(H), int(R)],
        solves_per_sec=round(H * R / dt, 1),
        best_hypothesis=int(best),
        best_cost=float(cost),
    )
    print(json.dumps(out), flush=True)
    if args.out and jax.process_index() == 0:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


def _spawn2(args):
    """Launch 2 local processes over loopback.  Both are CPU-only
    (--cpu-devices): one JAX process per GPU, so the pair never opens a
    card."""
    import subprocess

    here = os.path.abspath(__file__)
    out = args.out
    base = [
        sys.executable, here, "--distributed",
        "--coordinator", "localhost:29408", "--nprocs", "2",
        "--cpu-devices", "2",
        "-B", str(args.batch_per_device), "--iters", str(args.iters),
    ]
    p1 = subprocess.Popen(base + ["--pid", "1"],
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    p0 = subprocess.run(base + ["--pid", "0"] + (["--out", out] if out else []),
                        capture_output=True, text=True, timeout=900)
    out1, err1 = p1.communicate(timeout=120)
    if p0.returncode != 0:
        sys.stderr.write(p0.stderr[-4000:])
        sys.exit(p0.returncode)
    print(p0.stdout.strip())
    print(out1.decode().strip())
    if out:
        print(f"artifact: {out}")


if __name__ == "__main__":
    main()
