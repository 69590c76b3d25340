"""Speed-of-light accounting for the FULL fused control tick.

FK + point jacobians + world-origin CRBA + A⁻¹ + contact space + JKT +
constraint assembly + all three IPM QPs (BASELINE.md: "per-chip
speed-of-light for the dynamics and QP kernels").

FLOP counting: XLA's pre-optimization cost analysis of FusedTick's
element-leading program (ops/tick_kernel.py) on the CPU is a count of the
arithmetic a tick needs per solve (structural zeros already elided by the
program construction).  Counted at the serving shape: warm-start inputs,
warm_iters IPM iterations.

Per-stage split: the same analysis on ``prestage`` alone separates the
dynamics pipeline from the QP chain.

Measured throughput: the serving tick (libdwbc_tpu.backend's choice) in
bench.py's chained-scan shape on the GPU, timed with block_until_ready;
% of peak = solves/s × flops_per_solve ÷ the device's float32 peak outside
the tensor cores (the tick's arithmetic is elementwise; it emits no dots
worth a tensor core).  flops_per_solve is the fused program's count, the
arithmetic a tick needs, so the share is one of needed work, not of what
the serving tick executes.  Peaks come from PEAKS, keyed by device_kind;
a device that is not in the table is an error.

Usage: python benchmarks/sol_tick.py [--batch 1024] [--chain 64]
       [--warm-iters 7] [--flops-only]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# Published peaks per device_kind (dense, full power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(
        f32_flops=67e12, hbm_bytes_per_s=3.35e12,
        source="NVIDIA H100 SXM data sheet: 67 TFLOP/s FP32 outside the "
               "tensor cores, 3.35 TB/s HBM3",
    ),
}


def peak_for(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(f"no published peak for device_kind {device_kind!r}")
    return PEAKS[device_kind]


def _flops_of(fn, *args, **kwargs):
    """Algorithmic flop count of the traced program (counting only —
    nothing is executed).

    PRE-optimization HLO cost analysis: the post-optimization count is
    inflated by CPU fusion rematerialization (instructions duplicated into
    multiple fusions are counted once per fusion), which says nothing about
    the arithmetic the tick executes.  The pre-opt count is the program as
    written, with structural zeros already elided by the
    element-leading construction."""
    import jax

    lowered = jax.jit(fn, **kwargs).lower(*args)
    cost = lowered.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float(cost["flops"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--chain", type=int, default=64)
    ap.add_argument("--warm-iters", type=int, default=7)
    ap.add_argument("--flops-only", action="store_true",
                    help="count FLOPs only; no device measurement")
    ap.add_argument("--solves-per-sec", type=float, default=None,
                    help="use this measured throughput instead of timing")
    ap.add_argument("-o", "--out", default=os.path.join(
        REPO, "out", "sol_tick.json"))
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from libdwbc_tpu import runtime

    runtime.enable_compile_cache()
    from libdwbc_tpu.wbc.fused import FusedTick
    from libdwbc_tpu.wbc.pipeline import standard_tocabi_config

    model, _ = ge._model_and_tick()
    cfg = standard_tocabi_config(model, qp_iters=12)
    xt = FusedTick(model, cfg, dtype=jnp.float32)

    # ---- FLOP counts (CPU lowering of the identical program) ------------
    B = 8  # count at a tiny batch; flops scale exactly linearly in B
    q, qd, fstars = ge._example_inputs(model)
    qs = jnp.asarray(np.tile(q, (B, 1)), jnp.float32)
    qds = jnp.asarray(np.tile(qd, (B, 1)), jnp.float32)
    fs = tuple(jnp.asarray(np.tile(f, (B, 1)), jnp.float32) for f in fstars)
    warm = xt.init_warm((B,))

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        def warm_tick(qb, fsb, wb):
            q_el = jnp.moveaxis(qb, 0, -1)
            fs_el = tuple(jnp.moveaxis(f, 0, -1) for f in fsb)
            w_el = tuple((jnp.moveaxis(x, 0, -1), jnp.moveaxis(l, 0, -1))
                         for x, l in wb)
            out = xt.prog.tick(q_el, fs_el, warm=w_el, iters=args.warm_iters)
            return out["torque_cmd"], out["warm_out"]

        fl_tick = _flops_of(warm_tick, qs, fs, warm)

        def prestage_only(qb):
            q_el = jnp.moveaxis(qb, 0, -1)
            pre = xt.prog.prestage(q_el)
            return pre["torque_grav"], pre["Ntorques"], pre["Atemp"]

        fl_pre = _flops_of(prestage_only, qs)

    flops_per_solve = fl_tick / B
    flops_pre = fl_pre / B
    flops_qp = flops_per_solve - flops_pre

    # ---- measured throughput -------------------------------------------
    sps = args.solves_per_sec
    peak = None
    if sps is None and not args.flops_only:
        runtime.require_gpu()
        peak = peak_for(runtime.device_info()["kind"])
        _, tick = ge._model_and_tick(qp_iters=12)
        import bench

        K = args.chain
        a = jax.device_put(ge._batch_inputs(model, args.batch, seed=0))
        chained = bench._chain(jax, jnp, tick, model, K, args.warm_iters)
        jax.block_until_ready(chained(*a))
        ts = [bench._timed(jax, chained, *a)[0] for _ in range(3)]
        sps = args.batch * K / float(np.median(ts))

    out = dict(
        metric="fused_tick_speed_of_light",
        config="tocabi33 double-support 2-level HQP, warm serving shape",
        warm_iters=args.warm_iters,
        flops_per_solve=round(flops_per_solve, 1),
        flops_prestage=round(flops_pre, 1),
        flops_qp_chain=round(flops_qp, 1),
    )
    if peak is not None:
        out.update(
            device=runtime.device_info(), card=runtime.card_line(),
            f32_peak_flops=peak["f32_flops"], peak_source=peak["source"],
            flop_bound_solves_per_sec=peak["f32_flops"] / flops_per_solve,
        )
    if sps is not None:
        out.update(
            solves_per_sec=sps,
            achieved_gflops=sps * flops_per_solve / 1e9,
        )
        if peak is not None:
            out["pct_of_f32_peak"] = (
                100.0 * sps * flops_per_solve / peak["f32_flops"])
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
