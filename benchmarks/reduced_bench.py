"""Reduced-vs-full pipeline throughput on the serving shape, on one GPU.

The reference motivates its `_R` path as "Time-Efficient Contact Consistent
Whole-Body Control" and measures full-vs-reduced per-stage timings in
tests/sp_test/redu_dyn_test.cpp:302-326 and the 18-45 DoF sweep in
tests/sp_test/dof_comparison.cpp.  This harness is the serving-shape
analog: both pipelines as compiled batched warm-started chained ticks
(the exact bench.py methodology: K on-device chained ticks, timed with
block_until_ready), same model, same contact/task config.  It compiles the
reference's URDFs, so it needs the reference tree.

Writes out/reduced_bench.json (or --out):
  per topology: {model_dof, reduced_dof, full_solves_s, reduced_solves_s,
                 speedup, tau_grav_xcheck, gaps}

Run:  python benchmarks/reduced_bench.py [--out FILE] [--dof45] [--k K]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _chained(jax, jnp, tick, model, K, warm_iters):
    """Warm-started K-tick on-device chain (bench.py serving shape)."""

    @jax.jit
    def chain(q0, qd0, fstars_):
        warm0 = tick.init_warm((q0.shape[0],))
        res0, warm = tick._tick_impl(q0, qd0, fstars_, warm=warm0, qp_iters=12)
        dq = 1e-6 * jnp.tanh(res0.torque_cmd[:, : model.model_dof])
        q1 = q0.at[:, 6 : 6 + model.model_dof].add(dq)

        def body(carry, _):
            qq, qqd, w = carry
            res, w = tick._tick_impl(qq, qqd, fstars_, warm=w,
                                     qp_iters=warm_iters)
            dq = 1e-6 * jnp.tanh(res.torque_cmd[:, : model.model_dof])
            qq = qq.at[:, 6 : 6 + model.model_dof].add(dq)
            return (qq, qqd, w), (jnp.max(res.qp_gap), jnp.max(res.qp_primal_res))

        (qq, _, _), diag = jax.lax.scan(body, (q1, qd0, warm), None,
                                        length=K - 1)
        return qq, diag

    return chain


def bench_tick(jax, jnp, tick, model, qs, qds, fs, K, warm_iters, repeats=3):
    chain = _chained(jax, jnp, tick, model, K, warm_iters)
    q_d = jax.device_put(qs)
    qd_d = jax.device_put(qds)
    fs_d = tuple(jax.device_put(f) for f in fs)
    qq, diag = chain(q_d, qd_d, fs_d)
    jax.block_until_ready(qq)  # compile + warm
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        qq, diag = chain(q_d, qd_d, fs_d)
        jax.block_until_ready(qq)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    per_tick = dt / K
    assert np.isfinite(np.asarray(qq)).all()
    return dict(
        solves_s=qs.shape[0] / per_tick,
        gap_max=float(np.asarray(diag[0]).max()),
        pres_max=float(np.asarray(diag[1]).max()),
        spread=float((max(times) - min(times)) / dt),
    )


def run_topology(jax, jnp, urdf, name, K, warm_iters, B=1024):
    from libdwbc_tpu.model.compile import compile_urdf
    from libdwbc_tpu.wbc import types as T
    from libdwbc_tpu.wbc.pipeline import CompiledTick, PipelineConfig
    from libdwbc_tpu.wbc.reduced_tick import ReducedTick

    model = compile_urdf(urdf, floating=True)
    foot = dict(
        contact_type=T.CONTACT_6D,
        contact_point=np.array([0.03, 0.0, -0.1585]),
        contact_direction=np.array([0.0, 0.0, 1.0]),
        plane_x=0.15, plane_y=0.075, active=True,
    )
    lf = model.body_index("l_ankleroll_link")
    rf = model.body_index("r_ankleroll_link")
    ub = model.body_index("upperbody_link")
    cfg = PipelineConfig(
        contacts=(T.ContactDef(link=lf, **foot), T.ContactDef(link=rf, **foot)),
        task_specs=(((T.TASK_LINK_6D, 0),), ((T.TASK_LINK_ROTATION, ub),)),
        torque_limit=np.full(model.model_dof, 300.0),
        qp_iters=12,
    )
    import jax.numpy as jnp_

    full = CompiledTick(model, cfg, dtype=jnp_.float32)
    red = ReducedTick(model, cfg, dtype=jnp_.float32, tangential_weight=False)

    rng = np.random.default_rng(0)
    q = np.zeros(model.nq, np.float32)
    q[2] = 0.92983
    q[model.nq - 1] = 1.0
    # bent-knee double-support pose (the validated DoF-sweep configuration;
    # a straight-leg zero pose sits at the knee singularity and the QPs
    # fight unsolvable torque demands)
    q[6 : 6 + 12] = np.array([0, 0, -0.24, 0.6, -0.36, 0] * 2, np.float32)
    qs = np.tile(q, (B, 1)).astype(np.float32)
    qs[:, 6 : 6 + model.model_dof] += 0.02 * rng.standard_normal(
        (B, model.model_dof)
    ).astype(np.float32)
    qds = np.zeros((B, model.ndof), np.float32)
    fs = tuple(
        np.tile(f, (B, 1)).astype(np.float32)
        for f in (np.array([0.1, 0.5, 0.1, 0.1, -0.1, 0.1]),
                  np.array([0.1, -0.1, 0.1]))
    )

    r_full = bench_tick(jax, jnp, full, model, qs, qds, fs, K, warm_iters)
    r_red = bench_tick(jax, jnp, red, model, qs, qds, fs, K, warm_iters)

    # cross-formulation truth: τ_grav identical linear algebra in different
    # coordinates — anything beyond f32 roundoff is a bug
    nchk = 8
    res_f = full._tick_impl(
        jax.device_put(qs[:nchk]), jax.device_put(qds[:nchk]),
        tuple(jax.device_put(f[:nchk]) for f in fs), qp_iters=12,
    )
    res_r = red._tick_impl(
        jax.device_put(qs[:nchk]), jax.device_put(qds[:nchk]),
        tuple(jax.device_put(f[:nchk]) for f in fs), qp_iters=12,
    )
    dg = float(np.abs(np.asarray(res_f.torque_grav)
                      - np.asarray(res_r.torque_grav)).max())
    assert dg < 0.05, f"reduced τ_grav diverges from full: {dg}"
    return dict(
        name=name,
        model_dof=model.model_dof,
        reduced_model_dof=red.ridx.reduced_model_dof,
        nc_dof=red.ridx.nc_dof,
        full_solves_s=round(r_full["solves_s"], 1),
        reduced_solves_s=round(r_red["solves_s"], 1),
        speedup=round(r_red["solves_s"] / r_full["solves_s"], 3),
        full_gap_max=r_full["gap_max"],
        reduced_gap_max=r_red["gap_max"],
        full_pres_max=r_full["pres_max"],
        reduced_pres_max=r_red["pres_max"],
        run_spread_full=round(r_full["spread"], 4),
        run_spread_reduced=round(r_red["spread"], 4),
        tau_grav_xcheck=round(dg, 6),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        REPO, "out", "reduced_bench.json"))
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--warm-iters", type=int, default=7)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--dof45", action="store_true",
                    help="also run the 45-DoF sweep topology")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from libdwbc_tpu import runtime

    runtime.enable_compile_cache()
    runtime.require_gpu()
    rows = [run_topology(
        jax, jnp, "/root/reference/tests/dyros_tocabi.urdf", "tocabi33",
        args.k, args.warm_iters, B=args.batch,
    )]
    if args.dof45:
        rows.append(run_topology(
            jax, jnp, "/root/reference/tests/dof_test/dyros_tocabi_dof45.urdf",
            "dof45", args.k, args.warm_iters, B=args.batch,
        ))
    out = dict(
        device=runtime.device_info(), card=runtime.card_line(),
        batch=args.batch, chained_ticks=args.k, warm_iters=args.warm_iters,
        rows=rows,
    )
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
