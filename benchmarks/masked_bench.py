"""Masked multi-hypothesis serving bench — BASELINE config 5's shape.

4096 scenarios, each a (state, support-hypothesis) pair over the two-foot
candidate set {both, left, right}, solved per tick by ONE masked tick (the
serving one, libdwbc_tpu.backend.serving_tick(masked=True)) with warm-start
carry — the persistent hot-start analog of
the reference's per-hierarchy qpOASES solvers (include/dwbc.h:222-228), at
hypothesis-sweep scale the reference cannot express (its SetContact resizes
matrices per mode, include/dwbc.h:432-474).

Methodology identical to bench.py (chained on-device scan, timed with
block_until_ready).  Needs a GPU.

Usage: python benchmarks/masked_bench.py [--fused] [-B 4096] [-K 32]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-B", type=int, default=4096)
    ap.add_argument("-K", type=int, default=32)
    ap.add_argument("--warm-iters", type=int, default=7)
    ap.add_argument("--fused", action="store_true",
                    help="also time FusedTick(masked=True) for comparison "
                         "(on the GPU its compile runs for many minutes)")
    ap.add_argument("--switch", action="store_true",
                    help="also time the per-mode lax.switch formulation "
                         "(parallel/hypotheses.py) for comparison")
    ap.add_argument("--switch-batch", type=int, default=512)
    ap.add_argument("--fallback", action="store_true",
                    help="also time the warm serving chain with the per-lane "
                         "gap_fallback safety net armed (wbc/loop.py)")
    ap.add_argument("--out", default=None,
                    help="write all results to this JSON artifact")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from libdwbc_tpu import runtime
    from libdwbc_tpu.model.compile import RobotModel

    runtime.enable_compile_cache()
    runtime.require_gpu()
    card = runtime.card_line()
    from libdwbc_tpu.wbc.pipeline import standard_tocabi_config

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = RobotModel.load(os.path.join(here, "models", "tocabi.npz"))
    cfg = standard_tocabi_config(model, qp_iters=12)

    B, K = args.B, args.K
    rng = np.random.default_rng(0)
    q = np.zeros(model.nq, np.float32)
    q[2] = 0.92983
    q[model.ndof] = 1.0
    q[6:18] = np.array([0, 0, -0.24, 0.6, -0.36, 0] * 2, np.float32)
    qs = np.tile(q, (B, 1))
    qs[:, 6:39] += 0.02 * rng.standard_normal((B, 33)).astype(np.float32)
    qds = np.zeros((B, model.ndof), np.float32)
    f1 = np.tile(np.array([0.1, 0.3, 0.1, 0, 0, 0], np.float32), (B, 1))
    f2 = np.tile(np.array([0.05, 0, 0], np.float32), (B, 1))
    # hypothesis grid: both/left/right support, cycled across scenarios
    mask_set = np.array([[1, 1], [1, 0], [0, 1]], np.float32)
    masks = mask_set[np.arange(B) % 3]

    def run(tick, label):
        @jax.jit
        def chained(q0, qd0, fs, cm):
            warm0 = tick.init_warm((q0.shape[0],))
            res0, warm = tick._tick_impl(q0, qd0, fs, cm, warm=warm0,
                                         qp_iters=12)
            dq = 1e-6 * jnp.tanh(res0.torque_cmd)
            q1 = q0.at[:, 6:39].add(dq)

            def body(carry, _):
                qq, w = carry
                res, w = tick._tick_impl(qq, qd0, fs, cm, warm=w,
                                         qp_iters=args.warm_iters)
                qq = qq.at[:, 6:39].add(1e-6 * jnp.tanh(res.torque_cmd))
                return (qq, w), (jnp.max(res.qp_gap), jnp.max(res.qp_primal_res))

            (qq, _), diag = jax.lax.scan(body, (q1, warm), None, length=K - 1)
            return qq, diag

        a = (jax.device_put(qs), jax.device_put(qds),
             (jax.device_put(f1), jax.device_put(f2)), jax.device_put(masks))
        qq, diag = chained(*a)
        jax.block_until_ready(qq)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            qq, diag = chained(*a)
            jax.block_until_ready(qq)
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        per_tick = dt / K
        out = dict(
            metric=f"masked_hypothesis_solves_per_sec_{label}",
            value=B / per_tick,
            device=runtime.device_info(), card=card,
            unit="solves/s",
            batch=B, chained_ticks=K, warm_iters=args.warm_iters,
            run_spread=round((max(times) - min(times)) / dt, 4),
            qp_gap_max=float(np.asarray(diag[0]).max()),
            qp_primal_res_max=float(np.asarray(diag[1]).max()),
        )
        print(json.dumps(out), flush=True)
        return out

    results = []
    from libdwbc_tpu.backend import serving_tick

    ft = serving_tick(model, cfg, dtype=jnp.float32, masked=True)
    serving_row = run(ft, "serving")
    results.append(serving_row)

    if args.fallback:
        # the serving shape WITH the per-lane gap_fallback safety net armed
        # (wbc/loop.py::make_control_loop): healthy limit-riding lanes must
        # not trip it (cap-aware normalized complementarity, ops/qp.py),
        # so the warm-chain throughput cost should be the price of the
        # untaken lax.cond branch, not a permanent full-budget re-solve.
        from libdwbc_tpu.wbc.loop import make_control_loop

        def _advance(q, qdot, res, dt):
            return q.at[:, 6:39].add(1e-6 * jnp.tanh(res.torque_cmd)), qdot

        loop = make_control_loop(
            ft, transition=_advance, K=K, warm_start=True,
            warm_iters=args.warm_iters, gap_fallback=1e-3,
        )
        a = (jax.device_put(qs), jax.device_put(qds),
             (jax.device_put(f1), jax.device_put(f2)), jax.device_put(masks))
        lr = loop(*a)
        jax.block_until_ready(lr)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            lr = loop(*a)
            jax.block_until_ready(lr)
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        per_tick = dt / K
        val = round(B / per_tick, 1)
        out = dict(
            metric="masked_hypothesis_solves_per_sec_serving_fallback",
            value=val,
            unit="solves/s",
            batch=B, chained_ticks=K, warm_iters=args.warm_iters,
            gap_fallback=1e-3,
            run_spread=round((max(times) - min(times)) / dt, 4),
            qp_error_ticks=int(np.asarray(lr.qp_error).sum()),
            qp_primal_res_max=float(np.asarray(lr.qp_primal_res).max()),
            fallback_cost_vs_plain=round(
                1.0 - val / serving_row["value"], 4
            ),
        )
        print(json.dumps(out), flush=True)
        results.append(out)

    if args.fused:
        from libdwbc_tpu.wbc.fused import FusedTick

        results.append(run(FusedTick(model, cfg, dtype=jnp.float32,
                                     masked=True), "fused"))

    if args.switch:
        # per-mode lax.switch comparison (parallel/hypotheses.py): under
        # vmap every branch executes for every scenario — the cost the
        # masked single-graph formulation avoids.
        #
        # Like-for-like protocol: both
        # formulations are timed COLD (full 12-iter budget every tick),
        # same batch, same K-tick on-device chained scan.  Cold because the
        # switch path structurally cannot carry warm state: each mode's QP
        # warm pytree has different shapes (cfree=6 vs 0 ⇒ different slot
        # widths), so a per-scenario warm carry across lax.switch branches
        # has no common carry structure; the masked single-graph
        # formulation is exactly what removes that obstruction.  The warm
        # serving row above is reported separately as the serving number.
        from libdwbc_tpu.parallel.hypotheses import (
            contact_mode_ticks, hypothesis_sweep,
        )

        Bs = min(B, args.switch_batch)
        Ks = max(4, K // 4)
        modes, ticks = contact_mode_ticks(
            model, cfg.contacts, cfg.task_specs, cfg.torque_limit,
            qp_iters=12,
        )
        # map each scenario's mask to its contact_mode_ticks branch index
        order = {tuple(int(b) for b in m): i for i, m in enumerate(modes)}
        midx = np.array(
            [order[tuple(int(x) for x in m)] for m in masks[:Bs]], np.int32
        )

        @jax.jit
        def switch_chained(mi, q0, qd0, fsb):
            def body(qq, _):
                tau, cost, best = hypothesis_sweep(
                    model, modes, ticks, mi, qq, qd0, fsb
                )
                qq = qq.at[:, 6:39].add(1e-6 * jnp.tanh(tau))
                return qq, jnp.max(cost)

            qq, costs = jax.lax.scan(body, q0, None, length=Ks)
            return qq, costs

        aa = (jax.device_put(midx), jax.device_put(qs[:Bs]),
              jax.device_put(qds[:Bs]),
              (jax.device_put(f1[:Bs]), jax.device_put(f2[:Bs])))
        qq, _ = switch_chained(*aa)
        jax.block_until_ready(qq)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            qq, _ = switch_chained(*aa)
            jax.block_until_ready(qq)
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        per_tick = dt / Ks
        out = dict(
            metric="masked_hypothesis_solves_per_sec_switch",
            value=round(Bs / per_tick, 1),
            unit="solves/s",
            batch=Bs, chained_ticks=Ks, warm_iters=None,
            note="lax.switch per-mode ticks (all branches execute under "
                 "vmap); COLD 12-iter solves, chained on-device scan — "
                 "compare against the cold serving row at the same (B, K)",
        )
        print(json.dumps(out), flush=True)
        results.append(out)

        # the apples-to-apples serving row: same batch, same chain, COLD
        @jax.jit
        def serving_cold_chained(q0, qd0, fs, cm):
            def body(qq, _):
                res = ft._tick_impl(qq, qd0, fs, cm, qp_iters=12)
                qq = qq.at[:, 6:39].add(1e-6 * jnp.tanh(res.torque_cmd))
                return qq, (jnp.max(res.qp_gap), jnp.max(res.qp_primal_res))

            qq, diag = jax.lax.scan(body, q0, None, length=Ks)
            return qq, diag

        ac = (jax.device_put(qs[:Bs]), jax.device_put(qds[:Bs]),
              (jax.device_put(f1[:Bs]), jax.device_put(f2[:Bs])),
              jax.device_put(masks[:Bs]))
        qq, diag = serving_cold_chained(*ac)
        jax.block_until_ready(qq)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            qq, diag = serving_cold_chained(*ac)
            jax.block_until_ready(qq)
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        per_tick = dt / Ks
        out = dict(
            metric="masked_hypothesis_solves_per_sec_serving_cold",
            value=round(Bs / per_tick, 1),
            unit="solves/s",
            batch=Bs, chained_ticks=Ks, warm_iters=None,
            qp_gap_max=float(np.asarray(diag[0]).max()),
            qp_primal_res_max=float(np.asarray(diag[1]).max()),
            note="masked serving tick, COLD 12-iter solves, same (B, K) "
                 "as the switch row — THIS ratio is the honest "
                 "masked-vs-switch multiplier",
        )
        print(json.dumps(out), flush=True)
        results.append(out)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(results=results), f, indent=1)


if __name__ == "__main__":
    main()
