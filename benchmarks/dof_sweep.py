"""DoF-sweep harness: full vs reduced pipeline across 18–45-DoF models.

Equivalent of the reference's dof_comparison executable
(/root/reference/tests/sp_test/dof_comparison.cpp): compile each URDF in the
reference's dof_test family, run the full and reduced OSF-HQP pipelines, and
report per-stage timings + torque similarity.

Usage:  python benchmarks/dof_sweep.py [-r repeats] [--dofs 18,27,33,45]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DOF_DIR = "/root/reference/tests/dof_test"


def run_one(urdf: str, repeats: int):
    import jax
    import jax.numpy as jnp

    from libdwbc_tpu.model.compile import compile_urdf
    from libdwbc_tpu.wbc import types as T
    from libdwbc_tpu.wbc.robot import RobotData

    rd = RobotData(dtype=jnp.float64)
    rd.model = compile_urdf(urdf, floating=True)
    from libdwbc_tpu.kin.engine import Kinematics

    rd.kin = Kinematics(rd.model)
    mdof = rd.model_dof_

    # Standard legs-first config: contacts on the 6th body of each leg chain
    rd.AddContactConstraint(6, T.CONTACT_6D, [0.03, 0, -0.1585], [0, 0, 1], 0.15, 0.075)
    rd.AddContactConstraint(12, T.CONTACT_6D, [0.03, 0, -0.1585], [0, 0, 1], 0.15, 0.075)
    rd.AddTaskSpace(0, T.TASK_LINK_6D, 0, np.zeros(3))
    if rd.model.nbody > 15:
        rd.AddTaskSpace(1, T.TASK_LINK_ROTATION, 15, np.zeros(3))
    rd.SetTorqueLimit(np.full(mdof, 300.0))

    q = np.zeros(rd.model.nq)
    q[2] = 0.92983
    q[rd.model.ndof] = 1.0
    legs = [0.0, 0.0, -0.24, 0.6, -0.36, 0.0] * 2
    q[6 : 6 + 12] = legs
    rd.UpdateKinematics(q, np.zeros(rd.model.ndof))
    rd.SetContact(True, True)
    rd.SetTaskSpace(0, np.array([0.1, 0.4, 0.1, 0.1, -0.1, 0.1]))
    if len(rd.ts_) > 1:
        rd.SetTaskSpace(1, np.array([0.1, -0.1, 0.1]))

    def full():
        rd.CalcContactConstraint()
        rd.CalcGravCompensation()
        rd.CalcTaskControlTorque(True)
        rd.CalcContactRedistribute(True)
        return rd.torque_command()

    def reduced():
        # Like-for-like vs the full path: the reference's reduced
        # redistribution uses a *tangential-weighted* objective
        # (CalcContactRedistributeR, src/dwbc.cpp:4814-4848) whose optimum
        # differs from the full path's min-‖f_c,red‖² by a pure in-span(NwJw)
        # internal redistribution (zero task-space effect).  The similarity
        # column compares the same objective on both sides, matching
        # redu_dyn_test.cpp:324-326's ≈0 expectation; the objective
        # difference is reported separately as an in-span residual.
        rd.ReducedDynamicsCalculate()
        rd.ReducedCalcContactConstraint()
        rd.ReducedCalcGravCompensation()
        rd.ReducedCalcTaskControlTorque(True)
        rd.ReducedCalcContactRedistribute(True, tangential_weight=False)
        return rd.torque_command()

    def lqp():
        rd.CalcContactConstraint()
        rd.CalcGravCompensation()
        rd.ConfigureLQP()
        return rd.CalcControlTorqueLQP()

    def lqp_r():
        # Full reduced-LQP sequence incl. the nc cascade, matching the
        # reference harness (tests/sp_test/dof_comparison.cpp:209-252):
        # ConfigureLQP_R → CalcControlTorqueLQP_R → jacc from the reduced
        # solution → ConfigureLQP_R_NC(jacc) → CalcControlTorqueLQP_R_NC,
        # which recomposes the nc-task torque into torque_lqp_.
        rd.ReducedDynamicsCalculate()
        if getattr(rd, "_reduced_degenerate", False):
            rd.CalcContactConstraint()
            rd.CalcGravCompensation()
            rd.ConfigureLQP()
            return rd.CalcControlTorqueLQP()
        rd.ReducedCalcContactConstraint()
        rd.ReducedCalcGravCompensation()
        rd.ReducedCalcTaskSpace()
        rd.ConfigureLQP_R()
        rd.CalcControlTorqueLQP_R()
        q_acc_R = rd.lqp_r_result.y[: rd._ridx.reduced_system_dof]
        rd.ConfigureLQP_R_NC(q_acc_R)
        rd.CalcControlTorqueLQP_R_NC()
        return np.asarray(rd.torque_lqp_)

    def timed(fn):
        tau = fn()  # compile/warm
        t0 = time.perf_counter()
        for _ in range(repeats):
            tau = fn()
        return tau, (time.perf_counter() - t0) / repeats

    tau_f, t_full = timed(full)
    tg_f = np.asarray(rd.torque_grav_)
    tt_f = np.asarray(rd.torque_task_)
    NwJw_f = np.asarray(rd.cspace.NwJw)

    tau_r, t_red = timed(reduced)
    tg_r = np.asarray(rd.torque_grav_)
    tt_r = np.asarray(rd.torque_task_)

    # span(NwJw) residual of the command difference: any Δτ_cmd lying in
    # span(NwJw) is an internal contact-force redistribution with ZERO
    # task-space effect (flat-face indeterminacy, see CLAUDE.md); what is
    # NOT in span is real disagreement.
    dtau = np.asarray(tau_f) - np.asarray(tau_r)
    if NwJw_f.size:
        coef, *_ = np.linalg.lstsq(NwJw_f, dtau, rcond=None)
        span_resid = float(np.linalg.norm(dtau - NwJw_f @ coef))
    else:
        span_resid = float(np.linalg.norm(dtau))

    tau_l, t_lqp = timed(lqp)
    tau_lr, t_lqp_r = timed(lqp_r)

    return dict(
        urdf=os.path.basename(urdf),
        model_dof=mdof,
        reduced_dof=rd._ridx.reduced_model_dof,
        t_full_ms=round(t_full * 1e3, 2),
        t_reduced_ms=round(t_red * 1e3, 2),
        ratio=round(t_red / t_full, 3),
        torque_similarity=float(np.linalg.norm(dtau)),
        tau_grav_diff=float(np.abs(tg_f - tg_r).max()),
        tau_task_diff=float(np.abs(tt_f - tt_r).max()),
        dtau_span_nwjw_resid=span_resid,
        t_lqp_ms=round(t_lqp * 1e3, 2),
        t_lqp_r_ms=round(t_lqp_r * 1e3, 2),
        lqp_ratio=round(t_lqp_r / t_lqp, 3),
        # full-LQP vs reduced-LQP(+nc cascade) are different optimization
        # programs (the reference harness compares their *timings* only);
        # the norm is recorded for trend-watching, not asserted ≈0.
        lqp_torque_similarity=float(
            np.linalg.norm(np.asarray(tau_l) - np.asarray(tau_lr))
        ),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-r", "--repeats", type=int, default=3)
    ap.add_argument("--dofs", type=str, default="")
    ap.add_argument("-o", "--out", type=str, default="",
                    help="also write all rows to this JSON artifact")
    args = ap.parse_args()

    # the sweep runs f64 pipelines: CPU with x64
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from libdwbc_tpu import runtime

    # persistent compilation cache: a resumed/re-run sweep skips the jits
    runtime.enable_compile_cache()

    urdfs = sorted(glob.glob(os.path.join(DOF_DIR, "*.urdf")))
    if args.dofs:
        want = {d.strip() for d in args.dofs.split(",")}
        urdfs = [u for u in urdfs if any(f"dof{d}.urdf" in u for d in want)]
    if not urdfs:
        print(json.dumps({"error": f"no URDFs found under {DOF_DIR}"}))
        return

    # resume: keep rows already recorded in the artifact (the full f64 sweep
    # is compile-bound; an interrupted run should not redo finished models)
    rows = []
    done = set()
    if args.out and os.path.exists(args.out):
        try:
            with open(args.out) as f:
                rows = [r for r in json.load(f)["rows"] if "error" not in r]
            done = {r["urdf"] for r in rows}
        except Exception:
            rows, done = [], set()

    for u in urdfs:
        if os.path.basename(u) in done:
            continue
        try:
            row = run_one(u, args.repeats)
        except Exception as e:  # noqa: BLE001 — sweep should report, not die
            row = {"urdf": os.path.basename(u), "error": str(e)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        if args.out:  # incremental write: partial sweeps still leave data
            with open(args.out, "w") as f:
                json.dump({"repeats": args.repeats, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
