"""FusedTick: the whole WBC tick as one element-leading program.

Same _tick_impl / init_warm interface and warm-state pytree shapes as
pipeline.CompiledTick, with the entire tick —
FK, jacobians, world-frame CRBA, A⁻¹, contact space, JKT, constraint
assembly, and all QPs — expressed by ops/tick_kernel.py; this module holds
the plumbing.

The program is traced as one plain XLA graph with the batch trailing.  It
does not serve on the GPU: there its compile takes longer than 420 s
(libdwbc_tpu/backend.py says which tick serves where).

Reference: the per-tick call sequence at /root/reference/src/dwbc.cpp
(SURVEY.md §3.1); golden/cross-formulation parity in
tests/test_fused_tick.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..model.compile import RobotModel
from ..ops.tick_kernel import SERVO_ELEM_SHAPES, TickProgram
from .pipeline import PipelineConfig, TickResult, qp_error_flag


class FusedTick:
    """One fused WBC tick for a fixed configuration.

    API mirrors CompiledTick: __call__(q, qdot, fstars, servos=),
    _tick_impl(..., warm=, qp_iters=, servos=), init_warm(batch).

    servos: the on-device trajectory-PD servo runs INSIDE the fused program
    (tick_kernel.py::_servo_fstar_el; 1e-10 parity vs CompiledTick in
    tests/test_fused_servo.py).  qdot feeds the servo'd task links' point
    velocities; without servos it is accepted for interface parity and
    unused — the tick compensates gravity, not Coriolis, exactly like the
    reference's grav+task+contact sum (src/pybind/rl_wbc_bridge.cpp:131-139).
    """

    def __init__(self, model: RobotModel, cfg: PipelineConfig,
                 dtype=jnp.float32, masked: bool = False):
        self.model = model
        self.cfg = cfg
        self.dtype = dtype
        self.masked = masked
        self.prog = TickProgram(model, cfg, dtype, masked=masked)
        self._tick = jax.jit(self._tick_impl, static_argnames=("qp_iters",))

    # ------------------------------------------------------------- warm
    def _level_dims(self):
        return self.prog.qp_dims

    def init_warm(self, batch=()):
        """Same pytree/shape contract as CompiledTick.init_warm."""
        return tuple(
            (jnp.zeros(batch + (nv,), self.dtype),
             jnp.ones(batch + (rows,), self.dtype))
            for nv, rows in self.prog.qp_dims
        )

    # ------------------------------------------------------------- tick
    def _tick_impl(self, q, qdot, fstars, contact_mask=None, warm=None,
                   qp_iters=None, servos=None):
        """Masked mode takes contact_mask as the 4th positional argument —
        the MaskedTick._tick_impl signature, so make_control_loop and the
        hypothesis sweeps drive either class.  servos: CompiledTick's
        nested per-level/per-spec ServoParams pytree — the on-device
        trajectory-PD servo runs INSIDE the fused program."""
        assert (contact_mask is not None) == self.masked
        iters = self.cfg.qp_iters if qp_iters is None else qp_iters
        q = jnp.asarray(q, self.dtype)
        qdot = jnp.asarray(qdot, self.dtype)
        fstars = tuple(jnp.asarray(f, self.dtype) for f in fstars)
        batched = q.ndim == 2
        cmask = None
        if self.masked:
            cmask = jnp.asarray(contact_mask, self.dtype)
            if batched and cmask.ndim == 1:
                cmask = jnp.broadcast_to(cmask, (q.shape[0],) + cmask.shape)
        if not batched:
            q = q[None]
            qdot = qdot[None]
            fstars = tuple(f[None] for f in fstars)
            if cmask is not None:
                cmask = cmask[None]
            if warm is not None:
                warm = tuple((x[None], l[None]) for x, l in warm)
        out = self._run_xla(q, fstars, warm, iters, cmask,
                            qdot=qdot, servos=servos)

        result = TickResult(
            torque_grav=out["torque_grav"],
            torque_task=out["torque_task"],
            torque_contact=out["torque_contact"],
            torque_cmd=out["torque_cmd"],
            contact_force=out["contact_force"],
            qp_gap=out["qp_gap"],
            qp_primal_res=out["qp_primal_res"],
            contact_rank_health=out["health"],
            qp_error=qp_error_flag(
                out["qp_gap"], out["qp_primal_res"], out["torque_cmd"],
                self.cfg,
            ),
        )
        if not batched:
            result = TickResult(*(r[0] for r in result))
            if warm is not None:
                wout = tuple((x[0], l[0]) for x, l in out["warm_out"])
                return result, wout
            return result
        if warm is not None:
            return result, out["warm_out"]
        return result

    # ------------------------------------------------------------ servos
    def _servo_fields(self, sp, B):
        """ServoParams → dict of batched (B, elem...) arrays."""
        d = {}
        for f in sp._fields:
            leaf = jnp.asarray(getattr(sp, f), self.dtype)
            es = SERVO_ELEM_SHAPES[f]
            if leaf.ndim == len(es):
                leaf = jnp.broadcast_to(leaf, (B,) + es)
            d[f] = leaf
        return d

    def _servos_batched(self, servos, B):
        """Nested pytree → per-level tuple of per-spec dict-or-None."""
        if servos is None:
            return None
        out = []
        for h, slots in enumerate(self.prog.task_slots):
            lvl = servos[h] if h < len(servos) else None
            if lvl is None:
                out.append(None)
                continue
            out.append(tuple(
                None if sp is None else self._servo_fields(sp, B)
                for sp in lvl
            ))
        return tuple(out)

    # ------------------------------------------------------------- XLA
    def _run_xla(self, q, fstars, warm, iters, cmask=None, qdot=None,
                 servos=None):
        q_el = jnp.moveaxis(q, 0, -1)
        fs_el = tuple(jnp.moveaxis(f, 0, -1) for f in fstars)
        cm_el = None if cmask is None else jnp.moveaxis(cmask, 0, -1)
        qd_el = None if qdot is None else jnp.moveaxis(qdot, 0, -1)
        sv_el = None
        if servos is not None:
            sv_b = self._servos_batched(servos, q.shape[0])
            sv_el = tuple(
                None if lvl is None else tuple(
                    None if d is None
                    else {k: jnp.moveaxis(v, 0, -1) for k, v in d.items()}
                    for d in lvl
                )
                for lvl in sv_b
            )
        w_el = None
        if warm is not None:
            w_el = tuple(
                (jnp.moveaxis(x, 0, -1), jnp.moveaxis(l, 0, -1))
                for x, l in warm
            )
        out = self.prog.tick(q_el, fs_el, warm=w_el, iters=iters, cmask=cm_el,
                             qdot=qd_el, servos=sv_el)
        res = {
            k: jnp.moveaxis(out[k], -1, 0)
            for k in ("torque_grav", "torque_task", "torque_contact",
                      "torque_cmd", "contact_force")
        }
        res["qp_gap"] = out["qp_gap"]
        res["qp_primal_res"] = out["qp_primal_res"]
        res["health"] = out["health"]
        res["warm_out"] = tuple(
            (jnp.moveaxis(x, -1, 0), jnp.moveaxis(l, -1, 0))
            for x, l in out["warm_out"]
        )
        return res

    # ---------------------------------------------------------- calling
    def __call__(self, q, qdot, fstars, contact_mask=None, servos=None) -> TickResult:
        return self._tick(q, qdot, fstars, contact_mask=contact_mask,
                          servos=servos)

    def batched(self):
        return jax.jit(self._tick_impl, static_argnames=("qp_iters",))
