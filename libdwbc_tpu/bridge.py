"""RL environment bridge: the Python-native equivalent of the reference's
pybind11 module (src/pybind/rl_wbc_bridge.cpp).

The reference needed a C++→Python marshalling layer; here the framework is
Python/JAX-first, so the bridge is a thin convenience class with the same
surface: fixed Tocabi setup (2 foot contacts, pelvis-6D + upper-body-rotation
tasks, 300 Nm limits), MuJoCo qpos quaternion reorder, and the
grav→task→redistribute tick.  For vectorized RL environments use
``BatchedRlWBCBridge`` — thousands of envs solved per call on one device.
"""

from __future__ import annotations

import os

import numpy as np

_DEFAULT_MODEL = os.path.join(os.path.dirname(os.path.dirname(__file__)), "models", "tocabi.npz")


def _standard_robot(model_path: str | None = None, urdf_path: str | None = None):
    from .model.compile import RobotModel, compile_urdf
    from .wbc import types as T
    from .wbc.robot import RobotData

    rd = RobotData()
    if urdf_path:
        rd.LoadModelData(urdf_path, True, 0)
    else:
        from .kin.engine import Kinematics

        rd.model = RobotModel.load(model_path or _DEFAULT_MODEL)
        rd.kin = Kinematics(rd.model)
    rd.AddContactConstraint(6, T.CONTACT_6D, [0.03, 0, -0.1585], [0, 0, 1], 0.15, 0.075)
    rd.AddContactConstraint(12, T.CONTACT_6D, [0.03, 0, -0.1585], [0, 0, 1], 0.15, 0.075)
    rd.AddTaskSpace(0, T.TASK_LINK_6D, 0, np.zeros(3))
    rd.AddTaskSpace(1, T.TASK_LINK_ROTATION, 15, np.zeros(3))
    rd.SetTorqueLimit(np.full(rd.model_dof_, 300.0))
    return rd


def mujoco_to_dwbc_q(qpos: np.ndarray, system_dof: int, model_dof: int) -> np.ndarray:
    """MuJoCo qpos [x y z, qw qx qy qz, joints] → RBDL layout
    [x y z, qx qy qz, joints, qw]  (rl_wbc_bridge.cpp:88-98)."""
    q = np.zeros(system_dof + 1)
    q[0:3] = qpos[0:3]
    q[3:6] = qpos[4:7]
    q[system_dof] = qpos[3]
    q[6 : 6 + model_dof] = qpos[7 : 7 + model_dof]
    return q


class RlWBCBridge:
    """Single-env bridge (reference class surface, rl_wbc_bridge.h:46-77)."""

    def __init__(self, env_id: int = 0, model_path: str | None = None,
                 urdf_path: str | None = None):
        self.rd_ = _standard_robot(model_path, urdf_path)
        self._task_init = True

    def UpdateKinematics(self, qpos, qvel, qacc):
        q = mujoco_to_dwbc_q(
            np.asarray(qpos, float), self.rd_.system_dof_, self.rd_.model_dof_
        )
        self.rd_.UpdateKinematics(q, np.asarray(qvel, float), np.asarray(qacc, float))

    def SetContact(self, left: bool, right: bool):
        self.rd_.SetContact(left, right)
        self.rd_.CalcContactConstraint()
        self.rd_.CalcTaskSpace()

    def SetTaskSpace(self, heirarchy: int, f_star):
        self.rd_.SetTaskSpace(heirarchy, np.asarray(f_star, float))

    def CalcTorque(self):
        self.rd_.CalcGravCompensation()
        self.rd_.CalcTaskControlTorque(True, self._task_init, update_task_space=False)
        self.rd_.CalcContactRedistribute(True, self._task_init)
        self._task_init = False

    def getTorqueCommand(self):
        return list(np.asarray(self.rd_.torque_command(), dtype=np.float32))

    def Reset(self):
        self._task_init = True

    def reflectAction(self, action):  # parity stub (reference is commented out)
        pass


class BatchedRlWBCBridge:
    """Vectorized bridge: one fused compiled tick over N environments.

    qpos (N, nq_mujoco), qvel/qacc (N, ndof), fstars tuple of (N, t).
    """

    def __init__(self, n_envs: int, model_path: str | None = None,
                 qp_iters: int = 12, dtype=None):
        import jax.numpy as jnp

        from .model.compile import RobotModel
        from .wbc.pipeline import CompiledTick, standard_tocabi_config

        self.model = RobotModel.load(model_path or _DEFAULT_MODEL)
        cfg = standard_tocabi_config(self.model, qp_iters=qp_iters)
        self.tick = CompiledTick(self.model, cfg, dtype=dtype or jnp.float32)
        self._batched = self.tick.batched()
        self.n_envs = n_envs

    def solve(self, qpos, qvel, qacc, fstar0, fstar1):
        import jax.numpy as jnp

        qpos = np.asarray(qpos, np.float32)
        N = qpos.shape[0]
        qs = np.zeros((N, self.model.nq), dtype=np.float32)
        qs[:, 0:3] = qpos[:, 0:3]
        qs[:, 3:6] = qpos[:, 4:7]
        qs[:, self.model.ndof] = qpos[:, 3]
        qs[:, 6 : 6 + self.model.model_dof] = qpos[:, 7 : 7 + self.model.model_dof]
        res = self._batched(
            jnp.asarray(qs), jnp.asarray(qvel, jnp.float32),
            (jnp.asarray(fstar0, jnp.float32), jnp.asarray(fstar1, jnp.float32)),
        )
        return np.asarray(res.torque_cmd)
