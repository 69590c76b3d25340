"""Programmatic (non-URDF) model construction — the analog of
``RobotData::InitModelWithLinkJoint`` (/root/reference/src/dwbc.cpp:2425-2471).

Two protocols:
* round-trip: moving-body specs extracted from the compiled Tocabi model
  recompile to an identical RobotModel (arrays bit/1e-12 equal);
* end-to-end: a small hand-built chain through RobotData.InitModelWithLinkJoint
  matches the identical chain loaded from a URDF string, through the full
  OSF-HQP tick.
"""

import numpy as np
import pytest

from conftest import URDF

from libdwbc_tpu.model.compile import (
    JointSpec, LinkSpec, compile_from_links, compile_urdf,
)


def _specs_from_model(model):
    """Extract parallel Link/Joint vectors from a compiled model's moving
    bodies (fixed frames were already lumped at compile time)."""
    links, joints = [], []
    for i in range(model.nbody):
        links.append(
            LinkSpec(
                name=model.body_names[i],
                mass=float(model.mass[i]),
                com=model.com[i],
                inertia=model.inertia[i],
                parent=int(model.parent[i]),
            )
        )
        if i == 0:
            joints.append(JointSpec(joint_type="floating", name="root"))
        else:
            joints.append(
                JointSpec(
                    joint_type="revolute",
                    axis=model.axis[i],
                    origin_xyz=model.X_T_trans[i],
                    origin_rot=model.X_T_rot[i],
                    name=model.joint_names[i],
                )
            )
    return links, joints


def test_roundtrip_tocabi(tocabi_model):
    m0 = tocabi_model
    links, joints = _specs_from_model(m0)
    m1 = compile_from_links(links, joints, name=m0.name)
    assert m1.nbody == m0.nbody and m1.ndof == m0.ndof and m1.nq == m0.nq
    assert m1.body_names == m0.body_names
    assert m1.joint_names == m0.joint_names
    np.testing.assert_array_equal(m1.parent, m0.parent)
    np.testing.assert_array_equal(m1.q_index, m0.q_index)
    np.testing.assert_allclose(m1.X_T_rot, m0.X_T_rot, atol=1e-12)
    np.testing.assert_allclose(m1.X_T_trans, m0.X_T_trans, atol=0)
    np.testing.assert_allclose(m1.axis, m0.axis, atol=0)
    np.testing.assert_allclose(m1.mass, m0.mass, atol=0)
    np.testing.assert_allclose(m1.com, m0.com, atol=0)
    np.testing.assert_allclose(m1.inertia, m0.inertia, atol=0)
    np.testing.assert_array_equal(m1.ancestor_mask, m0.ancestor_mask)


def test_roundtrip_dynamics_parity(tocabi_model):
    """A and G of the recompiled model match on a nontrivial pose."""
    from conftest import CASE_Q, full_q
    from libdwbc_tpu.kin.engine import Kinematics

    links, joints = _specs_from_model(tocabi_model)
    m1 = compile_from_links(links, joints)
    q = full_q(CASE_Q[1])
    qd = np.zeros(39)
    st0 = Kinematics(tocabi_model).update(q, qd)
    st1 = Kinematics(m1).update(q, qd)
    np.testing.assert_allclose(np.asarray(st1.A), np.asarray(st0.A), atol=1e-12)
    np.testing.assert_allclose(np.asarray(st1.G), np.asarray(st0.G), atol=1e-12)


_CHAIN_URDF = """
<robot name="chain3">
  <link name="base">
    <inertial><origin xyz="0 0 0.1"/><mass value="5.0"/>
      <inertia ixx="0.2" iyy="0.2" izz="0.1"/></inertial>
  </link>
  <link name="l1">
    <inertial><origin xyz="0 0 -0.2"/><mass value="2.0"/>
      <inertia ixx="0.05" iyy="0.05" izz="0.02"/></inertial>
  </link>
  <link name="l2">
    <inertial><origin xyz="0 0 -0.15"/><mass value="1.0"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.01"/></inertial>
  </link>
  <link name="sensor"><inertial><mass value="0.2"/>
      <inertia ixx="0.001" iyy="0.001" izz="0.001"/></inertial>
  </link>
  <joint name="j1" type="revolute">
    <parent link="base"/><child link="l1"/>
    <origin xyz="0 0.1 -0.1" rpy="0.1 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-2" upper="2" effort="100" velocity="10"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="l1"/><child link="l2"/>
    <origin xyz="0 0 -0.4" rpy="0 0.2 0"/><axis xyz="0 1 0"/>
    <limit lower="-2" upper="2" effort="100" velocity="10"/>
  </joint>
  <joint name="jf" type="fixed">
    <parent link="l2"/><child link="sensor"/>
    <origin xyz="0 0 -0.3"/>
  </joint>
</robot>
"""


def _chain_specs():
    links = [
        LinkSpec("base", 5.0, np.array([0, 0, 0.1]), np.diag([0.2, 0.2, 0.1]), -1),
        LinkSpec("l1", 2.0, np.array([0, 0, -0.2]), np.diag([0.05, 0.05, 0.02]), 0),
        LinkSpec("l2", 1.0, np.array([0, 0, -0.15]), np.diag([0.02, 0.02, 0.01]), 1),
        LinkSpec("sensor", 0.2, np.zeros(3), np.diag([1e-3, 1e-3, 1e-3]), 2),
    ]
    joints = [
        JointSpec("floating", name="root"),
        JointSpec("revolute", np.array([0, 1, 0.0]), np.array([0, 0.1, -0.1]),
                  np.array([0.1, 0, 0]), name="j1",
                  limit_lower=-2, limit_upper=2, limit_effort=100,
                  limit_velocity=10),
        JointSpec("revolute", np.array([0, 1, 0.0]), np.array([0, 0, -0.4]),
                  np.array([0, 0.2, 0]), name="j2",
                  limit_lower=-2, limit_upper=2, limit_effort=100,
                  limit_velocity=10),
        JointSpec("fixed", origin_xyz=np.array([0, 0, -0.3]), name="jf"),
    ]
    return links, joints


def test_chain_matches_urdf():
    m_urdf = compile_urdf(_CHAIN_URDF, floating=True)
    links, joints = _chain_specs()
    m_prog = compile_from_links(links, joints, name="chain3")
    assert m_prog.nbody == m_urdf.nbody == 3   # sensor lumped into l2
    np.testing.assert_allclose(m_prog.mass, m_urdf.mass, atol=0)
    np.testing.assert_allclose(m_prog.com, m_urdf.com, atol=1e-15)
    np.testing.assert_allclose(m_prog.inertia, m_urdf.inertia, atol=1e-15)
    np.testing.assert_allclose(m_prog.X_T_rot, m_urdf.X_T_rot, atol=1e-12)
    np.testing.assert_allclose(
        m_prog.joint_limit_lower, m_urdf.joint_limit_lower, atol=0
    )


def test_facade_full_tick_parity():
    """InitModelWithLinkJoint through the full OSF tick == URDF model."""
    from libdwbc_tpu.wbc import types as T
    from libdwbc_tpu.wbc.robot import RobotData

    def build(rd_init):
        rd = RobotData()
        rd_init(rd)
        rd.AddContactConstraint(2, T.CONTACT_POINT, [0, 0, -0.3], [0, 0, 1])
        # a POSITION task: with a single 3-dof point contact, a 6-row task
        # would make Λ_t singular (rank(A⁻¹N_C) = n-3 but the base task
        # needs 6) — the reference's COD-thresholded pinv hits the same
        # degeneracy there
        rd.AddTaskSpace(0, T.TASK_LINK_POSITION, 0, np.zeros(3))
        rd.SetTorqueLimit(np.full(2, 50.0))
        q = np.zeros(rd.model.nq)
        q[2] = 0.8
        q[rd.model.nq - 1] = 1.0
        q[6:8] = [0.3, -0.5]
        rd.UpdateKinematics(q, np.zeros(rd.model.ndof))
        rd.SetContact(True)
        rd.CalcContactConstraint()
        rd.CalcGravCompensation()
        rd.SetTaskSpace(0, np.array([0.1, 0.2, 0.1]))
        rd.CalcTaskControlTorque(True, True)
        rd.CalcContactRedistribute(True, True)
        tau = rd.torque_command()
        assert np.isfinite(tau).all()
        return tau

    links, joints = _chain_specs()
    tau_prog = build(lambda rd: rd.InitModelWithLinkJoint(links, joints))

    import os
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".urdf", delete=False) as f:
        f.write(_CHAIN_URDF)
        path = f.name
    try:
        tau_urdf = build(lambda rd: rd.LoadModelData(path, True, 0))
    finally:
        os.unlink(path)
    np.testing.assert_allclose(tau_prog, tau_urdf, atol=1e-9)
