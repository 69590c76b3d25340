"""Model compiler: URDF → static fixed-topology array program.

This replaces the reference's runtime RBDL model (``RobotData::LoadModelData``
/ ``InitModelData``, /root/reference/src/dwbc.cpp:102-252) with an
ahead-of-time compilation step.  The output, :class:`RobotModel`, is a set of
*static* numpy arrays (parent indices, joint frames, axes, lumped inertias,
ancestor masks).  Every per-tick quantity downstream is a pure jitted
function of ``(q, qdot)`` with these arrays baked in as constants — there is
no pointer-chasing model object on the device.

Ordering parity: bodies are numbered by a pre-order depth-first walk with
child joints sorted alphabetically by joint name, which reproduces
RBDL+urdfdom numbering (see urdf.py).  Fixed joints are merged into their
moving parent exactly like RBDL's fixed-body lumping (same math as
``Link::AddLink``, /root/reference/src/link.cpp:247-269).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .rotations_np import rpy_to_matrix, skew_np
from .urdf import UrdfInertial, UrdfJoint, UrdfLink, UrdfModel, parse_urdf

GRAVITY = np.array([0.0, 0.0, -9.81])


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Static description of a floating- or fixed-base kinematic tree.

    All arrays are host numpy; jitted kernels close over them as constants.
    Body 0 is the (floating) base.  ``ndof`` counts generalized velocities
    (6 + n_joints when floating); ``nq = ndof + 1`` when floating (quaternion
    w is stored at q[ndof], RBDL layout).
    """

    name: str
    floating: bool
    nbody: int                 # number of moving bodies (incl. base)
    ndof: int                  # system dof (generalized velocities)
    nq: int                    # size of q vector
    model_dof: int             # actuated joints = ndof - 6 (floating) | ndof

    body_names: tuple[str, ...]        # (nbody,)
    joint_names: tuple[str, ...]       # (nbody,) name of joint above body ('' for base)
    parent: np.ndarray                 # (nbody,) int32, parent body index, -1 for base
    q_index: np.ndarray                # (nbody,) int32, qdot index of body's joint dof
    X_T_rot: np.ndarray                # (nbody,3,3) child joint frame rotation in parent frame
    X_T_trans: np.ndarray              # (nbody,3)  child joint frame origin in parent frame
    axis: np.ndarray                   # (nbody,3)  revolute axis in child frame

    mass: np.ndarray                   # (nbody,) lumped body mass
    com: np.ndarray                    # (nbody,3) lumped COM in body frame
    inertia: np.ndarray                # (nbody,3,3) lumped inertia about COM, body frame

    ancestor_mask: np.ndarray          # (nbody, ndof) float, 1 where dof moves body
    joint_limit_lower: np.ndarray      # (model_dof,)
    joint_limit_upper: np.ndarray      # (model_dof,)
    effort_limit: np.ndarray           # (model_dof,)
    velocity_limit: np.ndarray         # (model_dof,)
    damping: np.ndarray                # (model_dof,)

    # Frames merged away by fixed-joint lumping: name -> (body index, R, p)
    fixed_frames: dict[str, tuple[int, np.ndarray, np.ndarray]]

    total_mass: float
    gravity: np.ndarray                # (3,)

    # ------------------------------------------------------- serialization
    def save(self, path: str) -> None:
        """Serialize the compiled model (npz: arrays + json-encoded metadata).

        This is the shippable artifact of the model compiler — downstream
        code never needs the URDF again.
        """
        import json

        meta = dict(
            name=self.name,
            floating=self.floating,
            body_names=list(self.body_names),
            joint_names=list(self.joint_names),
            fixed_frames={
                k: [int(v[0]), v[1].tolist(), v[2].tolist()]
                for k, v in self.fixed_frames.items()
            },
        )
        np.savez_compressed(
            path,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            parent=self.parent,
            q_index=self.q_index,
            X_T_rot=self.X_T_rot,
            X_T_trans=self.X_T_trans,
            axis=self.axis,
            mass=self.mass,
            com=self.com,
            inertia=self.inertia,
            ancestor_mask=self.ancestor_mask,
            joint_limit_lower=self.joint_limit_lower,
            joint_limit_upper=self.joint_limit_upper,
            effort_limit=self.effort_limit,
            velocity_limit=self.velocity_limit,
            damping=self.damping,
            gravity=self.gravity,
        )

    @staticmethod
    def load(path: str) -> "RobotModel":
        import json

        z = np.load(path)
        meta = json.loads(bytes(z["meta"]).decode())
        nbody = len(meta["body_names"])
        base_dof = 6 if meta["floating"] else 0
        ndof = base_dof + nbody - 1
        return RobotModel(
            name=meta["name"],
            floating=meta["floating"],
            nbody=nbody,
            ndof=ndof,
            nq=ndof + 1 if meta["floating"] else ndof,
            model_dof=ndof - base_dof,
            body_names=tuple(meta["body_names"]),
            joint_names=tuple(meta["joint_names"]),
            parent=z["parent"],
            q_index=z["q_index"],
            X_T_rot=z["X_T_rot"],
            X_T_trans=z["X_T_trans"],
            axis=z["axis"],
            mass=z["mass"],
            com=z["com"],
            inertia=z["inertia"],
            ancestor_mask=z["ancestor_mask"],
            joint_limit_lower=z["joint_limit_lower"],
            joint_limit_upper=z["joint_limit_upper"],
            effort_limit=z["effort_limit"],
            velocity_limit=z["velocity_limit"],
            damping=z["damping"],
            fixed_frames={
                k: (int(v[0]), np.array(v[1]), np.array(v[2]))
                for k, v in meta["fixed_frames"].items()
            },
            total_mass=float(np.sum(z["mass"])),
            gravity=z["gravity"],
        )

    def body_index(self, name: str) -> int:
        """Index of a moving body by name (case-insensitive, like the
        reference's strcasecmp lookup, /root/reference/src/dwbc.cpp:401)."""
        low = name.lower()
        for i, nm in enumerate(self.body_names):
            if nm.lower() == low:
                return i
        if name in self.fixed_frames:
            return self.fixed_frames[name][0]
        raise KeyError(f"no body named {name!r}")

    # --- pytree-ish convenience -------------------------------------------
    def children(self, i: int) -> list[int]:
        return [j for j in range(self.nbody) if self.parent[j] == i]


def _merge_inertial(
    mass_a: float, com_a: np.ndarray, I_a: np.ndarray,
    mass_b: float, com_b_in_a: np.ndarray, I_b_in_a_about_its_com: np.ndarray,
) -> tuple[float, np.ndarray, np.ndarray]:
    """Lump body b into body a's frame (Link::AddLink math, link.cpp:247-269)."""
    new_mass = mass_a + mass_b
    if new_mass == 0.0:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    new_com = (mass_a * com_a + mass_b * com_b_in_a) / new_mass
    I_a_origin = I_a + mass_a * skew_np(com_a) @ skew_np(com_a).T
    I_b_origin = I_b_in_a_about_its_com + mass_b * skew_np(com_b_in_a) @ skew_np(com_b_in_a).T
    new_I = I_a_origin + I_b_origin - new_mass * skew_np(new_com) @ skew_np(new_com).T
    return new_mass, new_com, new_I


def compile_urdf(path_or_string: str, floating: bool = True) -> RobotModel:
    """Compile a URDF into a RobotModel (the compiled LoadModelData)."""
    urdf = parse_urdf(path_or_string)
    return compile_model(urdf, floating)


# ---------------------------------------------------------------------------
# Programmatic (non-URDF) model construction — the analog of
# ``RobotData::InitModelWithLinkJoint`` (/root/reference/src/dwbc.cpp:2425-2471),
# which rebuilds an RBDL model from parallel std::vector<Link>/<Joint>.
# Here the same parallel-vector shape compiles straight to a RobotModel.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LinkSpec:
    """One body of a programmatic model (reference ``DWBC::Link``,
    include/dwbc_link.h:42-145: mass/COM/inertia + parent id)."""

    name: str
    mass: float = 0.0
    com: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    inertia: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((3, 3))
    )
    parent: int = -1          # index into the links list; -1 = root


@dataclasses.dataclass
class JointSpec:
    """The joint ABOVE the same-index link (reference ``DWBC::Joint``,
    include/dwbc_link.h:22-40: type + axis + parent-frame transform).

    joint_type: 'floating' (root only), 'revolute', or 'fixed' (lumped into
    the parent, RBDL fixed-body merging).  origin_* place the child joint
    frame in the parent frame (the reference's joint_rotation_/
    joint_translation_ SpatialTransform, src/dwbc.cpp:2438)."""

    joint_type: str = "revolute"
    axis: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 1.0])
    )
    origin_xyz: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    origin_rpy: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    origin_rot: np.ndarray | None = None   # (3,3) overrides origin_rpy if given
    name: str = ""
    limit_lower: float = -np.inf
    limit_upper: float = np.inf
    limit_effort: float = np.inf
    limit_velocity: float = np.inf
    damping: float = 0.0


def compile_from_links(
    links: list[LinkSpec], joints: list[JointSpec], name: str = "programmatic"
) -> RobotModel:
    """Compile a model from parallel Link/Joint vectors — no URDF anywhere.

    ``links[i]`` is connected to ``links[links[i].parent]`` by ``joints[i]``
    (``joints[0]`` is the root joint: 'floating' for a floating base, any
    other type for a fixed base), exactly the vector convention of
    ``InitModelWithLinkJoint`` (src/dwbc.cpp:2434-2470).  Bodies are numbered
    in list order (the reference adds them in vector order too), so unlike
    the URDF path there is no alphabetical child reordering.
    """
    assert len(links) == len(joints) and links, "parallel links/joints required"
    assert links[0].parent < 0, "links[0] must be the root (parent=-1)"
    floating = joints[0].joint_type == "floating"

    urdf_links = {
        l.name: UrdfLink(
            l.name,
            UrdfInertial(
                float(l.mass),
                np.asarray(l.com, np.float64).copy(),
                np.asarray(l.inertia, np.float64).copy(),
            ),
        )
        for l in links
    }
    assert len(urdf_links) == len(links), "link names must be unique"
    ujoints: dict[str, "UrdfJoint"] = {}
    child_joints: dict[str, list[str]] = {l.name: [] for l in links}
    for i in range(1, len(links)):
        l, j = links[i], joints[i]
        assert 0 <= l.parent < i, (
            f"link {l.name!r}: parent index {l.parent} must precede it"
        )
        assert j.joint_type in ("revolute", "continuous", "fixed"), (
            f"unsupported joint type {j.joint_type!r} for {l.name!r}"
        )
        jname = j.name or f"{l.name}_joint"
        assert jname not in ujoints, f"duplicate joint name {jname!r}"
        if j.origin_rot is not None:
            from .rotations_np import matrix_to_rpy

            rpy = matrix_to_rpy(np.asarray(j.origin_rot, np.float64))
        else:
            rpy = np.asarray(j.origin_rpy, np.float64).copy()
        ujoints[jname] = UrdfJoint(
            jname, j.joint_type, links[l.parent].name, l.name,
            np.asarray(j.origin_xyz, np.float64).copy(),
            rpy,
            np.asarray(j.axis, np.float64).copy(),
            limit_lower=j.limit_lower, limit_upper=j.limit_upper,
            limit_effort=j.limit_effort, limit_velocity=j.limit_velocity,
            damping=j.damping,
        )
        # insertion order, NOT alphabetical: body numbering follows the
        # caller's vector order like the reference's sequential AddBody
        child_joints[links[l.parent].name].append(jname)

    um = UrdfModel(
        name=name,
        links=urdf_links,
        joints=ujoints,
        root_link=links[0].name,
        child_joints=child_joints,
    )
    return compile_model(um, floating)


def compile_model(urdf: UrdfModel, floating: bool = True) -> RobotModel:
    body_names: list[str] = []
    joint_names: list[str] = []
    parent: list[int] = []
    q_index: list[int] = []
    X_T_rot: list[np.ndarray] = []
    X_T_trans: list[np.ndarray] = []
    axis: list[np.ndarray] = []
    mass: list[float] = []
    com: list[np.ndarray] = []
    inertia: list[np.ndarray] = []
    jl_lower: list[float] = []
    jl_upper: list[float] = []
    jl_effort: list[float] = []
    jl_vel: list[float] = []
    jl_damp: list[float] = []
    fixed_frames: dict[str, tuple[int, np.ndarray, np.ndarray]] = {}

    root = urdf.links[urdf.root_link]
    base_dof = 6 if floating else 0

    # Body 0: the root/base.
    body_names.append(root.name)
    joint_names.append("")
    parent.append(-1)
    q_index.append(0)
    X_T_rot.append(np.eye(3))
    X_T_trans.append(np.zeros(3))
    axis.append(np.zeros(3))
    mass.append(root.inertial.mass)
    com.append(root.inertial.com.copy())
    inertia.append(root.inertial.inertia.copy())

    next_q = base_dof

    def lump_fixed_subtree(body_idx: int, link_name: str, R: np.ndarray, p: np.ndarray):
        """Merge `link_name` (pose R,p in body_idx frame) into body_idx, then
        recurse: fixed children keep lumping, moving children become bodies."""
        link = urdf.links[link_name]
        fixed_frames[link_name] = (body_idx, R.copy(), p.copy())
        inert = link.inertial
        com_in_a = R @ inert.com + p
        I_in_a = R @ inert.inertia @ R.T
        mass[body_idx], com[body_idx], inertia[body_idx] = _merge_inertial(
            mass[body_idx], com[body_idx], inertia[body_idx],
            inert.mass, com_in_a, I_in_a,
        )
        for jname in urdf.child_joints[link_name]:
            joint = urdf.joints[jname]
            Rj = rpy_to_matrix(joint.origin_rpy)
            pj = joint.origin_xyz
            if joint.joint_type == "fixed":
                lump_fixed_subtree(body_idx, joint.child, R @ Rj, R @ pj + p)
            else:
                add_moving_body(body_idx, joint, R @ Rj, R @ pj + p)

    def add_moving_body(parent_idx: int, joint, Rj: np.ndarray, pj: np.ndarray):
        nonlocal next_q
        assert joint.joint_type in ("revolute", "continuous"), (
            f"unsupported joint type {joint.joint_type!r} for {joint.name!r}"
        )
        idx = len(body_names)
        link = urdf.links[joint.child]
        body_names.append(joint.child)
        joint_names.append(joint.name)
        parent.append(parent_idx)
        q_index.append(next_q)
        next_q += 1
        X_T_rot.append(Rj)
        X_T_trans.append(pj)
        axis.append(joint.axis.copy())
        mass.append(link.inertial.mass)
        com.append(link.inertial.com.copy())
        inertia.append(link.inertial.inertia.copy())
        jl_lower.append(joint.limit_lower)
        jl_upper.append(joint.limit_upper)
        jl_effort.append(joint.limit_effort)
        jl_vel.append(joint.limit_velocity)
        jl_damp.append(joint.damping)
        walk(idx, joint.child)

    def walk(body_idx: int, link_name: str):
        """Pre-order DFS, children alphabetical by joint name (RBDL parity)."""
        for jname in urdf.child_joints[link_name]:
            joint = urdf.joints[jname]
            Rj = rpy_to_matrix(joint.origin_rpy)
            pj = joint.origin_xyz
            if joint.joint_type == "fixed":
                lump_fixed_subtree(body_idx, joint.child, Rj, pj)
            else:
                add_moving_body(body_idx, joint, Rj, pj)

    walk(0, root.name)

    nbody = len(body_names)
    ndof = next_q
    model_dof = ndof - base_dof
    nq = ndof + 1 if floating else ndof

    parent_arr = np.array(parent, dtype=np.int32)
    q_index_arr = np.array(q_index, dtype=np.int32)

    # Ancestor mask: dof j moves body i iff the body owning dof j is on the
    # path base→i.  Base dofs (0..5) move every body when floating.
    amask = np.zeros((nbody, ndof), dtype=np.float64)
    for i in range(nbody):
        if floating:
            amask[i, 0:6] = 1.0
        k = i
        while k > 0:
            amask[i, q_index_arr[k]] = 1.0
            k = parent_arr[k]

    return RobotModel(
        name=urdf.name,
        floating=floating,
        nbody=nbody,
        ndof=ndof,
        nq=nq,
        model_dof=model_dof,
        body_names=tuple(body_names),
        joint_names=tuple(joint_names),
        parent=parent_arr,
        q_index=q_index_arr,
        X_T_rot=np.stack(X_T_rot),
        X_T_trans=np.stack(X_T_trans),
        axis=np.stack(axis),
        mass=np.array(mass),
        com=np.stack(com),
        inertia=np.stack(inertia),
        ancestor_mask=amask,
        joint_limit_lower=np.array(jl_lower),
        joint_limit_upper=np.array(jl_upper),
        effort_limit=np.array(jl_effort),
        velocity_limit=np.array(jl_vel),
        damping=np.array(jl_damp),
        fixed_frames=fixed_frames,
        total_mass=float(np.sum(mass)),
        gravity=GRAVITY.copy(),
    )
