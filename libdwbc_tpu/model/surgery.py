"""Model surgery: runtime model modification as host-side recompilation.

The reference mutates RBDL's internal vectors in place (``DeleteLink``,
``AddLink``, ``ChangeLinkToFixedJoint``, ``ChangeLinkInertia``,
/root/reference/src/dwbc.cpp:1821-2382, 2707-2748) and then renumbers all
bookkeeping (``InitAfterModelMod``).  Here the model is a static
compiled artifact, so surgery = build a new :class:`RobotModel` and recompile
the (cached) kernels — no in-graph mutation, no renumbering bugs.

All functions are pure: they return a new RobotModel.
"""

from __future__ import annotations

import numpy as np

from .compile import RobotModel, _merge_inertial
from .rotations_np import rpy_to_matrix, skew_np


def _rebuild(model: RobotModel, keep: list[int], parent_map: dict[int, int],
             extra=None) -> RobotModel:
    """Re-number bodies listed in `keep` (must include 0 first, topologically
    ordered) with new parents per parent_map; recompute q indices & masks."""
    old2new = {old: new for new, old in enumerate(keep)}
    nbody = len(keep)
    base_dof = 6 if model.floating else 0
    ndof = base_dof + nbody - 1

    def gather(arr):
        return np.array([arr[i] for i in keep])

    parent = np.array(
        [-1] + [old2new[parent_map[i]] for i in keep[1:]], dtype=np.int32
    )
    q_index = np.array([0] + [base_dof + k - 1 for k in range(1, nbody)], dtype=np.int32)

    amask = np.zeros((nbody, ndof))
    for i in range(nbody):
        if model.floating:
            amask[i, 0:6] = 1.0
        k = i
        while k > 0:
            amask[i, q_index[k]] = 1.0
            k = parent[k]

    jl = lambda arr, default: np.array(
        [arr[model.q_index[i] - base_dof] if i != 0 and model.q_index[i] >= base_dof
         and model.q_index[i] - base_dof < len(arr) else default
         for i in keep[1:]]
    )

    mass = gather(model.mass)
    return RobotModel(
        name=model.name,
        floating=model.floating,
        nbody=nbody,
        ndof=ndof,
        nq=ndof + 1 if model.floating else ndof,
        model_dof=ndof - base_dof,
        body_names=tuple(model.body_names[i] for i in keep),
        joint_names=tuple(model.joint_names[i] for i in keep),
        parent=parent,
        q_index=q_index,
        X_T_rot=gather(model.X_T_rot),
        X_T_trans=gather(model.X_T_trans),
        axis=gather(model.axis),
        mass=mass,
        com=gather(model.com),
        inertia=gather(model.inertia),
        ancestor_mask=amask,
        joint_limit_lower=jl(model.joint_limit_lower, -np.inf),
        joint_limit_upper=jl(model.joint_limit_upper, np.inf),
        effort_limit=jl(model.effort_limit, np.inf),
        velocity_limit=jl(model.velocity_limit, np.inf),
        damping=jl(model.damping, 0.0),
        fixed_frames=dict(model.fixed_frames),
        total_mass=float(np.sum(mass)),
        gravity=model.gravity.copy(),
    )


def _descendants(model: RobotModel, body: int) -> list[int]:
    out = []
    stack = [body]
    while stack:
        b = stack.pop()
        out.append(b)
        stack.extend(i for i in range(model.nbody) if model.parent[i] == b)
    return out


def delete_subtree(model: RobotModel, body: int) -> RobotModel:
    """Remove a body and all its descendants (reference ``DeleteLink`` with
    delete_all, src/dwbc.cpp:1821-2036)."""
    assert body != 0, "cannot delete the base"
    gone = set(_descendants(model, body))
    keep = [i for i in range(model.nbody) if i not in gone]
    parent_map = {i: int(model.parent[i]) for i in keep if i != 0}
    return _rebuild(model, keep, parent_map)


def change_link_to_fixed(model: RobotModel, body: int) -> RobotModel:
    """Freeze a joint: lump the body into its parent (at the current zero
    configuration of that joint) and reattach its children
    (``ChangeLinkToFixedJoint``, src/dwbc.cpp:2360-2382)."""
    assert body != 0
    par = int(model.parent[body])
    R = model.X_T_rot[body]          # child frame in parent frame at q=0
    p = model.X_T_trans[body]

    # lump inertia into parent
    new_mass = model.mass.copy()
    new_com = model.com.copy()
    new_inertia = model.inertia.copy()
    m_b, c_b, I_b = _merge_inertial(
        model.mass[par], model.com[par], model.inertia[par],
        model.mass[body], R @ model.com[body] + p, R @ model.inertia[body] @ R.T,
    )
    new_mass[par] = m_b
    new_com[par] = c_b
    new_inertia[par] = I_b

    # reattach children of `body` to `par` with composed transforms
    new_Xr = model.X_T_rot.copy()
    new_Xt = model.X_T_trans.copy()
    parent_map = {}
    for i in range(1, model.nbody):
        if i == body:
            continue
        if int(model.parent[i]) == body:
            new_Xr[i] = R @ model.X_T_rot[i]
            new_Xt[i] = R @ model.X_T_trans[i] + p
            parent_map[i] = par
        else:
            parent_map[i] = int(model.parent[i])

    patched = RobotModel(
        **{**model.__dict__,
           "mass": new_mass, "com": new_com, "inertia": new_inertia,
           "X_T_rot": new_Xr, "X_T_trans": new_Xt}
    )
    keep = [i for i in range(model.nbody) if i != body]
    out = _rebuild(patched, keep, parent_map)
    out.fixed_frames[model.body_names[body]] = (
        keep.index(par) if par in keep else 0, R.copy(), p.copy()
    )
    return out


def add_link(
    model: RobotModel, parent: int, name: str, joint_type: str,
    axis: np.ndarray, origin_xyz: np.ndarray, origin_rpy: np.ndarray,
    mass: float, com: np.ndarray, inertia: np.ndarray,
) -> RobotModel:
    """Append a body under `parent` (reference ``AddLink``,
    src/dwbc.cpp:2095-2150).  joint_type: 'revolute' | 'fixed'."""
    R = rpy_to_matrix(np.asarray(origin_rpy, float))
    p = np.asarray(origin_xyz, float)
    if joint_type == "fixed":
        new_mass = model.mass.copy()
        new_com = model.com.copy()
        new_inertia = model.inertia.copy()
        m_b, c_b, I_b = _merge_inertial(
            model.mass[parent], model.com[parent], model.inertia[parent],
            mass, R @ np.asarray(com, float) + p, R @ np.asarray(inertia, float) @ R.T,
        )
        new_mass[parent] = m_b
        new_com[parent] = c_b
        new_inertia[parent] = I_b
        out = RobotModel(
            **{**model.__dict__, "mass": new_mass, "com": new_com,
               "inertia": new_inertia,
               "total_mass": float(np.sum(new_mass))}
        )
        out.fixed_frames[name] = (parent, R, p)
        return out

    assert joint_type in ("revolute", "continuous")
    app = lambda arr, v: np.concatenate([arr, np.asarray(v)[None]], axis=0)
    patched = RobotModel(
        **{**model.__dict__,
           "nbody": model.nbody + 1,
           "ndof": model.ndof + 1,
           "nq": model.nq + 1,
           "model_dof": model.model_dof + 1,
           "body_names": model.body_names + (name,),
           "joint_names": model.joint_names + (name + "_joint",),
           "parent": np.concatenate([model.parent, [parent]]).astype(np.int32),
           "q_index": np.concatenate([model.q_index, [model.ndof]]).astype(np.int32),
           "X_T_rot": app(model.X_T_rot, R),
           "X_T_trans": app(model.X_T_trans, p),
           "axis": app(model.axis, np.asarray(axis, float)),
           "mass": np.concatenate([model.mass, [mass]]),
           "com": app(model.com, np.asarray(com, float)),
           "inertia": app(model.inertia, np.asarray(inertia, float)),
           "joint_limit_lower": np.concatenate([model.joint_limit_lower, [-np.inf]]),
           "joint_limit_upper": np.concatenate([model.joint_limit_upper, [np.inf]]),
           "effort_limit": np.concatenate([model.effort_limit, [np.inf]]),
           "velocity_limit": np.concatenate([model.velocity_limit, [np.inf]]),
           "damping": np.concatenate([model.damping, [0.0]]),
           "total_mass": float(np.sum(model.mass) + mass),
           }
    )
    keep = list(range(patched.nbody))
    parent_map = {i: int(patched.parent[i]) for i in keep if i != 0}
    return _rebuild(patched, keep, parent_map)


def change_link_inertia(
    model: RobotModel, body: int, mass: float, com: np.ndarray, inertia: np.ndarray
) -> RobotModel:
    """Replace a body's inertial parameters (``ChangeLinkInertia``,
    src/dwbc.cpp:2707-2748)."""
    new_mass = model.mass.copy()
    new_com = model.com.copy()
    new_inertia = model.inertia.copy()
    new_mass[body] = mass
    new_com[body] = np.asarray(com, float)
    new_inertia[body] = np.asarray(inertia, float)
    return RobotModel(
        **{**model.__dict__, "mass": new_mass, "com": new_com,
           "inertia": new_inertia, "total_mass": float(np.sum(new_mass))}
    )
