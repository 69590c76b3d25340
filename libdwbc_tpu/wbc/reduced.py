"""Reduced-dimension contact-consistent dynamics (the reference's `_R` path).

Re-derivation of ``ReducedDynamicsCalculate`` and the reduced pipeline
(/root/reference/src/dwbc.cpp:2752-3770): the kinematic tree is split at
model-compile time into the **contact chain** (links on a path from any
active contact to the base) and the **non-contact chain**; the non-contact
chain is lumped into a single 6-DoF virtual body via its locked spatial
inertia and centroidal momentum matrix, and the whole OSF-HQP cascade runs
in ``reduced_system_dof = co_dof + 12`` coordinates.

Differences from the reference:
* chain classification is static per contact mode → plain index arrays;
* the partial CRBA over the nc subtree (which pokes RBDL's internals,
  src/dwbc.cpp:2828-2878) becomes masked dense einsums over per-body
  jacobians in the base frame — same math, matmul-shaped;
* no rank-revealing COD: the reduced contact space reuses the closed-form
  kernel factorization from dynamics.contact_space.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..kin.engine import KinState
from ..kin.rotations import skew
from ..model.compile import RobotModel
from .dynamics import ContactSpace, _psd_inv, contact_space


@dataclasses.dataclass(frozen=True)
class ReducedIndex:
    """Static chain classification for one contact mode
    (src/dwbc.cpp:2755-2823)."""

    co_links: tuple[int, ...]
    nc_links: tuple[int, ...]
    co_joints: np.ndarray       # qdot indices of contact-chain joints
    nc_joints: np.ndarray       # qdot indices of non-contact-chain joints
    vc_joints: np.ndarray       # [0..5] + co_joints
    co_dof: int
    nc_dof: int
    vc_dof: int
    reduced_model_dof: int      # co_dof + 6
    reduced_system_dof: int     # co_dof + 12


def classify_chains(model: RobotModel, contact_links: list[int]) -> ReducedIndex:
    co_links = {0}
    for cl in contact_links:
        k = cl
        while k != 0:
            co_links.add(k)
            k = int(model.parent[k])
    nc_links = [i for i in range(model.nbody) if i not in co_links]
    co_joints = sorted(int(model.q_index[i]) for i in co_links if i != 0)
    nc_joints = sorted(int(model.q_index[i]) for i in nc_links)
    co_dof = len(co_joints)
    nc_dof = len(nc_joints)
    return ReducedIndex(
        co_links=tuple(sorted(co_links)),
        nc_links=tuple(nc_links),
        co_joints=np.array(co_joints, dtype=np.int64),
        nc_joints=np.array(nc_joints, dtype=np.int64),
        vc_joints=np.array(list(range(6)) + co_joints, dtype=np.int64),
        co_dof=co_dof,
        nc_dof=nc_dof,
        vc_dof=co_dof + 6,
        reduced_model_dof=co_dof + 6,
        reduced_system_dof=co_dof + 12,
    )


class ReducedDynamics(NamedTuple):
    """Per-tick reduced-dynamics quantities (base-frame where noted)."""

    mass_nc: jnp.ndarray        # ()
    com_pos_nc: jnp.ndarray     # (3,) nc-chain COM, base frame
    inertia_nc: jnp.ndarray     # (3,3) nc-chain locked inertia about its COM
    cmm_nc: jnp.ndarray         # (6,nc_dof) nc centroidal momentum matrix
    J_I_nc: jnp.ndarray         # (6,nc_dof) lumped-body velocity map
    A_NC_joint: jnp.ndarray     # (nc,nc) nc-subtree joint-space mass matrix
    J_R: jnp.ndarray            # (r_sys,n) reduction jacobian
    A_R_inv: jnp.ndarray        # (r_sys,r_sys)
    A_R: jnp.ndarray
    J_I_nc_inv_T: jnp.ndarray   # (6,nc_dof) dynamically consistent inverse-T
    N_I_nc: jnp.ndarray         # (nc,nc) nc null projector
    J_R_INV_T: jnp.ndarray      # (r_sys,n)
    G_R: jnp.ndarray            # (r_sys,)
    G_NC: jnp.ndarray           # (nc,)


def reduced_dynamics(
    model: RobotModel, idx: ReducedIndex, st: KinState
) -> ReducedDynamics:
    """Lump the non-contact chain into a virtual 6-DoF body
    (``ReducedDynamicsCalculate``, src/dwbc.cpp:2752-2989)."""
    dtype = st.A.dtype
    nc = list(idx.nc_links)
    ncj = jnp.asarray(idx.nc_joints)
    vcj = jnp.asarray(idx.vc_joints)
    n = model.ndof
    r_sys = idx.reduced_system_dof
    vc_dof = idx.vc_dof
    nc_dof = idx.nc_dof

    R0 = st.R[..., 0, :, :]
    R0T = jnp.swapaxes(R0, -1, -2)
    p0 = st.p[..., 0, :]

    mass = jnp.asarray(model.mass[nc], dtype=dtype)             # (b,)
    inertia_l = jnp.asarray(model.inertia[nc], dtype=dtype)     # (b,3,3)

    # nc-body poses relative to base (base frame)
    R_rel = jnp.einsum("...ij,...bjk->...bik", R0T, st.R[..., nc, :, :])
    com_rel = jnp.einsum(
        "...ij,...bj->...bi", R0T, st.com_w[..., nc, :] - p0[..., None, :]
    )
    I_rel = jnp.einsum("...bij,bjk,...blk->...bil", R_rel, inertia_l, R_rel)

    mass_nc = jnp.sum(mass)
    com_pos_nc = jnp.einsum("b,...bi->...i", mass, com_rel) / mass_nc
    d = com_rel - com_pos_nc[..., None, :]
    inertia_nc = jnp.sum(I_rel, axis=-3) + jnp.einsum(
        "b,...bij,...bkj->...ik", mass, skew(d), skew(d)
    )

    # relative jacobians of nc bodies w.r.t. nc joints (base frame):
    # slice the world-frame jacobians and rotate — J columns are world-frame
    # axis fields, so base-frame jac = R0ᵀ · (world jac columns at nc dofs).
    Jv_w = st.Jcom[..., nc, 0:3, :][..., :, :, ncj]              # (...,b,3,ncd)
    Jw_w = st.Jcom[..., nc, 3:6, :][..., :, :, ncj]
    Jv = jnp.einsum("...ij,...bjk->...bik", R0T, Jv_w)
    Jw = jnp.einsum("...ij,...bjk->...bik", R0T, Jw_w)

    lin = jnp.einsum("b,...bik->...ik", mass, Jv)                # (...,3,ncd)
    ang = jnp.einsum("...bij,...bjk->...ik", I_rel, Jw) + jnp.einsum(
        "b,...bij,...bjk->...ik", mass, skew(d), Jv
    )
    cmm_nc = jnp.concatenate([lin, ang], axis=-2)                # (...,6,ncd)

    # nc-subtree joint-space mass matrix (the A_NC bottom-right block the
    # reference extracts from its partial CRBA, src/dwbc.cpp:2892-2904):
    # KE metric over nc bodies w.r.t. nc joint velocities (base frozen).
    # Jv is already the body-COM point jacobian (sliced from st.Jcom).
    A_NC_joint = jnp.einsum("b,...bik,...bil->...kl", mass, Jv, Jv) + jnp.einsum(
        "...bik,...bij,...bjl->...kl", Jw, I_rel, Jw
    )

    SI_l = jnp.zeros(cmm_nc.shape[:-2] + (6, 6), dtype=dtype)
    SI_l = SI_l.at[..., 0, 0].set(mass_nc).at[..., 1, 1].set(mass_nc).at[..., 2, 2].set(mass_nc)
    SI_l = SI_l.at[..., 3:6, 3:6].set(inertia_nc)
    J_I_nc = jnp.linalg.solve(SI_l, cmm_nc)                      # (...,6,ncd)

    # reduction jacobian J_R (src/dwbc.cpp:2918-2930)
    batch = cmm_nc.shape[:-2]
    J_R = jnp.zeros(batch + (r_sys, n), dtype=dtype)
    J_R = J_R.at[..., jnp.arange(vc_dof), vcj].set(1.0)
    J_R = J_R.at[..., vc_dof:, ncj].set(J_I_nc)

    A_R_inv = J_R @ st.A_inv @ jnp.swapaxes(J_R, -1, -2)
    A_R_inv = 0.5 * (A_R_inv + jnp.swapaxes(A_R_inv, -1, -2))
    A_R = _psd_inv(A_R_inv)

    # J̄_Rᵀ = A_R J_R A⁻¹, with the structural zero pattern enforced
    # (src/dwbc.cpp:2968-2980)
    JRIT_dense = A_R @ J_R @ st.A_inv
    J_I_nc_inv_T = JRIT_dense[..., vc_dof:, :][..., :, ncj]
    J_R_INV_T = jnp.zeros_like(JRIT_dense)
    J_R_INV_T = J_R_INV_T.at[..., jnp.arange(vc_dof), vcj].set(1.0)
    J_R_INV_T = J_R_INV_T.at[..., vc_dof:, ncj].set(J_I_nc_inv_T)

    N_I_nc = jnp.eye(nc_dof, dtype=dtype) - jnp.swapaxes(J_I_nc, -1, -2) @ J_I_nc_inv_T

    G_vc = st.G[..., vcj]
    G_nc = st.G[..., ncj]
    G_R = jnp.concatenate(
        [G_vc, jnp.einsum("...ij,...j->...i", J_I_nc_inv_T, G_nc)], axis=-1
    )
    return ReducedDynamics(
        mass_nc=mass_nc, com_pos_nc=com_pos_nc, inertia_nc=inertia_nc,
        cmm_nc=cmm_nc, J_I_nc=J_I_nc, A_NC_joint=A_NC_joint,
        J_R=J_R, A_R_inv=A_R_inv, A_R=A_R,
        J_I_nc_inv_T=J_I_nc_inv_T, N_I_nc=N_I_nc, J_R_INV_T=J_R_INV_T,
        G_R=G_R, G_NC=G_nc,
    )


def reduced_contact_space(idx: ReducedIndex, J_C, rd: ReducedDynamics) -> ContactSpace:
    """Contact-space factorization in reduced coordinates
    (``ReducedCalcContactConstraint``, src/dwbc.cpp:3077-3142).  Reuses the
    generic closed-form kernel factorization."""
    vcj = jnp.asarray(idx.vc_joints)
    batch = J_C.shape[:-2]
    J_CR = jnp.zeros(batch + (J_C.shape[-2], idx.reduced_system_dof), dtype=J_C.dtype)
    J_CR = J_CR.at[..., :, : idx.vc_dof].set(J_C[..., :, vcj])
    return contact_space(J_CR, rd.A_R_inv), J_CR


def reduced_gravity(idx: ReducedIndex, cs_r: ContactSpace, rd: ReducedDynamics, G):
    """τ_g in reduced coords + recomposition (src/dwbc.cpp:3144-3150).

    Returns (torque_grav_full(model_dof), torque_grav_R(r_model), P_CR).
    """
    r_model = idx.reduced_model_dof
    NG = jnp.einsum("...ij,...j->...i", cs_r.N_C, rd.G_R)
    tgR = jnp.einsum(
        "...ij,...j->...i", cs_r.W_inv,
        jnp.einsum("...ij,...j->...i", rd.A_R_inv[..., -r_model:, :], NG),
    )
    P_CR = jnp.einsum("...ij,...j->...i", cs_r.J_C_INV_T, rd.G_R)
    # final actuated gravity torque: co part from the reduced solve, nc part
    # raw gravity (the nc chain self-compensates) — src/dwbc.cpp:3147-3148
    tg_full = jnp.concatenate([tgR[..., : idx.co_dof], rd.G_NC], axis=-1)
    return tg_full, tgR, P_CR
