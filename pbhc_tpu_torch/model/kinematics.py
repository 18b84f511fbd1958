"""Batched forward kinematics over the robot tree (counterpart of
`pbhc_tpu/model/kinematics.py`).

Every function takes leading batch dims (`[..., B, 3]` etc.) where the JAX
module works on one sample under `vmap`. Bodies are processed level by level
down the tree: each level is one batched product, parents are gathered by
their position in the level-sorted concatenation (no scatters).
"""
from __future__ import annotations

import numpy as np
import torch

from pbhc_tpu_torch.maths import rotations as rot
from pbhc_tpu_torch.model.mjcf import RobotModel


def _level_order(model: RobotModel):
    """(order, pos, parent_pos per level); `kinematics.py:20`."""
    order = [0] + [int(i) for lv in model.levels for i in lv]
    pos = np.zeros(model.num_bodies, dtype=np.int64)
    for p, b in enumerate(order):
        pos[b] = p
    parent_pos = [pos[model.parent[lv]] for lv in model.levels]
    return np.asarray(order), pos, parent_pos


def _fk_levels(model: RobotModel, R_root, p_root, R_joint):
    """Level-wise FK (`kinematics.py:35`).

    R_root [...,3,3], p_root [...,3], R_joint [...,B,3,3] (root row ignored:
    the root pose comes in directly) -> world (p [...,B,3], R [...,B,3,3]).
    """
    dev = R_joint.device
    R_local = rot.quat_to_matrix(torch.as_tensor(model.local_quat, dtype=torch.float32, device=dev))
    local_pos = torch.as_tensor(model.local_pos, dtype=torch.float32, device=dev)
    _, pos, parent_pos = _level_order(model)

    R_acc = R_root[..., None, :, :]
    p_acc = p_root[..., None, :]
    for lv, ppos in zip(model.levels, parent_pos):
        Rp = R_acc[..., ppos, :, :]
        p_new = torch.einsum("...lij,lj->...li", Rp, local_pos[lv]) + p_acc[..., ppos, :]
        R_new = Rp @ R_local[lv] @ R_joint[..., lv, :, :]
        R_acc = torch.cat([R_acc, R_new], dim=-3)
        p_acc = torch.cat([p_acc, p_new], dim=-2)
    return p_acc[..., pos, :], R_acc[..., pos, :, :]


def _clamped(index, rows: int):
    """`index` clipped to `rows - 1`. JAX clamps an out-of-range gather index,
    so where a clip has fewer pose rows than the model has bodies (a 23-DoF
    clip, 27 rows, on the 29-DoF model, 30 bodies) the JAX package reads its
    last row for the bodies beyond; the port reads the same."""
    return np.minimum(np.asarray(index), rows - 1)


def fk_pose_aa(model: RobotModel, pose_aa, trans):
    """Motion-data FK (`kinematics.py:59`): pose_aa [...,J,3] per-body
    axis-angle (index 0 = root), trans [...,3] -> (pos [...,B,3], quat [...,B,4])."""
    rows = _clamped(np.arange(model.num_bodies), pose_aa.shape[-2])
    R_pose = rot.quat_to_matrix(rot.exp_map_to_quat(pose_aa[..., rows, :]))
    p_w, R_w = _fk_levels(model, R_pose[..., 0, :, :], trans, R_pose)
    return p_w, rot.matrix_to_quat(R_w)


def joint_rotations_from_dof(model: RobotModel, dof_pos):
    """Per-body joint rotations from hinge angles [...,nd] -> [...,B,3,3]."""
    axis = torch.as_tensor(model.dof_axis, dtype=torch.float32, device=dof_pos.device)
    R = rot.quat_to_matrix(rot.quat_from_angle_axis(dof_pos, axis.expand(dof_pos.shape + (3,))))
    nd = model.num_dof
    slot = np.full(model.num_bodies, nd, dtype=np.int64)
    slot[np.asarray(model.dof_body)] = np.arange(nd)
    eye = torch.eye(3, device=dof_pos.device).expand(dof_pos.shape[:-1] + (1, 3, 3))
    return torch.cat([R, eye], dim=-3)[..., slot, :, :]


def fk_root_dof(model: RobotModel, root_pos, root_quat, dof_pos):
    """Simulator FK (`kinematics.py:88`) -> (pos [...,B,3], quat [...,B,4], R [...,B,3,3])."""
    R_joint = joint_rotations_from_dof(model, dof_pos)
    p_w, R_w = _fk_levels(model, rot.quat_to_matrix(root_quat), root_pos, R_joint)
    return p_w, rot.matrix_to_quat(R_w), R_w


def fk_velocities(model: RobotModel, body_pos, body_R, root_lin_vel, root_ang_vel, dof_vel):
    """World-frame body velocities at each body origin (`kinematics.py:100`)."""
    nd = model.num_dof
    dof_body = np.asarray(model.dof_body)
    axis_local = torch.as_tensor(model.dof_axis, dtype=torch.float32, device=dof_vel.device)
    slot = np.full(model.num_bodies, nd, dtype=np.int64)
    slot[dof_body] = np.arange(nd)
    axis_w_d = torch.einsum("...dij,dj->...di", body_R[..., dof_body, :, :], axis_local) * dof_vel[..., None]
    twist = torch.cat([axis_w_d, torch.zeros_like(axis_w_d[..., :1, :])], dim=-2)[..., slot, :]

    _, pos, parent_pos = _level_order(model)
    v_acc = root_lin_vel[..., None, :]
    w_acc = root_ang_vel[..., None, :]
    for lv, ppos in zip(model.levels, parent_pos):
        wp = w_acc[..., ppos, :]
        w_new = wp + twist[..., lv, :]
        v_new = v_acc[..., ppos, :] + rot.cross(wp, body_pos[..., lv, :] - body_pos[..., model.parent[lv], :])
        w_acc = torch.cat([w_acc, w_new], dim=-2)
        v_acc = torch.cat([v_acc, v_new], dim=-2)
    return v_acc[..., pos, :], w_acc[..., pos, :]


def dof_from_pose_aa(model: RobotModel, pose_aa):
    """Hinge angles from per-body axis-angle (`kinematics.py:128`): [...,J,3] -> [...,nd]."""
    sgn = torch.as_tensor(np.asarray(model.dof_axis).sum(-1), dtype=torch.float32, device=pose_aa.device)
    return pose_aa[..., _clamped(model.dof_body, pose_aa.shape[-2]), :].sum(-1) * sgn
