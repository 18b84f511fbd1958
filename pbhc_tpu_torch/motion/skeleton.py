"""Skeleton state/motion classes — the poselib equivalent (counterpart of
`pbhc_tpu/motion/skeleton.py`, numpy and scipy as there).

Compact numpy reimplementation of the vendored poselib surface the reference
pipeline uses (reference smpl_retarget/poselib/poselib/skeleton/
skeleton3d.py: SkeletonTree:21, SkeletonState:269 with local<->global rotation
conversion and `retarget_to`, SkeletonMotion:1009 with velocity computation;
and humanoidverse/utils/motion_lib/skeleton.py): tree bookkeeping by node
name, FK composition of local rotations, inverse (global->local), T-pose
calibrated cross-skeleton retargeting, and finite-difference velocities.

Offline tooling only (retarget/packaging/visualization) — the on-device FK
path is pbhc_tpu_torch.model.kinematics.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial.transform import Rotation as sRot


def _qmul(a, b):
    return (sRot.from_quat(a) * sRot.from_quat(b)).as_quat()


def _qinv(q):
    return sRot.from_quat(q).inv().as_quat()


@dataclasses.dataclass
class SkeletonTree:
    """Kinematic tree: names, parents, rest-pose local translations
    (reference poselib skeleton3d.py:21-267)."""

    node_names: list
    parent_indices: np.ndarray      # [J] int, -1 for root
    local_translation: np.ndarray   # [J,3]
    # fixed body-frame rotation offset in the parent frame (MJCF body quat;
    # identity for SMPL-style skeletons, non-identity for e.g. G1 ankles)
    local_rotation_offset: np.ndarray = None  # [J,4] xyzw

    def __post_init__(self):
        if self.local_rotation_offset is None:
            off = np.zeros((self.num_joints, 4), dtype=np.float32)
            off[:, 3] = 1.0
            self.local_rotation_offset = off

    @classmethod
    def from_robot_model(cls, model):
        """From an MJCF-compiled RobotModel (body tree)."""
        return cls(list(model.body_names),
                   np.asarray(model.parent, dtype=np.int64),
                   np.asarray(model.local_pos, dtype=np.float32),
                   np.asarray(model.local_quat, dtype=np.float32))

    @classmethod
    def from_mjcf(cls, path):
        from pbhc_tpu_torch.model.mjcf import load_mjcf

        return cls.from_robot_model(load_mjcf(path))

    @property
    def num_joints(self):
        return len(self.node_names)

    def index(self, name):
        return self.node_names.index(name)


@dataclasses.dataclass
class SkeletonState:
    """Rotations of every joint + root translation for T frames
    (reference poselib skeleton3d.py:269-1007)."""

    tree: SkeletonTree
    local_rotation: np.ndarray    # [T,J,4] xyzw
    root_translation: np.ndarray  # [T,3]

    # ----------------------------------------------------------------- FK
    @property
    def global_rotation(self):
        T, J, _ = self.local_rotation.shape
        off = self.tree.local_rotation_offset
        out = np.empty_like(self.local_rotation)
        for j in range(J):
            p = self.tree.parent_indices[j]
            oj = np.tile(off[j], (T, 1))
            if p < 0:
                out[:, j] = _qmul(oj, self.local_rotation[:, j])
            else:
                out[:, j] = _qmul(_qmul(out[:, p], oj), self.local_rotation[:, j])
        return out

    @property
    def global_translation(self):
        g = self.global_rotation
        T, J, _ = self.local_rotation.shape
        out = np.empty((T, J, 3), dtype=np.float32)
        for j in range(J):
            p = self.tree.parent_indices[j]
            if p < 0:
                out[:, j] = self.root_translation
            else:
                out[:, j] = out[:, p] + sRot.from_quat(g[:, p]).apply(self.tree.local_translation[j])
        return out

    @classmethod
    def from_global_rotation(cls, tree, global_rotation, root_translation):
        """global -> local: R_local[j] = R_global[parent]^-1 * R_global[j]."""
        T, J, _ = global_rotation.shape
        off = tree.local_rotation_offset
        local = np.empty_like(global_rotation)
        for j in range(J):
            p = tree.parent_indices[j]
            oj = np.tile(off[j], (T, 1))
            if p < 0:
                local[:, j] = _qmul(_qinv(oj), global_rotation[:, j])
            else:
                local[:, j] = _qmul(_qinv(_qmul(global_rotation[:, p], oj)),
                                    global_rotation[:, j])
        return cls(tree, local, np.asarray(root_translation, dtype=np.float32))

    @classmethod
    def zero_pose(cls, tree, num_frames=1):
        q = np.zeros((num_frames, tree.num_joints, 4), dtype=np.float32)
        q[..., 3] = 1.0
        return cls(tree, q, np.zeros((num_frames, 3), dtype=np.float32))

    # ------------------------------------------------------------ retarget
    def retarget_to(self, joint_mapping: dict, source_tpose: "SkeletonState",
                    target_tpose: "SkeletonState", scale_to_target_skeleton: float = 1.0):
        """T-pose-calibrated rotation transfer (reference poselib
        skeleton3d.py `retarget_to`): for each mapped joint the world-frame
        delta from the source T-pose is applied onto the target T-pose,
        unmapped target joints hold their T-pose rotation; root translation is
        scaled and offset so the T-pose roots coincide.
        joint_mapping: {source_node_name: target_node_name}.
        """
        src_g = self.global_rotation                       # [T,Js,4]
        src_tpose_g = source_tpose.global_rotation[0]      # [Js,4]
        tgt_tpose_g = target_tpose.global_rotation[0]      # [Jt,4]
        T = src_g.shape[0]
        Jt = target_tpose.tree.num_joints

        tgt_g = np.broadcast_to(tgt_tpose_g, (T, Jt, 4)).copy()
        for s_name, t_name in joint_mapping.items():
            s = self.tree.index(s_name)
            t = target_tpose.tree.index(t_name)
            delta = _qmul(src_g[:, s], np.tile(_qinv(src_tpose_g[s]), (T, 1)))
            tgt_g[:, t] = _qmul(delta, np.tile(tgt_tpose_g[t], (T, 1)))

        root_off = (self.root_translation - source_tpose.root_translation[0]) \
            * scale_to_target_skeleton
        root = target_tpose.root_translation[0][None] + root_off
        return SkeletonState.from_global_rotation(target_tpose.tree, tgt_g, root)


@dataclasses.dataclass
class SkeletonMotion(SkeletonState):
    """SkeletonState + fps + finite-difference global velocities
    (reference poselib skeleton3d.py:1009-1180)."""

    fps: float = 30.0

    @classmethod
    def from_state(cls, state: SkeletonState, fps: float):
        return cls(state.tree, state.local_rotation, state.root_translation, fps=float(fps))

    @property
    def global_velocity(self):
        p = self.global_translation
        return np.gradient(p, axis=0) * self.fps

    @property
    def global_angular_velocity(self):
        g = self.global_rotation
        T, J, _ = g.shape
        w = np.zeros((T, J, 3), dtype=np.float32)
        if T > 1:
            dq = (sRot.from_quat(g[1:].reshape(-1, 4))
                  * sRot.from_quat(g[:-1].reshape(-1, 4)).inv()).as_rotvec()
            w[:-1] = dq.reshape(T - 1, J, 3) * self.fps
            w[-1] = w[-2]
        return w
