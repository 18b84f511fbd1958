"""Deploy-side observation builder of the KungfuBot2 student, in numpy
(counterpart of `pbhc_tpu/deploy/student_obs.py`, a copy: the port imports
nothing of the JAX package).

The exported student is the 3-input graph actor_obs / future_motion_targets
/ prop_history (reference deploy_real.py:820-905, inference_helpers.py:
95-138). `StudentObsBuilder` is the host twin of the observation getters of
`envs/general_tracking_env.py`: the same sorted-group layout, scales and
pre-push history, in numpy, so that it runs on the robot's onboard PC or
inside the MuJoCo sim2sim runtime. `MotionHost` copies a `MotionLib`'s
single clip to host numpy once (from whatever device the library is on) and
interpolates it there, as `motion_lib.get_motion_state` does.

Real-robot specifics, as in the reference controller:
* the dof and roll/pitch offsets captured at the first policy step and
  compensated (reference deploy_real.py:654-662,696-699,839-846);
* the reference motion's yaw aligned to the robot's initial heading
  (reference deploy_real.py `_ref_to_robot_frame`).
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------- numpy quats
def quat_mul(a, b):
    """xyzw hamilton product."""
    x1, y1, z1, w1 = np.moveaxis(a, -1, 0)
    x2, y2, z2, w2 = np.moveaxis(b, -1, 0)
    return np.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], axis=-1)


def quat_conj(q):
    return q * np.asarray([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)


def quat_rotate(q, v):
    qv, w = q[..., :3], q[..., 3:4]
    t = 2.0 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)


def quat_rotate_inverse(q, v):
    return quat_rotate(quat_conj(q), v)


def quat_to_matrix(q):
    x, y, z, w = np.moveaxis(q, -1, 0)
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)


def get_euler_xyz(q):
    """Roll/pitch/yaw from an xyzw quat (numpy twin of `maths/rotations.get_euler_xyz`)."""
    x, y, z, w = np.moveaxis(q, -1, 0)
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return np.stack([roll, pitch, yaw], axis=-1)


def yaw_quat(yaw):
    return np.stack([np.zeros_like(yaw), np.zeros_like(yaw),
                     np.sin(yaw / 2), np.cos(yaw / 2)], axis=-1)


def slerp(q0, q1, t):
    d = np.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = np.where(d < 0, -q1, q1)
    d = np.abs(d)
    lin = np.clip(d, 0.0, 1.0) > 0.9995
    th = np.arccos(np.clip(d, -1.0, 1.0))
    s = np.sin(th)
    w0 = np.where(lin, 1.0 - t, np.sin((1.0 - t) * th) / np.where(s == 0, 1.0, s))
    w1 = np.where(lin, t, np.sin(t * th) / np.where(s == 0, 1.0, s))
    out = w0 * q0 + w1 * q1
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


# ---------------------------------------------------------------- motion host
class MotionHost:
    """Host numpy copy of a `MotionLib`'s single-clip data with interpolation
    (host twin of `motion_lib.get_motion_state`; reference
    motion_lib_base.py:123-259)."""

    def __init__(self, motion_lib):
        d = motion_lib.data
        g = lambda x: x.detach().cpu().numpy()
        self.gts, self.grs = g(d.gts), g(d.grs)
        self.gvs, self.gavs = g(d.gvs), g(d.gavs)
        self.dof_pos, self.dof_vel = g(d.dof_pos), g(d.dof_vel)
        self.length = float(g(d.lengths)[0])
        self.dt = float(g(d.dt)[0])
        self.num_frames = int(g(d.num_frames)[0])

    def state(self, t):
        """Reference state at time(s) t (scalar or [S]); clamped to clip end."""
        t = np.asarray(t, dtype=np.float64)
        phase = np.clip(t / self.length, 0.0, 1.0)
        f0 = (phase * (self.num_frames - 1)).astype(np.int64)
        f1 = np.minimum(f0 + 1, self.num_frames - 1)
        b = np.clip((np.maximum(t, 0.0) - f0 * self.dt) / self.dt, 0.0, 1.0)
        be = b[..., None, None] if t.ndim else b   # broadcast over [.., B, 3]
        bd = b[..., None] if t.ndim else b         # broadcast over [.., nd]
        pos = (1 - be) * self.gts[f0] + be * self.gts[f1]
        rot_ = slerp(self.grs[f0], self.grs[f1], np.asarray(be))
        vel = (1 - be) * self.gvs[f0] + be * self.gvs[f1]
        ang = (1 - be) * self.gavs[f0] + be * self.gavs[f1]
        q = (1 - bd) * self.dof_pos[f0] + bd * self.dof_pos[f1]
        dq = (1 - bd) * self.dof_vel[f0] + bd * self.dof_vel[f1]
        return dict(body_pos=pos.astype(np.float32), body_rot=rot_.astype(np.float32),
                    body_vel=vel.astype(np.float32), body_ang_vel=ang.astype(np.float32),
                    dof_pos=q.astype(np.float32), dof_vel=dq.astype(np.float32))


# ------------------------------------------------------------------- builder
class StudentObsBuilder:
    """Builds {actor_obs, future_motion_targets, prop_history} per tick.

    `meta` is the exported student metadata: obs_groups/obs_dims/obs_scales/
    history_spec plus future_num_steps/future_max_steps/key_body_ids/
    anchor_index/default_dof_pos/dt/clip_obs.
    """

    HIST_KEYS = ("actions", "base_ang_vel", "dof_pos", "dof_vel", "roll_pitch")

    def __init__(self, meta, motion: MotionHost, compensate_offsets=True):
        """`compensate_offsets=True` mirrors the real-robot controller
        (capture+apply init dof/roll-pitch offsets, yaw-only anchor quat —
        deploy_real.py:654-662,843-852); False mirrors sim2sim/training
        (full anchor quat, no offsets — urcirobot idiom)."""
        self.meta = meta
        self.motion = motion
        self.compensate = bool(compensate_offsets)
        self.dims = meta["obs_dims"]
        self.scales = meta["obs_scales"]
        self.default_dof = np.asarray(meta["default_dof_pos"], dtype=np.float32)
        self.clip_obs = float(meta.get("clip_obs", 100.0))
        self.dt = float(meta["dt"])
        self.key_body_ids = np.asarray(meta["key_body_ids"], dtype=np.int64)
        self.anchor_index = int(meta.get("anchor_index", 0))
        S = int(meta["future_num_steps"])
        mx = int(meta.get("future_max_steps", 95))
        self.tar_obs_steps = np.linspace(1, mx, S).astype(np.int64)
        L = int(meta["history_length"])
        self.hist_len = L
        self.hist = {k: np.zeros((L, self.dims[k]), dtype=np.float32)
                     for k in self.HIST_KEYS}
        # first-policy-step capture (reference deploy_real.py:654-662)
        self.init_dof_offset = None
        self.init_rp_offset = None
        self.ref_yaw_offset = None   # robot_yaw0 - ref_yaw0 (_ref_to_robot_frame)

    def reset(self):
        for k in self.hist:
            self.hist[k][:] = 0
        self.init_dof_offset = None
        self.init_rp_offset = None
        self.ref_yaw_offset = None

    # -------------------------------------------------------------- helpers
    def _capture_offsets(self, q, quat_xyzw, t):
        rpy = get_euler_xyz(quat_xyzw)
        if self.compensate:
            self.init_dof_offset = (q - self.default_dof).astype(np.float32)
            self.init_rp_offset = rpy[:2].astype(np.float32)
        else:
            self.init_dof_offset = np.zeros_like(self.default_dof)
            self.init_rp_offset = np.zeros(2, dtype=np.float32)
        ref_rot = self.motion.state(t)["body_rot"][self.anchor_index]
        self.ref_yaw_offset = float(rpy[2] - get_euler_xyz(ref_rot)[2])

    def _ref_to_robot(self, qref):
        """Yaw-align a reference quat to the robot's initial heading."""
        return quat_mul(yaw_quat(np.asarray(self.ref_yaw_offset)), qref)

    # ---------------------------------------------------------------- build
    def build(self, robot, t):
        """robot exposes q, dq, quat_xyzw (IMU), base_ang_vel_local,
        last_action; `t` is the policy-mode clock in seconds."""
        q = np.asarray(robot.q, dtype=np.float32)
        dq = np.asarray(robot.dq, dtype=np.float32)
        quat = np.asarray(robot.quat_xyzw, dtype=np.float32)
        omega = np.asarray(robot.base_ang_vel_local, dtype=np.float32)
        if self.init_dof_offset is None:
            # yaw offset against the first policy target frame (t+dt), the
            # frame the robot's start pose corresponds to
            self._capture_offsets(q, quat, t + self.dt)

        sc = lambda name: float(self.scales.get(name, 1.0))
        # offset-compensated current obs (reference deploy_real.py:696-699,839-846)
        dof_pos = (q - self.default_dof - self.init_dof_offset) * sc("dof_pos")
        dof_vel = dq * sc("dof_vel")
        ang_vel = omega * sc("base_ang_vel")
        rpy = get_euler_xyz(quat)
        roll_pitch = (rpy[:2] - self.init_rp_offset) * sc("roll_pitch")
        actions = np.asarray(robot.last_action, dtype=np.float32) * sc("actions")

        # anchor_ref_rot: robot-anchor -> next-step-ref-anchor relative
        # rotation, first two matrix columns (general_tracking_env.py:160-166).
        # The robot quat is roll/pitch-offset compensated by replacing it with
        # its yaw-only part when an offset was captured (deploy_real.py:843-852).
        nxt = self.motion.state(t + self.dt)
        ref_anchor_rot = self._ref_to_robot(nxt["body_rot"][self.anchor_index])
        robot_quat_c = yaw_quat(np.asarray(rpy[2])) if self.compensate else quat
        rel = quat_mul(quat_conj(robot_quat_c), ref_anchor_rot)
        anchor_ref_rot = quat_to_matrix(rel)[..., :2].reshape(-1) * sc("anchor_ref_rot")

        # next_step_ref_motion (general_tracking_env.py:193-197): [root_h,
        # roll_pitch, local root vel, yaw vel, dof_pos, key bodies in the ref
        # anchor frame]
        n_rpy = get_euler_xyz(nxt["body_rot"][0])
        n_vel_loc = quat_rotate_inverse(nxt["body_rot"][0], nxt["body_vel"][0])
        n_ang_loc = quat_rotate_inverse(nxt["body_rot"][0], nxt["body_ang_vel"][0])
        a_pos = nxt["body_pos"][self.anchor_index]
        a_rot = nxt["body_rot"][self.anchor_index]
        kb = quat_rotate_inverse(
            np.broadcast_to(a_rot, (len(self.key_body_ids), 4)),
            nxt["body_pos"][self.key_body_ids] - a_pos)
        next_step = np.concatenate([
            nxt["body_pos"][0, 2:3], n_rpy[:2], n_vel_loc, n_ang_loc[2:3],
            nxt["dof_pos"], kb.reshape(-1)]).astype(np.float32) * sc("next_step_ref_motion")

        # history BEFORE pushing the current frame (the env reads the ring
        # buffer pre-roll: tracking_env.py:1273-1286)
        hist_flat = np.concatenate(
            [self.hist[k].reshape(-1) for k in self.HIST_KEYS]).astype(np.float32)

        actor_obs = np.concatenate([
            actions, anchor_ref_rot, ang_vel, dof_pos, dof_vel,
            hist_flat, next_step, roll_pitch]).astype(np.float32)

        # future targets, sorted group-member order, step-major per term
        # (general_tracking_env.py:169-190)
        ft = t + self.tar_obs_steps * self.dt
        fm = self.motion.state(ft)
        f_rot = fm["body_rot"][:, 0]
        f_rpy = get_euler_xyz(f_rot)
        f_vel = quat_rotate_inverse(f_rot, fm["body_vel"][:, 0])
        f_ang = quat_rotate_inverse(f_rot, fm["body_ang_vel"][:, 0])
        future = np.concatenate([
            (f_vel * sc("future_motion_base_lin_vel")).reshape(-1),
            (f_ang[:, 2:3] * sc("future_motion_base_yaw_vel")).reshape(-1),
            (fm["dof_pos"] * sc("future_motion_dof_pos")).reshape(-1),
            (f_rpy[:, :2] * sc("future_motion_roll_pitch")).reshape(-1),
            (fm["body_pos"][:, 0, 2:3] * sc("future_motion_root_height")).reshape(-1),
        ]).astype(np.float32)

        # push current scaled frame, newest first (tracking_env.py:1277-1280)
        cur = dict(actions=actions, base_ang_vel=ang_vel, dof_pos=dof_pos,
                   dof_vel=dof_vel, roll_pitch=roll_pitch)
        for k in self.hist:
            self.hist[k] = np.concatenate([cur[k][None], self.hist[k][:-1]], axis=0)

        c = self.clip_obs
        return {
            "actor_obs": np.clip(actor_obs, -c, c)[None],
            "future_motion_targets": np.clip(future, -c, c)[None],
            "prop_history": np.clip(hist_flat, -c, c)[None],
        }
