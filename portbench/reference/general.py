"""Plain reference of one control step of KungfuBot2's general-tracking env
(`GeneralTrackingEnv` on the lanes engine) over a multi-clip library,
followed from the program's own state.

It builds on the motion-tracking step's reference (`reference/tracking.py`:
the PD torques, every substep of the engine, the closing body states and
contact forces, the penalty and limit terms) and adds what the general env
changes:

- the motion library: every clip of the configuration file's library
  through `reference/motion.py` (forward kinematics, velocities, contact
  mask; zeros where a clip has none), each env's reference state looked up
  in its own clip by its motion id;
- the anchor and anchor-yaw-aligned diffs: the reference's bodies moved so
  that its anchor (the pelvis) sits under the robot's anchor in x and y,
  turned by the yaw of the robot's anchor against the reference's;
- the reward's tracking terms: key-body positions and rotations in that
  aligned frame, key-body linear and angular velocities, the anchor's
  position and rotation, the root's velocity in its own frame;
- the reward summed over its columns (the run keeps no per-term vector),
  the termination term included: the scale on every env that ended its
  episode without a timeout;
- the observations of the envs that did not reset: the robot's key bodies
  in its anchor frame, the reference anchor in the robot's anchor frame,
  roll and pitch, the root's height, the contact mask the step was given,
  and the future targets: the reference at `future_num_steps` control-step
  offsets `linspace(1, future_max_steps, S)` truncated to integers after
  the step's end, flattened step-major (root height, roll and pitch, the
  root's linear velocity and yaw rate in its own frame, joint angles, the
  key bodies in the reference anchor's frame), and the first of them as
  the next step's compact target.

Not worked out, as in `reference/tracking.py`: the terminations themselves
(thresholds that rounding can flip) and the resets.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from . import motion, tracking
from .engine import quat_to_matrix
from .tracking import quat_mul, quat_rotate, quat_rotate_inverse


def conjugate(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def angle(q):
    """The rotation angle of unit quaternions, in [0, pi]."""
    return 2.0 * torch.atan2(torch.linalg.vector_norm(q[..., :3], dim=-1), torch.abs(q[..., 3]))


def heading(q):
    """The yaw of the rotated x-axis."""
    x = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    x[..., 0] = 1.0
    r = quat_rotate(q, x)
    return torch.atan2(r[..., 1], r[..., 0])


def yaw_quat(yaw):
    z = torch.zeros_like(yaw)
    return torch.stack([z, z, torch.sin(0.5 * yaw), torch.cos(0.5 * yaw)], dim=-1)


def roll_pitch(q):
    """Roll and pitch of the x-y-z Euler angles, in the form that holds
    for the interpolated reference's quaternions, which are not unit."""
    x, y, z, w = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), w * w - x * x - y * y + z * z)
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    return torch.stack([roll, pitch], dim=-1)


def two_columns(q):
    """The first two columns of each rotation's matrix, flattened row by row."""
    return quat_to_matrix(q)[..., :2].reshape(q.shape[:-1] + (6,))


def clip_motion(root, snapshot: dict, device, clip: dict):
    """`motion.Motion` of one clip of a library already read: the clip is
    handed to it in place of a file."""
    read = motion.load_clips
    motion.load_clips = lambda path: {"clip": clip}
    try:
        return motion.Motion(root, snapshot, device)
    finally:
        motion.load_clips = read


class Library:
    """Every clip of a library file, in its order, on `device`."""

    def __init__(self, root, snapshot: dict, device, path):
        self.clips = [clip_motion(root, snapshot, device, c) for c in motion.load_clips(path).values()]

    def state(self, ids, times):
        """The reference of each entry of `ids` at `times` (same shape), in
        its own clip: {key: [*ids.shape, ...]}."""
        flat_ids, flat_t = ids.reshape(-1), times.reshape(-1)
        out = {}
        for m in flat_ids.unique().tolist():
            sel = flat_ids == m
            for k, v in self.clips[m].state(flat_t[sel]).items():
                if k not in out:
                    out[k] = torch.zeros((flat_ids.shape[0], *v.shape[1:]), dtype=v.dtype, device=v.device)
                out[k][sel] = v
        return {k: v.reshape(*ids.shape, *v.shape[1:]) for k, v in out.items()}


class Reference(tracking.Reference):
    def __init__(self, config: dict, root, device, precision: str = "float32"):
        super().__init__(config, root, device, precision)
        with open(Path(root) / config["snapshot"]) as f:
            snap = json.load(f)
        rc, o = snap["robot"], snap["obs"]
        self.library = Library(root, snap, device, Path(root) / config["motion_file"])
        names_ext = list(self.engine.tb["names"]) + [x["joint_name"] for x in rc["motion"]["extend_config"]]
        self.key = np.asarray([names_ext.index(n) for n in rc["key_bodies"]])
        self.anchor = names_ext.index(rc["motion"].get("anchor_link", "pelvis"))
        steps = np.linspace(1, int(o["future_max_steps"]), int(o["future_num_steps"])).astype(np.int32)
        self.future_steps = torch.as_tensor(steps.astype(np.float32), device=self.dev)
        scales = {k: float(v) for k, v in snap["rewards"]["reward_scales"].items()}
        self.termination_scale = scales.get("termination", 0.0) * self.dt
        if snap["env"]["config"].get("use_vec_reward", True):
            raise NotImplementedError("the reference reads the summed reward of a run without a reward vector")
        if self.dr.get("randomize_base_mass", False):
            raise NotImplementedError("the reference reads runs without an added base mass")

    # ------------------------------------------------------------ the motion
    def times(self, rec):
        """Seconds into each env's clip at the step's end (its episode length
        after the step, in control steps)."""
        pre = rec["pre"]
        return (pre["episode_length"] + 1).to(torch.float32) * self.dt + pre["motion_start_times"]

    def reference_state(self, rec):
        """The reference one control step after the step's end, each env in
        its own clip."""
        return self.library.state(rec["pre"]["motion_ids"], self.times(rec) + self.dt)

    def future(self, rec):
        """The reference at the future offsets, [N, S, ...]."""
        t = self.times(rec)[:, None] + self.future_steps[None] * self.dt
        ids = rec["pre"]["motion_ids"][:, None].expand(t.shape)
        return self.library.state(ids, t)

    # --------------------------------------------------------------- rewards
    def tracking_terms(self, rec, touch) -> dict:
        """The general env's tracking terms, name -> [N], against the
        reference one control step ahead of the step's end."""
        ref = self.reference_state(rec)
        post = rec["post_sim"]
        pos, quat, vel, ang = self.extended(post)
        sig = {k: rec["pre"]["sigma_values"][i] for i, k in enumerate(self.sigma_terms)}
        track = lambda err, term: torch.exp(-err / sig[term])
        msq = lambda x: (x ** 2).mean(-1).mean(-1)
        k, a = self.key, self.anchor
        # the reference's bodies under the robot's anchor, turned by the yaw between the two anchors
        ref_anchor_pos, ref_anchor_quat = ref["rg_pos"][:, a], ref["rb_rot"][:, a]
        shift = torch.cat([pos[:, a, :2], ref_anchor_pos[:, 2:3]], dim=-1)[:, None]
        turn = yaw_quat(heading(quat_mul(quat[:, a], conjugate(ref_anchor_quat))))[:, None]
        aligned_pos = shift + quat_rotate(turn.expand(ref["rg_pos"].shape[:-1] + (4,)),
                                          ref["rg_pos"] - ref_anchor_pos[:, None])
        aligned_quat = quat_mul(turn.expand(ref["rb_rot"].shape), ref["rb_rot"])
        root_vel = quat_rotate_inverse(ref["rb_rot"][:, 0], ref["body_vel"][:, 0]) \
            - quat_rotate_inverse(post["root_quat"], post["root_lin_vel"])
        r = {
            "key_body_velocity": track(msq((ref["body_vel"] - vel)[:, k]), "key_body_vel"),
            "key_body_ang_velocity": track(msq((ref["body_ang_vel"] - ang)[:, k]), "key_body_ang_vel"),
            "local_key_body_position": track(msq((aligned_pos - pos)[:, k]), "local_key_body_pos"),
            "local_key_body_rotation": track((angle(quat_mul(aligned_quat, conjugate(quat))[:, k]) ** 2).mean(-1),
                                             "local_key_body_rot"),
            "teleop_anchor_body_position": track(((ref["rg_pos"][:, a] - pos[:, a]) ** 2).mean(-1),
                                                 "teleop_anchor_body_pos"),
            "teleop_anchor_body_rotation": track(angle(quat_mul(ref_anchor_quat, conjugate(quat[:, a]))) ** 2,
                                                 "teleop_anchor_body_rot"),
            "teleop_root_vel": track((root_vel ** 2).mean(-1), "teleop_root_vel"),
        }
        return {name: v for name, v in r.items() if name in self.columns}

    def reward_gap(self, rec) -> float:
        """The summed reward: max |a - b| over the larger of the two's
        largest entries."""
        terms = self.reward_terms(rec)
        want = torch.zeros_like(rec["rew"][:, 0])
        for name, scale in zip(self.columns, self.scales):
            if name not in terms:
                raise NotImplementedError(f"the reference does not work out the reward term {name}")
            term = terms[name] * scale
            if name in self.penalised_terms:
                term = term * rec["pre"]["reward_penalty_scale"]
            want = want + torch.nan_to_num(term, nan=0.0, posinf=0.0, neginf=0.0)
        want = want + (rec["done"] & ~rec["time_out"]).to(torch.float32) * self.termination_scale
        got, want = rec["rew"][:, 0].double(), want.double()
        top = max(float(want.abs().max()), float(got.abs().max()))
        return float((got - want).abs().max()) / top if top > 0 else 0.0

    # ---------------------------------------------------------- observations
    def raw_observations(self, rec) -> dict:
        """Every observation part the run's groups read, before noise and
        scale, name -> [N, width]."""
        pre, post, prm = rec["pre"], rec["post_sim"], rec["params"]
        N = post["root_pos"].shape[0]
        quat = post["root_quat"]
        pos, bquat, _, _ = self.extended(post)
        a, k = self.anchor, self.key
        inv = conjugate(bquat[:, a])
        ref = self.reference_state(rec)
        fut = self.future(rec)
        f_root = fut["rb_rot"][:, :, 0]
        f_vel = quat_rotate_inverse(f_root, fut["body_vel"][:, :, 0])
        f_ang = quat_rotate_inverse(f_root, fut["body_ang_vel"][:, :, 0])
        f_inv = conjugate(fut["rb_rot"][:, :, a])[:, :, None]
        f_rel = fut["rg_pos"] - fut["rg_pos"][:, :, a][:, :, None]
        f_key = quat_rotate(f_inv.expand(f_rel.shape[:-1] + (4,)), f_rel)[:, :, k]
        f_rp = roll_pitch(f_root)
        return {
            "base_lin_vel": quat_rotate_inverse(quat, post["root_lin_vel"]),
            "base_ang_vel": quat_rotate_inverse(quat, post["root_ang_vel"]),
            "dof_pos": post["dof_pos"] - pre["default_dof_pos"], "dof_vel": post["dof_vel"],
            "actions": torch.clamp(rec["actions"], -self.action_clip, self.action_clip),
            "roll_pitch": roll_pitch(quat), "root_height": post["root_pos"][:, 2:3],
            "contact_mask": pre["contacts_filt"],
            "local_key_body_pos": quat_rotate(inv[:, None].expand(pos.shape[:-1] + (4,)),
                                              pos - pos[:, a][:, None])[:, k].reshape(N, -1),
            "local_key_body_rot": two_columns(quat_mul(inv[:, None].expand(bquat.shape), bquat))[:, k].reshape(N, -1),
            "anchor_ref_pos": quat_rotate(inv, ref["rg_pos"][:, a] - pos[:, a]),
            "anchor_ref_rot": two_columns(quat_mul(inv, ref["rb_rot"][:, a])),
            "dr_base_com": prm["com"][:, 0].T - self.base_com,
            "dr_base_mass": torch.zeros((N, 1), device=self.dev),
            "dr_friction": prm["friction"][:, None],
            "dr_kp": pre["kp_scale"], "dr_kd": pre["kd_scale"],
            "future_motion_root_height": fut["rg_pos"][:, :, 0, 2:3].reshape(N, -1),
            "future_motion_roll_pitch": f_rp.reshape(N, -1),
            "future_motion_base_lin_vel": f_vel.reshape(N, -1),
            "future_motion_base_yaw_vel": f_ang[..., 2:3].reshape(N, -1),
            "future_motion_dof_pos": fut["dof_pos"].reshape(N, -1),
            "future_motion_local_ref_key_body_pos": f_key.reshape(N, -1),
            "next_step_ref_motion": torch.cat([fut["rg_pos"][:, 0, 0, 2:3], f_rp[:, 0], f_vel[:, 0], f_ang[:, 0, 2:3],
                                               fut["dof_pos"][:, 0], f_key[:, 0].reshape(N, -1)], dim=-1),
        }

    def observation_gap(self, rec) -> float:
        """The observations of the envs that did not reset: every part
        without noise over its largest entry; every noised part by how far
        it lies outside its noise's range, over that range; the history
        parts against the history the step was given, exactly."""
        keep = ~rec["done"]
        if not bool(keep.any()):
            return 0.0
        pre, o = rec["pre"], self.snap_obs
        raw = self.raw_observations(rec)
        worst = 0.0
        for group, names in o["obs_dict"].items():
            got, off = rec["obs"][group][keep].double(), 0
            for name in sorted(names):
                hist = o.get("obs_auxiliary", {}).get(name)
                if hist:
                    want = torch.cat([pre["history"][k][:, :n].reshape(keep.shape[0], -1)
                                      for k, n in sorted(hist.items())], dim=-1)
                else:
                    want = raw[name] * float(o["obs_scales"].get(name, 1.0))
                want = torch.clamp(want[keep].double(), -self.clip_obs, self.clip_obs)
                part = got[:, off:off + want.shape[-1]]
                off += want.shape[-1]
                noise = 0.0 if hist else float(o["noise_scales"].get(name, 0.0)) * float(o["obs_scales"].get(name, 1.0))
                gap = float((part - want).abs().max())
                if noise > 0:
                    worst = max(worst, max(gap - noise, 0.0) / noise)
                else:
                    top = max(float(want.abs().max()), float(part.abs().max()))
                    worst = max(worst, gap / top if top > 0 else 0.0)
            if off != got.shape[-1]:
                raise ValueError(f"the program's {group} is {got.shape[-1]} wide, the reference's {off}")
        return worst
