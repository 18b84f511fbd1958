"""General motion-tracking env (KungfuBot2) in torch (counterpart of
`pbhc_tpu/envs/general_tracking_env.py`).

`MotionTrackingEnv` with four hooks filled in: quaternion-product and
root-frame diffs plus the anchor and anchor-yaw-aligned ("beyondmimic
local") diffs (`general_tracking_env.py:49-82`), the `ref_pos_z`/`ref_ori`
terminations (`:84-92`), the key-body and anchor rewards (`:94-133`) and the
anchor-frame and future-target observations (`:135-198`).

The future targets are flattened step-major ([N, S, D] -> [N, S*D]) at the
`S = future_num_steps` control-step offsets `linspace(1, future_max_steps, S)`,
so that the Conv1d motion encoder sees time on one axis; `next_step_ref_motion`
is the compact target of the first of those steps.
"""
from __future__ import annotations

import numpy as np
import torch

from pbhc_tpu_torch.envs.tracking_env import EnvState, MotionTrackingEnv
from pbhc_tpu_torch.maths import rotations as rot
from pbhc_tpu_torch.motion.motion_lib import get_motion_state


class GeneralTrackingEnv(MotionTrackingEnv):
    def __init__(self, config, num_envs: int, device="cuda", seed: int = 0, shard=None):
        super().__init__(config, num_envs, device=device, seed=seed, shard=shard)
        rcfg = config.robot
        names_ext = list(self.sim_model.body_names) + [e["joint_name"] for e in rcfg.motion.extend_config]
        self.key_body_id = np.asarray([names_ext.index(n) for n in rcfg.key_bodies])
        self.anchor_index = names_ext.index(rcfg.motion.get("anchor_link", "pelvis"))
        self.future_num_steps = int(config.obs.get("future_num_steps", 20))
        self.future_max_steps = int(config.obs.get("future_max_steps", 95))
        steps = np.linspace(1, self.future_max_steps, self.future_num_steps).astype(np.int32)
        self.tar_obs_steps = torch.as_tensor(steps.astype(np.float32), device=self.device)

    # ------------------------------------------------------------------ diffs
    def _compute_diffs(self, sim, mres, body_pos, body_quat, body_vel, body_ang_vel):
        d = super()._compute_diffs(sim, mres, body_pos, body_quat, body_vel, body_ang_vel)
        d["dif_body_rot_quat"] = rot.quat_mul(mres["rg_rot_t"], rot.quat_conjugate(body_quat))
        ref_root_vel_local = rot.quat_rotate_inverse(mres["root_rot"], mres["root_vel"])
        d["dif_root_velocity"] = ref_root_vel_local - rot.quat_rotate_inverse(sim.root_quat, sim.root_lin_vel)
        d["dif_root_rot"] = rot.quat_mul(mres["root_rot"], rot.quat_conjugate(sim.root_quat))
        d["dif_root_height"] = mres["root_pos"][:, 2:3] - sim.root_pos[:, 2:3]
        ai = self.anchor_index
        d["dif_anchor_body_pos"] = d["dif_body_pos"][:, ai]
        d["dif_anchor_pos_z"] = mres["rg_pos_t"][:, ai, 2] - body_pos[:, ai, 2]
        g = self._gravity_vec.expand(self.num_envs, 3)
        d["dif_anchor_ori"] = (rot.quat_rotate_inverse(mres["rg_rot_t"][:, ai], g)[:, 2]
                               - rot.quat_rotate_inverse(body_quat[:, ai], g)[:, 2])
        # anchor-yaw-aligned reference (`general_tracking_env.py:69-82`)
        anchor_pos_ref = mres["rg_pos_t"][:, ai][:, None]
        anchor_quat_ref = mres["rg_rot_t"][:, ai][:, None]
        delta_pos = torch.cat([body_pos[:, ai][:, None, :2], anchor_pos_ref[..., 2:3]], dim=-1)
        delta_ori = _yaw_quat(rot.quat_mul(body_quat[:, ai][:, None], rot.quat_conjugate(anchor_quat_ref)))
        delta_ori = delta_ori.expand(mres["rg_rot_t"].shape)
        body_pos_relative = delta_pos + rot.quat_rotate(delta_ori, mres["rg_pos_t"] - anchor_pos_ref)
        body_quat_relative = rot.quat_mul(delta_ori, mres["rg_rot_t"])
        d["dif_local_body_pos"] = body_pos_relative - body_pos
        d["dif_local_body_rot_quat"] = rot.quat_mul(body_quat_relative, rot.quat_conjugate(body_quat))
        return d

    # ------------------------------------------------------------ termination
    def _extra_terminations(self, term, diffs, state):
        tcfg, tscl = self.ecfg.termination, self.ecfg.termination_scales
        if tcfg.get("terminate_by_ref_pos_z", False):
            term["ref_pos_z"] = torch.abs(diffs["dif_anchor_pos_z"]) > float(tscl.termination_ref_pos_z_threshold)
        if tcfg.get("terminate_by_ref_ori", False):
            term["ref_ori"] = torch.abs(diffs["dif_anchor_ori"]) > float(tscl.termination_ref_ori_threshold)
        return term

    # ---------------------------------------------------------------- rewards
    def _reward_terms(self, state: EnvState, rs):
        rews, errors, feet_air_time = super()._reward_terms(state, rs)
        sig = {t: state.sigma_values[i] for i, t in enumerate(self.sigma_terms)}
        d = rs["diffs"]

        def track(err, term):
            errors[term] = err
            return torch.exp(-err / sig[term])

        def msq(x):
            return (x ** 2).mean(-1).mean(-1)

        kid = self.key_body_id
        if "teleop_key_body_pos" in sig:
            rews["teleop_key_body_position"] = track(msq(d["dif_body_pos"][:, kid]), "teleop_key_body_pos")
        if "teleop_anchor_body_pos" in sig:
            rews["teleop_anchor_body_position"] = track((d["dif_anchor_body_pos"] ** 2).mean(-1),
                                                        "teleop_anchor_body_pos")
        if "teleop_anchor_body_rot" in sig:
            ang, _ = rot.quat_to_angle_axis(d["dif_body_rot_quat"][:, self.anchor_index])
            rews["teleop_anchor_body_rotation"] = track(ang ** 2, "teleop_anchor_body_rot")
        if "local_key_body_pos" in sig:
            rews["local_key_body_position"] = track(msq(d["dif_local_body_pos"][:, kid]), "local_key_body_pos")
        if "local_key_body_rot" in sig:
            ang, _ = rot.quat_to_angle_axis(d["dif_local_body_rot_quat"][:, kid])
            rews["local_key_body_rotation"] = track((ang ** 2).mean(-1), "local_key_body_rot")
        if "key_body_vel" in sig:
            rews["key_body_velocity"] = track(msq(d["dif_body_vel"][:, kid]), "key_body_vel")
        if "key_body_ang_vel" in sig:
            rews["key_body_ang_velocity"] = track(msq(d["dif_body_ang_vel"][:, kid]), "key_body_ang_vel")
        if "teleop_root_vel" in sig:
            rews["teleop_root_vel"] = track((d["dif_root_velocity"] ** 2).mean(-1), "teleop_root_vel")
        if "teleop_root_pose" in sig:
            ang, _ = rot.quat_to_angle_axis(d["dif_root_rot"])
            rews["teleop_root_pose"] = track(ang ** 2 + (d["dif_root_height"] ** 2).mean(-1), "teleop_root_pose")
        return rews, errors, feet_air_time

    # -------------------------------------------------------------------- obs
    def _obs_getters(self, state: EnvState):
        getters = super()._obs_getters(state)
        sim, N, ai, kid = state.sim, self.num_envs, self.anchor_index, self.key_body_id
        getters["roll_pitch"] = rot.get_euler_xyz(sim.root_quat)[:, :2]
        getters["root_height"] = sim.root_pos[:, 2:3]
        getters["contact_mask"] = state.contacts_filt

        # key bodies in the robot's anchor frame (`general_tracking_env.py:147-161`)
        body_pos, body_quat, _, _ = self._extend_body_states(sim)
        anchor_inv = rot.quat_conjugate(body_quat[:, ai])[:, None]
        local_pos = rot.quat_rotate(anchor_inv.expand(body_pos.shape[:-1] + (4,)),
                                    body_pos - body_pos[:, ai][:, None])
        local_rot = rot.quat_to_matrix(rot.quat_mul(anchor_inv.expand(body_quat.shape), body_quat))[..., :2]
        getters["local_key_body_pos"] = local_pos[:, kid].reshape(N, -1)
        getters["local_key_body_rot"] = local_rot[:, kid].reshape(N, -1)

        # robot anchor -> reference anchor (`:163-170`)
        mres, _ = self._motion_state_at(state, 1)
        aq_inv = rot.quat_conjugate(body_quat[:, ai])
        getters["anchor_ref_pos"] = rot.quat_rotate(aq_inv, mres["rg_pos_t"][:, ai] - body_pos[:, ai])
        getters["anchor_ref_rot"] = rot.quat_to_matrix(
            rot.quat_mul(aq_inv, mres["rg_rot_t"][:, ai]))[..., :2].reshape(N, -1)

        # future targets, step-major (`:172-198`)
        t = ((state.episode_length.to(torch.float32)[:, None] * self.dt + state.motion_start_times[:, None])
             + self.tar_obs_steps[None] * self.dt)                            # [N,S]
        ids = state.motion_ids[:, None].expand(t.shape)
        # on terrain, moved onto the env's tile as every reference fetch is (`:173`)
        off = state.origin_shift[:, None] if self.terrain is not None else None
        fm = get_motion_state(self.motion_lib.data, ids, t, offset=off)
        froot_rot = fm["root_rot"]
        frpy = rot.get_euler_xyz(froot_rot)
        froot_vel = rot.quat_rotate_inverse(froot_rot, fm["root_vel"])
        froot_ang = rot.quat_rotate_inverse(froot_rot, fm["root_ang_vel"])
        f_anchor_inv = rot.quat_conjugate(fm["rg_rot_t"][..., ai, :])[..., None, :]
        f_local_key = rot.quat_rotate(f_anchor_inv.expand(fm["rg_pos_t"].shape[:-1] + (4,)),
                                      fm["rg_pos_t"] - fm["rg_pos_t"][..., ai, :][..., None, :])[..., kid, :]
        getters["future_motion_root_height"] = fm["root_pos"][..., 2:3].reshape(N, -1)
        getters["future_motion_roll_pitch"] = frpy[..., :2].reshape(N, -1)
        getters["future_motion_base_lin_vel"] = froot_vel.reshape(N, -1)
        getters["future_motion_base_yaw_vel"] = froot_ang[..., 2:3].reshape(N, -1)
        getters["future_motion_base_ang_vel"] = froot_ang.reshape(N, -1)
        getters["future_motion_dof_pos"] = fm["dof_pos"].reshape(N, -1)
        getters["future_motion_local_ref_key_body_pos"] = f_local_key.reshape(N, -1)
        getters["next_step_ref_motion"] = torch.cat([
            fm["root_pos"][:, 0, 2:3], frpy[:, 0, :2], froot_vel[:, 0], froot_ang[:, 0, 2:3],
            fm["dof_pos"][:, 0], f_local_key[:, 0].reshape(N, -1)], dim=-1)
        return getters


def _yaw_quat(q):
    """Yaw component of an XYZW quaternion (`general_tracking_env.py:201`)."""
    return rot.quat_from_angle_axis(rot.calc_heading(q), rot._unit_axis(q, 2))
