"""MuJoCo sim2sim deploy runtime, the cross-engine fidelity oracle
(counterpart of `pbhc_tpu/deploy/mujoco_runtime.py`).

Reimplements the reference URCI deploy path (reference humanoidverse/deploy/
urcirobot.py + mujoco.py): a 50 Hz control loop around MuJoCo at 500 Hz with
decimation 10 and explicit PD, observations rebuilt in numpy with the
training layout, the policy run by an export's host executor, and a loop
that follows the reference motion clip. Trajectories are returned for the
metrics library (reference README.md:104: train in one simulator, replay in
MuJoCo).

It runs on the host, as on the robot's onboard PC: numpy state, MuJoCo on
the CPU. The reference clip is a `MotionLib` on `device` (default "cpu", the
robot PC's device); only its t = 0 state is read, on the host. `mujoco` is
imported inside the functions that need it: the module imports where MuJoCo
is missing, and those functions raise `ImportError` there.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from pbhc_tpu_torch.deploy.export import NumpyPolicy


def _quat_rotate_inverse_np(q_xyzw, v):
    from scipy.spatial.transform import Rotation as sRot

    return sRot.from_quat(q_xyzw).apply(v, inverse=True)


class ObsBuilder:
    """Numpy twin of the env's config-driven obs assembly (deployable subset).

    reference urcirobot.py:326-481 rebuilds `_get_obs_*` on CPU; here the
    layout comes straight from the exported policy metadata.
    """

    def __init__(self, meta):
        self.meta = meta
        self.groups = meta["obs_groups"]["actor_obs"]
        self.scales = meta["obs_scales"]
        self.dims = meta["obs_dims"]
        self.hist_spec = meta["history_spec"].get("history_actor", {})
        self.hist = {k: np.zeros((v, self.dims[k]), dtype=np.float32) for k, v in self.hist_spec.items()}
        self.default_dof = np.asarray(meta["default_dof_pos"], dtype=np.float32)
        self.clip_obs = meta["clip_obs"]

    def reset(self):
        for k in self.hist:
            self.hist[k][:] = 0

    def raw_obs(self, robot):
        return {
            "base_ang_vel": robot.base_ang_vel_local.astype(np.float32),
            "projected_gravity": robot.projected_gravity.astype(np.float32),
            "dof_pos": (robot.q - self.default_dof).astype(np.float32),
            "dof_vel": robot.dq.astype(np.float32),
            "actions": robot.last_action.astype(np.float32),
            "ref_motion_phase": np.asarray([robot.phase], dtype=np.float32),
        }

    def build(self, robot):
        raw = self.raw_obs(robot)
        parts = []
        for name in sorted(self.groups):
            if name == "history_actor":
                hp = [(self.hist[k][: self.hist_spec[k]]).reshape(-1) for k in sorted(self.hist_spec)]
                parts.append(np.concatenate(hp) * self.scales.get(name, 1.0))
            else:
                parts.append(raw[name] * self.scales.get(name, 1.0))
        obs = np.concatenate(parts)
        # push current (scaled) obs into history AFTER building, newest first
        for k in self.hist:
            self.hist[k] = np.concatenate(
                [(raw[k] * self.scales.get(k, 1.0))[None], self.hist[k][:-1]], axis=0)
        return np.clip(obs, -self.clip_obs, self.clip_obs)


class MujocoDeployRobot:
    """50 Hz policy / 500 Hz MuJoCo PD loop (reference mujoco.py:212-528)."""

    def __init__(self, policy_path, motion_file, xml_path=None, robot_type=None,
                 sim_fps=500, decimation=10, terrain=None, device="cpu"):
        import mujoco

        from pbhc_tpu_torch.model.g1 import g1_asset_root, load_g1_motion_model
        from pbhc_tpu_torch.motion.motion_lib import MotionLib

        # a preloaded policy object (NumpyPolicy / OnnxPolicy) passes through;
        # paths load the npz format
        self.policy = policy_path if hasattr(policy_path, "meta") else NumpyPolicy(policy_path)
        self.meta = self.policy.meta
        robot_type = robot_type or self.meta.get("robot_type", "g1_23dof_lock_wrist")
        self.obs_builder = ObsBuilder(self.meta)

        xml_path = xml_path or str(g1_asset_root() / f"{robot_type}.xml")
        if terrain is not None:
            # replay on the training heightfield (envs.terrain.Terrain)
            import tempfile

            from pbhc_tpu_torch.envs.terrain import fill_mujoco_hfield

            out = Path(tempfile.mkdtemp()) / "scene_terrain.xml"
            terrain.export_mujoco(xml_path, out)
            xml_path = str(out)
            self.m = fill_mujoco_hfield(mujoco.MjModel.from_xml_path(xml_path), out)
        else:
            self.m = mujoco.MjModel.from_xml_path(xml_path)
        self.m.opt.timestep = 1.0 / sim_fps
        # dynamics parity with the training engine: the official
        # g1_29dof_rev_1_0.xml ships no joint armature/damping and its
        # ~1e-5 kgm^2 wrist links are unstable in any fixed-step integrator;
        # load_g1_sim_model floors them (model/g1.py), so the sim2sim twin
        # must too or the policy meets different dynamics than it trained on
        if float(np.max(self.m.dof_armature[6:])) == 0.0:
            self.m.dof_armature[6:] = 0.01
        if float(np.max(self.m.dof_damping[6:])) == 0.0:
            self.m.dof_damping[6:] = 0.001
        self.d = mujoco.MjData(self.m)
        self._mujoco = mujoco
        self.decimation = decimation
        self.ctrl_dt = decimation / sim_fps

        mj_joints = [mujoco.mj_id2name(self.m, mujoco.mjtObj.mjOBJ_JOINT, i) for i in range(1, self.m.njnt)]
        if mj_joints != list(self.meta["dof_names"]):
            raise ValueError(f"the policy's dof_names are not the MJCF's joint order {mj_joints}")

        self.motion = MotionLib(motion_file, load_g1_motion_model(robot_type), num_envs=1,
                                step_dt=self.ctrl_dt, device=device)
        self.kp = np.asarray(self.meta["kp"])
        self.kd = np.asarray(self.meta["kd"])
        self.tau_lim = np.asarray(self.meta["torque_limits"])
        self.action_scale = np.asarray(self.meta["action_scale"])
        self.default_dof = np.asarray(self.meta["default_dof_pos"])
        self.action_clip = self.meta["action_clip"]
        self.nd = len(self.default_dof)
        self.last_action = np.zeros(self.nd, dtype=np.float32)
        self.t = 0.0

    # ------------------------------------------------------------------ state
    @property
    def q(self):
        return self.d.qpos[7:].copy()

    @property
    def dq(self):
        return self.d.qvel[6:].copy()

    @property
    def base_quat_xyzw(self):
        return self.d.qpos[3:7][[1, 2, 3, 0]].copy()

    @property
    def base_ang_vel_local(self):
        return self.d.qvel[3:6].copy()  # mujoco free joint: angular vel is body-frame

    @property
    def projected_gravity(self):
        return _quat_rotate_inverse_np(self.base_quat_xyzw, np.array([0.0, 0.0, -1.0]))

    @property
    def phase(self):
        return min(self.t / float(self.motion.data.lengths[0]), 1.0)

    # ------------------------------------------------------------------ control
    def reset(self):
        import torch

        from pbhc_tpu_torch.motion.motion_lib import get_motion_state

        dev = self.motion.device
        st = get_motion_state(self.motion.data, torch.zeros(1, dtype=torch.int64, device=dev),
                              torch.zeros(1, device=dev))
        host = lambda k: st[k][0].cpu().numpy()
        self.d.qpos[:3] = host("root_pos")
        self.d.qpos[3:7] = host("root_rot")[[3, 0, 1, 2]]
        self.d.qpos[7:] = host("dof_pos")
        self.d.qvel[:] = 0
        self._mujoco.mj_forward(self.m, self.d)
        self.last_action[:] = 0
        self.t = 0.0
        self.obs_builder.reset()

    def control_step(self):
        obs = self.obs_builder.build(self)
        action = np.clip(self.policy(obs), -self.action_clip, self.action_clip)
        self.last_action = action.astype(np.float32)
        target = action * self.action_scale + self.default_dof
        for _ in range(self.decimation):
            tau = self.kp * (target - self.d.qpos[7:]) - self.kd * self.d.qvel[6:]
            self.d.ctrl[:] = 0
            self.d.qfrc_applied[:] = 0
            self.d.qfrc_applied[6:] = np.clip(tau, -self.tau_lim, self.tau_lim)
            self._mujoco.mj_step(self.m, self.d)
        self.t += self.ctrl_dt

    def rollout(self, max_steps=None):
        """Run the clip to its end; returns a trajectory dict for metrics."""
        length = float(self.motion.data.lengths[0])
        steps = max_steps or int(length / self.ctrl_dt)
        traj = {"root_pos": [], "root_rot": [], "dof_pos": [], "body_pos": [], "body_rot": []}
        self.reset()
        for _ in range(steps):
            self.control_step()
            traj["root_pos"].append(self.d.qpos[:3].copy())
            traj["root_rot"].append(self.base_quat_xyzw)
            traj["dof_pos"].append(self.q)
            traj["body_pos"].append(self.d.xpos[1:].copy())          # skip world body
            traj["body_rot"].append(self.d.xquat[1:][:, [1, 2, 3, 0]].copy())
        return {k: np.stack(v) for k, v in traj.items()}
