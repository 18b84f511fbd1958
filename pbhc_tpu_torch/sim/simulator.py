"""The simulator tensor contract and the facade over the port's engine
(counterpart of `pbhc_tpu/sim/simulator.py:25-122`).

The reference envs reach a simulator through an abstract tensor contract:
`dof_pos`/`dof_vel` [N,nd], `robot_root_states` [N,13] (position, xyzw
quaternion, linear and angular velocity, world frame), per-body
`_rigid_body_{pos,rot,vel,ang_vel}` and `contact_forces`, with
`apply_torques_at_dof`, `simulate_at_each_physics_step` and the state
setters. The envs here step the engine directly; this facade gives the same
contract over it, for code written against the contract and for lock-step
comparisons. `EngineSimulator` is the JAX package's `TpuSimulator`: a
stateful wrapper around the per-env `Engine.substep`. `MujocoSimulator` is
the MuJoCo backend (`simulator.py:125-197`), on the host; it imports
`mujoco` when it is built, so this module imports where MuJoCo is missing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbhc_tpu_torch.sim.engine import Engine, SimParams, tree_map


class BaseSimulator:
    """The tensor contract (`simulator.py:25-52`)."""

    dof_pos: torch.Tensor
    dof_vel: torch.Tensor
    robot_root_states: torch.Tensor
    contact_forces: torch.Tensor
    _rigid_body_pos: torch.Tensor
    _rigid_body_rot: torch.Tensor
    _rigid_body_vel: torch.Tensor
    _rigid_body_ang_vel: torch.Tensor

    def apply_torques_at_dof(self, torques):
        raise NotImplementedError

    def simulate_at_each_physics_step(self):
        raise NotImplementedError

    def refresh_sim_tensors(self):
        raise NotImplementedError

    def set_actor_root_state_tensor(self, env_ids, root_states):
        raise NotImplementedError

    def set_dof_state_tensor(self, env_ids, dof_pos, dof_vel):
        raise NotImplementedError


class EngineSimulator(BaseSimulator):
    """Stateful facade over `Engine`'s per-env step, `num_envs` envs on the
    engine's device (`simulator.py:55`, `TpuSimulator`). Each physics step is
    one `Engine.substep` from a cold contact solve, as there."""

    def __init__(self, engine: Engine, num_envs: int, params: SimParams | None = None):
        self.engine = engine
        self.num_envs = num_envs
        batch = lambda x: x.expand((num_envs,) + tuple(x.shape)).clone()
        self.params = params if params is not None else tree_map(batch, engine.default_params())
        self.state = tree_map(batch, engine.default_state())
        self._torques = torch.zeros((num_envs, engine.nd), device=engine.device)
        self._lam = None
        self.refresh_sim_tensors()

    @property
    def _body_list(self):
        return list(self.engine.model.body_names)

    def find_rigid_body_indice(self, name):
        return self._body_list.index(name)

    def apply_torques_at_dof(self, torques):
        self._torques = torch.as_tensor(torques, dtype=torch.float32, device=self.engine.device)

    def simulate_at_each_physics_step(self):
        self.state, self._lam = self.engine.substep(self.params, self.state, self._torques)

    def refresh_sim_tensors(self):
        self.state = self.engine.derived_state(self.params, self.state)
        st = self.state
        self.dof_pos, self.dof_vel = st.dof_pos, st.dof_vel
        self.robot_root_states = torch.cat([st.root_pos, st.root_quat, st.root_lin_vel, st.root_ang_vel], dim=-1)
        self.base_quat = st.root_quat
        self._rigid_body_pos, self._rigid_body_rot = st.body_pos, st.body_quat
        self._rigid_body_vel, self._rigid_body_ang_vel = st.body_lin_vel, st.body_ang_vel
        self.contact_forces = st.contact_forces

    def _mask(self, env_ids):
        mask = torch.zeros((self.num_envs,), dtype=torch.bool, device=self.engine.device)
        mask[torch.as_tensor(env_ids, device=self.engine.device)] = True
        return mask[:, None]

    def set_actor_root_state_tensor(self, env_ids, root_states):
        """Rows of `root_states` [N,13] into the envs `env_ids` (`simulator.py:102`)."""
        rs = torch.as_tensor(root_states, dtype=torch.float32, device=self.engine.device)
        m, st = self._mask(env_ids), self.state
        self.state = dataclasses.replace(
            st, root_pos=torch.where(m, rs[:, 0:3], st.root_pos), root_quat=torch.where(m, rs[:, 3:7], st.root_quat),
            root_lin_vel=torch.where(m, rs[:, 7:10], st.root_lin_vel),
            root_ang_vel=torch.where(m, rs[:, 10:13], st.root_ang_vel))

    def set_dof_state_tensor(self, env_ids, dof_pos, dof_vel):
        """Rows of `dof_pos`, `dof_vel` [N,nd] into the envs `env_ids` (`simulator.py:114`)."""
        dev = self.engine.device
        m, st = self._mask(env_ids), self.state
        self.state = dataclasses.replace(
            st, dof_pos=torch.where(m, torch.as_tensor(dof_pos, dtype=torch.float32, device=dev), st.dof_pos),
            dof_vel=torch.where(m, torch.as_tensor(dof_vel, dtype=torch.float32, device=dev), st.dof_vel))


class MujocoSimulator(BaseSimulator):
    """Single-env MuJoCo backend with the same contract, the CPU oracle
    (`simulator.py:125`): its tensors are host numpy arrays with a leading
    env axis of 1. `mujoco` is imported in the constructor."""

    def __init__(self, xml_path, sim_fps=200):
        import mujoco

        self._mujoco = mujoco
        self.m = mujoco.MjModel.from_xml_path(str(xml_path))
        self.m.opt.timestep = 1.0 / sim_fps
        self.d = mujoco.MjData(self.m)
        self.num_envs = 1
        self.nd = self.m.nv - 6
        self._torques = np.zeros(self.nd)
        self.refresh_sim_tensors()

    @property
    def _body_list(self):
        return [self._mujoco.mj_id2name(self.m, self._mujoco.mjtObj.mjOBJ_BODY, i)
                for i in range(1, self.m.nbody)]

    def apply_torques_at_dof(self, torques):
        self._torques = np.asarray(torques).reshape(-1)

    def simulate_at_each_physics_step(self):
        self.d.qfrc_applied[:] = 0
        self.d.qfrc_applied[6:] = self._torques
        self._mujoco.mj_step(self.m, self.d)

    def refresh_sim_tensors(self):
        from scipy.spatial.transform import Rotation as sRot

        d = self.d
        self.dof_pos = d.qpos[7:].copy()[None]
        self.dof_vel = d.qvel[6:].copy()[None]
        quat = d.qpos[3:7][[1, 2, 3, 0]]
        ang_world = sRot.from_quat(quat).apply(d.qvel[3:6])  # body->world
        self.robot_root_states = np.concatenate(
            [d.qpos[:3], quat, d.qvel[:3], ang_world])[None]
        self.base_quat = quat[None]
        self._rigid_body_pos = d.xpos[1:].copy()[None]
        self._rigid_body_rot = d.xquat[1:][:, [1, 2, 3, 0]].copy()[None]
        vels = np.zeros((self.m.nbody - 1, 6))
        for i in range(1, self.m.nbody):
            self._mujoco.mj_objectVelocity(self.m, d, self._mujoco.mjtObj.mjOBJ_BODY, i, vels[i - 1], 0)
        self._rigid_body_ang_vel = vels[None, :, :3]
        self._rigid_body_vel = vels[None, :, 3:]
        cf = np.zeros((self.m.nbody - 1, 3))
        for ci in range(d.ncon):
            c = d.contact[ci]
            force = np.zeros(6)
            self._mujoco.mj_contactForce(self.m, d, ci, force)
            frame = c.frame.reshape(3, 3)
            f_world = frame.T @ force[:3]
            for g in (c.geom1, c.geom2):
                b = self.m.geom_bodyid[g]
                if b > 0:
                    cf[b - 1] += f_world
        self.contact_forces = cf[None]

    def set_actor_root_state_tensor(self, env_ids, root_states):
        rs = np.asarray(root_states).reshape(-1)
        self.d.qpos[:3] = rs[0:3]
        self.d.qpos[3:7] = rs[3:7][[3, 0, 1, 2]]
        self.d.qvel[:3] = rs[7:10]
        from scipy.spatial.transform import Rotation as sRot

        self.d.qvel[3:6] = sRot.from_quat(rs[3:7]).apply(rs[10:13], inverse=True)
        self._mujoco.mj_forward(self.m, self.d)

    def set_dof_state_tensor(self, env_ids, dof_pos, dof_vel):
        self.d.qpos[7:] = np.asarray(dof_pos).reshape(-1)
        self.d.qvel[6:] = np.asarray(dof_vel).reshape(-1)
        self._mujoco.mj_forward(self.m, self.d)
