"""MuJoCo fleet mirror: K MuJoCo twins driven by one batched env state
(counterpart of `pbhc_tpu/deploy/mj_mirror.py`).

The bridge that lets MuJoCo act as the dynamics inside the training env's
observation pipeline: initialise K `MjData` from a batched engine `SimState`,
PD-step them under policy actions, and read the batch back in the engine's
conventions (xyzw quaternions, world-frame angular velocity; MuJoCo free
joints store wxyz and body-frame angular velocity, reference
deploy/mujoco.py:336,383). The twins run on the host; `inject` returns the
state's tensors on the device of the state it is given. No reference
analog: the reference validates in MuJoCo but never feeds MuJoCo states
back into its training stack. `mujoco` is imported inside the constructor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


class MjFleet:
    """K independent MuJoCo twins of the env's robot, PD-driven at 50 Hz."""

    def __init__(self, env, k, sim_fps=500, decimation=10, terrain=None,
                 tile=(0, 0), sphere_feet=None):
        """sphere_feet: None = default (spheres on hfield scenes, mesh on the
        plane); True/False forces the foot collision geometry either way —
        the knob tools/diag_hfield.py uses to decompose scene-vs-foot
        transfer gaps."""
        import mujoco

        from pbhc_tpu_torch.model.g1 import g1_asset_root

        self.mujoco = mujoco
        self.k = k
        self.decimation = int(decimation)
        robot_type = str(env.config.robot.robot_type)
        xml = str(g1_asset_root() / f"{robot_type}.xml")
        if terrain is None and sphere_feet:
            # plane scene with the engine's sphere soles (diagnostic)
            import re as _re
            import tempfile
            from pathlib import Path as _Path

            from pbhc_tpu_torch.envs.terrain import swap_sphere_soles

            src = _Path(xml)
            txt = swap_sphere_soles(src.read_text())
            txt = _re.sub(r'meshdir="([^"]*)"',
                          lambda m: f'meshdir="{(src.parent / m.group(1)).resolve()}"',
                          txt)
            xml = str(_Path(tempfile.mkdtemp()) / "plane_spheres.xml")
            _Path(xml).write_text(txt)
        if terrain is not None:
            # hfield twin: export the training heightfield (sphere-sole feet,
            # see Terrain.export_mujoco) and TRANSLATE it so the chosen tile's
            # center sits at the world origin with ground height 0 — the env,
            # motion references, and fall thresholds all stay unshifted.
            import tempfile
            from pathlib import Path

            from pbhc_tpu_torch.envs.terrain import fill_mujoco_hfield

            out = Path(tempfile.mkdtemp()) / "fleet_terrain.xml"
            terrain.export_mujoco(
                xml, out,
                sphere_feet=True if sphere_feet is None else sphere_feet)
            self.m = fill_mujoco_hfield(mujoco.MjModel.from_xml_path(str(out)), out)
            cx, cy, cz = (float(v) for v in terrain.env_origins[tile[0], tile[1]])
            gid = mujoco.mj_name2id(self.m, mujoco.mjtObj.mjOBJ_GEOM, "terrain")
            if gid < 0:
                raise ValueError("the exported hfield scene has no terrain geom")
            self.m.geom_pos[gid][0] -= cx
            self.m.geom_pos[gid][1] -= cy
            self.m.geom_pos[gid][2] -= cz
        else:
            self.m = mujoco.MjModel.from_xml_path(xml)
        self.terrain = terrain
        self._tile_off = ((cx, cy, cz) if terrain is not None
                          else (0.0, 0.0, 0.0))
        self.m.opt.timestep = 1.0 / sim_fps
        # the G1 MJCF <default> leaks armature/damping 0 onto some variants
        if float(np.max(self.m.dof_armature[6:])) == 0.0:
            self.m.dof_armature[6:] = 0.01
        if float(np.max(self.m.dof_damping[6:])) == 0.0:
            self.m.dof_damping[6:] = 0.001
        self.d = [mujoco.MjData(self.m) for _ in range(k)]
        for d in self.d:  # valid derived state (geom_xpos) before first use
            mujoco.mj_forward(self.m, d)
        host = lambda t: t.detach().cpu().numpy()
        self.kp = host(env.p_gains)
        self.kd = host(env.d_gains)
        self.tl = host(env.torque_limits)
        self.asc = host(env.action_scales)
        self.ds = host(env.raw_default_dof_pos)

    def ground_height(self, xy):
        """Terrain height [K] under fleet-frame xy [K,2] (the frame whose
        origin is the chosen tile center at z=0); 0 on the plane scene.
        Bilinear, matching engine.ground_height — use for height-relative
        fall thresholds on sloped/obstacle cells."""
        xy = np.asarray(xy, np.float64)
        if self.terrain is None:
            return np.zeros(len(xy))
        cx, cy, cz = self._tile_off
        return self.terrain.height_at(xy + np.array([cx, cy])) - cz

    def set_from(self, sim, i):
        """MjData[i] <- engine SimState row i (xyzw->wxyz, world->body w)."""
        from pbhc_tpu_torch.deploy.student_obs import quat_rotate_inverse

        row = lambda t: t[i].detach().cpu().numpy()
        d = self.d[i]
        d.qpos[:3] = row(sim.root_pos)
        d.qpos[3:7] = row(sim.root_quat)[[3, 0, 1, 2]]
        d.qpos[7:] = row(sim.dof_pos)
        d.qvel[:3] = row(sim.root_lin_vel)
        d.qvel[3:6] = quat_rotate_inverse(row(sim.root_quat), row(sim.root_ang_vel))
        d.qvel[6:] = row(sim.dof_vel)
        self.mujoco.mj_forward(self.m, d)

    def step(self, actions, alive=None):
        """One 50 Hz control tick: deploy PD loop per alive twin."""
        for i in range(self.k):
            if alive is not None and not alive[i]:
                continue
            d = self.d[i]
            target = actions[i] * self.asc + self.ds
            for _ in range(self.decimation):
                tau = self.kp * (target - d.qpos[7:]) - self.kd * d.qvel[6:]
                d.qfrc_applied[:] = 0
                d.qfrc_applied[6:] = np.clip(tau, -self.tl, self.tl)
                self.mujoco.mj_step(self.m, d)

    def read_batch(self):
        """Stack MuJoCo states in ENGINE conventions:
        (pos [K,3], quat_xyzw [K,4], lin_vel_world, ang_vel_world, q, dq),
        numpy, the angular velocity rotated in float32 as in JAX."""
        from pbhc_tpu_torch.maths.rotations import quat_rotate

        P, Q, LV, W, QQ, DQ = [], [], [], [], [], []
        for d in self.d:
            P.append(np.asarray(d.qpos[:3]))
            Q.append(np.asarray(d.qpos[3:7])[[1, 2, 3, 0]])
            LV.append(np.asarray(d.qvel[:3]))
            W.append(np.asarray(d.qvel[3:6]))
            QQ.append(np.asarray(d.qpos[7:]))
            DQ.append(np.asarray(d.qvel[6:]))
        # body -> world angular velocity
        f32 = lambda a: torch.as_tensor(np.stack(a), dtype=torch.float32)
        AV = quat_rotate(f32(Q), f32(W)).numpy()
        return (np.stack(P), np.stack(Q), np.stack(LV),
                AV, np.stack(QQ), np.stack(DQ))

    def inject(self, state_sim):
        """Batched engine SimState fields <- current MuJoCo states, float32 on
        the device of `state_sim` (no derived-cache refresh; call
        env.engine.derived_state after)."""
        dev = state_sim.root_pos.device
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        P, Q, LV, AV, QQ, DQ = self.read_batch()
        return dataclasses.replace(
            state_sim, root_pos=t(P), root_quat=t(Q), root_lin_vel=t(LV),
            root_ang_vel=t(AV), dof_pos=t(QQ), dof_vel=t(DQ))
