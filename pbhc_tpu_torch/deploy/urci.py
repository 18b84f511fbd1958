"""URCI, the Unified Robot Control Interface: the sim2sim CLI (counterpart of
`pbhc_tpu/deploy/urci.py`).

Reimplements the reference deploy runtime (reference humanoidverse/urci.py +
deploy/urcirobot.py:126-212): a 50 Hz control loop around MuJoCo that holds
several exported policies and routes between them. Policy id -2 resets the
robot, the motion's end advances to the next policy, and actions are
EMA-blended across switches. Robustness "attacks" follow the reference
MuJoCo deploy options (reference deploy/mujoco.py:217-241,460-528): IMU
noise (OU/white/pink), action delay, actuation masking, motor offset, vMF
joint-velocity perturbation, tanh torque saturation.

`_load_policy` runs an `.onnx` on the native executor
(`deploy/native/onnx_exec.py`), with the metadata of the run two directories
up (`deploy/onnx_numpy.py::meta_from_reference_config`), and an `.npz` on
`NumpyPolicy`. Unlike the JAX function, a failure to build or plan the
native executor raises: nothing falls back to the numpy executor.

CLI:
    python -m pbhc_tpu_torch.deploy.urci policy_a.npz [policy_b.npz ...] \\
        [steps=1000] [deploy=single|multiple|external] [attack.imu=OU] [attack.action_delay_ms=10] ...
`deploy=<group>` reads `config/groups/deploy/<group>.json` (the JSON of
the JAX package's `config/deploy/<group>.yaml`). MuJoCo is needed to run it.
"""
from __future__ import annotations

import sys
from collections import deque
from pathlib import Path

import numpy as np

from pbhc_tpu_torch.deploy.mujoco_runtime import MujocoDeployRobot, ObsBuilder
from pbhc_tpu_torch.utils.noise_tool import RadialPerturbation, noise_process_dict


class AttackConfig:
    def __init__(self, **kw):
        self.imu = kw.get("imu")                       # None | OU | white | pink
        self.imu_rpy_scale = float(kw.get("imu_rpy_scale", 1.0))    # degrees
        self.imu_ang_vel_scale = float(kw.get("imu_ang_vel_scale", 0.1))
        self.action_delay_ms = float(kw.get("action_delay_ms", 0.0))
        self.actuation_mask = kw.get("actuation_mask")  # list of dof indices to freeze
        self.motor_offset = float(kw.get("motor_offset", 0.0))
        self.dq_radial = bool(kw.get("dq_radial", False))
        self.tanh_torque = bool(kw.get("tanh_torque", False))


class URCIRobot(MujocoDeployRobot):
    """MujocoDeployRobot + attacks + multi-policy routing."""

    RESET_PID = -2

    def __init__(self, policy_paths, motion_file=None, attack: AttackConfig = None, **kw):
        self.policies = [str(p) for p in policy_paths]
        attack = attack or AttackConfig()
        first = _load_policy(self.policies[0], motion_file)
        super().__init__(first, motion_file or first.meta.get("motion_file"), **kw)
        self.attack = attack
        self._imu = None
        if attack.imu:
            self._imu = noise_process_dict[attack.imu](shape=(6,), dt=self.ctrl_dt)
        self._radial = RadialPerturbation() if attack.dq_radial else None
        delay_steps = int(round(attack.action_delay_ms / 1000.0 / self.ctrl_dt * self.decimation))
        self._action_queue = deque(maxlen=max(delay_steps, 1))
        self.cur_pid = 0
        self._blend = 0.0
        self._prev_action = np.zeros(self.nd, dtype=np.float32)

    # ------------------------------------------------------- attacked state
    @property
    def base_ang_vel_local(self):
        w = self.d.qvel[3:6].copy()
        if self._imu is not None:
            w = w + self._imu_sample[3:6] * self.attack.imu_ang_vel_scale
        return w

    @property
    def projected_gravity(self):
        from scipy.spatial.transform import Rotation as sRot

        q = self.base_quat_xyzw
        if self._imu is not None:
            rpy = sRot.from_quat(q).as_euler("xyz")
            rpy = rpy + self._imu_sample[:3] * self.attack.imu_rpy_scale * np.pi / 180.0
            q = sRot.from_euler("xyz", rpy).as_quat()
        return sRot.from_quat(q).apply([0.0, 0.0, -1.0], inverse=True)

    @property
    def dq(self):
        v = self.d.qvel[6:].copy()
        if self._radial is not None:
            v = self._radial.apply(v)
        return v

    # ----------------------------------------------------------- control
    def control_step(self):
        if self._imu is not None:
            self._imu_sample = self._imu.step()
        obs = self.obs_builder.build(self)
        action = np.clip(self.policy(obs), -self.action_clip, self.action_clip)
        # EMA blend across policy switches (reference urcirobot.py:176-197)
        if self._blend < 1.0:
            action = self._blend * action + (1 - self._blend) * self._prev_action
            self._blend = min(1.0, self._blend + 0.1)
        self.last_action = action.astype(np.float32)
        self._prev_action = self.last_action

        target = action * self.action_scale + self.default_dof
        if self.attack.motor_offset:
            target = target + self.attack.motor_offset
        for _ in range(self.decimation):
            tau = self.kp * (target - self.d.qpos[7:]) - self.kd * self.d.qvel[6:]
            tau = np.clip(tau, -self.tau_lim, self.tau_lim)
            if self.attack.tanh_torque:
                tau = self.tau_lim * np.tanh(tau / np.maximum(self.tau_lim, 1e-6))
            if self.attack.actuation_mask:
                tau[np.asarray(self.attack.actuation_mask, dtype=int)] = 0.0
            if self._action_queue.maxlen > 1:
                self._action_queue.append(tau)
                tau = self._action_queue[0]
            self.d.ctrl[:] = 0
            self.d.qfrc_applied[:] = 0
            self.d.qfrc_applied[6:] = tau
            self._mujoco.mj_step(self.m, self.d)
        self.t += self.ctrl_dt

    # ------------------------------------------------------------ routing
    def switch_policy(self, pid):
        """Switch to policy `pid` (reference urcirobot.py:126-212 SetObsCfg)."""
        if pid == self.RESET_PID:
            self.reset()
            self._blend = 1.0
            return
        self.policy = _load_policy(self.policies[pid])
        self.meta = self.policy.meta
        self.obs_builder = ObsBuilder(self.meta)
        self.cur_pid = pid
        self._blend = 0.0  # EMA-blend in the new policy's actions
        self.t = 0.0       # new motion phase

    def routing(self, total_steps=None, loop=True):
        """Run policies in sequence; motion end advances to the next policy."""
        self.reset()
        traj = {"root_pos": [], "root_rot": [], "dof_pos": [], "dof_vel": [],
                "root_lin_vel": [], "root_ang_vel": [], "pid": []}
        steps = 0
        while total_steps is None or steps < total_steps:
            self.control_step()
            traj["root_pos"].append(self.d.qpos[:3].copy())
            traj["root_rot"].append(self.d.qpos[3:7][[1, 2, 3, 0]].copy())  # wxyz->xyzw
            traj["dof_pos"].append(self.q)
            traj["dof_vel"].append(self.d.qvel[6:].copy())
            traj["root_lin_vel"].append(self.d.qvel[:3].copy())
            traj["root_ang_vel"].append(self.d.qvel[3:6].copy())
            traj["pid"].append(self.cur_pid)
            steps += 1
            if self.phase >= 1.0:  # motion end -> next policy (reference :188-197)
                nxt = self.cur_pid + 1
                if nxt >= len(self.policies):
                    if not loop:
                        break
                    nxt = 0
                self.switch_policy(nxt)
            if total_steps is None and steps > 100000:
                break
        return {k: np.asarray(v) for k, v in traj.items()}


def _load_policy(path, motion_file=None):
    """`.npz` -> `NumpyPolicy`; `.onnx` -> `NativeOnnxPolicy` with the metadata
    of the run two directories up (reference urci.py:97-174 load_policy and
    its config lookup). A native build or plan failure raises."""
    if str(path).endswith(".onnx"):
        from pbhc_tpu_torch.deploy.native.onnx_exec import NativeOnnxPolicy
        from pbhc_tpu_torch.deploy.onnx_numpy import meta_from_reference_config

        meta = meta_from_reference_config(Path(path).resolve().parent.parent, motion_file)
        return NativeOnnxPolicy(path, meta)
    from pbhc_tpu_torch.deploy.export import NumpyPolicy

    return NumpyPolicy(path)


def main(argv=None):
    """Runs the routing loop; returns its trajectory."""
    argv = argv or sys.argv[1:]
    paths = [a for a in argv if not ("=" in a)]
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    # deploy=<single|multiple|external> loads the deploy config group
    # (reference config/deploy/*.yaml) for defaults; explicit kv wins
    dep = {}
    if "deploy" in kv:
        import json

        grp = Path(__file__).resolve().parents[1] / "config" / "groups" / "deploy" / f"{kv.pop('deploy')}.json"
        dep = json.loads(grp.read_text())["deploy"]
    steps = int(kv.pop("steps", dep.get("steps", 500)))
    loop = str(kv.pop("loop", dep.get("loop", "true"))).lower() in ("true", "1")
    attack_kw = {k[7:]: v for k, v in kv.items() if k.startswith("attack.")}
    robot = URCIRobot(paths, motion_file=kv.get("motion_file"), attack=AttackConfig(**attack_kw))
    if dep.get("deploy_mode") == "external":
        # drive the full loop with a stub policy (reference external/core.py);
        # the first npz still provides robot meta (gains, scales, obs spec)
        from pbhc_tpu_torch.deploy.external import get_external_policy

        robot.policy = get_external_policy(
            str(kv.pop("external_policy", dep.get("external_policy", "zero"))),
            dict(robot.meta, dt=robot.ctrl_dt))
    if not bool(dep.get("switch_ema", True)):
        robot._blend = 1.0
    traj = robot.routing(total_steps=steps, loop=loop)
    print(f"[urci] ran {len(traj['pid'])} steps over {len(paths)} policies; "
          f"final root z={traj['root_pos'][-1, 2]:.3f}; "
          f"policy switches={int((np.diff(traj['pid']) != 0).sum())}")
    return traj


if __name__ == "__main__":
    main()
