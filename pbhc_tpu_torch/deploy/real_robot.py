"""Real-robot deployment controller (counterpart of
`pbhc_tpu/deploy/real_robot.py`; reference deploy_real/deploy_real.py).

A 50 Hz wall-clock loop over a LowState-subscribe / LowCmd-publish transport
with the zero-torque -> move-to-default -> default-pose -> policy state
machine of the reference Unitree G1 controller, first-step dof/roll-pitch
offset compensation, and obs logging. Everything runs on the robot's
onboard PC: numpy state, the export's host executor (the native core of
`deploy/native/`), and the reference clip in a `MotionLib` on `device`
(default "cpu", the robot PC's device), read on the host.

The Unitree SDK2 (CycloneDDS) exists only on the robot, so the transport is
an interface: `UnitreeDDSTransport` binds to `unitree_sdk2py` where it is
installed; `LoopbackTransport` runs the same controller against the MuJoCo
runtime. Unlike the JAX controller, a policy whose native executor fails to
build or plan raises instead of falling back to numpy. `main` reads its
robot config as JSON (`config/groups/deploy/real_g1_23*.json`); JSON is
YAML, so one file serves both packages.
"""
from __future__ import annotations

import struct
import time
from dataclasses import dataclass

import numpy as np

from pbhc_tpu_torch.deploy.mujoco_runtime import ObsBuilder


class KeyMap:
    """Wireless-remote button bit indices (reference common/remote_controller.py)."""

    R1, L1, start, select, R2, L2, F1, F2 = range(8)
    A, B, X, Y, up, right, down, left = range(8, 16)


class RemoteController:
    """Decodes the 40-byte wireless_remote blob from LowState.

    Layout (reference common/remote_controller.py:24-38): uint16 button bits
    at offset 2, then float32 lx@4, rx@8, ry@12, ly@20.
    """

    def __init__(self):
        self.lx = self.ly = self.rx = self.ry = 0.0
        self.button = [0] * 16

    def set(self, data):
        keys = struct.unpack("<H", bytes(data[2:4]))[0]
        for i in range(16):
            self.button[i] = (keys >> i) & 1
        self.lx = struct.unpack("<f", bytes(data[4:8]))[0]
        self.rx = struct.unpack("<f", bytes(data[8:12]))[0]
        self.ry = struct.unpack("<f", bytes(data[12:16]))[0]
        self.ly = struct.unpack("<f", bytes(data[20:24]))[0]


@dataclass
class G1DeployMap:
    """G1 motor-bus layout for the 23-DoF lock-wrist policy
    (reference deploy_real/configs/g1_23.yaml): 29 motors on the bus; the 23
    policy DoFs map through `policy2motor`, the 6 wrist motors are held at
    `held_target` with soft gains."""

    policy2motor: tuple = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
                           12, 13, 14, 15, 16, 17, 18, 22, 23, 24, 25)
    held_motor_idx: tuple = (19, 20, 21, 26, 27, 28)
    held_target: tuple = (0.0,) * 6
    held_kp: tuple = (20.0,) * 6
    held_kd: tuple = (1.0,) * 6
    num_motors: int = 29
    mode_pr: int = 0       # MotorMode.PR: series control for pitch/roll joints
    weak_motor: tuple = ()


@dataclass
class LowState:
    q: np.ndarray
    dq: np.ndarray
    quat_xyzw: np.ndarray
    ang_vel_body: np.ndarray


class Transport:
    """LowState/LowCmd bus interface."""

    def read_state(self) -> LowState:
        raise NotImplementedError

    def send_command(self, q_target, kp, kd):
        raise NotImplementedError


class UnitreeDDSTransport(Transport):
    """Real robot over unitree_sdk2py DDS (reference deploy_real.py:148-188,
    557-569): LowState subscriber + CRC-stamped LowCmd publisher on the `hg`
    (humanoid G1/H1-2) message family, with the policy-DoF <-> motor-bus index
    map and the six held wrist motors.

    The SDK (CycloneDDS bindings) exists only on the robot's onboard PC, so
    the import is gated; everything else is complete.
    """

    def __init__(self, net_interface, deploy_map: G1DeployMap | None = None,
                 lowcmd_topic="rt/lowcmd", lowstate_topic="rt/lowstate",
                 domain_id=0):
        try:
            from unitree_sdk2py.core.channel import (ChannelFactoryInitialize,
                                                     ChannelPublisher,
                                                     ChannelSubscriber)
            from unitree_sdk2py.idl.default import (
                unitree_hg_msg_dds__LowCmd_, unitree_hg_msg_dds__LowState_)
            from unitree_sdk2py.idl.unitree_hg.msg.dds_ import (LowCmd_,
                                                                LowState_)
            from unitree_sdk2py.utils.crc import CRC
        except ImportError as e:  # pragma: no cover - hardware-only dep
            raise ImportError("unitree_sdk2py is required for real-robot deploy") from e

        self.map = deploy_map or G1DeployMap()
        self.remote = RemoteController()
        self._crc = CRC()
        ChannelFactoryInitialize(domain_id, net_interface)

        self.low_state = unitree_hg_msg_dds__LowState_()
        self.low_cmd = unitree_hg_msg_dds__LowCmd_()
        self._mode_machine = 0

        self._pub = ChannelPublisher(lowcmd_topic, LowCmd_)
        self._pub.Init()
        self._sub = ChannelSubscriber(lowstate_topic, LowState_)
        self._sub.Init(self._on_low_state, 10)

        # wait for the first LowState tick (reference wait_for_low_state)
        while self.low_state.tick == 0:
            time.sleep(0.02)

        # init_cmd_hg (reference common/command_helper.py:30-41)
        self.low_cmd.mode_machine = self._mode_machine
        self.low_cmd.mode_pr = self.map.mode_pr
        for mc in self.low_cmd.motor_cmd:
            mc.mode = 1
            mc.q = mc.qd = mc.kp = mc.kd = mc.tau = 0.0

    def _on_low_state(self, msg):
        self.low_state = msg
        self._mode_machine = msg.mode_machine
        self.remote.set(msg.wireless_remote)

    def read_state(self) -> LowState:
        s = self.low_state
        m = self.map
        q = np.array([s.motor_state[i].q for i in m.policy2motor], dtype=np.float32)
        dq = np.array([s.motor_state[i].dq for i in m.policy2motor], dtype=np.float32)
        # IMU quaternion arrives WXYZ (reference deploy_real.py:645)
        w, x, y, z = s.imu_state.quaternion
        quat_xyzw = np.array([x, y, z, w], dtype=np.float32)
        if w < 0:  # canonical form: q and -q are the same rotation
            quat_xyzw = -quat_xyzw
        gyro = np.asarray(s.imu_state.gyroscope, dtype=np.float32)
        return LowState(q=q, dq=dq, quat_xyzw=quat_xyzw, ang_vel_body=gyro)

    def send_command(self, q_target, kp, kd):
        cmd, m = self.low_cmd, self.map
        cmd.mode_machine = self._mode_machine
        for j, mi in enumerate(m.policy2motor):
            mc = cmd.motor_cmd[mi]
            mc.q = float(q_target[j])
            mc.qd = 0.0
            mc.kp = float(kp[j])
            mc.kd = float(kd[j])
            mc.tau = 0.0
        for j, mi in enumerate(m.held_motor_idx):
            mc = cmd.motor_cmd[mi]
            mc.q = float(m.held_target[j])
            mc.qd = 0.0
            mc.kp = float(m.held_kp[j])
            mc.kd = float(m.held_kd[j])
            mc.tau = 0.0
        cmd.crc = self._crc.Crc(cmd)
        self._pub.Write(cmd)

    def send_damping(self):
        """Emergency damping (reference create_damping_cmd): kd=8 everywhere."""
        cmd = self.low_cmd
        for mc in cmd.motor_cmd:
            mc.q = mc.qd = mc.kp = mc.tau = 0.0
            mc.kd = 8.0
        cmd.crc = self._crc.Crc(cmd)
        self._pub.Write(cmd)


class LoopbackTransport(Transport):
    """Drives the MuJoCo runtime with the exact controller pathway (sim2sim)."""

    def __init__(self, robot):
        self.robot = robot

    def read_state(self):
        r = self.robot
        return LowState(q=r.d.qpos[7:].copy(), dq=r.d.qvel[6:].copy(),
                        quat_xyzw=r.base_quat_xyzw, ang_vel_body=r.d.qvel[3:6].copy())

    def send_command(self, q_target, kp, kd):
        r = self.robot
        for _ in range(r.decimation):
            tau = kp * (q_target - r.d.qpos[7:]) - kd * r.d.qvel[6:]
            r.d.qfrc_applied[:] = 0
            r.d.qfrc_applied[6:] = np.clip(tau, -r.tau_lim, r.tau_lim)
            r._mujoco.mj_step(r.m, r.d)


class RealRobotController:
    """50 Hz control state machine (reference deploy_real.py:575-636,637-900)."""

    ZERO_TORQUE, MOVE_TO_DEFAULT, DEFAULT_POSE, POLICY = range(4)

    def __init__(self, policy_path, transport: Transport, motion_file=None,
                 ctrl_dt=0.02, move_duration_s=2.0, realtime=False,
                 compensate_offsets=True, device="cpu"):
        # a student ONNX (3 inputs, `.meta.json` beside it) -> StudentPolicy,
        # else an .npz on the native MLP core: both the host C++ cores, for a
        # deterministic tick latency (the onnxruntime equivalent)
        from pathlib import Path as _P

        if str(policy_path).endswith(".onnx") and _P(str(policy_path) + ".meta.json").exists():
            from pbhc_tpu_torch.deploy.export import StudentPolicy

            self.policy = StudentPolicy(policy_path, native=True)
        else:
            from pbhc_tpu_torch.deploy.native import NativePolicy

            self.policy = NativePolicy(policy_path)
        self.meta = self.policy.meta
        # 3-input student policies get the general-tracking obs twin
        # (reference deploy_real.py:820-905); single-input ones the KB1 builder
        self.is_student = "prop_history" in self.meta.get("obs_groups", {})
        self.compensate_offsets = bool(compensate_offsets)
        self.obs_builder = None if self.is_student else ObsBuilder(self.meta)
        self.transport = transport
        self.ctrl_dt = ctrl_dt
        self.realtime = realtime
        self.kp = np.asarray(self.meta["kp"])
        self.kd = np.asarray(self.meta["kd"])
        self.default_dof = np.asarray(self.meta["default_dof_pos"])
        self.action_scale = np.asarray(self.meta["action_scale"])
        self.action_clip = self.meta["action_clip"]
        self.nd = len(self.default_dof)
        self.mode = self.ZERO_TORQUE
        self.move_steps = int(move_duration_s / ctrl_dt)
        self._move_i = 0
        self._move_start_q = None
        self.last_action = np.zeros(self.nd, dtype=np.float32)
        self.t = 0.0
        # first-policy-step compensation offsets (reference deploy_real.py:654-662)
        self._init_dof_offset = None
        self.obs_log = []

        from pbhc_tpu_torch.model.g1 import load_g1_motion_model
        from pbhc_tpu_torch.motion.motion_lib import MotionLib

        mf = motion_file or self.meta.get("motion_file")
        # the motion model must match the policy's robot (29-dof students
        # index extended key bodies beyond the 23-dof body count)
        rt = self.meta.get("robot_type", "g1_23dof_lock_wrist")
        self.motion = MotionLib(mf, load_g1_motion_model(rt), 1, ctrl_dt, device=device) if mf else None
        if self.is_student:
            from pbhc_tpu_torch.deploy.student_obs import MotionHost, StudentObsBuilder

            if self.motion is None:
                raise ValueError("a student policy needs a motion file")
            self.obs_builder = StudentObsBuilder(
                self.meta, MotionHost(self.motion),
                compensate_offsets=self.compensate_offsets)

    # --- state properties consumed by the obs builders
    @property
    def q(self):
        # KB1 path: captured init offset APPLIED to the dof obs (reference
        # deploy_real.py:696-699); student path compensates inside its builder
        if self._init_dof_offset is not None:
            return self._state.q - self._init_dof_offset
        return self._state.q

    @property
    def dq(self):
        return self._state.dq

    @property
    def quat_xyzw(self):
        return self._state.quat_xyzw

    @property
    def base_ang_vel_local(self):
        return self._state.ang_vel_body

    @property
    def projected_gravity(self):
        from scipy.spatial.transform import Rotation as sRot

        return sRot.from_quat(self._state.quat_xyzw).apply([0, 0, -1.0], inverse=True)

    @property
    def phase(self):
        if self.motion is None:
            return 0.0
        return min(self.t / float(self.motion.data.lengths[0]), 1.0)

    # ------------------------------------------------------------------ modes
    def request_policy(self):
        """Remote-button equivalent: advance the state machine."""
        if self.mode == self.ZERO_TORQUE:
            self.mode = self.MOVE_TO_DEFAULT
            self._move_i = 0
            self._move_start_q = self._state.q.copy() if hasattr(self, "_state") else None
        elif self.mode == self.DEFAULT_POSE:
            self.mode = self.POLICY
            self._init_dof_offset = None

    def step(self):
        t0 = time.time()
        self._state = self.transport.read_state()

        if self.mode == self.ZERO_TORQUE:
            self.transport.send_command(self._state.q, np.zeros(self.nd), np.zeros(self.nd))
        elif self.mode == self.MOVE_TO_DEFAULT:
            if self._move_start_q is None:
                self._move_start_q = self._state.q.copy()
            w = min(1.0, (self._move_i + 1) / self.move_steps)
            target = (1 - w) * self._move_start_q + w * self.default_dof
            self.transport.send_command(target, self.kp, self.kd)
            self._move_i += 1
            if self._move_i >= self.move_steps:
                self.mode = self.DEFAULT_POSE
        elif self.mode == self.DEFAULT_POSE:
            self.transport.send_command(self.default_dof, self.kp, self.kd)
        else:  # POLICY
            if self.is_student:
                obs = self.obs_builder.build(self, self.t)
                action = self.policy(obs)
            else:
                if self._init_dof_offset is None:
                    # capture step-1 offsets (reference deploy_real.py:654-662)
                    self._init_dof_offset = (
                        (self._state.q - self.default_dof).copy()
                        if self.compensate_offsets else np.zeros(self.nd, np.float32))
                obs = self.obs_builder.build(self)
                action = self.policy(obs)
            action = np.clip(action, -self.action_clip, self.action_clip).reshape(-1)
            self.last_action = action.astype(np.float32)
            target = action * self.action_scale + self.default_dof
            self.transport.send_command(target, self.kp, self.kd)
            self.t += self.ctrl_dt
            self.obs_log.append(obs)

        if self.realtime:
            dt = time.time() - t0
            if dt < self.ctrl_dt:
                time.sleep(self.ctrl_dt - dt)


def main(argv=None):
    """Real-robot entry (reference deploy_real.py:1052-1102):

        python -m pbhc_tpu_torch.deploy.real_robot <net_interface> <config.json>

    Zero torque until START, blend to the default pose, hold until A, then
    run the policy at control_dt; SELECT (or Ctrl-C) drops to damping mode.
    The config's schema is the reference deploy_real/configs/g1_23*.yaml's,
    written as JSON: see pbhc_tpu_torch/config/groups/deploy/real_g1_23{,_student}.json.
    """
    import json
    import sys as _sys

    argv = argv if argv is not None else _sys.argv[1:]
    if len(argv) != 2:
        print(main.__doc__)
        return 1
    net_if, cfg_path = argv
    with open(cfg_path) as f:
        cfg = json.load(f)

    dm = G1DeployMap()
    if "leg_joint2motor_idx" in cfg:  # motor maps overridable per config
        dm = G1DeployMap(
            policy2motor=tuple(cfg["leg_joint2motor_idx"]),
            held_motor_idx=tuple(cfg.get("arm_waist_joint2motor_idx", ())),
            held_target=tuple(cfg.get("arm_waist_target", [0.0] * 6)),
            held_kp=tuple(cfg.get("arm_waist_kps", [20.0] * 6)),
            held_kd=tuple(cfg.get("arm_waist_kds", [1.0] * 6)))
    transport = UnitreeDDSTransport(
        net_if, dm,
        lowcmd_topic=cfg.get("lowcmd_topic", "rt/lowcmd"),
        lowstate_topic=cfg.get("lowstate_topic", "rt/lowstate"))
    ctl = RealRobotController(
        cfg["policy_path"], transport, motion_file=cfg.get("motion_file"),
        ctrl_dt=float(cfg.get("control_dt", 0.02)), realtime=True)

    print("zero torque; press START to move to the default pose...")
    try:
        while True:
            ctl.step()
            btn = transport.remote.button
            if ctl.mode == ctl.ZERO_TORQUE and btn[KeyMap.start]:
                ctl.request_policy()
                print("moving to default pose; press A to run the policy...")
            elif ctl.mode == ctl.DEFAULT_POSE and btn[KeyMap.A]:
                ctl.request_policy()
                print("policy running; SELECT for damping exit")
            if btn[KeyMap.select]:
                break
    except KeyboardInterrupt:
        pass
    transport.send_damping()
    print("damping mode; exit")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
