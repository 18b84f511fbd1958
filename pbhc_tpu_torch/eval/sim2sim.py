"""Sim2sim metric rollout: an exported policy in MuJoCo, scored by the E_*/L2_*
families (counterpart of `pbhc_tpu/eval/sim2sim.py`).

The reference's validation idiom (reference README.md:104: train, replay in
MuJoCo through urci.py, measure with measure_traj.py) as one call, used by
`eval_agent sim2sim=true`. The rollout runs on the host (MuJoCo and the
export's host executor); the forward kinematics of the rolled trajectory
and the reference clip it is scored against are computed on `device`
(default "cuda", the caller's device). MuJoCo is needed to run either
function; `mujoco` is imported inside them through the runtimes.
"""
from __future__ import annotations

import numpy as np
import torch


def _score(traj, ctrl_dt, motion_file, robot_type, fix_height, device):
    """The families of a MuJoCo trajectory {root_pos, root_rot (xyzw),
    dof_pos, root_vel} ([T, ...] numpy) against the clip's reference from
    time 0, on the bodies the FK gives (no extended bodies)."""
    from pbhc_tpu_torch.eval.metrics import eval_accuracy, eval_smoothness
    from pbhc_tpu_torch.model.g1 import load_g1_motion_model
    from pbhc_tpu_torch.model.kinematics import fk_root_dof
    from pbhc_tpu_torch.motion.motion_lib import MotionLib, get_motion_state

    model = load_g1_motion_model(robot_type)
    T = len(traj["dof_pos"])
    t = lambda k: torch.as_tensor(traj[k], dtype=torch.float32, device=device)
    with torch.no_grad():
        body_pos, body_rot, _ = fk_root_dof(model, t("root_pos"), t("root_rot"), t("dof_pos"))
    traj_d = {"body_pos": body_pos.cpu().numpy(), "body_rot": body_rot.cpu().numpy(),
              "dof_pos": traj["dof_pos"], "root_pos": traj["root_pos"], "root_vel": traj["root_vel"]}
    # the training run's fix_height, so that the reference is the one the policy trained on
    ml = MotionLib(str(motion_file), model, num_envs=1, step_dt=ctrl_dt, fix_height=str(fix_height),
                   device=device)
    times = torch.as_tensor(np.arange(T) * ctrl_dt, dtype=torch.float32, device=device)
    mres = get_motion_state(ml.data, torch.zeros(T, dtype=torch.int64, device=device), times)
    host = lambda k: mres[k].cpu().numpy()
    B = traj_d["body_pos"].shape[1]
    ref_d = {"body_pos": host("rg_pos_t")[:, :B], "body_rot": host("rg_rot_t")[:, :B],
             "dof_pos": host("dof_pos"), "root_pos": host("root_pos"), "root_vel": host("root_vel"),
             "contact_mask": host("contact_mask")}
    return {
        "accuracy": eval_accuracy(traj_d, ref_d, ctrl_dt),
        "smoothness": eval_smoothness(traj_d, ctrl_dt, ref=ref_d),
        "steps": T,
        "final_z": float(traj_d["root_pos"][-1, 2]),
    }


def rollout_metrics(policy_path, motion_file, robot_type="g1_23dof_lock_wrist", fix_height="no_fix",
                    device="cuda"):
    """Roll `policy_path` (an `.npz` export, or an `.onnx` with its run's
    config two directories up) through the URCI runtime for one clip length
    and score it against the reference (`sim2sim.py:14`). Returns
    {"accuracy", "smoothness", "steps", "final_z"}."""
    from pbhc_tpu_torch.deploy.urci import URCIRobot

    robot = URCIRobot([str(policy_path)], motion_file=str(motion_file))
    n_steps = int(robot.motion.data.num_frames[0] / robot.motion.data.fps[0] / robot.ctrl_dt)
    traj = robot.routing(total_steps=n_steps, loop=False)
    traj = {"root_pos": traj["root_pos"], "root_rot": traj["root_rot"], "dof_pos": traj["dof_pos"],
            "root_vel": traj["root_lin_vel"]}
    return _score(traj, robot.ctrl_dt, motion_file, robot_type, fix_height, device)


def student_rollout_metrics(onnx_path, motion_file=None, robot_type=None, fix_height="no_fix", device="cuda"):
    """Sim2sim of the 3-input student export through the real-robot
    controller (`StudentPolicy` on the native core, `StudentObsBuilder`,
    50 Hz) over the MuJoCo loopback transport, scored as `rollout_metrics`
    is (`sim2sim.py:66`)."""
    from pbhc_tpu_torch.deploy.export import StudentPolicy
    from pbhc_tpu_torch.deploy.mujoco_runtime import MujocoDeployRobot
    from pbhc_tpu_torch.deploy.real_robot import LoopbackTransport, RealRobotController

    policy = StudentPolicy(onnx_path)
    mf = str(motion_file or policy.meta["motion_file"])
    robot_type = robot_type or policy.meta.get("robot_type", "g1_29dof_rev_1_0")
    sim = MujocoDeployRobot(policy, mf, robot_type=robot_type)
    sim.reset()
    # compensate_offsets=False is the training and sim2sim obs idiom (the full
    # anchor quat, no initial offsets); True is the hardware idiom
    ctrl = RealRobotController(str(onnx_path), LoopbackTransport(sim), motion_file=mf, compensate_offsets=False)
    if not ctrl.is_student:
        raise ValueError(f"{onnx_path} is not a 3-input student export")
    ctrl.mode = ctrl.POLICY

    n_steps = int(float(sim.motion.data.lengths[0]) / ctrl.ctrl_dt)
    traj = {"root_pos": [], "root_rot": [], "dof_pos": []}
    for _ in range(n_steps):
        ctrl.step()
        traj["root_pos"].append(sim.d.qpos[:3].copy())
        traj["root_rot"].append(sim.base_quat_xyzw)
        traj["dof_pos"].append(sim.q)
    traj = {k: np.stack(v) for k, v in traj.items()}
    traj["root_vel"] = np.gradient(traj["root_pos"], ctrl.ctrl_dt, axis=0)
    return _score(traj, ctrl.ctrl_dt, mf, robot_type, fix_height, device)
