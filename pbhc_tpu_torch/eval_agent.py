"""Evaluation CLI (counterpart of `pbhc_tpu/eval_agent.py:22-198`).

Usage:
    python -m pbhc_tpu_torch.eval_agent checkpoint=<run>/ckpt/model_<it>.pkl \\
        [num_envs=1] [callbacks=plot,force,openloop] [dashboard=true] [sim2sim=true]
        [save_motion=true] [device=cpu] [a.b.c=value]

Reads the config of the run that wrote the checkpoint (its `config.json`,
else the committed snapshot: `config/loader.py::snapshot_for_checkpoint`),
exports the deploy policy beside it (`<run>/exported/model_<it>.npz` and
`.onnx`, the same bytes as `pbhc_tpu` writes), rolls the deterministic
policy from clip time 0 with env 0 recorded, computes the E_* accuracy and
L2_* smoothness families against the reference motion, and writes them with
the completion ratio to `<run>/eval_model_<it>.json`. It runs on the first
CUDA card unless `device=` names another device. `sim2sim=true` also replays
the exported `.npz` in MuJoCo for one clip length (`eval/sim2sim.py`; MuJoCo
must be installed) and adds its families under `sim2sim`.

The reference is fetched as `rollout_jax` fetches it, without the env's
terrain origin shift (`pbhc_tpu/eval_agent.py:68`), so on a heightfield run
the global family `E_gmpbpe` includes the tile offset (ROADMAP queue 3).
`save_motion=true` (or `save_motion` in the run's config) also writes env
0's rollout as a training-format motion clip, `<run>/motion_model_<it>.pkl`
(`save_rollout_motion`: the JAX package's schema, written by
`motion/package.dump`, which `joblib.load` reads).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch
from scipy.spatial.transform import Rotation as sRot

from pbhc_tpu_torch.agents.networks import GaussianActor, PhaseAwareActor
from pbhc_tpu_torch.deploy.export import export_policy
from pbhc_tpu_torch.eval import batch_eval
from pbhc_tpu_torch.eval.callbacks import build_callbacks
from pbhc_tpu_torch.eval.dashboard import DashboardLogger
from pbhc_tpu_torch.eval.metrics import eval_accuracy, eval_smoothness
from pbhc_tpu_torch.motion.motion_lib import get_motion_state
from pbhc_tpu_torch.motion.package import dump
from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload

TRAJ_KEYS = ("root_pos", "root_rot", "dof_pos", "body_pos", "body_rot", "contact_mask", "dof_vel",
             "root_lin_vel", "root_ang_vel", "action")
REF_KEYS = ("root_pos", "root_rot", "dof_pos", "body_pos", "body_rot", "contact_mask")


def rollout(env, actor, num_steps, dashboard=None, callbacks=None):
    """Deterministic rollout from clip time 0 (`rollout_jax`,
    `eval_agent.py:22`). Returns env 0's trajectory and reference as dicts
    of [T, ...] numpy arrays, and its per-step `done` flags; it stops after
    the step on which env 0 is done."""
    state, obs = batch_eval.start_episodes(env)
    callbacks = callbacks or []
    for cb in callbacks:
        cb.on_pre_evaluate_policy()
    traj = {k: [] for k in TRAJ_KEYS}
    ref = {k: [] for k in REF_KEYS}
    dones = []
    for step_i in range(num_steps):
        with torch.no_grad():
            actions = batch_eval.act_mean(actor, obs)
        actor_state = {"step": step_i, "obs": obs, "actions": actions, "env_state": state}
        for cb in callbacks:
            actor_state = cb.on_pre_eval_env_step(actor_state)
        actions = torch.as_tensor(actor_state["actions"], dtype=torch.float32, device=env.device)
        with torch.no_grad():
            state, obs, _, done, info = env.step(state, actions)
        actor_state["env_state"] = state
        for cb in callbacks:
            actor_state = cb.on_post_eval_env_step(actor_state)
        sim = state.sim
        body_pos, body_quat, _, _ = env._extend_body_states(sim)
        t = state.episode_length.to(torch.float32) * env.dt + state.motion_start_times
        mres = get_motion_state(env.motion_lib.data, state.motion_ids, t)
        for k, v in (("root_pos", sim.root_pos), ("root_rot", sim.root_quat), ("dof_pos", sim.dof_pos),
                     ("body_pos", body_pos), ("body_rot", body_quat), ("contact_mask", state.contacts_filt),
                     ("dof_vel", sim.dof_vel), ("root_lin_vel", sim.root_lin_vel),
                     ("root_ang_vel", sim.root_ang_vel), ("action", actions)):
            traj[k].append(v[0].clone())
        for k, v in (("root_pos", mres["root_pos"]), ("root_rot", mres["root_rot"]), ("dof_pos", mres["dof_pos"]),
                     ("body_pos", mres["rg_pos_t"]), ("body_rot", mres["rg_rot_t"]),
                     ("contact_mask", mres["contact_mask"])):
            ref[k].append(v[0].clone())
        if dashboard is not None:
            scal = {k: float(v) for k, v in info["log"].items()
                    if k.startswith("rew_") or "diff_norm" in k or "sigma" in k}
            scal["root_z"] = float(sim.root_pos[0, 2])
            scal["dof_err"] = float(torch.abs(mres["dof_pos"][0] - sim.dof_pos[0]).mean())
            dashboard.log_step(scal)
        dones.append(bool(done[0]))
        if dones[-1]:
            break
    for cb in callbacks:
        cb.on_post_evaluate_policy()
    stack = lambda d: {k: torch.stack(v).cpu().numpy() for k, v in d.items()}
    return stack(traj), stack(ref), dones


def clip_steps(env) -> int:
    """Control steps in the clip (`eval_agent.py:154`)."""
    return int(float(env.motion_lib.data.lengths[0]) / env.dt)


def main(argv=None):
    """Returns the results written to `eval_<stem>.json`."""
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv)
    ckpt_path = Path(kv.pop("checkpoint"))
    sim2sim = kv.pop("sim2sim", "false").lower() == "true"
    save_motion_arg = kv.pop("save_motion", None)
    dashboard_flag = kv.pop("dashboard", "false").lower() == "true"
    callback_names = kv.pop("callbacks", "")
    num_envs = int(kv.pop("num_envs", 1))
    device = kv.pop("device", "cuda")

    env, actor, cfg = batch_eval.load(ckpt_path, num_envs, [f"{k}={v}" for k, v in kv.items()], device)
    if not isinstance(actor, (GaussianActor, PhaseAwareActor)):
        raise NotImplementedError("eval_agent exports and scores MHPPO actors, as the JAX CLI does; export a "
                                  "PPOMimic student with `python -m pbhc_tpu_torch.deploy.export student <ckpt>`")
    # a run trained with opt=record carries save_motion in its config
    save_motion = (save_motion_arg.lower() == "true" if save_motion_arg is not None
                   else bool(cfg.get("save_motion")))
    run_dir = ckpt_path.parent.parent
    # the checkpoint's arrays as stored, so that the .npz holds pbhc_tpu's bytes
    npz_path = export_policy(actor, load_checkpoint_payload(ckpt_path)["actor_params"], env,
                             run_dir / "exported" / f"{ckpt_path.stem}.npz",
                             meta_extra={"motion_file": str(cfg.robot.motion.motion_file)})
    print(f"[eval] exported policy -> {npz_path}")

    dash = None
    if dashboard_flag:
        dash = DashboardLogger()
        print(f"[eval] live dashboard at {dash.start()}")
    callbacks = build_callbacks(callback_names.split(","), cfg, env, dashboard=dash)

    num_steps = clip_steps(env)
    traj, ref, _ = rollout(env, actor, num_steps, dashboard=dash, callbacks=callbacks)
    acc = eval_accuracy(traj, ref, env.dt)
    smooth = eval_smoothness(traj, env.dt, ref=ref)
    ratio = len(traj["dof_pos"]) / num_steps
    print(f"[eval] episode completed {len(traj['dof_pos'])}/{num_steps} steps (ratio {ratio:.3f})")
    print("[eval] accuracy:", json.dumps({k: round(v, 4) for k, v in acc.items()}))
    print("[eval] smoothness:", json.dumps({k: round(v, 4) for k, v in smooth.items()}))
    results = {"accuracy": acc, "smoothness": smooth, "completion_ratio": ratio}
    if sim2sim:
        # the MuJoCo replay of the export, scored with the same families
        # (`eval_agent.py:178-189`; reference urci.py replay + measure_traj.py)
        from pbhc_tpu_torch.eval.sim2sim import rollout_metrics

        s2s = rollout_metrics(npz_path, cfg.robot.motion.motion_file, robot_type=str(cfg.robot.robot_type),
                              fix_height=str(cfg.robot.motion.get("fix_height", "no_fix")), device=device)
        print(f"[eval] sim2sim replay: {s2s['steps']} steps, final root z={s2s['final_z']:.3f}, "
              f"E_mpjpe={s2s['accuracy']['E_mpjpe']:.1f}")
        results["sim2sim_final_z"] = s2s["final_z"]
        results["sim2sim"] = s2s
    if save_motion:
        # the rollout in the training-data schema (`eval_agent.py:190-193`;
        # reference motion_tracking.py:140-169,860-940 `save_motion`)
        save_rollout_motion(env, traj, run_dir / f"motion_{ckpt_path.stem}.pkl")
    out = run_dir / f"eval_{ckpt_path.stem}.json"
    out.write_text(json.dumps(results, indent=1))
    print(f"[eval] wrote {out}")
    if dash is not None:
        dash.stop()
    return results


def save_rollout_motion(env, traj, path):
    """Write a rollout (`rollout`'s trajectory) as a training-format motion
    pkl `{"rollout": clip}` (`pbhc_tpu/eval_agent.py:201-230`: the schema of
    reference motion_lib_base.py:421-441 plus the rollout's extras)."""
    T = len(traj["dof_pos"])
    axes = np.asarray(env.motion_model.dof_axis)
    root_aa = sRot.from_quat(traj["root_rot"]).as_rotvec()
    pose_aa = np.concatenate([
        root_aa[:, None, :],
        traj["dof_pos"][:, :, None] * axes[None],
        np.zeros((T, env.num_extend, 3)),
    ], axis=1).astype(np.float32)
    clip = {
        "root_trans_offset": traj["root_pos"].astype(np.float32),
        "root_rot": traj["root_rot"].astype(np.float32),
        "dof": traj["dof_pos"].astype(np.float32),
        "pose_aa": pose_aa,
        "fps": int(round(1.0 / env.dt)),
        "contact_mask": traj["contact_mask"].astype(np.float64),
        "dof_vel": traj["dof_vel"].astype(np.float32),
        "root_lin_vel": traj["root_lin_vel"].astype(np.float32),
        "root_ang_vel": traj["root_ang_vel"].astype(np.float32),
        "action": traj["action"].astype(np.float32),
    }
    dump({"rollout": clip}, path)
    print(f"[eval] saved rollout motion -> {path}")
    return path


if __name__ == "__main__":
    main()
