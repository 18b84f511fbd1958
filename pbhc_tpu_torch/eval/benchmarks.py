"""Benchmark suite of five configurations (counterpart of
`pbhc_tpu/eval/benchmarks.py`, `BASELINE.md`'s configurations).

1. deploy:    exported-policy MuJoCo rollout, single env, on the host (the
   numpy executor of the export; needs `mujoco`, which raises
   `ModuleNotFoundError` where it is missing)
2. walk64:    G1 23-DoF walk tracking (g1_walk_45cms_23dof.pkl), 64 envs
3. punch4096: horse-stance-punch at 4096 envs (`bench.py`'s env)
4. kb2:       KungfuBot2 general tracking (29-DoF) over a library of three
   23-DoF clips merged by `motion/package.merge`, 2048 envs
5. dr29:      29-DoF with full domain randomisation, 1024 envs

Configs 2-5 time 30 control steps of zero actions, after a warm-up of 30, on
the lanes engine (kernel 1). Each config prints one JSON line
{"config", "metric", "value", "unit"}; `main` returns the results with a
`detail` entry each (reward sums, step counts, seconds; config 4 the clips
read back and the env's `num_unique`).

    python -m pbhc_tpu_torch.eval.benchmarks [1|2|3|4|5|all] [device=cpu]
"""
from __future__ import annotations

import json
import sys
import tempfile
import time

import torch

from pbhc_tpu_torch.config.loader import compose
from pbhc_tpu_torch.eval.batch_eval import ENVS, set_precision
from pbhc_tpu_torch.motion.motion_lib import REPO_ROOT, load_motion_dict
from pbhc_tpu_torch.utils.profiling import phase_timer

MOTIONS = REPO_ROOT / "assets" / "motions"
WALK = str(MOTIONS / "g1_walk_45cms_23dof.pkl")
PUNCH = str(MOTIONS / "Horse-stance_punch.pkl")
POSE = str(MOTIONS / "Horse-stance_pose.pkl")
KICK = str(MOTIONS / "Side_kick.pkl")
WALK29 = str(MOTIONS / "g1_rig_Skeleton_Sequence_converted_processed_g1_29dof_rev_1_0.pkl")
V1 = ["exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking", "rewards=motion_tracking",
      "domain_rand=main", "simulator=tpu"]
KB2_29 = ["exp=general_tracking", "robot=g1_29dof", "obs=general_tracking_teacher", "rewards=general_tracking",
          "domain_rand=main", "simulator=tpu"]
STEPS = 30
KEYS = ("config", "metric", "value", "unit")


def make_env(selections, overrides, num_envs, device="cuda"):
    """The env of a composed selection set at `num_envs` envs on `device`."""
    set_precision()
    cfg = compose(selections, list(overrides) + [f"num_envs={num_envs}"])
    return ENVS[cfg.env.target](cfg, num_envs, device=device)


def _env_rollout(env, state, steps):
    """`steps` control steps of zero actions from `state`: (state, the reward
    summed over steps, envs and heads, a tensor on the env's device)."""
    actions = torch.zeros((env.num_envs, env.nd), device=env.device)
    total = torch.zeros((), device=env.device)
    with torch.no_grad():
        for _ in range(steps):
            state, _, rew, _, _ = env.step(state, actions)
            total = total + rew.sum()
    return state, total


def _env_throughput(selections, overrides, num_envs, steps=STEPS, device="cuda"):
    """Env-steps/s of `steps` control steps from `init_state`, after a warm-up
    rollout of as many (JAX times one jitted scan; here the steps are eager),
    the device synchronised around the timed one. Returns (rate, env, detail)."""
    env = make_env(selections, overrides, num_envs, device)
    state, warm = _env_rollout(env, env.init_state(), steps)
    with phase_timer(f"{steps} control steps", state, verbose=False) as t:
        state, timed = _env_rollout(env, state, steps)
    detail = dict(num_envs=num_envs, warmup_steps=steps, steps=steps, seconds=t.elapsed,
                  reward_sums=[float(warm), float(timed)], device=str(env.device))
    return steps * num_envs / t.elapsed, env, detail


def _result(config, eps, detail):
    return {"config": config, "metric": "env_steps_per_sec", "value": round(eps, 1), "unit": "steps/s",
            "detail": detail}


def bench_deploy(device="cuda"):
    """Config 1: MuJoCo deploy rollout rate of a random policy's export
    (single env, on the host; the export's env on `device`). Where MuJoCo is
    missing, `MujocoDeployRobot` raises `ModuleNotFoundError`."""
    from pbhc_tpu_torch.agents.convert import flax_params
    from pbhc_tpu_torch.agents.networks import actor_from_config, flax_init_
    from pbhc_tpu_torch.deploy.export import export_policy
    from pbhc_tpu_torch.deploy.mujoco_runtime import MujocoDeployRobot

    env = make_env(V1, [f"robot.motion.motion_file={POSE}"], 2, device)
    actor = flax_init_(actor_from_config(env.config, env.obs_dim("actor_obs"), env.num_actions),
                       torch.Generator().manual_seed(1))
    with tempfile.TemporaryDirectory() as d:
        npz = export_policy(actor, flax_params(actor), env, f"{d}/p.npz", meta_extra={"motion_file": POSE})
        robot = MujocoDeployRobot(npz, POSE)
        robot.reset()
        for _ in range(10):
            robot.control_step()
        n = 100
        t0 = time.perf_counter()
        for _ in range(n):
            robot.control_step()
        seconds = time.perf_counter() - t0
    rate = n / seconds
    return {"config": "1-deploy-mujoco", "metric": "control_steps_per_sec", "value": round(rate, 1),
            "unit": "50Hz-steps/s (realtime x{:.1f})".format(rate / 50),
            "detail": dict(warmup_steps=10, steps=n, seconds=seconds, device="cpu")}


def bench_walk64(device="cuda"):
    eps, _, detail = _env_throughput(V1, [f"robot.motion.motion_file={WALK}"], 64, device=device)
    return _result("2-walk-64env", eps, detail)


def bench_punch4096(device="cuda"):
    eps, _, detail = _env_throughput(V1, [f"robot.motion.motion_file={PUNCH}"], 4096, device=device)
    return _result("3-punch-4096env", eps, detail)


def bench_kb2(device="cuda"):
    from pbhc_tpu_torch.motion.package import merge

    with tempfile.TemporaryDirectory() as d:
        lib = f"{d}/lib.pkl"
        merge(lib, [POSE, PUNCH, KICK])
        clips = len(load_motion_dict(lib))
        eps, env, detail = _env_throughput(KB2_29, [f"robot.motion.motion_file={lib}"], 2048, device=device)
    detail.update(library_clips=clips, num_unique=int(env.motion_lib.num_unique))
    return _result("4-kb2-multimotion-2048env", eps, detail)


def bench_dr29(device="cuda"):
    eps, _, detail = _env_throughput(KB2_29, [f"robot.motion.motion_file={WALK29}"], 1024, device=device)
    return _result("5-29dof-fullDR-1024env", eps, detail)


BENCHES = {"1": bench_deploy, "2": bench_walk64, "3": bench_punch4096,
           "4": bench_kb2, "5": bench_dr29}


def main(argv=None, device=None):
    """Run `argv[0]` (a config's number, or `all`, the default) on `device`
    (`device=` in `argv`, default cuda); print each config's JSON line and
    return the results."""
    argv = sys.argv[1:] if argv is None else list(argv)
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    pos = [a for a in argv if "=" not in a]
    device = device or kv.get("device", "cuda")
    which = pos[0] if pos else "all"
    out = []
    for k in (list(BENCHES) if which == "all" else [which]):
        res = BENCHES[k](device)
        print(json.dumps({key: res[key] for key in KEYS}), flush=True)
        out.append(res)
    return out


if __name__ == "__main__":
    main()
