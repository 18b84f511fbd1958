"""A full training iteration over `n` data-parallel ranks (the port's twin of
`__graft_entry__.dryrun_multichip`, `__graft_entry__.py:51-107`).

Spawns `n` ranks, each with 4 envs of the v1 training config built as
`__graft_entry__._build` builds them (`:15-33`: 2 steps per env, 2
minibatches, 1 epoch, the horse-stance pose clip), starts them from rank 0's
weights, runs one `train_iteration` and prints `reward/step` from rank 0.
On `cuda` the ranks take one card each, or share the cards when there are
more ranks than cards (`parallel/mesh.py::backend_for`: `nccl` or `gloo`);
`device=cpu` runs `gloo` ranks on the CPU.

    python -m pbhc_tpu_torch.parallel.dryrun [n] [device=cpu]      (default 8, cuda)
"""
from __future__ import annotations

import sys

ENVS_PER_RANK = 4
SELECTIONS = ["exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking", "rewards=motion_tracking",
              "domain_rand=main", "simulator=tpu"]


def _build(num_envs, shard, device="cuda", motion_file="assets/motions/Horse-stance_pose.pkl"):
    from pbhc_tpu_torch.agents.mh_ppo import MHPPO
    from pbhc_tpu_torch.config.loader import compose
    from pbhc_tpu_torch.envs.tracking_env import MotionTrackingEnv

    cfg = compose(SELECTIONS, [f"num_envs={num_envs}", f"robot.motion.motion_file={motion_file}",
                               "algo.config.num_steps_per_env=2", "algo.config.num_mini_batches=2",
                               "algo.config.num_learning_epochs=1", f"device={device}"])
    env = MotionTrackingEnv(cfg, shard.local_envs, device=device, seed=0, shard=shard)
    return env, MHPPO(cfg, env)


def _rank(n_devices, device):
    from pbhc_tpu_torch.eval.batch_eval import set_precision
    from pbhc_tpu_torch.parallel.mesh import make_mesh, rank_device, shard_train_state

    set_precision()
    shard = make_mesh(ENVS_PER_RANK * n_devices, device)
    env, algo = _build(shard.num_envs, shard, str(rank_device(device)))
    ts = shard_train_state(algo.init_train_state(), shard)
    ts, log = algo.train_iteration(ts)
    return float(log["Train/mean_step_reward"])


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout: float = 600.0) -> float:
    """One training iteration sharded over `n_devices` ranks on `device`;
    prints and returns rank 0's `reward/step`."""
    from pbhc_tpu_torch.parallel.mesh import backend_for, run_ranks

    backend = backend_for(device, n_devices)
    reward = run_ranks(_rank, n_devices, (n_devices, device), backend=backend, timeout=timeout, threads=1)[0]
    print(f"dryrun_multichip({n_devices}, {device}, {backend}): OK — reward/step={reward:.4f}")
    return reward


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("device=")]
    dev = [a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("device=")]
    dryrun_multichip(int(args[0]) if args else 8, dev[-1] if dev else "cuda")
