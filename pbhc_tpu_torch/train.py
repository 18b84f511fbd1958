"""Training CLI (counterpart of `pbhc_tpu/train.py`).

Usage (any selection of the config groups; these are the sets with a committed
snapshot of their composition, `config/loader.py::COMPOSED`):
    # KungfuBot v1 (MHPPO on MotionTrackingEnv); add terrain=locomotion for the
    # heightfield curriculum terrain
    python -m pbhc_tpu_torch.train exp=motion_tracking robot=g1_23dof \\
        obs=motion_tracking rewards=motion_tracking domain_rand=main simulator=tpu \\
        [terrain=locomotion] num_envs=4096 robot.motion.motion_file=assets/motions/Horse-stance_punch.pkl \\
        algo.config.num_learning_iterations=<n> [simulator.config.solver=pallas] [device=cpu]
    # KungfuBot2 teacher (PPOMimic on GeneralTrackingEnv; robot=g1_29dof for 29 DoF)
    python -m pbhc_tpu_torch.train exp=general_tracking robot=g1_23dof_student \\
        obs=general_tracking_teacher rewards=general_tracking domain_rand=main simulator=tpu \\
        num_envs=2048 robot.motion.motion_file=assets/motions/g1_ue_walk_23dof.pkl
    # KungfuBot2 student, distilled from a teacher checkpoint
    python -m pbhc_tpu_torch.train exp=general_tracking robot=g1_23dof_student \\
        obs=general_tracking_student ... \\
        algo.config.teacher_model_path=<teacher model_<it>.pkl> algo.config.dagger_only=true

It runs on the first CUDA card unless `device=` names another device. It
writes a run directory `<base_dir>/<project_name>/<time>-<experiment>-<task>/`
holding the composed config as `config.json` (which the port's evaluation
reads) and as `config.yaml` (which `pbhc_tpu`'s evaluation reads), the
console output tee'd into `train.log`, the logged scalars as JSON lines in
`scalars.jsonl` and, where `torch.utils.tensorboard` imports, as a
TensorBoard event file with the JAX CLI's tags and steps (every logged key
and `Perf/total_fps` at iteration it + 1, `pbhc_tpu/train.py:287-290`), and
the checkpoints `ckpt/model_<it>.pkl` (flax-layout params, which `pbhc_tpu`
loads too, plus the optimizer state), saved every `save_interval`
iterations and at the end, each with a params-only mirror in
`<artifact_dir>/<experiment>/ckpt/` (default `artifacts/`, under pytest a
temporary directory), of which the newest 2 are kept.

Resume: `checkpoint=<model_<it>.pkl>` restores params, optimizer state, lr
and iteration (`algo.config.load_optimizer=false`, or a params-only pickle,
starts a fresh optimizer); `auto_load_latest=true` picks the newest
checkpoint of this experiment under `<base_dir>/<project_name>`, else the
newest mirror; `total_iterations=<n>` runs up to iteration n in all.

Env-axis data parallelism (`parallel/mesh.py`; JAX's auto-sharding,
`pbhc_tpu/train.py:230-239`): under a process group that `torchrun` started
(`torchrun --nproc_per_node=<gpus> -m pbhc_tpu_torch.train ...`) or a caller
initialised, each rank trains `num_envs / world` envs on its own card (ranks
beyond the card count share cards); with more than one GPU visible, no group
and `multichip` true (the default), the CLI spawns one rank per GPU itself.
The ranks start from rank 0's weights, reduce every env and sample mean over
all of them, and check after each iteration that their replicated state is
bit-identical. Rank 0 alone writes the run directory and prints; its
checkpoints have the one-rank layout. `fps` counts every rank's env-steps.

`use_wandb=true` starts wandb with `sync_tensorboard` (project, group,
entity and id from the `wandb` group, `opt=wandb`) as the JAX CLI does
(`pbhc_tpu/train.py:214-228`); where wandb is missing or does not start, it
prints the JAX CLI's line `[train] use_wandb=true but wandb unavailable
(...); TB only` and trains on. Neither wandb nor TensorBoard is on the card's
machine: there the run logs `scalars.jsonl` alone.

Not ported: the hung-device watchdog (a remote-TPU guard).
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

from pbhc_tpu_torch.agents.mh_ppo import MHPPO
from pbhc_tpu_torch.agents.ppo_mimic import PPOMimic, add_teacher_obs_groups, load_teacher
from pbhc_tpu_torch.config.loader import compose, parse_cli, snapshot_for_checkpoint, to_yaml
from pbhc_tpu_torch.eval.batch_eval import ENV_TARGET, ENVS, GENERAL_ENV_TARGET, set_precision
from pbhc_tpu_torch.parallel.mesh import (EnvShard, backend_for, check_replicas, make_mesh, rank_device,
                                          run_ranks, shard_train_state)
from pbhc_tpu_torch.utils.checkpoint import (latest_checkpoint, load_checkpoint_payload,
                                             restore_train_state, save_artifact, save_checkpoint)

ALGO_TARGET = "pbhc_tpu.agents.mh_ppo.MHPPO"
MIMIC_ALGO_TARGET = "pbhc_tpu.agents.ppo_mimic.PPOMimic"
ALGOS = {(ENV_TARGET, ALGO_TARGET): MHPPO, (GENERAL_ENV_TARGET, MIMIC_ALGO_TARGET): PPOMimic}
REPO = Path(__file__).resolve().parent.parent


def load_teacher_config(ckpt_path):
    """The teacher run's config (`pbhc_tpu/train.py:307`): its run directory's
    `config.json`, else the committed snapshot named after it."""
    return snapshot_for_checkpoint(ckpt_path)


def build(cfg, shard: EnvShard | None = None):
    """(env, algo, train state) for a composed config, on `cfg.device`
    (default cuda), in float32 with TF32 off; with a `shard` of a data-parallel
    run, the rank's envs on the rank's card. A distillation config gains the
    teacher's obs groups (in place) and its frozen teacher."""
    set_precision()
    algo_cls = ALGOS.get((cfg.env.target, cfg.algo.target))
    if algo_cls is None:
        raise NotImplementedError(f"{cfg.env.target} with {cfg.algo.target} is not ported")
    seed, device = int(cfg.seed), cfg.get("device", "cuda")
    shard = EnvShard(int(cfg.num_envs)) if shard is None else shard
    if shard.distributed:
        device = rank_device(device, shard.rank)
    teacher_path = cfg.algo.config.get("teacher_model_path")
    if teacher_path and algo_cls is not PPOMimic:
        raise ValueError("teacher_model_path is a PPOMimic option")
    teacher_cfg = load_teacher_config(teacher_path) if teacher_path else None
    if teacher_cfg is not None:
        add_teacher_obs_groups(cfg, teacher_cfg)
    env = ENVS[cfg.env.target](cfg, shard.local_envs, device=device, seed=seed, shard=shard)
    if algo_cls is MHPPO:
        algo = MHPPO(cfg, env, seed=seed)
    else:
        teacher = load_teacher(teacher_path, teacher_cfg, env) if teacher_path else None
        algo = PPOMimic(cfg, env, teacher=teacher, seed=seed)
    return env, algo, algo.init_train_state()


def resolve_artifact_dir(cfg) -> Path:
    """Where the run's params-only mirror goes (`pbhc_tpu/train.py:373`):
    `<artifact_dir>/<experiment>`; without `artifact_dir`, `artifacts/` of
    the source tree, or under pytest a temporary directory."""
    if cfg.get("artifact_dir"):
        base = Path(cfg.artifact_dir)
    elif os.environ.get("PYTEST_CURRENT_TEST"):
        base = Path(tempfile.gettempdir()) / "pbhc_pytest_artifacts"
    else:
        base = REPO / "artifacts"
    return base / str(cfg.experiment_name)


class _Tee:
    """Write to a stream and a logfile (`pbhc_tpu/train.py:83`)."""

    def __init__(self, stream, f):
        self._stream, self._f = stream, f

    def write(self, s):
        self._stream.write(s)
        self._f.write(s)
        return len(s)

    def flush(self):
        self._stream.flush()
        self._f.flush()

    def __getattr__(self, name):
        return getattr(self._stream, name)


@contextlib.contextmanager
def _tee(path):
    """stdout and stderr also into `path` while the block runs."""
    out, err = sys.stdout, sys.stderr
    with open(path, "a", buffering=1) as f:
        sys.stdout, sys.stderr = _Tee(out, f), _Tee(err, f)
        try:
            yield
        finally:
            sys.stdout, sys.stderr = out, err


def _summary_writer(exp_dir):
    """A TensorBoard writer on the run directory where
    `torch.utils.tensorboard` imports (`pbhc_tpu/train.py:207-212`), else None."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir=str(exp_dir))


def _wandb_run(cfg, exp_dir, say):
    """The wandb run of `use_wandb=true` (`pbhc_tpu/train.py:214-228`), or
    None: without the option, or, with JAX's line, where wandb is missing or
    does not start (a machine without network)."""
    if not bool(cfg.get("use_wandb", False)):
        return None
    try:
        import wandb

        wcfg = dict(cfg.get("wandb", {}))
        return wandb.init(project=wcfg.get("wandb_project", "PBHC_TPU"), group=wcfg.get("wandb_group"),
                          entity=wcfg.get("wandb_entity"), id=wcfg.get("wandb_id"), dir=str(exp_dir),
                          sync_tensorboard=True, config=dict(cfg))
    except Exception as e:  # as JAX: any failure to start degrades to TensorBoard alone
        say(f"[train] use_wandb=true but wandb unavailable ({e}); TB only")
        return None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _resume(cfg, algo, ts, art_dir, say=print):
    ckpt_path = cfg.get("checkpoint")
    if not ckpt_path and cfg.get("auto_load_latest"):
        ckpt_path = (latest_checkpoint(Path(cfg.base_dir) / cfg.project_name, str(cfg.experiment_name))
                     or latest_checkpoint(art_dir))
        if ckpt_path:
            say(f"[train] auto_load_latest -> {ckpt_path}")
    if ckpt_path:
        payload = load_checkpoint_payload(ckpt_path)
        restore_train_state(ts, payload, bool(cfg.algo.config.get("load_optimizer", True)))
        say(f"[train] resumed from {ckpt_path} at iteration {ts.iteration}")
    return ts


def spawn_world(cfg) -> int:
    """How many ranks the CLI spawns itself (`pbhc_tpu/train.py:230-232`):
    one per visible GPU when more than one is visible, the run is on `cuda`
    and `multichip` is true, unless a process group is there to join
    (a caller's, or `torchrun`'s); else 0."""
    import torch.distributed as dist

    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        return 0
    on_cuda = torch.device(cfg.get("device", "cuda")).type == "cuda"
    n = torch.cuda.device_count() if on_cuda else 0
    return n if n > 1 and bool(cfg.get("multichip", True)) else 0


def _rank_main(argv):
    return main(argv)[2]


def main(argv=None):
    """Returns the algorithm, the final train state and the log of every
    printed iteration (with its fps and its rollout and update seconds). When
    it spawns the ranks itself, returns (None, None, rank 0's log)."""
    argv = sys.argv[1:] if argv is None else argv
    sels, ovs = parse_cli(argv)
    cfg = compose(sels, ovs)
    world = spawn_world(cfg)
    if world:
        print(f"[train] {world} GPUs visible: spawning one rank each (env-axis data parallelism)")
        return None, None, run_ranks(_rank_main, world, (argv,), backend=backend_for("cuda", world),
                                     timeout=None)[0]
    shard = make_mesh(int(cfg.num_envs), cfg.get("device", "cuda"))
    if shard.rank != 0:
        return _run(cfg, shard, None, None, None)

    timestamp = time.strftime("%Y%m%d_%H%M%S")
    exp_dir = (Path(cfg.base_dir) / cfg.project_name
               / f"{timestamp}-{cfg.experiment_name}-{cfg.get('log_task_name', 'task')}")
    exp_dir.mkdir(parents=True, exist_ok=True)
    config_json, config_yaml = json.dumps(cfg, indent=1), to_yaml(cfg)
    (exp_dir / "config.json").write_text(config_json)
    (exp_dir / "config.yaml").write_text(config_yaml)
    with _tee(exp_dir / "train.log"):
        return _run(cfg, shard, exp_dir, config_json, config_yaml)


def _run(cfg, shard, exp_dir, config_json, config_yaml):
    """The training loop; `exp_dir` None on the ranks after the first, which
    write and print nothing."""
    say = print if exp_dir is not None else (lambda *a, **k: None)
    say(f"[train] experiment dir: {exp_dir}")
    env, algo, ts = build(cfg, shard)
    dev = env.device
    say(f"[train] device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")
    art_dir = resolve_artifact_dir(cfg)
    if exp_dir is not None:
        (art_dir / "ckpt").mkdir(parents=True, exist_ok=True)
        (art_dir / "config.json").write_text(config_json)
        (art_dir / "config.yaml").write_text(config_yaml)
    ts = _resume(cfg, algo, ts, art_dir, say)
    if shard.distributed:
        ts = shard_train_state(ts, shard)
        say(f"[train] env-axis data parallelism: {shard.world} ranks x {shard.local_envs} envs "
            f"({shard.backend})")

    num_iters = int(cfg.algo.config.num_learning_iterations)
    if cfg.get("total_iterations"):   # cumulative across resumes
        num_iters = max(0, int(cfg.total_iterations) - ts.iteration)
        say(f"[train] total_iterations={cfg.total_iterations}: {num_iters} remaining")
    save_interval = int(cfg.algo.config.save_interval)
    log_interval = max(1, int(cfg.algo.config.get("logging_interval", 25)) // 5)
    steps_per_iter = shard.num_envs * algo.num_steps     # every rank's env-steps
    ckpt_dir = exp_dir / "ckpt" if exp_dir is not None else None
    logs = []

    def save():
        if exp_dir is not None:
            say(f"[train] saved {save_checkpoint(ckpt_dir, ts)}")
            save_artifact(art_dir, ts)

    t_start = time.time()
    last_log_t, last_log_it = t_start, 0
    with contextlib.ExitStack() as logs_open:
        scalars = writer = None
        if exp_dir is not None:
            scalars = logs_open.enter_context(open(exp_dir / "scalars.jsonl", "a"))
            # wandb first: its `sync_tensorboard` mirrors the writers made after it
            run = _wandb_run(cfg, exp_dir, say)
            if run is not None:
                logs_open.callback(run.finish)
            writer = _summary_writer(exp_dir)
            if writer is not None:
                logs_open.callback(writer.close)
        for it in range(num_iters):
            t0 = time.time()
            if it == 2:
                # as the JAX CLI does: iterations 0 and 1 (there: compiles; here:
                # kernel builds and library warm-up) stay out of the fps windows
                last_log_t, last_log_it = t0, 2
            log_now = (it + 1) % log_interval == 0 or it == 0
            rollout = algo.rollout(ts)
            if log_now:
                # rollout seconds: from the iteration's start on the host to the
                # rollout's end on the device (earlier unsynchronised iterations'
                # device work included)
                _sync(dev)
                t_mid = time.time()
            ts, log = algo.learn(ts, rollout)
            save_now = (it + 1) % save_interval == 0 and it + 1 < num_iters
            # the ranks' weights, moments and lr must stay bit-identical: checked
            # where the loop synchronises anyway (logs, saves, the end)
            checksum = (check_replicas(ts, shard) if shard.distributed
                        and (log_now or save_now or it + 1 == num_iters) else None)
            if it == 0:
                _sync(dev)
                say(f"[train] first iteration (incl. kernel builds): {time.time() - t0:.1f}s")
            if log_now:
                log = {k: float(v) for k, v in log.items()}      # waits for the whole window
                now = time.time()
                window_iters = 1 if it == 0 else (it + 1 - last_log_it)
                fps = steps_per_iter * window_iters / (now - last_log_t)
                last_log_t, last_log_it = now, it + 1
                logs.append(dict(log, iteration=ts.iteration, fps=fps, rollout_s=t_mid - t0,
                                 update_s=now - t_mid, **({} if checksum is None else {"replica_checksum": checksum})))
                if scalars is not None:
                    scalars.write(json.dumps({"iteration": ts.iteration, **log, "Perf/total_fps": fps}) + "\n")
                    scalars.flush()
                if writer is not None:
                    for k, v in log.items():
                        writer.add_scalar(k, v, it + 1)
                    writer.add_scalar("Perf/total_fps", fps, it + 1)
                terr = (f" terrain_level_mean={log['Env/terrain_level_mean']:.2f}"
                        f"/max={log['Env/terrain_level_max']:.0f}"
                        if "Env/terrain_level_mean" in log else "")
                say(f"[it {it + 1}/{num_iters}] rew/step={log['Train/mean_step_reward']:.4f} "
                    f"epl={log['Env/episode_length_mean']:.1f} kl={log['Loss/kl']:.4f} "
                    f"lr={log['Loss/lr']:.2e} fps={fps:,.0f}{terr} "
                    f"rollout/update={t_mid - t0:.2f}/{now - t_mid:.2f}s", flush=True)
            if save_now:
                save()
    _sync(dev)
    say(f"[train] done in {time.time() - t_start:.0f}s")
    save()
    return algo, ts, logs


if __name__ == "__main__":
    main()
