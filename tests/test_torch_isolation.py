"""The port runs where only torch, numpy, scipy and the standard library are.

The machine with the card has no JAX, PyYAML, joblib, lxml, MuJoCo,
TensorBoard, wandb, matplotlib or rerun. A subprocess that blocks those
modules (and `pbhc_tpu`, and `torch.utils.tensorboard`) imports
every module of `pbhc_tpu_torch` and `chip_smoke`, builds the side-kick env
and actor on the CPU at 128 envs from the config snapshot and the checkpoint,
drives a few control steps of the serving loop, does the same for the
KungfuBot2 teacher (`GeneralTrackingEnv`, `MimicActorCritic`) at 32 envs
and for the heightfield-terrain run `terrain_walk_v3` at 16 envs, runs the
training CLI (`python -m pbhc_tpu_torch.train`) for one iteration: MHPPO at
128 envs with `use_wandb=true` (it prints the JAX CLI's line and trains with
`scalars.jsonl` alone), a KungfuBot2 student distilled from the committed teacher (its
config read from the snapshot) at 32 envs, a KungfuBot2 teacher with MoE
backbones and a phase-aware MHPPO run at 16 envs, steps the v1 env at 16
envs on the per-env engine (`pgs`; `apgd` with soft dynamic correction; the
OU observation noise and the close-to-limit terminations), steps the
simulator facade, runs the evaluation CLI (`python -m
pbhc_tpu_torch.eval_agent`) on a copy of the side-kick run with its clip cut
to 20 frames, exports the committed KungfuBot2 student through the `export
student` CLI, builds one tick of its deploy inputs (`StudentObsBuilder`) and
runs them on the native executor (`StudentPolicy(native=True)`), starts the
teleop hook of the env, checks that a MuJoCo-side constructor raises
`ImportError` there, composes a selection set that has no snapshot
(`domain_rand=off`) with an override, merges the benchmark suite's motion
library with `motion/package.py`, times config 2's rollout at 8 envs, and
runs the offline motion pipeline: the eval CLI's `save_motion=true`, the
contact-mask CLI, a short retarget fit of the side-kick's SMPL joints, and
the viewers, whose drawing libraries raise there.

`mujoco` may be imported only inside functions of the seven port modules of
the MuJoCo side (`MUJOCO_MODULES`), matplotlib and rerun only inside
functions of the viewers (`VIS_MODULES`), and wandb and
`torch.utils.tensorboard` only inside functions of the training CLI, so that
every module imports on the card's machine; a top-level import of any of
them anywhere fails the source check.
"""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "pbhc_tpu", "yaml", "joblib", "lxml", "mujoco",
           "tensorboard", "wandb", "matplotlib", "mpl_toolkits", "rerun")
# blocked modules of packages that are there (torch's TensorBoard writer)
BLOCKED_SUBMODULES = ("torch.utils.tensorboard",)
# the MuJoCo side of the deploy and eval stack: the only modules that may
# import `mujoco`, and only inside a function
MUJOCO_MODULES = {"pbhc_tpu_torch/deploy/mujoco_runtime.py", "pbhc_tpu_torch/deploy/urci.py",
                  "pbhc_tpu_torch/deploy/real_robot.py", "pbhc_tpu_torch/eval/sim2sim.py",
                  "pbhc_tpu_torch/envs/terrain.py", "pbhc_tpu_torch/sim/simulator.py",
                  "pbhc_tpu_torch/deploy/mj_mirror.py"}
# the viewers: the only modules that may import matplotlib or rerun, and only
# inside a function
VIS_MODULES = {"pbhc_tpu_torch/vis/vis_motion.py", "pbhc_tpu_torch/vis/vis_rr.py",
               "pbhc_tpu_torch/vis/vis_smpl.py"}
# the training CLI's optional loggers: the only module that may import them
TRAIN_CLI = {"pbhc_tpu_torch/train.py"}
SCOPED = {"mujoco": MUJOCO_MODULES, "matplotlib": VIS_MODULES, "mpl_toolkits": VIS_MODULES,
          "rerun": VIS_MODULES, "wandb": TRAIN_CLI, "torch.utils.tensorboard": TRAIN_CLI}

SCRIPT = textwrap.dedent("""
    import sys
    BLOCKED = {blocked!r}
    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]
    for name in BLOCKED + {blocked_sub!r}:
        sys.modules[name] = None          # any import of it raises ImportError
    sys.path.insert(0, {repo!r})

    import importlib, pkgutil
    import torch
    torch.set_num_threads(2)
    import pbhc_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(pbhc_tpu_torch.__path__, "pbhc_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke                     # import only: main() is not run

    from pbhc_tpu_torch.eval import batch_eval
    env, actor, cfg = batch_eval.load("artifacts/kb1_side_kick/ckpt/model_10500.pkl", 128, device="cpu")
    state, obs = batch_eval.start_episodes(env)
    state, first, nonfinite = batch_eval.rollout_ratio(env, actor, state, obs, 3)
    assert obs["actor_obs"].shape == (128, 380), obs["actor_obs"].shape
    assert int(state.episode_length.min()) == 3 and int(nonfinite) == 0
    assert torch.isfinite(state.sim.dof_pos).all() and torch.isfinite(state.sim.root_pos).all()
    env, actor, cfg = batch_eval.load("artifacts/kb2_teacher23_r3/ckpt/model_24000.pkl", 32, device="cpu")
    state, obs = batch_eval.start_episodes(env)
    state, first, nonfinite = batch_eval.rollout_ratio(env, actor, state, obs, 3)
    assert obs["future_motion_targets"].shape == (32, 1140) and int(nonfinite) == 0
    env, actor, cfg = batch_eval.load("artifacts/terrain_walk_v3/ckpt/model_6500.pkl", 16, device="cpu")
    state, obs = batch_eval.start_episodes(env)
    state, first, nonfinite = batch_eval.rollout_ratio(env, actor, state, obs, 3)
    assert env.engine.terrain_hf.shape == (1300, 2100) and int(nonfinite) == 0
    assert float(state.sim.root_pos[:, 1].max()) > 150.0
    import pickle, shutil
    from pathlib import Path
    from pbhc_tpu_torch.motion.motion_lib import load_motion_dict
    run = Path("{base_dir}") / "evalrun" / "kb1_side_kick"
    (run / "ckpt").mkdir(parents=True)
    shutil.copy("artifacts/kb1_side_kick/ckpt/model_10500.pkl", run / "ckpt")
    raw = load_motion_dict("assets/motions/Side_kick.pkl")
    key = next(iter(raw))
    clip = {{k: (v[:20] if hasattr(v, "shape") else v) for k, v in raw[key].items()}}
    (run.parent / "short.pkl").write_bytes(pickle.dumps({{key: clip}}))
    import runpy
    sys.argv = ["pbhc_tpu_torch.train", "exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking",
                "rewards=motion_tracking", "domain_rand=main", "simulator=tpu", "num_envs=128",
                "robot.motion.motion_file=assets/motions/Horse-stance_punch.pkl",
                "algo.config.num_learning_iterations=1", "device=cpu", "base_dir={base_dir}",
                "artifact_dir={base_dir}/art", "use_wandb=true"]
    runpy.run_module("pbhc_tpu_torch.train", run_name="__main__")
    sys.argv = ["pbhc_tpu_torch.train", "exp=general_tracking", "robot=g1_23dof_student",
                "obs=general_tracking_student", "rewards=general_tracking", "domain_rand=main",
                "simulator=tpu", "num_envs=32", "robot.motion.motion_file=assets/motions/g1_ue_walk_23dof.pkl",
                "algo.config.teacher_model_path=artifacts/kb2_teacher23_r3/ckpt/model_24000.pkl",
                "algo.config.dagger_only=true", "algo.config.num_steps_per_env=4",
                "algo.config.num_learning_iterations=1", "device=cpu", "base_dir={base_dir}",
                "artifact_dir={base_dir}/art", "experiment_name=student"]
    runpy.run_module("pbhc_tpu_torch.train", run_name="__main__")
    small = ["num_envs=16", "algo.config.num_steps_per_env=4", "algo.config.num_learning_iterations=1",
             "device=cpu", "base_dir={base_dir}", "artifact_dir={base_dir}/art"]
    sys.argv = ["pbhc_tpu_torch.train", "exp=general_tracking", "robot=g1_23dof_student",
                "obs=general_tracking_teacher", "rewards=general_tracking", "domain_rand=main", "simulator=tpu",
                "robot.motion.motion_file=assets/motions/g1_ue_walk_23dof.pkl", "experiment_name=moe",
                "algo.config.module_dict.actor.layer_config.type=MoEMLP",
                "algo.config.module_dict.critic.layer_config.type=MoEMLP"] + small
    runpy.run_module("pbhc_tpu_torch.train", run_name="__main__")
    v1 = ["exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking", "rewards=motion_tracking",
          "domain_rand=main", "simulator=tpu"]
    horse = "robot.motion.motion_file=assets/motions/Horse-stance_punch.pkl"
    sys.argv = ["pbhc_tpu_torch.train", *v1, horse, "experiment_name=phase",
                "algo.config.phase_embed.type=Sinusoidal"] + small
    runpy.run_module("pbhc_tpu_torch.train", run_name="__main__")
    import json
    from pbhc_tpu_torch.config.loader import compose
    from pbhc_tpu_torch.envs.tracking_env import MotionTrackingEnv
    from pbhc_tpu_torch.sim.simulator import EngineSimulator
    ou = {{"enable": True, "kwargs": {{"theta": 1.0, "sigma": 1.0}}}}
    for ovs in (["simulator.config.solver=pgs"],
                ["simulator.config.solver=apgd", "env.config.soft_dynamic_correction.enable=true"],
                ["obs.noise_process=" + json.dumps(ou),
                 "env.config.termination.terminate_when_close_to_torque_limit=true"]):
        env = MotionTrackingEnv(compose(v1, ["num_envs=16", horse] + ovs), 16, device="cpu")
        state = env.reset_to_start(env.init_state())
        obs, state.history = env.compute_observations(state)
        for _ in range(2):
            state, obs, _, _, _ = env.step(state, torch.zeros((16, env.nd)))
        assert torch.isfinite(state.sim.dof_pos).all() and torch.isfinite(obs["actor_obs"]).all()
    sim = EngineSimulator(env.engine, 2)
    sim.simulate_at_each_physics_step()
    sim.refresh_sim_tensors()
    assert sim.robot_root_states.shape == (2, 13)
    sys.argv = ["pbhc_tpu_torch.eval_agent", f"checkpoint={{run}}/ckpt/model_10500.pkl", "device=cpu",
                f"robot.motion.motion_file={{run.parent}}/short.pkl", "save_motion=true"]
    runpy.run_module("pbhc_tpu_torch.eval_agent", run_name="__main__")
    assert (run / "exported" / "model_10500.onnx").is_file() and (run / "eval_model_10500.json").is_file()
    from pbhc_tpu_torch.motion.motion_lib import load_joblib
    assert load_joblib(run / "motion_model_10500.pkl")["rollout"]["dof"].shape[1] == 23
    from pbhc_tpu_torch.model.g1 import load_g1_motion_model
    from pbhc_tpu_torch.motion import retarget, tools
    tools.main(["contact_mask", "assets/motions/Side_kick.pkl", "{base_dir}/cm.pkl", "device=cpu"])
    assert load_joblib("{base_dir}/cm.pkl")[key]["contact_mask"].shape[1] == 2
    fit = retarget.retarget_smpl_joints(load_g1_motion_model(), raw[key]["smpl_joints"][:5], iters=3,
                                        device="cpu")
    assert fit["dof"].shape == (5, 23)
    from pbhc_tpu_torch.vis import vis_motion, vis_rr
    for draw in (lambda: vis_motion.render_motion("assets/motions/Side_kick.pkl", "{base_dir}/m.gif",
                                                  max_frames=2, device="cpu"),
                 lambda: vis_rr.stream_motion("assets/motions/Side_kick.pkl", device="cpu")):
        try:
            draw()
            raise AssertionError("a viewer drew without its drawing library")
        except (ImportError, SystemExit):
            pass
    import numpy as np
    from pbhc_tpu_torch.deploy import export
    from pbhc_tpu_torch.deploy.student_obs import MotionHost, StudentObsBuilder
    from pbhc_tpu_torch.maths import rotations as rot
    student = "artifacts/kb2_student23_r3/ckpt/model_8000.pkl"
    onnx = export.main(["student", student, "{base_dir}/student/student.onnx", "device=cpu"])
    assert onnx.is_file() and (onnx.parent / "student.onnx.meta.json").is_file()
    env, net, cfg = batch_eval.load(student, 1, device="cpu")
    state, obs = batch_eval.start_episodes(env)
    sim = state.sim
    class Robot:
        q, dq, quat_xyzw = sim.dof_pos[0].numpy(), sim.dof_vel[0].numpy(), sim.root_quat[0].numpy()
        base_ang_vel_local = rot.quat_rotate_inverse(sim.root_quat, sim.root_ang_vel)[0].numpy()
        last_action = state.actions[0].numpy()
    feeds = StudentObsBuilder(export.student_meta(env), MotionHost(env.motion_lib),
                              compensate_offsets=False).build(Robot, 0.0)
    assert {{k: v.shape for k, v in feeds.items()}} == {{k: tuple(obs[k].shape) for k in feeds}}
    action = export.StudentPolicy(onnx, native=True)(feeds)
    assert action.shape == (23,) and np.isfinite(action).all()
    env, actor, cfg = batch_eval.load("artifacts/kb1_side_kick/ckpt/model_10500.pkl", 2,
                                      ["env.config.use_teleop_control=true", "env.config.teleop_port=0"],
                                      device="cpu")
    assert env.teleop_marker_coords.shape == (2, 3, 3) and env.teleop_source.addr[1] > 0
    env.close()
    from pbhc_tpu_torch.sim.simulator import MujocoSimulator
    try:
        MujocoSimulator("assets/robots/g1/g1_23dof_lock_wrist.xml")
        raise AssertionError("MujocoSimulator built without mujoco")
    except ImportError:
        pass
    from pbhc_tpu_torch.eval import benchmarks
    from pbhc_tpu_torch.motion import package
    cfg = compose([s if not s.startswith("domain_rand=") else "domain_rand=off" for s in v1],
                  ["obs.history_length=3"])
    assert cfg.domain_rand.randomize_friction is False
    lib = package.merge("{base_dir}/lib.pkl", [benchmarks.POSE, benchmarks.PUNCH, benchmarks.KICK])
    assert [r[1] for r in package.info(lib)] == [210, 200, 179]
    eps, env, detail = benchmarks._env_throughput(
        benchmarks.V1, ["robot.motion.motion_file=" + benchmarks.WALK], 8, 2, "cpu")
    assert eps > 0 and all(np.isfinite(detail["reward_sums"]))
    leaked = [n for n, m in sys.modules.items() if m is not None and (
        n.split(".")[0] in BLOCKED or n.startswith({blocked_sub!r}))]
    assert not leaked, leaked
    print("modules", len(names), "ISOLATION OK")
""")


def test_port_runs_without_jax_yaml_joblib_lxml(tmp_path):
    script = SCRIPT.format(blocked=BLOCKED, blocked_sub=BLOCKED_SUBMODULES, repo=str(REPO), base_dir=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ISOLATION OK" in out.stdout
    assert out.stdout.count("[it 1/1]") == 4 and len(list(tmp_path.glob("PBHC_TPU/*/ckpt/model_1.pkl"))) == 4
    assert out.stdout.count("[train] use_wandb=true but wandb unavailable (") == 1
    assert not list(tmp_path.glob("PBHC_TPU/*/events.out.tfevents.*"))


def _imports(path):
    """(module, inside a function) for every absolute import of `path`: the
    imported module's dotted name, for `from m import n` m.n."""
    out = []

    def visit(node, in_function):
        if isinstance(node, ast.Import):
            out.extend((a.name, in_function) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.extend((f"{node.module}.{a.name}", in_function) for a in node.names)
        in_function = in_function or isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
        for child in ast.iter_child_nodes(node):
            visit(child, in_function)

    visit(ast.parse(path.read_text()), False)
    return out


def _scope(name):
    """The key of SCOPED that the module `name` falls under, or None."""
    return next((k for k in SCOPED if name == k or name.startswith(k + ".")), None)


def test_no_forbidden_import_in_sources():
    files = sorted((REPO / "pbhc_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    scoped_in = {key: set() for key in SCOPED}
    for f in files:
        rel = f.relative_to(REPO).as_posix()
        for name, in_function in _imports(f):
            scope = _scope(name)
            if scope is None:
                assert name.split(".")[0] not in BLOCKED, f"{rel} imports {name}"
                continue
            assert rel in SCOPED[scope], f"{rel} imports {name}: only {sorted(SCOPED[scope])} may"
            assert in_function, f"{rel} imports {name} at module level: import it inside the function"
            scoped_in[scope].add(rel)
    # the scoping is not vacuous: the runtimes that build MuJoCo models import
    # it, the viewers their drawing libraries, the training CLI its loggers
    assert {"pbhc_tpu_torch/deploy/mujoco_runtime.py", "pbhc_tpu_torch/deploy/mj_mirror.py",
            "pbhc_tpu_torch/sim/simulator.py"} <= scoped_in["mujoco"]
    assert scoped_in["matplotlib"] == {"pbhc_tpu_torch/vis/vis_motion.py", "pbhc_tpu_torch/vis/vis_smpl.py"}
    assert scoped_in["rerun"] == {"pbhc_tpu_torch/vis/vis_rr.py"}
    assert scoped_in["wandb"] == scoped_in["torch.utils.tensorboard"] == TRAIN_CLI
