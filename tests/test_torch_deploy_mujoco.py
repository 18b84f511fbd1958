"""Port parity: the MuJoCo side of the deploy and eval stack (the MuJoCo
deploy runtime, URCI, the real-robot controller over the loopback
transport, sim2sim scoring and `eval_agent sim2sim=true`, the fleet mirror,
the MuJoCo simulator facade and the terrain's MuJoCo writers), against
`pbhc_tpu` on the CPU. Skipped where MuJoCo is not installed.

Both packages run on the same exports (the side-kick checkpoint's `.npz`
written by the port, the JAX package's bytes; the committed student's
ONNX), the same clips cut short (so the file stays well under its time
budget), and the same numpy seeds for the attack noise. The JAX controller
runs its numpy executors (its native libraries are built next to their
sources on first use, and this file leaves them untouched); the port's runs
its native cores.

Tolerances: MuJoCo trajectories and controller observations 1e-4 (MuJoCo is
deterministic; the two packages feed it actions that differ by the
executors' float32 rounding, ~1e-6, and reference states from two FK
implementations, ~1e-6); the policy-id sequence exactly; the sim2sim
families 1e-3 relative (tests/test_torch_eval.py's bound for families of a
short rollout); the fleet mirror's read-back 1e-6 (float32 inputs through
the same float64 MuJoCo state; the angular velocity rotated in float32,
1e-5); the simulator facade exactly (the same MuJoCo calls); the terrain
writers byte for byte.
"""
import dataclasses
import json
import pickle
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(2)
mujoco = pytest.importorskip("mujoco")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pbhc_tpu.config.loader import compose as jax_compose  # noqa: E402
from pbhc_tpu.deploy import mj_mirror as jax_mirror  # noqa: E402
from pbhc_tpu.deploy import mujoco_runtime as jax_runtime  # noqa: E402
from pbhc_tpu.deploy import real_robot as jax_real  # noqa: E402
from pbhc_tpu.deploy import urci as jax_urci  # noqa: E402
from pbhc_tpu.deploy.onnx_numpy import OnnxPolicy as JaxOnnxPolicy  # noqa: E402
from pbhc_tpu.deploy.onnx_numpy import meta_from_reference_config as jax_meta_from_config  # noqa: E402
from pbhc_tpu.envs import terrain as jax_terrain  # noqa: E402
from pbhc_tpu.envs.tracking_env import MotionTrackingEnv as JaxEnv  # noqa: E402
from pbhc_tpu.eval import sim2sim as jax_sim2sim  # noqa: E402
from pbhc_tpu.sim.simulator import MujocoSimulator as JaxMujocoSimulator  # noqa: E402
from pbhc_tpu_torch import eval_agent  # noqa: E402
from pbhc_tpu_torch.config.loader import compose, snapshot_for_checkpoint  # noqa: E402
from pbhc_tpu_torch.deploy import export, mj_mirror, mujoco_runtime, real_robot, urci  # noqa: E402
from pbhc_tpu_torch.deploy.native.onnx_exec import NativeOnnxPolicy  # noqa: E402
from pbhc_tpu_torch.deploy.onnx_numpy import meta_from_reference_config  # noqa: E402
from pbhc_tpu_torch.envs import terrain  # noqa: E402
from pbhc_tpu_torch.envs.tracking_env import MotionTrackingEnv  # noqa: E402
from pbhc_tpu_torch.eval import batch_eval, sim2sim  # noqa: E402
from pbhc_tpu_torch.model.g1 import g1_asset_root  # noqa: E402
from pbhc_tpu_torch.motion.motion_lib import load_motion_dict  # noqa: E402
from pbhc_tpu_torch.sim.simulator import MujocoSimulator  # noqa: E402
from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
RUN = "kb1_side_kick"
CKPT = REPO / "artifacts" / RUN / "ckpt" / "model_10500.pkl"
STUDENT_CKPT = "artifacts/kb2_student23_r3/ckpt/model_8000.pkl"
TERRAIN_RUN = REPO / "artifacts" / "terrain_walk_v2"
TOL = 1e-4
V1 = ["exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking", "rewards=motion_tracking",
      "domain_rand=main", "simulator=tpu"]
DR_OFF = ["domain_rand.randomize_friction=false", "domain_rand.randomize_base_mass=false",
          "domain_rand.randomize_link_mass=false", "domain_rand.randomize_pd_gain=false",
          "domain_rand.push_robots=false", "domain_rand.randomize_ctrl_delay=false",
          "domain_rand.randomize_rfi_lim=false", "domain_rand.use_rao=false",
          "domain_rand.randomize_default_dof_pos=false", "domain_rand.randomize_base_com=false",
          "domain_rand.randomize_link_inertia=false", "env.config.noise_to_initial_level=0"]


def _short_clip(path, src, frames):
    """`src` cut to its first `frames` frames, as a plain pickle both
    packages' motion readers take."""
    raw = load_motion_dict(str(REPO / src))
    key = next(iter(raw))
    clip = {k: (v[:frames] if isinstance(v, np.ndarray) else v) for k, v in raw[key].items()}
    path.write_bytes(pickle.dumps({key: clip}))
    return str(path)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    d = tmp_path_factory.mktemp("deploy_mujoco")
    env, actor, cfg = batch_eval.load(CKPT, 1, device="cpu")
    npz = export.export_policy(actor, load_checkpoint_payload(CKPT)["actor_params"], env, d / "model_10500.npz",
                               meta_extra={"motion_file": str(cfg.robot.motion.motion_file)})
    return SimpleNamespace(dir=d, npz=str(npz),
                           kick20=_short_clip(d / "kick20.pkl", "assets/motions/Side_kick.pkl", 20),
                           kick40=_short_clip(d / "kick40.pkl", "assets/motions/Side_kick.pkl", 40),
                           walk40=_short_clip(d / "walk40.pkl", "assets/motions/g1_ue_walk_23dof.pkl", 40))


@pytest.fixture
def jax_numpy_executors(monkeypatch):
    """The JAX controller's numpy fallback in place of its native cores."""
    import pbhc_tpu.deploy.native as jax_native
    import pbhc_tpu.deploy.native.onnx_exec as jax_onnx_exec

    def refuse(*a, **k):
        raise RuntimeError("the JAX package's native cores are not built by this test")

    monkeypatch.setattr(jax_native, "NativePolicy", refuse)
    monkeypatch.setattr(jax_onnx_exec, "NativeOnnxPolicy", refuse)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), atol=tol, err_msg=what)


def test_deploy_robot_rollout_matches_jax(exports):
    port = mujoco_runtime.MujocoDeployRobot(exports.npz, exports.kick40)
    jx = jax_runtime.MujocoDeployRobot(exports.npz, exports.kick40)
    tp, tj = port.rollout(50), jx.rollout(50)
    assert sorted(tp) == sorted(tj) and tp["dof_pos"].shape == (50, 23)
    for k in tp:
        _close(tp[k], tj[k], what=k)
    _close(port.d.qpos, jx.d.qpos, what="qpos")
    _close(port.d.qvel, jx.d.qvel, what="qvel")
    assert np.isfinite(port.d.qpos).all() and port.obs_builder.hist_spec == jx.obs_builder.hist_spec


def test_urci_routing_matches_jax(exports):
    """Two policies routed over a 20-frame clip (0.63 s, 32 control steps)
    with OU IMU noise, a 10 ms action delay and the radial joint-velocity
    attack, from the same numpy seed: the same trajectory and the same
    policy switch."""
    trajs, robots = [], []
    for mod in (urci, jax_urci):
        np.random.seed(7)
        robot = mod.URCIRobot([exports.npz, exports.npz], motion_file=exports.kick20,
                              attack=mod.AttackConfig(imu="OU", action_delay_ms=10, dq_radial=True))
        trajs.append(robot.routing(total_steps=45))
        robot.switch_policy(1)
        robot.control_step()
        robots.append(robot)
    tp, tj = trajs
    np.testing.assert_array_equal(tp["pid"], tj["pid"])
    assert set(tp["pid"].tolist()) == {0, 1} and robots[0].cur_pid == 1 and robots[0]._blend == 0.1
    for k in tp:
        _close(tp[k], tj[k], what=k)
    _close(robots[0].d.qpos, robots[1].d.qpos, what="qpos after the switch")
    for group, steps in (("external", 10), ("single", 5)):
        traj = urci.main([exports.npz, f"deploy={group}", f"steps={steps}", f"motion_file={exports.kick20}"])
        assert len(traj["pid"]) == steps and np.isfinite(traj["root_pos"]).all()


def test_load_policy_on_the_committed_terrain_onnx(tmp_path):
    """`_load_policy` runs the committed ONNX on the native executor with the
    run's own metadata; its actions equal JAX's numpy executor's with the
    metadata JAX derives from the same config in the reference's format."""
    onnx = TERRAIN_RUN / "exported" / "model_6000.onnx"
    pol = urci._load_policy(str(onnx), "m.pkl")
    assert isinstance(pol, NativeOnnxPolicy)
    assert pol.meta == meta_from_reference_config(TERRAIN_RUN, "m.pkl")
    cfg = yaml.safe_load((TERRAIN_RUN / "config.yaml").read_text())
    cfg["robot"]["dof_names"] = pol.meta["dof_names"]
    cfg["obs"]["obs_dims"] = [{k: v} for k, v in cfg["obs"]["obs_dims"].items()]
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(cfg))
    jmeta = jax_meta_from_config(tmp_path / "config.yaml", "m.pkl")
    assert jmeta == pol.meta
    obs = np.random.default_rng(4).standard_normal((3, 380)).astype(np.float32)
    _close(np.stack([pol(o) for o in obs]), JaxOnnxPolicy(onnx, jmeta)(obs), tol=2e-5)


def test_real_robot_controller_matches_jax(exports, jax_numpy_executors):
    """The state machine of tests/test_real_robot.py over the loopback
    transport, side by side: the same modes at every tick, the same policy
    observations and the same MuJoCo state."""
    runs = []
    for rt, ctrl_mod in ((mujoco_runtime, real_robot), (jax_runtime, jax_real)):
        sim = rt.MujocoDeployRobot(exports.npz, exports.kick40)
        sim.reset()
        ctrl = ctrl_mod.RealRobotController(exports.npz, ctrl_mod.LoopbackTransport(sim))
        modes = []
        for _ in range(3):
            ctrl.step()
            modes.append(ctrl.mode)
        ctrl.request_policy()
        for _ in range(ctrl.move_steps + 1):
            ctrl.step()
            modes.append(ctrl.mode)
        ctrl.request_policy()
        for _ in range(5):
            ctrl.step()
            modes.append(ctrl.mode)
        runs.append((ctrl, sim, modes))
    (pc, ps, pm), (jc, js, jm) = runs
    assert type(pc.policy).__name__ == "NativePolicy" and type(jc.policy).__name__ == "NumpyPolicy"
    assert pm == jm and pm[-1] == pc.POLICY and pm[3 + pc.move_steps - 1] == pc.DEFAULT_POSE
    assert len(pc.obs_log) == len(jc.obs_log) == 5
    for a, b in zip(pc.obs_log, jc.obs_log):
        _close(a, b, what="obs_log")
    _close(ps.d.qpos, js.d.qpos, what="qpos")
    _close(ps.d.qvel, js.d.qvel, what="qvel")


def test_remote_decode_deploy_map_and_config(tmp_path):
    import struct

    blob = bytearray(40)
    blob[2:4] = struct.pack("<H", (1 << real_robot.KeyMap.start) | (1 << real_robot.KeyMap.A)
                            | (1 << real_robot.KeyMap.left))
    for off, v in ((4, 0.25), (8, -0.5), (12, 0.75), (20, -1.0)):
        blob[off:off + 4] = struct.pack("<f", v)
    port, jx = real_robot.RemoteController(), jax_real.RemoteController()
    port.set(blob)
    jx.set(blob)
    assert port.button == jx.button and (port.lx, port.rx, port.ry, port.ly) == (jx.lx, jx.rx, jx.ry, jx.ly)
    assert port.button[real_robot.KeyMap.start] == 1 and port.button[real_robot.KeyMap.B] == 0
    m = real_robot.G1DeployMap()
    assert dataclasses.asdict(m) == dataclasses.asdict(jax_real.G1DeployMap())
    assert set(m.policy2motor) | set(m.held_motor_idx) == set(range(m.num_motors))
    # `main` reads the JSON config; without the Unitree SDK the transport refuses
    cfg = REPO / "pbhc_tpu_torch" / "config" / "groups" / "deploy" / "real_g1_23.json"
    with pytest.raises(ImportError, match="unitree_sdk2py"):
        real_robot.main(["lo", str(cfg)])
    assert real_robot.main(["lo"]) == 1


def _families_close(got, want, rel=1e-3):
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= rel * max(abs(want[k]), 1e-9), (k, got[k], want[k])


def test_eval_agent_sim2sim_matches_jax(tmp_path, exports):
    """`eval_agent sim2sim=true` on a copy of the side-kick run with the clip
    cut to 40 frames: its `sim2sim` block equals what the JAX `eval_agent`
    writes there, `pbhc_tpu.eval.sim2sim.rollout_metrics` on the same
    export, clip, robot and `fix_height`."""
    run = tmp_path / RUN
    (run / "ckpt").mkdir(parents=True)
    shutil.copy(CKPT, run / "ckpt")
    res = eval_agent.main([f"checkpoint={run / 'ckpt' / CKPT.name}", "sim2sim=true", "device=cpu",
                           f"robot.motion.motion_file={exports.kick40}"])
    written = json.loads((run / f"eval_{CKPT.stem}.json").read_text())
    assert written["sim2sim"] == res["sim2sim"] and written["sim2sim_final_z"] == res["sim2sim"]["final_z"]
    cfg = snapshot_for_checkpoint(CKPT)
    want = jax_sim2sim.rollout_metrics(run / "exported" / f"{CKPT.stem}.npz", exports.kick40,
                                       robot_type=str(cfg["robot"]["robot_type"]),
                                       fix_height=str(cfg["robot"]["motion"].get("fix_height", "no_fix")))
    got = res["sim2sim"]
    assert got["steps"] == want["steps"] == 65
    assert abs(got["final_z"] - want["final_z"]) <= TOL
    _families_close(got["accuracy"], want["accuracy"])
    _families_close(got["smoothness"], want["smoothness"])


def test_student_rollout_metrics_matches_jax(exports, jax_numpy_executors):
    """The student export through the real-robot controller in MuJoCo, on the
    walk clip cut to 40 frames: the port's native executor and builder
    against JAX's numpy ones."""
    onnx = export.main(["student", STUDENT_CKPT, str(exports.dir / "student.onnx"), "device=cpu"])
    got = sim2sim.student_rollout_metrics(onnx, motion_file=exports.walk40, device="cpu")
    want = jax_sim2sim.student_rollout_metrics(onnx, motion_file=exports.walk40)
    assert got["steps"] == want["steps"] == 64
    assert abs(got["final_z"] - want["final_z"]) <= TOL
    _families_close(got["accuracy"], want["accuracy"])
    _families_close(got["smoothness"], want["smoothness"])


@pytest.fixture(scope="module")
def fleet_envs():
    motion = [f"robot.motion.motion_file={REPO / 'assets/motions/Horse-stance_pose.pkl'}"]
    jenv = JaxEnv(jax_compose(str(REPO / "pbhc_tpu" / "config"), V1, ["num_envs=2"] + motion + DR_OFF), 2,
                  jax.random.PRNGKey(0))
    tenv = MotionTrackingEnv(compose(V1, ["num_envs=2"] + motion + DR_OFF), 2, device="cpu")
    return jenv, tenv


def test_mj_fleet_matches_jax(fleet_envs):
    """`set_from` -> `read_batch` -> `inject`, from the port's engine state and
    from JAX's holding the same values (a twisted root, so that the frame
    conventions matter), then one PD tick."""
    jenv, tenv = fleet_envs
    js = jenv.reset_to_start(jenv.init_state(jax.random.PRNGKey(1)), jax.random.PRNGKey(2)).sim
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    vals = {"root_pos": np.asarray(js.root_pos), "root_quat": q, "dof_pos": np.asarray(js.dof_pos),
            "root_lin_vel": rng.standard_normal((2, 3)).astype(np.float32),
            "root_ang_vel": rng.standard_normal((2, 3)).astype(np.float32),
            "dof_vel": 0.1 * rng.standard_normal((2, 23)).astype(np.float32)}
    js = dataclasses.replace(js, **{k: jnp.asarray(v) for k, v in vals.items()})
    ts = tenv.reset_to_start(tenv.init_state()).sim
    ts = dataclasses.replace(ts, **{k: torch.as_tensor(v) for k, v in vals.items()})
    port, jx = mj_mirror.MjFleet(tenv, 2), jax_mirror.MjFleet(jenv, 2)
    for i in range(2):
        port.set_from(ts, i)
        jx.set_from(js, i)
    got, want = port.read_batch(), jx.read_batch()
    for a, b, tol in zip(got, want, (1e-6, 1e-6, 1e-6, 1e-5, 1e-6, 1e-6)):
        _close(a, b, tol=tol)
    _close(got[3], vals["root_ang_vel"], tol=1e-5, what="world angular velocity round trip")
    acts = 0.1 * rng.standard_normal((2, 23)).astype(np.float32)
    port.step(acts)
    jx.step(acts)
    tsim, jsim = port.inject(ts), jx.inject(js)
    for f in ("root_pos", "root_quat", "root_lin_vel", "root_ang_vel", "dof_pos", "dof_vel"):
        a = getattr(tsim, f)
        assert a.dtype == torch.float32 and a.device == ts.root_pos.device
        _close(a.numpy(), np.asarray(getattr(jsim, f)), tol=1e-5, what=f)


def test_mujoco_simulator_matches_jax():
    xml = g1_asset_root() / "g1_23dof_lock_wrist.xml"
    port, jx = MujocoSimulator(xml), JaxMujocoSimulator(xml)
    rs = np.zeros((1, 13), np.float32)
    rs[0, 2], rs[0, 6], rs[0, 7], rs[0, 11] = 0.9, 1.0, 0.2, 0.3
    dof = np.full((1, 23), 0.1, np.float32)
    tau = np.random.default_rng(6).standard_normal(23) * 5
    for sim in (port, jx):
        sim.set_actor_root_state_tensor([0], rs)
        sim.set_dof_state_tensor([0], dof, np.zeros_like(dof))
        for _ in range(20):
            sim.apply_torques_at_dof(tau)
            sim.simulate_at_each_physics_step()
        sim.refresh_sim_tensors()
    assert port._body_list == jx._body_list
    for f in ("dof_pos", "dof_vel", "robot_root_states", "base_quat", "_rigid_body_pos", "_rigid_body_rot",
              "_rigid_body_vel", "_rigid_body_ang_vel", "contact_forces"):
        np.testing.assert_array_equal(getattr(port, f), getattr(jx, f), err_msg=f)


def test_terrain_writers_match_jax(tmp_path):
    cfg = dict(num_rows=2, num_cols=2, border_size=2.0)
    port, jx = terrain.Terrain(terrain.TerrainConfig(**cfg)), jax_terrain.Terrain(jax_terrain.TerrainConfig(**cfg))
    robot = g1_asset_root() / "g1_23dof_lock_wrist.xml"
    for sphere_feet in (True, False):
        a = port.export_mujoco(robot, tmp_path / f"port_{sphere_feet}.xml", sphere_feet=sphere_feet)
        b = jx.export_mujoco(robot, tmp_path / f"jax_{sphere_feet}.xml", sphere_feet=sphere_feet)
        assert a.read_bytes() == b.read_bytes()
        assert Path(str(a) + ".terrain.npz").read_bytes() == Path(str(b) + ".terrain.npz").read_bytes()
    xml = robot.read_text()
    for style in ("box", "sphere"):
        assert terrain.swap_sphere_soles(xml, style) == jax_terrain.swap_sphere_soles(xml, style)
    models = [f(mujoco.MjModel.from_xml_path(str(p)), p) for f, p in
              ((terrain.fill_mujoco_hfield, a), (jax_terrain.fill_mujoco_hfield, b))]
    np.testing.assert_array_equal(models[0].hfield_data, models[1].hfield_data)
    assert float(np.ptp(models[0].hfield_data)) > 0
