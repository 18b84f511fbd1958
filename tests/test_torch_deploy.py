"""Port parity: the deploy stack that runs without MuJoCo (the student export
and its `export` CLI, the numpy and native ONNX executors, the native MLP
core, the student observation builder, the external stubs, teleop and the
deploy config snapshots), against `pbhc_tpu` on the CPU.

The same inputs go through both packages: the committed KungfuBot2 student
(`kb2_student23_r3`), the committed `terrain_walk_v2` ONNX, the side-kick
checkpoint's `.npz` export, and observations drawn from a numpy seed. The
JAX side runs its numpy executors only: its native libraries are built next
to their sources on first use, and this file leaves them untouched.

Tolerances:
- the student export: ONNX bytes equal, `.meta.json` equal once parsed, and
  the bytes' SHA-256 pinned (`chip_smoke.py` holds the card's export to it);
- executors on the same graph and feeds: 2e-5 absolute (float32 sums in
  other orders; the JAX package's own executor bound,
  tests/test_native_infer.py); an executor against the port's torch
  student: rtol 2e-4 / atol 2e-5 (that file's bound against flax);
- `NativePolicy` against `NumpyPolicy`: 1e-5 (tests/test_native_infer.py);
- `StudentObsBuilder` against the env's observations: 2e-4 absolute
  (tests/test_student_obs.py: the builder interpolates the reference in
  float64 and normalises its quaternions, the env in float32); against the
  JAX builder on the same state and motion arrays: 1e-6 (the same numpy
  code);
- the deploy metadata of a run config: equal to JAX's; against the
  metadata the JAX exporter wrote for that run: rtol 1e-6 (the exporter
  rounds gains to float32).
"""
import hashlib
import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(2)

from pbhc_tpu.deploy import export as jax_export  # noqa: E402
from pbhc_tpu.deploy import external as jax_external  # noqa: E402
from pbhc_tpu.deploy import student_obs as jax_student_obs  # noqa: E402
from pbhc_tpu.deploy.onnx_numpy import OnnxPolicy as JaxOnnxPolicy  # noqa: E402
from pbhc_tpu.deploy.onnx_numpy import meta_from_reference_config as jax_meta_from_config  # noqa: E402
from pbhc_tpu.deploy.teleop import TeleopSource as JaxTeleopSource  # noqa: E402
from pbhc_tpu_torch.deploy import export, external, student_obs  # noqa: E402
from pbhc_tpu_torch.deploy.native import NativePolicy  # noqa: E402
from pbhc_tpu_torch.deploy.native.onnx_exec import NativeOnnxPolicy  # noqa: E402
from pbhc_tpu_torch.deploy.onnx_numpy import OnnxPolicy, meta_from_reference_config  # noqa: E402
from pbhc_tpu_torch.deploy.teleop import TeleopSource  # noqa: E402
from pbhc_tpu_torch.eval import batch_eval  # noqa: E402
from pbhc_tpu_torch.maths import rotations as rot  # noqa: E402
from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
STUDENT_CKPT = "artifacts/kb2_student23_r3/ckpt/model_8000.pkl"
# sha256 of the JAX package's `export_student` of STUDENT_CKPT
# (python -m pbhc_tpu.deploy.export student <ckpt> <out>); chip_smoke.py pins it too
STUDENT_ONNX_SHA256 = "7c90c7627fe76981680fdb4609000d4de4cbba82b4d6197b4e2adb01343457f5"
SIDE_KICK_CKPT = "artifacts/kb1_side_kick/ckpt/model_10500.pkl"
TERRAIN_RUN = REPO / "artifacts" / "terrain_walk_v2"
TERRAIN_ONNX = TERRAIN_RUN / "exported" / "model_6000.onnx"
# observation noise off (tests/test_student_obs.py) and the randomisations
# the deploy builder cannot see (tests/test_torch_env.py::OFF)
STUDENT_OFF = ["obs.noise_scales.base_ang_vel=0", "obs.noise_scales.dof_pos=0", "obs.noise_scales.dof_vel=0",
               "obs.noise_scales.roll_pitch=0", "domain_rand.push_robots=false",
               "domain_rand.randomize_torque_rfi=false", "domain_rand.use_rao=false",
               "domain_rand.randomize_ctrl_delay=false", "domain_rand.randomize_pd_gain=false",
               "domain_rand.randomize_rfi_lim=false", "domain_rand.randomize_link_mass=false",
               "domain_rand.randomize_link_inertia=false", "domain_rand.randomize_base_com=false",
               "domain_rand.randomize_friction=false"]
FEEDS = ("actor_obs", "future_motion_targets", "prop_history")


@pytest.fixture(scope="module")
def student(tmp_path_factory):
    """The student exported by both packages' CLIs."""
    d = tmp_path_factory.mktemp("student")
    port = export.main(["student", STUDENT_CKPT, str(d / "port.onnx"), "device=cpu"])
    jax_export.main(["student", STUDENT_CKPT, str(d / "jax.onnx")])
    return Path(port), d / "jax.onnx"


@pytest.fixture(scope="module")
def side_kick(tmp_path_factory):
    """The side-kick checkpoint's `.npz` and `.onnx` exports (the port's
    writer, the JAX package's bytes: tests/test_torch_eval.py)."""
    env, actor, cfg = batch_eval.load(SIDE_KICK_CKPT, 1, device="cpu")
    path = export.export_policy(actor, load_checkpoint_payload(SIDE_KICK_CKPT)["actor_params"], env,
                                tmp_path_factory.mktemp("side_kick") / "model_10500.npz",
                                meta_extra={"motion_file": str(cfg.robot.motion.motion_file)})
    return path, actor


def _feeds(meta, n, seed):
    rng = np.random.default_rng(seed)
    dims = {"actor_obs": meta["obs_dim"],
            "future_motion_targets": sum(meta["obs_dims"][k] for k in meta["obs_groups"]["future_motion_targets"]),
            "prop_history": sum(meta["obs_dims"][k] * L for k, L in meta["history_spec"]["history"].items())}
    return {k: rng.standard_normal((n, dims[k])).astype(np.float32) for k in FEEDS}


def test_export_student_matches_jax(student):
    port, jax_path = student
    data = port.read_bytes()
    assert data == jax_path.read_bytes()
    assert hashlib.sha256(data).hexdigest() == STUDENT_ONNX_SHA256
    meta = json.loads(Path(str(port) + ".meta.json").read_text())
    assert meta == json.loads(Path(str(jax_path) + ".meta.json").read_text())
    assert meta["obs_dim"] == 877 and meta["history_length"] == 10 and meta["future_num_steps"] == 20


def test_export_info_matches_jax(side_kick, capsys):
    path, _ = side_kick
    export.main(["info", str(path)])
    port = capsys.readouterr().out
    jax_export.main(["info", str(path)])
    assert port == capsys.readouterr().out
    assert json.loads(port)["layers"] == ["380x512", "512x256", "256x128", "128x23"]


def test_student_executors_match_jax_and_torch(student):
    path, _ = student
    meta = json.loads(Path(str(path) + ".meta.json").read_text())
    feeds = _feeds(meta, 1, 0)
    want = JaxOnnxPolicy(path, meta).run(feeds)[0]
    _, net, _ = batch_eval.load(STUDENT_CKPT, 1, device="cpu")
    with torch.no_grad():
        mean = net.act({k: torch.as_tensor(v) for k, v in feeds.items()}, True)[0].numpy()
    for native in (False, True):
        pol = export.StudentPolicy(path, native=native)
        got = pol(feeds)
        assert got.shape == (23,)
        np.testing.assert_allclose(got, want[0], atol=2e-5, err_msg=f"native={native}")
        np.testing.assert_allclose(got, mean[0], rtol=2e-4, atol=2e-5, err_msg=f"native={native}")
    # the numpy executor batched, against torch
    batch = _feeds(meta, 5, 1)
    with torch.no_grad():
        mean = net.act({k: torch.as_tensor(v) for k, v in batch.items()}, True)[0].numpy()
    np.testing.assert_allclose(OnnxPolicy(path, meta).run(batch)[0], mean, rtol=2e-4, atol=2e-5)


def _reference_format(cfg, dof_names):
    """A committed run's config in the reference's format (what the JAX
    `meta_from_reference_config` reads): `robot.dof_names` listed and
    `obs.obs_dims` as a list of one-key dicts."""
    cfg = json.loads(json.dumps(cfg))
    cfg["robot"]["dof_names"] = list(dof_names)
    cfg["obs"]["obs_dims"] = [{k: v} for k, v in cfg["obs"]["obs_dims"].items()]
    return cfg


def test_meta_from_reference_config(tmp_path):
    """The reference format: equal to JAX's from the same config (a YAML file
    for JAX, the dict or a run directory's config.json for the port). A
    committed run's own config (the snapshot route, no `dof_names`): the
    metadata the JAX exporter wrote into that run's `.npz`."""
    written = json.loads(bytes(np.load(TERRAIN_RUN / "exported" / "model_6000.npz")["meta_json"]).decode())
    cfg = _reference_format(yaml.safe_load((TERRAIN_RUN / "config.yaml").read_text()), written["dof_names"])
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(cfg))
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    want = jax_meta_from_config(tmp_path / "config.yaml", "m.pkl")
    assert meta_from_reference_config(cfg, "m.pkl") == want
    assert meta_from_reference_config(tmp_path, "m.pkl") == want
    got = meta_from_reference_config(TERRAIN_RUN)
    assert got == meta_from_reference_config(cfg)
    for k in ("dof_names", "obs_groups", "obs_dims", "obs_scales", "history_spec", "num_actions"):
        assert got[k] == written[k], k
    for k in ("action_scale", "default_dof_pos", "kp", "kd", "torque_limits", "action_clip", "clip_obs", "dt"):
        np.testing.assert_allclose(got[k], written[k], rtol=1e-6, err_msg=k)


def test_meta_from_reference_config_resolves_interpolations(tmp_path):
    """A config dict whose values still hold `${...}` (and a foreign resolver,
    kept raw) gives the metadata JAX's gives after its lenient resolution."""
    written = json.loads(bytes(np.load(TERRAIN_RUN / "exported" / "model_6000.npz")["meta_json"]).decode())
    cfg = _reference_format(yaml.safe_load((TERRAIN_RUN / "config.yaml").read_text()), written["dof_names"])
    dims = cfg["obs"]["obs_dims"]
    plain = meta_from_reference_config(cfg, "m.pkl")
    for entry in dims:
        ((k, v),) = entry.items()
        if v == cfg["robot"]["dof_obs_size"]:
            entry[k] = "${robot.dof_obs_size}"
        elif v == 3 * cfg["robot"]["dof_obs_size"]:
            entry[k] = "${eval:'3 * ${robot.dof_obs_size}'}"
    cfg["experiment_dir"] = "logs/${now:%Y-%m-%d}"
    assert any(isinstance(v, str) for e in dims for v in e.values())
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(cfg))
    want = jax_meta_from_config(tmp_path / "config.yaml", "m.pkl")
    assert meta_from_reference_config(cfg, "m.pkl") == want == plain


def test_terrain_onnx_executors_match_jax():
    meta = meta_from_reference_config(TERRAIN_RUN)
    obs = np.random.default_rng(2).standard_normal((4, 380)).astype(np.float32)
    want = JaxOnnxPolicy(TERRAIN_ONNX, meta)(obs)
    npz = jax_export.NumpyPolicy(TERRAIN_RUN / "exported" / "model_6000.npz")(obs)
    np.testing.assert_allclose(want, npz, atol=2e-5)
    for pol in (OnnxPolicy(TERRAIN_ONNX, meta), NativeOnnxPolicy(TERRAIN_ONNX, meta)):
        assert pol.meta == meta and pol.inputs == ["actor_obs"]
        # the native plan is made for batch 1, the robot's tick
        got = np.stack([pol(row) for row in obs])
        np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(OnnxPolicy(TERRAIN_ONNX, meta)(obs), want, atol=2e-5)


def test_native_policy_matches_numpy(side_kick):
    path, actor = side_kick
    obs = np.random.default_rng(0).normal(0, 1, (16, 380)).astype(np.float32)
    ref = export.NumpyPolicy(path)
    nat = NativePolicy(path)
    np.testing.assert_allclose(ref(obs), jax_export.NumpyPolicy(path)(obs), atol=1e-6)
    np.testing.assert_allclose(nat(obs), ref(obs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nat(obs[0]), ref(obs[0]), rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(nat(obs), actor(torch.as_tensor(obs))[0].numpy(), atol=1e-5)
    with pytest.raises(ValueError):
        nat(obs[0, :100])
    assert nat.meta == ref.meta and nat.meta["n_layers"] == 4


class _Robot:
    """An env row as the controller surface the builders read."""

    def __init__(self, state, i=0):
        sim = state.sim
        self.q = sim.dof_pos[i].numpy()
        self.dq = sim.dof_vel[i].numpy()
        self.quat_xyzw = sim.root_quat[i].numpy()
        self.base_ang_vel_local = rot.quat_rotate_inverse(sim.root_quat[i:i + 1], sim.root_ang_vel[i:i + 1])[0].numpy()
        self.last_action = state.actions[i].numpy()


def test_student_obs_builder_matches_env_and_jax():
    """Six control steps of the student from clip start (`batch_eval`'s
    serving loop, N = 2): at each, the port's builder on env 0's state
    against the env's observations, and the JAX builder on the same state
    and the same motion arrays against the port's."""
    env, net, _ = batch_eval.load(STUDENT_CKPT, 2, STUDENT_OFF, device="cpu")
    meta = export.student_meta(env)
    host = student_obs.MotionHost(env.motion_lib)
    builder = student_obs.StudentObsBuilder(meta, host, compensate_offsets=False)
    jax_builder = jax_student_obs.StudentObsBuilder(
        meta, jax_student_obs.MotionHost(SimpleNamespace(data=SimpleNamespace(
            **{k: getattr(env.motion_lib.data, k).numpy() for k in
               ("gts", "grs", "gvs", "gavs", "dof_pos", "dof_vel", "lengths", "dt", "num_frames")}))),
        compensate_offsets=False)
    state, obs = batch_eval.start_episodes(env)
    for _ in range(6):
        t = float(state.episode_length[0]) * env.dt + float(state.motion_start_times[0])
        got = builder.build(_Robot(state), t)
        jgot = jax_builder.build(_Robot(state), t)
        for k in FEEDS:
            assert got[k].shape == (1, obs[k].shape[1]), k
            np.testing.assert_allclose(got[k][0], obs[k][0].numpy(), atol=2e-4, err_msg=k)
            np.testing.assert_allclose(got[k], jgot[k], atol=1e-6, err_msg=k)
        with torch.no_grad():
            state, obs, _, done, _ = env.step(state, batch_eval.act_mean(net, obs))
        assert not bool(done[0])
    assert builder.hist["actions"].shape == (10, 23)


def test_student_obs_offsets_match_jax():
    """Offset compensation (tests/test_student_obs.py::test_student_obs_offsets):
    a tilted, shifted start gives the perfect start's observations, and the
    port's builder equals JAX's on both over three ticks."""
    class _M:  # identity pose, 2 bodies
        length, dt, num_frames = 2.0, 0.02, 101

        def state(self, t):
            sh = np.asarray(t, dtype=np.float64).shape
            return dict(
                body_pos=np.zeros(sh + (2, 3), np.float32) + np.asarray([0, 0, 0.79], np.float32),
                body_rot=np.broadcast_to(np.asarray([0, 0, 0, 1], np.float32), sh + (2, 4)).copy(),
                body_vel=np.zeros(sh + (2, 3), np.float32), body_ang_vel=np.zeros(sh + (2, 3), np.float32),
                dof_pos=np.zeros(sh + (3,), np.float32), dof_vel=np.zeros(sh + (3,), np.float32))

    meta = {"obs_dims": {"actions": 3, "base_ang_vel": 3, "dof_pos": 3, "dof_vel": 3, "roll_pitch": 2},
            "obs_scales": {}, "default_dof_pos": [0.1, -0.2, 0.3], "clip_obs": 100.0, "dt": 0.02,
            "key_body_ids": [1], "anchor_index": 0, "future_num_steps": 4, "future_max_steps": 8,
            "history_length": 3}
    a = np.sin(0.026), np.cos(0.026)
    robots = {"perfect": SimpleNamespace(q=np.asarray(meta["default_dof_pos"], np.float32), quat_xyzw=[0, 0, 0, 1.0]),
              "tilted": SimpleNamespace(q=np.asarray(meta["default_dof_pos"], np.float32) + 0.05,
                                        quat_xyzw=[a[0], 0, 0, a[1]])}
    out = {}
    for name, r in robots.items():
        r.dq, r.base_ang_vel_local, r.last_action = np.zeros(3), np.zeros(3), np.full(3, 0.1)
        b = student_obs.StudentObsBuilder(dict(meta), _M(), compensate_offsets=True)
        jb = jax_student_obs.StudentObsBuilder(dict(meta), _M(), compensate_offsets=True)
        out[name] = [b.build(r, 0.02 * i) for i in range(3)]
        for got, want in zip(out[name], [jb.build(r, 0.02 * i) for i in range(3)]):
            for k in got:
                np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    for p, t in zip(out["perfect"], out["tilted"]):
        for k in p:
            np.testing.assert_allclose(p[k], t[k], atol=1e-5, err_msg=k)


def test_numpy_quaternions_match_torch():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((6, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.standard_normal((6, 3)).astype(np.float32)
    tq, tv = torch.as_tensor(q), torch.as_tensor(v)
    np.testing.assert_allclose(student_obs.quat_rotate_inverse(q, v), rot.quat_rotate_inverse(tq, tv).numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(student_obs.get_euler_xyz(q), rot.get_euler_xyz(tq).numpy(), atol=1e-5)
    np.testing.assert_allclose(student_obs.quat_to_matrix(q), rot.quat_to_matrix(tq).numpy(), atol=1e-6)
    np.testing.assert_allclose(student_obs.quat_mul(q, q[::-1]), rot.quat_mul(tq, tq.flip(0)).numpy(), atol=1e-6)


@pytest.mark.parametrize("kind,kw", [("zero", {}), ("sin", {"amp": 0.2, "freq_hz": 1.5, "joints": [0, 3, 7]})])
def test_external_stubs_match_jax(kind, kw):
    meta = {"num_actions": 23, "dt": 0.02}
    port, jax_pol = external.get_external_policy(kind, meta, **kw), jax_external.get_external_policy(kind, meta, **kw)
    for _ in range(5):
        np.testing.assert_array_equal(port(None), jax_pol(None))
    assert port.t == 5


def _received(src, coords, timeout=1.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if np.array_equal(src.coords, coords):
            return True
        time.sleep(0.01)
    return False


def test_teleop_round_trip():
    """One marker set over UDP on localhost, sent by either package's
    `send`, lands in the port's listener within 1 s."""
    src = TeleopSource(port=0).start()
    try:
        port = src.addr[1]
        assert port != 0 and np.array_equal(src.coords, np.zeros((3, 3)))
        for i, send in enumerate((TeleopSource.send, JaxTeleopSource.send)):
            coords = np.arange(9, dtype=np.float64).reshape(3, 3) * (i + 1) - 0.5
            send(coords, port=port)
            assert _received(src, coords), src.coords
    finally:
        src.stop()
    assert src._thread is None


def test_teleop_env_hook():
    """`use_teleop_control=true` starts a listener and holds the [N,3,3]
    marker buffer (`tracking_env.py:178-186`); the env steps as before."""
    env, actor, _ = batch_eval.load(SIDE_KICK_CKPT, 2, ["env.config.use_teleop_control=true",
                                                        "env.config.teleop_port=0"], device="cpu")
    try:
        assert env.teleop_marker_coords.shape == (2, 3, 3)
        state, obs = batch_eval.start_episodes(env)
        state, first, nonfinite = batch_eval.rollout_ratio(env, actor, state, obs, 2)
        assert int(nonfinite) == 0
        coords = np.full((3, 3), 0.25)
        TeleopSource.send(coords, port=env.teleop_source.addr[1])
        assert _received(env.teleop_source, coords)
    finally:
        env.close()
    assert env.teleop_source is None
    plain, _, _ = batch_eval.load(SIDE_KICK_CKPT, 2, device="cpu")
    assert plain.teleop_source is None


@pytest.mark.parametrize("group", ["single", "multiple", "external", "real_g1_23", "real_g1_23_student"])
def test_deploy_snapshot_equals_yaml(group):
    snap = REPO / "pbhc_tpu_torch" / "config" / "groups" / "deploy" / f"{group}.json"
    assert json.loads(snap.read_text()) == yaml.safe_load((REPO / "pbhc_tpu" / "config" / "deploy"
                                                           / f"{group}.yaml").read_text())
