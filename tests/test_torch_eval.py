"""Port parity: the evaluation CLI (`eval_agent`, `batch_eval.sample_episodes`),
its metric families, the deploy export and the eval callbacks, against
`pbhc_tpu` on the CPU.

Randomness is switched off as in tests/test_torch_env.py. Runs that
`eval_agent` writes into (`exported/`, `eval_<stem>.json`) are copies under
`tmp_path`, evaluated on the side-kick clip cut to its first 40 frames
(1.3 s, 64 control steps).

Tolerances:
- the metric families on identical inputs: 1e-6 relative (the same numpy
  code in both packages);
- a rollout's trajectory and reference: tests/test_torch_env.py's `SIM_TOL`
  and 2e-3 on the actions (the serving path's bounds; the reference
  rotations 4e-4, tests/test_torch_motion.py's slerp bound, the other
  reference fields 2e-5); the reference and the terrain offset fields 1e-4;
- the exports: `.onnx` bytes equal; `.npz` bytes equal when written from the
  checkpoint's params, arrays and metadata equal from the converter;
- the families of an `eval_agent` or `sample_episodes` run over the cut
  clip: 1e-3 relative (over 64 steps the two trajectories stay within
  ~1e-5 of each other, and the families within ~1e-5 relative); the
  completion ratio exactly;
- a whole clip (the horse-stance run, 348 steps): the two rollouts are
  held to `SIM_TOL` step by step until they first part; where they part,
  JAX's own step must jump by more than `SIM_TOL` when its state is nudged
  by 1e-5 m at the root (a contact event: step 89 on one CPU, ~1.05 rad/s
  in a joint velocity, the same in both). From there the two trajectories
  are two samples of a chaotic rollout, so each rollout family is held to
  max(2e-2 relative, twice the distance between JAX's own run and JAX's
  run from a start nudged by 1e-5 m), computed in the test. The reference
  families (L2_ref_*) do not depend on the rollout: 1e-5 relative.
"""
import dataclasses
import json
import pickle
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu import eval_agent as jax_agent  # noqa: E402
from pbhc_tpu.deploy import export as jax_export  # noqa: E402
from pbhc_tpu.deploy.onnx_export import export_mimic_onnx as jax_mimic_onnx  # noqa: E402
from pbhc_tpu.deploy.onnx_numpy import OnnxPolicy  # noqa: E402
from pbhc_tpu.eval import batch_eval as jax_eval  # noqa: E402
from pbhc_tpu.eval import dashboard as jax_dashboard  # noqa: E402
from pbhc_tpu.eval import metrics as jax_metrics  # noqa: E402
from pbhc_tpu_torch import eval_agent  # noqa: E402
from pbhc_tpu_torch.agents.convert import flax_params  # noqa: E402
from pbhc_tpu_torch.deploy.export import export_policy  # noqa: E402
from pbhc_tpu_torch.deploy.onnx_export import export_mimic_onnx  # noqa: E402
from pbhc_tpu_torch.eval import batch_eval, callbacks, dashboard, metrics  # noqa: E402
from pbhc_tpu_torch.motion.motion_lib import load_motion_dict  # noqa: E402
from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload  # noqa: E402
from test_torch_env import OFF, SIM_TOL  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
RUN = "kb1_side_kick"
CKPT = f"artifacts/{RUN}/ckpt/model_10500.pkl"
KB2_CKPT = "artifacts/kb2_teacher23_r3/ckpt/model_24000.pkl"
V3_CKPT = "artifacts/terrain_walk_v3/ckpt/model_6500.pkl"


@pytest.fixture(autouse=True)
def no_motion_cache(monkeypatch):
    monkeypatch.setenv("PBHC_MOTION_CACHE", "0")


def _traj(rng, T=50, B=27, nd=23):
    return {"body_pos": rng.normal(size=(T, B, 3)), "dof_pos": rng.normal(size=(T, nd)),
            "contact_mask": rng.uniform(size=(T, 2))}


def test_metric_families_match_jax():
    rng = np.random.default_rng(0)
    traj, ref = _traj(rng), _traj(rng)
    ref["body_pos"] = ref["body_pos"][:45]                   # the families cut to the shorter
    for dt, per_frame in ((0.02, True), (0.02, False)):
        want = jax_metrics.eval_accuracy(traj, ref, dt, per_frame)
        got = metrics.eval_accuracy(traj, ref, dt, per_frame)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-6), k
        want = jax_metrics.eval_smoothness(traj, dt, ref=ref, delta_per_frame=per_frame)
        got = metrics.eval_smoothness(traj, dt, ref=ref, delta_per_frame=per_frame)
        assert sorted(got) == sorted(want) and len(got) == 12
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-6), k
    lens, mlen = rng.integers(10, 300, 64), rng.uniform(3.0, 6.0, 64)
    assert metrics.episode_length_ratio(lens, mlen, 0.02) == pytest.approx(
        jax_metrics.episode_length_ratio(lens, mlen, 0.02), rel=1e-6)
    with pytest.raises(ValueError, match="requires dt"):
        metrics.eval_accuracy(traj, ref, None, False)


def _compare_rollouts(jtraj, jref, ttraj, tref):
    tol = {"root_pos": SIM_TOL["root_pos"], "root_rot": SIM_TOL["root_quat"], "dof_pos": SIM_TOL["dof_pos"],
           "body_pos": SIM_TOL["body_pos"], "body_rot": SIM_TOL["body_quat"], "dof_vel": SIM_TOL["dof_vel"],
           "root_lin_vel": SIM_TOL["root_lin_vel"], "root_ang_vel": SIM_TOL["root_ang_vel"],
           "action": 2e-3, "contact_mask": 0.0}
    assert sorted(ttraj) == sorted(jtraj) and sorted(tref) == sorted(jref)
    for k, v in jtraj.items():
        assert ttraj[k].shape == v.shape and ttraj[k].dtype == np.float32, k
        np.testing.assert_allclose(ttraj[k], v, atol=tol[k], err_msg=f"traj/{k}")
    for k, v in jref.items():
        np.testing.assert_allclose(tref[k], v, atol=4e-4 if k.endswith("rot") else 2e-5, err_msg=f"ref/{k}")


def test_rollout_matches_rollout_jax():
    """Five steps of the deterministic eval rollout, 4 envs, env 0 recorded."""
    jenv, algo, payload = jax_eval._load(CKPT, 4, OFF)
    jtraj, jref, jdones = jax_agent.rollout_jax(jenv, algo.actor, payload["actor_params"], 5,
                                                jax.random.PRNGKey(1))
    tenv, actor, _ = batch_eval.load(CKPT, 4, OFF, device="cpu")
    ttraj, tref, tdones = eval_agent.rollout(tenv, actor, 5)
    assert tdones == jdones == [False] * 5
    _compare_rollouts(jtraj, jref, ttraj, tref)


def test_eval_reference_carries_no_terrain_offset():
    """`rollout_jax` fetches the reference without the env's tile shift
    (`pbhc_tpu/eval_agent.py:68`), so on a heightfield run E_gmpbpe holds the
    tile's offset from the world origin (~41 m here) while the root-relative
    E_mpbpe does not. The port keeps that behaviour; both packages agree."""
    jenv, algo, payload = jax_eval._load(V3_CKPT, 1, OFF)
    jtraj, jref, _ = jax_agent.rollout_jax(jenv, algo.actor, payload["actor_params"], 5, jax.random.PRNGKey(1))
    tenv, actor, _ = batch_eval.load(V3_CKPT, 1, OFF, device="cpu")
    ttraj, tref, _ = eval_agent.rollout(tenv, actor, 5)
    origin = tenv.terrain_origins[0, 0].numpy()              # env 0: row 0, column 0
    assert np.linalg.norm(origin[:2]) > 40.0
    for traj, ref in ((jtraj, jref), (ttraj, tref)):
        # the clip starts near the world origin; the robot on its tile
        np.testing.assert_allclose(traj["root_pos"][:, :2] - ref["root_pos"][:, :2],
                                   np.broadcast_to(origin[:2], (5, 2)), atol=0.1)
    np.testing.assert_allclose(tref["body_pos"], jref["body_pos"], atol=1e-4)
    np.testing.assert_allclose(ttraj["body_pos"], jtraj["body_pos"], atol=1e-4)
    tacc, jacc = metrics.eval_accuracy(ttraj, tref, tenv.dt), jax_metrics.eval_accuracy(jtraj, jref, jenv.dt)
    assert tacc["E_gmpbpe"] > 1e3 * 40.0 and tacc["E_mpbpe"] < 200.0
    for k in ("E_gmpbpe", "E_mpbpe"):
        assert tacc[k] == pytest.approx(jacc[k], rel=1e-3), k


def test_export_policy_matches_jax(tmp_path):
    jenv, algo, payload = jax_eval._load(CKPT, 1, ())
    tenv, actor, cfg = batch_eval.load(CKPT, 1, (), device="cpu")
    extra = {"motion_file": str(cfg.robot.motion.motion_file)}
    want = jax_export.export_policy(payload["actor_params"], jenv, tmp_path / "jax" / "m.npz", meta_extra=extra,
                                    actor=algo.actor)
    got = export_policy(actor, load_checkpoint_payload(CKPT)["actor_params"], tenv, tmp_path / "port" / "m.npz",
                        meta_extra=extra)
    conv = export_policy(actor, flax_params(actor), tenv, tmp_path / "conv" / "m.npz", meta_extra=extra)
    assert got.read_bytes() == want.read_bytes()
    for p in (got, conv):
        assert p.with_suffix(".onnx").read_bytes() == want.with_suffix(".onnx").read_bytes()
    w, c = np.load(want), np.load(conv)
    assert w.files == c.files == ["w0", "b0", "w1", "b1", "w2", "b2", "w3", "b3", "std", "meta_json"]
    for k in w.files:
        np.testing.assert_array_equal(c[k], w[k], err_msg=k)
    meta = json.loads(bytes(c["meta_json"]).decode())
    assert meta["obs_dim"] == 380 and meta["num_actions"] == 23 and meta["motion_file"] == extra["motion_file"]
    # the JAX package's deploy runtimes read the port's files and act as the port's actor does
    obs = np.random.default_rng(1).normal(size=(6, 380)).astype(np.float32)
    with torch.no_grad():
        mean = actor(torch.as_tensor(obs))[0].numpy()
    np.testing.assert_allclose(jax_export.NumpyPolicy(conv)(obs), mean, atol=1e-5)
    np.testing.assert_allclose(OnnxPolicy(conv.with_suffix(".onnx"))(obs), mean, atol=1e-5)


def test_export_mimic_onnx_matches_jax(tmp_path):
    """The 3-input student graph of the KungfuBot2 teacher's net, written from
    the port's network through the converter: the same bytes."""
    jenv, algo, payload = jax_eval._load(KB2_CKPT, 1, ())
    tenv, net, _ = batch_eval.load(KB2_CKPT, 1, (), device="cpu")
    want = jax_mimic_onnx(algo.net, payload["params"], tmp_path / "jax.onnx", obs_dim=jenv.obs_dim("actor_obs"))
    got = export_mimic_onnx(net, flax_params(net), tmp_path / "port.onnx", obs_dim=tenv.obs_dim("actor_obs"))
    assert Path(got).read_bytes() == Path(want).read_bytes()


def _short_run(tmp_path, name, frames=40, actions=False):
    """A copy of the side-kick run under `tmp_path/name` and its clip cut to
    `frames` frames (with recorded actions if asked); returns the copied
    checkpoint and the motion override."""
    run = tmp_path / name / RUN
    (run / "ckpt").mkdir(parents=True)
    shutil.copy(REPO / "artifacts" / RUN / "config.yaml", run / "config.yaml")
    shutil.copy(REPO / CKPT, run / "ckpt" / Path(CKPT).name)
    raw = load_motion_dict(str(REPO / "assets/motions/Side_kick.pkl"))
    key = next(iter(raw))
    clip = {k: (v[:frames] if isinstance(v, np.ndarray) else v) for k, v in raw[key].items()}
    if actions:
        clip["action"] = (0.1 * np.random.default_rng(2).normal(size=(frames, 23))).astype(np.float32)
    motion = tmp_path / f"{name}_short.pkl"
    motion.write_bytes(pickle.dumps({key: clip}))
    return run / "ckpt" / Path(CKPT).name, f"robot.motion.motion_file={motion}"


def _close_families(got, want, rel=1e-3):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        tol = 1e-5 if k.startswith("L2_ref_") else rel
        assert np.isfinite(got[k]) and got[k] == pytest.approx(v, rel=tol), k


def test_eval_agent_end_to_end_matches_jax(tmp_path):
    jckpt, motion = _short_run(tmp_path, "jax")
    tckpt, _ = _short_run(tmp_path, "port")
    jmotion = tmotion = motion            # one clip file: the exports record its path
    want = jax_agent.main([f"checkpoint={jckpt}", jmotion, "save_motion=true", *OFF])
    got = eval_agent.main([f"checkpoint={tckpt}", tmotion, "save_motion=true", "device=cpu", *OFF])
    assert got["completion_ratio"] == want["completion_ratio"] == 1.0
    _close_families(got["accuracy"], want["accuracy"])
    _close_families(got["smoothness"], want["smoothness"])
    assert json.loads((tckpt.parent.parent / "eval_model_10500.json").read_text()) == got
    for suffix in (".npz", ".onnx"):
        a = (jckpt.parent.parent / "exported" / f"model_10500{suffix}").read_bytes()
        assert (tckpt.parent.parent / "exported" / f"model_10500{suffix}").read_bytes() == a, suffix
    # save_motion: the rollout as a motion clip in the JAX package's schema
    # (`pbhc_tpu/eval_agent.py:215-227`), which `joblib.load` reads; its
    # values are the rollout's, held as `_compare_rollouts` holds them
    import joblib

    jclip = joblib.load(jckpt.parent.parent / "motion_model_10500.pkl")["rollout"]
    tclip = joblib.load(tckpt.parent.parent / "motion_model_10500.pkl")["rollout"]
    assert list(tclip) == list(jclip) and tclip["fps"] == jclip["fps"] == 50
    tol = {"root_trans_offset": SIM_TOL["root_pos"], "root_rot": SIM_TOL["root_quat"], "dof": SIM_TOL["dof_pos"],
           "pose_aa": 2 * SIM_TOL["root_quat"], "contact_mask": 0.0, "dof_vel": SIM_TOL["dof_vel"],
           "root_lin_vel": SIM_TOL["root_lin_vel"], "root_ang_vel": SIM_TOL["root_ang_vel"], "action": 2e-3}
    for k, v in tol.items():
        assert tclip[k].shape == jclip[k].shape and tclip[k].dtype == jclip[k].dtype, k
        np.testing.assert_allclose(tclip[k], jclip[k], atol=v, err_msg=k)


def test_sample_episodes_matches_jax(tmp_path):
    ckpt, motion = _short_run(tmp_path, "run")
    want = jax_eval.sample_episodes(ckpt, num_envs=2, episodes=4, overrides=[motion, *OFF])
    got = batch_eval.sample_episodes(ckpt, num_envs=2, episodes=4, overrides=[motion, *OFF], device="cpu")
    assert sorted(got) == sorted(want) and len(got) == 22
    _close_families({k: v["mean"] for k, v in got.items()}, {k: v["mean"] for k, v in want.items()})
    # randomness off: the two episodes are the same rollout
    assert all(v["std"] == 0.0 for v in got.values())
    out = batch_eval.main([f"checkpoint={ckpt}", "mode=sample_episodes", "num_envs=2", "device=cpu", motion, *OFF])
    assert out == got
    with pytest.raises(ValueError, match="mode="):
        batch_eval.main([f"checkpoint={ckpt}", "mode=nope", "device=cpu"])


class _NudgedEnvsRecorder:
    """An eval callback for `rollout_jax` that keeps each step's pre-step env
    state, actions and post-step state, and the trajectories of envs 1 and 2
    in `rollout_jax`'s keys (env 0 is the one `rollout_jax` records)."""

    def __init__(self, env):
        self.env, self.steps = env, []
        self.traj = {e: {k: [] for k in eval_agent.TRAJ_KEYS} for e in (1, 2)}

    def on_pre_evaluate_policy(self):
        pass

    def on_post_evaluate_policy(self):
        pass

    def on_pre_eval_env_step(self, actor_state):
        self.steps.append([actor_state["env_state"], actor_state["actions"], None])
        return actor_state

    def on_post_eval_env_step(self, actor_state):
        state = self.steps[-1][2] = actor_state["env_state"]
        sim = state.sim
        body_pos, body_quat, _, _ = self.env._extend_body_states(sim)
        for e, traj in self.traj.items():
            for k, v in (("root_pos", sim.root_pos), ("root_rot", sim.root_quat), ("dof_pos", sim.dof_pos),
                         ("body_pos", body_pos), ("body_rot", body_quat), ("contact_mask", state.contacts_filt),
                         ("dof_vel", sim.dof_vel), ("root_lin_vel", sim.root_lin_vel),
                         ("root_ang_vel", sim.root_ang_vel), ("action", actor_state["actions"])):
                traj[k].append(np.asarray(v[e]))
        return actor_state


def test_horse_stance_pose_scored_by_sample_episodes():
    """The second committed MHPPO run, from its committed snapshot, over its
    whole clip (7 s, 348 control steps). The port's rollout is held to JAX's
    step by step until the two first part, which must be at a step where
    JAX's own step jumps under a 1e-5 m nudge of its state; then the port's
    `sample_episodes` families (2 envs) are held to JAX's within the spread
    JAX's own families show when its start is nudged by +-1e-5 m at the
    root. The randomness is off, so JAX's envs 1 and 2 run those nudged
    starts beside env 0 in one rollout. `sample_episodes` writes nothing
    beside the checkpoint."""
    ckpt = "artifacts/kb1_horse_stance_pose/ckpt/model_7000.pkl"
    ovs = OFF + list(batch_eval.NO_TERMINATION)
    jenv, algo, payload = jax_eval._load(ckpt, 3, ovs)
    params = payload["actor_params"]
    steps = int(float(jenv.motion_lib.data.lengths[0]) / jenv.dt)

    def nudged(js, dz):
        return dataclasses.replace(js, sim=dataclasses.replace(js.sim, root_pos=js.sim.root_pos.at[:, 2].add(dz)))

    reset = jenv.reset_to_start
    jenv.reset_to_start = lambda state, k: nudged(reset(state, k), jnp.asarray([0.0, 1e-5, -1e-5]))
    rec = _NudgedEnvsRecorder(jenv)
    # the key of jax_eval.sample_episodes' one episode
    traj, ref, _ = jax_agent.rollout_jax(jenv, algo.actor, params, steps, jax.random.PRNGKey(100), callbacks=[rec])
    jenv.reset_to_start = reset

    def families(tr):
        return {**jax_metrics.eval_accuracy(tr, ref, jenv.dt), **jax_metrics.eval_smoothness(tr, jenv.dt, ref=ref)}

    want = families(traj)
    spread = [families({k: np.stack(v) for k, v in rec.traj[e].items()}) for e in (1, 2)]

    # the port step by step against JAX's env 0, until they part
    tenv, actor, _ = batch_eval.load(ckpt, 2, ovs, device="cpu")
    ts, tobs = batch_eval.start_episodes(tenv)
    jstep = jax.jit(jenv.step)
    parted = None
    for i, (before, ja, after) in enumerate(rec.steps):
        with torch.no_grad():
            ts, tobs, _, _, _ = tenv.step(ts, actor(tobs["actor_obs"])[0])
        far = {f: float(np.abs(getattr(ts.sim, f).numpy()[0] - np.asarray(getattr(after.sim, f))[0]).max()) - tol
               for f, tol in SIM_TOL.items()}
        if max(far.values()) > 0:
            parted = i
            jump = max(float(np.abs(np.asarray(jstep(nudged(before, dz), ja)[0].sim.dof_vel)[0]
                                    - np.asarray(after.sim.dof_vel)[0]).max()) for dz in (1e-5, -1e-5))
            assert jump > SIM_TOL["dof_vel"], (i, far, jump)
            break
    assert parted is None or parted >= 20

    got = batch_eval.sample_episodes(ckpt, num_envs=2, episodes=2, overrides=OFF, device="cpu")
    assert sorted(got) == sorted(want)
    for k, j in want.items():
        t = got[k]["mean"]
        if k.startswith("L2_ref_"):
            assert t == pytest.approx(j, rel=1e-5), k
        else:
            bound = max(2e-2 * abs(j), 2.0 * max(abs(s[k] - j) for s in spread))
            assert np.isfinite(t) and abs(t - j) <= bound, (k, t, j, [s[k] for s in spread], parted)


def test_callbacks_and_dashboard_logger(tmp_path):
    """The plot, force and open-loop callbacks through a 5-step rollout into a
    dashboard logger whose HTTP server is not started."""
    ckpt, motion = _short_run(tmp_path, "run", actions=True)
    env, actor, cfg = batch_eval.load(ckpt, 2, [motion, *OFF], device="cpu")
    dash = dashboard.DashboardLogger(history=3)
    cbs = callbacks.build_callbacks(["plot", " force", "openloop", ""], cfg, env, dashboard=dash)
    assert [type(c).__name__ for c in cbs] == ["AnalysisPlotCallback", "ForcePlotCallback",
                                               "OpenLoopReplayCallback"]
    traj, _, _ = eval_agent.rollout(env, actor, 5, dashboard=dash, callbacks=cbs)
    frames = [min(int(i * env.dt * 30.0), 39) for i in range(5)]
    np.testing.assert_array_equal(traj["action"], cbs[2].actions[frames])
    snap = dash.snapshot()
    want = {"root_z", "dof_err", "torque_norm", "contact_fz_total", "contact_f_max",
            *(f"dof_pos_{j}" for j in range(6)), *(f"action_{j}" for j in range(6))}
    assert want <= set(snap) and any(k.startswith("rew_") for k in snap)
    assert all(len(v) == 3 and np.isfinite(v).all() for v in snap.values())   # the newest 3 steps kept
    # the JAX package's logger keeps the same channels from the same input
    jdash = jax_dashboard.DashboardLogger(history=3)
    for i in range(5):
        jdash.log_step({"a": float(i), "b": 2.0 * i})
        dash.log_step({"a": float(i), "b": 2.0 * i})
    assert dash.snapshot()["a"] == jdash.snapshot()["a"] == [2.0, 3.0, 4.0]
    with pytest.raises(ValueError, match="unknown eval callback"):
        callbacks.build_callbacks(["nope"], cfg, env)
    no_actions, _ = _short_run(tmp_path, "plain")
    with pytest.raises(ValueError, match="no recorded actions"):
        callbacks.OpenLoopReplayCallback(cfg, env, motion_file=str(tmp_path / "plain_short.pkl"))


def test_eval_agent_refuses_student_export(tmp_path):
    ckpt = tmp_path / "kb2_teacher23_r3" / "ckpt" / Path(KB2_CKPT).name
    ckpt.parent.mkdir(parents=True)
    shutil.copy(REPO / KB2_CKPT, ckpt)
    with pytest.raises(NotImplementedError, match="export student"):
        eval_agent.main([f"checkpoint={ckpt}", "device=cpu", "num_envs=1"])
    assert sorted(p.name for p in ckpt.parents[1].iterdir()) == ["ckpt"]     # nothing written
