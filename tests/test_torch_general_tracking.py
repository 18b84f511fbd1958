"""Port parity: `GeneralTrackingEnv` (KungfuBot2) on the lanes engine and the
KungfuBot2 serving path, against `pbhc_tpu` on the CPU.

For the committed 23-DoF and 29-DoF teachers, both packages load the run
through their `batch_eval` loaders (N = 64 envs), reset every env to clip
start, and step 10 control steps under the checkpoint's deterministic
history-latent action (`episode_ratio`'s loop). Randomness is switched off
through config overrides, as in tests/test_torch_env.py (JAX's threefry
and torch's generators draw different numbers); the `ref_pos_z` and
`ref_ori` terminations are switched on so that their code runs.

Tolerances (those of tests/test_torch_env.py for the side-kick): actions
and every observation group 2e-3 absolute (they hold velocities that the
contact solve's f32 noise reaches), rewards 1e-3 relative, states 1e-4
(positions, quaternions) and 2e-3 (velocities), `done` and `time_outs`
exactly, the step logs 1e-3 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu.agents.mimic_networks import MimicActorCritic as FlaxMimic  # noqa: E402
from pbhc_tpu.envs.general_tracking_env import _yaw_quat as jax_yaw_quat  # noqa: E402
from pbhc_tpu.eval import batch_eval as jax_eval  # noqa: E402
from pbhc_tpu.maths import rotations as jr  # noqa: E402
from pbhc_tpu_torch.envs.general_tracking_env import _yaw_quat  # noqa: E402
from pbhc_tpu_torch.eval import batch_eval  # noqa: E402
from pbhc_tpu_torch.maths import rotations as tr  # noqa: E402

CKPTS = {"kb2_teacher23_r3": "artifacts/kb2_teacher23_r3/ckpt/model_24000.pkl",
         "kb2_teacher29_r5": "artifacts/kb2_teacher29_r5/ckpt/model_3000.pkl"}
N = 64
OFF = ["domain_rand.push_robots=false", "domain_rand.randomize_torque_rfi=false",
       "domain_rand.use_rao=false", "domain_rand.randomize_ctrl_delay=false",
       "domain_rand.randomize_pd_gain=false", "domain_rand.randomize_rfi_lim=false",
       "domain_rand.randomize_link_mass=false", "domain_rand.randomize_link_inertia=false",
       "domain_rand.randomize_base_com=false", "domain_rand.randomize_friction=false",
       "obs.noise_scales.base_ang_vel=0", "obs.noise_scales.dof_pos=0",
       "obs.noise_scales.dof_vel=0", "obs.noise_scales.roll_pitch=0",
       "env.config.termination.terminate_by_ref_pos_z=true",
       "env.config.termination.terminate_by_ref_ori=true"]
GROUPS = ("actor_obs", "priv_obs", "future_motion_targets", "prop_history")
SIM_TOL = {"root_pos": 1e-4, "root_quat": 1e-4, "dof_pos": 1e-4, "body_pos": 1e-4, "body_quat": 1e-4,
           "root_lin_vel": 2e-3, "root_ang_vel": 2e-3, "dof_vel": 2e-3, "body_lin_vel": 2e-3,
           "body_ang_vel": 2e-3}


@pytest.fixture(scope="module", params=sorted(CKPTS))
def envs(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("PBHC_MOTION_CACHE", "0")
    ckpt = CKPTS[request.param]
    jenv, algo, payload = jax_eval._load(ckpt, N, OFF)
    params = payload["params"]
    js = jenv.reset_to_start(jenv.init_state(jax.random.PRNGKey(1)), jax.random.PRNGKey(1))
    jobs, hist = jenv._compute_observations(js, jax.random.PRNGKey(2))
    js = dataclasses.replace(js, history=hist)
    jstep = jax.jit(jenv.step)
    jact = jax.jit(lambda o: algo.net.apply(params, o, True, method=FlaxMimic.act)[0])
    tenv, actor, _ = batch_eval.load(ckpt, N, OFF, device="cpu")
    ts, tobs = batch_eval.start_episodes(tenv)
    yield jenv, jstep, jact, js, jobs, tenv, actor, ts, tobs
    mp.undo()


def _close(a, b, atol, what):
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=atol, err_msg=what)


def _compare_states(js, ts):
    for f, tol in SIM_TOL.items():
        _close(getattr(js.sim, f), getattr(ts.sim, f), tol, f)
    for f in ("episode_length", "motion_start_times", "motion_len"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)
    for f in ("contacts", "contacts_filt", "feet_air_time", "sigma_values", "sigma_ema",
              "average_episode_length", "motion_far_threshold"):
        _close(getattr(js, f), getattr(ts, f), 1e-5, f)
    for k in js.history:
        _close(js.history[k], ts.history[k], 2e-3, f"history/{k}")


def test_first_observations(envs):
    jenv, _, _, js, jobs, tenv, _, ts, tobs = envs
    assert tenv.tar_obs_steps.tolist() == jenv.tar_obs_steps.tolist()
    assert (tenv.anchor_index, tenv.key_body_id.tolist()) == (jenv.anchor_index, jenv.key_body_id.tolist())
    for g in GROUPS:
        assert tuple(tobs[g].shape) == jobs[g].shape == (N, tenv.obs_dim(g)), g
        _close(jobs[g], tobs[g], 1e-5, g)
    _compare_states(js, ts)


def test_serving_path_first_ten_steps(envs):
    """Every obs group, reward, termination and log over 10 serving steps."""
    _, jstep, jact, js, jobs, tenv, actor, ts, tobs = envs
    for i in range(10):
        ja = jact(jobs)
        with torch.no_grad():
            ta = batch_eval.act_mean(actor, tobs)
        _close(ja, ta, 2e-3, f"actions step {i}")
        js, jobs, jrew, jdone, jinfo = jstep(js, ja)
        ts, tobs, trew, tdone, tinfo = tenv.step(ts, ta)
        assert trew.shape == (N, 1)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone), err_msg=f"done step {i}")
        np.testing.assert_array_equal(tinfo["time_outs"].numpy(), np.asarray(jinfo["time_outs"]))
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=1e-3, atol=1e-5, err_msg=f"step {i}")
        for g in GROUPS:
            _close(jobs[g], tobs[g], 2e-3, f"{g} step {i}")
    _compare_states(js, ts)
    assert set(tinfo["log"]) == set(jinfo["log"])
    assert {"terminate_by_ref_pos_z", "terminate_by_ref_ori", "rew_local_key_body_rotation"} <= set(tinfo["log"])
    for k, v in jinfo["log"].items():
        np.testing.assert_allclose(float(tinfo["log"][k]), float(v), rtol=1e-3, atol=1e-6, err_msg=k)


def test_reward_and_diff_terms(envs):
    """The env's diffs and reward terms on the current state, term by term."""
    jenv, _, _, js, _, tenv, _, ts, _ = envs
    jm, _ = jenv._motion_state_at(js, 1)
    tm, _ = tenv._motion_state_at(ts, 1)
    jb = jenv._extend_body_states(js.sim)
    tb = tenv._extend_body_states(ts.sim)
    jd = jenv._compute_diffs(js.sim, jm, *jb)
    td = tenv._compute_diffs(ts.sim, tm, *tb)
    assert set(jd) == set(td)
    for k in jd:
        _close(jd[k], td[k], 2e-3, k)


@pytest.mark.parametrize("fn", ["yaw_quat", "quat_to_angle_axis"])
def test_rotation_helpers_match_jax(fn):
    rng = np.random.default_rng(11)
    q = rng.normal(size=(256, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[:8] = [0.0, 0.0, 0.0, 1.0]                          # null rotations take the z axis
    if fn == "yaw_quat":
        np.testing.assert_allclose(_yaw_quat(torch.as_tensor(q)).numpy(), np.asarray(jax_yaw_quat(jnp.asarray(q))),
                                   atol=1e-6)
    else:
        for a, b in zip(tr.quat_to_angle_axis(torch.as_tensor(q)), jr.quat_to_angle_axis(jnp.asarray(q))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
