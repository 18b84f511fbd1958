"""Port parity: the tracking env's lanes branch and the serving path as a
whole, against `pbhc_tpu` on the side-kick run config.

Randomness is switched off through config overrides (pushes, torque RFI/RAO,
control delay, PD-gain and link/friction randomisation, observation noise):
JAX's threefry and torch's generators draw different numbers. N = 128 envs.

Tolerances: states 1e-4 absolute (positions, quaternions, joint angles) and
2e-3 (velocities, which the contact solve's f32 noise reaches through 4
substeps per control step), observations 2e-3 (they hold those velocities,
scaled by at most 1), rewards 1e-4 relative, contact forces 1e-2 N per
100 N of load. `done` is compared exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu.eval import batch_eval as jax_eval  # noqa: E402
from pbhc_tpu_torch.eval import batch_eval  # noqa: E402

CKPT = "artifacts/kb1_side_kick/ckpt/model_10500.pkl"
N = 128
OFF = ["domain_rand.push_robots=false", "domain_rand.randomize_torque_rfi=false",
       "domain_rand.use_rao=false", "domain_rand.randomize_ctrl_delay=false",
       "domain_rand.randomize_pd_gain=false", "domain_rand.randomize_rfi_lim=false",
       "domain_rand.randomize_link_mass=false", "domain_rand.randomize_link_inertia=false",
       "domain_rand.randomize_base_com=false", "domain_rand.randomize_friction=false",
       "obs.noise_scales.base_ang_vel=0", "obs.noise_scales.dof_pos=0",
       "obs.noise_scales.dof_vel=0", "obs.noise_scales.projected_gravity=0"]
SIM_TOL = {"root_pos": 1e-4, "root_quat": 1e-4, "dof_pos": 1e-4, "body_pos": 1e-4, "body_quat": 1e-4,
           "root_lin_vel": 2e-3, "root_ang_vel": 2e-3, "dof_vel": 2e-3, "body_lin_vel": 2e-3,
           "body_ang_vel": 2e-3}


@pytest.fixture(scope="module")
def envs(monkeypatch_module):
    monkeypatch_module.setenv("PBHC_MOTION_CACHE", "0")
    jenv, algo, payload = jax_eval._load(CKPT, N, OFF)
    ap = payload["actor_params"]
    js = jenv.reset_to_start(jenv.init_state(jax.random.PRNGKey(1)), jax.random.PRNGKey(1))
    jobs, hist = jenv._compute_observations(js, jax.random.PRNGKey(2))
    js = dataclasses.replace(js, history=hist)
    jstep = jax.jit(jenv.step)
    jact = jax.jit(lambda o: algo.actor.apply(ap, o)[0])
    tenv, actor, _ = batch_eval.load(CKPT, N, OFF, device="cpu")
    ts, tobs = batch_eval.start_episodes(tenv)
    return jenv, jstep, jact, js, jobs, tenv, actor, ts, tobs


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _close(a, b, atol, what):
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=atol, err_msg=what)


def _compare_states(js, ts):
    for f, tol in SIM_TOL.items():
        _close(getattr(js.sim, f), getattr(ts.sim, f), tol, f)
    cf = np.asarray(js.sim.contact_forces)
    _close(cf, ts.sim.contact_forces, 1e-4 * max(100.0, np.abs(cf).max()), "contact_forces")
    for f in ("episode_length", "motion_start_times", "motion_len", "action_delay_idx", "push_counter"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)
    for f in ("actions", "last_actions", "torques", "default_dof_pos", "kp_scale", "rao_scale"):
        _close(getattr(js, f), getattr(ts, f), 2e-3 * max(1.0, float(np.abs(np.asarray(getattr(js, f))).max())), f)
    for f in ("contacts", "contacts_filt", "feet_air_time", "average_episode_length",
              "reward_penalty_scale", "motion_far_threshold", "soft_dof_pos_limit", "sigma_values",
              "sigma_ema"):
        _close(getattr(js, f), getattr(ts, f), 1e-5, f)
    assert sorted(js.history) == sorted(ts.history)
    for k in js.history:
        _close(js.history[k], ts.history[k], 2e-3, f"history/{k}")


def test_first_observations(envs):
    _, _, _, js, jobs, _, _, ts, tobs = envs
    for g in ("actor_obs", "critic_obs"):
        assert tuple(tobs[g].shape) == jobs[g].shape
        _close(jobs[g], tobs[g], 1e-5, g)
    _compare_states(js, ts)


def test_one_env_step(envs):
    jenv, jstep, _, js, _, tenv, _, ts, _ = envs
    acts = (0.3 * np.random.default_rng(0).normal(size=(N, tenv.nd))).astype(np.float32)
    js, jobs, jrew, jdone, jinfo = jstep(js, jax.numpy.asarray(acts))
    ts, tobs, trew, tdone, tinfo = tenv.step(ts, torch.as_tensor(acts))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(tinfo["time_outs"].numpy(), np.asarray(jinfo["time_outs"]))
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=1e-4, atol=1e-6)
    for g in ("actor_obs", "critic_obs"):
        _close(jobs[g], tobs[g], 2e-3, g)
    _compare_states(js, ts)
    assert set(tinfo["log"]) == set(jinfo["log"])
    for k, v in jinfo["log"].items():
        np.testing.assert_allclose(float(tinfo["log"][k]), float(v), rtol=1e-3, atol=1e-6, err_msg=k)


def test_serving_path_first_ten_steps(envs):
    """Reset to clip start, first observations, actor mean actions: the loop of
    `episode_ratio`, driven for 10 control steps in both packages."""
    _, jstep, jact, js, jobs, tenv, actor, ts, tobs = envs
    for i in range(10):
        ja = jact(jobs["actor_obs"])
        with torch.no_grad():
            ta, _ = actor(tobs["actor_obs"])
        _close(ja, ta, 2e-3, f"actions step {i}")
        js, jobs, jrew, jdone, jinfo = jstep(js, ja)
        ts, tobs, trew, tdone, tinfo = tenv.step(ts, ta)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone), err_msg=f"done step {i}")
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=1e-3, atol=1e-5)
    _compare_states(js, ts)
    _close(jobs["actor_obs"], tobs["actor_obs"], 2e-3, "actor_obs")
