"""Port parity: the benchmark suite (`pbhc_tpu_torch.eval.benchmarks`)
against `pbhc_tpu.eval.benchmarks`, at N = 4 envs on the CPU.

For configs 2-5 the composed config and the env's obs dims equal JAX's, and
3 control steps of zero actions (`_env_rollout`, the loop the suite times)
sum to JAX's reward within a relative 1e-3 (the per-step reward bound of
tests/test_torch_env.py; the sum of 3 steps x 4 envs does not widen it
since every term has one sign and one scale). Both envs start from the
same state: randomness off (tests/test_torch_env.py::OFF, its KungfuBot2
twin for configs 4-5), every env at its clip's start, with the same motion
ids. Config 4 tracks three 23-DoF clips, merged by each package's `merge`,
with the 29-DoF model: its motion library is held to JAX's first (clips,
frame counts, DoF order and values). Each config's JSON line has JAX's
keys, names and units; config 1 runs here (MuJoCo is installed) and raises
`ModuleNotFoundError` where MuJoCo is missing.
"""
import dataclasses
import importlib
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu.config.loader import compose as jax_compose  # noqa: E402
from pbhc_tpu.eval import benchmarks as jbench  # noqa: E402
from pbhc_tpu.motion.package import merge as jax_merge  # noqa: E402
from pbhc_tpu_torch.eval import benchmarks as bench  # noqa: E402
from pbhc_tpu_torch.motion.package import merge  # noqa: E402

N = 4
STEPS = 3
RTOL = 1e-3
OFF = ["domain_rand.push_robots=false", "domain_rand.randomize_torque_rfi=false",
       "domain_rand.use_rao=false", "domain_rand.randomize_ctrl_delay=false",
       "domain_rand.randomize_pd_gain=false", "domain_rand.randomize_rfi_lim=false",
       "domain_rand.randomize_link_mass=false", "domain_rand.randomize_link_inertia=false",
       "domain_rand.randomize_base_com=false", "domain_rand.randomize_friction=false",
       "obs.noise_scales.base_ang_vel=0", "obs.noise_scales.dof_pos=0", "obs.noise_scales.dof_vel=0"]
OFF_V1 = OFF + ["obs.noise_scales.projected_gravity=0"]
OFF_KB2 = OFF + ["obs.noise_scales.roll_pitch=0"]
CONFIGS = {"2": (bench.V1, bench.WALK, OFF_V1), "3": (bench.V1, bench.PUNCH, OFF_V1),
           "4": (bench.KB2_29, None, OFF_KB2), "5": (bench.KB2_29, bench.WALK29, OFF_KB2)}
NAMES = {"2": "bench_walk64", "3": "bench_punch4096", "4": "bench_kb2", "5": "bench_dr29"}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Config 4's library, merged by each package (JAX's env reads JAX's)."""
    d = tmp_path_factory.mktemp("kb2")
    clips = [bench.POSE, bench.PUNCH, bench.KICK]
    return str(jax_merge(d / "jax.pkl", clips)), str(merge(d / "port.pkl", clips))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request, libs):
    """(config, JAX env, port env) at N envs with randomness off."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PBHC_MOTION_CACHE", "0")
    key = request.param
    sels, motion, off = CONFIGS[key]
    jmotion, tmotion = libs if key == "4" else (motion, motion)
    jcfg = jax_compose(str(bench.REPO_ROOT / "pbhc_tpu" / "config"), sels,
                       [f"robot.motion.motion_file={jmotion}", *off, f"num_envs={N}"])
    mod, cls = jcfg.env.target.rsplit(".", 1)
    jenv = getattr(importlib.import_module(mod), cls)(jcfg, N, jax.random.PRNGKey(0))
    tenv = bench.make_env(sels, [f"robot.motion.motion_file={tmotion}", *off], N, device="cpu")
    yield key, jenv, tenv
    mp.undo()


def test_config_and_obs_dims_match_jax(pair):
    key, jenv, tenv = pair
    cfg = json.loads(json.dumps(tenv.config))
    want = json.loads(json.dumps(jenv.config))
    if key == "4":       # each env read its own package's merged library
        cfg["robot"]["motion"].pop("motion_file"), want["robot"]["motion"].pop("motion_file")
    assert cfg == want
    groups = sorted(jenv.config.obs.obs_dict)
    assert groups == sorted(tenv.config.obs.obs_dict)
    assert [tenv.obs_dim(g) for g in groups] == [jenv.obs_dim(g) for g in groups]
    assert (tenv.nd, tenv.num_envs) == (jenv.nd, N) and tenv.nd == (23 if key in "23" else 29)


@pytest.mark.parametrize("pair", ["4"], indirect=True)
def test_merged_23dof_library_on_29dof_model_matches_jax(pair):
    """Config 4: three 23-DoF clips tracked by the 29-DoF model."""
    _, jenv, tenv = pair
    jd, td = jenv.motion_lib.data, tenv.motion_lib.data
    assert tenv.motion_lib.num_unique == jenv.motion_lib.num_unique == 3
    np.testing.assert_array_equal(td.num_frames.numpy(), np.asarray(jd.num_frames))
    np.testing.assert_array_equal(td.length_starts.numpy(), np.asarray(jd.length_starts))
    assert td.dof_pos.shape == jd.dof_pos.shape and td.dof_pos.shape[1] == 29
    np.testing.assert_allclose(td.dof_pos.numpy(), np.asarray(jd.dof_pos), atol=1e-6)
    np.testing.assert_allclose(td.gts.numpy(), np.asarray(jd.gts), atol=1e-5)


def test_env_rollout_reward_matches_jax(pair):
    key, jenv, tenv = pair
    ids = np.arange(N) % jenv.motion_lib.num_unique
    js = dataclasses.replace(jenv.init_state(jax.random.PRNGKey(1)), motion_ids=jnp.asarray(ids, jnp.int32))
    js = jenv.reset_to_start(js, jax.random.PRNGKey(1))
    ts = dataclasses.replace(tenv.init_state(), motion_ids=torch.as_tensor(ids))
    ts = tenv.reset_to_start(ts)
    step = jax.jit(jenv.step)
    zeros = jnp.zeros((N, jenv.nd))
    rewards = []
    for _ in range(STEPS):
        js, _, rew, _, _ = step(js, zeros)
        rewards.append(float(rew.sum()))
    ts, total = bench._env_rollout(tenv, ts, STEPS)
    assert total.shape == () and np.isfinite(float(total))
    np.testing.assert_allclose(float(total), sum(rewards), rtol=RTOL)
    np.testing.assert_allclose(ts.sim.root_pos.numpy(), np.asarray(js.sim.root_pos), atol=1e-4)


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_json_lines_have_jax_keys(key, monkeypatch, capsys):
    """Each config's line and result, the env cut to N envs and 2 + 2 steps;
    JAX's with its timed rollout replaced by a constant."""
    real = bench._env_throughput
    monkeypatch.setattr(bench, "_env_throughput",
                        lambda sels, ovs, n, steps=30, device="cuda": real(sels, ovs, N, 2, device))
    monkeypatch.setattr(jbench, "_env_throughput", lambda *a, **k: 1.0)
    (res,) = bench.main([key], device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = getattr(jbench, NAMES[key])()
    assert list(line) == list(want) == list(bench.KEYS)
    assert {k: line[k] for k in ("config", "metric", "unit")} == {k: want[k] for k in ("config", "metric", "unit")}
    assert line == {k: res[k] for k in bench.KEYS} and line["value"] > 0
    detail = res["detail"]
    assert detail["steps"] == detail["warmup_steps"] == 2 and detail["num_envs"] == N
    assert all(np.isfinite(detail["reward_sums"]))
    if key == "4":
        assert detail["library_clips"] == detail["num_unique"] == 3


def test_deploy_config_runs_here(capsys):
    pytest.importorskip("mujoco")
    (res,) = bench.main(["1", "device=cpu"])
    line = json.loads(capsys.readouterr().out.strip())
    assert list(line) == list(bench.KEYS)
    assert line["config"] == "1-deploy-mujoco" and line["metric"] == "control_steps_per_sec"
    assert np.isfinite(res["detail"]["seconds"]) and line["value"] > 0
    assert line["unit"].startswith("50Hz-steps/s (realtime x")


def test_deploy_config_raises_without_mujoco(monkeypatch):
    monkeypatch.setitem(sys.modules, "mujoco", None)
    with pytest.raises(ModuleNotFoundError, match="mujoco"):
        bench.bench_deploy("cpu")
    with pytest.raises(ModuleNotFoundError, match="mujoco"):
        bench.main(["all"], device="cpu")
