"""Port parity: env-axis data parallelism (`pbhc_tpu_torch/parallel/`) on two
`gloo` ranks on the CPU, against the JAX package's update on the whole
trajectory and against the port's one-rank run.

The ranks are spawned by `parallel/mesh.run_ranks` (a file store under the
test's temp dir, one thread each, a timeout) and run the scenarios of
`tests/torch_parallel_workers.py`; one spawn serves every test but the
dry run's, which spawns its own.

- MHPPO: a fixed [T=4, N=32] trajectory split by env (16 per rank), from a
  primed optimizer state (tests/test_torch_ppo.py's `_primed`), 5 epochs x 4
  minibatches with JAX's permutations: params atol 1e-5 and the log's losses
  rtol 1e-4 against JAX's update phase on the whole trajectory, the lr exactly
  (the bounds tests/test_torch_ppo.py holds the one-process port to).
- PPOMimic with MoE actor and critic (load-balance weight 1.0, so that the
  load balance moves the gate), RL + DAgger, and distillation from the
  committed teacher, on [T=4, N=16] trajectories: params atol 1e-5 against
  the one-rank port (which tests/test_torch_ppo_mimic.py and
  tests/test_torch_moe.py hold to JAX), the lr exactly; and averaging the
  ranks' local load-balance losses instead misses that bound.
- The env: 12 control steps of 2 x 4 envs against 1 x 8 over a merged
  three-clip library, with adaptive sigma, the penalty and motion-far
  curricula and adaptive motion sampling on, randomness off as in
  tests/test_torch_env.py and the reset's draws injected as functions of the
  global env index: done flags exactly, the replicated scalars and the step
  logs of the replicated state to 1e-5 relative (global sums in another
  order), the reward logs to 1e-5 of the mean of the ranks' own rewards.
"""
import concurrent.futures
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import torch_parallel_workers as W  # noqa: E402
from pbhc_tpu.agents.mh_ppo import MHPPO as JaxMHPPO  # noqa: E402
from pbhc_tpu.config.loader import compose as jax_compose  # noqa: E402
from pbhc_tpu.envs.tracking_env import MotionTrackingEnv as JaxEnv  # noqa: E402
from pbhc_tpu.utils.checkpoint import load_checkpoint_payload as jax_load  # noqa: E402
from pbhc_tpu_torch.agents import convert  # noqa: E402
from pbhc_tpu_torch.agents.mh_ppo import MHPPO  # noqa: E402
from pbhc_tpu_torch.config.loader import compose  # noqa: E402
from pbhc_tpu_torch.envs.tracking_env import MotionTrackingEnv  # noqa: E402
from pbhc_tpu_torch.motion import package  # noqa: E402
from pbhc_tpu_torch.parallel import dryrun  # noqa: E402
from pbhc_tpu_torch.parallel.mesh import EnvShard, run_ranks  # noqa: E402
from test_torch_ppo import _primed, _samples  # noqa: E402

WORLD = 2
PPO_N, PPO_T = 32, 4
PPO_OVS = [f"num_envs={PPO_N}", "robot.motion.motion_file=assets/motions/Horse-stance_punch.pkl",
           f"algo.config.num_steps_per_env={PPO_T}"]
MIMIC_N, MIMIC_T = 16, 4
MOE = ["algo.config.module_dict.actor.layer_config.type=MoEMLP",
       "algo.config.module_dict.critic.layer_config.type=MoEMLP", "algo.config.load_balancing_loss_alpha=1.0",
       "algo.config.dagger_only=false", "algo.config.num_learning_epochs=2"]
ENV_N, ENV_K = 8, 12
CLIPS = ["Horse-stance_pose", "Side_kick", "Hooks_punch"]
OFF = ["domain_rand.push_robots=false", "domain_rand.randomize_torque_rfi=false",
       "domain_rand.use_rao=false", "domain_rand.randomize_ctrl_delay=false",
       "domain_rand.randomize_pd_gain=false", "domain_rand.randomize_rfi_lim=false",
       "domain_rand.randomize_link_mass=false", "domain_rand.randomize_link_inertia=false",
       "domain_rand.randomize_base_com=false", "domain_rand.randomize_friction=false",
       "obs.noise_scales.base_ang_vel=0", "obs.noise_scales.dof_pos=0",
       "obs.noise_scales.dof_vel=0", "obs.noise_scales.projected_gravity=0"]
TRAIN = ["num_envs=8", "robot.motion.motion_file=assets/motions/Horse-stance_pose.pkl",
         "algo.config.num_steps_per_env=3", "algo.config.num_learning_iterations=2",
         "algo.config.logging_interval=5", "device=cpu"]


def _assert_tree_close(got, want, atol, what):
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want)
    for path, v in flat_got:
        np.testing.assert_allclose(v, np.asarray(flat_want[path]), atol=atol,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _tree_diff(a, b):
    return max(float(np.abs(x - np.asarray(y)).max()) for (_, x), (_, y) in
               zip(jax.tree_util.tree_flatten_with_path(a)[0], jax.tree_util.tree_flatten_with_path(b)[0]))


# ---------------------------------------------------------------- inputs
def _mhppo_inputs():
    """The port's inputs, and a function that runs JAX's update phase on the
    whole trajectory."""
    jax_cfg = jax_compose("pbhc_tpu/config", W.V1, PPO_OVS)
    jalgo = JaxMHPPO(jax_cfg, JaxEnv(jax_cfg, PPO_N, jax.random.PRNGKey(0)))
    cfg = compose(W.V1, PPO_OVS + ["device=cpu"])
    talgo = MHPPO(cfg, MotionTrackingEnv(cfg, PPO_N, device="cpu"))
    ka, kc = jax.random.split(jax.random.PRNGKey(3))
    ap = jax.tree.map(np.asarray, jalgo.actor.init(ka, jnp.zeros((1, jalgo.actor_dim))))
    cp = jax.tree.map(np.asarray, jalgo.critic.init(kc, jnp.zeros((1, jalgo.critic_dim))))
    (ap, cp, aopt, copt), ts = _primed(jalgo, talgo, cfg, ap, cp, 3)
    rng = np.random.default_rng(3)
    traj = _samples(jalgo, ap, (PPO_T, PPO_N), rng, 0.05)
    for k in ("returns", "advantages"):
        del traj[k]
    last_obs = {"critic_obs": rng.normal(size=(PPO_N, jalgo.critic_dim)).astype(np.float32)}
    key = jax.random.PRNGKey(7)
    # JAX's permutations: train_iteration splits the rollout's key once, then
    # once per epoch (`mh_ppo.py:250-255`)
    rk, _ = jax.random.split(key)
    perms = []
    for _ in range(jalgo.num_epochs):
        rk, kp = jax.random.split(rk)
        perms.append(np.asarray(jax.random.permutation(kp, PPO_T * PPO_N)))

    def jax_update():
        jts = jalgo.init_train_state(jax.random.PRNGKey(0))
        jts = dataclasses.replace(jts, actor_params=ap, critic_params=cp, actor_opt=aopt, critic_opt=copt)
        jtraj = {k: jnp.asarray(v) for k, v in traj.items()}
        jalgo._rollout = lambda ts: (ts.env_state, ts.obs | {"critic_obs": jnp.asarray(last_obs["critic_obs"])},
                                     key, jtraj, {"x": jnp.zeros(PPO_T)})
        jts, jlog = jalgo.train_iteration(jts)
        return jts, {k: float(v) for k, v in jlog.items()}

    state = {"actor": convert.flax_params(ts.actor), "critic": convert.flax_params(ts.critic),
             "actor_opt": ts.actor_opt.state_dict(), "critic_opt": ts.critic_opt.state_dict(), "lr": float(ts.lr)}
    return jax_update, dict(ovs=PPO_OVS, state=state, traj=traj, last_obs=last_obs, perms=perms)


def _mimic_inputs(run, extra, hist_encoding, seed):
    algo, ts = W.mimic_algo(run, extra, MIMIC_N, seed)
    traj, last = W.mimic_traj(algo, ts, MIMIC_T, np.random.default_rng(seed))
    perms = [np.random.default_rng(seed + 10 + e).permutation(MIMIC_T * MIMIC_N) for e in range(algo.num_epochs)]
    return dict(run=run, extra=extra, num_envs=MIMIC_N, seed=seed, traj=traj, last_obs=last, perms=perms,
                hist_encoding=hist_encoding)


def _env_ovs(library):
    return [f"num_envs={ENV_N}", f"robot.motion.motion_file={library}", *OFF,
            "env.config.adaptive_motion_sampling.enabled=true",
            "env.config.termination_curriculum.terminate_when_motion_far_initial_threshold=0.3"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-rank references and the two ranks' results of every scenario."""
    tmp = tmp_path_factory.mktemp("parallel")
    library = package.merge(tmp / "library.pkl", [f"assets/motions/{c}.pkl" for c in CLIPS])
    jax_update, mhppo = _mhppo_inputs()
    moe = _mimic_inputs("kb2_teacher23_r3", MOE, True, 5)
    distill = _mimic_inputs("kb2_student23_r3", [f"algo.config.teacher_model_path={W.TEACHER}"], True, 6)
    actions = (0.4 * np.random.default_rng(8).normal(size=(ENV_K, ENV_N, 23))).astype(np.float32)
    env = dict(ovs=_env_ovs(library), actions=actions)
    base = tmp / "train"
    train = dict(argv=[*W.V1, *TRAIN, f"base_dir={base}", f"artifact_dir={base}/artifacts"], base_dir=str(base))
    spec = [("mhppo_learn", mhppo), ("mimic_learn", moe), ("mimic_learn:avg", dict(moe, average_local_lb=True)),
            ("mimic_learn:distill", distill), ("env_scalars", env), ("draws", dict(num_envs=8)),
            ("train_main", train)]
    # the ranks run while this process computes the references
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, W.rank_main, WORLD, (spec,), store_dir=tmp, timeout=300, threads=1)
        jax_ref = jax_update()
        one = {"mimic_learn": W.mimic_learn(**moe), "mimic_learn:distill": W.mimic_learn(**distill),
               "env_scalars": W.env_scalars(**env)}
        return jax_ref, one, ranks.result()


def test_mhppo_two_ranks_match_jax_update_on_the_whole_trajectory(runs):
    (jts, jlog), _, ranks = runs
    for r, res in enumerate(r["mhppo_learn"] for r in ranks):
        assert res["lr"] == jlog["Loss/lr"], r
        for k in ("Train/mean_step_reward", "Loss/surrogate", "Loss/value", "Loss/entropy", "Loss/kl"):
            np.testing.assert_allclose(res["log"][k], jlog[k], rtol=1e-4, atol=1e-6, err_msg=f"rank {r} {k}")
        _assert_tree_close(res["actor"], jts.actor_params, 1e-5, f"rank {r} actor")
        _assert_tree_close(res["critic"], jts.critic_params, 1e-5, f"rank {r} critic")


@pytest.mark.parametrize("scenario", ["mimic_learn", "mimic_learn:distill"])
def test_ppo_mimic_two_ranks_match_one_rank(runs, scenario):
    """MoE RL + DAgger, and distillation: both ranks hold the one-rank params."""
    _, one, ranks = runs
    want = one[scenario]
    for r, res in enumerate(x[scenario] for x in ranks):
        assert res["lr"] == want["lr"], r
        _assert_tree_close(res["net"], want["net"], 1e-5, f"rank {r} {scenario}")
        for k, v in want["log"].items():
            np.testing.assert_allclose(res["log"][k], v, rtol=1e-4, atol=1e-6, err_msg=f"rank {r} {k}")
    if scenario == "mimic_learn":
        assert "Loss/load_balancing" in want["log"] and "Loss/hist_latent" in want["log"]


def test_averaging_local_load_balance_losses_misses_the_bound(runs):
    """The check above is sensitive to the MoE loss: averaging the ranks' own
    load-balance losses (local f and P) moves the params past its 1e-5."""
    _, one, ranks = runs
    assert _tree_diff(ranks[0]["mimic_learn:avg"]["net"], one["mimic_learn"]["net"]) > 1e-5


def test_env_replicated_scalars_two_ranks_match_one_rank(runs):
    _, one, ranks = runs
    want = one["env_scalars"]
    assert want["num_unique"] == len(CLIPS)
    dones = np.stack(want["dones"])
    # the scalars are exercised: resets by failure and by the clip's end, every step
    assert dones.sum() >= ENV_N and dones.any(1).mean() > 0.5
    got_dones = np.concatenate([np.stack(r["env_scalars"]["dones"]) for r in ranks], axis=1)
    np.testing.assert_array_equal(got_dones, dones)
    for k in range(ENV_K):
        rewards = np.concatenate([r["env_scalars"]["rewards"][k] for r in ranks])     # [N, R]
        for r, res in enumerate(x["env_scalars"] for x in ranks):
            for name, v in want["scalars"][k].items():
                np.testing.assert_allclose(res["scalars"][k][name], v, rtol=1e-5, atol=1e-7,
                                           err_msg=f"step {k} rank {r} {name}")
            assert res["logs"][k].keys() == want["logs"][k].keys()
            for name, v in want["logs"][k].items():
                if not name.startswith("rew_"):
                    np.testing.assert_allclose(res["logs"][k][name], v, rtol=1e-5, atol=1e-6,
                                               err_msg=f"step {k} rank {r} log {name}")
            # the reward logs are the means over both ranks' envs of the
            # rewards the ranks computed (the envs' own rewards part from the
            # one-rank run's at a contact event, through the engine's f32
            # rounding, which depends on the batch width)
            got = np.asarray([v for name, v in res["logs"][k].items() if name.startswith("rew_")])
            np.testing.assert_allclose(got, rewards.mean(0), rtol=1e-5, atol=1e-7, err_msg=f"step {k} rank {r}")
    assert not np.allclose(want["scalars"][-1]["motion_fail_ema"], 0.0)
    assert want["scalars"][-1]["average_episode_length"] > 0


def test_per_rank_draws_differ_and_permutations_agree(runs):
    _, _, ranks = runs
    a, b = (r["draws"] for r in ranks)
    np.testing.assert_array_equal(a["perm"], b["perm"])
    np.testing.assert_array_equal(a["env_shared"], b["env_shared"])
    assert not np.array_equal(a["env"], b["env"]) and not np.array_equal(a["actions"], b["actions"])
    # a single process: the learner's one generator seeded seed + 1, as before
    one = W.draws(8)
    gen = torch.Generator().manual_seed(1)
    np.testing.assert_array_equal(one["actions"], torch.randn(8, generator=gen).numpy())
    np.testing.assert_array_equal(one["perm"], torch.randperm(64, generator=gen).numpy())


def test_env_shard_layout_and_single_process_reductions():
    shard = EnvShard(8, world=2, rank=1, group=object())     # the layout needs no collective
    assert (shard.local_envs, shard.offset) == (4, 4)
    idx = torch.tensor([9, 4, 12, 3, 7])                    # t * 8 + env
    assert shard.local_rows(idx).tolist() == [0, 4, 3]      # t * 4 + env - 4 for envs 4..7
    with pytest.raises(ValueError):
        EnvShard(6, world=4)
    one = EnvShard(8)
    idx = torch.tensor([3, 17, 9])
    assert one.local_rows(idx) is idx
    x = torch.arange(6.0)
    assert one.all_sum([x])[0] is x
    m, s = one.mean_std(x)
    assert float(m) == float(x.mean()) and float(s) == float(x.std(correction=0))
    gen, shared = one.generators(3, "cpu")
    assert gen is shared


def test_two_rank_train_cli_writes_one_rank_checkpoint(runs):
    """Rank 0 alone writes the run; the ranks stay bit-identical; the
    checkpoint has the one-rank layout and loads in the JAX package."""
    _, _, ranks = runs
    r0, r1 = (r["train_main"] for r in ranks)
    assert r1["ckpts"] == [] or r1["ckpts"] == r0["ckpts"]
    assert [os.path.basename(p) for p in r0["ckpts"] if "artifacts" not in p] == ["model_2.pkl"]
    assert r0["checksum"] == r1["checksum"]
    assert [x["replica_checksum"] for x in r0["logs"]] == [x["replica_checksum"] for x in r1["logs"]]
    assert all(np.isfinite(v) for x in r0["logs"] for v in x.values())
    _assert_tree_close(r1["params"], r0["params"], 0.0, "rank 1 vs rank 0")
    ckpt = next(p for p in r0["ckpts"] if "artifacts" not in p)
    payload = jax_load(ckpt)
    assert payload["iteration"] == 2
    _assert_tree_close(payload["actor_params"], r0["params"], 0.0, "checkpoint")
    run_dir = os.path.dirname(os.path.dirname(ckpt))
    assert json.loads(open(os.path.join(run_dir, "config.json")).read())["num_envs"] == 8


def test_run_ranks_raises_a_ranks_error(tmp_path):
    import torch.multiprocessing as mp

    with pytest.raises(mp.ProcessRaisedException, match="rank 1 fails"):
        run_ranks(W.fail_on_rank_1, WORLD, store_dir=tmp_path, timeout=60, threads=1)


def test_dryrun_multichip_two_ranks(capsys):
    reward = dryrun.dryrun_multichip(2, device="cpu", timeout=120)
    assert np.isfinite(reward)
    assert "dryrun_multichip(2, cpu, gloo): OK" in capsys.readouterr().out
