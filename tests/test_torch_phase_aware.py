"""Port parity: the phase-aware MHPPO networks (`PhaseEmbed`,
`PhaseAwareActor`, `PhaseAwareCritic`, both embedding types), their flax
conversion, one MHPPO minibatch update with them, and a run the port's
training CLI writes with them, against `pbhc_tpu` on the CPU.

The networks are the v1 training config's widths behind the embedding
(`algo.config.phase_embed`, dim 16), placed where `obs_key_slices` puts
`ref_motion_phase` in each obs group (N = 64). Flax initialises them; inputs
come from a numpy seed, with a phase in [0, 1.05] at the phase's slot.

Tolerances: outputs 1e-5 absolute, the weights written back by
`flax_params` exactly; the minibatch update as tests/test_torch_ppo.py holds
it (params 1e-5, losses 1e-5 relative, the adaptive lr exactly, after one
shared Adam step); the trained run's checkpoint read by the JAX package equal
to the port's weights bit for bit, and its actor's outputs there 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu.agents.mh_ppo import MHPPO as JaxMHPPO  # noqa: E402
from pbhc_tpu.config.loader import compose as jax_compose  # noqa: E402
from pbhc_tpu.envs.tracking_env import MotionTrackingEnv as JaxEnv  # noqa: E402
from pbhc_tpu.deploy.export import export_policy as jax_export_policy  # noqa: E402
from pbhc_tpu.eval import batch_eval as jax_batch_eval  # noqa: E402
from pbhc_tpu_torch import eval_agent, train  # noqa: E402
from pbhc_tpu_torch.agents import convert  # noqa: E402
from pbhc_tpu_torch.agents.mh_ppo import MHPPO  # noqa: E402
from pbhc_tpu_torch.agents.networks import PhaseAwareActor, PhaseAwareCritic, PhaseEmbed  # noqa: E402
from pbhc_tpu_torch.config.loader import compose  # noqa: E402
from pbhc_tpu_torch.deploy.export import export_policy  # noqa: E402
from pbhc_tpu_torch.envs.tracking_env import MotionTrackingEnv  # noqa: E402
from pbhc_tpu_torch.eval import batch_eval  # noqa: E402
from test_torch_ppo import _assert_tree_close, _params, _primed, _samples  # noqa: E402

N = 64
SELS = ["exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking", "rewards=motion_tracking",
        "domain_rand=main", "simulator=tpu"]
OVS = [f"num_envs={N}", "robot.motion.motion_file=assets/motions/Horse-stance_punch.pkl"]
TYPES = ["Sinusoidal", "Learnable"]


@pytest.fixture(scope="module")
def envs():
    return (JaxEnv(jax_compose("pbhc_tpu/config", SELS, OVS), N, jax.random.PRNGKey(0)),
            MotionTrackingEnv(compose(SELS, OVS), N, device="cpu"))


def _algos(envs, kind):
    ovs = OVS + [f"algo.config.phase_embed.type={kind}"]
    jenv, tenv = envs
    cfg = compose(SELS, ovs + ["device=cpu"])
    return JaxMHPPO(jax_compose("pbhc_tpu/config", SELS, ovs), jenv), MHPPO(cfg, tenv), cfg


def _obs(dim, pos, rng, n=256):
    obs = rng.normal(size=(n, dim)).astype(np.float32)
    obs[:, pos] = rng.uniform(0.0, 1.05, size=n)
    return obs


@pytest.mark.parametrize("kind", TYPES)
def test_phase_aware_networks_match_flax(envs, kind):
    jalgo, talgo, cfg = _algos(envs, kind)
    assert talgo.phase_pos == {g: jalgo.env.obs_key_slices(g)["ref_motion_phase"][0]
                               for g in ("actor_obs", "critic_obs")}
    ap, cp = _params(jalgo, seed=4)
    fresh = talgo.init_train_state()
    actor, critic = fresh.actor, fresh.critic
    assert isinstance(actor, PhaseAwareActor) and isinstance(critic, PhaseAwareCritic)
    actor, critic = convert.from_flax(ap, actor), convert.from_flax(cp, critic)
    _assert_tree_close(convert.flax_params(actor), ap, 0, "actor")
    _assert_tree_close(convert.flax_params(critic), cp, 0, "critic")
    assert ("PhaseEmbed_0" in ap["params"]) == (kind == "Learnable")
    rng = np.random.default_rng(5)
    aobs = _obs(talgo.actor_dim, talgo.phase_pos["actor_obs"], rng)
    cobs = _obs(talgo.critic_dim, talgo.phase_pos["critic_obs"], rng)
    jm, js = jalgo.actor.apply(ap, jnp.asarray(aobs))
    with torch.no_grad():
        tm, tsd = actor(torch.as_tensor(aobs))
        tv = critic(torch.as_tensor(cobs))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_array_equal(tsd.numpy(), np.asarray(js))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jalgo.critic.apply(cp, jnp.asarray(cobs))), atol=1e-5)


def test_phase_embed_of_the_phase_slot():
    """The sinusoidal embedding: [sin(2^k pi p), cos(2^k pi p)], k < dim // 2."""
    p = torch.tensor([[0.0], [0.25], [1.0]])
    emb = PhaseEmbed("Sinusoidal", 6)(p)
    k = torch.arange(3)
    want = torch.cat([torch.sin(p * 2.0 ** k * torch.pi), torch.cos(p * 2.0 ** k * torch.pi)], -1)
    assert emb.shape == (3, 6) and torch.allclose(emb, want, atol=1e-6)
    with pytest.raises(ValueError, match="phase_embed"):
        PhaseEmbed("Fourier")


@pytest.mark.parametrize("kind", TYPES)
def test_phase_aware_minibatch_update_matches_optax(envs, kind):
    jalgo, talgo, cfg = _algos(envs, kind)
    ap, cp = _params(jalgo, seed=6)
    (ap, cp, aopt, copt), ts = _primed(jalgo, talgo, cfg, ap, cp, 6)
    rng = np.random.default_rng(6)
    batch = _samples(jalgo, ap, (2048,), rng, 0.1)
    batch["actor_obs"][:, talgo.phase_pos["actor_obs"]] = rng.uniform(0.0, 1.05, size=2048)
    batch["critic_obs"][:, talgo.phase_pos["critic_obs"]] = rng.uniform(0.0, 1.05, size=2048)
    carry = (ap, cp, aopt, copt, jnp.asarray(1e-3, jnp.float32))
    (jap, jcp, _, _, jlr), jm = jax.jit(jalgo._minibatch_update)(carry, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = talgo._minibatch_update(ts, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert float(ts.lr) == float(jlr)
    for k in ("surrogate", "value_loss", "entropy", "kl"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    _assert_tree_close(convert.flax_params(ts.actor), jap, 1e-5, "actor")
    _assert_tree_close(convert.flax_params(ts.critic), jcp, 1e-5, "critic")


def test_phase_aware_run_scored_by_both_batch_evals(tmp_path):
    """2 training iterations of a learnable phase embedding at 32 envs (4
    steps each): both packages' `batch_eval` read the run; the JAX package's
    actor on the checkpoint is the port's, both packages export it to the
    same ONNX bytes, and the port's `eval_agent` scores and exports it."""
    _, ts, logs = train.main([*SELS, "num_envs=32", OVS[1], "algo.config.num_learning_iterations=2",
                              "algo.config.num_steps_per_env=4", "algo.config.phase_embed.type=Learnable",
                              "device=cpu", f"base_dir={tmp_path}"])
    assert ts.iteration == 2 and logs and all(np.isfinite(v) for x in logs for v in x.values())
    (run_dir,) = (tmp_path / "PBHC_TPU").iterdir()
    ckpt = run_dir / "ckpt" / "model_2.pkl"
    env, actor, _ = batch_eval.load(ckpt, 16, device="cpu")
    assert isinstance(actor, PhaseAwareActor)
    state, obs = batch_eval.start_episodes(env)
    state, first, nonfinite = batch_eval.rollout_ratio(env, actor, state, obs, 3)
    assert int(nonfinite) == 0
    jenv, jalgo, payload = jax_batch_eval._load(ckpt, 16)
    assert type(jalgo.actor).__name__ == "PhaseAwareActor"
    want = jax.tree_util.tree_flatten_with_path(convert.flax_params(ts.actor))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(payload["actor_params"])[0])
    for path, v in want:
        np.testing.assert_array_equal(np.asarray(got[path]), v)
    aobs = obs["actor_obs"].numpy()
    with torch.no_grad():
        np.testing.assert_allclose(actor(obs["actor_obs"])[0].numpy(),
                                   np.asarray(jalgo.actor.apply(payload["actor_params"], jnp.asarray(aobs))[0]),
                                   atol=1e-5)
    paths = [export_policy(actor, payload["actor_params"], env, tmp_path / "port" / "m.npz"),
             jax_export_policy(payload["actor_params"], jenv, tmp_path / "jax" / "m.npz", actor=jalgo.actor)]
    onnx = [p.with_suffix(".onnx").read_bytes() for p in paths]
    assert onnx[0] == onnx[1] and len(onnx[0]) > 1000
    res = eval_agent.main([f"checkpoint={ckpt}", "device=cpu"])
    assert 0 < res["completion_ratio"] <= 1.0 and np.isfinite(res["accuracy"]["E_mpjpe"])
    assert (run_dir / "exported" / "model_2.onnx").read_bytes() == onnx[0]
