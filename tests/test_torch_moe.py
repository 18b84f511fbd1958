"""Port parity: the mixture-of-experts backbone (`MoEMLP`), the KungfuBot2
networks built on it and PPOMimic's load-balance aux loss, against
`pbhc_tpu` on the CPU.

The flax modules are initialised by flax from a seed and carried into the
port by `agents/convert.py`; `flax_params` must write them back bit for bit.
Inputs come from a numpy seed. The gate's probabilities then have no ties,
so `torch.topk` and `jax.lax.top_k` pick the same experts (they may order
equal probabilities differently); the gradient flows through the kept
probabilities and the mean gate probability, not through the one-hot
dispatch, in both packages.

Tolerances: outputs and the aux loss 1e-5 absolute per unit of the largest
value (f32 MLPs of 2-4 layers, one batched product per layer); gradients
1e-5 per unit of the largest gradient; the PPOMimic update as
tests/test_torch_ppo_mimic.py holds it (params 1e-5 absolute, losses 1e-5
relative, the adaptive lr exactly), after one shared Adam step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu.agents.mh_ppo import _set_lr  # noqa: E402
from pbhc_tpu.agents.mimic_networks import MimicActorCritic as FlaxMimic  # noqa: E402
from pbhc_tpu.agents.networks import Estimator as FlaxEstimator  # noqa: E402
from pbhc_tpu.agents.networks import MoEMLP as FlaxMoE  # noqa: E402
from pbhc_tpu.agents.ppo_mimic import PPOMimic as JaxPPOMimic  # noqa: E402
from pbhc_tpu.agents.ppo_mimic import build_mimic_net as jax_build  # noqa: E402
from pbhc_tpu_torch.agents import convert  # noqa: E402
from pbhc_tpu_torch.agents.mimic_networks import mimic_net_from_config  # noqa: E402
from pbhc_tpu_torch.agents.networks import Estimator, MoEMLP, flax_init_  # noqa: E402
from pbhc_tpu_torch.agents.ppo_mimic import OBS_KEYS, PPOMimic  # noqa: E402
from pbhc_tpu_torch.config.loader import Cfg, apply_overrides, load_snapshot  # noqa: E402
from pbhc_tpu_torch.envs.general_tracking_env import GeneralTrackingEnv  # noqa: E402
from pbhc_tpu_torch.envs.tracking_env import obs_width  # noqa: E402

MOE = ["algo.config.module_dict.actor.layer_config.type=MoEMLP",
       "algo.config.module_dict.critic.layer_config.type=MoEMLP",
       "algo.config.module_dict.actor.layer_config.hidden_dims=[64, 32]",
       "algo.config.module_dict.critic.layer_config.hidden_dims=[64, 32]"]
MOTION = "robot.motion.motion_file=assets/motions/g1_ue_walk_23dof.pkl"
N = 32


def _close(got, want, atol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=atol * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def _lb_sum(variables):
    """What `PPOMimic._apply_lb` sums: every sown load-balancing loss."""
    return sum(float(jnp.sum(x)) for x in jax.tree_util.tree_leaves(variables))


@pytest.mark.parametrize("experts,top_k,activation", [(4, 2, "ELU"), (3, 1, "SiLU"), (6, 3, "ReLU")])
def test_moe_mlp_matches_flax(experts, top_k, activation):
    rng = np.random.default_rng(experts)
    x = rng.normal(size=(64, 20)).astype(np.float32)
    fmod = FlaxMoE((32, 16), 7, experts, top_k, activation)
    params = fmod.init(jax.random.PRNGKey(experts), jnp.zeros((1, 20)))
    tmod = convert.from_flax(params, MoEMLP(20, (32, 16), 7, experts, top_k, activation))
    jout, jvars = jax.jit(lambda p, x: fmod.apply(p, x, mutable=["intermediates"]))(params, jnp.asarray(x))
    with torch.no_grad():
        tout, tlb = tmod(torch.as_tensor(x))
    _close(tout, jout, 1e-5, "output")
    assert float(tlb) == pytest.approx(_lb_sum(jvars), abs=1e-6)
    assert float(tlb) > 0
    # flax's stacked expert kernels [E, in, out], written back bit for bit
    back = convert.flax_params(tmod)["params"]
    assert back["experts"]["Dense_0"]["kernel"].shape == (experts, 20, 32)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                 jax.tree_util.tree_flatten_with_path(params["params"])[0]):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=jax.tree_util.keystr(path))

    # gradients of output + aux loss through the kept probabilities
    def jloss(p):
        out, v = fmod.apply(p, jnp.asarray(x), mutable=["intermediates"])
        return jnp.sum(out ** 2) * 1e-2 + sum(jnp.sum(t) for t in jax.tree_util.tree_leaves(v))

    jgrad = jax.jit(jax.grad(jloss))(params)
    tout, tlb = tmod(torch.as_tensor(x))
    (torch.sum(tout ** 2) * 1e-2 + tlb).backward()
    tgrad = convert.state_dict_from_flax(jgrad, tmod)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree_util.tree_leaves(jgrad))
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), tgrad[name].numpy(), atol=1e-5 * max(1.0, scale), err_msg=name)


def test_flax_init_draws_expert_kernels_at_lecun_scale():
    """`flax_init_` gives each stacked expert layer lecun_normal weights
    (fan_in = its input width) and zero biases, as flax's vmapped `Dense`."""
    net = flax_init_(MoEMLP(400, (256,), 8, num_experts=4), torch.Generator().manual_seed(0))
    w = net.experts[0].weight.detach()
    assert w.shape == (4, 400, 256) and float(w.std()) == pytest.approx((1 / 400) ** 0.5, rel=0.05)
    assert float(w.abs().max()) <= 2 * (1 / 400) ** 0.5 / 0.87962566 + 1e-6
    assert not net.experts[0].bias.detach().any()
    assert not torch.equal(w[0], w[1])                          # each expert its own draw


def test_estimator_matches_flax():
    x = np.random.default_rng(3).normal(size=(16, 30)).astype(np.float32)
    fmod = FlaxEstimator((32, 16), 3)
    params = fmod.init(jax.random.PRNGKey(3), jnp.zeros((1, 30)))
    tmod = convert.from_flax(params, Estimator(30, (32, 16), 3))
    _close(tmod(torch.as_tensor(x)).detach(), fmod.apply(params, jnp.asarray(x)), 1e-5)
    assert set(convert.flax_params(tmod)["params"]) == {"MLP_0"}


def _moe_cfg(extra=()):
    return Cfg.wrap(apply_overrides(load_snapshot("kb2_teacher23_r3"), [MOTION, f"num_envs={N}", *MOE, *extra]))


@pytest.fixture(scope="module")
def moe_nets():
    """A flax-initialised MoE `MimicActorCritic` on the 23-DoF teacher's
    widths, its port twin, and the port env's observations over 4 control
    steps (B = 128)."""
    cfg = _moe_cfg()
    o = cfg.obs
    jnet = jax_build(cfg.algo.config, 23, obs_width(o, "future_motion_targets"), int(o.future_num_steps),
                     obs_width(o, "prop_history"), int(o.history_length))
    env = GeneralTrackingEnv(cfg, N, device="cpu", seed=5)
    state = env.init_state()
    obs, state.history = env.compute_observations(state)
    params = jnet.init(jax.random.PRNGKey(5), {k: jnp.asarray(obs[k][:1].numpy()) for k in OBS_KEYS})
    params = jax.tree.map(np.asarray, params)
    tnet = convert.from_flax(params, mimic_net_from_config(cfg, 23))
    seen = []
    with torch.no_grad():
        for _ in range(4):
            seen.append({k: obs[k].numpy() for k in OBS_KEYS})
            state, obs, *_ = env.step(state, tnet.act(obs, True)[0])
    batch = {k: np.concatenate([s[k] for s in seen]) for k in OBS_KEYS}
    return cfg, env, jnet, params, tnet, batch


def test_moe_mimic_net_matches_flax(moe_nets):
    cfg, _, jnet, params, tnet, obs = moe_nets
    assert "experts" in params["params"]["actor"]["backbone"] and "gate" in params["params"]["critic"]
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    tobs = {k: torch.as_tensor(v) for k, v in obs.items()}
    with torch.no_grad():
        for hist in (False, True):
            (jm, js), jv = jnet.apply(params, jobs, hist, method=FlaxMimic.act, mutable=["intermediates"])
            (tm, ts), tlb = tnet.act_lb(tobs, hist)
            _close(tm, jm, 1e-5, f"mean hist={hist}")
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            assert float(tlb) == pytest.approx(_lb_sum(jv), abs=1e-6) and float(tlb) > 0
        jval, jv = jnet.apply(params, jobs, method=FlaxMimic.evaluate, mutable=["intermediates"])
        tval, tlb = tnet.evaluate_lb(tobs)
        _close(tval, jval, 1e-5, "values")
        assert float(tlb) == pytest.approx(_lb_sum(jv), abs=1e-6) and float(tlb) > 0
    back = convert.flax_params(tnet)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                 jax.tree_util.tree_flatten_with_path(params)[0]):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_moe_update_rl_matches_jax(moe_nets):
    """One RL minibatch with MoE actor and critic, after one shared Adam step;
    the loss carries load_balancing_loss_alpha x (actor's + critic's aux loss)."""
    cfg, env, jnet, params, tnet, obs = moe_nets
    talgo = PPOMimic(cfg, env, seed=5)
    assert talgo.use_moe and talgo.lb_alpha == pytest.approx(1e-2)
    jalgo = JaxPPOMimic(Cfg.wrap(_moe_cfg()), env)
    ts = talgo.new_train_state(convert.from_flax(params, mimic_net_from_config(cfg, 23)))
    rng = np.random.default_rng(11)
    grads = jax.tree.map(lambda x: (1e-3 * rng.normal(size=x.shape)).astype(np.float32), params)
    jp = jax.tree.map(jnp.asarray, params)
    jopt = _set_lr(jalgo.tx.init(jp), jnp.asarray(1e-4, jnp.float32))
    upd, jopt = jalgo.tx.update(jax.tree.map(jnp.asarray, grads), jopt, jp)
    jp = optax.apply_updates(jp, upd)
    sd = convert.state_dict_from_flax(grads, ts.net)
    ts.opt.step([sd[n] for n, _ in ts.net.named_parameters()], torch.tensor(1e-4))

    f32 = lambda x: np.asarray(x, dtype=np.float32)
    (mean, std) = jnet.apply(jp, {k: jnp.asarray(v) for k, v in obs.items()}, False, method=FlaxMimic.act)
    values = f32(jnet.apply(jp, {k: jnp.asarray(v) for k, v in obs.items()}, method=FlaxMimic.evaluate))
    old_mean = f32(mean) + f32(0.05 * rng.normal(size=mean.shape))
    old_std = f32(std)
    actions = old_mean + old_std * f32(rng.normal(size=mean.shape))
    logp = f32((-0.5 * ((actions - old_mean) / old_std) ** 2 - np.log(old_std) - 0.5 * np.log(2 * np.pi)).sum(-1))
    B = actions.shape[0]
    batch = dict(obs, actions=f32(actions), logp=logp, mean=old_mean, std=old_std, values=values,
                 returns=f32(values + 0.3 * rng.normal(size=values.shape)), advantages=f32(rng.normal(size=(B,))))
    it = 2500
    (jp2, _, jlr, _), jm = jax.jit(jalgo._update_rl)((jp, jopt, jnp.asarray(1e-4, jnp.float32), jnp.asarray(it, jnp.int32)),
                                            jax.tree.map(jnp.asarray, batch))
    ts.lr, ts.iteration = torch.tensor(1e-4), it
    tm = talgo.update_rl(ts, {k: torch.tensor(v) for k, v in batch.items()})
    assert float(ts.lr) == float(jlr)
    for k in ("surrogate", "value_loss", "entropy", "kl", "priv_reg"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert float(tm["load_balancing"]) > 0
    got = convert.flax_params(ts.net)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                 jax.tree_util.tree_flatten_with_path(jp2)[0]):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, err_msg=jax.tree_util.keystr(path))


def test_moe_training_iteration_logs_the_aux_loss(moe_nets):
    """One RL + DAgger iteration of a MoE teacher (4 steps, N = 32): every
    logged value finite, the load-balance loss logged and positive."""
    cfg, env, _, _, _, _ = moe_nets
    cfg = _moe_cfg(["algo.config.num_steps_per_env=4"])
    algo = PPOMimic(cfg, env, seed=6)
    ts, log = algo.train_iteration(algo.init_train_state())
    vals = {k: float(v) for k, v in log.items()}
    assert all(np.isfinite(v) for v in vals.values()), vals
    assert vals["Loss/load_balancing"] > 0 and "Loss/hist_latent" in vals
