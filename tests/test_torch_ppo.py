"""Port parity: MHPPO's GAE, optimizer, minibatch update and update phase,
and the networks' conversion, against `pbhc_tpu` (flax/optax) on the CPU.

The networks are the training config's (actor 380-512-256-128-23, critic
630-768-512-128-21, ELU), carried from the flax init through
`agents/convert.py`. Inputs are made with numpy from a seed.

The update tests start from a mid-training optimizer state: both packages
first take one Adam step on the same given gradients. From a fresh state,
Adam's first step moves every weight by about lr whatever its gradient's
size, so a weight whose gradient is near zero turns the two packages' f32
rounding of that gradient into a difference of up to lr (seen: 6 of 194,560
first-layer weights off by 5e-5). Adam's first step itself is held to optax
on given gradients.

Tolerances:
- GAE: 1e-6 relative to each output's largest magnitude (XLA contracts the
  recursion's multiply-adds into fused ones, so an entry near zero carries
  the absolute rounding of the larger terms it was summed from);
- Adam after the global-norm clip, 3 steps on given gradients: atol 1e-7;
- one minibatch update: params atol 1e-5, losses and KL rtol 1e-5, the
  adaptive lr exactly;
- the whole update phase (5 epochs x 4 minibatches on a fixed trajectory,
  JAX's permutations): params atol 1e-5, the log's losses rtol 1e-4 (means of
  20 minibatches whose params drift apart by f32 rounding), the lr exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu.agents.mh_ppo import MHPPO as JaxMHPPO  # noqa: E402
from pbhc_tpu.agents.mh_ppo import _set_lr  # noqa: E402
from pbhc_tpu.agents.networks import Critic as FlaxCritic  # noqa: E402
from pbhc_tpu.config.loader import compose as jax_compose  # noqa: E402
from pbhc_tpu.envs.tracking_env import MotionTrackingEnv as JaxEnv  # noqa: E402
from pbhc_tpu_torch.agents import convert  # noqa: E402
from pbhc_tpu_torch.agents.mh_ppo import MHPPO, Adam  # noqa: E402
from pbhc_tpu_torch.agents.networks import (actor_from_config, critic_from_config,  # noqa: E402
                                            flax_init_)
from pbhc_tpu_torch.config.loader import compose  # noqa: E402
from pbhc_tpu_torch.envs.tracking_env import MotionTrackingEnv  # noqa: E402

N, T = 128, 24
SELS = ["exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking", "rewards=motion_tracking",
        "domain_rand=main", "simulator=tpu"]
OVS = [f"num_envs={N}", "robot.motion.motion_file=assets/motions/Horse-stance_punch.pkl"]


@pytest.fixture(scope="module")
def algos():
    jalgo = JaxMHPPO(jax_cfg := jax_compose("pbhc_tpu/config", SELS, OVS),
                     JaxEnv(jax_cfg, N, jax.random.PRNGKey(0)))
    cfg = compose(SELS, OVS + ["device=cpu"])
    talgo = MHPPO(cfg, MotionTrackingEnv(cfg, N, device="cpu"))
    return jalgo, talgo, cfg


def _params(jalgo, seed=0):
    ka, kc = jax.random.split(jax.random.PRNGKey(seed))
    ap = jalgo.actor.init(ka, jnp.zeros((1, jalgo.actor_dim)))
    cp = jalgo.critic.init(kc, jnp.zeros((1, jalgo.critic_dim)))
    return jax.tree.map(np.asarray, ap), jax.tree.map(np.asarray, cp)


def _primed(jalgo, talgo, cfg, ap, cp, seed):
    """JAX (params, optimizer states) and the port's train state after one Adam
    step at lr 1e-3 on the same random gradients, from flax-init params."""
    rng = np.random.default_rng(seed)
    grads = [jax.tree.map(lambda x: (1e-3 * rng.normal(size=x.shape)).astype(np.float32), p)
             for p in (ap, cp)]
    lr = jnp.asarray(1e-3, jnp.float32)
    jax_side = []
    for p, g in zip((ap, cp), grads):
        opt = _set_lr(jalgo.tx.init(p), lr)
        upd, opt = jalgo.tx.update(g, opt, p)
        jax_side += [optax.apply_updates(p, upd), opt]
    actor = convert.from_flax(ap, actor_from_config(cfg, talgo.actor_dim, talgo.num_act, talgo.phase_pos["actor_obs"]))
    critic = convert.from_flax(cp, critic_from_config(cfg, talgo.critic_dim, talgo.num_rew,
                                                      talgo.phase_pos["critic_obs"]))
    ts = talgo.new_train_state(actor, critic)
    for net, opt, g in ((actor, ts.actor_opt, grads[0]), (critic, ts.critic_opt, grads[1])):
        sd = convert.state_dict_from_flax(g, net)
        opt.step([sd[name] for name, _ in net.named_parameters()], torch.tensor(1e-3))
    ja, jaopt, jc, jcopt = jax_side
    return (ja, jc, jaopt, jcopt), ts


def _samples(jalgo, ap, shape, rng, shift):
    """Stored rollout data of `shape` ([B] or [T,N]) whose old policy is the
    current one with its mean moved by `shift` (which sets the KL)."""
    na, nr = jalgo.num_act, jalgo.num_rew
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    aobs = f32(rng.normal(size=(*shape, jalgo.actor_dim)))
    mean, std = jalgo.actor.apply(ap, jnp.asarray(aobs))
    old_mean = f32(mean) + f32(shift * rng.normal(size=(*shape, na)))
    old_std = f32(std) * f32(np.exp(0.05 * rng.normal(size=(*shape, na))))
    actions = old_mean + old_std * f32(rng.normal(size=(*shape, na)))
    logp = f32((-0.5 * ((actions - old_mean) / old_std) ** 2 - np.log(old_std)
                - 0.5 * np.log(2 * np.pi)).sum(-1))
    values = f32(0.5 * rng.normal(size=(*shape, nr)))
    return dict(actor_obs=aobs, critic_obs=f32(rng.normal(size=(*shape, jalgo.critic_dim))),
                actions=f32(actions), logp=logp, mean=old_mean, std=old_std, values=values,
                rewards=f32(0.1 * rng.normal(size=(*shape, nr))), dones=rng.uniform(size=shape) < 0.05,
                returns=f32(values + 0.3 * rng.normal(size=(*shape, nr))),
                advantages=f32(rng.normal(size=shape)))


def _assert_tree_close(got, want, atol, what):
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want)
    for path, v in flat_got:
        np.testing.assert_allclose(v, np.asarray(flat_want[path]), atol=atol,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


def test_gae_matches_jax(algos):
    jalgo, talgo, _ = algos
    rng = np.random.default_rng(0)
    R = jalgo.num_rew
    traj = dict(values=rng.normal(size=(T, N, R)).astype(np.float32),
                rewards=rng.normal(size=(T, N, R)).astype(np.float32),
                dones=rng.uniform(size=(T, N)) < 0.1)
    last = rng.normal(size=(N, R)).astype(np.float32)
    jr, ja = jalgo._gae({k: jnp.asarray(v) for k, v in traj.items()}, jnp.asarray(last))
    tr, ta = talgo._gae({k: torch.as_tensor(v) for k, v in traj.items()}, torch.as_tensor(last))
    for got, want in ((tr, jr), (ta, ja)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_adam_after_clip_matches_optax(scale):
    """Three steps with a changing lr; scale 10 makes the clip act."""
    rng = np.random.default_rng(int(scale))
    shapes = [(7, 5), (5,), (3,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.inject_hyperparams(optax.adam)(learning_rate=1e-3))
    jp, jopt = [jnp.asarray(p) for p in p0], tx.init([jnp.asarray(p) for p in p0])
    tp = [torch.as_tensor(p.copy()) for p in p0]
    opt = Adam(tp, 1.0)
    for step, lr in enumerate((1e-3, 1.5e-3, 1e-3 / 1.5)):
        grads = [(scale * rng.normal(size=s)).astype(np.float32) for s in shapes]
        jopt = _set_lr(jopt, jnp.asarray(lr, jnp.float32))
        upd, jopt = tx.update([jnp.asarray(g) for g in grads], jopt, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.as_tensor(g) for g in grads], torch.tensor(lr, dtype=torch.float32))
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, err_msg=f"step {step}")


def test_networks_convert_both_ways(algos):
    jalgo, talgo, cfg = algos
    ap, cp = _params(jalgo)
    critic = convert.from_flax(cp, critic_from_config(cfg, talgo.critic_dim, talgo.num_rew))
    actor = convert.from_flax(ap, actor_from_config(cfg, talgo.actor_dim, talgo.num_act))
    _assert_tree_close(convert.flax_params(critic), cp, 0, "critic")
    _assert_tree_close(convert.flax_params(actor), ap, 0, "actor")
    obs = np.random.default_rng(1).normal(size=(64, talgo.critic_dim)).astype(np.float32)
    hidden = tuple(cfg.algo.config.module_dict.critic.layer_config.hidden_dims)
    want = FlaxCritic(hidden, talgo.num_rew, "ELU").apply(cp, jnp.asarray(obs))
    with torch.no_grad():
        got = critic(torch.as_tensor(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_flax_init_draws_lecun_normal(algos):
    _, talgo, cfg = algos
    actor = flax_init_(actor_from_config(cfg, talgo.actor_dim, talgo.num_act), torch.Generator().manual_seed(0))
    for lin in actor.linear_layers():
        w = lin.weight.detach().numpy()
        sd = np.sqrt(1.0 / lin.in_features)
        assert np.all(lin.bias.detach().numpy() == 0)
        assert np.abs(w).max() <= 2 * sd / 0.87962566103423978 + 1e-7
        assert abs(w.std() / sd - 1.0) < 0.05, (w.std(), sd)
    np.testing.assert_array_equal(actor.std.detach().numpy(), np.float32(0.8))


@pytest.mark.parametrize("shift", [0.02, 0.1, 0.4])
def test_minibatch_update_matches_optax(algos, shift):
    """shift 0.02 / 0.1 / 0.4 puts the KL below, inside and above the band
    [desired/2, 2 desired]: the lr rises, stays, falls."""
    jalgo, talgo, cfg = algos
    seed = int(shift * 100)
    ap, cp = _params(jalgo, seed=seed)
    (ap, cp, aopt, copt), ts = _primed(jalgo, talgo, cfg, ap, cp, seed)
    batch = _samples(jalgo, ap, (3072,), np.random.default_rng(seed), shift)
    carry = (ap, cp, aopt, copt, jnp.asarray(1e-3, jnp.float32))
    (jap, jcp, _, _, jlr), jm = jax.jit(jalgo._minibatch_update)(
        carry, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = talgo._minibatch_update(ts, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert float(ts.lr) == float(jlr)
    assert float(jlr) != 1e-3 or shift == 0.1
    for k in ("surrogate", "value_loss", "entropy", "kl"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    _assert_tree_close(convert.flax_params(ts.actor), jap, 1e-5, "actor")
    _assert_tree_close(convert.flax_params(ts.critic), jcp, 1e-5, "critic")


def test_update_phase_matches_jax(algos):
    """`train_iteration` with the rollout replaced by a fixed trajectory: GAE,
    5 epochs x 4 minibatches with JAX's permutations, the log's losses."""
    jalgo, talgo, cfg = algos
    ap, cp = _params(jalgo, seed=3)
    (ap, cp, aopt, copt), ts = _primed(jalgo, talgo, cfg, ap, cp, 3)
    rng = np.random.default_rng(3)
    traj = _samples(jalgo, ap, (T, N), rng, 0.05)
    for k in ("returns", "advantages"):
        del traj[k]
    last_obs = {"critic_obs": rng.normal(size=(N, jalgo.critic_dim)).astype(np.float32)}
    key = jax.random.PRNGKey(7)

    jts = jalgo.init_train_state(jax.random.PRNGKey(0))
    jts = dataclasses.replace(jts, actor_params=ap, critic_params=cp, actor_opt=aopt, critic_opt=copt)
    jtraj = {k: jnp.asarray(v) for k, v in traj.items()}
    jalgo._rollout = lambda ts: (ts.env_state, ts.obs | {"critic_obs": jnp.asarray(last_obs["critic_obs"])},
                                 key, jtraj, {"x": jnp.zeros(T)})
    try:
        jts, jlog = jalgo.train_iteration(jts)
    finally:
        del jalgo._rollout
    # JAX's permutations: train_iteration splits the rollout's key once, then
    # once per epoch (`mh_ppo.py:250-255`)
    rk, _ = jax.random.split(key)
    perms = []
    for _ in range(jalgo.num_epochs):
        rk, kp = jax.random.split(rk)
        perms.append(torch.as_tensor(np.asarray(jax.random.permutation(kp, T * N))))

    ttraj = {k: torch.as_tensor(v) for k, v in traj.items()}
    last = {k: torch.as_tensor(v) for k, v in last_obs.items()}
    ts, tlog = talgo.learn(ts, (None, last, ttraj, {}), perms=perms)
    assert ts.iteration == 1
    assert float(ts.lr) == float(jlog["Loss/lr"])
    for k in ("Train/mean_step_reward", "Loss/surrogate", "Loss/value", "Loss/entropy", "Loss/kl"):
        np.testing.assert_allclose(float(tlog[k]), float(jlog[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    _assert_tree_close(convert.flax_params(ts.actor), jts.actor_params, 1e-5, "actor")
    _assert_tree_close(convert.flax_params(ts.critic), jts.critic_params, 1e-5, "critic")


def test_minibatch_update_with_l2c2_matches_optax(algos, monkeypatch):
    """L2C2 on (`algo.config.l2c2.enable`): the port draws the interpolation
    weights from its generator, JAX from `fold_in(batch["_key"], 0 / 1)`; the
    port is handed JAX's draws, in the order it asks (actor, then critic)."""
    jalgo, talgo, cfg = algos
    ap, cp = _params(jalgo, seed=11)
    (ap, cp, aopt, copt), ts = _primed(jalgo, talgo, cfg, ap, cp, 11)
    rng = np.random.default_rng(11)
    batch = _samples(jalgo, ap, (3072,), rng, 0.1)
    batch["next_actor_obs"] = (batch["actor_obs"] + 0.1 * rng.normal(size=batch["actor_obs"].shape)).astype(np.float32)
    batch["next_critic_obs"] = (batch["critic_obs"] + 0.1 * rng.normal(size=batch["critic_obs"].shape)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    draws = [np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (3072, 1))) * 2 - 1 for i in (0, 1)]
    monkeypatch.setitem(jalgo.config.l2c2, "enable", True)
    monkeypatch.setattr(talgo, "l2c2", True)
    monkeypatch.setattr(talgo, "_l2c2_obs",
                        lambda obs, nxt: obs + torch.as_tensor(draws.pop(0)) * (nxt - obs))
    carry = (ap, cp, aopt, copt, jnp.asarray(1e-3, jnp.float32))
    (jap, jcp, _, _, jlr), jm = jax.jit(jalgo._minibatch_update)(
        carry, {**{k: jnp.asarray(v) for k, v in batch.items()}, "_key": key})
    tm = talgo._minibatch_update(ts, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert not draws and float(ts.lr) == float(jlr)
    for k in ("surrogate", "value_loss", "entropy", "kl"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    _assert_tree_close(convert.flax_params(ts.actor), jap, 1e-5, "actor")
    _assert_tree_close(convert.flax_params(ts.critic), jcp, 1e-5, "critic")
