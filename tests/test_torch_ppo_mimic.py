"""Port parity: PPOMimic's updates (RL with priv-reg, DAgger, distillation),
its GAE and its priv-reg schedule, against `pbhc_tpu` on the CPU.

The networks start from the committed KungfuBot2 checkpoints (teacher
`kb2_teacher23_r3`, student `kb2_student23_r3`). Each update starts from a
mid-training optimizer state: both packages first take one Adam step on the
same random gradients (from a fresh state Adam's first step moves every
weight by about lr whatever its gradient, turning f32 rounding into
differences of up to lr; see tests/test_torch_ppo.py). The observations are
the port env's over 4 control steps at N = 64 (B = 256 samples); the stored
old policy is the current one with its mean moved by `shift` (which sets
the KL), as in tests/test_torch_ppo.py, so the clipped losses keep their
branch under rounding. The JAX updates run un-jitted: `PPOMimic._update_rl`
and `_update_dagger` as they are; the distillation minibatch, a closure
inside the jitted `distill_iteration`, is written out here from the same
calls (`ppo_mimic.py:382-396`).

Tolerances: params 1e-5 absolute after the update, losses and KL 1e-5
relative, the adaptive lr exactly; the DAgger update leaves every param
outside the history encoder bit for bit, the distillation update leaves the
history encoder bit for bit; GAE 1e-6 per unit of the largest output (see
tests/test_torch_ppo.py); the priv-reg coefficient exactly.
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
from pbhc_tpu.agents.ppo_mimic import PPOMimic as JaxPPOMimic  # noqa: E402
from pbhc_tpu.envs.general_tracking_env import GeneralTrackingEnv as JaxEnv  # noqa: E402
from pbhc_tpu_torch.agents import convert  # noqa: E402
from pbhc_tpu_torch.agents.ppo_mimic import (OBS_KEYS, PPOMimic, add_teacher_obs_groups,  # noqa: E402
                                             load_teacher)
from pbhc_tpu_torch.config.loader import Cfg, apply_overrides, load_snapshot  # noqa: E402
from pbhc_tpu_torch.envs.general_tracking_env import GeneralTrackingEnv  # noqa: E402
from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload  # noqa: E402

N = 64
MOTION = "robot.motion.motion_file=assets/motions/g1_ue_walk_23dof.pkl"
TEACHER = "artifacts/kb2_teacher23_r3/ckpt/model_24000.pkl"
STUDENT = "artifacts/kb2_student23_r3/ckpt/model_8000.pkl"


def _cfg(run, extra=()):
    return Cfg.wrap(apply_overrides(load_snapshot(run), [MOTION, f"num_envs={N}", *extra]))


def _jax(params):
    return jax.tree.map(jnp.asarray, params)


def _tree_close(got, want, atol, what):
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(g) == len(w)
    for path, v in g:
        np.testing.assert_allclose(v, np.asarray(w[path]), atol=atol, err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _batch(talgo, ts, steps=4):
    """The port env's observations over `steps` control steps (history-latent
    mean actions), flattened to [steps * N, ...]."""
    env, st, obs = talgo.env, ts.env_state, ts.obs
    out = {k: [] for k in (*OBS_KEYS, "teacher_actions")}
    with torch.no_grad():
        for _ in range(steps):
            for k in OBS_KEYS:
                out[k].append(obs[k].numpy())
            if talgo.teacher is not None:
                out["teacher_actions"].append(talgo.teacher(obs).numpy())
            st, obs, *_ = env.step(st, ts.net.act(obs, True)[0])
    return {k: np.concatenate(v) for k, v in out.items() if v}


@pytest.fixture(scope="module")
def teacher():
    cfg = _cfg("kb2_teacher23_r3", ["algo.config.dagger_only=false"])
    talgo = PPOMimic(cfg, GeneralTrackingEnv(cfg, N, device="cpu", seed=3), seed=3)
    jax_cfg = Cfg.wrap(load_snapshot("kb2_teacher23_r3"))
    jalgo = JaxPPOMimic(jax_cfg, JaxEnv(_cfg("kb2_teacher23_r3"), N, jax.random.PRNGKey(0)))
    params = load_checkpoint_payload(TEACHER)["params"]
    ts = talgo.init_train_state()
    convert.from_flax(params, ts.net)
    return jalgo, talgo, ts, params, _batch(talgo, ts)


def _prime(jalgo, talgo, ts, params, seed, hist=False, frozen_hist=False):
    """One shared Adam step on random gradients: only the history encoder's
    for `hist` (its own optimizer), none of the history encoder's for
    `frozen_hist` (as in distillation, where it never has a gradient).
    Returns the JAX (params, opt state); `ts` is stepped in place."""
    rng = np.random.default_rng(seed)

    def grad(p, x):
        in_hist = "history_encoder" in jax.tree_util.keystr(p)
        if (hist and not in_hist) or (frozen_hist and in_hist):
            return np.zeros(x.shape, np.float32)
        return (1e-3 * rng.normal(size=x.shape)).astype(np.float32)

    grads = jax.tree_util.tree_map_with_path(grad, params)
    jp = _jax(params)
    sd = convert.state_dict_from_flax(grads, ts.net)
    if hist:
        opt = jalgo.hist_tx.init(jp)
        upd, opt = jalgo.hist_tx.update(_jax(grads), opt, jp)
        ts.hist_opt.step([sd[n] for n, _ in ts.net.named_parameters() if "history_encoder" in n],
                         talgo.learning_rate)
    else:
        opt = _set_lr(jalgo.tx.init(jp), jnp.asarray(1e-4, jnp.float32))
        upd, opt = jalgo.tx.update(_jax(grads), opt, jp)
        ts.opt.step([sd[n] for n, _ in ts.net.named_parameters()], torch.tensor(1e-4))
    jp = optax.apply_updates(jp, upd)
    _tree_close(convert.flax_params(ts.net), jp, 1e-7, "primed")
    return jp, opt


def _rl_batch(jalgo, jp, obs, rng, shift):
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    B = obs["actor_obs"].shape[0]
    mean, std = jalgo.net.apply(jp, _jax(obs), False, method=FlaxMimic.act)
    values = f32(jalgo.net.apply(jp, _jax(obs), method=FlaxMimic.evaluate))
    old_mean = f32(mean) + f32(shift * rng.normal(size=mean.shape))
    old_std = f32(std) * f32(np.exp(0.05 * rng.normal(size=mean.shape)))
    actions = old_mean + old_std * f32(rng.normal(size=mean.shape))
    logp = f32((-0.5 * ((actions - old_mean) / old_std) ** 2 - np.log(old_std) - 0.5 * np.log(2 * np.pi)).sum(-1))
    return dict(obs, actions=f32(actions), logp=logp, mean=old_mean, std=old_std, values=values,
                returns=f32(values + 0.3 * rng.normal(size=values.shape)), advantages=f32(rng.normal(size=(B,))))


def _restore(ts, params):
    convert.from_flax(params, ts.net)
    ts.opt = type(ts.opt)(ts.net.parameters(), ts.opt.max_grad_norm)
    ts.hist_opt = type(ts.hist_opt)(ts.net.actor.history_encoder.parameters(), ts.hist_opt.max_grad_norm)


@pytest.mark.parametrize("shift", [0.02, 0.1, 0.4])
def test_update_rl_matches_jax(teacher, shift):
    """One RL minibatch at iteration 2500 (priv-reg coefficient 0.05). shift
    0.02 / 0.1 / 0.4 puts the KL below, inside and above [desired/2,
    2 desired]: the lr rises, stays, falls."""
    jalgo, talgo, ts, params, obs = teacher
    seed = int(shift * 100)
    _restore(ts, params)
    jp, jopt = _prime(jalgo, talgo, ts, params, seed)
    batch = _rl_batch(jalgo, jp, {k: obs[k] for k in OBS_KEYS}, np.random.default_rng(seed), shift)
    it = 2500
    (jp2, _, jlr, _), jm = jalgo._update_rl((jp, jopt, jnp.asarray(1e-4, jnp.float32), jnp.asarray(it, jnp.int32)),
                                            _jax(batch))
    ts.lr, ts.iteration = torch.tensor(1e-4), it
    tm = talgo.update_rl(ts, {k: torch.tensor(v) for k, v in batch.items()})
    assert float(ts.lr) == float(jlr)
    assert float(jlr) != np.float32(1e-4) or shift == 0.1
    for k in ("surrogate", "value_loss", "entropy", "kl", "priv_reg"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert float(jm["priv_reg"]) > 0
    _tree_close(convert.flax_params(ts.net), jp2, 1e-5, "params")


def test_update_dagger_matches_jax(teacher):
    """One DAgger minibatch: only the history encoder moves."""
    jalgo, talgo, ts, params, obs = teacher
    _restore(ts, params)
    jp, jhopt = _prime(jalgo, talgo, ts, params, 5, hist=True)
    before = convert.flax_params(ts.net)
    pv, hs = obs["priv_obs"][:128], obs["prop_history"][:128]
    (jp2, _), jloss = jalgo._update_dagger((jp, jhopt), (jnp.asarray(pv), jnp.asarray(hs)))
    tloss = talgo.update_dagger(ts, torch.as_tensor(pv), torch.as_tensor(hs))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    after = convert.flax_params(ts.net)
    _tree_close(after, jp2, 1e-5, "params")
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(after)[0],
                                 jax.tree_util.tree_flatten_with_path(before)[0]):
        moved = not np.array_equal(a, b)
        assert moved == ("history_encoder" in jax.tree_util.keystr(path)), jax.tree_util.keystr(path)


@pytest.fixture(scope="module")
def student():
    tcfg = load_snapshot("kb2_teacher23_r3")
    cfg = add_teacher_obs_groups(_cfg("kb2_student23_r3"), tcfg)
    env = GeneralTrackingEnv(cfg, N, device="cpu", seed=4)
    teach = load_teacher(TEACHER, tcfg, env)
    talgo = PPOMimic(cfg, env, teacher=teach, seed=4)
    ts = talgo.init_train_state()
    jax_cfg = Cfg.wrap(load_snapshot("kb2_student23_r3"))
    jalgo = JaxPPOMimic(jax_cfg, JaxEnv(_cfg("kb2_student23_r3"), N, jax.random.PRNGKey(0)))
    return jalgo, talgo, ts, teach


def test_distillation_init_grafts_the_teacher_encoder(student):
    _, _, ts, teach = student
    for (k, a), b in zip(ts.net.actor.history_encoder.state_dict().items(),
                         teach.net.actor.history_encoder.state_dict().values()):
        assert torch.equal(a, b), k


def test_distill_update_matches_jax(student):
    """One behaviour-cloning minibatch from the committed student's weights;
    the history encoder stays as it was."""
    jalgo, talgo, ts, _ = student
    params = load_checkpoint_payload(STUDENT)["params"]
    _restore(ts, params)
    jp, jopt = _prime(jalgo, talgo, ts, params, 6, frozen_hist=True)
    batch = _batch(talgo, ts)
    before = convert.flax_params(ts.net)

    def loss_fn(p):
        student_mean = jalgo.net.apply(p, {k: jnp.asarray(batch[k]) for k in OBS_KEYS}, True,
                                       method=FlaxMimic.act)[0]
        return jnp.linalg.norm(jnp.asarray(batch["teacher_actions"]) - student_mean, axis=-1).mean()

    jloss, grads = jax.value_and_grad(loss_fn)(jp)
    grads = jax.tree_util.tree_map_with_path(
        lambda path, g: jnp.zeros_like(g) if "history_encoder" in jax.tree_util.keystr(path) else g, grads)
    upd, _ = jalgo.tx.update(grads, jopt, jp)
    jp2 = optax.apply_updates(jp, upd)
    ts.lr = torch.tensor(1e-4)
    tloss = talgo.update_distill(ts, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    after = convert.flax_params(ts.net)
    _tree_close(after, jp2, 1e-5, "params")
    _tree_close(after["params"]["actor"]["history_encoder"], before["params"]["actor"]["history_encoder"], 0,
                "history_encoder")


def test_dagger_iteration_moves_only_the_history_encoder(teacher):
    """`dagger_iteration` (`ppo_mimic.py:347`): a history-latent rollout and
    one DAgger pass; port only (the JAX one is a jitted whole)."""
    _, talgo, ts, params, _ = teacher
    _restore(ts, params)
    before = convert.flax_params(ts.net)
    it = ts.iteration
    ts, log = talgo.dagger_iteration(ts)
    assert ts.iteration == it + 1 and ts.hist_opt.count == talgo.num_minibatches and ts.opt.count == 0
    assert np.isfinite(float(log["Loss/hist_latent"])) and float(log["Loss/kl"]) == 0
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(convert.flax_params(ts.net))[0],
                                 jax.tree_util.tree_flatten_with_path(before)[0]):
        moved = not np.array_equal(a, b)
        assert moved == ("history_encoder" in jax.tree_util.keystr(path)), jax.tree_util.keystr(path)


def test_gae_matches_jax(teacher):
    jalgo, talgo, *_ = teacher
    rng = np.random.default_rng(9)
    T = 24
    traj = {"values": rng.normal(size=(T, N, 1)).astype(np.float32),
            "rewards": (0.1 * rng.normal(size=(T, N, 1))).astype(np.float32),
            "dones": rng.uniform(size=(T, N)) < 0.05}
    last = rng.normal(size=(N, 1)).astype(np.float32)
    jr, ja = jalgo._gae(_jax(traj), jnp.asarray(last))
    tr, ta = talgo._gae({k: torch.as_tensor(v) for k, v in traj.items()}, torch.as_tensor(last))
    for a, b in ((tr, jr), (ta, ja)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6 * np.abs(np.asarray(b)).max())


def test_priv_reg_coef_and_mode(teacher):
    jalgo, talgo, ts, *_ = teacher
    for it in (0, 1999, 2000, 2500, 2999.0, 3000, 7000):
        assert talgo.priv_reg_coef(int(it)) == float(jalgo._priv_reg_coef(jnp.asarray(int(it), jnp.int32)))
    modes = []
    for it in (0, 1, 19, 20, 40):
        ts.iteration = it
        modes.append(talgo.mode(ts))
    assert modes == ["rl+dagger", "rl", "rl", "rl+dagger", "rl+dagger"]
