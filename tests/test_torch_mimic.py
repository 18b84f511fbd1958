"""Port parity: the KungfuBot2 networks (`agents/mimic_networks.py`) and
their flax conversion, against `pbhc_tpu`'s flax modules on the CPU.

All four committed KungfuBot2 checkpoints (teacher and student at 23 and
29 DoF) go through `agents/convert.py` into the port's `MimicActorCritic`.
The observations are the serving path's: the port's `GeneralTrackingEnv`
(N = 64, randomness of the run config as it is) after 3 control steps under
the checkpoint's own history-latent mean action; the env itself is held
against JAX in tests/test_torch_general_tracking.py.

Tolerances: `act` mean (both latent paths) and both latents 1e-5 absolute
(f32 nets of up to 5 layers behind a LayerNorm); `evaluate` 1e-5 per unit
of the largest value (values reach 20 here, where an f32 ulp is 2e-6, and
both packages sit about 1e-5 from a float64 evaluation); sigma exactly; the flax LayerNorm against the port's 1e-5 per unit of the largest output,
on unit-scale inputs offset by up to 3 (flax's E[x^2] - E[x]^2 variance is
written out in the same order, so the two differ only by reduction order); the weights written
back by `flax_params` exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

torch.set_num_threads(2)

from pbhc_tpu.agents.mimic_networks import MimicActorCritic as FlaxMimic  # noqa: E402
from pbhc_tpu.agents.ppo_mimic import build_mimic_net as jax_build  # noqa: E402
from pbhc_tpu_torch.agents import convert  # noqa: E402
from pbhc_tpu_torch.agents.mimic_networks import ConvEncoder, mimic_net_from_config  # noqa: E402
from pbhc_tpu_torch.agents.networks import LayerNorm, flax_init_  # noqa: E402
from pbhc_tpu_torch.config.loader import Cfg, apply_overrides, load_snapshot  # noqa: E402
from pbhc_tpu_torch.envs.general_tracking_env import GeneralTrackingEnv  # noqa: E402
from pbhc_tpu_torch.envs.tracking_env import obs_width  # noqa: E402
from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload  # noqa: E402

CKPTS = {"kb2_teacher23_r3": "model_24000.pkl", "kb2_student23_r3": "model_8000.pkl",
         "kb2_teacher29_r5": "model_3000.pkl", "kb2_student29_r5": "model_1750.pkl"}
N = 64
GROUPS = ("actor_obs", "priv_obs", "future_motion_targets", "prop_history")


def _nets(run):
    cfg = load_snapshot(run)
    nd = int(cfg.robot.actions_dim)
    o = cfg.obs
    jnet = jax_build(cfg.algo.config, nd, obs_width(o, "future_motion_targets"), int(o.future_num_steps),
                     obs_width(o, "prop_history"), int(o.history_length))
    params = load_checkpoint_payload(f"artifacts/{run}/ckpt/{CKPTS[run]}")["params"]
    tnet = convert.from_flax(params, mimic_net_from_config(cfg, nd))
    motion = "assets/motions/g1_ue_walk_23dof.pkl" if "23" in run else cfg.robot.motion.motion_file
    env = GeneralTrackingEnv(Cfg.wrap(apply_overrides(cfg, [f"robot.motion.motion_file={motion}"])), N,
                             device="cpu", seed=7)
    state = env.init_state()
    obs, state.history = env.compute_observations(state)
    with torch.no_grad():
        for _ in range(3):
            state, obs, *_ = env.step(state, tnet.act(obs, True)[0])
    return cfg, jnet, params, tnet, {g: obs[g].numpy() for g in GROUPS}


@pytest.mark.parametrize("run", sorted(CKPTS))
def test_committed_checkpoint_outputs_match_flax(run):
    _, jnet, params, tnet, obs = _nets(run)
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    tobs = {k: torch.as_tensor(v) for k, v in obs.items()}
    with torch.no_grad():
        for hist in (False, True):
            jm, js = jnet.apply(params, jobs, hist, method=FlaxMimic.act)
            tm, ts = tnet.act(tobs, hist)
            np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5, err_msg=f"mean hist={hist}")
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        jv = np.asarray(jnet.apply(params, jobs, method=FlaxMimic.evaluate))
        np.testing.assert_allclose(tnet.evaluate(tobs).numpy(), jv, atol=1e-5 * max(1.0, np.abs(jv).max()))
        np.testing.assert_allclose(tnet.priv_latent(tobs["priv_obs"]).numpy(),
                                   np.asarray(jnet.apply(params, jobs["priv_obs"], method=FlaxMimic.priv_latent)),
                                   atol=1e-5)
        np.testing.assert_allclose(tnet.hist_latent(tobs["prop_history"]).numpy(),
                                   np.asarray(jnet.apply(params, jobs["prop_history"],
                                                         method=FlaxMimic.hist_latent)), atol=1e-5)


@pytest.mark.parametrize("run", sorted(CKPTS))
def test_flax_params_round_trip(run):
    _, _, params, tnet, _ = _nets(run)
    got = jax.tree_util.tree_flatten_with_path(convert.flax_params(tnet))[0]
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=jax.tree_util.keystr(k))


def test_fresh_net_matches_flax_init_layout():
    """A fresh port net has the flax init's tree, shapes and LayerNorm values,
    and lecun-normal kernels over fan-in (k x in for a Conv)."""
    cfg, jnet, _, _, obs = _nets("kb2_teacher29_r5")
    jparams = jnet.init(jax.random.PRNGKey(0), {k: jnp.asarray(v[:1]) for k, v in obs.items()})
    tnet = flax_init_(mimic_net_from_config(cfg, 29), torch.Generator().manual_seed(0))
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(convert.flax_params(tnet))[0]}
    want = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if "scale" in k or "bias" in k or "std" in k:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    conv = got["['params']['actor']['motion_encoder']['Conv_0']['kernel']"]          # [6, 60, 40]
    assert abs(conv.std() * np.sqrt(6 * 60) - 1.0) < 0.05 and np.abs(conv).max() <= 2.0 / np.sqrt(360) / 0.8796


def test_layernorm_matches_flax():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(256, 416)) + rng.uniform(-3, 3, size=(256, 1))).astype(np.float32)
    scale, bias = rng.normal(size=(2, 416)).astype(np.float32)
    ref = fnn.LayerNorm().apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    ln = LayerNorm(416)
    with torch.no_grad():
        ln.weight.copy_(torch.as_tensor(scale))
        ln.bias.copy_(torch.as_tensor(bias))
        np.testing.assert_allclose(ln(torch.as_tensor(x)).numpy(), np.asarray(ref),
                                   atol=1e-5 * np.abs(np.asarray(ref)).max())


@pytest.mark.parametrize("tsteps,per_step", [(10, 74), (20, 57)])
def test_conv_encoder_matches_flax(tsteps, per_step):
    from pbhc_tpu.agents.mimic_networks import ConvEncoder as FlaxConv

    rng = np.random.default_rng(tsteps)
    x = rng.normal(size=(N, tsteps * per_step)).astype(np.float32)
    fenc = FlaxConv(tsteps, per_step, 30, 64, "SiLU")
    params = fenc.init(jax.random.PRNGKey(tsteps), jnp.asarray(x))
    tenc = convert.from_flax(params, ConvEncoder(tsteps, per_step, 30, 64, "SiLU"))
    with torch.no_grad():
        np.testing.assert_allclose(tenc(torch.as_tensor(x)).numpy(), np.asarray(fenc.apply(params, jnp.asarray(x))),
                                   atol=1e-5)


def test_convert_rejects_other_architectures():
    cfg, _, params, _, _ = _nets("kb2_teacher23_r3")
    with pytest.raises(ValueError, match=r"\(23,\) != \(29,\)"):
        convert.from_flax(params, mimic_net_from_config(cfg, 29))
    other = Cfg.wrap(apply_overrides(load_snapshot("kb2_teacher23_r3"),
                                     ["algo.config.module_dict.actor.layer_config.hidden_dims=[768, 512]"]))
    with pytest.raises(ValueError, match="Dense_3"):
        convert.from_flax(params, mimic_net_from_config(other, 23))


def test_moe_backbone_is_refused():
    """A `MoEMLP` backbone builds (its parity is tests/test_torch_moe.py);
    a backbone type the JAX package does not know is refused."""
    cfg = Cfg.wrap(apply_overrides(load_snapshot("kb2_teacher23_r3"),
                                   ["algo.config.module_dict.actor.layer_config.type=MoEMLP"]))
    net = mimic_net_from_config(cfg, 23)
    assert type(net.actor.backbone).__name__ == "MoEMLP" and len(net.actor.backbone.experts) == 4
    assert type(net.critic).__name__ == "MLP"
    other = Cfg.wrap(apply_overrides(load_snapshot("kb2_teacher23_r3"),
                                     ["algo.config.module_dict.critic.layer_config.type=Transformer"]))
    with pytest.raises(ValueError, match="unknown backbone type"):
        mimic_net_from_config(other, 23)
