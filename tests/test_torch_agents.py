"""Port parity: the committed side-kick actor through `agents/convert.py`.

The flax `GaussianActor` (pbhc_tpu.agents.networks) and the torch one compute
the same function once the weights are carried across: 1e-5 absolute on the
mean (four f32 layers, 380 -> 512 -> 256 -> 128 -> 23, ELU).
"""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu.agents.networks import GaussianActor as FlaxActor  # noqa: E402
from pbhc_tpu_torch.agents.convert import actor_from_flax  # noqa: E402
from pbhc_tpu_torch.agents.networks import GaussianActor, actor_from_config  # noqa: E402
from pbhc_tpu_torch.config.loader import load_snapshot  # noqa: E402
from pbhc_tpu_torch.eval import batch_eval  # noqa: E402
from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload  # noqa: E402

CKPT = "artifacts/kb1_side_kick/ckpt/model_10500.pkl"


def test_checkpoint_payload_is_plain_pickle():
    payload = load_checkpoint_payload(CKPT)
    with open(CKPT, "rb") as f:
        ref = pickle.load(f)
    assert sorted(payload) == sorted(ref) == ["actor_params", "critic_params", "iteration", "lr"]
    with pytest.raises(FileNotFoundError):
        load_checkpoint_payload("artifacts/kb1_side_kick/ckpt/model_0.pkl")


def test_actor_forward_matches_flax():
    cfg = load_snapshot("kb1_side_kick")
    params = load_checkpoint_payload(CKPT)["actor_params"]
    hidden = tuple(cfg.algo.config.module_dict.actor.layer_config.hidden_dims)
    flax_actor = FlaxActor(hidden, 23, float(cfg.algo.config.init_noise_std), "ELU")
    actor = actor_from_flax(params, actor_from_config(cfg, 380, 23))
    obs = np.random.default_rng(0).normal(size=(64, 380)).astype(np.float32)
    mean, std = flax_actor.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        tmean, tstd = actor(torch.as_tensor(obs))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(mean), atol=1e-5)
    np.testing.assert_allclose(tstd.numpy(), np.asarray(std), atol=0)


def test_convert_rejects_wrong_architecture():
    params = load_checkpoint_payload(CKPT)["actor_params"]
    with pytest.raises(ValueError, match="Dense"):
        actor_from_flax(params, GaussianActor(380, (512, 256), 23))
    with pytest.raises(ValueError, match="kernel"):
        actor_from_flax(params, GaussianActor(381, (512, 256, 128), 23))


def test_cli_rejects_unported_modes():
    with pytest.raises(NotImplementedError, match="sample_episodes"):
        batch_eval.main(["checkpoint=" + CKPT, "mode=sample", "device=cpu"])
