"""Port parity: the training entry points (`pbhc_tpu_torch.train`, the config
snapshot behind its command, the checkpoints it writes) against `pbhc_tpu`.

- The composed config: the snapshot with the slice's overrides applied is
  equal to the JAX loader's `compose` of the same selections and overrides.
- Checkpoints cross over both ways: a `.pkl` the port writes is read by
  `pbhc_tpu.utils.checkpoint.load_checkpoint_payload` and, applied to the
  flax actor and critic, gives the port's outputs to atol 1e-5 (f32 MLPs of
  four layers); one that `pbhc_tpu.train.save_artifact` writes loads in the
  port the same way.
- `train.main` runs 2 iterations at 128 envs on the CPU per solver, with
  every logged value finite.
- Logging: with `use_wandb=true` and wandb missing the port prints the JAX
  CLI's line and trains; its TensorBoard event file holds the tags, at the
  steps, that `pbhc_tpu.train.main` writes for the same run (recorded from
  its `SummaryWriter`).
"""
import sys
import json
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu import train as jax_train  # noqa: E402
from pbhc_tpu.agents.networks import Critic as FlaxCritic  # noqa: E402
from pbhc_tpu.agents.networks import GaussianActor as FlaxActor  # noqa: E402
from pbhc_tpu.config.loader import compose as jax_compose  # noqa: E402
from pbhc_tpu.config.loader import parse_cli as jax_parse_cli  # noqa: E402
from pbhc_tpu.utils.checkpoint import load_checkpoint_payload as jax_load  # noqa: E402
from pbhc_tpu_torch import train  # noqa: E402
from pbhc_tpu_torch.agents import convert  # noqa: E402
from pbhc_tpu_torch.agents.networks import actor_from_config, critic_from_config, flax_init_  # noqa: E402
from pbhc_tpu_torch.config import loader  # noqa: E402
from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload, save_checkpoint  # noqa: E402

SELS = ["exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking", "rewards=motion_tracking",
        "domain_rand=main", "simulator=tpu"]
MOTION = "robot.motion.motion_file=assets/motions/Horse-stance_punch.pkl"
# override sets the composer must take as JAX's does: the training CLI's at
# 4096 envs on both solvers, and the CPU tests'
SLICE_OVERRIDES = [
    [],
    ["num_envs=4096", MOTION, "algo.config.num_learning_iterations=100"],
    ["num_envs=4096", MOTION, "simulator.config.solver=pallas"],
    ["num_envs=128", MOTION, "simulator.config.solver=lanes", "algo.config.num_learning_iterations=2",
     "algo.config.logging_interval=5", "base_dir=/tmp/x", "seed=3"],
    ["num_envs=128", MOTION, "domain_rand.push_robots=false", "obs.noise_scales.dof_vel=0",
     "domain_rand.randomize_friction=false"],
]


@pytest.mark.parametrize("ovs", SLICE_OVERRIDES, ids=lambda o: str(len(o)))
def test_snapshot_with_overrides_equals_compose(ovs):
    got = loader.compose(SELS, ovs)
    want = jax_compose("pbhc_tpu/config", SELS, ovs)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


def test_parse_cli_and_unknown_selections():
    argv = [*SELS, "num_envs=4096", MOTION, "simulator.config.solver=pallas", "seed=1"]
    assert loader.parse_cli(argv) == jax_parse_cli(argv)
    assert loader.parse_cli(argv + ["device=cpu"]) == (SELS, argv[len(SELS):] + ["device=cpu"])
    # a selection with no group file raises, as JAX's `read_text` does
    with pytest.raises(FileNotFoundError, match="mujoco.json"):
        loader.compose(SELS[:-1] + ["simulator=mujoco"])


def _nets(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    actor = flax_init_(actor_from_config(cfg, 380, 23), gen)
    critic = flax_init_(critic_from_config(cfg, 630, 21), gen)
    return actor, critic


def _flax_outputs(cfg, payload, aobs, cobs):
    c = cfg.algo.config
    flax_actor = FlaxActor(tuple(c.module_dict.actor.layer_config.hidden_dims), 23,
                           float(c.init_noise_std), "ELU")
    flax_critic = FlaxCritic(tuple(c.module_dict.critic.layer_config.hidden_dims), 21, "ELU")
    mean, std = flax_actor.apply(payload["actor_params"], jnp.asarray(aobs))
    return np.asarray(mean), np.asarray(std), np.asarray(flax_critic.apply(payload["critic_params"],
                                                                         jnp.asarray(cobs)))


def test_port_checkpoint_loads_in_jax_package(tmp_path):
    cfg = loader.compose(SELS, [MOTION])
    actor, critic = _nets(cfg, 0)
    ts = SimpleNamespace(actor=actor, critic=critic, iteration=7, lr=torch.tensor(3e-4))
    path = save_checkpoint(tmp_path / "ckpt", ts)
    assert path.name == "model_7.pkl"
    payload = jax_load(path)
    assert payload["iteration"] == 7 and payload["lr"] == pytest.approx(3e-4)
    rng = np.random.default_rng(0)
    aobs = rng.normal(size=(64, 380)).astype(np.float32)
    cobs = rng.normal(size=(64, 630)).astype(np.float32)
    mean, std, value = _flax_outputs(cfg, payload, aobs, cobs)
    with torch.no_grad():
        tmean, tstd = actor(torch.as_tensor(aobs))
        tvalue = critic(torch.as_tensor(cobs))
    np.testing.assert_allclose(tmean.numpy(), mean, atol=1e-5)
    np.testing.assert_allclose(tstd.numpy(), std, atol=1e-5)
    np.testing.assert_allclose(tvalue.numpy(), value, atol=1e-5)


def test_jax_checkpoint_loads_in_port(tmp_path):
    cfg = loader.compose(SELS, [MOTION])
    c = cfg.algo.config
    ka, kc = jax.random.split(jax.random.PRNGKey(5))
    flax_actor = FlaxActor(tuple(c.module_dict.actor.layer_config.hidden_dims), 23, 0.8, "ELU")
    flax_critic = FlaxCritic(tuple(c.module_dict.critic.layer_config.hidden_dims), 21, "ELU")
    jts = SimpleNamespace(iteration=jnp.asarray(4), lr=jnp.asarray(2e-4),
                          actor_params=flax_actor.init(ka, jnp.zeros((1, 380))),
                          critic_params=flax_critic.init(kc, jnp.zeros((1, 630))))
    path = jax_train.save_artifact(tmp_path, 4, jts)
    payload = load_checkpoint_payload(path)
    actor = convert.from_flax(payload["actor_params"], actor_from_config(cfg, 380, 23))
    critic = convert.from_flax(payload["critic_params"], critic_from_config(cfg, 630, 21))
    rng = np.random.default_rng(1)
    aobs = rng.normal(size=(64, 380)).astype(np.float32)
    cobs = rng.normal(size=(64, 630)).astype(np.float32)
    mean, _, value = _flax_outputs(cfg, payload, aobs, cobs)
    with torch.no_grad():
        np.testing.assert_allclose(actor(torch.as_tensor(aobs))[0].numpy(), mean, atol=1e-5)
        np.testing.assert_allclose(critic(torch.as_tensor(cobs)).numpy(), value, atol=1e-5)


@pytest.mark.parametrize("solver", ["lanes", "pallas"])
def test_train_cli_two_iterations(tmp_path, solver):
    _, ts, logs = train.main([*SELS, "num_envs=128", MOTION, f"simulator.config.solver={solver}",
                           "algo.config.num_learning_iterations=2", "algo.config.logging_interval=5",
                           "device=cpu", f"base_dir={tmp_path}"])
    assert ts.iteration == 2 and [log["iteration"] for log in logs] == [1, 2]
    for log in logs:
        bad = {k: v for k, v in log.items() if not np.isfinite(v)}
        assert not bad, bad
    (run,) = (tmp_path / "PBHC_TPU").iterdir()
    cfg = json.loads((run / "config.json").read_text())
    assert cfg["simulator"]["config"]["solver"] == solver and cfg["num_envs"] == 128
    with open(run / "ckpt" / "model_2.pkl", "rb") as f:
        payload = pickle.load(f)
    assert payload["iteration"] == 2
    _assert_same_params(payload["actor_params"], convert.flax_params(ts.actor))


def _assert_same_params(a, b):
    for path, v in jax.tree_util.tree_flatten_with_path(a)[0]:
        np.testing.assert_array_equal(v, dict(jax.tree_util.tree_flatten_with_path(b)[0])[path])


# the logging runs: one iteration, 32 envs, 4 steps per env
SMALL = [*SELS, "num_envs=32", MOTION, "algo.config.num_steps_per_env=4", "algo.config.num_learning_iterations=1"]


def test_use_wandb_without_wandb_trains(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)          # `import wandb` raises ImportError
    _, ts, logs = train.main([*SMALL, "use_wandb=true", "device=cpu", f"base_dir={tmp_path}",
                              f"artifact_dir={tmp_path}/art"])
    out = capsys.readouterr().out
    assert "[train] use_wandb=true but wandb unavailable (" in out and "); TB only\n" in out
    assert ts.iteration == 1 and len(logs) == 1
    (run,) = (tmp_path / "PBHC_TPU").iterdir()
    assert "use_wandb=true but wandb unavailable" in (run / "train.log").read_text()


def test_tensorboard_tags_match_jax_cli(tmp_path, monkeypatch):
    """The port's event file against the scalars the JAX CLI hands its
    `SummaryWriter` for the same run (a recorder in its place: JAX never
    closes its writer, so its file may be unflushed when `main` returns)."""
    pytest.importorskip("tensorboard")
    import torch.utils.tensorboard as tb
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    train.main([*SMALL, "device=cpu", f"base_dir={tmp_path}/port", f"artifact_dir={tmp_path}/art"])
    (run,) = (tmp_path / "port" / "PBHC_TPU").iterdir()
    acc = EventAccumulator(str(run))
    acc.Reload()
    port = {tag: [e.step for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}

    written = {}

    class Recorder:
        def __init__(self, log_dir):
            pass

        def add_scalar(self, tag, value, step):
            written.setdefault(tag, []).append(step)

    monkeypatch.setattr(tb, "SummaryWriter", Recorder)
    jax_train.main([*SMALL, f"base_dir={tmp_path}/jax", f"artifact_dir={tmp_path}/art"])
    assert "Perf/total_fps" in written and "Loss/kl" in written and len(written) > 10
    assert port == written
