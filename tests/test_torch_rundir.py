"""Port parity: a run directory written by the port's training CLI is
evaluated by both packages.

- `pbhc_tpu_torch.train.main` runs 2 iterations at 128 envs on the CPU.
- Its `config.yaml` reads back through `yaml.safe_load` equal to its
  `config.json`, types included (every float a float).
- The port's `batch_eval.load` reads the run (from `config.json`) and steps
  it with `rollout_ratio`.
- `pbhc_tpu.eval.batch_eval._load` builds its env and algo from the same
  directory (from `config.yaml`) and loads the checkpoint, whose actor
  parameters equal the trained ones exactly.
- The emitter round-trips the scalars YAML 1.1 resolves differently from
  JSON (`1e-05`, `"yes"`, `"1e3"`, ...) and nested collections.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(2)

from pbhc_tpu.eval import batch_eval as jax_batch_eval  # noqa: E402
from pbhc_tpu_torch import train  # noqa: E402
from pbhc_tpu_torch.agents import convert  # noqa: E402
from pbhc_tpu_torch.config import loader  # noqa: E402
from pbhc_tpu_torch.eval import batch_eval  # noqa: E402

SELS = ["exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking", "rewards=motion_tracking",
        "domain_rand=main", "simulator=tpu"]
MOTION = "robot.motion.motion_file=assets/motions/Horse-stance_punch.pkl"
ITERS = 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(run directory, final train state) of a 2-iteration CPU training run."""
    base = tmp_path_factory.mktemp("runs")
    _, ts, _ = train.main([*SELS, "num_envs=128", MOTION, f"algo.config.num_learning_iterations={ITERS}",
                           "device=cpu", f"base_dir={base}"])
    (run_dir,) = (base / "PBHC_TPU").iterdir()
    return run_dir, ts


def _same(a, b):
    """Equal values of equal types (floats as floats, -0.0 keeps its sign)."""
    if isinstance(a, float):
        return isinstance(b, float) and (a == b and math.copysign(1, a) == math.copysign(1, b)
                                         or a != a and b != b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and a == b


def test_config_yaml_reads_back_as_config_json(run):
    run_dir, _ = run
    want = json.loads((run_dir / "config.json").read_text())
    got = yaml.safe_load((run_dir / "config.yaml").read_text())
    assert _same(want, got)
    assert got["env"]["config"]["termination_curriculum"]["terminate_when_motion_far_curriculum_degree"] == 2.5e-05


def test_port_batch_eval_reads_the_run(run):
    run_dir, _ = run
    ckpt = run_dir / "ckpt" / f"model_{ITERS}.pkl"
    cfg = loader.snapshot_for_checkpoint(ckpt)
    assert cfg == json.loads((run_dir / "config.json").read_text())
    env, actor, cfg = batch_eval.load(ckpt, 16, device="cpu")
    assert cfg.num_envs == 16 and cfg.simulator.config.solver == "lanes"
    state, obs = batch_eval.start_episodes(env)
    state, first, nonfinite = batch_eval.rollout_ratio(env, actor, state, obs, 3)
    assert first.shape == (16,) and int(nonfinite) == 0
    assert torch.isfinite(state.sim.root_pos).all()


def test_jax_batch_eval_reads_the_run(run):
    run_dir, ts = run
    env, algo, payload = jax_batch_eval._load(run_dir / "ckpt" / f"model_{ITERS}.pkl", 16)
    assert env.num_envs == 16 and type(algo).__name__ == "MHPPO"
    assert payload["iteration"] == ITERS
    want = jax.tree_util.tree_flatten_with_path(convert.flax_params(ts.actor))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(payload["actor_params"])[0])
    for path, v in want:
        np.testing.assert_array_equal(np.asarray(got[path]), v)


def test_committed_run_still_reads_its_snapshot():
    cfg = loader.snapshot_for_checkpoint("artifacts/kb1_side_kick/ckpt/model_10500.pkl")
    assert cfg == loader.load_snapshot("kb1_side_kick")


@pytest.mark.parametrize("value", [
    1e-05, 1e20, -0.0, 2.5e-07, -1e-06, 0.1, 3.0, float("inf"), -float("inf"), 7, -3, 0, True, False, None,
    "yes", "No", "on", "OFF", "y", "null", "~", "1e3", "0x1F", "12", ".5", "-", "", "a b", "key: v", "#x",
    "[1]", "{a}", "'q'", '"dq"', "tab\there", "é", "a/b.c-d_e", "Horse-stance_punch",
    [[1, 2.0], [], [["no", 1e-05]]], {"a": {"b": [None, {}, {"c": -0.0}]}, "d": []},
], ids=repr)
def test_to_yaml_round_trips(value):
    doc = {"k": value, "1e-05": [value, {"x": value}]}
    assert _same(doc, yaml.safe_load(loader.to_yaml(doc)))
