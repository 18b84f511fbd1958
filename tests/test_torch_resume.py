"""Training resume and the run directory of the port's training CLI, for
both agents (PPOMimic on the KungfuBot2 teacher config, MHPPO on the
KungfuBot-v1 config), on the CPU at 32 envs and 4 steps per iteration.

- A 2-iteration run resumed with `checkpoint=<model_2.pkl>
  total_iterations=3` runs exactly one iteration from the saved params,
  Adam moments and step counts, lr and iteration (all compared exactly).
- A params-only pickle (a committed artifact, or the run's mirror) and
  `load_optimizer=false` resume with a fresh optimizer.
- `auto_load_latest` picks what `pbhc_tpu.utils.checkpoint.latest_checkpoint`
  picks, and the port's `latest_checkpoint` agrees with it on a tree of run
  directories, pickles and orbax-style directories.
- `pbhc_tpu`'s resume filter (`train.py:183-188`: payload keys that are
  fields of its train state) takes the params and ignores the port's
  optimizer key.
- The run directory holds `train.log` and the logged scalars as JSON lines;
  the artifact mirror keeps the newest 2.
"""
import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu.agents.mh_ppo import TrainState as JaxTrainState  # noqa: E402
from pbhc_tpu.agents.ppo_mimic import MimicTrainState as JaxMimicTrainState  # noqa: E402
from pbhc_tpu.utils.checkpoint import latest_checkpoint as jax_latest  # noqa: E402
from pbhc_tpu.utils.checkpoint import load_checkpoint_payload as jax_load  # noqa: E402
from pbhc_tpu_torch import train  # noqa: E402
from pbhc_tpu_torch.agents import convert  # noqa: E402
from pbhc_tpu_torch.config import loader  # noqa: E402
from pbhc_tpu_torch.utils.checkpoint import (OPT_KEY, latest_checkpoint, load_checkpoint_payload,  # noqa: E402
                                             restore_train_state, save_artifact)

KB2 = ["exp=general_tracking", "robot=g1_23dof_student", "obs=general_tracking_teacher",
       "rewards=general_tracking", "domain_rand=main", "simulator=tpu",
       "robot.motion.motion_file=assets/motions/g1_ue_walk_23dof.pkl"]
KB1 = ["exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking", "rewards=motion_tracking",
       "domain_rand=main", "simulator=tpu", "robot.motion.motion_file=assets/motions/Horse-stance_punch.pkl"]
SMALL = ["num_envs=32", "device=cpu", "algo.config.num_steps_per_env=4", "algo.config.logging_interval=5"]
AGENTS = {"ppo_mimic": (KB2, ("opt", "hist_opt")), "mh_ppo": (KB1, ("actor_opt", "critic_opt"))}


def _run(tmp_path, sels, *extra):
    return train.main([*sels, *SMALL, f"base_dir={tmp_path / 'logs'}", f"artifact_dir={tmp_path / 'art'}",
                       *extra])


def _assert_state_equals_payload(ts, payload, opt_names):
    assert ts.iteration == payload["iteration"]
    assert float(ts.lr) == np.float32(payload["lr"])
    for key, net in (("params", getattr(ts, "net", None)), ("actor_params", getattr(ts, "actor", None)),
                     ("critic_params", getattr(ts, "critic", None))):
        if net is None:
            continue
        got = dict(convert._flat(convert.flax_params(net)))
        for k, v in convert._flat(payload[key]):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    for name in opt_names:
        saved, opt = payload[OPT_KEY][name], getattr(ts, name)
        assert opt.count == saved["count"] > 0
        for a, b in (*zip(opt.mu, saved["mu"]), *zip(opt.nu, saved["nu"])):
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("agent", sorted(AGENTS))
def test_resume_runs_the_remaining_iteration_from_the_saved_state(tmp_path, agent):
    sels, opt_names = AGENTS[agent]
    _, ts2, _ = _run(tmp_path, sels, "algo.config.num_learning_iterations=2")
    (run,) = (tmp_path / "logs" / "PBHC_TPU").iterdir()
    ckpt = run / "ckpt" / "model_2.pkl"
    payload = load_checkpoint_payload(ckpt)
    _assert_state_equals_payload(ts2, payload, opt_names)

    cfg = loader.compose(sels[:6], [sels[6], *SMALL])
    _, _, fresh = train.build(cfg)
    restore_train_state(fresh, payload)
    _assert_state_equals_payload(fresh, payload, opt_names)

    _, ts3, logs = _run(tmp_path, sels, f"checkpoint={ckpt}", "total_iterations=3")
    assert ts3.iteration == 3 and [log["iteration"] for log in logs] == [3]
    runs = sorted((tmp_path / "logs" / "PBHC_TPU").iterdir())
    assert (runs[-1] / "ckpt" / "model_3.pkl").is_file()
    assert "resumed from" in (runs[-1] / "train.log").read_text()
    # the resumed iteration continued the saved optimizers: 5 epochs x 4
    # minibatches of RL steps (iteration 2 runs no DAgger pass)
    for name in opt_names:
        steps = 0 if name == "hist_opt" else 20
        assert getattr(ts3, name).count == payload[OPT_KEY][name]["count"] + steps, name


def test_params_only_pickle_and_load_optimizer_false_start_fresh(tmp_path):
    cfg = loader.compose(KB2[:6], [KB2[6], *SMALL])
    _, _, ts = train.build(cfg)
    committed = load_checkpoint_payload("artifacts/kb2_teacher23_r3/ckpt/model_24000.pkl")
    restore_train_state(ts, committed)
    assert ts.iteration == 24000 and float(ts.lr) == np.float32(committed["lr"])
    assert ts.opt.count == ts.hist_opt.count == 0 and all(float(m.abs().max()) == 0 for m in ts.opt.mu)
    with torch.no_grad():
        got = dict(convert._flat(convert.flax_params(ts.net)))
    for k, v in convert._flat(committed["params"]):
        np.testing.assert_array_equal(got[k], v)

    _run(tmp_path, KB2, "algo.config.num_learning_iterations=1")
    (run,) = (tmp_path / "logs" / "PBHC_TPU").iterdir()
    _, ts_fresh, _ = _run(tmp_path, KB2, f"checkpoint={run / 'ckpt' / 'model_1.pkl'}",
                             "algo.config.load_optimizer=false", "total_iterations=2")
    assert ts_fresh.iteration == 2 and ts_fresh.opt.count == 4 * 5     # one iteration from count 0


def test_auto_load_latest_picks_what_jax_picks(tmp_path):
    _run(tmp_path, KB2, "algo.config.num_learning_iterations=1", "experiment_name=kb2a")
    _run(tmp_path, KB2, "algo.config.num_learning_iterations=2", "experiment_name=kb2b")
    root = tmp_path / "logs" / "PBHC_TPU"
    want = jax_latest(root, experiment_name="kb2a")
    assert want.name == "model_1.pkl"
    _, ts, logs = _run(tmp_path, KB2, "auto_load_latest=true", "experiment_name=kb2a", "total_iterations=2")
    assert ts.iteration == 2 and [log["iteration"] for log in logs] == [2]
    assert f"auto_load_latest -> {want}" in sorted(root.glob("*kb2a*"))[-1].joinpath("train.log").read_text()


def test_latest_checkpoint_agrees_with_jax(tmp_path):
    root = tmp_path / "logs" / "PBHC_TPU"
    layout = {"20260101_000000-expA-task/ckpt/model_5.pkl": 1, "20260101_000000-expA-task/ckpt/model_40": 2,
              "20260102_000000-expA-task/ckpt/model_12.pkl": 3, "20260103_000000-expB-task/ckpt/model_90.pkl": 4,
              "20260104_000000-expA-task/ckpt/model_40.pkl": 5, "20260104_000000-expA-task/ckpt/notes.txt": 6,
              "20260104_000000-expA-task/ckpt/model_7.tmp": 7}
    for rel, t in layout.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        if rel.endswith("model_40"):
            p.mkdir()
        else:
            p.write_text("x")
        os.utime(p, (1e9 + t, 1e9 + t))
    for kw in ({}, {"experiment_name": "expA"}, {"experiment_name": "expB"}, {"experiment_name": "none"}):
        assert latest_checkpoint(root, **kw) == jax_latest(root, **kw), kw
    assert latest_checkpoint(root / "20260102_000000-expA-task") == jax_latest(root / "20260102_000000-expA-task")


def test_jax_resume_filter_ignores_the_optimizer_key(tmp_path):
    """The port's checkpoint through `pbhc_tpu`'s loader and its resume filter."""
    _run(tmp_path, KB2, "algo.config.num_learning_iterations=1")
    (run,) = (tmp_path / "logs" / "PBHC_TPU").iterdir()
    payload = jax_load(run / "ckpt" / "model_1.pkl")
    assert OPT_KEY in payload
    for cls in (JaxMimicTrainState, JaxTrainState):
        fields = {f.name for f in dataclasses.fields(cls)}
        taken = {k for k in payload if k in fields and k not in ("iteration", "lr")}
        assert OPT_KEY not in fields and taken <= {"params", "actor_params", "critic_params"}
    assert {k for k in payload if k in {f.name for f in dataclasses.fields(JaxMimicTrainState)}} \
        == {"params", "iteration", "lr"}


def test_run_directory_log_scalars_and_mirror(tmp_path):
    _, ts, _ = _run(tmp_path, KB2, "algo.config.num_learning_iterations=2")
    (run,) = (tmp_path / "logs" / "PBHC_TPU").iterdir()
    assert "[train] experiment dir" in (run / "train.log").read_text()
    lines = [json.loads(x) for x in (run / "scalars.jsonl").read_text().splitlines()]
    assert [x["iteration"] for x in lines] == [1, 2]
    for x in lines:
        assert {"Loss/priv_reg", "Loss/surrogate", "Loss/lr", "Perf/total_fps", "Train/mean_step_reward"} <= set(x)
        assert all(np.isfinite(v) for v in x.values())
    assert "Loss/hist_latent" in lines[0] and "Loss/hist_latent" not in lines[1]   # iteration 0: RL + DAgger
    mirror = tmp_path / "art" / "General_Tracking"
    assert json.loads((mirror / "config.json").read_text())["num_envs"] == 32
    (mirrored,) = (mirror / "ckpt").iterdir()
    with open(mirrored, "rb") as f:
        assert OPT_KEY not in pickle.load(f)
    for _ in range(3):
        ts.iteration += 1
        save_artifact(mirror, ts)
    assert sorted(p.name for p in (mirror / "ckpt").iterdir()) == ["model_4.pkl", "model_5.pkl"]
