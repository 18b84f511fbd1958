"""Port parity: config snapshots, MJCF parsing and the G1 model builders.

The port (`pbhc_tpu_torch`) must describe the robot exactly as `pbhc_tpu`
does: every field of every RobotModel is compared for exact equality.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(2)

from pbhc_tpu.model import g1 as jg1  # noqa: E402
from pbhc_tpu.model.mjcf import load_mjcf as jax_load_mjcf  # noqa: E402
from pbhc_tpu_torch.config import loader as tl  # noqa: E402
from pbhc_tpu_torch.model import g1 as tg1  # noqa: E402
from pbhc_tpu_torch.model.mjcf import load_mjcf, strip_xml_comments  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
G1 = REPO / "assets" / "robots" / "g1"
SNAPSHOTS = sorted(tl.SNAPSHOT_DIR.glob("*.json"))


def assert_models_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, list):
            assert len(x) == len(y), f.name
            for u, v in zip(x, y):
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v), err_msg=f.name)
        elif x is None:
            assert y is None, f.name
        else:
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f.name)


@pytest.mark.parametrize("snap", SNAPSHOTS, ids=lambda p: p.stem)
def test_snapshot_equals_run_config(snap):
    """Each JSON snapshot is exactly yaml.safe_load of its run's config.yaml."""
    src = REPO / "artifacts" / snap.stem / "config.yaml"
    assert json.loads(snap.read_text()) == yaml.safe_load(src.read_text())


def test_snapshot_for_checkpoint_and_missing_run():
    cfg = tl.snapshot_for_checkpoint(REPO / "artifacts/kb1_side_kick/ckpt/model_10500.pkl")
    assert cfg.simulator.config.solver == "lanes" and cfg.num_envs == 4096
    with pytest.raises(FileNotFoundError, match="no config snapshot"):
        tl.snapshot_for_checkpoint(REPO / "artifacts/no_such_run/ckpt/model_1.pkl")


@pytest.mark.parametrize("text", ["true", "false", "null", "0", "2", "0.5", "1e-5", "-3.25",
                                  "[0, 2]", "lanes", "assets/motions/Side_kick.pkl"])
def test_parse_scalar_matches_yaml(text):
    """CLI override values parse as the JAX loader's yaml.safe_load does
    (YAML 1.1 reads '1e-5' as a string, JSON as a float: the port's choice)."""
    want = yaml.safe_load(text)
    if text == "1e-5":
        want = 1e-5
    assert tl.parse_scalar(text) == want


def test_overrides_reach_nested_keys():
    cfg = tl.Cfg.wrap(tl.apply_overrides(tl.load_snapshot("kb1_side_kick"),
                                         ["domain_rand.push_robots=false", "new.key=3"]))
    assert cfg.domain_rand.push_robots is False and cfg.new.key == 3


def test_strip_nested_comments():
    assert strip_xml_comments("a<!-- x <!-- y --> z -->b<!--c-->d") == "abd"


@pytest.mark.parametrize("xml", ["g1_23dof_lock_wrist.xml", "g1_23dof_lock_wrist_fitmotionONLY.xml"])
def test_robot_model_fields_equal(xml):
    assert_models_equal(jax_load_mjcf(G1 / xml), load_mjcf(G1 / xml))


@pytest.mark.parametrize("self_collision", [True, False])
def test_g1_sim_model_equal(self_collision):
    assert_models_equal(jg1.load_g1_sim_model("g1_23dof_lock_wrist", self_collision=self_collision),
                        tg1.load_g1_sim_model("g1_23dof_lock_wrist", self_collision=self_collision))


def test_g1_motion_model_equal():
    cfg = tl.load_snapshot("kb1_side_kick")
    ext = [dict(e) for e in cfg.robot.motion.extend_config]
    assert_models_equal(jg1.load_g1_motion_model("g1_23dof_lock_wrist", ext),
                        tg1.load_g1_motion_model("g1_23dof_lock_wrist", ext))
