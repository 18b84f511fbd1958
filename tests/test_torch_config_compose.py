"""Port parity: config composition and the override scalar reader.

The port composes the JAX package's config groups from JSON copies
(`pbhc_tpu_torch/config/groups/`); each copy must equal `yaml.safe_load` of
its YAML source, and `compose` must equal the JAX `compose` exactly (values
and types, after a JSON round trip) on every selection set the repo's tests
compose, under overrides of the interpolation sources. `parse_scalar` must
type a value as `yaml.safe_load` does.
"""
import json
import math
from pathlib import Path

import pytest
import yaml

from pbhc_tpu.config.loader import compose as jax_compose
from pbhc_tpu_torch.config import loader as tl

REPO = Path(__file__).resolve().parents[1]
CFG_DIR = REPO / "pbhc_tpu" / "config"
YAMLS = sorted(CFG_DIR.rglob("*.yaml"))

V1 = ["exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking", "rewards=motion_tracking",
      "domain_rand=main", "simulator=tpu"]


def _with(sels, group, name):
    return [f"{group}={name}" if s.startswith(f"{group}=") else s for s in sels]


SETS = {"v1": V1, "v1-dr-off": _with(V1, "domain_rand", "off"),
        "v1-locomotion": V1 + ["terrain=locomotion"], "v1-plane": V1 + ["terrain=plane"],
        "v1-only-leg": _with(V1, "robot", "g1_only_leg"), "v1-general": _with(V1, "robot", "g1_23dof_general"),
        **{f"kb2-{robot}-{role}": ["exp=general_tracking", f"robot={robot}", f"obs=general_tracking_{role}",
                                   "rewards=general_tracking", "domain_rand=main", "simulator=tpu"]
           for robot in ("g1_23dof_student", "g1_29dof") for role in ("teacher", "student")}}
OVERRIDES = {"none": [], "history": ["obs.history_length=3"], "future": ["obs.future_num_steps=5"],
             "bodies": ["robot.num_bodies=20"],
             "scalars": ["algo.config.learning_rate=1e-5", "seed=1", "env.config.x=.5", "env.config.y=off"]}


def _plain(obj):
    return json.loads(json.dumps(obj))


def test_every_group_file_has_a_json_copy():
    copies = sorted(tl.GROUP_DIR.rglob("*.json"))
    assert len(YAMLS) == len(copies) == 31
    assert [p.relative_to(CFG_DIR).with_suffix("") for p in YAMLS] == \
        [p.relative_to(tl.GROUP_DIR).with_suffix("") for p in copies]


@pytest.mark.parametrize("src", YAMLS, ids=lambda p: p.relative_to(CFG_DIR).with_suffix("").as_posix())
def test_group_json_equals_yaml(src):
    """Each group's JSON copy is `yaml.safe_load` of its YAML, `defaults`
    lists and `${...}` strings raw."""
    copy = tl.GROUP_DIR / src.relative_to(CFG_DIR).with_suffix(".json")
    assert json.loads(copy.read_text()) == (yaml.safe_load(src.read_text()) or {})


@pytest.mark.parametrize("ovs", OVERRIDES, ids=str)
@pytest.mark.parametrize("name", SETS, ids=str)
def test_compose_equals_jax(name, ovs):
    """Overrides go in before the interpolations are resolved, as in JAX: an
    override of `obs.history_length`, `obs.future_num_steps` or
    `robot.num_bodies` reaches every key that interpolates it."""
    sels, o = SETS[name], OVERRIDES[ovs]
    want = _plain(jax_compose(str(CFG_DIR), sels, o))
    got = tl.compose(sels, o)
    assert _plain(got) == want
    if ovs == "bodies" and name.startswith("v1"):
        assert got.obs.obs_dims.dif_local_rigid_body_pos == 3 * 20 + 9
    if ovs == "scalars":
        assert got.algo.config.learning_rate == "1e-5" and got.env.config.y is False


def test_missing_group_file_raises_in_both():
    with pytest.raises(FileNotFoundError):
        jax_compose(str(CFG_DIR), V1 + ["exp=nope"])
    with pytest.raises(FileNotFoundError):
        tl.compose(V1 + ["exp=nope"])


@pytest.mark.parametrize("sels", list(tl.COMPOSED), ids=lambda s: tl.COMPOSED[s])
def test_composed_snapshot_equals_compose(sels):
    """The committed snapshot of each CLI selection set is its composition."""
    snap = json.loads((tl.SNAPSHOT_DIR / f"{tl.COMPOSED[sels]}.json").read_text())
    assert _plain(tl.compose(sels)) == snap


# the cases where JSON-and-words typing differed from YAML 1.1, quoted
# strings, flow collections, comments, and the usual override values
SCALARS = ["1e-5", ".5", "yes", "off", "None", "0x10", "1_000", "+1", "true", "False", "null", "~", "",
           "0", "-3.25", "1.0e+5", "1.0e5", "-.5e+3", "017", "0b101", "-0x1F", "12:30", "1:30.5", ".inf",
           "-.Inf", ".NaN", "tRue", "y", "lanes", "assets/motions/Side_kick.pkl", "a b", "a #comment",
           "a#b", "'it''s'", '"tab\\there \\u00e9"', "'1'", "[0, 2]", "[]", "{a: 1}", "{}", "[a: 1]",
           "{a, b: [1, {c: off}]}", '{"enable": true, "kwargs": {"theta": 1.0, "sigma": 1.0}}',
           "[1.0e+5, .5, yes, null, '2']", "http://x:80/y", "{a:1}"]


def _same(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("text", SCALARS)
def test_parse_scalar_equals_yaml_safe_load(text):
    assert _same(yaml.safe_load(text), tl.parse_scalar(text))


@pytest.mark.parametrize("text", ["a: 1", "- x", "&a 1", "*a", "!!str 1", "[1, 2", "'open", "2024-01-01",
                                  "a\nb", "{a: 1} x"])
def test_parse_scalar_refuses_what_it_does_not_read(text):
    """Block collections, anchors, aliases, tags, timestamps, several lines
    and malformed flow: a `ValueError`, never a value that differs from YAML's."""
    with pytest.raises(ValueError):
        tl.parse_scalar(text)
