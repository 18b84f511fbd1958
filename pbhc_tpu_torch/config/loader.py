"""Config access for the port (counterpart of `pbhc_tpu/config/loader.py`).

Configs are read from JSON snapshots under `config/snapshots/`, so the port
needs no YAML parser. A run directory the port's training CLI writes holds
its own config as `config.json`, which `snapshot_for_checkpoint` reads
first, and as `config.yaml` (`to_yaml`, an emitter of the port's own), which
`pbhc_tpu`'s loaders read. The committed snapshots are of two kinds:
- one per committed run directory (`artifacts/<run>/config.yaml` ->
  `<run>.json`); a test holds each equal to `yaml.safe_load` of its source;
- one per CLI selection set the port runs (`COMPOSED`): the JAX loader's
  `compose(selections)` with no overrides. `compose` here applies dotted
  overrides on top of it; a test holds that equal to the JAX `compose` for the
  overrides the port's commands use (none of them touches an interpolation
  source, which the JAX loader resolves after the overrides).
"""
from __future__ import annotations

import json
import math
import re
from pathlib import Path

SNAPSHOT_DIR = Path(__file__).resolve().parent / "snapshots"


class Cfg(dict):
    """dict with attribute access (recursive); `pbhc_tpu/config/loader.py:28`."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return Cfg({k: Cfg.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Cfg.wrap(v) for v in obj]
        return obj

    def get_path(self, dotted, default=None):
        node = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


_WORDS = {"true": True, "false": False, "null": None, "none": None, "~": None}


def parse_scalar(s: str):
    """CLI override value -> bool/None/int/float/list, else the string itself.

    Covers what the JAX loader's `yaml.safe_load` gives for override values in
    practice (`true`, `0`, `0.5`, `1e-5`, `[0, 2]`)."""
    t = s.strip()
    if t.lower() in _WORDS:
        return _WORDS[t.lower()]
    try:
        return json.loads(t)
    except ValueError:
        return s


def set_dotted(cfg: dict, dotted: str, value):
    node = cfg
    parts = dotted.split(".")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def load_snapshot(name: str) -> Cfg:
    """The JSON snapshot of run `name` as a `Cfg`."""
    path = SNAPSHOT_DIR / f"{name}.json"
    if not path.is_file():
        have = sorted(p.stem for p in SNAPSHOT_DIR.glob("*.json"))
        raise FileNotFoundError(f"no config snapshot {path.name} (have: {have})")
    return Cfg.wrap(json.loads(path.read_text()))


def snapshot_for_run(run_dir) -> Cfg:
    """Config of the run directory `run_dir`: its `config.json` where it has
    one (the port's training CLI writes it), else the committed snapshot
    named after the directory."""
    run_dir = Path(run_dir).resolve()
    own = run_dir / "config.json"
    if own.is_file():
        return Cfg.wrap(json.loads(own.read_text()))
    return load_snapshot(run_dir.name)


def snapshot_for_checkpoint(ckpt_path) -> Cfg:
    """Config of the run that wrote `ckpt_path` (`<run>/ckpt/model_<it>.pkl`)."""
    return snapshot_for_run(Path(ckpt_path).resolve().parent.parent)


# YAML 1.1 as PyYAML resolves plain scalars: a string may stay unquoted only if
# it starts with a letter, `_` or `/`, holds no character YAML gives a meaning,
# and is none of the words YAML reads as a bool or null
_PLAIN = re.compile(r"[A-Za-z_/][A-Za-z0-9_./-]*")
_YAML_WORDS = {"yes", "no", "on", "off", "true", "false", "null", "y", "n"}


def _yaml_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r and "." not in r.split("e")[0]:
            r = r.replace("e", ".0e", 1)      # YAML 1.1 floats need a `.`: 1e-05 -> 1.0e-05
        return r
    if isinstance(v, str):
        if _PLAIN.fullmatch(v) and v.lower() not in _YAML_WORDS:
            return v
        return json.dumps(v)                  # a double-quoted YAML scalar
    if isinstance(v, dict) and not v:
        return "{}"
    if isinstance(v, (list, tuple)) and not v:
        return "[]"
    raise TypeError(f"to_yaml: cannot write {type(v).__name__} {v!r}")


def _yaml_lines(obj, indent: int):
    pad = " " * indent
    if isinstance(obj, dict) and obj:
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"to_yaml: key {k!r} is not a string")
            if isinstance(v, (dict, list, tuple)) and v:
                yield f"{pad}{_yaml_scalar(k)}:"
                yield from _yaml_lines(v, indent + 2)
            else:
                yield f"{pad}{_yaml_scalar(k)}: {_yaml_scalar(v)}"
    elif isinstance(obj, (list, tuple)) and obj:
        for v in obj:
            if isinstance(v, (dict, list, tuple)) and v:
                first, *rest = _yaml_lines(v, indent + 2)
                yield f"{pad}- {first.lstrip()}"
                yield from rest
            else:
                yield f"{pad}- {_yaml_scalar(v)}"
    else:
        yield pad + _yaml_scalar(obj)


def to_yaml(obj) -> str:
    """Block-style YAML of a config (dicts with string keys, lists, strings,
    ints, floats, bools, None) that `yaml.safe_load` reads back equal, types
    included: every float carries a `.` (`1.0e-05`) and every string YAML
    would resolve to something else is double-quoted."""
    return "\n".join(_yaml_lines(obj, 0)) + "\n"


def apply_overrides(cfg: dict, overrides=()):
    for ov in overrides:
        k, v = ov.split("=", 1)
        set_dotted(cfg, k, parse_scalar(v))
    return cfg


# CLI selection set -> the snapshot of its composition
_V1 = ("exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking", "rewards=motion_tracking",
       "domain_rand=main", "simulator=tpu")
COMPOSED = {
    _V1: "motion_tracking_g1_23dof",
    # the same on the heightfield curriculum terrain (`config/terrain/locomotion.yaml`)
    _V1 + ("terrain=locomotion",): "motion_tracking_g1_23dof_terrain",
    # KungfuBot2 teacher and student (README's general_tracking commands), with
    # the robot groups the committed `artifacts/kb2_*` runs were composed from
    **{("exp=general_tracking", f"robot={robot}", f"obs=general_tracking_{role}", "rewards=general_tracking",
        "domain_rand=main", "simulator=tpu"): f"general_tracking_{role}_{name}"
       for robot, name in (("g1_23dof_student", "g1_23dof"), ("g1_29dof", "g1_29dof"))
       for role in ("teacher", "student")},
}

# top-level keys that are overrides, not group selections (`loader.py:189-200`),
# plus the port's `device`
_OVERRIDE_KEYS = {"num_envs", "seed", "checkpoint", "experiment_name", "project_name", "headless",
                  "base_dir", "multichip", "use_wandb", "save_motion", "log_task_name",
                  "auto_load_latest", "total_iterations", "watchdog_timeout_s",
                  "watchdog_boot_timeout_s", "artifact_dir", "device"}


def compose(selections=(), overrides=()) -> Cfg:
    """The composed config of `selections` (`pbhc_tpu/config/loader.py:168`)
    with dotted `overrides` applied, from the selection set's snapshot."""
    sels = tuple(s.lstrip("+") for s in selections)
    name = COMPOSED.get(sels)
    if name is None:
        raise FileNotFoundError(f"no config snapshot for the selections {list(sels)}; the port "
                                f"has snapshots for {[list(k) for k in COMPOSED]}")
    return Cfg.wrap(apply_overrides(load_snapshot(name), overrides))


def parse_cli(argv):
    """Split CLI args into (selections, overrides): group=name vs dotted.key=v
    (`loader.py:189`)."""
    sels, ovs = [], []
    for a in argv:
        a = a.lstrip("+")
        key = a.split("=", 1)[0]
        (ovs if "." in key or key in _OVERRIDE_KEYS else sels).append(a)
    return sels, ovs
