"""Config access for the port (counterpart of `pbhc_tpu/config/loader.py`).

Configs are read from JSON snapshots under `config/snapshots/`, so the port
needs no YAML parser. There are two kinds:
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


def snapshot_for_checkpoint(ckpt_path) -> Cfg:
    """Config of the run that wrote `ckpt_path` (`<run>/ckpt/model_<it>.pkl`)."""
    return load_snapshot(Path(ckpt_path).resolve().parent.parent.name)


def apply_overrides(cfg: dict, overrides=()):
    for ov in overrides:
        k, v = ov.split("=", 1)
        set_dotted(cfg, k, parse_scalar(v))
    return cfg


# CLI selection set -> the snapshot of its composition
COMPOSED = {
    ("exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking", "rewards=motion_tracking",
     "domain_rand=main", "simulator=tpu"): "motion_tracking_g1_23dof",
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
