"""Config composition for the port (counterpart of `pbhc_tpu/config/loader.py`).

The JAX package's YAML config groups are shipped as JSON under
`config/groups/<group>/<name>.json` (a test holds each equal to
`yaml.safe_load` of its source), so the port needs no YAML parser.
`compose(selections, overrides)` composes them as the JAX loader does: the
base file, then each selected group file (with Hydra-style `defaults`), then
the dotted overrides, then the `${...}` interpolations. Override values and
interpolated strings are typed by `parse_scalar`, a YAML 1.1 reader of one
line that gives what `yaml.safe_load` gives.

Run configs are JSON snapshots under `config/snapshots/`: one per committed
run directory (`artifacts/<run>/config.yaml` -> `<run>.json`), and one per
selection set in `COMPOSED` (its composition with no overrides). A run
directory the port's training CLI writes holds its own config as
`config.json`, which `snapshot_for_checkpoint` reads first, and as
`config.yaml` (`to_yaml`, an emitter of the port's own), which `pbhc_tpu`'s
loaders read.
"""
from __future__ import annotations

import copy
import json
import math
import re
from pathlib import Path

SNAPSHOT_DIR = Path(__file__).resolve().parent / "snapshots"
GROUP_DIR = Path(__file__).resolve().parent / "groups"


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


# PyYAML's implicit resolvers of plain scalars (YAML 1.1, `yaml/resolver.py`),
# tried in its order: bool, float, int, merge, null, timestamp, value
_BOOL = {w: w.lower() in ("yes", "true", "on") for w in
         ("yes", "Yes", "YES", "no", "No", "NO", "true", "True", "TRUE", "false", "False", "FALSE",
          "on", "On", "ON", "off", "Off", "OFF")}
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = {"~", "null", "Null", "NULL", ""}
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                        (?:[Tt]|[ \t]+)[0-9][0-9]?
                        :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# YAML's double-quoted escapes (`yaml/scanner.py`)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b",
            "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(digits: str, cast):
    value = 0
    for part in digits.split(":"):
        value = value * 60 + cast(part)
    return value


def _plain(text: str):
    """A plain scalar typed as PyYAML's SafeLoader types it."""
    if text in _BOOL:
        return _BOOL[text]
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        return sign * (_sexagesimal(v, float) if ":" in v else float(v))
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * (_sexagesimal(v, int) if ":" in v else int(v))
    if text in _NULL:
        return None
    if text in ("<<", "=") or _TIMESTAMP.match(text):
        raise ValueError(f"parse_scalar: {text!r} is a YAML merge key, value key or timestamp, "
                         "which no config holds")
    return text


class _Line:
    """Recursive-descent reader of one line of YAML: a plain or quoted
    scalar, or flow sequences and mappings of them. Block collections,
    anchors, aliases, tags and directives raise `ValueError`."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def fail(self, what):
        raise ValueError(f"parse_scalar: {what} at column {self.i} of {self.s!r}")

    def peek(self, k=0):
        j = self.i + k
        return self.s[j] if j < len(self.s) else ""

    def skip_ws(self):
        while self.peek() in (" ", "\t"):
            self.i += 1

    def at_value_colon(self, flow):
        return self.peek() == ":" and (self.peek(1) in ("", " ", "\t") or (flow and self.peek(1) in ",[]{}"))

    def node(self, flow: bool):
        self.skip_ws()
        c = self.peek()
        if c == "[":
            return self.collection("]")
        if c == "{":
            return self.collection("}")
        if c in ("'", '"'):
            return self.quoted(c)
        if c in ("-", "?", ":") and self.peek(1) in ("", " ", "\t"):
            self.fail("block collections are not read")
        if c and c in ",[]{}#&*!|>%@`":
            self.fail(f"{c!r} cannot start a scalar here")
        return self.plain(flow)

    def plain(self, flow):
        start = j = self.i
        s = self.s
        while j < len(s):
            c = s[j]
            if c in " \t":
                k = j
                while k < len(s) and s[k] in " \t":
                    k += 1
                if k == len(s) or s[k] == "#":
                    break
                j = k
                continue
            self.i = j
            if self.at_value_colon(flow) or (flow and c in ",?[]{}"):
                break
            j += 1
        self.i = j
        return _plain(s[start:j].rstrip(" \t"))

    def quoted(self, q):
        s, j, out = self.s, self.i + 1, []
        while True:
            if j >= len(s):
                self.i = j
                self.fail("unclosed quoted scalar")
            c = s[j]
            if c == q:
                if q == "'" and s[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                self.i = j + 1
                return "".join(out)
            if c == "\\" and q == '"':
                e = s[j + 1:j + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    j += 2
                elif e in _ESCAPE_CODES:
                    n = _ESCAPE_CODES[e]
                    digits = s[j + 2:j + 2 + n]
                    if len(digits) != n or any(d not in "0123456789abcdefABCDEF" for d in digits):
                        self.i = j
                        self.fail("bad escape")
                    out.append(chr(int(digits, 16)))
                    j += 2 + n
                else:
                    self.i = j
                    self.fail("unknown escape")
                continue
            out.append(c)
            j += 1

    def collection(self, close):
        """`[a, b: c]` (a pair inside a sequence is a one-key mapping) or
        `{a: 1, b}` (a key with no value maps to None)."""
        self.i += 1
        out = [] if close == "]" else {}
        while True:
            self.skip_ws()
            if self.peek() == close:
                self.i += 1
                return out
            if self.peek() in ("", ","):
                self.fail(f"an entry or {close!r} expected")
            adjacent = self.peek() in ("'", '"', "[", "{")
            key = self.node(True)
            self.skip_ws()
            if self.peek() == ":" and (adjacent or self.at_value_colon(True)):
                self.i += 1
                self.skip_ws()
                value = None if self.peek() in (",", close) else self.node(True)
                if close == "]":
                    out.append({key: value})
                else:
                    out[key] = value
            elif close == "]":
                out.append(key)
            else:
                out[key] = None
            self.skip_ws()
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != close:
                self.fail(f"',' or {close!r} expected")


def parse_scalar(s: str):
    """One line of YAML (a CLI override value, an interpolated string) as
    `yaml.safe_load` reads it: PyYAML's bool, null, int and float resolvers
    (YAML 1.1: `yes`/`off` are bools, `0x10` and `1_000` ints, `1e-5` a
    string since a float needs a `.`), quoted strings, and flow sequences
    and mappings of these. Raises `ValueError` on YAML it does not read."""
    if any(c in s for c in "\n\r"):
        raise ValueError(f"parse_scalar: {s!r} is not one line")
    line = _Line(s)
    line.skip_ws()
    value = None if line.peek() in ("", "#") else line.node(False)
    line.skip_ws()
    if line.at_value_colon(False):
        line.fail("block mappings are not read")
    if line.peek() not in ("", "#"):
        line.fail("unexpected text")
    return value


def set_dotted(cfg: dict, dotted: str, value):
    node = cfg
    parts = dotted.split(".")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def deep_merge(dst: dict, src: dict) -> dict:
    """`src` merged into `dst` (`loader.py:58`): nested dicts merge, anything
    else replaces, copied."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            deep_merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


_INTERP = re.compile(r"\$\{([^${}]+)\}")
_EVAL_QUOTED = re.compile(r"\$\{eval:\s*'([^']*)'\s*\}")
_EVAL_BARE = re.compile(r"\$\{eval:\s*([^{}]*)\}")


def _resolve_str(s: str, root: dict, depth=0):
    """`loader.py:79`: `${eval:'expr'}` evaluated (no builtins) after its inner
    references; a whole-string `${path}` keeps the referenced value's type;
    embedded references are substituted, and a changed string is re-typed
    by `parse_scalar`."""
    if depth > 10:
        raise ValueError(f"interpolation loop resolving {s!r}")

    def lookup(path: str):
        node = root
        for part in path.split("."):
            node = node[part]
        return node

    def sub(m):
        return str(_resolve_value(lookup(m.group(1)), root, depth + 1))

    original = s
    while True:
        m = _EVAL_QUOTED.search(s) or _EVAL_BARE.search(s)
        if m is None:
            break
        val = eval(_INTERP.sub(sub, m.group(1)), {"__builtins__": {}}, {})  # arithmetic only
        s = s[:m.start()] + str(val) + s[m.end():]

    m = _INTERP.fullmatch(s.strip())
    if m and not m.group(1).startswith("eval:"):
        return _resolve_value(lookup(m.group(1)), root, depth + 1)

    out = _INTERP.sub(sub, s)
    return parse_scalar(out) if out != original else s


def _resolve_value(v, root, depth=0, strict=True):
    if isinstance(v, str) and "${" in v:
        try:
            return _resolve_str(v, root, depth)
        except (KeyError, TypeError):
            # foreign resolvers (Hydra's ${now:...}, ${oc.env:...}) in run
            # configs of the reference: kept raw in lenient mode
            if strict:
                raise
            return v
    return v


def resolve_interpolations(cfg: dict, strict: bool = True):
    """Every `${...}` of `cfg` resolved against `cfg` (`loader.py:124`),
    repeated to a fixpoint over at most 5 passes."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return _resolve_value(node, cfg, strict=strict)

    prev, out = None, cfg
    for _ in range(5):
        out = walk(out)
        if out == prev:
            break
        prev = out
    return out


def _load_file(path: Path) -> dict:
    """A group file with its Hydra `defaults` (`loader.py:148`): entries are
    `_self_` (the file's own keys at that point), `{"/group": name}` or a
    sibling file's name, merged in order; the own keys last if `_self_` is
    not listed. A missing file raises `FileNotFoundError`."""
    raw = json.loads(path.read_text()) or {}
    defaults = raw.pop("defaults", None)
    merged: dict = {}
    for entry in defaults or ():
        if entry == "_self_":
            deep_merge(merged, raw)
            raw = {}
            continue
        if isinstance(entry, dict):
            ((group, name),) = entry.items()
            sub = _load_file(GROUP_DIR / str(group).lstrip("/") / f"{name}.json")
        else:
            sub = _load_file(path.parent / f"{entry}.json")
        deep_merge(merged, sub)
    return deep_merge(merged, raw)


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


# the selection sets with a committed snapshot of their composition (no
# overrides), which the CLIs, README and `chip_smoke.py` run
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
    """`base` + the group selections (`group=name`, later ones win) + the
    dotted `overrides`, then the interpolations resolved, as
    `pbhc_tpu/config/loader.py:168` composes them."""
    cfg = _load_file(GROUP_DIR / "base.json")
    for sel in selections:
        group, name = sel.lstrip("+").split("=", 1)
        deep_merge(cfg, _load_file(GROUP_DIR / group / f"{name}.json"))
    apply_overrides(cfg, overrides)
    return Cfg.wrap(resolve_interpolations(cfg))


def parse_cli(argv):
    """Split CLI args into (selections, overrides): group=name vs dotted.key=v
    (`loader.py:189`)."""
    sels, ovs = [], []
    for a in argv:
        a = a.lstrip("+")
        key = a.split("=", 1)[0]
        (ovs if "." in key or key in _OVERRIDE_KEYS else sels).append(a)
    return sels, ovs
