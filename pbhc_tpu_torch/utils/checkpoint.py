"""Read and write the flax-layout checkpoint pickles and resume from them
(counterpart of `pbhc_tpu/utils/checkpoint.py`, `.pkl` branch, and of
`pbhc_tpu/train.py::save_checkpoint`/`save_artifact`/the resume block,
`:173-204`, `:361-421`).

A checkpoint is a plain pickle: `{iteration, lr}` and the params as numpy
dicts in flax layout, `actor_params`/`critic_params` for MHPPO and `params`
for PPOMimic, which is what `pbhc_tpu` writes and reads. Both packages read
it without JAX, flax or orbax. A checkpoint of a run also holds the port's
optimizer state (Adam's step count and moments, per optimizer: `actor_opt`
and `critic_opt`, or `opt` and `hist_opt`) under `torch_optimizer`, a key
no JAX train state has, so `pbhc_tpu`'s resume takes the params and starts a
fresh optimizer. The artifact mirror and the committed `artifacts/*` pickles
hold params only; resuming from one starts a fresh optimizer here too.
Orbax checkpoint directories are neither read nor written.
"""
from __future__ import annotations

import os
import pickle
import re
from pathlib import Path

import torch

from pbhc_tpu_torch.agents.convert import flax_params, from_flax

OPT_KEY = "torch_optimizer"


def load_checkpoint_payload(path) -> dict:
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"{path}: not a checkpoint file (orbax directories are not read by the port)")
    with open(path, "rb") as f:
        return pickle.load(f)


def _nets(ts) -> dict:
    """payload key -> network of a train state (`MHPPO`'s or `PPOMimic`'s)."""
    if hasattr(ts, "net"):
        return {"params": ts.net}
    return {"actor_params": ts.actor, "critic_params": ts.critic}


def _optimizers(ts) -> dict:
    names = ("opt", "hist_opt") if hasattr(ts, "net") else ("actor_opt", "critic_opt")
    return {k: getattr(ts, k) for k in names if hasattr(ts, k)}


def _write(path: Path, payload) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)
    return path


def params_payload(ts) -> dict:
    return {"iteration": int(ts.iteration), "lr": float(ts.lr),
            **{k: flax_params(net) for k, net in _nets(ts).items()}}


def save_checkpoint(ckpt_dir, ts) -> Path:
    """Write `ts` (params and, where it has them, optimizer states) as
    `<ckpt_dir>/model_<iteration>.pkl`."""
    payload = params_payload(ts)
    opts = _optimizers(ts)
    if opts:
        payload[OPT_KEY] = {k: o.state_dict() for k, o in opts.items()}
    return _write(Path(ckpt_dir) / f"model_{payload['iteration']}.pkl", payload)


def save_artifact(art_dir, ts, keep: int = 2) -> Path:
    """The params-only mirror `<art_dir>/ckpt/model_<iteration>.pkl`, keeping
    the newest `keep` (`pbhc_tpu/train.py:389-421`)."""
    ckpt = Path(art_dir) / "ckpt"
    path = _write(ckpt / f"model_{int(ts.iteration)}.pkl", params_payload(ts))
    old = sorted(ckpt.glob("model_*.pkl"), key=lambda p: int(re.match(r"model_(\d+)", p.name).group(1)))
    for p in old[:-keep]:
        p.unlink(missing_ok=True)
    return path


def restore_train_state(ts, payload, load_optimizer: bool = True):
    """Resume `ts` in place from a checkpoint payload (`pbhc_tpu/train.py:173-204`):
    the params it holds, the optimizer states when it holds them and
    `load_optimizer`, the lr, and the iteration (0 when absent)."""
    for key, net in _nets(ts).items():
        if key in payload:
            from_flax(payload[key], net)
    if load_optimizer and OPT_KEY in payload:
        for key, opt in _optimizers(ts).items():
            opt.load_state_dict(payload[OPT_KEY][key])
    ts.iteration = int(payload.get("iteration", 0))
    ts.lr = torch.tensor(float(payload.get("lr", float(ts.lr))), dtype=torch.float32, device=ts.lr.device)
    return ts


def latest_checkpoint(root, experiment_name=None):
    """Newest `model_<it>` checkpoint under `root` (a run dir, its ckpt/, or
    a logs tree filtered by experiment name), as `pbhc_tpu/utils/checkpoint.py:53`
    picks it: the highest iteration, then the newest file. None when empty."""
    pat = re.compile(r"model_(\d+)(\.pkl)?$")
    cands = []
    for p in Path(root).rglob("model_*"):
        m = pat.match(p.name)
        if not m:
            continue
        if experiment_name and f"-{experiment_name}-" not in str(p.parent.parent):
            continue
        cands.append((int(m.group(1)), p.stat().st_mtime, p))
    return max(cands)[2] if cands else None
