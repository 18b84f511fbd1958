"""Read and write the flax-layout checkpoint pickles (counterpart of
`pbhc_tpu/utils/checkpoint.py::load_checkpoint_payload`, `.pkl` branch, and of
`pbhc_tpu/train.py::save_artifact`, `:389-421`).

A checkpoint is a plain pickle of `{iteration, lr, actor_params,
critic_params}`, the params as numpy dicts in flax layout. Both packages read
it without JAX, flax or orbax: the committed `artifacts/*/ckpt/model_<it>.pkl`
files are such pickles, and `pbhc_tpu` loads the ones the port writes. Orbax
checkpoint directories (with optimizer state) are neither read nor written.
"""
from __future__ import annotations

import os
import pickle
from pathlib import Path

from pbhc_tpu_torch.agents.convert import flax_params


def load_checkpoint_payload(path) -> dict:
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"{path}: not a checkpoint file (orbax directories are not read by the port)")
    with open(path, "rb") as f:
        return pickle.load(f)


def save_checkpoint(ckpt_dir, ts) -> Path:
    """Write `ts` (an `MHPPO` train state) as `<ckpt_dir>/model_<iteration>.pkl`."""
    payload = {"iteration": int(ts.iteration), "lr": float(ts.lr),
               "actor_params": flax_params(ts.actor), "critic_params": flax_params(ts.critic)}
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"model_{payload['iteration']}.pkl"
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)
    return path
