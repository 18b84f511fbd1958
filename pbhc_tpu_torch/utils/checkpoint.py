"""Read the flax-layout checkpoint pickles (counterpart of
`pbhc_tpu/utils/checkpoint.py::load_checkpoint_payload`, `.pkl` branch).

The committed `artifacts/*/ckpt/model_<it>.pkl` files are plain pickles of
numpy dicts (`{iteration, lr, actor_params, critic_params}`); they load
without JAX, flax or orbax. Orbax checkpoint directories are not read here.
"""
from __future__ import annotations

import pickle
from pathlib import Path


def load_checkpoint_payload(path) -> dict:
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"{path}: not a checkpoint file (orbax directories are not read by the port)")
    with open(path, "rb") as f:
        return pickle.load(f)
