"""Motion packaging (counterpart of `pbhc_tpu/motion/package.py`).

Merge single-clip pkls into one multi-motion library file, list its clips,
and compute contact masks from foot height and velocity thresholds.

The library is written without joblib: a plain pickle through zlib at level
3, which `joblib.load` reads (it detects zlib by its first byte, as it does
the `joblib.dump(..., compress=3)` the JAX module writes) and the port's
`motion_lib.load_joblib` reads too.

CLI:
    python -m pbhc_tpu_torch.motion.package merge out.pkl a.pkl b.pkl ...
    python -m pbhc_tpu_torch.motion.package info lib.pkl
"""
from __future__ import annotations

import pickle
import sys
import zlib
from pathlib import Path

import numpy as np

from pbhc_tpu_torch.motion.motion_lib import load_joblib

COMPRESS_LEVEL = 3   # joblib.dump's compress=3, the JAX module's


def dump(obj, path):
    """`obj` pickled and zlib-compressed into `path`, readable by `joblib.load`."""
    Path(path).write_bytes(zlib.compress(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL), COMPRESS_LEVEL))


def merge(out_path, in_paths):
    """The clips of every file of `in_paths`, in order, written to `out_path`;
    a clip whose key is taken already is renamed `<file stem>__<key>`."""
    lib = {}
    for p in in_paths:
        for k, v in load_joblib(p).items():
            key = f"{Path(p).stem}__{Path(str(k)).name}" if k in lib else k
            lib[key] = v
    dump(lib, out_path)
    return out_path


def info(path):
    """(key, frames, fps, seconds, has contact_mask) for each clip of `path`."""
    rows = []
    for k, v in load_joblib(path).items():
        T = v["pose_aa"].shape[0]
        fps = v.get("fps", 30)
        rows.append((k, T, fps, T / fps, "contact_mask" in v))
    return rows


def compute_contact_mask(body_pos, foot_indices, fps, height_thr=0.08, vel_thr=0.4):
    """Height and velocity foot contact detection (reference
    convert_fit_motion.foot_detect): [T, B, 3] body positions -> [T, feet]."""
    feet = body_pos[:, foot_indices]
    vel = np.zeros_like(feet)
    vel[1:] = (feet[1:] - feet[:-1]) * fps
    speed = np.linalg.norm(vel, axis=-1)
    low = feet[..., 2] < height_thr
    slow = speed < vel_thr
    return (low & slow).astype(np.float64)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cmd = argv[0]
    if cmd == "merge":
        out = merge(argv[1], argv[2:])
        print(f"wrote {out} ({len(load_joblib(out))} clips)")
    elif cmd == "info":
        for k, T, fps, secs, has_cm in info(argv[1]):
            print(f"{k}: {T} frames @ {fps} fps = {secs:.2f}s contact_mask={has_cm}")
    else:
        raise SystemExit(f"unknown command {cmd}")


if __name__ == "__main__":
    main()
