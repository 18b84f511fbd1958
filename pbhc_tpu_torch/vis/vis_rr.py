"""Rerun-based interactive motion viewer (counterpart of
`pbhc_tpu/vis/vis_rr.py`; reference robot_motion_process/vis_rr.py): streams
the FK'd skeleton of a motion pkl (the port's `MotionLib`, its `gts`, built
on `device`) to a rerun viewer.

rerun is an optional dependency, imported only when no `rr` backend is
given; without it the module raises with a pointer to the matplotlib
renderer (`pbhc_tpu_torch.vis.vis_motion`).

Usage: python -m pbhc_tpu_torch.vis.vis_rr motion.pkl [robot_type=...] [fps=30] [device=cpu]
"""
from __future__ import annotations

import sys

import numpy as np


def stream_motion(motion_file, robot_type="g1_23dof_lock_wrist", fps=30, rr=None, device="cuda"):
    if rr is None:
        try:
            import rerun as rr  # noqa: F811
        except ImportError as e:
            raise SystemExit(
                "rerun is not installed; use "
                "`python -m pbhc_tpu_torch.vis.vis_motion <pkl> <gif>` instead") from e

    from pbhc_tpu_torch.model.g1 import load_g1_motion_model
    from pbhc_tpu_torch.motion.motion_lib import MotionLib
    from pbhc_tpu_torch.vis.vis_motion import skeleton_segments

    model = load_g1_motion_model(robot_type)
    ml = MotionLib(motion_file, model, num_envs=1, step_dt=1.0 / fps, device=device)
    gts = ml.data.gts.cpu().numpy()                       # [F,B,3]

    rr.init("pbhc_tpu_motion", spawn=True)
    for t in range(gts.shape[0]):
        rr.set_time_sequence("frame", t)
        segs = skeleton_segments(model, gts[t])
        rr.log("skeleton", rr.LineStrips3D([np.asarray(s) for s in segs]))
        rr.log("bodies", rr.Points3D(gts[t]))
    return gts.shape[0]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv[1:])
    n = stream_motion(argv[0], robot_type=kv.get("robot_type", "g1_23dof_lock_wrist"),
                      fps=int(kv.get("fps", 30)), device=kv.get("device", "cuda"))
    print(f"streamed {n} frames")


if __name__ == "__main__":
    main()
