"""Motion / rollout visualization (counterpart of `pbhc_tpu/vis/vis_motion.py`;
reference robot_motion_process/vis_q_mj.py and visualize.py).

Without a GL stack, the tool draws the G1 skeleton (FK'd bones + optional
reference ghost) with matplotlib and writes an animated GIF/MP4. Input is
either a motion pkl or a rollout trajectory from the eval harness. The FK is
the port's batched `fk_pose_aa` on `device` (default the first CUDA card);
matplotlib is imported inside the functions that draw, so the module
imports where matplotlib is not installed.

CLI:
    python -m pbhc_tpu_torch.vis.vis_motion motion.pkl out.gif [fps=30] [stride=2] [robot_type=...] [device=cpu]
"""
from __future__ import annotations

import sys

import numpy as np


def skeleton_segments(model, body_pos):
    """[B,3] joint positions -> list of (parent, child) segments."""
    segs = []
    for i in range(1, model.num_bodies):
        p = model.parent[i]
        segs.append((body_pos[p], body_pos[i]))
    return segs


def motion_frames(motion_file, robot_type="g1_23dof_lock_wrist", stride=2, max_frames=400, device="cuda"):
    """(model, FK'd body positions [F,B,3]) of the first clip of `motion_file`,
    every `stride`-th frame, at most `max_frames`."""
    import torch

    from pbhc_tpu_torch.model.g1 import load_g1_motion_model
    from pbhc_tpu_torch.model.kinematics import fk_pose_aa
    from pbhc_tpu_torch.motion.motion_lib import load_motion_dict

    model = load_g1_motion_model(robot_type)
    clip = next(iter(load_motion_dict(motion_file).values()))
    f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32)[::stride][:max_frames], device=device)
    with torch.no_grad():
        p, _ = fk_pose_aa(model, f32(clip["pose_aa"]), f32(clip["root_trans_offset"]))
    return model, p.cpu().numpy()


def render_motion(motion_file, out_path, robot_type="g1_23dof_lock_wrist",
                  fps=30, stride=2, ghost=None, max_frames=400, device="cuda"):
    model, frames = motion_frames(motion_file, robot_type, stride, max_frames, device)
    return _animate(model, frames, out_path, fps=max(1, fps // stride), ghost=ghost)


def render_trajectory(model, body_pos_traj, out_path, fps=25, ghost=None):
    """Render an eval rollout trajectory [T,B,3] (+ optional reference ghost)."""
    return _animate(model, np.asarray(body_pos_traj), out_path, fps=fps, ghost=ghost)


def _animate(model, frames, out_path, fps=15, ghost=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as anim
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    center = frames[:, 0, :2].mean(0)

    def draw(t):
        ax.cla()
        ax.set_xlim(center[0] - 1, center[0] + 1)
        ax.set_ylim(center[1] - 1, center[1] + 1)
        ax.set_zlim(0, 2)
        for src in ([ghost[t]] if ghost is not None else []):
            for a, b in skeleton_segments(model, src):
                ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], c="0.7", lw=1)
        for a, b in skeleton_segments(model, frames[t]):
            ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], c="tab:blue", lw=2)
        ax.scatter(*frames[t, 0], c="r", s=20)
        ax.set_title(f"frame {t}/{len(frames)}")

    ani = anim.FuncAnimation(fig, draw, frames=len(frames), interval=1000 / fps)
    writer = anim.PillowWriter(fps=fps) if str(out_path).endswith(".gif") else anim.FFMpegWriter(fps=fps)
    ani.save(out_path, writer=writer)
    plt.close(fig)
    return out_path


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    pos = [a for a in argv if "=" not in a]
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    out = render_motion(pos[0], pos[1], fps=int(kv.get("fps", 30)),
                        stride=int(kv.get("stride", 2)),
                        robot_type=kv.get("robot_type", "g1_23dof_lock_wrist"),
                        device=kv.get("device", "cuda"))
    print(f"[vis] wrote {out}")


if __name__ == "__main__":
    main()
