"""SMPL motion visualizer: render a GVHMR/AMASS ``smpl.npz`` to GIF/MP4
(counterpart of `pbhc_tpu/vis/vis_smpl.py`; numpy, with matplotlib imported
inside the function that draws).

The reference renders SMPL meshes with a GPU renderer fed by the licensed
SMPL body model (reference smpl_vis/smpl_render.py:51-113 ``render``,
smpl_vis/utils/body_model_smpl.py).  Neither the model files nor GL ship with
the repository, so rendering is tiered:

  * **mesh** — when the user supplies an SMPL model file (``smpl_model=...``,
    ``$SMPL_MODEL_PATH``, or the ``assets/body_models/`` drop-in — the same
    user-supplied ``body_model/`` convention as the reference), frames are
    full LBS meshes drawn headlessly with matplotlib's Poly3DCollection.
  * **skeleton** — otherwise, the 24-joint skeleton via the same matplotlib
    backend as vis_motion.

CLI: python -m pbhc_tpu_torch.vis.vis_smpl smpl.npz out.gif [fps=] [stride=2] [smpl_model=<file>]
"""
from __future__ import annotations

import sys

import numpy as np

from pbhc_tpu_torch.motion.smpl_npz import SMPL_PARENTS, load_smpl_npz, npz_to_joints


def smpl_segments(joints_t):
    """[24,3] joint positions -> list of (parent, child) segment endpoints."""
    return [(joints_t[SMPL_PARENTS[j]], joints_t[j]) for j in range(1, 24)]


def _mesh_frames(npz_path, model_path, stride):
    """LBS the archive's poses through the user's body model -> z-up verts."""
    from pbhc_tpu_torch.motion.smpl_model import load_smpl_model, smpl_lbs

    data = load_smpl_npz(npz_path)
    model = load_smpl_model(model_path)
    verts, _ = smpl_lbs(
        model, data["poses"][::stride], data.get("betas"), data["trans"][::stride]
    )
    return verts.astype(np.float32), np.asarray(model["faces"]), data["fps"]


def render_smpl_npz(npz_path, out_path, fps=None, stride=2, smpl_model=None,
                    max_faces=4000):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as anim
    import matplotlib.pyplot as plt

    from pbhc_tpu_torch.motion.smpl_model import find_model_file

    model_path = find_model_file(smpl_model)
    verts = faces = None
    if model_path is not None:
        verts, faces, src_fps = _mesh_frames(npz_path, model_path, stride)
        if len(faces) > max_faces:  # thin the triangles to keep each frame's draw cheap
            faces = faces[:: int(np.ceil(len(faces) / max_faces))]
        center = verts[:, :, :2].reshape(-1, 2).mean(0)
        nframes = len(verts)
    else:
        joints, src_fps = npz_to_joints(npz_path)
        joints = joints[::stride]
        center = joints[:, 0, :2].mean(0)
        nframes = len(joints)
    fps = fps or max(1, int(round(src_fps / stride)))

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")

    def draw(t):
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        ax.cla()
        ax.set_xlim(center[0] - 1, center[0] + 1)
        ax.set_ylim(center[1] - 1, center[1] + 1)
        ax.set_zlim(0, 2)
        if verts is not None:
            tris = verts[t][faces]
            pc = Poly3DCollection(tris, alpha=0.6, linewidths=0.05)
            pc.set_facecolor("tab:green")
            pc.set_edgecolor("k")
            ax.add_collection3d(pc)
        else:
            for a, b in smpl_segments(joints[t]):
                ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]],
                        c="tab:green", lw=2)
            ax.scatter(*joints[t, 0], c="r", s=20)
        ax.set_title(f"frame {t}/{nframes}" + (" (mesh)" if verts is not None else ""))

    ani = anim.FuncAnimation(fig, draw, frames=nframes, interval=1000 / fps)
    writer = anim.PillowWriter(fps=fps) if str(out_path).endswith(".gif") \
        else anim.FFMpegWriter(fps=fps)
    ani.save(out_path, writer=writer)
    plt.close(fig)
    return out_path


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    pos = [a for a in argv if "=" not in a]
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    out = render_smpl_npz(pos[0], pos[1],
                          fps=int(kv["fps"]) if "fps" in kv else None,
                          stride=int(kv.get("stride", 2)),
                          smpl_model=kv.get("smpl_model"))
    print(f"[vis_smpl] wrote {out}")


if __name__ == "__main__":
    main()
