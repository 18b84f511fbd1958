"""Offline motion-processing tools (counterpart of `pbhc_tpu/motion/tools.py`).

* `interpolate_default_pose`: default-pose lead-in/out blending with yaw
  correction (reference robot_motion_process/motion_interpolation_pkl.py:10-60).
* `convert_29dof_to_23dof`: strip wrist DoFs (reference convert_29dof_to_23dof.py).
* contact-mask recompute helper lives in pbhc_tpu_torch.motion.package.

* `lafan_to_pkl`: LAFAN-style CSV -> motion pkl (reference motion_source/
  convert_lafan_pkl.py).
* `compute_contact_mask`: FK-based foot contact detection (reference
  motion_source/count_pkl_contact_mask.py).

Clips are read by the port's joblib reader (`motion_lib.load_joblib`) and
written by `motion/package.dump` (zlib level 3, which `joblib.load` reads);
`compute_contact_mask`'s FK is the port's batched `fk_pose_aa` on `device`.

CLI (every command keeps the JAX module's arguments; `device=cpu` runs the
contact mask's FK on the CPU, the default is the first CUDA card):
    python -m pbhc_tpu_torch.motion.tools interp in.pkl out.pkl [lead_in_s=0.5] [lead_out_s=0.5]
    python -m pbhc_tpu_torch.motion.tools 29to23 in.pkl out.pkl
    python -m pbhc_tpu_torch.motion.tools 23to29 in.pkl out.pkl
    python -m pbhc_tpu_torch.motion.tools lafan in.csv out.pkl [start=0] [end=N] [fps=30]
    python -m pbhc_tpu_torch.motion.tools ue in.pkl out.pkl
    python -m pbhc_tpu_torch.motion.tools contact_mask in.pkl out.pkl [vel_thres=] [height_thres=] [device=cpu]
    python -m pbhc_tpu_torch.motion.tools edit_contact in.pkl out.pkl set=L:10:50:1 [set=R:0:-1:0 ...]
"""
from __future__ import annotations

import sys

import numpy as np
import torch
from scipy.spatial.transform import Rotation as sRot

from pbhc_tpu_torch.model.g1 import load_g1_motion_model
from pbhc_tpu_torch.model.kinematics import fk_pose_aa
from pbhc_tpu_torch.motion.motion_lib import load_joblib
from pbhc_tpu_torch.motion.package import dump

# G1 29-dof joint order: 23-dof variant removes the 3 wrist joints per arm
# minus the single retained elbow... the lock-wrist variant drops
# wrist_roll/pitch/yaw on both arms (6 dofs): indices in the 29-dof order
_WRIST_IDX_29 = [19, 20, 21, 26, 27, 28]  # l/r wrist roll,pitch,yaw


def interpolate_default_pose(clip: dict, default_dof, default_root_height=0.793,
                             lead_in_s=0.5, lead_out_s=0.5):
    """Prepend/append a blend from/to the default standing pose."""
    fps = int(clip["fps"])
    n_in = int(lead_in_s * fps)
    n_out = int(lead_out_s * fps)
    dof = np.asarray(clip["dof"])
    trans = np.asarray(clip["root_trans_offset"])
    root_rot = np.asarray(clip["root_rot"])  # xyzw
    T, nd = dof.shape
    default_dof = np.asarray(default_dof, dtype=dof.dtype)

    # default pose aligned to the clip's initial yaw (reference :30-45)
    yaw0 = sRot.from_quat(root_rot[0]).as_euler("xyz")[2]
    q_default = sRot.from_euler("z", yaw0).as_quat()
    t_default = trans[0].copy()
    t_default[2] = default_root_height

    def blend(n, a_dof, a_trans, a_quat, b_dof, b_trans, b_quat):
        out_dof, out_trans, out_rot = [], [], []
        for i in range(n):
            w = (i + 1) / (n + 1)
            out_dof.append((1 - w) * a_dof + w * b_dof)
            out_trans.append((1 - w) * a_trans + w * b_trans)
            key = sRot.from_quat(np.stack([a_quat, b_quat]))
            from scipy.spatial.transform import Slerp

            out_rot.append(Slerp([0, 1], key)(w).as_quat())
        return np.asarray(out_dof), np.asarray(out_trans), np.asarray(out_rot)

    di, ti, ri = blend(n_in, default_dof, t_default, q_default, dof[0], trans[0], root_rot[0])
    do, to, ro = blend(n_out, dof[-1], trans[-1], root_rot[-1], default_dof,
                       trans[-1] * [1, 1, 0] + [0, 0, default_root_height],
                       sRot.from_euler("z", sRot.from_quat(root_rot[-1]).as_euler("xyz")[2]).as_quat())

    new = dict(clip)
    new["dof"] = np.concatenate([di, dof, do]).astype(np.float32)
    new["root_trans_offset"] = np.concatenate([ti, trans, to]).astype(np.float32)
    new["root_rot"] = np.concatenate([ri, root_rot, ro]).astype(np.float32)
    # rebuild pose_aa from root rot + dof * axes
    if "pose_aa" in clip:
        J = clip["pose_aa"].shape[1]
        n_extend = J - 1 - nd
        model = load_g1_motion_model()
        axes = np.asarray(model.dof_axis)[:nd]
        root_aa = sRot.from_quat(new["root_rot"]).as_rotvec()
        pose = np.concatenate(
            [root_aa[:, None, :], new["dof"][:, :, None] * axes[None],
             np.zeros((len(new["dof"]), n_extend, 3))], axis=1)
        new["pose_aa"] = pose.astype(np.float32)
    if "contact_mask" in clip:
        cm = np.asarray(clip["contact_mask"])
        new["contact_mask"] = np.concatenate(
            [np.ones((n_in, cm.shape[1])), cm, np.ones((n_out, cm.shape[1]))]).astype(cm.dtype)
    if "smpl_joints" in new:
        del new["smpl_joints"]
    return new


def convert_29dof_to_23dof(clip: dict):
    """Drop wrist dofs; lock-wrist pose_aa keeps 24+extend joints."""
    new = dict(clip)
    dof = np.asarray(clip["dof"])
    if dof.shape[1] != 29:
        raise ValueError(f"expects a 29-dof clip, got {dof.shape[1]} dofs")
    keep = [i for i in range(29) if i not in _WRIST_IDX_29]
    new["dof"] = dof[:, keep].astype(np.float32)
    if "pose_aa" in clip:
        pose = np.asarray(clip["pose_aa"])
        # pose_aa: [T, 1 + 29 + E, 3] -> [T, 1 + 23 + E, 3]
        body_keep = [0] + [1 + i for i in keep] + list(range(30, pose.shape[1]))
        new["pose_aa"] = pose[:, body_keep].astype(np.float32)
    return new


def convert_23dof_to_29dof(clip: dict):
    """Up-convert a lock-wrist 23-dof clip to the 29-dof order by inserting
    zero wrist dofs (the inverse of the reference's 29->23 wrist strip,
    convert_29dof_to_23dof.py) and rebuilding pose_aa on the 29-dof axes."""
    dof23 = np.asarray(clip["dof"], dtype=np.float32)
    if dof23.shape[1] != 23:
        raise ValueError(f"expects a 23-dof clip, got {dof23.shape[1]} dofs")
    T = len(dof23)
    dof29 = np.zeros((T, 29), dtype=np.float32)
    dof29[:, :19] = dof23[:, :19]
    dof29[:, 22:26] = dof23[:, 19:23]

    model = load_g1_motion_model("g1_29dof_rev_1_0")
    axes = np.asarray(model.dof_axis, dtype=np.float32)[:29]
    quat = np.asarray(clip["root_rot"], dtype=np.float32)
    root_aa = sRot.from_quat(quat).as_rotvec().astype(np.float32)
    n_extend = max(model.num_bodies - 30, 0) or 3
    pose_aa = np.concatenate(
        [root_aa[:, None], axes[None] * dof29[:, :, None],
         np.zeros((T, n_extend, 3), np.float32)], axis=1)
    new = {k: v for k, v in clip.items() if k not in ("dof", "pose_aa", "smpl_joints")}
    new["dof"] = dof29
    new["pose_aa"] = pose_aa.astype(np.float32)
    return new


def convert_ue_to_23dof(raw):
    """UE-exported walk clip (29 dof, loose key names) -> training schema
    (reference convert_ue_walk_to_23dof.py): accepts flat or {name: clip}
    nesting and dof_pos/root_pos key variants, drops the wrist dofs
    (19:22, 26:29), and rebuilds pose_aa = [root_aa, axis*dof, zeros(extend)]
    from the MJCF joint axes."""
    if isinstance(raw, dict) and raw and isinstance(next(iter(raw.values())), dict):
        first = next(iter(raw.values()))
        clip = first if ("dof" in first or "dof_pos" in first) else raw
    else:
        clip = raw
    dof = np.asarray(clip.get("dof_pos", clip.get("dof")), dtype=np.float32)
    if dof.ndim != 2 or dof.shape[-1] != 29:
        raise ValueError(f"expects a 29-dof UE clip, got dofs of shape {dof.shape}")
    dof23 = np.concatenate([dof[:, :19], dof[:, 22:26]], axis=1)
    trans = np.asarray(clip.get("root_trans_offset", clip.get("root_pos")), dtype=np.float32)
    quat = np.asarray(clip["root_rot"], dtype=np.float32)  # xyzw

    model = load_g1_motion_model()
    axes = np.asarray(model.dof_axis, dtype=np.float32)[: dof23.shape[1]]
    root_aa = sRot.from_quat(quat).as_rotvec().astype(np.float32)
    T = len(dof23)
    pose_aa = np.concatenate(
        [root_aa[:, None], axes[None] * dof23[:, :, None],
         np.zeros((T, 3, 3), np.float32)], axis=1)
    return {
        "root_trans_offset": trans,
        "pose_aa": pose_aa.astype(np.float32),
        "dof": dof23,
        "root_rot": quat,
        "fps": int(clip.get("fps", 30)),
    }


def lafan_to_pkl(csv_path: str, start=0, end=None, fps=30):
    """LAFAN-style CSV -> motion dict (reference motion_source/
    convert_lafan_pkl.py:8-39): rows are [root_trans(3), root_quat xyzw(4),
    dof(29)]; wrist dofs are dropped (19:22 and 26:29 in the 29-dof order) and
    pose_aa is rebuilt as [root_aa, axis*dof, zeros(extend)]."""
    data = np.genfromtxt(csv_path, delimiter=",").astype(np.float32)[start:end]
    root_trans = data[:, :3]
    root_qua = data[:, 3:7]
    dof = data[:, 7:]
    dof_new = np.concatenate([dof[:, :19], dof[:, 22:26]], axis=1)

    model = load_g1_motion_model()
    axes = np.asarray(model.dof_axis, dtype=np.float32)[: dof_new.shape[1]]
    root_aa = sRot.from_quat(root_qua).as_rotvec().astype(np.float32)
    pose_aa = np.concatenate(
        [root_aa[:, None], axes[None] * dof_new[:, :, None],
         np.zeros((len(data), 3, 3), np.float32)], axis=1)
    return {
        "root_trans_offset": root_trans,
        "pose_aa": pose_aa.astype(np.float32),
        "dof": dof_new.astype(np.float32),
        "root_rot": root_qua,
        "fps": fps,
    }


def compute_contact_mask(clip: dict, vel_thres=0.002, height_thres=0.12, device="cuda"):
    """Foot-contact detection from FK'd ankle positions (reference
    motion_source/count_pkl_contact_mask.py:18-37): contact when the squared
    frame-to-frame ankle displacement < vel_thres AND height < height_thres;
    frame 0 forced to contact. Returns the clip with a [T,2] contact_mask
    (L, R order, matching the reference). The FK runs on `device`."""
    model = load_g1_motion_model()
    names = list(model.body_names)
    fid = [next(i for i, n in enumerate(names) if s in n and "ankle_roll" in n)
           for s in ("left", "right")]
    f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)
    with torch.no_grad():
        p, _ = fk_pose_aa(model, f32(clip["pose_aa"]), f32(clip["root_trans_offset"]))
    feet = p[:, fid].cpu().numpy()                                 # [T,2,3]

    d2 = ((feet[1:] - feet[:-1]) ** 2).sum(-1)                     # [T-1,2]
    low = feet[1:, :, 2] < height_thres
    mask = ((d2 < vel_thres) & low).astype(np.float32)
    mask = np.concatenate([np.ones((1, 2), np.float32), mask], axis=0)
    new = dict(clip)
    new["contact_mask"] = mask
    return new


def edit_contact_mask(clip: dict, edits):
    """Hand-edit the contact mask over frame ranges — the CLI equivalent of
    the reference's interactive mask editing in vis_q_mj.py (key-driven
    toggle-and-resave, robot_motion_process/vis_q_mj.py:42-80).

    `edits` is a list of (foot, start, end, value) with foot in {"L","R"},
    end exclusive (negative indices allowed)."""
    new = dict(clip)
    T = len(np.asarray(clip["dof"]))
    cm = np.asarray(clip.get("contact_mask", np.ones((T, 2))), dtype=np.float32).copy()
    for foot, start, end, value in edits:
        col = {"L": 0, "R": 1}[foot.upper()]
        cm[start:end, col] = float(value)
    new["contact_mask"] = cm
    return new


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cmd, src, dst = argv[0], argv[1], argv[2]
    kv = dict(a.split("=", 1) for a in argv[3:])
    if cmd == "lafan":
        name = src.rsplit("/", 1)[-1].removesuffix(".csv")
        start = int(kv.get("start", 0))
        end = int(kv["end"]) if "end" in kv else None
        clip = lafan_to_pkl(src, start, end, fps=int(kv.get("fps", 30)))
        dump({f"{name}_{start}_{end if end is not None else 'end'}": clip}, dst)
        print(f"wrote {dst}")
        return
    if cmd == "ue":
        name = src.rsplit("/", 1)[-1].split(".")[0]
        clip = convert_ue_to_23dof(load_joblib(src))
        dump({name: clip}, dst)
        print(f"wrote {dst}")
        return
    data = load_joblib(src)
    out = {}
    for k, clip in data.items():
        if cmd == "interp":
            from pbhc_tpu_torch.config.loader import compose

            cfg = compose(["robot=g1_23dof"])
            model = load_g1_motion_model()
            dd = [cfg.robot.init_state.default_joint_angles[n] for n in model.dof_names]
            out[k] = interpolate_default_pose(
                clip, dd,
                lead_in_s=float(kv.get("lead_in_s", 0.5)),
                lead_out_s=float(kv.get("lead_out_s", 0.5)))
        elif cmd == "29to23":
            out[k] = convert_29dof_to_23dof(clip)
        elif cmd == "23to29":
            out[k] = convert_23dof_to_29dof(clip)
        elif cmd == "edit_contact":
            edits = []
            for a in argv[3:]:
                key, val = a.split("=", 1)
                if key != "set":
                    continue
                foot, start, end, value = val.split(":")
                edits.append((foot, int(start), int(end), float(value)))
            out[k] = edit_contact_mask(clip, edits)
            on = out[k]["contact_mask"].mean(0)
            print(f"{k}: contact fraction L={on[0]:.2f} R={on[1]:.2f}")
        elif cmd == "contact_mask":
            out[k] = compute_contact_mask(
                clip, vel_thres=float(kv.get("vel_thres", 0.002)),
                height_thres=float(kv.get("height_thres", 0.12)), device=kv.get("device", "cuda"))
            on = out[k]["contact_mask"].mean(0)
            print(f"{k}: contact fraction L={on[0]:.2f} R={on[1]:.2f}")
        else:
            raise SystemExit(f"unknown command {cmd}")
    dump(out, dst)
    print(f"wrote {dst}")


if __name__ == "__main__":
    main()
