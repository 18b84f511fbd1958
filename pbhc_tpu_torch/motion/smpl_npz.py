"""GVHMR/AMASS-style SMPL ``.npz`` ingestion (counterpart of
`pbhc_tpu/motion/smpl_npz.py`).

The reference pipeline's first stage (GVHMR, reference motion_source/demo.py:203-215
``save_npz``) emits a z-up SMPL motion archive::

    smpl.npz: betas [10] f32, gender str, poses [T,72] f32 (axis-angle: root
              orient in poses[:, :3] already rotated into z-up world by demo.py's
              ``transform1``), trans [T,3] f32 (z-up), mocap_framerate float

which the retarget stage consumes. This module takes everything from the
``.npz`` onward:

    load_smpl_npz   -- schema-validated load (numpy)
    smpl_fk         -- 24-joint SMPL skeleton FK (numpy, no body-model file)
    npz_to_joints   -- npz -> z-up world joint positions [T,24,3]
    npz_to_clip     -- npz -> retargeted G1 motion clip dict (the port's
                       `retarget_smpl_joints` and batched FK, on `device`)
    main            -- CLI: .npz -> motion .pkl, written by `motion/package.dump`
                       (zlib level 3, which `joblib.load` reads)

    python -m pbhc_tpu_torch.motion.smpl_npz in.npz out.pkl [--name <key>] [--iters 600]
        [--robot g1_23dof_lock_wrist] [--smpl-model <file>] [device=cpu]

Shape approximation: the SMPL body-model file (betas -> joint regressor) is a
licensed external asset that is not in the repository, so FK uses the
canonical neutral mean-shape joint offsets below and ignores ``betas``
unless a model file is supplied (`motion/smpl_model.py`). The systematic
skeleton mismatch this introduces is absorbed by the per-match-point offset
parameters that ``retarget_smpl_joints`` fits.
"""
from __future__ import annotations

import numpy as np

# Standard SMPL 24-joint hierarchy (joint index -> parent index).
SMPL_JOINT_NAMES = [
    "pelvis", "left_hip", "right_hip", "spine1", "left_knee", "right_knee",
    "spine2", "left_ankle", "right_ankle", "spine3", "left_foot", "right_foot",
    "neck", "left_collar", "right_collar", "head", "left_shoulder",
    "right_shoulder", "left_elbow", "right_elbow", "left_wrist", "right_wrist",
    "left_hand", "right_hand",
]
SMPL_PARENTS = np.asarray(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 20, 21], dtype=np.int32)

# Neutral mean-shape joint offsets, parent-relative, in the SMPL canonical
# (y-up, x-left) body frame: an approximation of the neutral template's rest
# skeleton (betas ignored -- see module docstring).  Meters.
SMPL_NEUTRAL_OFFSETS = np.asarray([
    [0.000, 0.000, 0.000],    # pelvis (root)
    [+0.058, -0.082, -0.018],  # left_hip
    [-0.058, -0.082, -0.018],  # right_hip
    [0.000, +0.105, -0.013],   # spine1
    [+0.043, -0.386, 0.002],   # left_knee
    [-0.043, -0.386, 0.002],   # right_knee
    [0.000, +0.137, 0.003],    # spine2
    [-0.015, -0.400, -0.045],  # left_ankle
    [+0.015, -0.400, -0.045],  # right_ankle
    [0.000, +0.056, 0.002],    # spine3
    [+0.025, -0.062, +0.122],  # left_foot
    [-0.025, -0.062, +0.122],  # right_foot
    [0.000, +0.212, -0.034],   # neck
    [+0.081, +0.113, -0.019],  # left_collar
    [-0.081, +0.113, -0.019],  # right_collar
    [0.000, +0.066, +0.050],   # head
    [+0.092, +0.035, -0.009],  # left_shoulder
    [-0.092, +0.035, -0.009],  # right_shoulder
    [+0.257, -0.012, -0.013],  # left_elbow
    [-0.257, -0.012, -0.013],  # right_elbow
    [+0.251, +0.009, -0.004],  # left_wrist
    [-0.251, +0.009, -0.004],  # right_wrist
    [+0.083, -0.011, -0.012],  # left_hand
    [-0.083, -0.011, -0.012],  # right_hand
], dtype=np.float64)


def load_smpl_npz(path) -> dict:
    """Load + validate a GVHMR/AMASS SMPL npz (reference demo.py:214 schema).

    Returns {"poses" [T,24,3] f64 axis-angle, "trans" [T,3] f64, "betas" [10],
    "fps" float, "gender" str}.  Accepts poses stored as [T,72] or [T,24,3];
    AMASS archives with >72 pose dims (SMPL-H/X hands) are truncated to the
    24-joint body.
    """
    raw = np.load(path, allow_pickle=True)
    missing = {"poses", "trans"} - set(raw.files)
    if missing:
        raise ValueError(f"{path}: missing npz keys {sorted(missing)} "
                         "(expected GVHMR save_npz schema: betas/poses/trans/"
                         "mocap_framerate)")
    poses = np.asarray(raw["poses"], dtype=np.float64)
    if poses.ndim == 2:
        if poses.shape[1] < 72:
            raise ValueError(f"poses [T,{poses.shape[1]}]: need >=72 pose dims")
        poses = poses[:, :72].reshape(-1, 24, 3)
    elif poses.ndim == 3:
        poses = poses[:, :24]
    else:
        raise ValueError(f"poses ndim {poses.ndim}: expected [T,72] or [T,24,3]")
    trans = np.asarray(raw["trans"], dtype=np.float64)
    if trans.shape != (poses.shape[0], 3):
        raise ValueError(f"trans {trans.shape} does not match poses T={poses.shape[0]}")
    fps_key = "mocap_framerate" if "mocap_framerate" in raw.files else "mocap_frame_rate"
    fps = float(raw[fps_key]) if fps_key in raw.files else 30.0
    betas = np.asarray(raw["betas"], dtype=np.float64).reshape(-1)[:10] \
        if "betas" in raw.files else np.zeros(10)
    gender = str(raw["gender"]) if "gender" in raw.files else "neutral"
    return {"poses": poses, "trans": trans, "betas": betas, "fps": fps,
            "gender": gender}


def _aa_to_mat(aa):
    """Axis-angle [...,3] -> rotation matrix [...,3,3] (Rodrigues), numpy."""
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    axis = aa / np.maximum(theta, 1e-12)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = np.zeros_like(x)
    K = np.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
    K = K.reshape(aa.shape[:-1] + (3, 3))
    s = np.sin(theta)[..., None]
    c = np.cos(theta)[..., None]
    eye = np.broadcast_to(np.eye(3), K.shape)
    return eye + s * K + (1.0 - c) * (K @ K)


def smpl_fk(poses, trans, offsets=None):
    """FK the 24-joint SMPL skeleton: world joint positions [T,24,3].

    poses [T,24,3] axis-angle (root in world frame -- GVHMR emits z-up),
    trans [T,3] root translation.  Level-ordered loop over the 24-joint tree
    (offline tool: numpy; depth is only 9, T is the batch axis).
    """
    poses = np.asarray(poses, dtype=np.float64)
    trans = np.asarray(trans, dtype=np.float64)
    off = SMPL_NEUTRAL_OFFSETS if offsets is None else np.asarray(offsets)
    T = poses.shape[0]
    R = _aa_to_mat(poses)                       # [T,24,3,3] local rotations
    gR = np.empty_like(R)
    gp = np.empty((T, 24, 3))
    gR[:, 0] = R[:, 0]
    gp[:, 0] = trans
    for j in range(1, 24):
        p = SMPL_PARENTS[j]
        gR[:, j] = gR[:, p] @ R[:, j]
        gp[:, j] = gp[:, p] + (gR[:, p] @ off[j])
    return gp


def _model_offsets(betas, smpl_model=None):
    """Rest offsets from a user-supplied SMPL body model, or None.

    When the user drops in a model file (explicit path, $SMPL_MODEL_PATH, or
    assets/body_models/ — the reference's ``body_model/`` convention), FK
    uses the true betas-regressed skeleton instead of the neutral mean-shape
    approximation (the reference's shape-fit role, fit_smpl_shape.py)."""
    from pbhc_tpu_torch.motion.smpl_model import (find_model_file, load_smpl_model,
                                                  rest_offsets_from_model)

    mp = find_model_file(smpl_model)
    if mp is None:
        return None
    off = rest_offsets_from_model(load_smpl_model(mp), betas)
    if off.shape[0] != 24:
        raise ValueError(f"body model has {off.shape[0]} joints; SMPL FK "
                         "needs the 24-joint body")
    return off


def npz_to_joints(path, smpl_model=None) -> tuple[np.ndarray, float]:
    """SMPL npz -> z-up world joint positions [T,24,3] + fps."""
    d = load_smpl_npz(path)
    off = _model_offsets(d["betas"], smpl_model)
    return smpl_fk(d["poses"], d["trans"], offsets=off), d["fps"]


def _rest_pelvis_drop(model) -> float:
    """Rest-pose vertical distance pelvis -> ankle of the robot model (numpy
    FK down the tree at zero joint angles)."""
    from scipy.spatial.transform import Rotation as sRot

    parent = np.asarray(model.parent)
    lp = np.asarray(model.local_pos, dtype=np.float64)
    R_loc = sRot.from_quat(np.asarray(model.local_quat)).as_matrix()
    nb = len(model.body_names)
    p = np.zeros((nb, 3))
    R = np.zeros((nb, 3, 3))
    R[0] = np.eye(3)
    for b in range(1, nb):
        pa = int(parent[b])
        p[b] = p[pa] + R[pa] @ lp[b]
        R[b] = R[pa] @ R_loc[b]
    ankles = [i for i, n in enumerate(model.body_names) if "ankle_roll" in n]
    return float(p[0, 2] - np.mean([p[i, 2] for i in ankles]))


def npz_to_clip(path, model=None, min_height=None, scale=None,
                smpl_model=None, device="cuda", **retarget_kw) -> dict:
    """Full contract: SMPL npz -> retargeted G1 motion clip dict.

    Mirrors the reference npz->pkl stage (convert_fit_motion.py:84-390):
    FK to joints, floor the motion (lowest foot/ankle point -> z=0 when
    ``min_height`` is None), scale the target skeleton to the robot's
    proportions (the reference's shape-fit/height-adjust role: the SMPL mean
    shape's legs are ~15% longer than the G1's, which would otherwise leave
    the fitted root floating), then gradient-IK fit via retarget_smpl_joints
    on `device`.
    """
    from pbhc_tpu_torch.model.g1 import load_g1_motion_model
    from pbhc_tpu_torch.motion.retarget import retarget_smpl_joints

    d = load_smpl_npz(path)
    off = _model_offsets(d["betas"], smpl_model)
    joints = smpl_fk(d["poses"], d["trans"], offsets=off)
    fps = d["fps"]
    feet = joints[:, [7, 8, 10, 11], 2]
    floor = feet.min() if min_height is None else min_height
    joints = joints - np.asarray([0.0, 0.0, floor])
    if model is None:
        model = load_g1_motion_model()
    if scale is None:
        # pelvis->ankle vertical drop at rest (actual shape when a body
        # model is supplied, SMPL mean shape otherwise) vs robot
        o = SMPL_NEUTRAL_OFFSETS if off is None else off
        smpl_drop = -(o[1, 1] + o[4, 1] + o[7, 1])
        scale = _rest_pelvis_drop(model) / smpl_drop
    joints = joints * scale          # about the ground plane: z=0 invariant
    clip = retarget_smpl_joints(model, joints.astype(np.float32), fps=fps,
                                 device=device, **retarget_kw)
    return snap_to_ground(clip, model, device=device)


def snap_to_ground(clip: dict, model, clearance: float = 0.0, device="cuda") -> dict:
    """Shift the clip's root z so the lowest collision-sphere surface point
    over the WHOLE clip touches the ground (the reference's contact-based
    translation correction, convert_fit_motion.py:70-83; MotionLib's
    fix_height does the same first-frame-only at load). The FK is the port's
    batched `fk_root_dof` on `device`."""
    import torch
    from scipy.spatial.transform import Rotation as sRot

    from pbhc_tpu_torch.model.kinematics import fk_root_dof

    f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)
    with torch.no_grad():
        bp, bq, _ = fk_root_dof(model, f32(clip["root_trans_offset"]), f32(clip["root_rot"]), f32(clip["dof"]))
    bp, bq = bp.cpu().numpy(), bq.cpu().numpy()
    bidx = np.asarray(model.contact_body)
    if bidx.size:
        T = bp.shape[0]
        centers = bp[:, bidx] + sRot.from_quat(
            bq[:, bidx].reshape(-1, 4)).apply(
                np.tile(np.asarray(model.contact_pos), (T, 1))).reshape(T, -1, 3)
        low = float((centers[..., 2] - np.asarray(model.contact_radius)).min())
    else:
        low = float(bp[..., 2].min())
    out = dict(clip)
    out["root_trans_offset"] = clip["root_trans_offset"] - np.asarray(
        [0.0, 0.0, low - clearance], dtype=np.float32)
    return out


def main(argv=None):
    import argparse
    import sys

    from pbhc_tpu_torch.model.g1 import load_g1_motion_model
    from pbhc_tpu_torch.motion.package import dump

    argv = sys.argv[1:] if argv is None else list(argv)
    device = next((a.split("=", 1)[1] for a in argv if a.startswith("device=")), "cuda")
    ap = argparse.ArgumentParser(description="SMPL .npz -> G1 motion .pkl")
    ap.add_argument("npz")
    ap.add_argument("out_pkl")
    ap.add_argument("--name", default=None, help="motion key (default: npz stem)")
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--robot", default="g1_23dof_lock_wrist")
    ap.add_argument("--smpl-model", default=None,
                    help="SMPL body-model file (betas-correct skeleton)")
    args = ap.parse_args([a for a in argv if not a.startswith("device=")])

    model = load_g1_motion_model(args.robot)
    clip = npz_to_clip(args.npz, model=model, iters=args.iters,
                       smpl_model=args.smpl_model, verbose=True, device=device)
    name = args.name or args.npz.rsplit("/", 1)[-1].removesuffix(".npz")
    dump({name: clip}, args.out_pkl)
    print(f"[smpl_npz] wrote {args.out_pkl}: T={clip['dof'].shape[0]} "
          f"fps={clip['fps']}")


if __name__ == "__main__":
    main()
