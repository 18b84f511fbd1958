"""Physics-plausibility motion filter (counterpart of
`pbhc_tpu/motion/filter.py`; reference smpl_retarget/motion_filter,
IPMAN-style CoM/CoP stability).

The reference filters SMPL meshes by CoM-vs-support-polygon stability; smplx
is not available, so this filter works on the retargeted robot motion
directly: FK the clip (the port's batched `fk_pose_aa` on `device`), compute
the mass-weighted CoM, the support polygon from low-and-slow foot points,
and score each frame by (a) CoM ground projection inside/near the support
region and (b) vertical CoM acceleration consistency with the contact
state. Clips scoring below threshold are flagged.
"""
from __future__ import annotations

import numpy as np
import torch

from pbhc_tpu_torch.model.kinematics import fk_pose_aa


def stability_score(model, sim_model, pose_aa, trans, fps, foot_height_thr=0.1, device="cuda"):
    """Per-frame stability metrics for a motion clip. Returns dict of arrays."""
    f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)
    with torch.no_grad():
        p, _ = fk_pose_aa(model, f32(pose_aa), f32(trans))
    p = p.cpu().numpy()[:, : sim_model.num_real_bodies]
    mass = np.asarray(sim_model.mass[: sim_model.num_real_bodies])
    com = (p * mass[None, :, None]).sum(1) / mass.sum()                 # [T,3]

    feet = [i for i, n in enumerate(sim_model.body_names) if "ankle_roll" in n]
    foot_pos = p[:, feet]                                               # [T,2,3]
    grounded = foot_pos[..., 2] < foot_height_thr                       # [T,2]

    # distance of CoM ground-projection from the support segment between feet
    a, b = foot_pos[:, 0, :2], foot_pos[:, 1, :2]
    c = com[:, :2]
    ab = b - a
    t = np.clip(((c - a) * ab).sum(-1) / np.maximum((ab * ab).sum(-1), 1e-9), 0, 1)
    closest = a + t[:, None] * ab
    dist = np.linalg.norm(c - closest, axis=-1)
    dist = np.where(grounded.any(-1), dist, 0.0)                        # airborne frames pass

    # vertical CoM acceleration: should be ~-g when airborne
    dt = 1.0 / fps
    com_acc = np.gradient(np.gradient(com[:, 2], dt), dt)
    airborne = ~grounded.any(-1)
    grav_err = np.where(airborne, np.abs(com_acc + 9.81), 0.0)

    return {"com_support_dist": dist, "airborne_gravity_err": grav_err,
            "grounded_frames": grounded.any(-1).mean()}


def filter_clip(model, sim_model, clip, max_com_dist=0.35, max_grav_err=15.0, device="cuda"):
    """True if the clip is physically plausible (reference motion_filter.py:74-196)."""
    s = stability_score(model, sim_model, clip["pose_aa"], clip["root_trans_offset"],
                        clip["fps"], device=device)
    ok = (s["com_support_dist"].max() < max_com_dist
          and np.percentile(s["airborne_gravity_err"], 95) < max_grav_err)
    return bool(ok), s
