"""Canonical G1 robot model builders (counterpart of `pbhc_tpu/model/g1.py`).

Combines the MJCF variants the reference ships (reference
description/robots/g1/): the deploy XML carries the correct lock-wrist merged
inertials, the fitmotion XML carries the explicit foot contact spheres, and the
env config supplies the extend-bodies (hands/head).
"""
from __future__ import annotations

from pathlib import Path

from pbhc_tpu_torch.model.mjcf import RobotModel, load_mjcf

# single-sphere ground-collision approximations for non-foot bodies (offsets
# are roughly each body's CoM in its own frame); used for the `collision`
# penalty / contact termination and to keep ragdolls from falling through the
# floor — the reference gets these from PhysX mesh collision
G1_BODY_SPHERES = [
    ("pelvis", (0.0, 0.0, -0.076), 0.09),
    ("torso_link", (0.0, 0.0, 0.15), 0.11),
    ("left_knee_link", (0.005, 0.004, -0.12), 0.05),
    ("right_knee_link", (0.005, -0.004, -0.12), 0.05),
    ("left_hip_pitch_link", (0.003, 0.048, -0.026), 0.06),
    ("right_hip_pitch_link", (0.003, -0.048, -0.026), 0.06),
    ("left_shoulder_roll_link", (0.0, 0.0, -0.05), 0.05),
    ("right_shoulder_roll_link", (0.0, 0.0, -0.05), 0.05),
    ("left_elbow_link", (0.12, 0.0, 0.0), 0.05),
    ("right_elbow_link", (0.12, 0.0, 0.0), 0.05),
    # hand/head spheres: ground contact for crawl-class motions AND the
    # self-collision pair list below (the 23-DoF lock-wrist model has no hand
    # bodies; the hand sits ~0.25 m along the forearm, cf. DEFAULT_EXTEND_CONFIG)
    ("left_elbow_link", (0.25, 0.0, 0.0), 0.05),    # left hand
    ("right_elbow_link", (0.25, 0.0, 0.0), 0.05),   # right hand
    ("torso_link", (0.0, 0.0, 0.42), 0.09),         # head
]

# Sphere-sphere self-collision pairs, by (body_name, sphere-offset-x) so the
# list survives sphere reordering. Covers the contacts that matter for
# punch/kick/crossing-arm motions: hands & elbows vs torso/pelvis/head, hands
# vs same-side thigh+knee, hand-hand, knee-knee, thigh-thigh.
# (reference g1_23dof_lock_wrist.yaml:173 enables full PhysX self-collision;
# a curated pair list is the fixed-shape equivalent.)
G1_SELF_COLLISION_PAIRS = [
    (("left_elbow_link", 0.25), ("torso_link", (0.0, 0.15))),
    (("right_elbow_link", 0.25), ("torso_link", (0.0, 0.15))),
    (("left_elbow_link", 0.25), ("pelvis", (0.0, -0.076))),
    (("right_elbow_link", 0.25), ("pelvis", (0.0, -0.076))),
    (("left_elbow_link", 0.25), ("torso_link", (0.0, 0.42))),      # hand-head
    (("right_elbow_link", 0.25), ("torso_link", (0.0, 0.42))),
    (("left_elbow_link", 0.12), ("torso_link", (0.0, 0.15))),       # elbow-torso
    (("right_elbow_link", 0.12), ("torso_link", (0.0, 0.15))),
    (("left_elbow_link", 0.12), ("pelvis", (0.0, -0.076))),
    (("right_elbow_link", 0.12), ("pelvis", (0.0, -0.076))),
    (("left_elbow_link", 0.25), ("left_hip_pitch_link", 0.003)),
    (("right_elbow_link", 0.25), ("right_hip_pitch_link", 0.003)),
    (("left_elbow_link", 0.25), ("left_knee_link", 0.005)),
    (("right_elbow_link", 0.25), ("right_knee_link", 0.005)),
    (("left_elbow_link", 0.25), ("right_elbow_link", 0.25)),  # hand-hand
    (("left_knee_link", 0.005), ("right_knee_link", 0.005)),
    (("left_hip_pitch_link", 0.003), ("right_hip_pitch_link", 0.003)),
]


def _sphere_index(model, body_name, off):
    """Index of a contact sphere by body name + offset signature.

    `off` is the x offset, or an (x, z) tuple when x alone is ambiguous
    (torso chest vs head spheres share x=0)."""
    off_x, off_z = (off if isinstance(off, tuple) else (off, None))
    for k, (b, p) in enumerate(zip(model.contact_body, model.contact_pos)):
        if (model.body_names[b] == body_name and abs(p[0] - off_x) < 1e-6
                and (off_z is None or abs(p[2] - off_z) < 1e-6)):
            return k
    raise KeyError(f"no contact sphere ({body_name}, {off})")

# Foot sole contact spheres, derived from the deploy XML's ankle_roll
# collision MESH (the surface MuJoCo/PhysX and the real foot actually stand
# on). Measured sole extents in the ankle_roll body frame: x -0.066..0.142,
# y +-0.038, bottom z -0.0354 (flat within 3 mm). The fitmotion XML's four
# corner spheres (heel x=-0.05, toe x=0.12, y +-0.025/0.03) were made for
# retarget-time contact DETECTION, not dynamics: as a support polygon they are
# ~2 cm short at both ends and ~25% narrow, which shifts heel-strike/toe-off
# lever arms — the dominant engine<->MuJoCo lockstep error concentrated in
# ankle pitch/roll at foot strikes. Four corner spheres (3 mm edge inset,
# bottoms at z=-0.035) reproduce the mesh sole polygon; a third coplanar row
# was tried and rejected (redundant rows degrade the impulse solve).
G1_FOOT_SOLE_SPHERES = [
    (-0.060, 0.032, -0.030, 0.005), (-0.060, -0.032, -0.030, 0.005),
    (0.137, 0.032, -0.030, 0.005), (0.137, -0.032, -0.030, 0.005),
]


def _replace_foot_spheres(model: RobotModel) -> RobotModel:
    """Swap *_ankle_roll_link contact spheres for the mesh-sole set."""
    import dataclasses as _dc

    import numpy as _np

    feet = [i for i, n in enumerate(model.body_names) if n.endswith("ankle_roll_link")]
    keep = [k for k, b in enumerate(model.contact_body) if int(b) not in feet]
    cb = [int(model.contact_body[k]) for k in keep]
    cp = [model.contact_pos[k] for k in keep]
    cr = [float(model.contact_radius[k]) for k in keep]
    for b in feet:
        for x, y, z, r in G1_FOOT_SOLE_SPHERES:
            cb.append(b)
            cp.append(_np.asarray([x, y, z]))
            cr.append(r)
    return _dc.replace(
        model,
        contact_body=_np.asarray(cb, dtype=_np.int64),
        contact_pos=_np.stack(cp).astype(_np.float64),
        contact_radius=_np.asarray(cr, dtype=_np.float64),
    )


DEFAULT_EXTEND_CONFIG = [
    {"joint_name": "left_hand_link", "parent_name": "left_elbow_link", "pos": [0.25, 0.0, 0.0], "rot": [1.0, 0.0, 0.0, 0.0]},
    {"joint_name": "right_hand_link", "parent_name": "right_elbow_link", "pos": [0.25, 0.0, 0.0], "rot": [1.0, 0.0, 0.0, 0.0]},
    {"joint_name": "head_link", "parent_name": "torso_link", "pos": [0.0, 0.0, 0.42], "rot": [1.0, 0.0, 0.0, 0.0]},
]


def g1_asset_root() -> Path:
    root = Path(__file__).resolve().parents[2] / "assets" / "robots" / "g1"
    if not root.exists():
        raise FileNotFoundError(f"G1 robot description not found at {root}")
    return root


def load_g1_sim_model(robot_type: str = "g1_23dof_lock_wrist", body_spheres=True,
                      self_collision=True) -> RobotModel:
    """Dynamics model: deploy inertials + fitmotion foot spheres (+ body spheres
    + self-collision sphere pairs)."""
    import numpy as _np

    root = g1_asset_root()
    model = load_mjcf(root / f"{robot_type}.xml")
    fit = root / f"{robot_type}_fitmotionONLY.xml"
    if fit.exists():
        model = model.with_contacts_from(load_mjcf(fit))
    elif len(model.contact_body) == 0:
        # variants without explicit foot spheres (e.g. 29-DoF): borrow the
        # 23-DoF fitmotion foot sphere set — the ankle links are identical
        donor = load_mjcf(root / "g1_23dof_lock_wrist_fitmotionONLY.xml")
        model = model.with_contacts_from(donor)
    # dynamics uses the mesh-derived sole polygon, not the fitmotion
    # detection spheres (see G1_FOOT_SOLE_SPHERES)
    model = _replace_foot_spheres(model)
    if body_spheres:
        spheres = [s for s in G1_BODY_SPHERES if s[0] in model.body_names]
        model = model.add_collision_spheres(spheres)
        if self_collision:
            import dataclasses as _dc2

            pairs = []
            for a, b in G1_SELF_COLLISION_PAIRS:
                try:
                    pairs.append((_sphere_index(model, *a), _sphere_index(model, *b)))
                except KeyError:
                    pass  # variant without that body/sphere
            model = _dc2.replace(
                model, contact_pairs=_np.asarray(pairs, dtype=_np.int64).reshape(-1, 2))
    # the official g1_29dof_rev_1_0.xml carries NO <default> joint
    # armature/damping (the lock-wrist sim file sets 0.01/0.001); with zero
    # armature the ~1e-5 kgm^2 wrist links are numerically unstable at 200 Hz
    # (undamped oscillation grows until blowup) in ANY engine — floor the
    # values at the G1 sim defaults when the MJCF leaves them unset
    import dataclasses as _dc

    import numpy as _np

    if float(_np.max(model.dof_armature)) == 0.0:
        model = _dc.replace(model, dof_armature=_np.full(model.num_dof, 0.01, _np.float64))
    if model.dof_damping is None or float(_np.max(model.dof_damping)) == 0.0:
        model = _dc.replace(model, dof_damping=_np.full(model.num_dof, 0.001, _np.float64))
    return model


def load_g1_motion_model(robot_type: str = "g1_23dof_lock_wrist", extend_config=None) -> RobotModel:
    """Kinematics model for the motion library (fitmotion MJCF + extend bodies)."""
    root = g1_asset_root()
    fit = root / f"{robot_type}_fitmotionONLY.xml"
    path = fit if fit.exists() else root / f"{robot_type}.xml"
    model = load_mjcf(path)
    if extend_config is None:
        extend_config = DEFAULT_EXTEND_CONFIG
    return model.extend(extend_config)
