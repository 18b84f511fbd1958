"""The G1's tables for the plain engine reference (`reference/engine.py`),
worked out from the committed robot description and the run's config.

A frozen copy of the arithmetic the port uses to build them: the MJCF body
tree (depth-first document order, one hinge per non-root body, inertials
rotated into the body frame), the foot-sole contact spheres that replace the
description's foot spheres, one sphere on each of thirteen other bodies, and
a curated list of self-collision sphere pairs. The engine's per-env physical
parameters (masses, inertias, friction: domain-randomised by the program
from the seed) are the program's state and come with the recorded step.
"""
from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

BODY_SPHERES = [
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
    ("left_elbow_link", (0.25, 0.0, 0.0), 0.05),
    ("right_elbow_link", (0.25, 0.0, 0.0), 0.05),
    ("torso_link", (0.0, 0.0, 0.42), 0.09),
]

# (body, sphere x offset) or (body, (x, z)) where x alone is ambiguous
SELF_COLLISION_PAIRS = [
    (("left_elbow_link", 0.25), ("torso_link", (0.0, 0.15))),
    (("right_elbow_link", 0.25), ("torso_link", (0.0, 0.15))),
    (("left_elbow_link", 0.25), ("pelvis", (0.0, -0.076))),
    (("right_elbow_link", 0.25), ("pelvis", (0.0, -0.076))),
    (("left_elbow_link", 0.25), ("torso_link", (0.0, 0.42))),
    (("right_elbow_link", 0.25), ("torso_link", (0.0, 0.42))),
    (("left_elbow_link", 0.12), ("torso_link", (0.0, 0.15))),
    (("right_elbow_link", 0.12), ("torso_link", (0.0, 0.15))),
    (("left_elbow_link", 0.12), ("pelvis", (0.0, -0.076))),
    (("right_elbow_link", 0.12), ("pelvis", (0.0, -0.076))),
    (("left_elbow_link", 0.25), ("left_hip_pitch_link", 0.003)),
    (("right_elbow_link", 0.25), ("right_hip_pitch_link", 0.003)),
    (("left_elbow_link", 0.25), ("left_knee_link", 0.005)),
    (("right_elbow_link", 0.25), ("right_knee_link", 0.005)),
    (("left_elbow_link", 0.25), ("right_elbow_link", 0.25)),
    (("left_knee_link", 0.005), ("right_knee_link", 0.005)),
    (("left_hip_pitch_link", 0.003), ("right_hip_pitch_link", 0.003)),
]

# four corner spheres per foot sole (x, y, z, radius) in the ankle-roll frame
FOOT_SOLE_SPHERES = [(-0.060, 0.032, -0.030, 0.005), (-0.060, -0.032, -0.030, 0.005),
                     (0.137, 0.032, -0.030, 0.005), (0.137, -0.032, -0.030, 0.005)]


def _strip_comments(text: str) -> str:
    out, depth, i = [], 0, 0
    while i < len(text):
        if text.startswith("<!--", i):
            depth, i = depth + 1, i + 4
        elif depth and text.startswith("-->", i):
            depth, i = depth - 1, i + 3
        else:
            if not depth:
                out.append(text[i])
            i += 1
    return "".join(out)


def _vec(s, default):
    return np.asarray(default if s is None else s.split(), dtype=np.float64)


def _quat_matrix_xyzw(q):
    x, y, z, w = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def parse_mjcf(path):
    """The body tree, hinges, inertials and sphere geoms of an MJCF file."""
    root = ET.fromstring(_strip_comments(Path(path).read_text()))
    jd = root.find("default")
    jd = dict(jd.find("joint").attrib) if jd is not None and jd.find("joint") is not None else {}
    m = {k: [] for k in ("names", "parent", "local_pos", "local_quat", "mass", "com", "inertia", "body_dof",
                         "dof_body", "dof_names", "dof_axis", "dof_limits", "armature", "damping", "frictionloss",
                         "sphere_body", "sphere_pos", "sphere_radius")}

    def attr(j, name):
        return float(j.attrib.get(name, jd.get(name, 0.0)))

    def add(node, parent):
        idx = len(m["names"])
        m["names"].append(node.attrib["name"])
        m["parent"].append(parent)
        m["local_pos"].append(_vec(node.attrib.get("pos"), [0, 0, 0]))
        m["local_quat"].append(_vec(node.attrib.get("quat"), [1, 0, 0, 0])[[1, 2, 3, 0]])
        inert = node.find("inertial")
        if inert is not None:
            m["mass"].append(float(inert.attrib["mass"]))
            m["com"].append(_vec(inert.attrib.get("pos"), [0, 0, 0]))
            R = _quat_matrix_xyzw(_vec(inert.attrib.get("quat"), [1, 0, 0, 0])[[1, 2, 3, 0]])
            m["inertia"].append(R @ np.diag(_vec(inert.attrib.get("diaginertia"), [0, 0, 0])) @ R.T)
        else:
            m["mass"].append(0.0)
            m["com"].append(np.zeros(3))
            m["inertia"].append(np.zeros((3, 3)))
        hinges = [j for j in node.findall("joint") if j.attrib.get("type", "hinge") != "free"]
        if hinges and parent >= 0:
            j = hinges[-1]
            m["body_dof"].append(len(m["dof_body"]))
            m["dof_body"].append(idx)
            m["dof_names"].append(j.attrib["name"])
            m["dof_axis"].append(_vec(j.attrib.get("axis"), [0, 0, 1]))
            m["dof_limits"].append(_vec(j.attrib.get("range"), [-math.pi, math.pi]))
            m["armature"].append(attr(j, "armature"))
            m["damping"].append(attr(j, "damping"))
            m["frictionloss"].append(attr(j, "frictionloss"))
        else:
            m["body_dof"].append(-1)
        for g in node.findall("geom"):
            visual = g.attrib.get("contype") == "0" and g.attrib.get("conaffinity") == "0"
            if g.attrib.get("type", "sphere") == "sphere" and not visual and "size" in g.attrib:
                m["sphere_body"].append(idx)
                m["sphere_pos"].append(_vec(g.attrib.get("pos"), [0, 0, 0]))
                m["sphere_radius"].append(float(g.attrib["size"].split()[0]))
        for child in node.findall("body"):
            add(child, idx)

    add(root.find("worldbody").find("body"), -1)
    return m


def tables(root, robot_type: str, self_collision: bool = True) -> dict:
    """The engine's static tables for the G1 variant `robot_type`."""
    m = parse_mjcf(Path(root) / "assets" / "robots" / "g1" / f"{robot_type}.xml")
    names = m["names"]
    # contact spheres: every body's sphere geoms but the feet', the sole
    # corners on each foot, then the spheres on the other bodies
    feet = [i for i, n in enumerate(names) if n.endswith("ankle_roll_link")]
    fit = Path(root) / "assets" / "robots" / "g1" / f"{robot_type}_fitmotionONLY.xml"
    src = parse_mjcf(fit) if fit.exists() else m
    sb = [names.index(src["names"][b]) for b in src["sphere_body"]]
    cb, cp, cr = [], [], []
    for b, p, r in zip(sb, src["sphere_pos"], src["sphere_radius"]):
        if b not in feet:
            cb.append(b), cp.append(p), cr.append(r)
    for b in feet:
        for x, y, z, r in FOOT_SOLE_SPHERES:
            cb.append(b), cp.append(np.asarray([x, y, z])), cr.append(r)
    for name, off, r in BODY_SPHERES:
        if name in names:
            cb.append(names.index(name)), cp.append(np.asarray(off, dtype=np.float64)), cr.append(r)
    pairs = []
    if self_collision:
        def sphere(body, off):
            ox, oz = off if isinstance(off, tuple) else (off, None)
            for k, (b, p) in enumerate(zip(cb, cp)):
                if names[b] == body and abs(p[0] - ox) < 1e-6 and (oz is None or abs(p[2] - oz) < 1e-6):
                    return k
            return None
        for a, b in SELF_COLLISION_PAIRS:
            i, j = sphere(*a), sphere(*b)
            if i is not None and j is not None:
                pairs.append((i, j))
    parent = np.asarray(m["parent"], dtype=np.int64)
    depth = np.zeros(len(parent), dtype=np.int64)
    for i in range(1, len(parent)):
        depth[i] = depth[parent[i]] + 1
    levels = [np.nonzero(depth == d)[0] for d in range(1, depth.max() + 1)]
    return {
        "names": names, "dof_names": m["dof_names"], "parent": parent, "levels": levels,
        "local_pos": np.asarray(m["local_pos"]), "local_quat": np.asarray(m["local_quat"]),
        "body_dof": np.asarray(m["body_dof"], dtype=np.int64), "dof_body": np.asarray(m["dof_body"], dtype=np.int64),
        "dof_axis": np.asarray(m["dof_axis"]).reshape(-1, 3), "dof_limits": np.asarray(m["dof_limits"]).reshape(-1, 2),
        "contact_body": np.asarray(cb, dtype=np.int64), "contact_pos": np.asarray(cp).reshape(-1, 3),
        "contact_radius": np.asarray(cr), "pairs": np.asarray(pairs, dtype=np.int64).reshape(-1, 2),
    }
