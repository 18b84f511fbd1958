"""MJCF -> RobotModel compiler (counterpart of `pbhc_tpu/model/mjcf.py`).

Parses a MuJoCo XML robot description into flat numpy arrays: kinematic tree,
joint axes/limits, per-body inertials and contact spheres. Body order is
depth-first document order, one hinge per non-root body.

The stdlib parser rejects the nested comment in
`assets/robots/g1/g1_23dof_lock_wrist.xml:10-11`; the JAX module falls back
to lxml's recover mode there. This copy strips every comment, nested ones
included, before parsing, so it needs no lxml.
"""
from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np


def strip_xml_comments(text: str) -> str:
    """Remove `<!-- ... -->` comments, counting nested openers."""
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


def _fromstring(s, default):
    if s is None:
        return np.asarray(default, dtype=np.float64)
    return np.asarray(s.split(), dtype=np.float64)


@dataclasses.dataclass(eq=False)
class RobotModel:
    """Static robot description (host-side numpy; converted to tensors by consumers)."""

    body_names: list
    parent: np.ndarray            # [B] int, -1 for root
    local_pos: np.ndarray         # [B,3] body origin in parent frame
    local_quat: np.ndarray        # [B,4] xyzw body rotation in parent frame
    # joints: one hinge per non-root body (or none for welded bodies)
    body_dof: np.ndarray          # [B] dof index of the body's joint, -1 if none/root
    dof_body: np.ndarray          # [nd] body index per dof
    dof_names: list
    dof_axis: np.ndarray          # [nd,3] hinge axis in body frame
    dof_limits: np.ndarray        # [nd,2]
    dof_armature: np.ndarray      # [nd]
    # inertials (body frame)
    mass: np.ndarray              # [B]
    com: np.ndarray               # [B,3]
    inertia: np.ndarray           # [B,3,3] about com, in body frame
    # collision spheres for ground contact
    contact_body: np.ndarray      # [K] int body index
    contact_pos: np.ndarray       # [K,3] offset in body frame
    contact_radius: np.ndarray    # [K]
    # sphere-sphere self-collision pairs: indices into the contact-sphere list
    # (reference enables PhysX self-collision for the G1,
    # reference humanoidverse/config/robot/g1/g1_23dof_lock_wrist.yaml:173 +
    # simulator/isaacgym/isaacgym.py:272; here: an explicit curated pair list)
    contact_pairs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), dtype=np.int64))  # [P,2]
    # extended (virtual) bodies appended after the real ones
    num_real_bodies: int = 0
    levels: list = dataclasses.field(default_factory=list)  # bodies by tree depth
    dof_damping: np.ndarray = None       # [nd]
    dof_frictionloss: np.ndarray = None  # [nd]

    @property
    def num_bodies(self):
        return len(self.body_names)

    @property
    def num_dof(self):
        return len(self.dof_names)

    def with_contacts_from(self, other: "RobotModel"):
        """Take collision spheres from another variant of the same robot.

        The deploy MJCF uses mesh collision (feet meshes) while the fitmotion
        variant carries explicit foot contact spheres; we combine the deploy
        inertials with the fitmotion sphere set, mapped by body name.
        """
        m = dataclasses.replace(self)
        bidx = np.asarray([self.body_names.index(other.body_names[b]) for b in other.contact_body], dtype=np.int64)
        m.contact_body = bidx
        m.contact_pos = other.contact_pos.copy()
        m.contact_radius = other.contact_radius.copy()
        return m

    def add_collision_spheres(self, spheres):
        """Append approximate collision spheres: [(body_name, offset3, radius)].

        The reference delegates full mesh collision to PhysX; for the TPU engine
        we approximate non-foot bodies with single spheres (enough for ground
        collision, the `collision` penalty and contact-based termination).
        """
        m = dataclasses.replace(self)
        cb = list(self.contact_body)
        cp = list(self.contact_pos)
        cr = list(self.contact_radius)
        for name, off, rad in spheres:
            cb.append(self.body_names.index(name))
            cp.append(np.asarray(off, dtype=np.float64))
            cr.append(rad)
        m.contact_body = np.asarray(cb, dtype=np.int64)
        m.contact_pos = np.asarray(cp, dtype=np.float64)
        m.contact_radius = np.asarray(cr, dtype=np.float64)
        return m

    def extend(self, extend_config):
        """Append virtual bodies (hands/head) per robot.motion.extend_config.

        Mirrors torch_humanoid_batch.py:89-94: each entry adds a fixed child
        body with pos + rot (given wxyz) under parent_name.
        """
        m = dataclasses.replace(self)
        m.body_names = list(self.body_names)
        m.parent = self.parent.copy()
        m.local_pos = self.local_pos.copy()
        m.local_quat = self.local_quat.copy()
        m.body_dof = self.body_dof.copy()
        m.mass = self.mass.copy()
        m.com = self.com.copy()
        m.inertia = self.inertia.copy()
        for ec in extend_config:
            pidx = m.body_names.index(ec["parent_name"])
            m.body_names.append(ec["joint_name"])
            m.parent = np.concatenate([m.parent, [pidx]])
            m.local_pos = np.concatenate([m.local_pos, [np.asarray(ec["pos"], dtype=np.float64)]])
            rot_wxyz = np.asarray(ec["rot"], dtype=np.float64)
            rot_xyzw = rot_wxyz[[1, 2, 3, 0]]
            m.local_quat = np.concatenate([m.local_quat, [rot_xyzw]])
            m.body_dof = np.concatenate([m.body_dof, [-1]])
            m.mass = np.concatenate([m.mass, [0.0]])
            m.com = np.concatenate([m.com, [np.zeros(3)]])
            m.inertia = np.concatenate([m.inertia, [np.zeros((3, 3))]])
        m.num_real_bodies = self.num_real_bodies
        m.levels = _compute_levels(m.parent)
        return m


def _compute_levels(parent):
    B = len(parent)
    depth = np.zeros(B, dtype=np.int64)
    for i in range(1, B):
        depth[i] = depth[parent[i]] + 1
    levels = []
    for d in range(1, depth.max() + 1):
        levels.append(np.nonzero(depth == d)[0])
    return levels


def load_mjcf(path, armature: float = 0.0) -> RobotModel:
    """Parse an MJCF file into a RobotModel.

    Only the subset used by the G1 family is supported: a single floating-base
    tree, hinge joints, inertial tags with diaginertia, sphere collision geoms.
    """
    path = Path(path)
    root = ET.fromstring(strip_xml_comments(path.read_text()))
    worldbody = root.find("worldbody")
    body_root = worldbody.find("body")

    # flat <default><joint .../></default> attributes (no class hierarchy needed
    # for the G1 family)
    joint_default = {}
    default_node = root.find("default")
    if default_node is not None:
        jd = default_node.find("joint")
        if jd is not None:
            joint_default = dict(jd.attrib)

    body_names, parent, local_pos, local_quat = [], [], [], []
    mass, com, inertia = [], [], []
    body_dof, dof_body, dof_names, dof_axis, dof_limits = [], [], [], [], []
    dof_armature_l, dof_damping_l, dof_frictionloss_l = [], [], []
    contact_body, contact_pos, contact_radius = [], [], []

    def joint_attr(j, name, fallback):
        if name in j.attrib:
            return float(j.attrib[name])
        if name in joint_default:
            return float(joint_default[name])
        return fallback

    def add_body(node, parent_idx):
        idx = len(body_names)
        body_names.append(node.attrib["name"])
        parent.append(parent_idx)
        local_pos.append(_fromstring(node.attrib.get("pos"), [0, 0, 0]))
        q_wxyz = _fromstring(node.attrib.get("quat"), [1, 0, 0, 0])
        local_quat.append(q_wxyz[[1, 2, 3, 0]])  # -> xyzw

        inert = node.find("inertial")
        if inert is not None:
            mass.append(float(inert.attrib["mass"]))
            com.append(_fromstring(inert.attrib.get("pos"), [0, 0, 0]))
            diag = _fromstring(inert.attrib.get("diaginertia"), [0, 0, 0])
            iq_wxyz = _fromstring(inert.attrib.get("quat"), [1, 0, 0, 0])
            # rotate diag inertia into body frame: I = R diag R^T
            from scipy.spatial.transform import Rotation as sRot

            R = sRot.from_quat(iq_wxyz[[1, 2, 3, 0]]).as_matrix()
            inertia.append(R @ np.diag(diag) @ R.T)
        else:
            mass.append(0.0)
            com.append(np.zeros(3))
            inertia.append(np.zeros((3, 3)))

        joints = node.findall("joint")
        hinge = None
        for j in joints:
            if j.attrib.get("type", "hinge") == "free":
                continue
            hinge = j
        if hinge is not None and parent_idx >= 0:
            body_dof.append(len(dof_names))
            dof_body.append(idx)
            dof_names.append(hinge.attrib["name"])
            dof_axis.append(_fromstring(hinge.attrib.get("axis"), [0, 0, 1]))
            dof_limits.append(_fromstring(hinge.attrib.get("range"), [-np.pi, np.pi]))
            dof_armature_l.append(joint_attr(hinge, "armature", armature))
            dof_damping_l.append(joint_attr(hinge, "damping", 0.0))
            dof_frictionloss_l.append(joint_attr(hinge, "frictionloss", 0.0))
        else:
            body_dof.append(-1)

        for g in node.findall("geom"):
            gtype = g.attrib.get("type", "sphere")
            is_visual = g.attrib.get("contype") == "0" and g.attrib.get("conaffinity") == "0"
            if gtype == "sphere" and not is_visual and "size" in g.attrib:
                contact_body.append(idx)
                contact_pos.append(_fromstring(g.attrib.get("pos"), [0, 0, 0]))
                contact_radius.append(float(g.attrib["size"].split()[0]))

        for child in node.findall("body"):
            add_body(child, idx)

    add_body(body_root, -1)

    nd = len(dof_names)
    model = RobotModel(
        body_names=body_names,
        parent=np.asarray(parent, dtype=np.int64),
        local_pos=np.asarray(local_pos, dtype=np.float64),
        local_quat=np.asarray(local_quat, dtype=np.float64),
        body_dof=np.asarray(body_dof, dtype=np.int64),
        dof_body=np.asarray(dof_body, dtype=np.int64),
        dof_names=dof_names,
        dof_axis=np.asarray(dof_axis, dtype=np.float64).reshape(nd, 3),
        dof_limits=np.asarray(dof_limits, dtype=np.float64).reshape(nd, 2),
        dof_armature=np.asarray(dof_armature_l, dtype=np.float64),
        dof_damping=np.asarray(dof_damping_l, dtype=np.float64),
        dof_frictionloss=np.asarray(dof_frictionloss_l, dtype=np.float64),
        mass=np.asarray(mass, dtype=np.float64),
        com=np.asarray(com, dtype=np.float64),
        inertia=np.asarray(inertia, dtype=np.float64),
        contact_body=np.asarray(contact_body, dtype=np.int64),
        contact_pos=np.asarray(contact_pos, dtype=np.float64).reshape(len(contact_body), 3),
        contact_radius=np.asarray(contact_radius, dtype=np.float64),
        num_real_bodies=len(body_names),
    )
    model.levels = _compute_levels(model.parent)
    return model
