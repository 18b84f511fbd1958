"""Plain reference of the motion library: the clip read from its file, every
frame's body poses by forward kinematics on the motion model (the
description's motion-fitting variant with the run's virtual hand and head
bodies), velocities by finite differences smoothed with a Gaussian of 2
frames, and the reference state at a time by linear and spherical
interpolation between frames.

A frozen copy of the arithmetic the port uses. The clips are joblib files;
the reader resolves joblib's array wrappers itself (no joblib on the card's
machine).
"""
from __future__ import annotations

import bz2
import gzip
import io
import lzma
import pickle
import zlib
from pathlib import Path

import numpy as np
import torch
from scipy.ndimage import gaussian_filter1d
from scipy.spatial.transform import Rotation

from . import robot
from .engine import matrix_to_quat, quat_to_matrix


class _Wrapper:
    def __setstate__(self, state):
        self.__dict__.update(state)


class _Reader(pickle._Unpickler):
    dispatch = dict(pickle._Unpickler.dispatch)

    def __init__(self, file):
        super().__init__(file)
        self._raw = file

    def find_class(self, module, name):
        if module == "joblib.numpy_pickle" and name == "NumpyArrayWrapper":
            return _Wrapper
        return super().find_class(module, name)

    def load_build(self):
        pickle._Unpickler.load_build(self)
        w = self.stack[-1]
        if isinstance(w, _Wrapper):
            self.stack.pop()
            dtype = np.dtype(w.dtype)
            if dtype.hasobject:
                self.stack.append(pickle.load(self._raw))
                return
            if getattr(w, "numpy_array_alignment_bytes", None) is not None:
                self._raw.read(int.from_bytes(self._raw.read(1), "little"))
            shape = tuple(int(s) for s in w.shape)
            count = int(np.prod(shape, dtype=np.int64))
            arr = np.frombuffer(self._raw.read(count * dtype.itemsize), dtype=dtype, count=count).copy()
            arr = arr.reshape(shape[::-1]).T if w.order == "F" else arr.reshape(shape)
            self.stack.append(arr.astype(arr.dtype.newbyteorder("=")) if not arr.dtype.isnative else arr)

    dispatch[pickle.BUILD[0]] = load_build


def load_clips(path) -> dict:
    with open(path, "rb") as f:
        raw = f.read()
    for magic, decompress in ((b"\x78", zlib.decompress), (b"\x1f\x8b", gzip.decompress),
                              (b"BZh", bz2.decompress), (b"\xfd7zXZ", lzma.decompress)):
        if raw.startswith(magic):
            raw = decompress(raw)
    return _Reader(io.BytesIO(raw)).load()


def exp_map_to_quat(e):
    angle = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    half = 0.5 * angle
    k = torch.where(angle < 1e-4, 0.5 - angle * angle / 48.0, torch.sin(half) / torch.clamp(angle, min=1e-8))
    return torch.cat([e * k, torch.cos(half)], dim=-1)


def slerp(q0, q1, t):
    cos_half = torch.sum(q0 * q1, dim=-1)
    q1 = torch.where((cos_half < 0)[..., None], -q1, q1)
    cos_half = torch.abs(cos_half)[..., None]
    half = torch.acos(torch.clamp(cos_half, -1.0, 1.0))
    sin_half = torch.sqrt(torch.clamp(1.0 - cos_half * cos_half, min=0.0))
    safe = torch.clamp(sin_half, min=1e-6)
    out = torch.sin((1 - t) * half) / safe * q0 + torch.sin(t * half) / safe * q1
    out = torch.where(sin_half < 0.001, (1 - t) * q0 + t * q1, out)
    return torch.where(cos_half >= 1, q0, out)


class Motion:
    """The run's clip on `device`: per-frame body positions, rotations and
    velocities of the motion model, joint angles and velocities, contact
    mask."""

    def __init__(self, root, snapshot: dict, device):
        rc = snapshot["robot"]
        mcfg = rc["motion"]
        if mcfg.get("fix_height", "no_fix") != "no_fix":
            raise NotImplementedError("the reference reads clips without a height fix")
        base = Path(root) / "assets" / "robots" / "g1"
        fit = base / f"{rc['robot_type']}_fitmotionONLY.xml"
        m = robot.parse_mjcf(fit if fit.exists() else base / f"{rc['robot_type']}.xml")
        names, parent = list(m["names"]), list(m["parent"])
        local_pos, local_quat = list(m["local_pos"]), list(m["local_quat"])
        for e in mcfg["extend_config"]:
            names.append(e["joint_name"])
            parent.append(names.index(e["parent_name"]))
            local_pos.append(np.asarray(e["pos"], dtype=np.float64))
            local_quat.append(np.asarray(e["rot"], dtype=np.float64)[[1, 2, 3, 0]])
        self.names, self.num_real = names, len(m["names"])
        parent = np.asarray(parent)
        depth = np.zeros(len(parent), dtype=np.int64)
        for i in range(1, len(parent)):
            depth[i] = depth[parent[i]] + 1
        levels = [np.nonzero(depth == d)[0] for d in range(1, depth.max() + 1)]
        order = [0] + [int(i) for lv in levels for i in lv]
        pos = np.zeros(len(names), dtype=np.int64)
        for p, b in enumerate(order):
            pos[b] = p
        clips = load_clips(Path(root) / mcfg["motion_file"])
        if len(clips) != 1:
            raise NotImplementedError("the reference reads a one-clip library")
        clip = next(iter(clips.values()))
        pose_aa = torch.as_tensor(np.asarray(clip["pose_aa"], dtype=np.float32))
        trans = torch.as_tensor(np.asarray(clip["root_trans_offset"], dtype=np.float32))
        fps = float(clip["fps"])
        dt = 1.0 / fps
        T = pose_aa.shape[0]
        rows = np.minimum(np.arange(len(names)), pose_aa.shape[-2] - 1)
        with torch.no_grad():
            R_pose = quat_to_matrix(exp_map_to_quat(pose_aa[:, rows]))
            R_local = quat_to_matrix(torch.as_tensor(np.asarray(local_quat), dtype=torch.float32))
            lpos = torch.as_tensor(np.asarray(local_pos), dtype=torch.float32)
            R_acc, p_acc = R_pose[:, None, 0], trans[:, None]
            for lv in levels:
                pp = pos[parent[lv]]
                Rp = R_acc[:, pp]
                p_acc = torch.cat([p_acc, torch.einsum("...lij,lj->...li", Rp, lpos[lv]) + p_acc[:, pp]], dim=1)
                R_acc = torch.cat([R_acc, Rp @ R_local[lv] @ R_pose[:, lv]], dim=1)
            p_w, q_w = p_acc[:, pos].numpy(), matrix_to_quat(R_acc[:, pos]).numpy()
        dof_body = np.asarray(m["dof_body"])
        sgn = torch.as_tensor(np.asarray(m["dof_axis"]).reshape(-1, 3).sum(-1), dtype=torch.float32)
        dof = (pose_aa[:, np.minimum(dof_body, pose_aa.shape[-2] - 1)].sum(-1) * sgn).numpy()
        dvel = np.diff(dof, axis=0) / dt
        dvel = np.concatenate([dvel, dvel[-1:]], axis=0)
        rotvec = (Rotation.from_quat(q_w[1:].reshape(-1, 4))
                  * Rotation.from_quat(q_w[:-1].reshape(-1, 4)).inv()).as_rotvec()
        w = np.zeros_like(q_w[..., :3])
        w[:-1] = rotvec.reshape(T - 1, -1, 3) / dt
        mask = np.asarray(clip["contact_mask"], dtype=np.float32) if "contact_mask" in clip \
            else np.zeros((T, 2), dtype=np.float32)
        f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)
        self.gts, self.grs = f32(p_w), f32(q_w)
        self.gvs = f32(gaussian_filter1d(np.gradient(p_w, axis=0) / dt, 2, axis=0, mode="nearest"))
        self.gavs = f32(gaussian_filter1d(w, 2, axis=0, mode="nearest"))
        self.dof_pos, self.dof_vel, self.contact_mask = f32(dof), f32(dvel), f32(mask)
        self.length, self.frames, self.dt = f32(dt * (T - 1)), T, f32(1.0 / fps)

    def state(self, times):
        """The reference at `times` [N] (seconds into the clip)."""
        phase = torch.clamp(times / self.length, 0.0, 1.0)
        t = torch.clamp(times, min=0.0)
        f0 = (phase * (self.frames - 1)).to(torch.int64)
        f1 = torch.minimum(f0 + 1, torch.full_like(f0, self.frames - 1))
        blend = torch.clamp((t - f0 * self.dt) / self.dt, 0.0, 1.0)
        b, be = blend[:, None], blend[:, None, None]
        return {"rg_pos": (1 - be) * self.gts[f0] + be * self.gts[f1],
                "body_vel": (1 - be) * self.gvs[f0] + be * self.gvs[f1],
                "body_ang_vel": (1 - be) * self.gavs[f0] + be * self.gavs[f1],
                "rb_rot": slerp(self.grs[f0], self.grs[f1], be),
                "dof_pos": (1 - b) * self.dof_pos[f0] + b * self.dof_pos[f1],
                "dof_vel": (1 - b) * self.dof_vel[f0] + b * self.dof_vel[f1],
                "contact_mask": (1 - b) * self.contact_mask[f0] + b * self.contact_mask[f1]}
