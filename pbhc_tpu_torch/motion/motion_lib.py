"""Motion library in torch (counterpart of `pbhc_tpu/motion/motion_lib.py`).

Loads retargeted motion pkls ({root_trans_offset, pose_aa, fps, [dof],
[contact_mask]} per clip), forward-kinematizes every frame once at load time,
flat-concatenates all clips with `length_starts` offsets, and serves
time-indexed interpolated reference states (`get_motion_state`).

The clips are joblib pickles. `load_motion_dict` reads them without joblib:
`_JoblibReader` maps joblib's `NumpyArrayWrapper` to a local placeholder and
reads the raw array bytes that follow it in the file, as
`joblib.numpy_pickle.NumpyArrayWrapper.read_array` does; a compressed file
is decompressed with the standard library first. There is no disk cache
(the JAX module caches under `/tmp`).

A committed run config may name its motion by the absolute path of the
checkout that trained it (`kb2_student23_r3`); `resolve_motion_file` reads
such a path, where it is missing, as the same file under this checkout.
"""
from __future__ import annotations

import bz2
import dataclasses
import gzip
import io
import lzma
import os
import pickle
import zlib
from pathlib import Path

import numpy as np
import torch
from scipy.ndimage import gaussian_filter1d

from pbhc_tpu_torch.maths import rotations as rot
from pbhc_tpu_torch.model.kinematics import dof_from_pose_aa, fk_pose_aa
from pbhc_tpu_torch.model.mjcf import RobotModel

REPO_ROOT = Path(__file__).resolve().parents[2]


class _ArrayPlaceholder:
    """Stands in for `joblib.numpy_pickle.NumpyArrayWrapper`."""

    def __setstate__(self, state):
        self.__dict__.update(state)


class _JoblibReader(pickle._Unpickler):
    """Pure-python unpickler that resolves joblib's array wrappers."""

    dispatch = dict(pickle._Unpickler.dispatch)

    def __init__(self, file):
        super().__init__(file)
        self._raw = file

    def find_class(self, module, name):
        if module == "joblib.numpy_pickle" and name == "NumpyArrayWrapper":
            return _ArrayPlaceholder
        if module.startswith("joblib"):
            raise pickle.UnpicklingError(f"unsupported joblib object {module}.{name}")
        return super().find_class(module, name)

    def _read_array(self, w):
        dtype = np.dtype(w.dtype)
        if dtype.hasobject:
            return pickle.load(self._raw)
        if getattr(w, "numpy_array_alignment_bytes", None) is not None:
            pad = int.from_bytes(self._raw.read(1), "little")
            self._raw.read(pad)
        shape = tuple(int(s) for s in w.shape)
        count = int(np.prod(shape, dtype=np.int64))
        data = self._raw.read(count * dtype.itemsize)
        if len(data) != count * dtype.itemsize:
            raise pickle.UnpicklingError("truncated array data")
        arr = np.frombuffer(data, dtype=dtype, count=count).copy()
        arr = arr.reshape(shape[::-1]).T if w.order == "F" else arr.reshape(shape)
        if not arr.dtype.isnative:
            arr = arr.astype(arr.dtype.newbyteorder("="))
        return arr

    def load_build(self):
        pickle._Unpickler.load_build(self)
        if isinstance(self.stack[-1], _ArrayPlaceholder):
            self.stack.append(self._read_array(self.stack.pop()))

    dispatch[pickle.BUILD[0]] = load_build


# joblib's compressors by the first bytes of the file (`joblib/compressor.py`;
# `numpy_pickle_utils._detect_compressor`): each writes the whole pickle
# stream through it, with the arrays unpadded
_COMPRESSORS = ((b"\x78", zlib.decompress), (b"\x1f\x8b", gzip.decompress), (b"BZh", bz2.decompress),
                (b"\xfd7zXZ", lzma.decompress), (b"]\x00\x00", lzma.decompress))
_PICKLE_PROTO = b"\x80"


def load_joblib(path):
    """The object of a `joblib.dump` file, uncompressed or compressed with
    zlib, gzip, bz2, xz or lzma (as `joblib.load` reads it). Raises
    `ValueError` on another header (lz4, or not joblib's)."""
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        if head.startswith(_PICKLE_PROTO):
            return _JoblibReader(f).load()
        for magic, decompress in _COMPRESSORS:
            if head.startswith(magic):
                return _JoblibReader(io.BytesIO(decompress(f.read()))).load()
    raise ValueError(f"{path}: header {head!r} is neither a pickle nor a joblib compressor this "
                     "reader knows (zlib, gzip, bz2, xz, lzma)")


def resolve_motion_file(motion_file) -> str:
    """`motion_file` where it exists; else its part from the last `assets`
    on, under this checkout's root (a path recorded in another checkout).
    Raises `FileNotFoundError` where neither exists."""
    path = Path(motion_file)
    if path.exists():
        return str(motion_file)
    parts = path.parts
    if "assets" in parts:
        local = REPO_ROOT.joinpath(*parts[len(parts) - 1 - parts[::-1].index("assets"):])
        if local.exists():
            return str(local)
    raise FileNotFoundError(f"motion file {motion_file} not found, nor under {REPO_ROOT}")


def load_motion_dict(motion_file) -> dict:
    """One pkl, or a directory of pkls merged in sorted order (`motion_lib.py:75`),
    at `resolve_motion_file(motion_file)`."""
    motion_file = resolve_motion_file(motion_file)
    if not os.path.isdir(motion_file):
        return load_joblib(motion_file)
    names = sorted(f for f in os.listdir(motion_file) if f.endswith(".pkl"))
    if not names:
        raise ValueError(f"{motion_file}: directory contains no .pkl motions")
    raw = {}
    for name in names:
        stem = name[: -len(".pkl")]
        for k, v in load_joblib(os.path.join(motion_file, name)).items():
            raw[f"{stem}/{k}" if k in raw else k] = v
    return raw


@dataclasses.dataclass
class MotionData:
    """Flat-concatenated per-frame reference data (`motion_lib.py:30`)."""

    gts: torch.Tensor          # [F, B_ext, 3]
    grs: torch.Tensor          # [F, B_ext, 4] xyzw
    gvs: torch.Tensor          # [F, B_ext, 3]
    gavs: torch.Tensor         # [F, B_ext, 3]
    dof_pos: torch.Tensor      # [F, nd]
    dof_vel: torch.Tensor      # [F, nd]
    contact_mask: torch.Tensor  # [F, C]
    lengths: torch.Tensor      # [M] seconds
    fps: torch.Tensor          # [M]
    dt: torch.Tensor           # [M]
    num_frames: torch.Tensor   # [M] int
    length_starts: torch.Tensor  # [M] int
    sampling_prob: torch.Tensor  # [M]


def _compute_linear_velocity(p: np.ndarray, dt: float) -> np.ndarray:
    v = np.gradient(p, axis=0) / dt
    return gaussian_filter1d(v, 2, axis=0, mode="nearest")


def _compute_angular_velocity(q_xyzw: np.ndarray, dt: float) -> np.ndarray:
    from scipy.spatial.transform import Rotation as sRot

    T = q_xyzw.shape[0]
    dq = (sRot.from_quat(q_xyzw[1:].reshape(-1, 4))
          * sRot.from_quat(q_xyzw[:-1].reshape(-1, 4)).inv()).as_rotvec()
    w = np.zeros_like(q_xyzw[..., :3])
    w[:-1] = dq.reshape(T - 1, -1, 3) / dt
    return gaussian_filter1d(w, 2, axis=0, mode="nearest")


class MotionLib:
    """Holds the clips on `device` (`motion_lib.py:99`)."""

    def __init__(self, motion_file: str, model: RobotModel, num_envs: int, step_dt: float,
                 fix_height: str = "no_fix", device="cuda"):
        if motion_file is None:
            raise ValueError("robot.motion.motion_file is not set")
        if fix_height not in ("no_fix", "full_fix", "ankle_fix"):
            raise ValueError(f"fix_height={fix_height!r}")
        self.model = model
        self.num_envs = num_envs
        self.step_dt = step_dt
        self.fix_height = fix_height
        self.device = torch.device(device)
        self._load(motion_file)

    def _fix_height_diff(self, p_w, q_w):
        """Lowest collision-sphere surface of frame 0 (`motion_lib.py:116`)."""
        from scipy.spatial.transform import Rotation as sRot

        m = self.model
        bidx = np.asarray(m.contact_body)
        if bidx.size == 0:
            return float(p_w[0, :, 2].min())
        offs, rad = np.asarray(m.contact_pos), np.asarray(m.contact_radius)
        if self.fix_height == "ankle_fix":
            keep = np.asarray(["ankle" in m.body_names[b] or "foot" in m.body_names[b] for b in bidx])
            if keep.any():
                bidx, offs, rad = bidx[keep], offs[keep], rad[keep]
        centers = p_w[0, bidx] + sRot.from_quat(q_w[0, bidx]).apply(offs)
        return float((centers[:, 2] - rad).min())

    def _load(self, motion_file):
        raw = load_motion_dict(motion_file)
        self._keys = list(raw.keys())
        self.num_unique = len(self._keys)
        cols = {k: [] for k in ("gts", "grs", "gvs", "gavs", "dof_pos", "dof_vel", "contact_mask")}
        lengths, fps_l, nframes = [], [], []
        self.has_contact_mask = False
        for k in self._keys:
            clip = raw[k]
            pose_aa = torch.as_tensor(np.asarray(clip["pose_aa"], dtype=np.float32))
            trans = np.asarray(clip["root_trans_offset"], dtype=np.float32)
            fps = float(clip["fps"])
            dt = 1.0 / fps
            T = pose_aa.shape[0]
            with torch.no_grad():
                p_w, q_w = fk_pose_aa(self.model, pose_aa, torch.as_tensor(trans))
            p_w, q_w = p_w.numpy(), q_w.numpy()
            if self.fix_height != "no_fix":
                p_w = p_w.copy()
                p_w[..., 2] -= self._fix_height_diff(p_w, q_w)
            dof = dof_from_pose_aa(self.model, pose_aa).numpy()
            dvel = np.diff(dof, axis=0) / dt
            dvel = np.concatenate([dvel, dvel[-1:]], axis=0)
            cols["gts"].append(p_w)
            cols["grs"].append(q_w)
            cols["gvs"].append(_compute_linear_velocity(p_w, dt))
            cols["gavs"].append(_compute_angular_velocity(q_w, dt))
            cols["dof_pos"].append(dof)
            cols["dof_vel"].append(dvel)
            if "contact_mask" in clip:
                self.has_contact_mask = True
                cols["contact_mask"].append(np.asarray(clip["contact_mask"], dtype=np.float32))
            else:
                cols["contact_mask"].append(np.zeros((T, 2), dtype=np.float32))
            lengths.append(dt * (T - 1))
            fps_l.append(fps)
            nframes.append(T)

        dev = self.device
        f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)
        nf = np.asarray(nframes, dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(nf)[:-1]]).astype(np.int64)
        self.data = MotionData(
            **{k: f32(np.concatenate(v)) for k, v in cols.items()},
            lengths=f32(lengths), fps=f32(fps_l), dt=f32(1.0 / np.asarray(fps_l)),
            num_frames=torch.as_tensor(nf, device=dev),
            length_starts=torch.as_tensor(starts, device=dev),
            sampling_prob=torch.full((self.num_unique,), 1.0 / self.num_unique, device=dev))


def sample_time(data: MotionData, motion_ids, generator: torch.Generator, truncate_time=None):
    """Uniform phase sample (`motion_lib.py:260`)."""
    phase = torch.rand(motion_ids.shape, generator=generator, device=motion_ids.device)
    length = data.lengths[motion_ids]
    if truncate_time is not None:
        length = length - truncate_time
    return phase * length


def motion_length(data: MotionData, motion_ids):
    return data.lengths[motion_ids]


def _calc_frame_blend(time, length, num_frames, dt):
    """`motion_lib.py:273`."""
    phase = torch.clamp(time / length, 0.0, 1.0)
    time = torch.clamp(time, min=0.0)
    f0 = (phase * (num_frames - 1)).to(torch.int64)
    f1 = torch.minimum(f0 + 1, num_frames - 1)
    blend = torch.clamp((time - f0 * dt) / dt, 0.0, 1.0)
    return f0, f1, blend


def get_motion_state(data: MotionData, motion_ids, motion_times, offset=None):
    """Interpolated reference state (`motion_lib.py:283`); same keys as the JAX dict."""
    f0, f1, blend = _calc_frame_blend(motion_times, data.lengths[motion_ids],
                                      data.num_frames[motion_ids], data.dt[motion_ids])
    start = data.length_starts[motion_ids]
    f0l, f1l = f0 + start, f1 + start
    b = blend[..., None]
    be = blend[..., None, None]
    rg_pos = (1 - be) * data.gts[f0l] + be * data.gts[f1l]
    if offset is not None:
        rg_pos = rg_pos + offset[..., None, :]
    body_vel = (1 - be) * data.gvs[f0l] + be * data.gvs[f1l]
    body_ang_vel = (1 - be) * data.gavs[f0l] + be * data.gavs[f1l]
    rb_rot = rot.slerp(data.grs[f0l], data.grs[f1l], be)
    dof_pos = (1 - b) * data.dof_pos[f0l] + b * data.dof_pos[f1l]
    dof_vel = (1 - b) * data.dof_vel[f0l] + b * data.dof_vel[f1l]
    contact = (1 - b) * data.contact_mask[f0l] + b * data.contact_mask[f1l]
    return {
        "root_pos": rg_pos[..., 0, :], "root_rot": rb_rot[..., 0, :], "dof_pos": dof_pos,
        "root_vel": body_vel[..., 0, :], "root_ang_vel": body_ang_vel[..., 0, :],
        "dof_vel": dof_vel, "rg_pos": rg_pos, "rb_rot": rb_rot, "body_vel": body_vel,
        "body_ang_vel": body_ang_vel, "rg_pos_t": rg_pos, "rg_rot_t": rb_rot,
        "body_vel_t": body_vel, "body_ang_vel_t": body_ang_vel, "contact_mask": contact,
    }
