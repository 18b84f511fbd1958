"""Port parity: the viewers (`vis/vis_motion.py`, `vis/vis_rr.py`,
`vis/vis_smpl.py`) against `pbhc_tpu/vis/`, on the CPU.

Each viewer test of tests/test_motion_tools.py, tests/test_smpl_npz.py and
tests/test_smpl_model.py has its counterpart here: the port renders with
matplotlib (installed here, not on the card's machine) and streams
`vis_rr` to the same stub backend. The skeleton segments each draws are held
to the JAX package's: 1e-5 m for the FK'd G1 bodies (float32 FK in two
libraries), exactly for the numpy SMPL skeleton.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from pbhc_tpu.model.g1 import load_g1_motion_model as jax_motion_model  # noqa: E402
from pbhc_tpu.model.kinematics import fk_pose_aa as jax_fk_pose_aa  # noqa: E402
from pbhc_tpu.motion.motion_lib import load_motion_dict as jax_load_motion_dict  # noqa: E402
from pbhc_tpu.vis import vis_motion as jvis_motion  # noqa: E402
from pbhc_tpu.vis import vis_rr as jvis_rr  # noqa: E402
from pbhc_tpu.vis import vis_smpl as jvis_smpl  # noqa: E402
from pbhc_tpu_torch.vis import vis_motion, vis_rr, vis_smpl  # noqa: E402
from test_smpl_model import _save_npz, _toy_model  # noqa: E402
from test_smpl_npz import _write_npz  # noqa: E402

MOTION = "assets/motions/Horse-stance_pose.pkl"


def _segments(mod, model, frames):
    return np.asarray([[a, b] for t in range(len(frames)) for a, b in mod.skeleton_segments(model, frames[t])])


def test_vis_motion_gif_and_its_segments(tmp_path):
    out = vis_motion.render_motion(MOTION, tmp_path / "m.gif", stride=16, max_frames=8, device="cpu")
    assert os.path.getsize(out) > 10000
    model, frames = vis_motion.motion_frames(MOTION, stride=16, max_frames=8, device="cpu")
    jmodel = jax_motion_model()
    clip = next(iter(jax_load_motion_dict(MOTION).values()))
    jp, _ = jax.vmap(jax_fk_pose_aa, in_axes=(None, 0, 0))(
        jmodel, jnp.asarray(clip["pose_aa"][::16][:8]), jnp.asarray(clip["root_trans_offset"][::16][:8]))
    np.testing.assert_allclose(_segments(vis_motion, model, frames), _segments(jvis_motion, jmodel, np.asarray(jp)),
                               atol=1e-5)


class StubRR:
    """A rerun-compatible sink that records what it is sent (as
    tests/test_motion_tools.py streams `vis_rr`)."""

    def __init__(self):
        self.calls = []

    def init(self, name, spawn=False):
        self.calls.append(("init", name))

    def set_time_sequence(self, name, t):
        pass

    def log(self, path, obj):
        self.calls.append((path, np.asarray(obj)))

    @staticmethod
    def LineStrips3D(x):
        return x

    @staticmethod
    def Points3D(x):
        return x


def test_vis_rr_streams_the_jax_packages_skeleton():
    rr, jrr = StubRR(), StubRR()
    n = vis_rr.stream_motion(MOTION, rr=rr, device="cpu")
    assert n == jvis_rr.stream_motion(MOTION, rr=jrr) and n > 100
    assert [c[0] for c in rr.calls] == [c[0] for c in jrr.calls]
    assert sum(1 for c in rr.calls if c[0] == "bodies") == n
    for (path, got), (_, want) in zip(rr.calls[1:], jrr.calls[1:]):
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=path)


def test_vis_smpl_gif_and_its_segments(tmp_path):
    _write_npz(p := tmp_path / "smpl.npz", T=4)
    out = vis_smpl.render_smpl_npz(p, str(tmp_path / "smpl.gif"), stride=2)
    assert os.path.getsize(out) > 1000
    joints = vis_smpl.npz_to_joints(p)[0]
    for t in range(len(joints)):
        np.testing.assert_array_equal(np.asarray(vis_smpl.smpl_segments(joints[t])),
                                      np.asarray(jvis_smpl.smpl_segments(joints[t])))


def test_vis_smpl_mesh_path(tmp_path, monkeypatch):
    """npz motion + a user model file -> mesh frames equal to JAX's, and a GIF;
    without a model, the skeleton tier."""
    monkeypatch.delenv("SMPL_MODEL_PATH", raising=False)
    model_path = _save_npz(_toy_model(), tmp_path / "model.npz")
    poses = np.zeros((4, 72))
    poses[:, 5] = np.linspace(0, 0.5, 4)
    np.savez(mot := tmp_path / "motion.npz", poses=poses, trans=np.zeros((4, 3)), betas=np.zeros(10),
             mocap_framerate=30.0, gender="neutral")
    got, want = vis_smpl._mesh_frames(mot, model_path, 1), jvis_smpl._mesh_frames(mot, model_path, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    vis_smpl.render_smpl_npz(mot, tmp_path / "out.gif", stride=1, smpl_model=model_path)
    vis_smpl.render_smpl_npz(mot, tmp_path / "skel.gif", stride=2)
    assert (tmp_path / "out.gif").stat().st_size > 0 and (tmp_path / "skel.gif").stat().st_size > 0
