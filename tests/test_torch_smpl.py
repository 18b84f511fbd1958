"""Port parity: the SMPL ``.npz`` ingestion (`motion/smpl_npz.py`) and the
SMPL body model (`motion/smpl_model.py`) against `pbhc_tpu`, on the same
numpy inputs (toy body models and archives built from a numpy seed by the
JAX package's own test recipes; the licensed SMPL files are not used).

Each test of tests/test_smpl_npz.py and tests/test_smpl_model.py has its
counterpart here (the viewer's in tests/test_torch_vis.py). Both packages
are numpy here, so every array is compared exactly, except where the port's
float32 FK runs (`snap_to_ground`): 1e-5 m, float32 FK rounding.
"""
import subprocess
import sys

import joblib
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu.model.g1 import load_g1_motion_model as jax_motion_model  # noqa: E402
from pbhc_tpu.motion import smpl_model as jmodel  # noqa: E402
from pbhc_tpu.motion import smpl_npz as jnpz  # noqa: E402
from pbhc_tpu_torch.model.g1 import load_g1_motion_model  # noqa: E402
from pbhc_tpu_torch.motion import smpl_model as tmodel  # noqa: E402
from pbhc_tpu_torch.motion import smpl_npz as tnpz  # noqa: E402
from pbhc_tpu_torch.motion.motion_lib import MotionLib, load_joblib  # noqa: E402
from test_smpl_model import _save_npz, _toy_model, _toy_model_24  # noqa: E402
from test_smpl_npz import UPRIGHT, _write_npz  # noqa: E402


def _same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# ---------------------------------------------------------------- smpl_npz
def test_load_schema_and_shapes(tmp_path):
    _write_npz(p := tmp_path / "smpl.npz", T=7, fps=25.0)
    got = tnpz.load_smpl_npz(p)
    _same(got, jnpz.load_smpl_npz(p))
    assert got["poses"].shape == (7, 24, 3) and got["fps"] == 25.0


def test_load_rejects_bad_schema(tmp_path):
    np.savez(p := tmp_path / "bad.npz", poses=np.zeros((5, 72)))
    np.savez(p2 := tmp_path / "bad2.npz", poses=np.zeros((5, 10)), trans=np.zeros((5, 3)))
    for path, match in ((p, "trans"), (p2, "pose dims")):
        for pkg in (tnpz, jnpz):
            with pytest.raises(ValueError, match=match):
                pkg.load_smpl_npz(path)


def test_load_accepts_smplh_extra_dims(tmp_path):
    poses = np.zeros((4, 156))
    poses[:, :3] = UPRIGHT.as_rotvec()
    np.savez(p := tmp_path / "amass.npz", poses=poses, trans=np.zeros((4, 3)), mocap_framerate=120.0,
             betas=np.zeros(16))
    _same(tnpz.load_smpl_npz(p), jnpz.load_smpl_npz(p))


def test_fk_upright_rest_pose(tmp_path):
    _write_npz(p := tmp_path / "smpl.npz")
    joints, fps = tnpz.npz_to_joints(p)
    jjoints, jfps = jnpz.npz_to_joints(p)
    _same(joints, jjoints)
    assert fps == jfps == 30.0
    assert np.all(joints[:, 15, 2] > joints[:, 0, 2] + 0.4)


def test_fk_bone_lengths_invariant_under_motion():
    rng = np.random.default_rng(0)
    poses, trans = rng.normal(scale=0.3, size=(16, 24, 3)), rng.normal(size=(16, 3))
    _same(tnpz.smpl_fk(poses, trans), jnpz.smpl_fk(poses, trans))


def test_fk_root_rotation_spins_world():
    base = np.zeros((3, 24, 3))
    base[:, 0] = UPRIGHT.as_rotvec()
    _same(tnpz.smpl_fk(base, np.ones((3, 3))), jnpz.smpl_fk(base, np.ones((3, 3))))


def test_npz_to_pkl_cli_roundtrip(tmp_path):
    """The CLI on a 6-frame archive (120 fit iterations on the CPU): its pkl
    reads back through `joblib.load` and the port's reader alike and loads in
    the port's `MotionLib`; its skeleton scale and floor are the JAX
    package's, and `snap_to_ground` agrees with JAX's on the port's clip."""
    _write_npz(p := tmp_path / "smpl.npz", T=6)
    out = tmp_path / "motion.pkl"
    r = subprocess.run([sys.executable, "-m", "pbhc_tpu_torch.motion.smpl_npz", str(p), str(out), "--iters", "120",
                        "--name", "walk", "device=cpu"], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    clip = joblib.load(out)["walk"]
    _same(load_joblib(out), {"walk": clip})
    for k, shape in [("root_trans_offset", (6, 3)), ("root_rot", (6, 4)), ("dof", (6, 23)), ("pose_aa", (6, 27, 3))]:
        assert clip[k].shape == shape and clip[k].dtype == np.float32, k
    assert clip["retarget_mean_error_m"] < 0.25 and clip["fps"] == 30
    model, jmodel_ = load_g1_motion_model(), jax_motion_model()
    assert tnpz._rest_pelvis_drop(model) == jnpz._rest_pelvis_drop(jmodel_)
    ml = MotionLib(str(out), model, 1, 0.02, device="cpu")
    assert float(ml.data.lengths[0]) == pytest.approx(5 / 30.0, rel=1e-6)
    raw = dict(clip, root_trans_offset=clip["root_trans_offset"] + np.float32([0.0, 0.0, 0.1]))
    got, want = tnpz.snap_to_ground(raw, model, device="cpu"), jnpz.snap_to_ground(raw, jmodel_)
    np.testing.assert_allclose(got["root_trans_offset"], want["root_trans_offset"], atol=1e-5)
    np.testing.assert_allclose(got["root_trans_offset"], clip["root_trans_offset"], atol=1e-5)


# -------------------------------------------------------------- smpl_model
def _both(tmp_path, m):
    path = _save_npz(m, tmp_path / "m.npz")
    return tmodel.load_smpl_model(path), jmodel.load_smpl_model(path)


def test_load_npz_and_rest(tmp_path):
    got, want = _both(tmp_path, _toy_model())
    _same(got, want)
    _same(tmodel.rest_joints(got), jmodel.rest_joints(want))
    _same(tmodel.rest_offsets_from_model(got), jmodel.rest_offsets_from_model(want))


def test_identity_pose_is_template(tmp_path):
    got, want = _both(tmp_path, _toy_model())
    poses, trans = np.zeros((2, 12)), np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0]])
    _same(tmodel.smpl_lbs(got, poses, trans=trans), jmodel.smpl_lbs(want, poses, trans=trans))
    np.testing.assert_allclose(tmodel.smpl_lbs(got, poses)[0][0], got["v_template"], atol=1e-10)


def test_betas_shift_template(tmp_path):
    got, want = _both(tmp_path, _toy_model())
    betas = np.linspace(-1, 1, 10)
    _same(tmodel.smpl_lbs(got, np.zeros((1, 12)), betas=betas), jmodel.smpl_lbs(want, np.zeros((1, 12)), betas=betas))
    _same(tmodel.shaped_template(got, betas), jmodel.shaped_template(want, betas))


def test_root_rotation_is_rigid(tmp_path):
    got, want = _both(tmp_path, _toy_model())
    poses = np.zeros((1, 4, 3))
    poses[0, 0, 2] = np.pi / 2
    _same(tmodel.smpl_lbs(got, poses), jmodel.smpl_lbs(want, poses))


def test_child_joint_rotation_moves_only_descendants(tmp_path):
    got, want = _both(tmp_path, _toy_model(J=4))
    poses = np.zeros((1, 4, 3))
    poses[0, 2, 0] = np.pi / 2
    verts, joints = tmodel.smpl_lbs(got, poses)
    _same((verts, joints), jmodel.smpl_lbs(want, poses))
    np.testing.assert_allclose(verts[0, :6], got["v_template"][:6], atol=1e-10)


def test_posedirs_applied(tmp_path):
    m = _toy_model(J=4)
    m["posedirs"] = np.random.RandomState(1).randn(12, 3, 27) * 0.001
    got, want = _both(tmp_path, m)
    poses = np.zeros((1, 4, 3))
    poses[0, 1, 1] = 0.3
    _same(tmodel.smpl_lbs(got, poses), jmodel.smpl_lbs(want, poses))


def test_official_pkl_layout_chumpy_and_sparse(tmp_path):
    """An official-layout pkl (py2 protocol, chumpy arrays, a sparse
    regressor) written as tests/test_smpl_model.py writes it, read by both."""
    import pickle
    import types

    import scipy.sparse as sp

    m = _toy_model()
    ch, ch_ch = types.ModuleType("chumpy"), types.ModuleType("chumpy.ch")

    class Ch:
        def __init__(self, x):
            self.x = x

    Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
    ch_ch.Ch, ch.ch = Ch, ch_ch
    sys.modules["chumpy"], sys.modules["chumpy.ch"] = ch, ch_ch
    try:
        raw = {"v_template": Ch(m["v_template"]), "shapedirs": Ch(m["shapedirs"]),
               "J_regressor": sp.csr_matrix(m["J_regressor"]), "weights": Ch(m["weights"]), "f": m["f"],
               "kintree_table": m["kintree_table"]}
        with open(path := tmp_path / "SMPL_NEUTRAL.pkl", "wb") as f:
            pickle.dump(raw, f, protocol=2)
    finally:
        del sys.modules["chumpy"], sys.modules["chumpy.ch"]
    got = tmodel.load_smpl_model(path)
    _same(got, jmodel.load_smpl_model(path))
    np.testing.assert_allclose(got["J_regressor"], m["J_regressor"])


def test_find_model_file_env_and_absent(tmp_path, monkeypatch):
    monkeypatch.delenv("SMPL_MODEL_PATH", raising=False)
    for pkg in (tmodel, jmodel):
        with pytest.raises(FileNotFoundError):
            pkg.find_model_file(str(tmp_path / "absent.pkl"))
    assert tmodel.find_model_file(None) is None is jmodel.find_model_file(None)
    p = _save_npz(_toy_model(), tmp_path / "m.npz")
    assert tmodel.find_model_file(p) == p == jmodel.find_model_file(p)
    monkeypatch.setenv("SMPL_MODEL_PATH", p)
    assert tmodel.find_model_file(None) == p == jmodel.find_model_file(None)


def test_npz_to_joints_uses_body_model(tmp_path, monkeypatch):
    monkeypatch.delenv("SMPL_MODEL_PATH", raising=False)
    model_path, _ = _toy_model_24(tmp_path)
    rng = np.random.RandomState(5)
    np.savez(mot := tmp_path / "mot.npz", poses=rng.randn(3, 72) * 0.1, trans=rng.randn(3, 3) * 0.2,
             betas=np.linspace(-0.5, 0.5, 10), mocap_framerate=25.0, gender="neutral")
    got, fps = tnpz.npz_to_joints(mot, smpl_model=model_path)
    want, jfps = jnpz.npz_to_joints(mot, smpl_model=model_path)
    _same(got, want)
    assert fps == jfps == 25.0
    assert np.abs(got - tnpz.npz_to_joints(mot)[0]).max() > 1e-4       # betas engaged
