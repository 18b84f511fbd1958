"""Port parity: the offline motion tools (`motion/tools.py`), the skeleton
classes (`motion/skeleton.py`) and the motion filter (`motion/filter.py`)
against `pbhc_tpu`, on the same numpy inputs, on the CPU.

Each test of tests/test_motion_tools.py and tests/test_skeleton.py has its
counterpart here (the retarget fit's is in tests/test_torch_retarget.py, the
viewers' in tests/test_torch_vis.py).

Tolerances: numpy and scipy code gives the JAX package's arrays exactly;
a batched float32 FK (the contact mask's, the filter's) agrees with JAX's
float32 FK to 1e-5 m, and the mask built on it exactly; the filter's
airborne gravity error, a second difference of the CoM height over
dt = 1/30 s, carries that 1e-5 m times 4 / dt^2 = 3600, so 5e-2 m/s^2.
Files the port writes read with `joblib.load` into the JAX package's
arrays, and the port reads the JAX package's files, exactly.
"""
import joblib
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as sRot

torch.set_num_threads(2)

from pbhc_tpu.model.g1 import load_g1_motion_model as jax_motion_model  # noqa: E402
from pbhc_tpu.model.g1 import load_g1_sim_model as jax_sim_model  # noqa: E402
from pbhc_tpu.motion import filter as jfilter  # noqa: E402
from pbhc_tpu.motion import skeleton as jskel  # noqa: E402
from pbhc_tpu.motion import tools as jtools  # noqa: E402
from pbhc_tpu_torch.model.g1 import load_g1_motion_model, load_g1_sim_model  # noqa: E402
from pbhc_tpu_torch.model.kinematics import fk_root_dof  # noqa: E402
from pbhc_tpu_torch.motion import filter as tfilter  # noqa: E402
from pbhc_tpu_torch.motion import skeleton as tskel  # noqa: E402
from pbhc_tpu_torch.motion import tools as ttools  # noqa: E402
from pbhc_tpu_torch.motion.motion_lib import MotionLib, load_joblib  # noqa: E402

MOTION = "assets/motions/Horse-stance_pose.pkl"


@pytest.fixture(scope="module")
def clip():
    return next(iter(joblib.load(MOTION).values()))


def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def test_interpolate_default_pose(clip):
    want = jtools.interpolate_default_pose(clip, np.zeros(23), lead_in_s=0.3, lead_out_s=0.3)
    got = ttools.interpolate_default_pose(clip, np.zeros(23), lead_in_s=0.3, lead_out_s=0.3)
    _same(got, want)
    n = int(0.3 * clip["fps"])
    assert got["dof"].shape[0] == clip["dof"].shape[0] + 2 * n


def test_convert_29dof_to_23dof(clip):
    fake29 = dict(clip)
    T = clip["dof"].shape[0]
    rng = np.random.default_rng(0)
    fake29["dof"] = rng.normal(size=(T, 29)).astype(np.float32)
    fake29["pose_aa"] = rng.normal(size=(T, 33, 3)).astype(np.float32)
    _same(ttools.convert_29dof_to_23dof(fake29), jtools.convert_29dof_to_23dof(fake29))
    with pytest.raises(ValueError, match="29-dof"):
        ttools.convert_29dof_to_23dof(clip)


def test_compute_contact_mask(clip):
    want = jtools.compute_contact_mask(clip)
    got = ttools.compute_contact_mask(clip, device="cpu")
    _same(got, want)
    assert (got["contact_mask"][0] == 1).all()
    assert (got["contact_mask"] == np.asarray(clip["contact_mask"])).mean() > 0.6


def test_lafan_to_pkl(tmp_path):
    T = 12
    rng = np.random.default_rng(1)
    rows = np.zeros((T, 36), np.float32)
    rows[:, 3:7] = sRot.from_euler("z", rng.uniform(-1, 1, (T, 1))).as_quat()
    rows[:, 2] = 0.79
    rows[:, 7:] = rng.normal(0, 0.2, (T, 29))
    csv = tmp_path / "walk.csv"
    np.savetxt(csv, rows, delimiter=",")
    _same(ttools.lafan_to_pkl(str(csv), 2, 10), jtools.lafan_to_pkl(str(csv), 2, 10))


def _ue_raw(T=12):
    rng = np.random.default_rng(0)
    quat = sRot.from_euler("z", rng.uniform(-1, 1, (T, 1))).as_quat().astype(np.float32)
    return {"g1_ue_walk": {"dof_pos": rng.normal(0, 0.2, (T, 29)).astype(np.float32),
                           "root_pos": rng.normal(0, 0.1, (T, 3)).astype(np.float32),
                           "root_rot": quat, "fps": 50}}


def test_convert_ue_to_23dof(tmp_path):
    raw = _ue_raw()
    got = ttools.convert_ue_to_23dof(raw)
    _same(got, jtools.convert_ue_to_23dof(raw))
    ttools.dump({"g1_ue_walk": got}, tmp_path / "ue.pkl")
    ml = MotionLib(str(tmp_path / "ue.pkl"), load_g1_motion_model(), 1, 0.02, device="cpu")
    assert int(ml.data.num_frames[0]) == 12


def test_convert_23dof_to_29dof(clip, tmp_path):
    got = ttools.convert_23dof_to_29dof(clip)
    _same(got, jtools.convert_23dof_to_29dof(clip))
    ttools.dump({"m": got}, tmp_path / "m29.pkl")
    ml = MotionLib(str(tmp_path / "m29.pkl"), load_g1_motion_model("g1_29dof_rev_1_0"), 1, 0.02, device="cpu")
    assert int(ml.data.num_frames[0]) == len(clip["dof"])


def test_edit_contact_mask(clip):
    edits = [("L", 10, 20, 0.0), ("r", 0, 5, 1.0), ("L", -4, -1, 1.0)]
    _same(ttools.edit_contact_mask(clip, edits), jtools.edit_contact_mask(clip, edits))


@pytest.mark.parametrize("cmd,extra", [
    ("interp", ["lead_in_s=0.2", "lead_out_s=0.1"]),
    ("contact_mask", ["vel_thres=0.003", "height_thres=0.1"]),
    ("edit_contact", ["set=L:10:20:0", "set=R:0:5:1"]),
    ("23to29", []),
    ("ue", []),
    ("lafan", ["start=1", "end=9", "fps=25"]),
])
def test_cli_files_cross_read(cmd, extra, tmp_path):
    """Every command through both CLIs on the same input: the port's file
    read by `joblib.load` equals the JAX package's, which the port's reader
    reads back the same."""
    if cmd == "ue":
        joblib.dump(_ue_raw(), src := str(tmp_path / "ue_in.pkl"))
    elif cmd == "lafan":
        rows = np.zeros((12, 36), np.float32)
        rows[:, 6], rows[:, 7:] = 1.0, np.random.default_rng(2).normal(0, 0.2, (12, 29))
        np.savetxt(src := str(tmp_path / "walk.csv"), rows, delimiter=",")
    else:
        src = MOTION
    port_out, jax_out = str(tmp_path / "port.pkl"), str(tmp_path / "jax.pkl")
    ttools.main([cmd, src, port_out, *extra, "device=cpu"] if cmd == "contact_mask" else [cmd, src, port_out, *extra])
    jtools.main([cmd, src, jax_out, *extra])
    port_by_joblib, jax_by_port = joblib.load(port_out), load_joblib(jax_out)
    want = joblib.load(jax_out)
    assert list(port_by_joblib) == list(want) == list(jax_by_port)
    for k in want:
        _same(port_by_joblib[k], want[k])
        _same(jax_by_port[k], want[k])


# --------------------------------------------------------------- skeleton
def _g1_state(pkg, T=4, seed=0):
    """A G1 skeleton state of the same random hinge angles, root pose and
    translation in the package `pkg` (local rotations from the hinge axes)."""
    model = (jax_sim_model if pkg is jskel else load_g1_sim_model)()
    tree = pkg.SkeletonTree.from_robot_model(model)
    rng = np.random.default_rng(seed)
    dof = rng.uniform(-0.4, 0.4, (T, model.num_dof)).astype(np.float32)
    root_q = sRot.from_euler("xyz", rng.uniform(-0.3, 0.3, (T, 3))).as_quat().astype(np.float32)
    root_p = rng.normal(0, 0.2, (T, 3)).astype(np.float32)
    local = np.zeros((T, model.num_bodies, 4), dtype=np.float32)
    local[..., 3] = 1.0
    for d, b in enumerate(np.asarray(model.dof_body)):
        local[:, b] = sRot.from_rotvec(dof[:, d, None] * np.asarray(model.dof_axis)[d]).as_quat()
    local[:, 0] = root_q
    return model, tree, pkg.SkeletonState(tree, local, root_p), dof, root_p, root_q


def test_skeleton_fk_matches_jax_and_the_port_kinematics():
    _, _, jstate, *_ = _g1_state(jskel)
    model, _, state, dof, root_p, root_q = _g1_state(tskel)
    np.testing.assert_array_equal(state.global_translation, jstate.global_translation)
    np.testing.assert_array_equal(state.global_rotation, jstate.global_rotation)
    p, q, _ = fk_root_dof(model, torch.as_tensor(root_p), torch.as_tensor(root_q), torch.as_tensor(dof))
    np.testing.assert_allclose(state.global_translation, p.numpy(), atol=2e-5)
    np.testing.assert_allclose(np.abs((state.global_rotation * q.numpy()).sum(-1)), 1.0, atol=1e-5)


def test_skeleton_local_global_roundtrip():
    _, jtree, jstate, *_ = _g1_state(jskel, seed=1)
    _, tree, state, *_ = _g1_state(tskel, seed=1)
    back = tskel.SkeletonState.from_global_rotation(tree, state.global_rotation, state.root_translation)
    jback = jskel.SkeletonState.from_global_rotation(jtree, jstate.global_rotation, jstate.root_translation)
    np.testing.assert_array_equal(back.local_rotation, jback.local_rotation)
    np.testing.assert_allclose(np.abs((back.local_rotation * state.local_rotation).sum(-1)), 1.0, atol=1e-5)


def test_skeleton_retarget_identity_roundtrip():
    _, jtree, jstate, *_ = _g1_state(jskel, seed=2)
    _, tree, state, *_ = _g1_state(tskel, seed=2)
    out = state.retarget_to({n: n for n in tree.node_names}, *(tskel.SkeletonState.zero_pose(tree),) * 2, 1.0)
    jout = jstate.retarget_to({n: n for n in jtree.node_names}, *(jskel.SkeletonState.zero_pose(jtree),) * 2, 1.0)
    np.testing.assert_array_equal(out.global_translation, jout.global_translation)
    np.testing.assert_allclose(out.global_translation, state.global_translation, atol=2e-5)


def test_skeleton_motion_velocities():
    _, _, jstate, *_ = _g1_state(jskel, T=8, seed=3)
    _, _, state, *_ = _g1_state(tskel, T=8, seed=3)
    motion = tskel.SkeletonMotion.from_state(state, fps=30)
    jmotion = jskel.SkeletonMotion.from_state(jstate, fps=30)
    np.testing.assert_array_equal(motion.global_velocity, jmotion.global_velocity)
    np.testing.assert_array_equal(motion.global_angular_velocity, jmotion.global_angular_velocity)


# ----------------------------------------------------------------- filter
def test_stability_score_and_filter_clip(clip):
    want = jfilter.stability_score(jax_motion_model(), jax_sim_model(), clip["pose_aa"],
                                   clip["root_trans_offset"], clip["fps"])
    got = tfilter.stability_score(load_g1_motion_model(), load_g1_sim_model(), clip["pose_aa"],
                                  clip["root_trans_offset"], clip["fps"], device="cpu")
    np.testing.assert_allclose(got["com_support_dist"], want["com_support_dist"], atol=1e-5)
    np.testing.assert_allclose(got["airborne_gravity_err"], want["airborne_gravity_err"], atol=5e-2)
    assert got["grounded_frames"] == want["grounded_frames"]
    ok, _ = tfilter.filter_clip(load_g1_motion_model(), load_g1_sim_model(), clip, device="cpu")
    assert ok == jfilter.filter_clip(jax_motion_model(), jax_sim_model(), clip)[0]
