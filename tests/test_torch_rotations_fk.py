"""Port parity: quaternion math and forward kinematics against `pbhc_tpu`.

Inputs come from a numpy seed and go through both packages in float32.
Tolerance: 1e-5 absolute for unit-scale outputs (a few f32 ulps after the
chains of products that FK composes over 8 tree levels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu.maths import rotations as jr  # noqa: E402
from pbhc_tpu.model import g1 as jg1  # noqa: E402
from pbhc_tpu.model import kinematics as jk  # noqa: E402
from pbhc_tpu_torch.maths import rotations as tr  # noqa: E402
from pbhc_tpu_torch.model import g1 as tg1  # noqa: E402
from pbhc_tpu_torch.model import kinematics as tk  # noqa: E402

ATOL = 1e-5


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _inputs(rng):
    n = 64
    q, q2 = _quats(rng, n), _quats(rng, n)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return {
        "quat_mul": (q, q2), "quat_rotate": (q, v), "quat_rotate_inverse": (q, v),
        "quat_conjugate": (q,), "quat_pos": (q,), "quat_to_matrix": (q,),
        "matrix_to_quat": (np.asarray(jr.quat_to_matrix(jnp.asarray(q))),),
        "exp_map_to_quat": (np.concatenate([v, 1e-6 * v[:8]]),),
        "quat_from_angle_axis": (v[:, 0], rng.normal(size=(n, 3)).astype(np.float32)),
        "calc_heading": (q,), "calc_heading_quat_inv": (q,),
        "slerp": (q, q2, rng.uniform(size=(n, 1)).astype(np.float32)),
        "normalize": (v,),
    }


@pytest.mark.parametrize("name", sorted(_inputs(np.random.default_rng(0))))
def test_rotation_fn_matches_jax(name):
    args = _inputs(np.random.default_rng(0))[name]
    ref = np.asarray(getattr(jr, name)(*[jnp.asarray(a) for a in args]))
    out = getattr(tr, name)(*[torch.tensor(np.array(a)) for a in args]).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_slerp_endpoints_and_near_parallel():
    q = _quats(np.random.default_rng(1), 8)
    for t in (0.0, 1.0):
        tt = np.full((8, 1), t, np.float32)
        ref = np.asarray(jr.slerp(jnp.asarray(q), jnp.asarray(q), jnp.asarray(tt)))
        np.testing.assert_allclose(tr.slerp(torch.as_tensor(q), torch.as_tensor(q), torch.as_tensor(tt)).numpy(),
                                   ref, atol=ATOL)


@pytest.fixture(scope="module")
def models():
    return (jg1.load_g1_sim_model("g1_23dof_lock_wrist"), tg1.load_g1_sim_model("g1_23dof_lock_wrist"),
            jg1.load_g1_motion_model("g1_23dof_lock_wrist"), tg1.load_g1_motion_model("g1_23dof_lock_wrist"))


def test_fk_root_dof_and_velocities_random_poses(models):
    jm, tm, _, _ = models
    rng = np.random.default_rng(2)
    n = 32
    rp = rng.normal(size=(n, 3)).astype(np.float32)
    rq = _quats(rng, n)
    q = rng.uniform(-1.0, 1.0, size=(n, jm.num_dof)).astype(np.float32)
    rv, rw = rng.normal(size=(2, n, 3)).astype(np.float32)
    qd = rng.normal(size=(n, jm.num_dof)).astype(np.float32)
    jp, jq, jR = jax.vmap(jk.fk_root_dof, in_axes=(None, 0, 0, 0))(jm, jnp.asarray(rp), jnp.asarray(rq), jnp.asarray(q))
    tp, tq, tR = tk.fk_root_dof(tm, torch.as_tensor(rp), torch.as_tensor(rq), torch.as_tensor(q))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ATOL)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=ATOL)
    jv, jw = jax.vmap(jk.fk_velocities, in_axes=(None, 0, 0, 0, 0, 0))(jm, jp, jR, jnp.asarray(rv), jnp.asarray(rw), jnp.asarray(qd))
    tv, tw = tk.fk_velocities(tm, tp, tR, torch.as_tensor(rv), torch.as_tensor(rw), torch.as_tensor(qd))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)   # lever arms x O(1) rates
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL)


def test_fk_pose_aa_and_dof_recovery(models):
    _, _, jm, tm = models
    rng = np.random.default_rng(3)
    pose = (rng.normal(size=(16, jm.num_bodies, 3)) * 0.4).astype(np.float32)
    trans = rng.normal(size=(16, 3)).astype(np.float32)
    jp, jq = jax.vmap(jk.fk_pose_aa, in_axes=(None, 0, 0))(jm, jnp.asarray(pose), jnp.asarray(trans))
    tp, tq = tk.fk_pose_aa(tm, torch.as_tensor(pose), torch.as_tensor(trans))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ATOL)
    np.testing.assert_allclose(tk.dof_from_pose_aa(tm, torch.as_tensor(pose)).numpy(),
                               np.asarray(jk.dof_from_pose_aa(jm, jnp.asarray(pose))), atol=0)
