"""Port parity: the SMPL-to-G1 retarget fit (`motion/retarget.py`) against
`pbhc_tpu/motion/retarget.py` on the CPU.

The targets are SMPL joints from the neutral skeleton's FK (`smpl_fk`) of a
seeded pose sequence (smooth sinusoids about the upright root, walking
forward), floored and scaled to the G1 as `npz_to_clip` does: the
`smpl_joints` the committed clips carry are all zeros, a degenerate target.

- The loss and its gradient at the same (perturbed) parameters, against
  `jax.value_and_grad` of the JAX loss (written out here from the same
  calls, `retarget.py:65-87`, as the closure is not reachable): rtol 1e-5
  (float32 FK and its backward pass in two libraries).
- Three Adam steps from a shared state on the same gradients, against
  `optax.adam`: atol 1e-7.
- The whole fit (30 frames, 500 iterations, as tests/test_motion_tools.py
  runs JAX's): `retarget_mean_error_m` below 0.08 m and within 2 mm of
  JAX's; the same on the committed horse-stance clip's (zero) joints. The parameters themselves are not compared after many steps:
  Adam's first steps turn float32 rounding of near-zero gradients into
  differences of up to lr (ROADMAP queue 3).
"""
import jax
import jax.numpy as jnp
import joblib
import numpy as np
import optax
import pytest
import torch
from scipy.spatial.transform import Rotation as sRot

torch.set_num_threads(2)

from pbhc_tpu.maths import rotations as jrot  # noqa: E402
from pbhc_tpu.model.g1 import load_g1_motion_model as jax_motion_model  # noqa: E402
from pbhc_tpu.model.kinematics import fk_root_dof as jax_fk_root_dof  # noqa: E402
from pbhc_tpu.motion import retarget as jret  # noqa: E402
from pbhc_tpu.motion.smpl_npz import smpl_fk  # noqa: E402
from pbhc_tpu_torch.model.g1 import load_g1_motion_model  # noqa: E402
from pbhc_tpu_torch.motion import retarget as tret  # noqa: E402

MOTION = "assets/motions/Horse-stance_punch.pkl"
FRAMES = 30


def synthetic_joints(T, seed=0):
    """SMPL joints [T,24,3] of a seeded pose sequence, floored and scaled."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 30.0
    poses = np.zeros((T, 24, 3))
    poses[:, 0] = sRot.from_euler("xyz", [np.pi / 2, 0, np.pi]).as_rotvec()
    amp, freq, phase = rng.uniform(0, 0.4, (24, 3)), rng.uniform(0.3, 1.5, (24, 3)), rng.uniform(0, 6.3, (24, 3))
    poses[:, 1:] = (amp * np.sin(2 * np.pi * freq * t[:, None, None] + phase))[:, 1:]
    j = smpl_fk(poses, np.stack([0.3 * t, np.zeros(T), np.full(T, 0.9)], 1))
    j[..., 2] -= j[:, [7, 8, 10, 11], 2].min()
    return (j * 0.85).astype(np.float32)


@pytest.fixture(scope="module")
def joints():
    return synthetic_joints(FRAMES)


def _jax_loss(model, smpl_joints):
    """`retarget.py:65-87`'s loss, from the JAX module's own calls."""
    body_ids = jnp.asarray([model.body_names.index(n) for _, n in jret.SMPL_JOINT_MATCHES])
    targets = jnp.asarray(smpl_joints)[:, jnp.asarray([i for i, _ in jret.SMPL_JOINT_MATCHES])]
    lo = jnp.asarray(model.dof_limits[:, 0], dtype=jnp.float32)
    hi = jnp.asarray(model.dof_limits[:, 1], dtype=jnp.float32)
    fk = jax.vmap(jax_fk_root_dof, in_axes=(None, 0, 0, 0))

    def loss_fn(p):
        quat = jret._rot6d_to_quat(p["root_r6"])
        body_pos, body_quat, _ = fk(model, p["root_pos"], quat, p["dof"])
        off = jnp.clip(p["offsets"], -0.25, 0.25)
        match_pos = body_pos[:, body_ids] + jrot.quat_rotate(body_quat[:, body_ids], off[None])
        match = ((match_pos - targets) ** 2).sum(-1).mean()
        smooth = ((p["dof"][1:] - p["dof"][:-1]) ** 2).mean() \
            + ((p["root_pos"][1:] - p["root_pos"][:-1]) ** 2).mean() * 10
        limit = (jnp.clip(lo - p["dof"], 0, None) ** 2 + jnp.clip(p["dof"] - hi, 0, None) ** 2).mean()
        ground = (jnp.clip(-body_pos[..., 2] + 0.0, 0, None) ** 2).mean()
        offreg = (p["offsets"] ** 2).sum(-1).mean()
        return 1.0 * match + 0.5 * smooth + 10.0 * limit + 1.0 * ground + 0.1 * offreg

    return loss_fn


def _params(fit, seed):
    """The fit's initial parameters, perturbed from a numpy seed (dofs past
    their limits, non-zero offsets), as numpy arrays."""
    rng = np.random.default_rng(seed)
    p = {k: v.numpy().copy() for k, v in fit.init_params().items()}
    for k, scale in (("root_pos", 0.05), ("root_r6", 0.2), ("dof", 0.8), ("offsets", 0.1)):
        p[k] = (p[k] + scale * rng.normal(size=p[k].shape)).astype(np.float32)
    return p


def test_loss_and_gradient_match_jax(joints):
    fit = tret.RetargetFit(load_g1_motion_model(), joints, device="cpu")
    p = _params(fit, 0)
    loss, grads = fit.value_and_grad({k: torch.as_tensor(v) for k, v in p.items()})
    jax_vg = jax.jit(jax.value_and_grad(_jax_loss(jax_motion_model(), joints)))
    jloss, jgrads = jax_vg({k: jnp.asarray(v) for k, v in p.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in tret.PARAMS:
        g, jg = grads[k].numpy(), np.asarray(jgrads[k])
        np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max(), err_msg=k)


def test_adam_steps_match_optax():
    rng = np.random.default_rng(1)
    shapes = {"root_pos": (5, 3), "root_r6": (5, 6), "dof": (5, 23), "offsets": (14, 3)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = optax.adam(0.02)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    state = tx.init(jp)
    tp = [torch.as_tensor(p[k].copy()) for k in tret.PARAMS]
    opt = tret.Adam(tp, 0.02)
    for step in range(3):
        g = {k: (10.0 ** -step * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.as_tensor(g[k]) for k in tret.PARAMS])
        for k, t in zip(tret.PARAMS, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), atol=1e-7, err_msg=f"step {step} {k}")


@pytest.mark.parametrize("source", ["synthetic", "committed clip"])
def test_retarget_fit_error_matches_jax(joints, source):
    if source != "synthetic":
        joints = np.asarray(next(iter(joblib.load(MOTION).values()))["smpl_joints"][:FRAMES])
    out = tret.retarget_smpl_joints(load_g1_motion_model(), joints, iters=500, device="cpu")
    want = jret.retarget_smpl_joints(jax_motion_model(), joints, iters=500)
    assert out["retarget_mean_error_m"] < 0.08
    assert abs(out["retarget_mean_error_m"] - want["retarget_mean_error_m"]) < 2e-3
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert out[k].shape == v.shape and out[k].dtype == v.dtype, k
        else:
            assert type(out[k]) is type(v), k
    assert np.isfinite(out["pose_aa"]).all() and out["fps"] == 30
