"""SMPL joints -> G1 retargeting by a gradient fit through the port's FK
(counterpart of `pbhc_tpu/motion/retarget.py`).

One Adam fit over the whole motion at once: optimise (root_pos [T,3],
root_rot6d [T,6], dof [T,nd], per-match-point offsets [M,3]) so that the
mapped G1 body positions match the SMPL joint targets, with joint-limit,
temporal-smoothness, ground and offset penalties (`retarget.py:47-96`). The
loss's gradient is torch autograd through the batched `fk_root_dof`; Adam is
written out as `optax.adam` computes it (b1 0.9, b2 0.999, eps 1e-8 outside
the square root, bias corrections in float32, no gradient clip), so that the
fit follows the JAX package's step for step. Everything runs on `device`
(default the first CUDA card).

Input: SMPL joints [T, 24, 3] (e.g. GVHMR output or the `smpl_joints` field
of the committed clips). Output: a training-ready clip dict with the JAX
module's keys and dtypes.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation as sRot

from pbhc_tpu_torch.maths import rotations as rot
from pbhc_tpu_torch.model.kinematics import fk_root_dof

# SMPL joint index -> G1 body name (reference phc_g1_23dof.yaml joint_matches)
SMPL_JOINT_MATCHES = [
    (0, "pelvis"),
    (1, "left_hip_pitch_link"), (4, "left_knee_link"), (7, "left_ankle_roll_link"),
    (2, "right_hip_pitch_link"), (5, "right_knee_link"), (8, "right_ankle_roll_link"),
    (16, "left_shoulder_roll_link"), (18, "left_elbow_link"), (20, "left_hand_link"),
    (17, "right_shoulder_roll_link"), (19, "right_elbow_link"), (21, "right_hand_link"),
    (15, "head_link"),
]
PARAMS = ("root_pos", "root_r6", "dof", "offsets")


def _rot6d_to_quat(r6):
    """Continuous 6D rotation -> XYZW quat (`retarget.py:36`)."""
    a, b = r6[..., :3], r6[..., 3:]
    x = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=1e-6)
    b = b - (b * x).sum(-1, keepdim=True) * x
    y = b / torch.clamp(torch.linalg.vector_norm(b, dim=-1, keepdim=True), min=1e-6)
    z = rot.cross(x, y)
    return rot.matrix_to_quat(torch.stack([x, y, z], dim=-1))


class Adam:
    """`optax.adam(lr)`: moments with optax's update order, bias corrections
    `1 - decay ** count` in float32, the update
    `-lr * mu_hat / (sqrt(nu_hat) + eps)` added to each parameter."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params, lr: float):
        self.params, self.lr, self.count = params, float(lr), 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads):
        self.count += 1
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(self.count))
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.copy_((1.0 - self.b1) * g + self.b1 * m)
            v.copy_((1.0 - self.b2) * (g * g) + self.b2 * v)
            p.add_(-self.lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)))


class RetargetFit:
    """The fit's targets, bounds and loss for one motion (`retarget.py:47-87`)."""

    def __init__(self, model, smpl_joints, device="cuda", w_match=1.0, w_smooth=0.5, w_limit=10.0,
                 w_ground=1.0):
        self.model, self.device = model, torch.device(device)
        f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=self.device)
        self.body_ids = [model.body_names.index(n) for _, n in SMPL_JOINT_MATCHES]
        self.targets = f32(np.asarray(smpl_joints)[:, [i for i, _ in SMPL_JOINT_MATCHES]])   # [T,M,3]
        self.lo, self.hi = f32(model.dof_limits[:, 0]), f32(model.dof_limits[:, 1])
        self.w = (w_match, w_smooth, w_limit, w_ground)

    def init_params(self) -> dict:
        """Root at the pelvis target, identity rotation, zero dofs and offsets."""
        T = self.targets.shape[0]
        dev = self.device
        return {"root_pos": self.targets[:, 0].clone(),
                "root_r6": torch.tensor([1.0, 0, 0, 0, 1.0, 0], device=dev).repeat(T, 1),
                "dof": torch.zeros((T, self.model.num_dof), device=dev),
                "offsets": torch.zeros((len(SMPL_JOINT_MATCHES), 3), device=dev)}

    def match_pos(self, p, dof):
        """The match points: the mapped bodies' origins moved by the clipped offsets."""
        quat = _rot6d_to_quat(p["root_r6"])
        body_pos, body_quat, _ = fk_root_dof(self.model, p["root_pos"], quat, dof)
        off = torch.clamp(p["offsets"], -0.25, 0.25)
        ids = self.body_ids
        return body_pos[:, ids] + rot.quat_rotate(body_quat[:, ids], off[None].expand(len(body_pos), -1, -1)), \
            body_pos, quat

    def loss(self, p):
        w_match, w_smooth, w_limit, w_ground = self.w
        mp, body_pos, _ = self.match_pos(p, p["dof"])
        match = ((mp - self.targets) ** 2).sum(-1).mean()
        smooth = ((p["dof"][1:] - p["dof"][:-1]) ** 2).mean() \
            + ((p["root_pos"][1:] - p["root_pos"][:-1]) ** 2).mean() * 10
        limit = (torch.clamp(self.lo - p["dof"], min=0) ** 2 + torch.clamp(p["dof"] - self.hi, min=0) ** 2).mean()
        ground = (torch.clamp(-body_pos[..., 2] + 0.0, min=0) ** 2).mean()     # keep above ground
        # pins the root<->offsets gauge freedom (`retarget.py:80-85`)
        offreg = (p["offsets"] ** 2).sum(-1).mean()
        return w_match * match + w_smooth * smooth + w_limit * limit + w_ground * ground + 0.1 * offreg

    def value_and_grad(self, p):
        """(loss, {name: d loss / d name}), as `jax.value_and_grad(loss_fn)`."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = self.loss(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in PARAMS])
        return loss.detach(), dict(zip(PARAMS, grads))


def retarget_smpl_joints(model, smpl_joints, fps=30, iters=600, lr=0.02, w_match=1.0, w_smooth=0.5,
                         w_limit=10.0, w_ground=1.0, verbose=False, device="cuda"):
    """Fit G1 (root pose + dof) to SMPL joint positions [T,24,3] on `device`.
    Returns a clip dict (`retarget.py:108-127`)."""
    fit = RetargetFit(model, smpl_joints, device, w_match, w_smooth, w_limit, w_ground)
    params = fit.init_params()
    opt = Adam([params[k] for k in PARAMS], lr)
    for i in range(iters):
        loss, grads = fit.value_and_grad(params)
        opt.step([grads[k] for k in PARAMS])
        if verbose and i % 100 == 0:
            print(f"[retarget] iter {i}: loss={float(loss):.5f}")

    with torch.no_grad():
        dof = torch.clamp(params["dof"], fit.lo, fit.hi)
        mp, _, quat = fit.match_pos(params, dof)
        err = float(torch.linalg.vector_norm(mp - fit.targets, dim=-1).mean())
    quat, dof = quat.cpu().numpy(), dof.cpu().numpy()
    T = quat.shape[0]
    axes = np.asarray(model.dof_axis, dtype=np.float32)
    n_extend = model.num_bodies - model.num_real_bodies
    root_aa = sRot.from_quat(quat).as_rotvec()
    pose_aa = np.concatenate([root_aa[:, None, :], dof[:, :, None] * axes[None], np.zeros((T, n_extend, 3))],
                             axis=1)
    return {
        "root_trans_offset": params["root_pos"].cpu().numpy().astype(np.float32),
        "root_rot": quat.astype(np.float32),
        "dof": dof.astype(np.float32),
        "pose_aa": pose_aa.astype(np.float32),
        "fps": int(fps),
        "retarget_mean_error_m": err,
    }
