"""Quaternion / rotation math in torch (counterpart of `pbhc_tpu/maths/rotations.py`):
the functions the port's serving path uses.

Quaternions are XYZW. Every function broadcasts over leading batch dims and
has no data-dependent Python control flow, as in the JAX module.
"""
from __future__ import annotations

import torch


def normalize(v: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=eps)


def quat_unit(q: torch.Tensor) -> torch.Tensor:
    return normalize(q)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, XYZW (`rotations.py:38`)."""
    x1, y1, z1, w1 = a.unbind(-1)
    x2, y2, z2, w2 = b.unbind(-1)
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    return torch.stack([x, y, z, w], dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, with broadcasting."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by unit quaternion q (`rotations.py:49`)."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(xyz, v)
    return v + w * t + cross(xyz, t)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conjugate(q), v)


def quat_pos(q: torch.Tensor) -> torch.Tensor:
    """Flip sign so that w >= 0."""
    return torch.where(q[..., 3:4] < 0, -q, q)


def quat_from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    half = angle * 0.5
    xyz = normalize(axis) * torch.sin(half)[..., None]
    return torch.cat([xyz, torch.cos(half)[..., None]], dim=-1)


def exp_map_to_quat(e: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle vector -> XYZW quat, Taylor-safe near zero (`rotations.py:103`)."""
    angle = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    half = 0.5 * angle
    k = torch.where(angle < 1e-4, 0.5 - angle * angle / 48.0,
                    torch.sin(half) / torch.clamp(angle, min=eps))
    return torch.cat([e * k, torch.cos(half)], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """XYZW quat -> 3x3 rotation matrix (`rotations.py:118`)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> XYZW quat, branch-free (`rotations.py:135`)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-18))

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    q0 = torch.stack([m21 - m12, m02 - m20, m10 - m01, 4.0 * qw0 * qw0], -1) / (4.0 * qw0[..., None])
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    q1 = torch.stack([4.0 * qx1 * qx1, m01 + m10, m02 + m20, m21 - m12], -1) / (4.0 * qx1[..., None])
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    q2 = torch.stack([m01 + m10, 4.0 * qy2 * qy2, m12 + m21, m02 - m20], -1) / (4.0 * qy2[..., None])
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    q3 = torch.stack([m02 + m20, m12 + m21, 4.0 * qz3 * qz3, m10 - m01], -1) / (4.0 * qz3[..., None])

    cands = torch.stack([q0, q1, q2, q3], dim=-2)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    q = torch.take_along_dim(cands, idx[..., None, None].expand(idx.shape + (1, 4)), dim=-2)[..., 0, :]
    return quat_unit(quat_pos(q))


def _unit_axis(like: torch.Tensor, i: int) -> torch.Tensor:
    e = torch.zeros_like(like[..., :3])
    e[..., i] = 1.0
    return e


def calc_heading(q: torch.Tensor) -> torch.Tensor:
    """Yaw of the rotated x-axis (`rotations.py:204`)."""
    r = quat_rotate(q, _unit_axis(q, 0))
    return torch.atan2(r[..., 1], r[..., 0])


def calc_heading_quat_inv(q: torch.Tensor) -> torch.Tensor:
    return quat_from_angle_axis(-calc_heading(q), _unit_axis(q, 2))


def slerp(q0: torch.Tensor, q1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical lerp; t broadcasts with trailing dim 1 (`rotations.py:239`)."""
    cos_half = torch.sum(q0 * q1, dim=-1)
    q1 = torch.where((cos_half < 0)[..., None], -q1, q1)
    cos_half = torch.abs(cos_half)[..., None]
    half = torch.acos(torch.clamp(cos_half, -1.0, 1.0))
    sin_half = torch.sqrt(torch.clamp(1.0 - cos_half * cos_half, min=0.0))
    safe_sin = torch.clamp(sin_half, min=1e-6)
    out = torch.sin((1 - t) * half) / safe_sin * q0 + torch.sin(t * half) / safe_sin * q1
    out = torch.where(sin_half < 0.001, (1 - t) * q0 + t * q1, out)
    return torch.where(cos_half >= 1, q0, out)


def small_random_quat(shape, max_angle: float, generator: torch.Generator,
                      device=None) -> torch.Tensor:
    """Random small rotation (`rotations.py:261`), drawn from `generator`."""
    axis = normalize(torch.randn(shape + (3,), generator=generator, device=device))
    ang = max_angle * torch.rand(shape + (1,), generator=generator, device=device)
    return torch.cat([torch.sin(ang / 2) * axis, torch.cos(ang / 2)], dim=-1)
