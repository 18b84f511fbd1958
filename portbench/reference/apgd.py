"""Plain APGD contact solve of the lanes engine (kernel 1's function).

A frozen copy of the port's plain version in its float32 mode: accelerated
projected gradient descent on the Delassus system A lam + b over each
contact's friction cone, theta carried in float32, the warm start projected,
the step 1 / L from the active rows' absolute row sums. `precision="tf32"`
rounds A and the momentum point to TF32 in the matvec (the control).

A [3R,3R,N], b [3R,N], mu [N], active [R,N], x0 [3R,N] -> lam [3R,N].
"""
from __future__ import annotations

import torch

from .precision import rounded


def solve(A, b, mu, active, x0, iters: int, precision: str = "float32"):
    R = active.shape[0]
    act3 = torch.repeat_interleave(active, 3, dim=0)
    L = torch.amax(act3 * torch.sum(torch.abs(A) * act3[None], dim=1), dim=0)
    inv_L = 1.0 / torch.clamp(L, min=1e-6)
    A_mv = rounded(A, precision)

    def project(lam):
        lam3 = lam.reshape(R, 3, -1)
        ln = torch.clamp(lam3[:, 2], min=0.0)
        tn = torch.sqrt(lam3[:, 0] ** 2 + lam3[:, 1] ** 2)
        scale = torch.clamp(mu[None] * ln / torch.clamp(tn, min=1e-9), max=1.0)
        out = torch.stack([lam3[:, 0] * scale, lam3[:, 1] * scale, ln], dim=1)
        return (out * active[:, None]).reshape(3 * R, -1)

    x = project(x0)
    x_prev = x
    theta = torch.ones((), dtype=b.dtype, device=b.device)
    for _ in range(iters):
        theta_new = 0.5 * (torch.sqrt(theta ** 4 + 4 * theta ** 2) - theta ** 2)
        beta = theta * (1.0 - theta) / (theta ** 2 + theta_new)
        y = x + beta * (x - x_prev)
        g = torch.sum(A_mv * rounded(y, precision)[None], dim=1) + b
        x_prev, x, theta = x, project(y - inv_L[None] * g), theta_new
    return x
