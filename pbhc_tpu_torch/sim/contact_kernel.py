"""Kernel 1: the env-last APGD contact solve, in CUDA for Hopper.

Replaces `pbhc_tpu/sim/pallas_contact.py::_apgd_kernel_lanes` (:112-140,
`pallas_call` at :96). The function is the one `LanesEngine._apgd` computes
(`pbhc_tpu/sim/engine_lanes.py:643-682`), which is the reference here: theta
is carried in f32, the warm start is projected, and only the f32 matvec path
(`contact_matvec_dtype = float32`) exists.

Bound at the slice's shape (R = 12 rows, N = 4096 envs, 16 iterations) on an
H100: reading A once is 21.2 MB, 6.3 us at 3.35 TB/s; the 170 MFLOP of f32
work take 2.5 us at 67 TFLOP/s. The solve is memory bound, about 6.3 us per
launch; the design note is in `csrc/apgd_lanes.cu`.

`apgd_lanes` launches the kernel for CUDA tensors and runs the plain PyTorch
version `apgd_lanes_plain` for CPU tensors; there is no fallback between the
two. `apgd_lanes.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from pbhc_tpu_torch.utils import nvcc

LIBRARY = nvcc.CudaLibrary("apgd_lanes", ("apgd_lanes.cu",))
_lib = None


def apgd_lanes_plain(A, b, mu, active, x0, iters: int):
    """Plain PyTorch APGD, the same function as the kernel.

    A [3R,3R,N], b [3R,N], mu [N], active [R,N], x0 [3R,N] -> lam [3R,N]."""
    R = active.shape[0]
    act3 = torch.repeat_interleave(active, 3, dim=0)                  # [3R,N]
    L = torch.amax(act3 * torch.sum(torch.abs(A) * act3[None], dim=1), dim=0)
    inv_L = 1.0 / torch.clamp(L, min=1e-6)

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
        g = torch.sum(A * y[None], dim=1) + b
        x_prev, x, theta = x, project(y - inv_L[None] * g), theta_new
    return x


def _library():
    global _lib
    if _lib is None:
        lib = nvcc.load(LIBRARY)
        lib.apgd_lanes_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.apgd_lanes_launch.restype = ctypes.c_int
        lib.apgd_lanes_max_rows.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(A, b, mu, active, x0):
    R, N = active.shape
    n = 3 * R
    want = {"A": (A, (n, n, N)), "b": (b, (n, N)), "mu": (mu, (N,)),
            "active": (active, (R, N)), "x0": (x0, (n, N))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"apgd_lanes: {name} has shape {tuple(t.shape)}, want {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"apgd_lanes: {name} is {t.dtype}, the kernel takes float32")
        if t.device != A.device:
            raise ValueError(f"apgd_lanes: {name} is on {t.device}, A on {A.device}")


def apgd_lanes(A, b, mu, active, x0, iters: int):
    """The contact solve: CUDA kernel for CUDA tensors, plain version for CPU
    tensors. Same arguments as `apgd_lanes_plain`."""
    _check(A, b, mu, active, x0)
    if A.device.type == "cpu":
        return apgd_lanes_plain(A, b, mu, active, x0, iters)
    if A.device.type != "cuda":
        raise ValueError(f"apgd_lanes: no implementation for device {A.device}")
    lib = _library()
    R, N = active.shape
    if R > lib.apgd_lanes_max_rows():
        raise ValueError(f"apgd_lanes: R={R} rows, the kernel takes at most "
                         f"{lib.apgd_lanes_max_rows()} (its block's shared memory)")
    A, b, mu, active, x0 = (t.contiguous() for t in (A, b, mu, active, x0))
    out = torch.empty_like(b)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.apgd_lanes_launch(A.data_ptr(), b.data_ptr(), mu.data_ptr(), active.data_ptr(),
                                    x0.data_ptr(), out.data_ptr(), R, N, int(iters), stream)
    if err != 0:
        raise RuntimeError(f"apgd_lanes: kernel launch failed with CUDA error {err}")
    apgd_lanes.launches += 1
    return out


apgd_lanes.launches = 0
