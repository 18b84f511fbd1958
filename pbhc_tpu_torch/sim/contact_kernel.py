"""The contact kernels: the two APGD contact solves, in CUDA for Hopper.

Kernel 1, `apgd_lanes`: the env-last solve of the lanes engine. Replaces
`pbhc_tpu/sim/pallas_contact.py::_apgd_kernel_lanes` (:112-140,
`pallas_call` at :96). The function is the one `LanesEngine._apgd` computes
(`pbhc_tpu/sim/engine_lanes.py:643-682`), which is the reference here: theta
is carried in f32, the warm start is projected, and only the f32 matvec path
(`contact_matvec_dtype = float32`) exists.

Kernel 2, `apgd_envfirst`: the env-first solve of `Engine.substep_batched`.
Replaces `pallas_contact.py::_apgd_kernel` (:37-74, `pallas_call` at :161 in
`solve_contacts_pallas`) and follows it: a zero start and the momentum
coefficients of `_beta_schedule`.

Both share one solver body (`csrc/apgd_common.cuh`): a block stages the
Delassus matrices of a tile of E neighbouring envs in shared memory once and
runs every iteration from there, P threads per (env, contact). The kernels
pick E and P from the row count (`apgd::choose_tile`; `tile` reads the
choice back). Bounds and design notes are in the `.cu` files. Both take
R <= 42 contact rows (n = 3R <= 128).

Each wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version (`apgd_lanes_plain`, `apgd_envfirst_plain`) for CPU tensors; there is
no fallback between the two. `<wrapper>.launches` counts kernel launches.
`apgd_lanes_at_tile` and `apgd_envfirst_at_tile` launch a kernel at a tile
of the caller's choice, for tile sweeps; they count nothing.
"""
from __future__ import annotations

import ctypes

import torch

from pbhc_tpu_torch.utils import nvcc

HEADERS = ("apgd_common.cuh",)
LIBRARY = nvcc.CudaLibrary("apgd_lanes", ("apgd_lanes.cu",), HEADERS)
ENVFIRST_LIBRARY = nvcc.CudaLibrary("apgd_envfirst", ("apgd_envfirst.cu",), HEADERS)
LIBRARIES = (LIBRARY, ENVFIRST_LIBRARY)
_lib = None
_envfirst_lib = None


def tile(kernel: str, R: int) -> tuple:
    """(E, P), the envs per block and threads per contact, that `kernel`
    ("apgd_lanes" or "apgd_envfirst") launches with at R rows. Builds the
    kernel's library if needed."""
    lib = {"apgd_lanes": _library, "apgd_envfirst": _envfirst_library}[kernel]()
    E, P = ctypes.c_int(), ctypes.c_int()
    getattr(lib, f"{kernel}_tile")(R, ctypes.byref(E), ctypes.byref(P))
    return E.value, P.value


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
        _declare(lib, "apgd_lanes", 6)
        _lib = lib
    return _lib


def _declare(lib, kernel: str, n_ptr: int):
    """The C signatures of `kernel`'s exports; its launch functions take
    `n_ptr` tensor pointers."""
    ptrs, ints = [ctypes.c_void_p] * n_ptr, [ctypes.c_int] * 3
    getattr(lib, f"{kernel}_launch").argtypes = ptrs + ints + [ctypes.c_void_p]
    getattr(lib, f"{kernel}_launch_tile").argtypes = ptrs + ints + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    for fn in ("launch", "launch_tile", "max_rows"):
        getattr(lib, f"{kernel}_{fn}").restype = ctypes.c_int
    getattr(lib, f"{kernel}_tile").argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    getattr(lib, f"{kernel}_tile").restype = None


def _launch(lib, kernel: str, tensors, out, R: int, N: int, iters: int, at_tile):
    """Launch `kernel` on CUDA tensors at the kernel's tile, or at `at_tile`
    = (E, P); raise on a tile the kernel does not take or a failed launch."""
    ptrs = [t.data_ptr() for t in tensors] + [out.data_ptr()]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        if at_tile is None:
            err = getattr(lib, f"{kernel}_launch")(*ptrs, R, N, int(iters), stream)
        else:
            err = getattr(lib, f"{kernel}_launch_tile")(*ptrs, R, N, int(iters), *at_tile, stream)
    if err == -1:
        raise ValueError(f"{kernel}: the kernel does not take R={R}, N={N}, iters={iters}"
                         + ("" if at_tile is None else f" at tile (E, P) = {tuple(at_tile)}"))
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error {err}")
    return out


def _check(kernel: str, want: dict):
    """Raise unless every tensor of {name: (tensor, shape)} has its shape, is
    float32 and lies on the first tensor's device."""
    device = next(iter(want.values()))[0].device
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, want {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, the kernel takes float32")
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, A on {device}")


def apgd_lanes(A, b, mu, active, x0, iters: int):
    """The contact solve: CUDA kernel for CUDA tensors, plain version for CPU
    tensors. Same arguments as `apgd_lanes_plain`."""
    _check_lanes(A, b, mu, active, x0)
    if A.device.type == "cpu":
        return apgd_lanes_plain(A, b, mu, active, x0, iters)
    out = _launch_lanes(A, b, mu, active, x0, iters, None)
    apgd_lanes.launches += 1
    return out


def apgd_lanes_at_tile(A, b, mu, active, x0, iters: int, E: int, P: int):
    """Kernel 1 with E envs per block and P threads per contact, in place of
    the tile it picks for R; for tile sweeps. CUDA tensors only; not counted
    in `apgd_lanes.launches`."""
    _check_lanes(A, b, mu, active, x0)
    return _launch_lanes(A, b, mu, active, x0, iters, (E, P))


def _check_lanes(A, b, mu, active, x0):
    R, N = active.shape
    n = 3 * R
    _check("apgd_lanes", {"A": (A, (n, n, N)), "b": (b, (n, N)), "mu": (mu, (N,)),
                          "active": (active, (R, N)), "x0": (x0, (n, N))})


def _launch_lanes(A, b, mu, active, x0, iters, at_tile):
    R, N = active.shape
    if A.device.type != "cuda":
        raise ValueError(f"apgd_lanes: no implementation for device {A.device}")
    lib = _library()
    if R > lib.apgd_lanes_max_rows():
        raise ValueError(f"apgd_lanes: R={R} rows, the kernel takes at most "
                         f"{lib.apgd_lanes_max_rows()} (n = 3R <= 128)")
    tensors = [t.contiguous() for t in (A, b, mu, active, x0)]
    return _launch(lib, "apgd_lanes", tensors, torch.empty_like(tensors[1]), R, N, iters, at_tile)


apgd_lanes.launches = 0


# ----------------------------------------------------------------- kernel 2

def beta_schedule(iters: int):
    """APGD momentum coefficients, the theta recurrence in Python doubles
    (`pallas_contact.py:24-34`)."""
    betas, theta = [], 1.0
    for _ in range(iters):
        theta_new = 0.5 * ((theta ** 4 + 4 * theta ** 2) ** 0.5 - theta ** 2)
        betas.append(theta * (1.0 - theta) / (theta ** 2 + theta_new))
        theta = theta_new
    return betas


def apgd_envfirst_plain(A, b, mu, active, iters: int):
    """Plain PyTorch version of kernel 2, the same function.

    A [N,3R,3R], b [N,3R], mu [N], active [N,R] -> impulses [N,R,3]."""
    N, R = active.shape
    act3 = torch.repeat_interleave(active, 3, dim=1)                  # [N,3R]
    L = torch.amax(act3 * torch.sum(torch.abs(A) * act3[:, None, :], dim=2), dim=1)
    inv_L = (1.0 / torch.clamp(L, min=1e-6))[:, None]

    def project(lam):
        lam3 = lam.reshape(N, R, 3)
        ln = torch.clamp(lam3[..., 2], min=0.0)
        tn = torch.sqrt(lam3[..., 0] ** 2 + lam3[..., 1] ** 2)
        scale = torch.clamp(mu[:, None] * ln / torch.clamp(tn, min=1e-9), max=1.0)
        out = torch.stack([lam3[..., 0] * scale, lam3[..., 1] * scale, ln], dim=-1)
        return (out * active[..., None]).reshape(N, 3 * R)

    x = torch.zeros_like(b)
    x_prev = x
    for beta in beta_schedule(iters):
        y = x + beta * (x - x_prev)
        g = torch.sum(A * y[:, None, :], dim=2) + b
        x_prev, x = x, project(y - inv_L * g)
    return x.reshape(N, R, 3)


def _envfirst_library():
    global _envfirst_lib
    if _envfirst_lib is None:
        lib = nvcc.load(ENVFIRST_LIBRARY)
        _declare(lib, "apgd_envfirst", 5)
        lib.apgd_envfirst_max_iters.restype = ctypes.c_int
        _envfirst_lib = lib
    return _envfirst_lib


def apgd_envfirst(A, b, mu, active, iters: int):
    """Kernel 2: CUDA kernel for CUDA tensors, plain version for CPU tensors.
    Same arguments as `apgd_envfirst_plain`."""
    _check_envfirst(A, b, mu, active)
    if A.device.type == "cpu":
        return apgd_envfirst_plain(A, b, mu, active, iters)
    out = _launch_envfirst(A, b, mu, active, iters, None)
    apgd_envfirst.launches += 1
    return out


def apgd_envfirst_at_tile(A, b, mu, active, iters: int, E: int, P: int):
    """Kernel 2 with E envs per block and P threads per contact, in place of
    the tile it picks for R; for tile sweeps. CUDA tensors only; not counted
    in `apgd_envfirst.launches`."""
    _check_envfirst(A, b, mu, active)
    return _launch_envfirst(A, b, mu, active, iters, (E, P))


def _check_envfirst(A, b, mu, active):
    N, R = active.shape
    n = 3 * R
    _check("apgd_envfirst", {"A": (A, (N, n, n)), "b": (b, (N, n)), "mu": (mu, (N,)),
                             "active": (active, (N, R))})


def _launch_envfirst(A, b, mu, active, iters, at_tile):
    N, R = active.shape
    if A.device.type != "cuda":
        raise ValueError(f"apgd_envfirst: no implementation for device {A.device}")
    lib = _envfirst_library()
    if R > lib.apgd_envfirst_max_rows():
        raise ValueError(f"apgd_envfirst: R={R} rows, the kernel takes at most "
                         f"{lib.apgd_envfirst_max_rows()} (n = 3R <= 128)")
    if not 0 <= iters <= lib.apgd_envfirst_max_iters():
        raise ValueError(f"apgd_envfirst: iters={iters}, the kernel takes at most "
                         f"{lib.apgd_envfirst_max_iters()}")
    tensors = [t.contiguous() for t in (A, b, mu, active)]
    out = torch.empty((N, R, 3), dtype=torch.float32, device=A.device)
    return _launch(lib, "apgd_envfirst", tensors, out, R, N, iters, at_tile)


apgd_envfirst.launches = 0
