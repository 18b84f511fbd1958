"""The contact kernels: the two APGD contact solves, in CUDA for Hopper.

Kernel 1, `apgd_lanes`: the env-last solve of the lanes engine. Replaces
`pbhc_tpu/sim/pallas_contact.py::_apgd_kernel_lanes` (:112-140,
`pallas_call` at :96). The function is the one `LanesEngine._apgd` computes
(`pbhc_tpu/sim/engine_lanes.py:643-682`), which is the reference here: theta
is carried in f32 and the warm start is projected. Its matvec runs in one of
three modes, `contact_matvec_dtype` (`MV_MODES`): float32, or the product of
A and the momentum point y rounded to bfloat16 or float16 as JAX's compiled
`jnp.sum((A.astype(dt) * y.astype(dt)).astype(f32), axis=1)` computes it on
the CPU (`matvec_plain`). The Lipschitz bound comes from the f32 A in every mode.

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
no fallback between the two. `<wrapper>.launches` counts kernel launches
(kernel 1's in every mode; `apgd_lanes.mode_launches` by mode).
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
# kernel 1's matvec modes, by `contact_matvec_dtype`: the mode index of its
# launch function
MV_MODES = {"float32": 0, "bfloat16": 1, "float16": 2}
_lib = None
_envfirst_lib = None


def tile(kernel: str, R: int, mv_dtype: str = "float32") -> tuple:
    """(E, P), the envs per block and threads per contact, that `kernel`
    ("apgd_lanes" or "apgd_envfirst") launches with at R rows in the matvec
    mode `mv_dtype` (kernel 2 has float32 only). Kernel 1's modes share one
    tile: each stages A in float32, the reduced ones rounded in place. Builds
    the kernel's library if needed."""
    _check_mode(kernel, mv_dtype)
    lib = {"apgd_lanes": _library, "apgd_envfirst": _envfirst_library}[kernel]()
    E, P = ctypes.c_int(), ctypes.c_int()
    getattr(lib, f"{kernel}_tile")(R, ctypes.byref(E), ctypes.byref(P))
    return E.value, P.value


def _check_mode(kernel: str, mv_dtype: str):
    modes = MV_MODES if kernel == "apgd_lanes" else ("float32",)
    if mv_dtype not in modes:
        raise ValueError(f"{kernel}: matvec dtype {mv_dtype!r}, takes one of {', '.join(modes)}")


def round_to(x, mv_dtype: str):
    """`x` rounded to `mv_dtype` (to nearest, ties to even), held in float32."""
    return x if mv_dtype == "float32" else x.to(getattr(torch, mv_dtype)).float()


def matvec_plain(A_mv, y, mv_dtype: str):
    """sum_j A_mv[i,j,n] y[j,n] as XLA on the CPU computes the lanes
    engine's compiled matvec, `jnp.sum((A_mv * y.astype(dt)[None])
    .astype(f32), axis=1)` (`engine_lanes.py:618-619, 674-675`): `A_mv` is
    A rounded to the dtype once (`round_to`), y is rounded here. In bfloat16
    the product of the two rounded operands stays exact in float32 (8-bit
    significands); in float16 the product is rounded to float16. The sum is
    in float32. Rounding the bfloat16 product too, as torch's bfloat16
    multiply does, is another function
    (tests/test_torch_engine_lanes.py::test_matvec_product_rule_matches_jax)."""
    prod = A_mv * round_to(y, mv_dtype)[None]
    if mv_dtype == "float16":
        prod = round_to(prod, mv_dtype)
    return torch.sum(prod, dim=1)


def apgd_lanes_plain(A, b, mu, active, x0, iters: int, mv_dtype: str = "float32"):
    """Plain PyTorch APGD, the same function as the kernel in each mode.

    A [3R,3R,N], b [3R,N], mu [N], active [R,N], x0 [3R,N] -> lam [3R,N]."""
    R = active.shape[0]
    act3 = torch.repeat_interleave(active, 3, dim=0)                  # [3R,N]
    L = torch.amax(act3 * torch.sum(torch.abs(A) * act3[None], dim=1), dim=0)
    inv_L = 1.0 / torch.clamp(L, min=1e-6)
    A_mv = round_to(A, mv_dtype)

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
        g = matvec_plain(A_mv, y, mv_dtype) + b
        x_prev, x, theta = x, project(y - inv_L[None] * g), theta_new
    return x


def _library():
    global _lib
    if _lib is None:
        lib = nvcc.load(LIBRARY)
        _declare(lib, "apgd_lanes", 6)
        lib.apgd_lanes_launch_mode.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.apgd_lanes_launch_mode.restype = ctypes.c_int
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


def _launch(lib, kernel: str, tensors, out, R: int, N: int, iters: int, at_tile, mode=None):
    """Launch `kernel` on CUDA tensors at the kernel's tile, or at `at_tile`
    = (E, P), in matvec mode `mode` where the kernel has modes; raise on a
    tile the kernel does not take or a failed launch."""
    ptrs = [t.data_ptr() for t in tensors] + [out.data_ptr()]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        if mode is not None:
            E, P = (0, 0) if at_tile is None else at_tile
            err = getattr(lib, f"{kernel}_launch_mode")(*ptrs, R, N, int(iters), mode, E, P, stream)
        elif at_tile is None:
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


def apgd_lanes(A, b, mu, active, x0, iters: int, mv_dtype: str = "float32"):
    """The contact solve: CUDA kernel for CUDA tensors, plain version for CPU
    tensors, in the matvec mode `mv_dtype`. Same arguments as
    `apgd_lanes_plain`."""
    _check_lanes(A, b, mu, active, x0, mv_dtype)
    if A.device.type == "cpu":
        return apgd_lanes_plain(A, b, mu, active, x0, iters, mv_dtype)
    out = _launch_lanes(A, b, mu, active, x0, iters, None, mv_dtype)
    apgd_lanes.launches += 1
    apgd_lanes.mode_launches[mv_dtype] += 1
    return out


def apgd_lanes_at_tile(A, b, mu, active, x0, iters: int, E: int, P: int, mv_dtype: str = "float32"):
    """Kernel 1 with E envs per block and P threads per contact, in place of
    the tile it picks for R; for tile sweeps. CUDA tensors only; not counted
    in `apgd_lanes.launches`."""
    _check_lanes(A, b, mu, active, x0, mv_dtype)
    return _launch_lanes(A, b, mu, active, x0, iters, (E, P), mv_dtype)


def _check_lanes(A, b, mu, active, x0, mv_dtype):
    _check_mode("apgd_lanes", mv_dtype)
    R, N = active.shape
    n = 3 * R
    _check("apgd_lanes", {"A": (A, (n, n, N)), "b": (b, (n, N)), "mu": (mu, (N,)),
                          "active": (active, (R, N)), "x0": (x0, (n, N))})


def _launch_lanes(A, b, mu, active, x0, iters, at_tile, mv_dtype):
    R, N = active.shape
    if A.device.type != "cuda":
        raise ValueError(f"apgd_lanes: no implementation for device {A.device}")
    lib = _library()
    if R > lib.apgd_lanes_max_rows():
        raise ValueError(f"apgd_lanes: R={R} rows, the kernel takes at most "
                         f"{lib.apgd_lanes_max_rows()} (n = 3R <= 128)")
    tensors = [t.contiguous() for t in (A, b, mu, active, x0)]
    return _launch(lib, "apgd_lanes", tensors, torch.empty_like(tensors[1]), R, N, iters, at_tile,
                   MV_MODES[mv_dtype])


apgd_lanes.launches = 0
apgd_lanes.mode_launches = dict.fromkeys(MV_MODES, 0)


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
