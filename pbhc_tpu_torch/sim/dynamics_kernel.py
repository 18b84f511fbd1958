"""Kernel 3: the lanes engine's rigid-body dynamics, one CUDA launch a substep.

`lanes_dynamics` computes what `LanesEngine._pre_contact_plain` computes
(FK, the spatial inertias, the CRBA mass matrix, the RNEA bias forces, the
branch-sparse SPD inverse, the passive torques, u_plus with the energy
projection, the contact Jacobian, the sphere centres and the self-collision
pair rows) in one launch of `csrc/lanes_dynamics.cu`; the ground rows' gap
stays in PyTorch (`LanesEngine._ground_height`: a flat plane or the bilinear
heightfield), from the sphere centres the kernel hands back.
`lanes_body_state` computes `LanesEngine._body_state_plain` (FK, the body
twists, the quaternions) for `derived_state_lanes`, from the same file.

It replaces no TPU kernel: the JAX package leaves this chain to XLA's fusion.
Design and bound are in the `.cu` file. The kernel adapts to the model by
shape: the tables `LanesEngine.__init__` builds are packed once per engine
(`ModelTables`), and sizes, levels and dof groups are read at run time, up to
`CAPS`; beyond a cap the launch raises.

Each wrapper launches its kernel for CUDA tensors and runs the plain PyTorch
version for CPU tensors; there is no fallback between the two.
`<wrapper>.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from pbhc_tpu_torch.model.kinematics import _level_order
from pbhc_tpu_torch.sim.contact_kernel import _check
from pbhc_tpu_torch.utils import nvcc

LIBRARY = nvcc.CudaLibrary("lanes_dynamics", ("lanes_dynamics.cu",))
LIBRARIES = (LIBRARY,)
# the kernel's caps (csrc/lanes_dynamics.cu, `lanes_dynamics_caps` reads them
# back): the G1 models take nb 30, nd 29, K 21, P 17, 11 levels, 3 groups
CAPS = {"bodies": 40, "dofs": 42, "contacts": 32, "pairs": 32, "levels": 16, "groups": 8}
DIMS = ("nb", "nd", "nv", "K", "P", "levels", "groups", "max_group")
INT_TABLES = ("parent", "level_start", "level_body", "child_start", "child", "body_dof", "dof_body", "dof_anc",
              "group_start", "dof_group", "contact_body", "contact_anc", "pair_i", "pair_j")
FLOAT_TABLES = ("R_local", "local_pos", "axis", "contact_pos", "pair_rsum")
INPUTS = ("q", "qd", "rq", "rp", "rv", "rw", "tau", "mass", "com", "inertia", "armature", "damping", "frictionloss")
OUTPUTS = ("u_plus", "M_inv", "Jf", "x", "phi_p", "C")
BODY_INPUTS = ("q", "qd", "rq", "rp", "rv", "rw")
BODY_OUTPUTS = ("pos", "quat", "lin_vel", "ang_vel")
_lib = None


def _struct(name, fields):
    return type(name, (ctypes.Structure,), {"_fields_": fields})


# ctypes mirrors of the C structs (same field order)
Model = _struct("Model", [(n, ctypes.c_int) for n in DIMS]
                + [(n, ctypes.c_void_p) for n in INT_TABLES + FLOAT_TABLES])
Inputs = _struct("Inputs", [(n, ctypes.c_void_p) for n in INPUTS])
Outputs = _struct("Outputs", [(n, ctypes.c_void_p) for n in OUTPUTS])
BodyInputs = _struct("BodyInputs", [(n, ctypes.c_void_p) for n in BODY_INPUTS])
BodyOutputs = _struct("BodyOutputs", [(n, ctypes.c_void_p) for n in BODY_OUTPUTS])


def check_caps(dims: dict):
    """Raise unless the model's sizes are within the kernel's `CAPS`."""
    have = {"bodies": dims["nb"], "dofs": dims["nd"], "contacts": dims["K"], "pairs": dims["P"],
            "levels": dims["levels"], "groups": dims["groups"]}
    for name, n in have.items():
        if n > CAPS[name]:
            raise ValueError(f"lanes_dynamics: the model has {n} {name}, the kernel takes at most {CAPS[name]}")


class ModelTables:
    """The tables of a `LanesEngine` the kernels read, packed once into one
    int32 and one float32 tensor on the engine's device; `table(name)` is a
    table's slice, `dims` the sizes, `model()` the C struct of pointers."""

    def __init__(self, lanes):
        eng, model = lanes.e, lanes.e.model
        nb, nd = lanes.nb, lanes.nd
        parent = np.asarray(model.parent[:nb], dtype=np.int64)
        order, _, _ = _level_order(model)
        sizes = [1] + [len(lv) for lv in model.levels]
        children = [[c for c in range(nb) if parent[c] == b] for b in range(nb)]
        body_dof = np.asarray(eng.joint_slot, dtype=np.int64)
        body_dof = np.where(body_dof == nd, -1, body_dof)
        groups = lanes._dof_groups
        dof_group = np.zeros(nd, dtype=np.int64)
        for g, (a, b) in enumerate(groups):
            dof_group[a:b] = g
        ints = {
            "parent": parent,
            "level_start": np.cumsum([0] + sizes),
            "level_body": order,
            "child_start": np.cumsum([0] + [len(c) for c in children]),
            "child": np.asarray([c for cs in children for c in cs], dtype=np.int64),
            "body_dof": body_dof,
            "dof_body": np.asarray(model.dof_body, dtype=np.int64),
            "dof_anc": np.asarray(eng.dof_anc_np > 0, dtype=np.int64).reshape(-1),
            "group_start": np.asarray([a for a, _ in groups] + [groups[-1][1]]),
            "dof_group": dof_group,
            "contact_body": eng.contact_body,
            "contact_anc": (eng.contact_anc.cpu().numpy() > 0).astype(np.int64).reshape(-1),
            "pair_i": eng.pair_i,
            "pair_j": eng.pair_j,
        }
        floats = {
            "R_local": lanes._R_local.permute(2, 0, 1).reshape(nb, 9).cpu().numpy(),
            "local_pos": lanes._local_pos.T.cpu().numpy(),
            "axis": lanes._axis.T.cpu().numpy(),
            "contact_pos": lanes._contact_pos.T.cpu().numpy(),
            "pair_rsum": eng.pair_rsum.cpu().numpy() if lanes.P else np.zeros(0),
        }
        self.dims = {"nb": nb, "nd": nd, "nv": lanes.nv, "K": lanes.K, "P": lanes.P, "levels": len(sizes),
                     "groups": len(groups), "max_group": max(b - a for a, b in groups)}
        self.ints, self._int_at = _pack(ints, torch.int32, lanes.device)
        self.floats, self._float_at = _pack(floats, torch.float32, lanes.device)
        self._model = None

    def table(self, name: str) -> torch.Tensor:
        packed, at = (self.ints, self._int_at) if name in self._int_at else (self.floats, self._float_at)
        a, b = at[name]
        return packed[a:b]

    def model(self):
        if self._model is None:
            ptr = lambda packed, at, name: packed.data_ptr() + packed.element_size() * at[name][0]
            self._model = Model(*(self.dims[n] for n in DIMS),
                                *(ptr(self.ints, self._int_at, n) for n in INT_TABLES),
                                *(ptr(self.floats, self._float_at, n) for n in FLOAT_TABLES))
        return self._model


def _pack(tables: dict, dtype, device):
    """One flat tensor holding `tables` in order, and {name: (start, end)}."""
    at, flat, n = {}, [], 0
    for name, x in tables.items():
        x = np.asarray(x).reshape(-1)
        at[name] = (n, n + x.size)
        flat.append(x)
        n += x.size
    return torch.as_tensor(np.concatenate(flat)).to(dtype=dtype, device=device), at


def declare(lib):
    """The C signatures of the library's exports."""
    lib.lanes_dynamics_launch.argtypes = [Model, Inputs, Outputs, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p]
    lib.lanes_body_state_launch.argtypes = [Model, BodyInputs, BodyOutputs, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p]
    lib.lanes_dynamics_envs.argtypes = [Model, ctypes.c_int]
    lib.lanes_dynamics_caps.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.lanes_dynamics_caps.restype = None
    for fn in ("lanes_dynamics_launch", "lanes_body_state_launch", "lanes_dynamics_envs"):
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = declare(nvcc.load(LIBRARY))
    return _lib


def caps(lib=None) -> dict:
    """The caps the built kernel holds, by `CAPS`'s names."""
    out = (ctypes.c_int * len(CAPS))()
    (lib or _library()).lanes_dynamics_caps(out)
    return dict(zip(CAPS, out))


def envs(tables: ModelTables, body: bool = False, lib=None) -> int:
    """The envs a block of the dynamics (or body-state) kernel takes."""
    return (lib or _library()).lanes_dynamics_envs(tables.model(), int(body))


def _call(lib, fn: str, kernel: str, args, device, *tail):
    """Call the launch function `fn` on the current stream of `device` (a
    CUDA device; another device passes no stream, for a host build of the
    kernels); raise on -1 or a CUDA error."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            err = getattr(lib, fn)(*args, *tail, torch.cuda.current_stream(device).cuda_stream)
    else:
        err = getattr(lib, fn)(*args, *tail, None)
    if err == -1:
        raise ValueError(f"{kernel}: the kernel does not take this model, N or tile")
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error {err}")


def launch_dynamics(lib, tables: ModelTables, paramsT, stateT, tauT, dt: float, energy: bool, E: int = 0):
    """Launch the dynamics kernel of `lib` on the inputs' device; returns
    u_plus [nv,N], M_inv [nv,nv,N], Jf [KT*3,nv,N], x [3,K,N], phi_p [P,N],
    C [3,3,P,N]. E: envs a block (0: the kernel's choice)."""
    d = tables.dims
    check_caps(d)
    nb, nd, nv, K, P = d["nb"], d["nd"], d["nv"], d["K"], d["P"]
    N = tauT.shape[-1]
    ins = {"q": (stateT["q"], (nd, N)), "qd": (stateT["qd"], (nd, N)), "rq": (stateT["rq"], (4, N)),
           "rp": (stateT["rp"], (3, N)), "rv": (stateT["rv"], (3, N)), "rw": (stateT["rw"], (3, N)),
           "tau": (tauT, (nd, N)), "mass": (paramsT["mass"], (nb, N)), "com": (paramsT["com"], (3, nb, N)),
           "inertia": (paramsT["inertia"], (3, 3, nb, N)), "armature": (paramsT["armature"], (nd, N)),
           "damping": (paramsT["dof_damping"], (nd, N)), "frictionloss": (paramsT["dof_frictionloss"], (nd, N))}
    _check("lanes_dynamics", ins)
    dev = tauT.device
    if tables.ints.device != dev:
        raise ValueError(f"lanes_dynamics: the model's tables are on {tables.ints.device}, the inputs on {dev}")
    held = [ins[n][0].contiguous() for n in INPUTS]
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    outs = [empty(nv, N), empty(nv, nv, N), empty(3 * (K + P), nv, N), empty(3, K, N), empty(P, N),
            empty(3, 3, P, N)]
    args = (tables.model(), Inputs(*(t.data_ptr() for t in held)), Outputs(*(t.data_ptr() for t in outs)))
    _call(lib, "lanes_dynamics_launch", "lanes_dynamics", args, dev, N, float(dt), int(bool(energy)), int(E))
    return tuple(outs)


def launch_body_state(lib, tables: ModelTables, stateT, E: int = 0):
    """Launch the body-state kernel of `lib`; returns body_pos, body_quat,
    body_lin_vel, body_ang_vel env-first ([N,B,3], [N,B,4], [N,B,3], [N,B,3])."""
    d = tables.dims
    check_caps(d)
    nb, nd = d["nb"], d["nd"]
    N = stateT["q"].shape[-1]
    ins = {"q": (stateT["q"], (nd, N)), "qd": (stateT["qd"], (nd, N)), "rq": (stateT["rq"], (4, N)),
           "rp": (stateT["rp"], (3, N)), "rv": (stateT["rv"], (3, N)), "rw": (stateT["rw"], (3, N))}
    _check("lanes_body_state", ins)
    dev = stateT["q"].device
    if tables.ints.device != dev:
        raise ValueError(f"lanes_body_state: the model's tables are on {tables.ints.device}, the inputs on {dev}")
    held = [ins[n][0].contiguous() for n in BODY_INPUTS]
    outs = [torch.empty((N, nb, c), dtype=torch.float32, device=dev) for c in (3, 4, 3, 3)]
    args = (tables.model(), BodyInputs(*(t.data_ptr() for t in held)), BodyOutputs(*(t.data_ptr() for t in outs)))
    _call(lib, "lanes_body_state_launch", "lanes_body_state", args, dev, N, int(E))
    return tuple(outs)


def lanes_dynamics(lanes, paramsT, stateT, tauT):
    """The dynamics up to the contact solve of `LanesEngine._pre_contact`:
    kernel 3 for CUDA tensors, `lanes._pre_contact_plain` for CPU tensors.
    Returns u_plus, M_inv, Jf, phi [KT,N] and C (None without pairs)."""
    dev = tauT.device
    if dev.type == "cpu":
        return lanes._pre_contact_plain(paramsT, stateT, tauT)
    if dev.type != "cuda":
        raise ValueError(f"lanes_dynamics: no implementation for device {dev}")
    outs = launch_dynamics(_library(), lanes.tables, paramsT, stateT, tauT, lanes.opt.dt,
                           lanes.opt.energy_projection)
    lanes_dynamics.launches += 1
    return finish(lanes, *outs)


def finish(lanes, u_plus, M_inv, Jf, x, phi_p, C):
    """`_pre_contact`'s outputs from the kernel's: the ground rows' gap
    x_z - radius - ground height under x (the engine's flat plane or
    heightfield) before the pair rows' gaps; C None without pairs."""
    phi = x[2] - lanes._contact_radius - lanes._ground_height(x[:2])
    if not lanes.P:
        return u_plus, M_inv, Jf, phi, None
    return u_plus, M_inv, Jf, torch.cat([phi, phi_p], dim=0), C


def lanes_body_state(lanes, stT):
    """The body caches of `LanesEngine.derived_state_lanes`: the body-state
    kernel for CUDA tensors, `lanes._body_state_plain` for CPU tensors.
    Returns body_pos, body_quat, body_lin_vel, body_ang_vel, env-first."""
    dev = stT["q"].device
    if dev.type == "cpu":
        return lanes._body_state_plain(stT)
    if dev.type != "cuda":
        raise ValueError(f"lanes_body_state: no implementation for device {dev}")
    out = launch_body_state(_library(), lanes.tables, stT)
    lanes_body_state.launches += 1
    return out


lanes_dynamics.launches = 0
lanes_body_state.launches = 0
