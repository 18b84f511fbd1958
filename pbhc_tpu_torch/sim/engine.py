"""Engine types and static tables (counterpart of `pbhc_tpu/sim/engine.py`).

This slice ports what `LanesEngine` reads from an `Engine`: `SimParams`,
`SimState`, `EngineOptions` (`engine.py:71-148`), `active_set_indices`
(`:151`) and the static per-robot tables plus `default_params`,
`default_state` and `derived_state` (`:176-296`). The env-first solve paths
(`substep`, `control_step`, `substep_batched`, heightfield ground) are ROADMAP
queue 1 item 10 and raise here.

Tensors carry a leading env axis where the JAX code vmaps over envs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbhc_tpu_torch.maths import rotations as rot
from pbhc_tpu_torch.model import kinematics as kin
from pbhc_tpu_torch.model.mjcf import RobotModel

GRAVITY = 9.81


@dataclasses.dataclass
class SimParams:
    """Per-env physical parameters (leading env axis when batched)."""

    mass: torch.Tensor          # [B]
    com: torch.Tensor           # [B,3] body frame
    inertia: torch.Tensor       # [B,3,3] body frame about com
    friction: torch.Tensor      # []
    restitution: torch.Tensor   # []
    armature: torch.Tensor      # [nd]
    dof_damping: torch.Tensor   # [nd]
    dof_frictionloss: torch.Tensor  # [nd]


@dataclasses.dataclass
class SimState:
    """Dynamic state (leading env axis when batched)."""

    root_pos: torch.Tensor      # [3]
    root_quat: torch.Tensor     # [4] xyzw
    root_lin_vel: torch.Tensor  # [3] world
    root_ang_vel: torch.Tensor  # [3] world
    dof_pos: torch.Tensor       # [nd]
    dof_vel: torch.Tensor       # [nd]
    body_pos: torch.Tensor      # [B,3]
    body_quat: torch.Tensor     # [B,4]
    body_lin_vel: torch.Tensor  # [B,3]
    body_ang_vel: torch.Tensor  # [B,3]
    contact_forces: torch.Tensor  # [B,3]


def tree_map(fn, obj):
    """Apply `fn` to every tensor field of a SimParams/SimState."""
    return dataclasses.replace(obj, **{f.name: fn(getattr(obj, f.name))
                                       for f in dataclasses.fields(obj)})


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """The options the lanes engine reads (`engine.py:103-148`; see the JAX
    module for each one's rationale). `solver`, `relaxation` and
    `contact_reg` serve only the env-first solvers and come with them.

    There is no `lanes_contact_kernel`: in the JAX package that key picks the
    Pallas kernel or the XLA scan, two implementations of one function (and
    its default differs between `tracking_env.py:130` and `engine.py:148`).
    The port has one implementation per device, the CUDA kernel for CUDA
    tensors and its plain version for CPU tensors, so it accepts every value
    of the key in a run config and reads none."""

    dt: float = 1.0 / 200.0
    solver_iters: int = 32
    baumgarte: float = 0.2
    contact_margin: float = 0.0
    penetration_slop: float = 0.002
    max_depenetration_velocity: float = 1.0
    max_dof_vel: float = 100.0
    max_root_lin_vel: float = 50.0
    max_root_ang_vel: float = 50.0
    joint_limits: bool = True
    self_collision: bool = True
    pos_iters: int = 8
    energy_projection: bool = True
    contact_cap: int = 0
    pair_cap: int = 4
    warm_start: bool = True
    contact_matvec_dtype: str = "float32"


def active_set_indices(opt: EngineOptions, K: int, P: int, phi: torch.Tensor):
    """Class-budgeted active-set rows along the LAST axis of phi [..., K+P]
    (`engine.py:151`): the `contact_cap` deepest ground rows then the
    `pair_cap` deepest pair rows, each in ascending gap order. A stable sort
    breaks ties by the lower index, as `lax.top_k` does. None = no pruning."""
    cap, KT = opt.contact_cap, K + P

    def deepest(x, k):
        return torch.sort(x, dim=-1, stable=True).indices[..., :k]

    if not 0 < cap < KT:
        return None
    if P and opt.pair_cap > 0:
        cg, cp = min(cap, K), min(opt.pair_cap, P)
        if cg + cp >= KT:
            return None
        return torch.cat([deepest(phi[..., :K], cg), deepest(phi[..., K:], cp) + K], dim=-1)
    return deepest(phi, cap)


class Engine:
    """Static per-robot tables shared with `LanesEngine` (`engine.py:173`)."""

    def __init__(self, model: RobotModel, options: EngineOptions = EngineOptions(),
                 device="cuda"):
        if model.num_bodies != model.num_real_bodies:
            raise ValueError("pass the non-extended model")
        self.model = model
        self.opt = options
        self.device = torch.device(device)
        nb, nd = model.num_real_bodies, model.num_dof
        self.nb, self.nd, self.nv = nb, nd, 6 + nd
        t = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), dtype=dt, device=self.device)

        parent = model.parent[:nb]
        anc_body_dof = np.zeros((nb, nd), dtype=np.float32)
        for b in range(nb):
            x = b
            while x != -1:
                if model.body_dof[x] >= 0:
                    anc_body_dof[b, model.body_dof[x]] = 1.0
                x = parent[x]
        self.anc_body_dof_np = anc_body_dof
        self.dof_anc_np = anc_body_dof[np.asarray(model.dof_body), :].T   # [nd,nd]
        self.contact_anc = t(anc_body_dof[np.asarray(model.contact_body), :])  # [K,nd]
        self.contact_body = np.asarray(model.contact_body, dtype=np.int64)
        self.contact_pos = t(model.contact_pos)
        self.contact_radius = t(model.contact_radius)
        self.K = len(model.contact_body)

        pairs = np.asarray(getattr(model, "contact_pairs", np.zeros((0, 2))), dtype=np.int64)
        if not options.self_collision:
            pairs = pairs[:0]
        self.pair_i, self.pair_j = pairs[:, 0], pairs[:, 1]
        self.P = len(pairs)
        self.KT = self.K + self.P
        if self.P:
            self.pair_rsum = self.contact_radius[self.pair_i] + self.contact_radius[self.pair_j]

        sub = np.zeros((nb, nb), dtype=np.float32)
        for c in range(nb):
            x = c
            while x != -1:
                sub[x, c] = 1.0
                x = parent[x]
        self.subtree = t(sub)
        self.terrain_hf = None

        self.dof_limits = t(model.dof_limits)
        joint_slot = np.full(nb, nd, dtype=np.int64)
        joint_slot[np.asarray(model.dof_body)] = np.arange(nd)
        self.joint_slot = joint_slot

    def default_params(self) -> SimParams:
        m, t = self.model, lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self.device)
        return SimParams(
            mass=t(m.mass[: self.nb]), com=t(m.com[: self.nb]), inertia=t(m.inertia[: self.nb]),
            friction=t(1.0), restitution=t(0.0), armature=t(m.dof_armature),
            dof_damping=t(m.dof_damping), dof_frictionloss=t(m.dof_frictionloss))

    def default_state(self, root_pos=(0.0, 0.0, 0.8)) -> SimState:
        nb, nd, dev = self.nb, self.nd, self.device
        z = lambda *s: torch.zeros(s, device=dev)
        ident = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
        return SimState(
            root_pos=torch.tensor(root_pos, dtype=torch.float32, device=dev), root_quat=ident.clone(),
            root_lin_vel=z(3), root_ang_vel=z(3), dof_pos=z(nd), dof_vel=z(nd),
            body_pos=z(nb, 3), body_quat=ident.repeat(nb, 1), body_lin_vel=z(nb, 3),
            body_ang_vel=z(nb, 3), contact_forces=z(nb, 3))

    def derived_state(self, params: SimParams, state: SimState, contact_forces=None) -> SimState:
        """Refresh body pose/velocity caches from generalized state (`engine.py:280`).
        Works on any leading batch dims."""
        R_joint = kin.joint_rotations_from_dof(self.model, state.dof_pos)
        p_w, R_w = kin._fk_levels(self.model, rot.quat_to_matrix(state.root_quat),
                                  state.root_pos, R_joint)
        v, w = kin.fk_velocities(self.model, p_w, R_w, state.root_lin_vel,
                                 state.root_ang_vel, state.dof_vel)
        return dataclasses.replace(
            state, body_pos=p_w, body_quat=rot.matrix_to_quat(R_w), body_lin_vel=v,
            body_ang_vel=w,
            contact_forces=state.contact_forces if contact_forces is None else contact_forces)
