"""Engine types, static tables and the env-first batched step (counterpart
of `pbhc_tpu/sim/engine.py`).

`SimParams`, `SimState`, `EngineOptions` (`engine.py:71-148`),
`active_set_indices` (`:151`), the static per-robot tables with
`default_params`, `default_state` and `derived_state` (`:176-296`), and the
env-first batched step of the `solver: pallas` path: `_pre_contact`,
`substep_batched`, `_integrate`, `contact_forces_from_impulses` and
`control_step_batched` (`:657-889`), the heightfield ground (`set_terrain`,
`ground_height`, `:425-450`), which both engines' contact rows read, and the
per-env engine: `spd_inverse` (`:37`), `_solve_contacts` (`:501-655`, APGD
or sequential PGS with a warm start), `substep` and `control_step`
(`:807-861`), which the JAX package runs per env under `vmap` and the port
runs over the env batch with the same per-env semantics.

Tensors carry a leading env axis where the JAX code vmaps over envs. The
dynamics before the contact solve (FK, CRBA, RNEA, the SPD inverse, contact
Jacobians and pair rows) are the lanes engine's (`sim/engine_lanes.py`), which
computes the same quantities with the env axis last; `_pre_contact`
transposes them. From the Delassus matrix on, the step is env-first. In
`substep_batched`, as in `Engine.substep_batched`, the contact solve is
kernel 2; in `substep` it is the per-env solve, plain PyTorch, as it is XLA
code (not Pallas) in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbhc_tpu_torch.maths import rotations as rot
from pbhc_tpu_torch.model import kinematics as kin
from pbhc_tpu_torch.model.mjcf import RobotModel
from pbhc_tpu_torch.sim.contact_kernel import MV_MODES, apgd_envfirst

GRAVITY = 9.81


def spd_inverse(M: torch.Tensor) -> torch.Tensor:
    """Batched small-SPD inverse by unrolled Gauss-Jordan without pivoting
    (`engine.py:37`): n rank-1 updates of [M | I], each one batched op."""
    n = M.shape[-1]
    X = torch.cat([M, torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)], dim=-1)
    for j in range(n):
        row = X[..., j, :] / X[..., j, j][..., None]
        X = X - X[..., :, j][..., None] * row[..., None, :]
        X[..., j, :] = row
    return X[..., :, n:]


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
    """The engines' options (`engine.py:103-148`; see the JAX module for each
    one's rationale). `solver` (the per-env solve runs APGD for "apgd" and
    "pallas", else PGS, as in JAX), `relaxation` and `contact_reg` serve only
    the per-env solve; the env picks the engine from its own `solver` key.

    `contact_matvec_dtype` (float32, bfloat16 or float16) and
    `lanes_contact_kernel` (xla, pallas or auto) serve the lanes engine and
    are read as JAX reads them (`engine_lanes.py:583-624`): the position pass
    runs its matvec in the dtype, and so does the contact solve, except where
    JAX would send it to the Pallas kernel, which computes in float32 (N a
    multiple of 128 and the key `pallas`, or `auto` off the CPU). The solve
    is kernel 1 on a CUDA device either way, in the matching mode."""

    dt: float = 1.0 / 200.0
    solver: str = "apgd"
    solver_iters: int = 32
    baumgarte: float = 0.2
    contact_margin: float = 0.0
    penetration_slop: float = 0.002
    relaxation: float = 0.9
    max_depenetration_velocity: float = 1.0
    max_dof_vel: float = 100.0
    max_root_lin_vel: float = 50.0
    max_root_ang_vel: float = 50.0
    joint_limits: bool = True
    self_collision: bool = True
    pos_iters: int = 8
    contact_reg: float = 1e-3
    energy_projection: bool = True
    contact_cap: int = 0
    pair_cap: int = 4
    warm_start: bool = True
    contact_matvec_dtype: str = "float32"
    lanes_contact_kernel: str = "xla"

    def __post_init__(self):
        if self.contact_matvec_dtype not in MV_MODES:
            raise ValueError(f"contact_matvec_dtype={self.contact_matvec_dtype!r}: "
                             f"takes one of {', '.join(MV_MODES)}")


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
    """Static per-robot tables shared with `LanesEngine`, the env-first
    batched step and the per-env step (`engine.py:173`)."""

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
        # body of each impulse row of `contact_forces_from_impulses`: ground
        # rows, then each pair row on sphere i and (negated) on sphere j
        cb = self.contact_body
        self._force_body = torch.as_tensor(
            np.concatenate([cb, cb[self.pair_i], cb[self.pair_j]]), device=self.device)
        # the env-first contact solve: kernel 2's wrapper (launches the CUDA
        # kernel for CUDA tensors). `chip_smoke.py` swaps in the plain version
        # to hold a whole control step of the kernel against it.
        self.contact_solve = apgd_envfirst
        self._lanes = None

    # ------------------------------------------------------------ terrain
    def set_terrain(self, height_field, horizontal_scale):
        """Install a heightfield ground ([H,W] metres, float32 on the engine's
        device); the default is a flat plane (`engine.py:425`)."""
        self.terrain_hf = torch.as_tensor(np.asarray(height_field, dtype=np.float32), device=self.device)
        self.terrain_hscale = float(horizontal_scale)

    def ground_height(self, xy):
        """Ground height under world xy [..., 2] -> [...] (`engine.py:437`):
        bilinear in the cell under the point, the cell index clipped in
        float32 to [0, shape - 1.001] before `floor`, as JAX clips it, so
        that `i0 + 1` stays inside the field."""
        hf = self.terrain_hf
        if hf is None:
            return torch.zeros(xy.shape[:-1], device=xy.device)
        ij = xy / self.terrain_hscale
        i = torch.clamp(ij[..., 0], 0.0, hf.shape[0] - 1.001)
        j = torch.clamp(ij[..., 1], 0.0, hf.shape[1] - 1.001)
        i0, j0 = torch.floor(i).to(torch.int64), torch.floor(j).to(torch.int64)
        fi, fj = i - i0, j - j0
        return (hf[i0, j0] * (1 - fi) * (1 - fj) + hf[i0, j0 + 1] * (1 - fi) * fj
                + hf[i0 + 1, j0] * fi * (1 - fj) + hf[i0 + 1, j0 + 1] * fi * fj)

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

    # ------------------------------------------------------ env-first step
    def lanes(self):
        """The env-last engine over these tables, built at first use."""
        if self._lanes is None:
            from pbhc_tpu_torch.sim.engine_lanes import LanesEngine

            self._lanes = LanesEngine(self)
        return self._lanes

    def _pre_contact(self, params: SimParams, states: SimState, taus, paramsT=None):
        """`vmap(Engine._pre_contact)` (`engine.py:657-698`): dynamics up to the
        contact solve. Returns u_plus [N,nv], M_inv [N,nv,nv], J [N,KT,3,nv],
        phi [N,KT] and the pair-row contact frames C [N,P,3,3]. Pass `paramsT`
        (`LanesEngine.params_to_lanes(params)`) to skip the re-layout."""
        lanes = self.lanes()
        if paramsT is None:
            paramsT = lanes.params_to_lanes(params)
        u_plus, M_inv, Jf, phi, C = lanes._pre_contact(paramsT, lanes._to_lanes(states), taus.T)
        N = taus.shape[0]
        J = Jf.permute(2, 0, 1).reshape(N, self.KT, 3, self.nv)
        C = (torch.zeros((N, 0, 3, 3), device=self.device) if C is None
             else C.permute(3, 2, 0, 1))
        return u_plus.T, M_inv.permute(2, 0, 1), J, phi.T, C

    def _integrate(self, states: SimState, u_new, dpos):
        """Semi-implicit Euler + caps + hard joint limits (`engine.py:774`), on
        the lanes engine's formulas."""
        lanes = self.lanes()
        out = lanes._integrate(lanes._to_lanes(states), u_new.T, dpos.T)
        return dataclasses.replace(
            states, root_pos=out["rp"].T, root_quat=out["rq"].T, root_lin_vel=out["rv"].T,
            root_ang_vel=out["rw"].T, dof_pos=out["q"].T, dof_vel=out["qd"].T)

    def substep_batched(self, params: SimParams, states: SimState, taus, paramsT=None):
        """One physics step over the env batch with kernel 2 as the contact
        solve (`engine.py:700-772`). It starts the solve from zero on every
        substep (no warm start), as the JAX path does. Returns (states,
        impulses [N,KT,3] world frame)."""
        opt = self.opt
        N, nv, K = taus.shape[0], self.nv, self.K
        u_plus, M_inv, J, phi, C = self._pre_contact(params, states, taus, paramsT)
        idx = active_set_indices(opt, K, self.P, phi)                 # [N,R] | None
        if idx is not None:
            J = torch.gather(J, 1, idx[:, :, None, None].expand(-1, -1, 3, nv))
            phi = torch.gather(phi, 1, idx)
        R = J.shape[1]
        Jf = J.reshape(N, R * 3, nv)
        JfT = Jf.transpose(1, 2)
        # the Delassus matrix is a batched product outside the kernel, as in JAX
        A = (Jf @ M_inv @ JfT).contiguous()                            # [N,3R,3R]
        active = (phi < opt.contact_margin).to(torch.float32)         # [N,R]
        v0 = (Jf @ u_plus[..., None]).reshape(N, R, 3)
        rest = params.restitution
        rest = rest[:, None] if rest.ndim == 1 else rest
        b = v0.clone()
        b[..., 2] += rest * torch.clamp(v0[..., 2], max=0.0)
        b = b.reshape(N, R * 3)

        lam = self.contact_solve(A, b, params.friction, active, opt.solver_iters)   # [N,R,3]
        lamf = self._energy_safeguard(A, b, lam.reshape(N, R * 3))
        lam = lamf.reshape(N, R, 3)
        u_new = u_plus + (M_inv @ (JfT @ lamf[..., None]))[..., 0]

        dpos = self._position_pass(A, phi, active, M_inv, JfT)
        return self._integrate(states, u_new, dpos), self._to_world(lam, idx, C)

    def _position_pass(self, A, phi, active, M_inv, JfT):
        """Split-impulse position pass (`engine.py:630-647`, `:734-752`): a
        normal-only projected gradient on the Delassus operator, applied to
        positions only. Returns the generalized displacement [N,nv]."""
        opt = self.opt
        N, R = phi.shape
        b_err = -opt.baumgarte / opt.dt * torch.clamp(phi + opt.penetration_slop, max=0.0)
        b_err = torch.clamp(b_err, max=opt.max_depenetration_velocity)   # [N,R]
        act3 = torch.repeat_interleave(active, 3, dim=1)
        Lp = torch.amax(act3 * torch.sum(torch.abs(A) * act3[:, None, :], dim=2), dim=1)
        inv_Lp = (1.0 / torch.clamp(Lp, min=1e-6))[:, None]
        cp = torch.zeros((N, R, 3), device=A.device)
        cp[..., 2] = b_err * active
        cp = cp.reshape(N, R * 3)
        lam_p = torch.zeros_like(cp)
        for _ in range(opt.pos_iters):
            g = (A @ lam_p[..., None])[..., 0] - cp
            x3 = (lam_p - inv_Lp * g).reshape(N, R, 3)
            nxt = torch.zeros_like(x3)
            nxt[..., 2] = torch.clamp(x3[..., 2], min=0.0) * active
            lam_p = nxt.reshape(N, R * 3)
        return opt.dt * (M_inv @ (JfT @ lam_p[..., None]))[..., 0]

    def _to_world(self, lam, idx, C):
        """Solved rows [N,R,3] -> every row [N,KT,3], world frame: pruned rows
        scattered back (zeros elsewhere), pair rows rotated out of their
        contact frames (`engine.py:649-655`)."""
        K = self.K
        if idx is not None:
            lam = torch.zeros((lam.shape[0], self.KT, 3), device=lam.device).scatter_(
                1, idx[:, :, None].expand(-1, -1, 3), lam)
        if self.P:
            lam = torch.cat([lam[:, :K], torch.einsum("npab,npa->npb", C, lam[:, K:])], dim=1)
        return lam

    @staticmethod
    def _energy_safeguard(A, b, lam):
        """Rescale lam [N,R3] by t in [0, 1] so that the QP objective, the
        post-impulse kinetic-energy change, is not positive (`engine.py:593-602`)."""
        lAl = torch.sum(lam * (A @ lam[..., None])[..., 0], dim=-1)
        t = torch.clamp(-torch.sum(b * lam, dim=-1) / torch.clamp(lAl, min=1e-12), 0.0, 1.0)
        return lam * torch.where(lAl > 1e-12, t, 1.0)[:, None]

    # --------------------------------------------------------- per-env step
    def _solve_contacts(self, params: SimParams, M_inv, J, phi, u_plus, C, lam_warm=None):
        """The per-env contact solve (`engine.py:501-655`) over the env batch:
        u_plus [N,nv], M_inv [N,nv,nv], J [N,KT,3,nv], phi [N,KT], C [N,P,3,3],
        lam_warm [N,KT,3] world frame (None: from zero). The `contact_cap`
        active set is gathered (and the warm start with it), the Delassus
        matrix regularised by `contact_reg`, and the impulses found by APGD
        (from the projected warm start, theta from 1, Lipschitz bound over
        active rows, then the energy safeguard) or by sequential projected
        Gauss-Seidel over rows with 3x3 block inverses. Returns (u_new [N,nv],
        impulses [N,KT,3] world frame, position correction [N,nv])."""
        opt, K, nv = self.opt, self.K, self.nv
        N = u_plus.shape[0]
        if lam_warm is None:
            lam_cf = torch.zeros((N, self.KT, 3), device=u_plus.device)
        elif self.P:   # pair rows: world -> contact frame
            lam_cf = torch.cat([lam_warm[:, :K], torch.einsum("npab,npb->npa", C, lam_warm[:, K:])], dim=1)
        else:
            lam_cf = lam_warm
        idx = active_set_indices(opt, K, self.P, phi)                 # [N,R] | None
        if idx is not None:
            J = torch.gather(J, 1, idx[:, :, None, None].expand(-1, -1, 3, nv))
            phi = torch.gather(phi, 1, idx)
            lam_cf = torch.gather(lam_cf, 1, idx[:, :, None].expand(-1, -1, 3))
        R = J.shape[1]
        Jf = J.reshape(N, R * 3, nv)
        JfT = Jf.transpose(1, 2)
        A = Jf @ M_inv @ JfT                                           # [N,3R,3R]
        A = A + torch.diag_embed(opt.contact_reg * torch.diagonal(A, dim1=1, dim2=2) + 1e-8)
        active = (phi < opt.contact_margin).to(torch.float32)         # [N,R]
        v0 = (Jf @ u_plus[..., None]).reshape(N, R, 3)
        b = v0.clone()
        b[..., 2] += params.restitution[:, None] * torch.clamp(v0[..., 2], max=0.0)
        mu = params.friction[:, None]

        def project(lam):                                              # [N,R,3]
            ln = torch.clamp(lam[..., 2], min=0.0)
            tn = torch.sqrt(lam[..., 0] ** 2 + lam[..., 1] ** 2)
            scale = torch.clamp(mu * ln / torch.clamp(tn, min=1e-9), max=1.0)
            return torch.stack([lam[..., 0] * scale, lam[..., 1] * scale, ln], dim=-1) * active[..., None]

        bf = b.reshape(N, R * 3)
        if opt.solver in ("apgd", "pallas"):      # "pallas" falls back here, as `engine.py:566`
            act3 = torch.repeat_interleave(active, 3, dim=1)
            L = torch.amax(act3 * torch.sum(torch.abs(A) * act3[:, None, :], dim=2), dim=1)
            inv_L = (1.0 / torch.clamp(L, min=1e-6))[:, None]
            x = x_prev = project(lam_cf).reshape(N, R * 3)
            theta = torch.ones((), device=A.device)
            for _ in range(opt.solver_iters):
                theta_new = 0.5 * (torch.sqrt(theta ** 4 + 4 * theta ** 2) - theta ** 2)
                beta = theta * (1.0 - theta) / (theta ** 2 + theta_new)
                y = x + beta * (x - x_prev)
                g = (A @ y[..., None])[..., 0] + bf
                x_prev, x, theta = x, project((y - inv_L * g).reshape(N, R, 3)).reshape(N, R * 3), theta_new
            lam = self._energy_safeguard(A, bf, x).reshape(N, R, 3)
        else:    # "pgs", and any other value, as in JAX (an engine built for "lanes" solves per env by PGS)
            blocks = A.reshape(N, R, 3, R, 3)
            rows = torch.arange(R, device=A.device)
            D = blocks[:, rows, :, rows, :].transpose(0, 1)            # [N,R,3,3]
            eye = torch.eye(3, device=A.device)
            reg = opt.contact_reg * torch.clamp(D[..., 2, 2], min=1e-6)[..., None, None] * eye
            D_inv = torch.linalg.inv(D + reg + 1e-6 * eye)
            lam = project(lam_cf)
            for _ in range(opt.solver_iters):
                for k in range(R):      # sequential over rows, each seeing the rows before it
                    r = (blocks[:, k].reshape(N, 3, R * 3) @ lam.reshape(N, R * 3, 1))[..., 0] + b[:, k]
                    step = lam[:, k] - opt.relaxation * (D_inv[:, k] @ r[..., None])[..., 0]
                    ln = torch.clamp(step[:, 2], min=0.0)
                    tn = torch.sqrt(step[:, 0] ** 2 + step[:, 1] ** 2)
                    scale = torch.clamp(mu[:, 0] * ln / torch.clamp(tn, min=1e-9), max=1.0)
                    lam[:, k] = torch.stack([step[:, 0] * scale, step[:, 1] * scale, ln], dim=-1) \
                        * active[:, k, None]
        u_new = u_plus + (M_inv @ (JfT @ lam.reshape(N, R * 3, 1)))[..., 0]
        dpos = self._position_pass(A, phi, active, M_inv, JfT)
        return u_new, self._to_world(lam, idx, C), dpos

    def substep(self, params: SimParams, states: SimState, taus, lam_warm=None, paramsT=None):
        """One physics step of every env with the per-env solve (`engine.py:807`):
        dynamics, `_solve_contacts` (warm-started from `lam_warm` when
        `opt.warm_start`), integration. Returns (states, impulses [N,KT,3]
        world frame)."""
        u_plus, M_inv, J, phi, C = self._pre_contact(params, states, taus, paramsT)
        u_new, lam, dpos = self._solve_contacts(params, M_inv, J, phi, u_plus, C,
                                                lam_warm if self.opt.warm_start else None)
        return self._integrate(states, u_new, dpos), lam

    def control_step(self, params: SimParams, states: SimState, torque_fn, decimation: int,
                     pre_substep_fn=None, paramsT=None):
        """`decimation` x (`pre_substep_fn`, torques, `substep`), the impulses
        carried from substep to substep as the next warm start, then the
        derived caches and the mean contact forces (`engine.py:833-861`).
        torque_fn(states) -> [N,nd]; pre_substep_fn(states) -> states.
        Returns (states, the last substep's torques)."""
        lam = torch.zeros((states.root_pos.shape[0], self.KT, 3), device=self.device)
        lam_acc, tau = torch.zeros_like(lam), None
        for _ in range(decimation):
            if pre_substep_fn is not None:
                states = pre_substep_fn(states)
            tau = torque_fn(states)
            states, lam = self.substep(params, states, tau, lam, paramsT)
            lam_acc = lam_acc + lam
        cf = self.contact_forces_from_impulses(lam_acc, decimation)
        return self.derived_state(params, states, contact_forces=cf), tau

    def contact_forces_from_impulses(self, lam, decimation: int = 1):
        """Impulses [N,KT,3] summed over `decimation` substeps -> mean per-body
        world forces [N,B,3] (`engine.py:824-831`, `:880-885`)."""
        f = lam / (self.opt.dt * decimation)
        rows = torch.cat([f[:, :self.K], f[:, self.K:], -f[:, self.K:]], dim=1)
        cf = torch.zeros((lam.shape[0], self.nb, 3), device=lam.device)
        return cf.index_add_(1, self._force_body, rows)

    def control_step_batched(self, params: SimParams, states: SimState, torque_fn,
                             decimation: int, paramsT=None):
        """`decimation` x (torques -> `substep_batched`), then the derived caches
        and the mean contact forces (`engine.py:863-889`). torque_fn(states)
        -> [N,nd]. Returns (states, the last substep's torques)."""
        lam_acc, tau = None, None
        for _ in range(decimation):
            tau = torque_fn(states)
            states, lam = self.substep_batched(params, states, tau, paramsT)
            lam_acc = lam if lam_acc is None else lam_acc + lam
        cf = self.contact_forces_from_impulses(lam_acc, decimation)
        return self.derived_state(params, states, contact_forces=cf), tau
