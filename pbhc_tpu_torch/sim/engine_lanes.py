"""Env-in-lanes dynamics in torch (counterpart of `pbhc_tpu/sim/engine_lanes.py`).

The physics substep with the ENV axis LAST, as in the JAX module: on the GPU
every elementwise op then reads consecutive addresses across envs, and the
Delassus matrix comes out in the `[3R,3R,N]` layout the contact kernel reads.
The formulas follow `engine_lanes.py` line by line: FK, CRBA mass matrix and
RNEA bias in root-anchored world-axis spatial coordinates (f32 relies on that
anchoring), a branch-sparse Cholesky SPD inverse, contact Jacobians with
class-budgeted active-set rows, the APGD contact solve (kernel 1,
`sim/contact_kernel.py`), the energy safeguard, the split-impulse position
pass and semi-implicit Euler. `contact_matvec_dtype` and
`lanes_contact_kernel` are read as JAX reads them (`engine_lanes.py:583-624`;
see `EngineOptions`).

Two deliberate differences in form, not in value: small products the JAX
module scalarises for TPU tiles are written as broadcast tensor ops, and the
active-set rows are picked with a gather instead of a one-hot contraction
(the same rows, exactly).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbhc_tpu_torch.maths import rotations as rot
from pbhc_tpu_torch.model.kinematics import _level_order
from pbhc_tpu_torch.sim.contact_kernel import apgd_lanes, matvec_plain, round_to
from pbhc_tpu_torch.sim.engine import GRAVITY, Engine, SimParams, SimState, active_set_indices


# --------------------------------------------------------------------- helpers
# component-LEADING arrays ([3,...,N], [3,3,...,N], [4,N]); `engine_lanes.py:34-99`

def _mm33(A, B):
    """[3,3,...] @ [3,3,...] with broadcasting over trailing dims."""
    return sum(A[:, k].unsqueeze(1) * B[k].unsqueeze(0) for k in range(3))


def _mm33_t(A, B):
    """A @ B^T on [3,3,...]."""
    return sum(A[:, k].unsqueeze(1) * B[:, k].unsqueeze(0) for k in range(3))


def _mv3(A, v):
    """[3,3,...] @ [3,...]."""
    return sum(A[:, k] * v[k].unsqueeze(0) for k in range(3))


def _cross3(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _quat_to_matrix_lanes(q):
    """q [4,...] xyzw -> R [3,3,...]."""
    return torch.movedim(rot.quat_to_matrix(torch.movedim(q, 0, -1)), (-2, -1), (0, 1))


def _quat_integrate_lanes(q, omega, dt):
    """Lanes twin of rotations.quat_integrate (`engine_lanes.py:79`)."""
    e = omega * dt
    angle = torch.sqrt(e[0] ** 2 + e[1] ** 2 + e[2] ** 2)
    half = 0.5 * angle
    k = torch.where(angle < 1e-4, 0.5 - angle * angle / 48.0,
                    torch.sin(half) / torch.clamp(angle, min=1e-8))
    dx, dy, dz, dw = e[0] * k, e[1] * k, e[2] * k, torch.cos(half)
    x2, y2, z2, w2 = q[0], q[1], q[2], q[3]
    out = torch.stack([
        dw * x2 + dx * w2 + dy * z2 - dz * y2,
        dw * y2 - dx * z2 + dy * w2 + dz * x2,
        dw * z2 + dx * y2 - dy * x2 + dz * w2,
        dw * w2 - dx * x2 - dy * y2 - dz * z2,
    ])
    return out / torch.sqrt(torch.sum(out * out, dim=0, keepdim=True))


def _spd_inverse_lanes(M):
    """Cholesky SPD inverse on [n,n,N] (`engine_lanes.py:98`): M = L Lᵀ with
    the pivot clamped at 1e-12, Li = L⁻¹ by forward substitution, M⁻¹ = Liᵀ Li.
    Column- and row-vectorised instead of scalarised."""
    n = M.shape[0]
    L = torch.zeros_like(M)
    inv_d = torch.empty_like(M[0])                             # [n,N]
    for j in range(n):
        Lj = L[j, :j]                                          # [j,N]
        d = torch.sqrt(torch.clamp(M[j, j] - torch.sum(Lj * Lj, dim=0), min=1e-12))
        L[j, j] = d
        inv_d[j] = 1.0 / d
        if j + 1 < n:
            L[j + 1:, j] = (M[j + 1:, j] - torch.sum(L[j + 1:, :j] * Lj[None], dim=1)) * inv_d[j]
    Li = torch.zeros_like(M)
    for i in range(n):
        Li[i, i] = inv_d[i]
        if i:
            Li[i, :i] = -torch.sum(L[i, :i, None] * Li[:i, :i], dim=0) * inv_d[i]
    return torch.einsum("kin,kjn->ijn", Li, Li)


class LanesEngine:
    """Env-axis-last engine sharing the static tables of an `Engine`
    (`engine_lanes.py:149`)."""

    def __init__(self, engine: Engine):
        self.e = engine
        self.opt = engine.opt
        # the contact solve: kernel 1's wrapper (launches the CUDA kernel for
        # CUDA tensors). `chip_smoke.py` swaps in the plain version to hold a
        # whole control step of the kernel against it.
        self.contact_solve = apgd_lanes
        model = engine.model
        dev = engine.device
        self.device = dev
        self.nb, self.nd, self.nv, self.K = engine.nb, engine.nd, engine.nv, engine.K
        t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

        axis = np.asarray(model.dof_axis, dtype=np.float32)    # [nd,3]
        K_sk = np.zeros((self.nd, 3, 3), np.float32)
        K_sk[:, 0, 1], K_sk[:, 0, 2] = -axis[:, 2], axis[:, 1]
        K_sk[:, 1, 0], K_sk[:, 1, 2] = axis[:, 2], -axis[:, 0]
        K_sk[:, 2, 0], K_sk[:, 2, 1] = -axis[:, 1], axis[:, 0]
        self._K = t(np.moveaxis(K_sk, 0, -1))                   # [3,3,nd]
        self._P = t(np.moveaxis(np.einsum("di,dj->dij", axis, axis), 0, -1))
        self._axis = t(axis.T)                                   # [3,nd]
        self._eye3 = torch.eye(3, device=dev)

        R_local = rot.quat_to_matrix(t(model.local_quat))       # [B,3,3]
        self._R_local = R_local.permute(1, 2, 0).contiguous()    # [3,3,B]
        self._local_pos = t(np.asarray(model.local_pos).T)       # [3,B]

        _, pos, parent_pos = _level_order(model)
        self._levels = [np.asarray(lv) for lv in model.levels]
        self._parent_pos = [np.asarray(p) for p in parent_pos]
        self._pos = np.asarray(pos)
        self._joint_slot = np.asarray(engine.joint_slot)
        self._dof_body = np.asarray(model.dof_body)
        self._parent = np.asarray(model.parent[: self.nb])

        self._subtree = engine.subtree                           # [B,B]
        self._dof_anc_mask = t(engine.dof_anc_np)[:, :, None] > 0  # [nd,nd,1]
        self._contact_body = engine.contact_body
        self._contact_pos = engine.contact_pos.T.contiguous()   # [3,K]
        self._contact_radius = engine.contact_radius[:, None]    # [K,1]
        self._dof_limits = engine.dof_limits                     # [nd,2]
        self.P, self.KT = engine.P, engine.KT
        self._pair_i, self._pair_j = engine.pair_i, engine.pair_j
        if self.P:
            self._pair_rsum = engine.pair_rsum[:, None]          # [P,1]
        anc = torch.cat([torch.ones((self.K, 6), device=dev), engine.contact_anc], dim=1)
        self._anc_rows = torch.repeat_interleave(anc, 3, dim=0)[:, :, None]  # [K3,nv,1]

        # dofs couple only along ancestor chains: M_dd is block diagonal over
        # the subtrees hanging off the root (`engine_lanes.py:196-215`)
        anc_dd = engine.dof_anc_np + engine.dof_anc_np.T
        groups, seen = [], set()
        for d in range(self.nd):
            if d in seen:
                continue
            comp, stack = set(), [d]
            while stack:
                i = stack.pop()
                if i in comp:
                    continue
                comp.add(i)
                stack.extend(int(j) for j in np.nonzero(anc_dd[i] > 0)[0] if j not in comp)
            seen |= comp
            g = np.asarray(sorted(comp), dtype=np.int64)
            if g[-1] - g[0] + 1 != len(g):
                raise ValueError(f"non-contiguous dof group {g}")
            groups.append(g)
        self._dof_groups = groups

    # ------------------------------------------------------------------ FK
    def _fk(self, dof_pos, root_quat, root_pos):
        """dof_pos [nd,N], root_quat [4,N], root_pos [3,N] -> p_w [3,B,N], R_w [3,3,B,N]."""
        N = dof_pos.shape[-1]
        c, s = torch.cos(dof_pos), torch.sin(dof_pos)
        Rj = (self._eye3[:, :, None, None] * c + self._K[..., None] * s
              + self._P[..., None] * (1.0 - c))                      # [3,3,nd,N]
        ident = self._eye3[:, :, None, None].expand(3, 3, 1, N)
        Rj_all = torch.cat([Rj, ident], dim=2)[:, :, self._joint_slot]

        R_acc = _quat_to_matrix_lanes(root_quat)[:, :, None]          # [3,3,1,N]
        p_acc = root_pos[:, None]                                     # [3,1,N]
        for lv, ppos in zip(self._levels, self._parent_pos):
            Rp = R_acc[:, :, ppos]
            A = _mm33(Rp, self._R_local[:, :, lv][..., None])
            R_new = _mm33(A, Rj_all[:, :, lv])
            p_new = _mv3(Rp, self._local_pos[:, lv][:, :, None]) + p_acc[:, ppos]
            R_acc = torch.cat([R_acc, R_new], dim=2)
            p_acc = torch.cat([p_acc, p_new], dim=1)
        return p_acc[:, self._pos], R_acc[:, :, self._pos]

    # ------------------------------------------------------------- derived
    def derived_state_lanes(self, stT, states_env_first, contact_forces=None):
        """Refresh body pose/velocity caches from lanes state (`engine_lanes.py:245`)."""
        N = stT["q"].shape[-1]
        p_w, R_w = self._fk(stT["q"], stT["rq"], stT["rp"])
        ax_b = torch.cat([self._axis, torch.zeros((3, 1), device=self.device)], dim=1)[:, self._joint_slot]
        qd_b = torch.cat([stT["qd"], torch.zeros((1, N), device=self.device)], dim=0)[self._joint_slot]
        twist = _mv3(R_w, ax_b[:, :, None]) * qd_b[None]               # [3,B,N]

        v_acc, w_acc = stT["rv"][:, None], stT["rw"][:, None]
        for lv, ppos in zip(self._levels, self._parent_pos):
            wp = w_acc[:, ppos]
            w_new = wp + twist[:, lv]
            v_new = v_acc[:, ppos] + _cross3(wp, p_w[:, lv] - p_w[:, self._parent[lv]])
            w_acc = torch.cat([w_acc, w_new], dim=1)
            v_acc = torch.cat([v_acc, v_new], dim=1)
        v, w = v_acc[:, self._pos], w_acc[:, self._pos]
        out = dataclasses.replace(
            states_env_first,
            body_pos=p_w.permute(2, 1, 0).contiguous(),
            body_quat=rot.matrix_to_quat(R_w.permute(3, 2, 0, 1)),
            body_lin_vel=v.permute(2, 1, 0).contiguous(),
            body_ang_vel=w.permute(2, 1, 0).contiguous(),
        )
        if contact_forces is not None:
            out = dataclasses.replace(out, contact_forces=contact_forces)
        return out

    # --------------------------------------------------------- spatial algebra
    def _spatial_quantities(self, paramsT, p_w, R_w):
        """I_o [6,6,B,N], Phi_d [6,nd,N] about the root body origin (`engine_lanes.py:286`)."""
        p_rel = p_w - p_w[:, :1]
        c_w = p_rel + _mv3(R_w, paramsT["com"])
        I_c = _mm33_t(_mm33(R_w, paramsT["inertia"]), R_w)
        zero = torch.zeros_like(c_w[0])
        ch = torch.stack([torch.stack([zero, -c_w[2], c_w[1]]),
                          torch.stack([c_w[2], zero, -c_w[0]]),
                          torch.stack([-c_w[1], c_w[0], zero])])     # [3,3,B,N]
        m = paramsT["mass"][None, None]
        I_ang = I_c + m * _mm33_t(ch, ch)
        m_ch = m * ch
        m_eye = m * self._eye3[:, :, None, None]
        I_o = torch.cat([torch.cat([I_ang, m_ch], dim=1), torch.cat([-m_ch, m_eye], dim=1)], dim=0)

        R_d = R_w[:, :, self._dof_body]
        axis_w = _mv3(R_d, self._axis[:, :, None])                    # [3,nd,N]
        anchor = p_rel[:, self._dof_body]
        Phi_d = torch.cat([axis_w, _cross3(anchor, axis_w)], dim=0)   # [6,nd,N]
        return I_o, Phi_d, p_rel, c_w

    @staticmethod
    def _swap6(x):
        return torch.cat([x[3:], x[:3]], dim=0)

    def _mass_matrix(self, paramsT, I_o, Phi_d):
        """CRBA -> M [nv,nv,N] (`engine_lanes.py:320`)."""
        nd = self.nd
        I_comp = torch.einsum("bc,ijcn->ijbn", self._subtree, I_o)   # [6,6,B,N]
        I_comp_d = I_comp[:, :, self._dof_body]                       # [6,6,nd,N]
        F = torch.sum(I_comp_d * Phi_d[None], dim=1)                  # [6,nd,N]
        M_dd_full = torch.sum(Phi_d[:, :, None] * F[:, None], dim=0)  # [nd,nd,N]
        M_dd = torch.where(self._dof_anc_mask, M_dd_full, 0.0)
        eye = torch.eye(nd, device=self.device)[:, :, None]
        M_dd = M_dd + M_dd.transpose(0, 1) - M_dd * eye
        M_dd = M_dd + eye * paramsT["armature"][None]
        M_rd = self._swap6(F)
        M_rr = self._swap6(self._swap6(I_comp[:, :, 0]).transpose(0, 1))
        top = torch.cat([M_rr, M_rd], dim=1)
        bot = torch.cat([M_rd.transpose(0, 1), M_dd], dim=1)
        return torch.cat([top, bot], dim=0)

    @staticmethod
    def _cross_motion(a, b):
        return torch.cat([_cross3(a[:3], b[:3]), _cross3(a[:3], b[3:]) + _cross3(a[3:], b[:3])], dim=0)

    @staticmethod
    def _cross_force(a, f):
        return torch.cat([_cross3(a[:3], f[:3]) + _cross3(a[3:], f[3:]), _cross3(a[:3], f[3:])], dim=0)

    def _bias_forces(self, stateT, I_o, Phi_d):
        """RNEA with qdd = 0 -> bias [nv,N] (`engine_lanes.py:353`)."""
        N = stateT["qd"].shape[-1]
        v_root = torch.cat([stateT["rw"], stateT["rv"]], dim=0)
        grav = torch.tensor([0.0, 0.0, GRAVITY], device=self.device)[:, None]
        g_acc = torch.cat([torch.zeros((3, N), device=self.device),
                           _cross3(stateT["rv"], stateT["rw"]) + grav], dim=0)
        twist_d = Phi_d * stateT["qd"][None]
        twist = torch.cat([twist_d, torch.zeros((6, 1, N), device=self.device)], dim=1)[:, self._joint_slot]
        v_acc, a_acc = v_root[:, None], g_acc[:, None]
        for lv, ppos in zip(self._levels, self._parent_pos):
            vj = twist[:, lv]
            v_new = v_acc[:, ppos] + vj
            a_new = a_acc[:, ppos] + self._cross_motion(v_new, vj)
            v_acc = torch.cat([v_acc, v_new], dim=1)
            a_acc = torch.cat([a_acc, a_new], dim=1)
        v, a = v_acc[:, self._pos], a_acc[:, self._pos]
        Iv = torch.sum(I_o * v[None], dim=1)
        Ia = torch.sum(I_o * a[None], dim=1)
        f = Ia + self._cross_force(v, Iv)
        f_sub = torch.einsum("bc,icn->ibn", self._subtree, f)
        bias_d = torch.sum(Phi_d * f_sub[:, self._dof_body], dim=0)
        return torch.cat([self._swap6(f_sub[:, 0]), bias_d], dim=0)

    def _m_inverse(self, M):
        """Branch-sparse SPD inverse of M [nv,nv,N] via the 6x6 root Schur
        complement (`engine_lanes.py:384`)."""
        nd, N = self.nd, M.shape[-1]
        R, B = M[:6, :6], M[6:, :6]
        D_inv = torch.zeros((nd, nd, N), dtype=M.dtype, device=M.device)
        for g in self._dof_groups:
            a, b = int(g[0]), int(g[-1]) + 1
            D_inv[a:b, a:b] = _spd_inverse_lanes(M[6 + a:6 + b, 6 + a:6 + b])
        E = torch.einsum("ijn,jkn->ikn", D_inv, B)
        S = R - torch.einsum("jin,jkn->ikn", B, E)
        S_inv = _spd_inverse_lanes(S)
        TR = -torch.einsum("ijn,kjn->ikn", S_inv, E)
        BR = D_inv - torch.einsum("ijn,jkn->ikn", E, TR)
        top = torch.cat([S_inv, TR], dim=1)
        bot = torch.cat([TR.transpose(0, 1), BR], dim=1)
        return torch.cat([top, bot], dim=0)

    def _gravity_forces(self, I_o, Phi_d):
        f = I_o[:, 5] * GRAVITY
        f_sub = torch.einsum("bc,icn->ibn", self._subtree, f)
        G_d = torch.sum(Phi_d * f_sub[:, self._dof_body], dim=0)
        return torch.cat([self._swap6(f_sub[:, 0]), G_d], dim=0)

    # ------------------------------------------------------------------ contact
    def _contact_jacobian(self, p_w, R_w, Phi_d, p_rel):
        """Jf [K3,nv,N] (rows k-major), sphere centres x [3,K,N] (`engine_lanes.py:423`)."""
        K, nv = self.K, self.nv
        N = p_w.shape[-1]
        Rk = R_w[:, :, self._contact_body]
        x = p_w[:, self._contact_body] + _mv3(Rk, self._contact_pos[:, :, None])
        x_rel = x - p_w[:, :1]
        Jd = Phi_d[3:][:, None] + _cross3(Phi_d[:3][:, None], x_rel[:, :, None])  # [3,K,nd,N]
        eye = self._eye3
        Jr_v = eye[:, None, :, None].expand(3, K, 3, N)
        Jr_w = _cross3(eye[:, None, :, None], x_rel[:, :, None])      # [3,K,3,N]
        J = torch.cat([Jr_v, Jr_w, Jd], dim=2)                        # [3,K,nv,N]
        return J.transpose(0, 1).reshape(K * 3, nv, N), x

    def _pair_rows(self, J3, x):
        """Self-collision rows (`engine_lanes.py:447`): J3 [K,3,nv,N], x [3,K,N]
        -> (Jp [P*3,nv,N], phi_p [P,N], C [3,3,P,N])."""
        d = x[:, self._pair_i] - x[:, self._pair_j]
        dist = torch.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
        n = d / torch.clamp(dist, min=1e-9)[None]
        phi_p = dist - self._pair_rsum
        use_z = torch.abs(n[2]) < 0.9
        one, zero = torch.ones_like(dist), torch.zeros_like(dist)
        ref = torch.stack([torch.where(use_z, zero, one), zero, torch.where(use_z, one, zero)])
        t1 = _cross3(ref, n)
        t1 = t1 / torch.clamp(torch.sqrt(torch.sum(t1 * t1, dim=0, keepdim=True)), min=1e-9)
        t2 = _cross3(n, t1)
        C = torch.stack([t1, t2, n], dim=0)                           # [3,3,P,N]
        Jrel = J3[self._pair_i] - J3[self._pair_j]                    # [P,3,nv,N]
        Jp = torch.sum(C.permute(2, 0, 1, 3)[:, :, :, None] * Jrel[:, None], dim=2)  # [P,3,nv,N]
        return Jp.reshape(-1, J3.shape[2], J3.shape[3]), phi_p, C

    def _ground_height(self, xy):
        """xy [2,K,N] world coordinates -> [K,N] (`engine_lanes.py:474`): the
        engine's lookup (a flat plane, or the bilinear heightfield) on the
        component-last view."""
        return self.e.ground_height(torch.movedim(xy, 0, -1))

    # ------------------------------------------------------------------ substep
    def _pre_contact(self, paramsT, stateT, tauT):
        """Dynamics up to the contact solve, env-last (`engine_lanes.py:488-560`).
        Returns u_plus [nv,N], M_inv [nv,nv,N], Jf [KT*3,nv,N] (rows k-major,
        ground rows masked by ancestry), phi [KT,N] and the pair-row contact
        frames C [3,3,P,N] (None without pairs)."""
        opt = self.opt
        nv, K = self.nv, self.K
        N = tauT.shape[-1]
        dev = self.device

        p_w, R_w = self._fk(stateT["q"], stateT["rq"], stateT["rp"])
        I_o, Phi_d, p_rel, _ = self._spatial_quantities(paramsT, p_w, R_w)
        M = self._mass_matrix(paramsT, I_o, Phi_d)
        bias = self._bias_forces(stateT, I_o, Phi_d)

        qd0 = stateT["qd"]
        tau_passive = -paramsT["dof_damping"] * qd0 - paramsT["dof_frictionloss"] * torch.tanh(qd0 / 0.05)
        tau_full = torch.cat([torch.zeros((6, N), device=dev), tauT + tau_passive], dim=0)

        M_inv = self._m_inverse(M)
        u = torch.cat([stateT["rv"], stateT["rw"], qd0], dim=0)
        u_plus = u + opt.dt * torch.sum(M_inv * (tau_full - bias)[None], dim=1)

        if opt.energy_projection:
            G = self._gravity_forces(I_o, Phi_d)
            ke0 = 0.5 * torch.sum(u * torch.sum(M * u[None], dim=1), dim=0)
            ke_plus = 0.5 * torch.sum(u_plus * torch.sum(M * u_plus[None], dim=1), dim=0)
            p_ext = 0.5 * torch.sum((u + u_plus) * (tau_full - G), dim=0)
            target = torch.clamp(ke0 + opt.dt * p_ext, min=0.0)
            s = torch.clamp(torch.sqrt(target / torch.clamp(ke_plus, min=1e-12)), max=1.0)
            u_plus = u_plus * s[None]

        Jf, x = self._contact_jacobian(p_w, R_w, Phi_d, p_rel)
        Jf = Jf * self._anc_rows
        phi = x[2] - self._contact_radius - self._ground_height(x[:2])   # [K,N]

        C = None
        if self.P:
            Jp, phi_p, C = self._pair_rows(Jf.reshape(K, 3, nv, N), x)
            Jf = torch.cat([Jf, Jp], dim=0)
            phi = torch.cat([phi, phi_p], dim=0)
        return u_plus, M_inv, Jf, phi, C

    def _substep(self, paramsT, stateT, tauT, lam_prev=None):
        """One physics step, env-last (`engine_lanes.py:488-641`).
        Returns (stateT, lam [KT,3,N] world-frame impulses)."""
        opt = self.opt
        nv, K, KT = self.nv, self.K, self.KT
        N = tauT.shape[-1]
        dev = self.device
        u_plus, M_inv, Jf, phi, C = self._pre_contact(paramsT, stateT, tauT)

        if lam_prev is None:
            lam_cf = torch.zeros((KT, 3, N), device=dev)
        elif self.P:
            pair_cf = torch.stack([sum(C[a][b] * lam_prev[K:, b] for b in range(3))
                                   for a in range(3)], dim=1)
            lam_cf = torch.cat([lam_prev[:K], pair_cf], dim=0)
        else:
            lam_cf = lam_prev

        idx = active_set_indices(opt, K, self.P, phi.T)                 # [N,cap] | None
        idxT = None
        if idx is not None:
            idxT = idx.T.contiguous()                                   # [cap,N]
            cap = idxT.shape[0]
            Jf = torch.gather(Jf.reshape(KT, 3 * nv, N), 0,
                              idxT[:, None, :].expand(cap, 3 * nv, N)).reshape(cap * 3, nv, N)
            phi = torch.gather(phi, 0, idxT)
            lam_cf = torch.gather(lam_cf, 0, idxT[:, None, :].expand(cap, 3, N))
        R = phi.shape[0]

        # Delassus A = Jf M⁻¹ Jfᵀ: batched products outside the kernel, as in XLA
        JM = torch.einsum("avn,vwn->awn", Jf, M_inv)
        A = torch.einsum("awn,bwn->abn", JM, Jf).contiguous()          # [R3,R3,N]

        active = (phi < opt.contact_margin).to(torch.float32)           # [R,N]
        v0 = torch.sum(Jf * u_plus[None], dim=1).reshape(R, 3, N)
        b = v0.clone()
        b[:, 2] += paramsT["restitution"][None] * torch.clamp(v0[:, 2], max=0.0)
        b = b.reshape(R * 3, N)

        lam = self.contact_solve(A, b, paramsT["friction"], active, lam_cf.reshape(R * 3, N).contiguous(),
                                 iters=opt.solver_iters, mv_dtype=self.solve_dtype(N))

        # energy safeguard (`engine_lanes.py:595-601`)
        qv = torch.sum(A * lam[None], dim=1)
        lAl = torch.sum(lam * qv, dim=0)
        t = torch.clamp(-torch.sum(b * lam, dim=0) / torch.clamp(lAl, min=1e-12), 0.0, 1.0)
        t = torch.where(lAl > 1e-12, t, 1.0)
        lam = lam * t[None]

        imp = torch.sum(Jf * lam[:, None], dim=0)
        u_new = u_plus + torch.sum(M_inv * imp[None], dim=1)

        # split-impulse position pass (`engine_lanes.py:606-628`), its matvec
        # in `contact_matvec_dtype` on every branch, plain PyTorch as JAX's is XLA
        b_err = -opt.baumgarte / opt.dt * torch.clamp(phi + opt.penetration_slop, max=0.0)
        b_err = torch.clamp(b_err, max=opt.max_depenetration_velocity)
        act3 = torch.repeat_interleave(active, 3, dim=0)
        Lp = torch.amax(act3 * torch.sum(torch.abs(A) * act3[None], dim=1), dim=0)
        inv_Lp = 1.0 / torch.clamp(Lp, min=1e-6)
        cp = torch.zeros((R, 3, N), device=dev)
        cp[:, 2] = b_err * active
        cp = cp.reshape(R * 3, N)
        lam_p = torch.zeros((R * 3, N), device=dev)
        A_mv = round_to(A, opt.contact_matvec_dtype)
        for _ in range(opt.pos_iters):
            g = matvec_plain(A_mv, lam_p, opt.contact_matvec_dtype) - cp
            x3 = (lam_p - inv_Lp[None] * g).reshape(R, 3, N)
            nxt = torch.zeros_like(x3)
            nxt[:, 2] = torch.clamp(x3[:, 2], min=0.0) * active
            lam_p = nxt.reshape(R * 3, N)
        dpos = opt.dt * torch.sum(M_inv * torch.sum(Jf * lam_p[:, None], dim=0)[None], dim=1)

        lam3 = lam.reshape(R, 3, N)
        if idxT is not None:
            lam3 = torch.zeros((KT, 3, N), device=dev).scatter_(
                0, idxT[:, None, :].expand(idxT.shape[0], 3, N), lam3)
        if self.P:   # pair rows: contact frame -> world
            world = torch.stack([sum(C[a][b] * lam3[K:, a] for a in range(3)) for b in range(3)], dim=1)
            lam3 = torch.cat([lam3[:K], world], dim=0)
        return self._integrate(stateT, u_new, dpos), lam3

    def solve_dtype(self, N: int) -> str:
        """The matvec dtype of the contact solve at N envs, as JAX picks its
        solve (`engine_lanes.py:583-591`): float32 where JAX runs the Pallas
        kernel, which ignores the dtype (N a multiple of 128 and the key
        `pallas`, or `auto` off the CPU: JAX reads `auto` by its backend,
        which on a card would not be the CPU), else the XLA `_apgd` in
        `contact_matvec_dtype`."""
        kernel = self.opt.lanes_contact_kernel
        pallas = N % 128 == 0 and (kernel == "pallas" or (kernel == "auto" and self.device.type != "cpu"))
        return "float32" if pallas else self.opt.contact_matvec_dtype

    def _integrate(self, stateT, u_new, dpos=None):
        """Semi-implicit Euler + caps + hard joint limits (`engine_lanes.py:684`)."""
        opt = self.opt
        v_r = torch.clamp(u_new[:3], -opt.max_root_lin_vel, opt.max_root_lin_vel)
        w_r = torch.clamp(u_new[3:6], -opt.max_root_ang_vel, opt.max_root_ang_vel)
        qd = torch.clamp(u_new[6:], -opt.max_dof_vel, opt.max_dof_vel)
        dof_pos = stateT["q"] + qd * opt.dt
        if dpos is not None:
            dof_pos = dof_pos + dpos[6:]
        if opt.joint_limits:
            lo, hi = self._dof_limits[:, 0][:, None], self._dof_limits[:, 1][:, None]
            below, above = dof_pos < lo, dof_pos > hi
            dof_pos = torch.clamp(dof_pos, lo, hi)
            qd = torch.where(below & (qd < 0), 0.0, qd)
            qd = torch.where(above & (qd > 0), 0.0, qd)
        rq = _quat_integrate_lanes(stateT["rq"], w_r, opt.dt)
        rp = stateT["rp"] + v_r * opt.dt
        if dpos is not None:
            rp = rp + dpos[:3]
            rq = _quat_integrate_lanes(rq, dpos[3:6], 1.0)
        return dict(rp=rp, rq=rq, rv=v_r, rw=w_r, q=dof_pos, qd=qd)

    # ------------------------------------------------------------- control step
    @staticmethod
    def _to_lanes(states: SimState):
        return dict(rp=states.root_pos.T, rq=states.root_quat.T, rv=states.root_lin_vel.T,
                    rw=states.root_ang_vel.T, q=states.dof_pos.T, qd=states.dof_vel.T)

    @staticmethod
    def params_to_lanes(params: SimParams):
        """Env-first SimParams -> the component-leading env-last dict `_substep` reads."""
        return dict(
            mass=params.mass.T.contiguous(),                          # [B,N]
            com=params.com.permute(2, 1, 0).contiguous(),             # [3,B,N]
            inertia=params.inertia.permute(2, 3, 1, 0).contiguous(),  # [3,3,B,N]
            friction=params.friction.contiguous(),
            restitution=params.restitution.contiguous(),
            armature=params.armature.T.contiguous(),
            dof_damping=params.dof_damping.T.contiguous(),
            dof_frictionloss=params.dof_frictionloss.T.contiguous(),
        )

    def control_step_batched(self, params: SimParams, states: SimState, torque_fn,
                             decimation: int, paramsT=None, pre_substep_fn=None):
        """`engine_lanes.py:716`: `decimation` substeps with env-first state at
        the boundary. torque_fn(states_env_first) -> [N,nd]; pre_substep_fn
        (states_env_first) -> states, run before each substep's torques (the
        soft-dynamic-correction hook). Both see the body caches of the step's
        start, as in JAX. Pass `paramsT` (from `params_to_lanes`) to skip the
        per-call re-layout."""
        N = states.root_pos.shape[0]
        if paramsT is None:
            paramsT = self.params_to_lanes(params)

        def view(stT):
            return dataclasses.replace(
                states, root_pos=stT["rp"].T, root_quat=stT["rq"].T, root_lin_vel=stT["rv"].T,
                root_ang_vel=stT["rw"].T, dof_pos=stT["q"].T, dof_vel=stT["qd"].T)

        stT = self._to_lanes(states)
        lam = torch.zeros((self.KT, 3, N), device=self.device)
        lam_acc = torch.zeros_like(lam)
        tau = None
        for _ in range(decimation):
            if pre_substep_fn is not None:
                stT = self._to_lanes(pre_substep_fn(view(stT)))
            tau = torque_fn(view(stT))
            stT, lam = self._substep(paramsT, stT, tau.T, lam if self.opt.warm_start else None)
            lam_acc = lam_acc + lam
        cf = self.e.contact_forces_from_impulses(lam_acc.permute(2, 0, 1), decimation)
        out = self.derived_state_lanes(stT, view(stT), contact_forces=cf)
        return out, tau
