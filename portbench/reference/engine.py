"""Plain reference of the lanes engine's physics substep, env axis last.

A frozen copy of the port's formulas (CRBA mass matrix and RNEA bias in
root-anchored world-axis spatial coordinates, a Cholesky inverse per dof
branch and the root's Schur complement, contact Jacobians with
class-budgeted active rows, the Delassus system, the plain APGD solve of
`reference/apgd.py`, the energy safeguard, the split-impulse position pass,
semi-implicit Euler with velocity caps and joint limits), and of the body
states and per-body contact forces at the end of a control step. Tables come
from `reference/robot.py`, options from the run's config snapshot; the
per-env physical parameters are the program's state.

`precision="tf32"` rounds both operands of every product (the 3 x 3 frame
products, the spatial contractions, the Delassus and inverse products, the
matvecs) to TF32: the control.

States are dicts of env-last tensors: rp [3,N], rq [4,N] (xyzw), rv [3,N],
rw [3,N], q [nd,N], qd [nd,N].
"""
from __future__ import annotations

import numpy as np
import torch

from . import apgd, robot
from .precision import rounded

GRAVITY = 9.81
# the engine's options where the config leaves them unset
DEFAULTS = {"solver_iters": 32, "baumgarte": 0.2, "contact_margin": 0.0, "penetration_slop": 0.002,
            "max_depenetration_velocity": 1.0, "max_dof_vel": 100.0, "max_root_lin_vel": 50.0,
            "max_root_ang_vel": 50.0, "joint_limits": True, "pos_iters": 8, "energy_projection": True,
            "contact_cap": 0, "pair_cap": 4, "warm_start": True}


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]])


def quat_to_matrix(q):
    """q [..., 4] xyzw -> [..., 3, 3]."""
    x, y, z, w = q.unbind(-1)
    m = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                     2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """[..., 3, 3] -> [..., 4] xyzw, w >= 0, unit."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    sq = lambda x: torch.sqrt(torch.clamp(x, min=1e-18))
    a = sq(1.0 + tr) / 2.0
    q0 = torch.stack([m21 - m12, m02 - m20, m10 - m01, 4.0 * a * a], -1) / (4.0 * a[..., None])
    b = sq(1.0 + m00 - m11 - m22) / 2.0
    q1 = torch.stack([4.0 * b * b, m01 + m10, m02 + m20, m21 - m12], -1) / (4.0 * b[..., None])
    c = sq(1.0 - m00 + m11 - m22) / 2.0
    q2 = torch.stack([m01 + m10, 4.0 * c * c, m12 + m21, m02 - m20], -1) / (4.0 * c[..., None])
    d = sq(1.0 - m00 - m11 + m22) / 2.0
    q3 = torch.stack([m02 + m20, m12 + m21, 4.0 * d * d, m10 - m01], -1) / (4.0 * d[..., None])
    cands = torch.stack([q0, q1, q2, q3], dim=-2)
    idx = torch.argmax(torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], -1), dim=-1)
    q = torch.take_along_dim(cands, idx[..., None, None].expand(idx.shape + (1, 4)), dim=-2)[..., 0, :]
    q = torch.where(q[..., 3:4] < 0, -q, q)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp(min=1e-9)


def quat_integrate(q, omega, dt):
    """q [4,N] advanced by the world angular velocity omega [3,N] over dt."""
    e = omega * dt
    angle = torch.sqrt(e[0] ** 2 + e[1] ** 2 + e[2] ** 2)
    half = 0.5 * angle
    k = torch.where(angle < 1e-4, 0.5 - angle * angle / 48.0, torch.sin(half) / torch.clamp(angle, min=1e-8))
    dx, dy, dz, dw = e[0] * k, e[1] * k, e[2] * k, torch.cos(half)
    x, y, z, w = q[0], q[1], q[2], q[3]
    out = torch.stack([dw * x + dx * w + dy * z - dz * y, dw * y - dx * z + dy * w + dz * x,
                       dw * z + dx * y - dy * x + dz * w, dw * w - dx * x - dy * y - dz * z])
    return out / torch.sqrt(torch.sum(out * out, dim=0, keepdim=True))


class Engine:
    """The run's engine: `config` the run's config snapshot (a dict)."""

    def __init__(self, root, snapshot: dict, device, precision: str = "float32"):
        self.dev, self.precision = torch.device(device), precision
        rcfg, sim = snapshot["robot"], snapshot["simulator"]["config"]
        opt = dict(DEFAULTS)
        opt.update({k: sim[k] for k in DEFAULTS if k in sim})
        opt["dt"] = 1.0 / float(sim["sim"]["fps"])
        self.opt = opt
        self.decimation = int(sim["sim"]["control_decimation"])
        tb = robot.tables(root, rcfg["robot_type"], bool(rcfg.get("self_collision", True)))
        self.tb = tb
        t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self.dev)
        nb, nd = len(tb["names"]), len(tb["dof_body"])
        self.nb, self.nd, self.nv = nb, nd, 6 + nd
        parent = tb["parent"]
        anc_body_dof = np.zeros((nb, nd), dtype=np.float32)
        sub = np.zeros((nb, nb), dtype=np.float32)
        for b in range(nb):
            x = b
            while x != -1:
                if tb["body_dof"][x] >= 0:
                    anc_body_dof[b, tb["body_dof"][x]] = 1.0
                sub[x, b] = 1.0
                x = parent[x]
        dof_anc = anc_body_dof[tb["dof_body"], :].T
        self.subtree = t(sub)
        self.dof_anc_mask = t(dof_anc)[:, :, None] > 0
        self.cb = tb["contact_body"]
        self.K = len(self.cb)
        self.pi, self.pj = tb["pairs"][:, 0], tb["pairs"][:, 1]
        self.P = len(self.pi)
        self.KT = self.K + self.P
        self.radius = t(tb["contact_radius"])
        self.cpos = t(tb["contact_pos"]).T.contiguous()                 # [3,K]
        anc = torch.cat([torch.ones((self.K, 6), device=self.dev), t(anc_body_dof[self.cb])], dim=1)
        self.anc_rows = torch.repeat_interleave(anc, 3, dim=0)[:, :, None]
        axis = tb["dof_axis"].astype(np.float32)
        skew = np.zeros((nd, 3, 3), np.float32)
        skew[:, 0, 1], skew[:, 0, 2] = -axis[:, 2], axis[:, 1]
        skew[:, 1, 0], skew[:, 1, 2] = axis[:, 2], -axis[:, 0]
        skew[:, 2, 0], skew[:, 2, 1] = -axis[:, 1], axis[:, 0]
        self.K_sk = t(np.moveaxis(skew, 0, -1))
        self.P_ax = t(np.moveaxis(np.einsum("di,dj->dij", axis, axis), 0, -1))
        self.axis = t(axis.T)
        self.eye3 = torch.eye(3, device=self.dev)
        self.R_local = quat_to_matrix(t(tb["local_quat"])).permute(1, 2, 0).contiguous()
        self.local_pos = t(tb["local_pos"].T)
        order = [0] + [int(i) for lv in tb["levels"] for i in lv]
        pos = np.zeros(nb, dtype=np.int64)
        for p, b in enumerate(order):
            pos[b] = p
        self.pos, self.levels = pos, tb["levels"]
        self.parent_pos = [pos[parent[lv]] for lv in tb["levels"]]
        self.parent = parent
        slot = np.full(nb, nd, dtype=np.int64)
        slot[tb["dof_body"]] = np.arange(nd)
        self.slot, self.dof_body = slot, tb["dof_body"]
        self.dof_limits = t(tb["dof_limits"])
        anc_dd = dof_anc + dof_anc.T
        groups, seen = [], set()
        for d in range(nd):
            if d in seen:
                continue
            comp, stack = set(), [d]
            while stack:
                i = stack.pop()
                if i not in comp:
                    comp.add(i)
                    stack.extend(int(j) for j in np.nonzero(anc_dd[i] > 0)[0])
            seen |= comp
            groups.append((min(comp), max(comp) + 1))
        self.groups = groups
        self.force_body = torch.as_tensor(np.concatenate([self.cb, self.cb[self.pi], self.cb[self.pj]]),
                                          device=self.dev)

    # ------------------------------------------------------------ products
    def r(self, x):
        return rounded(x, self.precision)

    def mm(self, A, B):
        """[3,3,...] @ [3,3,...]."""
        A, B = self.r(A), self.r(B)
        return sum(A[:, k].unsqueeze(1) * B[k].unsqueeze(0) for k in range(3))

    def mm_t(self, A, B):
        A, B = self.r(A), self.r(B)
        return sum(A[:, k].unsqueeze(1) * B[:, k].unsqueeze(0) for k in range(3))

    def mv(self, A, v):
        A, v = self.r(A), self.r(v)
        return sum(A[:, k] * v[k].unsqueeze(0) for k in range(3))

    def ein(self, eq, a, b):
        return torch.einsum(eq, self.r(a), self.r(b))

    def rowdot(self, M, v, dim):
        """sum(M * v[None], dim): a matvec."""
        return torch.sum(self.r(M) * self.r(v)[None], dim=dim)

    # ------------------------------------------------------------ kinematics
    def fk(self, q, rq, rp):
        N = q.shape[-1]
        c, s = torch.cos(q), torch.sin(q)
        Rj = self.eye3[:, :, None, None] * c + self.K_sk[..., None] * s + self.P_ax[..., None] * (1.0 - c)
        Rj_all = torch.cat([Rj, self.eye3[:, :, None, None].expand(3, 3, 1, N)], dim=2)[:, :, self.slot]
        R_acc = quat_to_matrix(rq.T).permute(1, 2, 0)[:, :, None]          # [3,3,1,N]
        p_acc = rp[:, None]
        for lv, ppos in zip(self.levels, self.parent_pos):
            Rp = R_acc[:, :, ppos]
            R_new = self.mm(self.mm(Rp, self.R_local[:, :, lv][..., None]), Rj_all[:, :, lv])
            p_new = self.mv(Rp, self.local_pos[:, lv][:, :, None]) + p_acc[:, ppos]
            R_acc = torch.cat([R_acc, R_new], dim=2)
            p_acc = torch.cat([p_acc, p_new], dim=1)
        return p_acc[:, self.pos], R_acc[:, :, self.pos]

    def body_states(self, st):
        """World pose and velocity of every body: (pos [N,B,3], quat [N,B,4],
        lin_vel [N,B,3], ang_vel [N,B,3])."""
        N = st["q"].shape[-1]
        p_w, R_w = self.fk(st["q"], st["rq"], st["rp"])
        ax_b = torch.cat([self.axis, torch.zeros((3, 1), device=self.dev)], dim=1)[:, self.slot]
        qd_b = torch.cat([st["qd"], torch.zeros((1, N), device=self.dev)], dim=0)[self.slot]
        twist = self.mv(R_w, ax_b[:, :, None]) * qd_b[None]
        v_acc, w_acc = st["rv"][:, None], st["rw"][:, None]
        for lv, ppos in zip(self.levels, self.parent_pos):
            wp = w_acc[:, ppos]
            w_acc = torch.cat([w_acc, wp + twist[:, lv]], dim=1)
            v_acc = torch.cat([v_acc, v_acc[:, ppos] + _cross(wp, p_w[:, lv] - p_w[:, self.parent[lv]])], dim=1)
        v, w = v_acc[:, self.pos], w_acc[:, self.pos]
        return (p_w.permute(2, 1, 0), matrix_to_quat(R_w.permute(3, 2, 0, 1)), v.permute(2, 1, 0),
                w.permute(2, 1, 0))

    # ------------------------------------------------------------ dynamics
    def spatial(self, prm, p_w, R_w):
        p_rel = p_w - p_w[:, :1]
        c_w = p_rel + self.mv(R_w, prm["com"])
        I_c = self.mm_t(self.mm(R_w, prm["inertia"]), R_w)
        z = torch.zeros_like(c_w[0])
        ch = torch.stack([torch.stack([z, -c_w[2], c_w[1]]), torch.stack([c_w[2], z, -c_w[0]]),
                          torch.stack([-c_w[1], c_w[0], z])])
        m = prm["mass"][None, None]
        I_ang = I_c + m * self.mm_t(ch, ch)
        I_o = torch.cat([torch.cat([I_ang, m * ch], dim=1),
                         torch.cat([-m * ch, m * self.eye3[:, :, None, None]], dim=1)], dim=0)
        axis_w = self.mv(R_w[:, :, self.dof_body], self.axis[:, :, None])
        Phi = torch.cat([axis_w, _cross(p_rel[:, self.dof_body], axis_w)], dim=0)
        return I_o, Phi, p_rel

    @staticmethod
    def swap6(x):
        return torch.cat([x[3:], x[:3]], dim=0)

    def mass_matrix(self, prm, I_o, Phi):
        nd = self.nd
        I_comp = self.ein("bc,ijcn->ijbn", self.subtree, I_o)
        F = self.rowdot(I_comp[:, :, self.dof_body], Phi, 1)
        M_dd = torch.sum(self.r(Phi)[:, :, None] * self.r(F)[:, None], dim=0)
        M_dd = torch.where(self.dof_anc_mask, M_dd, 0.0)
        eye = torch.eye(nd, device=self.dev)[:, :, None]
        M_dd = M_dd + M_dd.transpose(0, 1) - M_dd * eye + eye * prm["armature"][None]
        M_rd = self.swap6(F)
        M_rr = self.swap6(self.swap6(I_comp[:, :, 0]).transpose(0, 1))
        return torch.cat([torch.cat([M_rr, M_rd], dim=1), torch.cat([M_rd.transpose(0, 1), M_dd], dim=1)], dim=0)

    @staticmethod
    def cross_motion(a, b):
        return torch.cat([_cross(a[:3], b[:3]), _cross(a[:3], b[3:]) + _cross(a[3:], b[:3])], dim=0)

    @staticmethod
    def cross_force(a, f):
        return torch.cat([_cross(a[:3], f[:3]) + _cross(a[3:], f[3:]), _cross(a[:3], f[3:])], dim=0)

    def bias(self, st, I_o, Phi):
        N = st["qd"].shape[-1]
        v_root = torch.cat([st["rw"], st["rv"]], dim=0)
        grav = torch.tensor([0.0, 0.0, GRAVITY], device=self.dev)[:, None]
        g_acc = torch.cat([torch.zeros((3, N), device=self.dev), _cross(st["rv"], st["rw"]) + grav], dim=0)
        twist = torch.cat([Phi * st["qd"][None], torch.zeros((6, 1, N), device=self.dev)], dim=1)[:, self.slot]
        v_acc, a_acc = v_root[:, None], g_acc[:, None]
        for lv, ppos in zip(self.levels, self.parent_pos):
            vj = twist[:, lv]
            v_new = v_acc[:, ppos] + vj
            a_acc = torch.cat([a_acc, a_acc[:, ppos] + self.cross_motion(v_new, vj)], dim=1)
            v_acc = torch.cat([v_acc, v_new], dim=1)
        v, a = v_acc[:, self.pos], a_acc[:, self.pos]
        f = self.rowdot(I_o, a, 1) + self.cross_force(v, self.rowdot(I_o, v, 1))
        f_sub = self.ein("bc,icn->ibn", self.subtree, f)
        return torch.cat([self.swap6(f_sub[:, 0]),
                          torch.sum(self.r(Phi) * self.r(f_sub[:, self.dof_body]), dim=0)], dim=0)

    def spd_inverse(self, M):
        n = M.shape[0]
        L = torch.zeros_like(M)
        inv_d = torch.empty_like(M[0])
        for j in range(n):
            Lj = L[j, :j]
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
        return self.ein("kin,kjn->ijn", Li, Li)

    def m_inverse(self, M):
        nd, N = self.nd, M.shape[-1]
        R, B = M[:6, :6], M[6:, :6]
        D_inv = torch.zeros((nd, nd, N), dtype=M.dtype, device=M.device)
        for a, b in self.groups:
            D_inv[a:b, a:b] = self.spd_inverse(M[6 + a:6 + b, 6 + a:6 + b])
        E = self.ein("ijn,jkn->ikn", D_inv, B)
        S_inv = self.spd_inverse(R - self.ein("jin,jkn->ikn", B, E))
        TR = -self.ein("ijn,kjn->ikn", S_inv, E)
        BR = D_inv - self.ein("ijn,jkn->ikn", E, TR)
        return torch.cat([torch.cat([S_inv, TR], dim=1), torch.cat([TR.transpose(0, 1), BR], dim=1)], dim=0)

    def gravity_forces(self, I_o, Phi):
        f_sub = self.ein("bc,icn->ibn", self.subtree, I_o[:, 5] * GRAVITY)
        return torch.cat([self.swap6(f_sub[:, 0]), torch.sum(self.r(Phi) * self.r(f_sub[:, self.dof_body]), dim=0)])

    def contact_jacobian(self, p_w, R_w, Phi):
        K, nv, N = self.K, self.nv, p_w.shape[-1]
        x = p_w[:, self.cb] + self.mv(R_w[:, :, self.cb], self.cpos[:, :, None])
        x_rel = x - p_w[:, :1]
        Jd = Phi[3:][:, None] + _cross(Phi[:3][:, None], x_rel[:, :, None])
        Jr_w = _cross(self.eye3[:, None, :, None], x_rel[:, :, None])
        J = torch.cat([self.eye3[:, None, :, None].expand(3, K, 3, N), Jr_w, Jd], dim=2)
        return J.transpose(0, 1).reshape(K * 3, nv, N), x

    def pair_rows(self, J3, x):
        d = x[:, self.pi] - x[:, self.pj]
        dist = torch.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
        n = d / torch.clamp(dist, min=1e-9)[None]
        phi = dist - (self.radius[self.pi] + self.radius[self.pj])[:, None]
        use_z = torch.abs(n[2]) < 0.9
        one, zero = torch.ones_like(dist), torch.zeros_like(dist)
        ref = torch.stack([torch.where(use_z, zero, one), zero, torch.where(use_z, one, zero)])
        t1 = _cross(ref, n)
        t1 = t1 / torch.clamp(torch.sqrt(torch.sum(t1 * t1, dim=0, keepdim=True)), min=1e-9)
        C = torch.stack([t1, _cross(n, t1), n], dim=0)
        Jrel = J3[self.pi] - J3[self.pj]
        Jp = torch.sum(self.r(C.permute(2, 0, 1, 3)[:, :, :, None]) * self.r(Jrel[:, None]), dim=2)
        return Jp.reshape(-1, J3.shape[2], J3.shape[3]), phi, C

    def active_rows(self, phi):
        """The rows the solve sees, [cap,N] (None: all): the `contact_cap`
        deepest ground rows, then the `pair_cap` deepest pair rows, each in
        ascending gap order (a stable sort: ties by the lower index)."""
        cap, K, P = self.opt["contact_cap"], self.K, self.P
        if not 0 < cap < self.KT:
            return None
        deepest = lambda x, k: torch.sort(x, dim=0, stable=True).indices[:k]
        if P and self.opt["pair_cap"] > 0:
            cg, cp = min(cap, K), min(self.opt["pair_cap"], P)
            if cg + cp >= self.KT:
                return None
            return torch.cat([deepest(phi[:K], cg), deepest(phi[K:], cp) + K], dim=0)
        return deepest(phi, cap)

    # ------------------------------------------------------------ the step
    def substep(self, prm, st, tau, lam_prev):
        """One physics substep: (state, world impulses [KT,3,N], the solve's
        inputs and output)."""
        opt, nv, K, KT = self.opt, self.nv, self.K, self.KT
        N, dt = tau.shape[-1], opt["dt"]
        p_w, R_w = self.fk(st["q"], st["rq"], st["rp"])
        I_o, Phi, _ = self.spatial(prm, p_w, R_w)
        M = self.mass_matrix(prm, I_o, Phi)
        bias = self.bias(st, I_o, Phi)
        qd0 = st["qd"]
        tau_p = -prm["dof_damping"] * qd0 - prm["dof_frictionloss"] * torch.tanh(qd0 / 0.05)
        tau_full = torch.cat([torch.zeros((6, N), device=self.dev), tau + tau_p], dim=0)
        M_inv = self.m_inverse(M)
        u = torch.cat([st["rv"], st["rw"], qd0], dim=0)
        u_plus = u + dt * self.rowdot(M_inv, tau_full - bias, 1)
        if opt["energy_projection"]:
            G = self.gravity_forces(I_o, Phi)
            ke0 = 0.5 * torch.sum(u * self.rowdot(M, u, 1), dim=0)
            ke1 = 0.5 * torch.sum(u_plus * self.rowdot(M, u_plus, 1), dim=0)
            p_ext = 0.5 * torch.sum((u + u_plus) * (tau_full - G), dim=0)
            target = torch.clamp(ke0 + dt * p_ext, min=0.0)
            u_plus = u_plus * torch.clamp(torch.sqrt(target / torch.clamp(ke1, min=1e-12)), max=1.0)[None]
        Jf, x = self.contact_jacobian(p_w, R_w, Phi)
        Jf = Jf * self.anc_rows
        phi = x[2] - self.radius[:, None]            # a flat ground at height 0
        C = None
        if self.P:
            Jp, phi_p, C = self.pair_rows(Jf.reshape(K, 3, nv, N), x)
            Jf, phi = torch.cat([Jf, Jp], dim=0), torch.cat([phi, phi_p], dim=0)
        if lam_prev is None:
            lam_cf = torch.zeros((KT, 3, N), device=self.dev)
        elif self.P:
            pair = torch.stack([sum(C[a][b] * lam_prev[K:, b] for b in range(3)) for a in range(3)], dim=1)
            lam_cf = torch.cat([lam_prev[:K], pair], dim=0)
        else:
            lam_cf = lam_prev
        idx = self.active_rows(phi)
        if idx is not None:
            cap = idx.shape[0]
            Jf = torch.gather(Jf.reshape(KT, 3 * nv, N), 0, idx[:, None].expand(cap, 3 * nv, N)).reshape(cap * 3, nv, N)
            phi = torch.gather(phi, 0, idx)
            lam_cf = torch.gather(lam_cf, 0, idx[:, None].expand(cap, 3, N))
        R = phi.shape[0]
        A = self.ein("awn,bwn->abn", self.ein("avn,vwn->awn", Jf, M_inv), Jf).contiguous()
        active = (phi < opt["contact_margin"]).to(torch.float32)
        v0 = self.rowdot(Jf, u_plus, 1).reshape(R, 3, N)
        b = v0.clone()
        b[:, 2] += prm["restitution"][None] * torch.clamp(v0[:, 2], max=0.0)
        b = b.reshape(R * 3, N)
        x0 = lam_cf.reshape(R * 3, N).contiguous()
        lam = apgd.solve(A, b, prm["friction"], active, x0, int(opt["solver_iters"]), self.precision)
        solve = {"A": A, "b": b, "mu": prm["friction"], "active": active, "x0": x0, "out": lam}
        lAl = torch.sum(lam * self.rowdot(A, lam, 1), dim=0)
        s = torch.clamp(-torch.sum(b * lam, dim=0) / torch.clamp(lAl, min=1e-12), 0.0, 1.0)
        lam = lam * torch.where(lAl > 1e-12, s, 1.0)[None]
        u_new = u_plus + self.rowdot(M_inv, torch.sum(self.r(Jf) * self.r(lam)[:, None], dim=0), 1)
        # split-impulse position pass
        b_err = torch.clamp(-opt["baumgarte"] / dt * torch.clamp(phi + opt["penetration_slop"], max=0.0),
                            max=opt["max_depenetration_velocity"])
        act3 = torch.repeat_interleave(active, 3, dim=0)
        inv_Lp = 1.0 / torch.clamp(torch.amax(act3 * torch.sum(torch.abs(A) * act3[None], dim=1), dim=0), min=1e-6)
        cp = torch.zeros((R, 3, N), device=self.dev)
        cp[:, 2] = b_err * active
        cp = cp.reshape(R * 3, N)
        lam_p = torch.zeros((R * 3, N), device=self.dev)
        for _ in range(int(opt["pos_iters"])):
            x3 = (lam_p - inv_Lp[None] * (self.rowdot(A, lam_p, 1) - cp)).reshape(R, 3, N)
            nxt = torch.zeros_like(x3)
            nxt[:, 2] = torch.clamp(x3[:, 2], min=0.0) * active
            lam_p = nxt.reshape(R * 3, N)
        dpos = dt * self.rowdot(M_inv, torch.sum(self.r(Jf) * self.r(lam_p)[:, None], dim=0), 1)
        lam3 = lam.reshape(R, 3, N)
        if idx is not None:
            lam3 = torch.zeros((KT, 3, N), device=self.dev).scatter_(0, idx[:, None].expand(idx.shape[0], 3, N), lam3)
        if self.P:
            world = torch.stack([sum(C[a][b] * lam3[K:, a] for a in range(3)) for b in range(3)], dim=1)
            lam3 = torch.cat([lam3[:K], world], dim=0)
        return self.integrate(st, u_new, dpos), lam3, solve

    def integrate(self, st, u_new, dpos):
        opt, dt = self.opt, self.opt["dt"]
        v_r = torch.clamp(u_new[:3], -opt["max_root_lin_vel"], opt["max_root_lin_vel"])
        w_r = torch.clamp(u_new[3:6], -opt["max_root_ang_vel"], opt["max_root_ang_vel"])
        qd = torch.clamp(u_new[6:], -opt["max_dof_vel"], opt["max_dof_vel"])
        q = st["q"] + qd * dt + dpos[6:]
        if opt["joint_limits"]:
            lo, hi = self.dof_limits[:, :1], self.dof_limits[:, 1:]
            below, above = q < lo, q > hi
            q = torch.clamp(q, lo, hi)
            qd = torch.where(below & (qd < 0), 0.0, qd)
            qd = torch.where(above & (qd > 0), 0.0, qd)
        rq = quat_integrate(quat_integrate(st["rq"], w_r, dt), dpos[3:6], 1.0)
        return {"rp": st["rp"] + v_r * dt + dpos[:3], "rq": rq, "rv": v_r, "rw": w_r, "q": q, "qd": qd}

    def contact_forces(self, lam_sum):
        """Impulses [KT,3,N] summed over a control step -> the mean world
        force on each body [N,B,3]."""
        f = lam_sum.permute(2, 0, 1) / (self.opt["dt"] * self.decimation)
        rows = torch.cat([f[:, :self.K], f[:, self.K:], -f[:, self.K:]], dim=1)
        cf = torch.zeros((f.shape[0], self.nb, 3), device=self.dev)
        return cf.index_add_(1, self.force_body, rows)
