"""Plain reference of one control step of the motion-tracking env (KungfuBot
v1's `MotionTrackingEnv` on the lanes engine), followed from the program's
own state.

What it works out again, from the run's config snapshot, the robot
description and the recorded step:

- the PD torques of every substep, `kp (target - q) - kd qd` with the
  delayed action's target, the random-action offset and the clip, which the
  program's torques must lie within up to its random-force draw (that draw,
  uniform in +-1 times the env's RFI scale, is the program's own);
- every substep of the engine (`reference/engine.py`) from the state the
  program entered it with and the torques it applied, with the reference's
  own contact solve; the body states and contact forces that close the step;
- the reward's columns but the termination term, from the program's
  post-step state: the penalties and limits, the feet's air time, and the
  tracking terms and contact mask against the motion's reference state one
  control step ahead (`reference/motion.py`), each with the env's sigmas.

- the observations of the envs that did not reset: the parts without noise
  exactly, the noised ones within their noise's range, the history parts
  equal to the history the step was given.

Not worked out: the terminations and the termination column (a threshold
that rounding can flip) and the reset of the envs that end their episode
(its draws are the program's).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from . import robot
from .engine import Engine
from .motion import Motion

SIM_FIELDS = ("rp", "rq", "rv", "rw", "q", "qd")
# a state field's key in the env's (env-first) state
ENV_FIRST = {"rp": "root_pos", "rq": "root_quat", "rv": "root_lin_vel", "rw": "root_ang_vel",
             "q": "dof_pos", "qd": "dof_vel"}


def rel_max(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def quat_rotate(q, v):
    """v [..., 3] rotated by the unit quaternion q [..., 4] xyzw."""
    u, w = q[..., :3], q[..., 3:4]
    u, v = torch.broadcast_tensors(u, v)
    t = 2.0 * torch.linalg.cross(u, v, dim=-1)
    return v + w * t + torch.linalg.cross(u, t, dim=-1)


def quat_rotate_inverse(q, v):
    return quat_rotate(torch.cat([-q[..., :3], q[..., 3:4]], dim=-1), v)


def quat_mul(a, b):
    x1, y1, z1, w1 = a.unbind(-1)
    x2, y2, z2, w2 = b.unbind(-1)
    return torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2, w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2, w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], dim=-1)


class Reference:
    def __init__(self, config: dict, root, device, precision: str = "float32"):
        self.dev, self.precision = torch.device(device), precision
        with open(Path(root) / config["snapshot"]) as f:
            snap = json.load(f)
        self.engine = Engine(root, snap, device, precision)
        e, rc = self.engine, snap["robot"]
        t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=self.dev)
        kp, kd, scale = [], [], []
        for n in e.tb["dof_names"]:
            got = None
            for pat, v in rc["control"]["stiffness"].items():
                if pat in n:
                    got = (float(v), float(rc["control"]["damping"][pat]))
            kp.append(got[0])
            kd.append(got[1])
            a = rc["control"]["action_scale"]
            scale.append(float(a) if not isinstance(a, dict) else [float(v) for p, v in a.items() if p in n][-1])
        self.p_gains, self.d_gains, self.action_scales = t(kp), t(kd), t(scale)
        self.torque_limits = t(rc["dof_effort_limit_list"])
        self.dof_vel_limits = t(rc["dof_vel_limit_list"])
        self.action_clip = float(rc["control"]["action_clip_value"])
        self.dr = snap["domain_rand"]
        names = e.tb["names"]
        self.feet = np.asarray([i for i, n in enumerate(names) if rc["foot_name"] in n])
        self.penalised = np.asarray([i for i, n in enumerate(names) if any(p in n for p in rc["penalize_contacts_on"])])
        sim = snap["simulator"]["config"]["sim"]
        self.dt = int(sim["control_decimation"]) / float(sim["fps"])
        rw = snap["rewards"]
        scales = {k: float(v) for k, v in rw["reward_scales"].items() if float(v) != 0.0}
        scales.pop("termination", None)
        self.columns = list(scales)
        self.scales = [scales[k] * self.dt for k in self.columns]
        self.penalised_terms = set(rw["reward_penalty_reward_names"]) if rw["reward_penalty_curriculum"] else set()
        self.rw = rw
        # the motion's reference state and the bodies the tracking terms read
        self.motion = Motion(root, snap, device)
        mc = rc["motion"]
        ext = mc["extend_config"]
        names_ext = list(names) + [x["joint_name"] for x in ext]
        self.upper = np.asarray([names_ext.index(n) for n in mc["upper_body_link"]])
        self.lower = np.asarray([names_ext.index(n) for n in mc["lower_body_link"]])
        self.tracked = np.asarray([names_ext.index(n) for n in mc["motion_tracking_link"]])
        self.ext_parent = np.asarray([names.index(x["parent_name"]) for x in ext])
        self.ext_pos = t([x["pos"] for x in ext])
        self.ext_rot = t(np.asarray([x["rot"] for x in ext])[:, [1, 2, 3, 0]])
        self.sigma_terms = list(rw["reward_tracking_sigma"])
        # the observations: the config's groups, and the inertials that the
        # domain-randomisation parts are read against
        self.snap_obs = snap["obs"]
        self.clip_obs = float((snap.get("normalization") or {}).get("clip_observations", 100.0))
        tb = robot.parse_mjcf(Path(root) / "assets" / "robots" / "g1" / f"{rc['robot_type']}.xml")
        self.rand_links = np.asarray([names.index(n) for n in self.dr.get("randomize_link_body_names", [])
                                      if n in names])
        self.base_mass = t(np.asarray(tb["mass"])[self.rand_links])
        self.base_com = t(tb["com"][0])

    # --------------------------------------------------------------- torques
    def torque_excess(self, rec) -> float:
        """How far the program's torques lie outside what the PD law, the
        random-action offset and its random-force draw allow, over the
        torque limit: worst entry of every substep."""
        pre, dr = rec["pre"], self.dr
        actions = torch.clamp(rec["actions"], -self.action_clip, self.action_clip)
        if dr.get("randomize_ctrl_delay", False):
            queue = torch.cat([actions[:, None], pre["action_queue"][:, :-1]], dim=1)
            after = queue[torch.arange(actions.shape[0], device=self.dev), pre["action_delay_idx"]]
        else:
            after = actions
        target = after * self.action_scales + pre["default_dof_pos"]
        kp, kd = pre["kp_scale"] * self.p_gains, pre["kd_scale"] * self.d_gains
        lim = self.torque_limits
        spread = float(dr["rfi_lim"]) * pre["rfi_lim_scale"] * lim if dr.get("randomize_torque_rfi", False) else 0.0
        offset = pre["rao_scale"] * lim if dr.get("use_rao", False) else 0.0
        worst = 0.0
        for s in rec["subs"]:
            pd = kp * (target - s["dof_pos"]) - kd * s["dof_vel"]
            lo = torch.clamp(pd - spread + offset, -lim, lim)
            hi = torch.clamp(pd + spread + offset, -lim, lim)
            out = torch.clamp(torch.maximum(lo - s["tau"], s["tau"] - hi), min=0.0) / lim
            worst = max(worst, float(out.max()))
        return worst

    # --------------------------------------------------------------- engine
    def follow(self, rec):
        """Each substep from the program's state entering it: (the reference's
        next states, its solves, its summed impulses)."""
        e = self.engine
        prm = rec["params"]
        lam, lam_sum, nxt, solves = None, 0.0, [], []
        for s in rec["subs"]:
            st = {k: s[ENV_FIRST[k]].T.contiguous() for k in SIM_FIELDS}
            lam_prev = lam if (lam is not None and e.opt["warm_start"]) else \
                torch.zeros((e.KT, 3, st["q"].shape[-1]), device=self.dev)
            out, lam, solve = e.substep(prm, st, s["tau"].T.contiguous(), lam_prev)
            nxt.append(out)
            solves.append(solve)
            lam_sum = lam_sum + lam
        return nxt, solves, lam_sum

    def engine_parts(self, rec, lo=None) -> dict:
        """Gaps between the program's step and the reference's, by part:
        each substep's velocity change (root and joints) over the largest
        change, its positions over the largest position, the closing body
        states and contact forces over their largest. With `lo` (the
        reference in the control's precision) the step compared is `lo`'s,
        from the same states."""
        nxt, _, lam_sum = self.follow(rec)
        subs, post = rec["subs"], rec["post_sim"]
        final = {k: post[ENV_FIRST[k]].T.contiguous() for k in SIM_FIELDS}
        if lo is None:
            ends = [{k: subs[i + 1][ENV_FIRST[k]].T for k in SIM_FIELDS} for i in range(len(subs) - 1)]
            ends.append({k: post[ENV_FIRST[k]].T for k in SIM_FIELDS})
            closing = (post["body_pos"], post["body_quat"], post["body_lin_vel"], post["body_ang_vel"])
            force = post["contact_forces"]
        else:
            ends, _, lo_sum = lo.follow(rec)
            closing, force = lo.engine.body_states(final), lo.engine.contact_forces(lo_sum)
        vel = pos = 0.0
        for s, ref, got in zip(subs, nxt, ends):
            for k in ("rv", "rw", "qd"):
                start = s[ENV_FIRST[k]].T
                vel = max(vel, rel_max(got[k] - start, ref[k] - start))
            for k in ("rp", "rq", "q"):
                pos = max(pos, rel_max(got[k], ref[k]))
        body = max(rel_max(a, b) for a, b in zip(closing, self.engine.body_states(final)))
        return {"velocity": vel, "position": pos, "body": body,
                "force": rel_max(force, self.engine.contact_forces(lam_sum))}

    # --------------------------------------------------------------- rewards
    def reward_terms(self, rec) -> dict:
        """The physics terms of the step's reward, name -> [N]."""
        pre, post = rec["pre"], rec["post_sim"]
        actions = torch.clamp(rec["actions"], -self.action_clip, self.action_clip)
        torques, rw = rec["torques"], self.rw
        norm = torch.linalg.vector_norm
        dof_pos, dof_vel, cf = post["dof_pos"], post["dof_vel"], post["contact_forces"]
        feet_cf, feet_vel = cf[:, self.feet], post["body_lin_vel"][:, self.feet]
        cf_norm = norm(feet_cf, dim=-1)
        in_contact = cf_norm > 1.0
        g = torch.tensor([0.0, 0.0, -1.0], device=self.dev).expand(dof_pos.shape[0], 3)
        gravity = quat_rotate_inverse(post["root_quat"], g)
        r = {
            "penalty_torques": (torques ** 2).sum(-1),
            "penalty_dof_vel": (dof_vel ** 2).sum(-1),
            "penalty_dof_acc": (((pre["last_dof_vel"] - dof_vel) / self.dt) ** 2).sum(-1),
            "penalty_action_rate": ((pre["last_actions"] - actions) ** 2).sum(-1),
            "penalty_orientation": (gravity[:, :2] ** 2).sum(-1),
            "penalty_slippage": (norm(feet_vel, dim=-1) * in_contact).sum(-1),
            "penalty_feet_contact_forces": torch.clamp(cf_norm - float(rw["locomotion_max_contact_force"]),
                                                       min=0.0).sum(-1),
            "penalty_stumble": torch.any(norm(feet_cf[..., :2], dim=-1) > 5.0 * torch.abs(feet_cf[..., 2]),
                                         dim=-1).to(torch.float32),
            "collision": (norm(cf[:, self.penalised], dim=-1) > 0.1).to(torch.float32).sum(-1),
            "foot_slip_penalty": (in_contact * norm(feet_vel[..., :2], dim=-1)).sum(-1),
        }
        touch = (feet_cf[..., 2] > 1.0) | (pre["last_contacts"] > 0)
        first = (pre["feet_air_time"] > 0) & touch
        r["feet_air_time"] = ((pre["feet_air_time"] + self.dt - float(rw["desired_feet_air_time"])) * first).sum(-1)
        r.update(self.tracking_terms(rec, touch=(cf_norm > 1.0)))
        lim = self.engine.dof_limits
        mid, rng = (lim[:, 0] + lim[:, 1]) / 2, lim[:, 1] - lim[:, 0]
        soft = pre["soft_dof_pos_limit"]
        r["limits_dof_pos"] = (torch.clamp(mid - 0.5 * rng * soft - dof_pos, min=0.0)
                               + torch.clamp(dof_pos - (mid + 0.5 * rng * soft), min=0.0)).sum(-1)
        r["limits_dof_vel"] = torch.clamp(torch.abs(dof_vel) - self.dof_vel_limits * pre["soft_dof_vel_limit"],
                                          0.0, 1.0).sum(-1)
        r["limits_torque"] = torch.clamp(torch.abs(torques) - self.torque_limits * pre["soft_torque_limit"],
                                         0.0, 1.0).sum(-1)
        return r

    def reference_state(self, rec):
        """The motion's reference one control step after the step's end."""
        pre = rec["pre"]
        return self.motion.state((pre["episode_length"] + 2).to(torch.float32) * self.dt + pre["motion_start_times"])

    def extended(self, post):
        """Every body's pose and velocity, the virtual hand and head bodies
        appended: (pos, quat, lin_vel, ang_vel), each [N, B + 3, *]."""
        pid = self.ext_parent
        pq, pp = post["body_quat"][:, pid], post["body_pos"][:, pid]
        ext_pos = quat_rotate(pq, self.ext_pos.expand(pq.shape[:-1] + (3,))) + pp
        ext_w = post["body_ang_vel"][:, pid]
        return (torch.cat([post["body_pos"], ext_pos], 1),
                torch.cat([post["body_quat"], quat_mul(pq, self.ext_rot.expand(pq.shape))], 1),
                torch.cat([post["body_lin_vel"], post["body_lin_vel"][:, pid]
                           + torch.linalg.cross(ext_w, ext_pos - pp, dim=-1)], 1),
                torch.cat([post["body_ang_vel"], ext_w], 1))

    # ---------------------------------------------------------- observations
    def observation_gap(self, rec) -> float:
        """The observations of the envs that did not reset: every part
        without noise over its largest entry; every noised part by how far
        it lies outside its noise's range, over that range; the history
        parts against the history the step was given, exactly."""
        keep = ~rec["done"]
        if not bool(keep.any()):
            return 0.0
        pre, post, o = rec["pre"], rec["post_sim"], self.snap_obs
        quat = post["root_quat"]
        g = torch.tensor([0.0, 0.0, -1.0], device=self.dev).expand(quat.shape[0], 3)
        ref = self.reference_state(rec)
        body_pos = self.extended(post)[0]
        x_axis = torch.tensor([1.0, 0.0, 0.0], device=self.dev).expand(quat.shape[0], 3)
        r = quat_rotate(quat, x_axis)
        half = -torch.atan2(r[:, 1], r[:, 0]) * 0.5
        z = torch.zeros_like(half)
        heading_inv = torch.stack([z, z, torch.sin(half), torch.cos(half)], -1)[:, None, :]
        local = lambda v: quat_rotate(heading_inv.expand(v.shape[:-1] + (4,)), v).reshape(v.shape[0], -1)
        times = (pre["episode_length"] + 2).to(torch.float32) * self.dt + pre["motion_start_times"]
        prm = rec["params"]
        raw = {
            "base_lin_vel": quat_rotate_inverse(quat, post["root_lin_vel"]),
            "base_ang_vel": quat_rotate_inverse(quat, post["root_ang_vel"]),
            "projected_gravity": quat_rotate_inverse(quat, g),
            "dof_pos": post["dof_pos"] - pre["default_dof_pos"], "dof_vel": post["dof_vel"],
            "actions": torch.clamp(rec["actions"], -self.action_clip, self.action_clip),
            "ref_motion_phase": torch.clamp(times / pre["motion_len"], 0.0, 1.05)[:, None],
            "dif_local_rigid_body_pos": local(ref["rg_pos"] - body_pos),
            "local_ref_rigid_body_pos": local(ref["rg_pos"] - post["root_pos"][:, None, :]),
            "dr_base_com": prm["com"][:, 0].T - self.base_com,
            "dr_link_mass": prm["mass"][self.rand_links].T / self.base_mass,
            "dr_friction": prm["friction"][:, None],
            "dr_kp": pre["kp_scale"], "dr_kd": pre["kd_scale"],
            "dr_ctrl_delay": pre["action_delay_idx"][:, None].to(torch.float32),
        }
        worst = 0.0
        for group, names in o["obs_dict"].items():
            got, off = rec["obs"][group][keep].double(), 0
            for name in sorted(names):
                hist = o.get("obs_auxiliary", {}).get(name)
                if hist:
                    want = torch.cat([pre["history"][k][:, :n].reshape(keep.shape[0], -1)
                                      for k, n in sorted(hist.items())], dim=-1)
                else:
                    want = raw[name] * float(o["obs_scales"].get(name, 1.0))
                want = torch.clamp(want[keep].double(), -self.clip_obs, self.clip_obs)
                part = got[:, off:off + want.shape[-1]]
                off += want.shape[-1]
                noise = 0.0 if hist else float(o["noise_scales"].get(name, 0.0)) * float(o["obs_scales"].get(name, 1.0))
                gap = float((part - want).abs().max())
                if noise > 0:
                    worst = max(worst, max(gap - noise, 0.0) / noise)
                else:
                    top = max(float(want.abs().max()), float(part.abs().max()))
                    worst = max(worst, gap / top if top > 0 else 0.0)
            if off != got.shape[-1]:
                raise ValueError(f"the program's {group} is {got.shape[-1]} wide, the reference's {off}")
        return worst

    def tracking_terms(self, rec, touch) -> dict:
        """The terms that read the motion's reference state one control step
        ahead of the step's end, and the contact mask, name -> [N]."""
        pre, rw = rec["pre"], self.rw
        ref = self.reference_state(rec)
        body_pos, body_quat, body_vel, body_w = self.extended(rec["post_sim"])
        post = rec["post_sim"]
        d_pos, d_rot = ref["rg_pos"] - body_pos, ref["rb_rot"] - body_quat
        d_vel, d_w = ref["body_vel"] - body_vel, ref["body_ang_vel"] - body_w
        d_q, d_qd = ref["dof_pos"] - post["dof_pos"], ref["dof_vel"] - post["dof_vel"]
        sig = {k: pre["sigma_values"][i] for i, k in enumerate(self.sigma_terms)}
        track = lambda err, term: torch.exp(-err / sig[term])
        msq = lambda x: (x ** 2).mean(-1).mean(-1)
        r = {
            "teleop_body_position_extend": (track(msq(d_pos[:, self.lower]), "teleop_lower_body_pos")
                                            * float(rw["teleop_body_pos_lowerbody_weight"])
                                            + track(msq(d_pos[:, self.upper]), "teleop_upper_body_pos")
                                            * float(rw["teleop_body_pos_upperbody_weight"])),
            "teleop_vr_3point": track(msq(d_pos[:, self.tracked]), "teleop_vr_3point_pos"),
            "teleop_body_position_feet": track(msq(d_pos[:, self.feet]), "teleop_feet_pos"),
            "teleop_body_rotation_extend": track(msq(d_rot), "teleop_body_rot"),
            "teleop_body_velocity_extend": track(msq(d_vel), "teleop_body_vel"),
            "teleop_body_ang_velocity_extend": track(msq(d_w), "teleop_body_ang_vel"),
            "teleop_joint_position": track((d_q ** 2).mean(-1), "teleop_joint_pos"),
            "teleop_joint_velocity": track((d_qd ** 2).mean(-1), "teleop_joint_vel"),
            "teleop_max_joint_position": track(torch.abs(d_q).amax(-1), "teleop_max_joint_pos"),
        }
        filt = ((touch.to(torch.float32) > 0) | (pre["last_contacts"] > 0)).to(torch.float32)
        err = torch.abs(filt - ref["contact_mask"]).mean(-1)
        r["teleop_contact_mask"], r["teleop_contact_mask_v2"] = 1.0 - err, 0.5 - err
        return {k: v for k, v in r.items() if k in self.columns}

    def reward_gap(self, rec) -> float:
        """The worst physics column of the reward vector: max |a - b| over
        the larger of the two columns' largest entries (a column that is
        all zero in both reads 0)."""
        terms = self.reward_terms(rec)
        worst = 0.0
        for i, (name, scale) in enumerate(zip(self.columns, self.scales)):
            if name not in terms:
                continue
            want = terms[name] * scale
            if name in self.penalised_terms:
                want = want * rec["pre"]["reward_penalty_scale"]
            want = torch.nan_to_num(want, nan=0.0, posinf=0.0, neginf=0.0).double()
            got = rec["rew"][:, i].double()
            top = max(float(want.abs().max()), float(got.abs().max()))
            if top > 0:
                worst = max(worst, float((got - want).abs().max()) / top)
        return worst

    def parts(self, rec, lo=None) -> dict:
        """Every part's gap: the program's (or, with `lo`, the control's:
        its torques and rewards are the program's, which the precision of
        a product does not reach)."""
        parts = self.engine_parts(rec, lo)
        if lo is None:
            parts["torque"] = self.torque_excess(rec)
            parts["reward"] = self.reward_gap(rec)
            parts["observation"] = self.observation_gap(rec)
        return parts
