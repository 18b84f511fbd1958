"""Motion-tracking RL environment in torch, lanes branch (counterpart of
`pbhc_tpu/envs/tracking_env.py`).

One batched state (`EnvState`, leading env axis) and step/reset functions with
masked `torch.where` resets, so a rollout never leaves the device and never
synchronises with the host. Randomness comes from one `torch.Generator` on the
env's device, drawn only where the config turns a random feature on. Its draws
differ from JAX's threefry, so parity tests turn randomness off.

This slice ports the `solver: lanes` branch. The soft-dynamic-correction hook,
heightfield terrain, the OU observation-noise process, teleop and the
env-first solvers raise `NotImplementedError` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from pbhc_tpu_torch.maths import rotations as rot
from pbhc_tpu_torch.model.g1 import load_g1_motion_model, load_g1_sim_model
from pbhc_tpu_torch.motion.motion_lib import MotionLib, get_motion_state, sample_time
from pbhc_tpu_torch.sim.engine import Engine, EngineOptions, SimState, tree_map
from pbhc_tpu_torch.sim.engine_lanes import LanesEngine


@dataclasses.dataclass
class EnvState:
    """Batched env state (`tracking_env.py:38`; the JAX `rng` key lives in the
    env's generator here)."""

    sim: SimState
    episode_length: torch.Tensor       # [N] int64
    actions: torch.Tensor              # [N,nd]
    last_actions: torch.Tensor
    actions_after_delay: torch.Tensor
    last_dof_vel: torch.Tensor
    torques: torch.Tensor
    action_queue: torch.Tensor         # [N,Q,nd]
    action_delay_idx: torch.Tensor     # [N] int64
    contacts: torch.Tensor             # [N,2]
    contacts_filt: torch.Tensor
    last_contacts: torch.Tensor
    last_contacts_filt: torch.Tensor
    feet_air_time: torch.Tensor
    motion_ids: torch.Tensor           # [N] int64
    motion_start_times: torch.Tensor   # [N]
    motion_len: torch.Tensor           # [N]
    motion_fail_ema: torch.Tensor      # [M]
    terrain_level: torch.Tensor        # [N] int64
    origin_shift: torch.Tensor         # [N,3]
    kp_scale: torch.Tensor             # [N,nd]
    kd_scale: torch.Tensor
    rfi_lim_scale: torch.Tensor
    rao_scale: torch.Tensor
    default_dof_pos: torch.Tensor
    push_counter: torch.Tensor         # [N] int64
    push_interval: torch.Tensor        # [N] int64
    average_episode_length: torch.Tensor  # 0-d curricula scalars
    reward_penalty_scale: torch.Tensor
    motion_far_threshold: torch.Tensor
    dof_far_threshold: torch.Tensor
    soft_dof_pos_limit: torch.Tensor
    soft_dof_vel_limit: torch.Tensor
    soft_torque_limit: torch.Tensor
    sdc_alpha: torch.Tensor
    noise_curriculum_value: torch.Tensor
    noise_ou: torch.Tensor             # [N,6]
    sigma_values: torch.Tensor         # [S]
    sigma_ema: torch.Tensor            # [S]
    history: Dict[str, torch.Tensor]   # key -> [N,len,dim]
    last_episode_length: torch.Tensor  # [N]


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1 item {item})")


class MotionTrackingEnv:
    """Config-derived constants + step/reset functions (`tracking_env.py:99`)."""

    def __init__(self, config, num_envs: int, device="cuda", seed: int = 0):
        self.config = config
        self.num_envs = num_envs
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        rcfg = config.robot
        ecfg = config.env.config
        sim_cfg = config.simulator.config

        if str(sim_cfg.get("solver", "apgd")) != "lanes":
            raise _not_ported(f"solver={sim_cfg.get('solver')!r} (env-first engine)", 10)
        if bool(ecfg.soft_dynamic_correction.get("enable", False)):
            raise _not_ported("soft dynamic correction", "7b")
        ter = config.get("terrain")
        if ter is not None and str(ter.get("mesh_type", "plane")) in ("heightfield", "trimesh"):
            raise _not_ported("heightfield terrain", 10)
        if bool(ecfg.get("use_teleop_control", False)):
            raise _not_ported("teleop control", "7b")
        np_cfg = config.obs.get("noise_process")
        if np_cfg and bool(np_cfg.get("enable", False)):
            raise _not_ported("the OU observation-noise process", "7b")
        self.terrain = None

        self_coll = bool(rcfg.get("self_collision", True))
        self.sim_model = load_g1_sim_model(rcfg.robot_type, self_collision=self_coll)
        extend_cfg = [dict(e) for e in rcfg.motion.extend_config]
        self.motion_model = load_g1_motion_model(rcfg.robot_type, extend_cfg)
        arm_cfg = rcfg.get("asset", {}).get("dof_armature")
        if arm_cfg:
            arm = np.asarray([float(arm_cfg[n]) for n in self.sim_model.dof_names])
            self.sim_model = dataclasses.replace(self.sim_model, dof_armature=arm)

        self.decimation = int(sim_cfg.sim.control_decimation)
        self.sim_dt = 1.0 / float(sim_cfg.sim.fps)
        self.dt = self.decimation * self.sim_dt
        self.engine = Engine(
            self.sim_model,
            EngineOptions(dt=self.sim_dt,
                          solver_iters=int(sim_cfg.get("solver_iters", 32)),
                          self_collision=self_coll,
                          contact_cap=int(sim_cfg.get("contact_cap", 0)),
                          pair_cap=int(sim_cfg.get("pair_cap", 4)),
                          warm_start=bool(sim_cfg.get("warm_start", True)),
                          pos_iters=int(sim_cfg.get("pos_iters", 8)),
                          contact_matvec_dtype=str(sim_cfg.get("contact_matvec_dtype", "float32"))),
            device=self.device)
        self.lanes_engine = LanesEngine(self.engine)
        self.nd, self.nb = self.engine.nd, self.engine.nb
        self.num_extend = len(extend_cfg)
        dev = self.device
        f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)

        # index bookkeeping (`tracking_env.py:193-214`)
        names = self.sim_model.body_names
        names_ext = list(names) + [e["joint_name"] for e in extend_cfg]
        self.feet_indices = np.asarray([names.index(n) for n in names if rcfg.foot_name in n])
        self.penalised_contact_indices = np.asarray(
            [i for i, n in enumerate(names) if any(p in n for p in rcfg.penalize_contacts_on)])
        self.termination_contact_indices = np.asarray(
            [i for i, n in enumerate(names) if any(p in n for p in rcfg.terminate_after_contacts_on)])
        self.upper_body_id = np.asarray([names_ext.index(n) for n in rcfg.motion.upper_body_link])
        self.lower_body_id = np.asarray([names_ext.index(n) for n in rcfg.motion.lower_body_link])
        self.motion_tracking_id = np.asarray([names_ext.index(n) for n in rcfg.motion.motion_tracking_link])
        self.extend_parent_ids = np.asarray([names.index(e["parent_name"]) for e in extend_cfg])
        self.extend_pos = f32([e["pos"] for e in extend_cfg])
        self.extend_rot_xyzw = f32(np.asarray([e["rot"] for e in extend_cfg])[:, [1, 2, 3, 0]])

        # PD / limits (`tracking_env.py:217-245`)
        default_angles = rcfg.init_state.default_joint_angles
        q0, kp, kd, ascale = [], [], [], []
        for n in self.sim_model.dof_names:
            q0.append(float(default_angles[n]))
            got = None
            for pat, v in rcfg.control.stiffness.items():
                if pat in n:
                    got = (float(v), float(rcfg.control.damping[pat]))
            if got is None:
                raise ValueError(f"no PD gain for {n}")
            kp.append(got[0])
            kd.append(got[1])
            a = rcfg.control.action_scale
            if isinstance(a, dict):
                val = None
                for pat, v in a.items():
                    if pat in n:
                        val = float(v)
                if val is None:
                    raise ValueError(f"no action_scale for {n}")
                ascale.append(val)
            else:
                ascale.append(float(a))
        self.raw_default_dof_pos = f32(q0)
        self.p_gains, self.d_gains, self.action_scales = f32(kp), f32(kd), f32(ascale)
        self.torque_limits = f32(rcfg.dof_effort_limit_list)
        self.dof_vel_limits = f32(rcfg.dof_vel_limit_list)
        self.dof_pos_limits = f32(self.sim_model.dof_limits)
        self.action_clip = float(rcfg.control.action_clip_value)
        self.clip_obs = float(config.get_path("normalization.clip_observations", 100.0))
        self.num_actions = int(rcfg.get("actions_dim", self.nd))
        self.only_track_leg = bool(rcfg.get("only_track_leg", False))
        if not self.only_track_leg and self.num_actions != self.nd:
            raise ValueError(f"actions_dim={self.num_actions} != num_dof={self.nd} requires only_track_leg")

        self.motion_lib = MotionLib(rcfg.motion.motion_file, self.motion_model, num_envs, self.dt,
                                    fix_height=str(rcfg.motion.get("fix_height", "no_fix")),
                                    device=dev)

        self.dr = config.domain_rand
        self.sim_params, self.dr_obs = self._sample_sim_params()
        self.paramsT = LanesEngine.params_to_lanes(self.sim_params)

        # rewards (`tracking_env.py:272-283`)
        scales = {k: float(v) for k, v in config.rewards.reward_scales.items() if float(v) != 0.0}
        self.termination_scale = scales.pop("termination", 0.0) * self.dt
        self.reward_names = list(scales.keys())
        self.reward_scales = [scales[k] * self.dt for k in self.reward_names]
        penalised = list(config.rewards.reward_penalty_reward_names)
        self.penalty_mask = [k in penalised for k in self.reward_names]
        self.use_vec_reward = bool(ecfg.get("use_vec_reward", True))
        self.num_rew_fn = (len(self.reward_names) + 1) if self.use_vec_reward else 1
        self.sigma_terms = list(config.rewards.reward_tracking_sigma.keys())
        self.sigma_init = f32([float(config.rewards.reward_tracking_sigma[t]) for t in self.sigma_terms])

        self.obs_dims = {k: int(v) for k, v in config.obs.obs_dims.items()}
        self.history_spec = {group: {k: int(v) for k, v in sorted(dict(spec).items())}
                             for group, spec in config.obs.obs_auxiliary.items()}
        self.max_episode_length_s = float(ecfg.max_episode_length_s)
        self.max_episode_length = int(np.ceil(self.max_episode_length_s / self.dt))
        self.ecfg = ecfg
        self._gravity_vec = f32([0.0, 0.0, -1.0])

    # ------------------------------------------------------------ random draws
    def _uniform(self, shape, lo, hi):
        lo = torch.as_tensor(lo, dtype=torch.float32, device=self.device)
        hi = torch.as_tensor(hi, dtype=torch.float32, device=self.device)
        return lo + (hi - lo) * torch.rand(shape, generator=self.gen, device=self.device)

    def _randint(self, shape, lo, hi):
        """Integers in [lo, hi)."""
        return torch.randint(int(lo), int(hi), shape, generator=self.gen, device=self.device)

    # ------------------------------------------------------------------ DR
    def _sample_sim_params(self):
        """Build-time DR (`tracking_env.py:292`)."""
        N, m, dr = self.num_envs, self.sim_model, self.dr
        base = self.engine.default_params()
        mass = base.mass.expand(N, self.nb).clone()
        inertia = base.inertia.expand(N, self.nb, 3, 3).clone()
        com = base.com.expand(N, self.nb, 3).clone()
        dev = self.device

        rand_names = list(dr.get("randomize_link_body_names", []))
        rand_idx = np.asarray([m.body_names.index(n) for n in rand_names if n in m.body_names], dtype=np.int64)
        link_mass_scale = torch.ones((N, max(len(rand_idx), 1)), device=dev)
        if dr.get("randomize_link_mass", False) and len(rand_idx):
            link_mass_scale = self._uniform((N, len(rand_idx)), *dr.link_mass_range)
            mass[:, rand_idx] *= link_mass_scale
            inertia[:, rand_idx] *= link_mass_scale[..., None, None]
        if dr.get("randomize_link_inertia", False) and len(rand_idx):
            inertia[:, rand_idx] *= self._uniform((N, len(rand_idx)), *dr.link_inertia_range)[..., None, None]
        hu = dr.get("heavy_upper", {})
        if hu and bool(hu.get("enable", False)):
            ratio = float(hu.get("ratio", 1.1))
            hu_idx = np.asarray([m.body_names.index(n) for n in hu.get("body_names", [])
                                 if n in m.body_names], dtype=np.int64)
            if len(hu_idx):
                mass[:, hu_idx] *= ratio
                inertia[:, hu_idx] *= ratio
        base_added_mass = torch.zeros((N,), device=dev)
        if dr.get("randomize_base_mass", False):
            base_idx = m.body_names.index("pelvis") if "pelvis" in m.body_names \
                else m.body_names.index("torso_link")
            base_added_mass = self._uniform((N,), *dr.added_mass_range)
            mass[:, base_idx] += base_added_mass
        base_com_bias = torch.zeros((N, 3), device=dev)
        if dr.get("randomize_base_com", False):
            r = dr.base_com_range
            base_com_bias = self._uniform((N, 3), [r.x[0], r.y[0], r.z[0]], [r.x[1], r.y[1], r.z[1]])
            com[:, 0] += base_com_bias
        friction = torch.ones((N,), device=dev)
        if dr.get("randomize_friction", False):
            friction = self._uniform((N,), *dr.friction_range)
        restitution = torch.full((N,), float((self.config.get("terrain") or {}).get("restitution", 0.0)),
                                 device=dev)
        if dr.get("randomize_restitution", False):
            restitution = self._uniform((N,), *dr.restitution_range)
        params = dataclasses.replace(
            base, mass=mass, com=com, inertia=inertia, friction=friction, restitution=restitution,
            armature=base.armature.expand(N, self.nd), dof_damping=base.dof_damping.expand(N, self.nd),
            dof_frictionloss=base.dof_frictionloss.expand(N, self.nd))
        dr_obs = {"base_com": base_com_bias, "base_mass": base_added_mass[:, None],
                  "link_mass": link_mass_scale, "friction": friction[:, None]}
        return params, dr_obs

    def _episodic_dr(self, N):
        """kp/kd/rfi/rao scales, delay, default pos (`tracking_env.py:404`)."""
        dr, nd, dev = self.dr, self.nd, self.device
        one = torch.ones((N, nd), device=dev)
        pd = dr.get("randomize_pd_gain", False)
        kp_scale = self._uniform((N, nd), *dr.kp_range) if pd else one
        kd_scale = self._uniform((N, nd), *dr.kd_range) if pd else one
        pspd = dr.get("parallel_serial_pd", {})
        if pspd and bool(pspd.get("enable", False)):
            jidx = np.asarray(list(pspd.joint_idx), dtype=np.int64)
            kp_scale = kp_scale.clone()
            kd_scale = kd_scale.clone()
            kp_scale[:, jidx] *= self._uniform((N, len(jidx)), *pspd.ratio)
            kd_scale[:, jidx] *= self._uniform((N, len(jidx)), *pspd.ratio)
        rfi = self._uniform((N, nd), *dr.rfi_lim_range) if dr.get("randomize_rfi_lim", False) else one
        rao = self._uniform((N, nd), -dr.rao_lim, dr.rao_lim) if dr.get("use_rao", False) \
            else torch.zeros((N, nd), device=dev)
        pstau = dr.get("parallel_serial_tau", {})
        if pstau and bool(pstau.get("enable", False)):
            tidx = np.asarray(list(pstau.joint_idx), dtype=np.int64)
            rao = rao.clone()
            rao[:, tidx] += float(pstau.rao_lim) * torch.randn((N, len(tidx)), generator=self.gen, device=dev)
        if dr.get("randomize_ctrl_delay", False):
            lo, hi = dr.ctrl_delay_step_range
            delay = self._randint((N,), lo, hi + 1)
        else:
            delay = torch.zeros((N,), dtype=torch.int64, device=dev)
        default_dof = self.raw_default_dof_pos.expand(N, nd)
        if dr.get("randomize_default_dof_pos", False):
            default_dof = default_dof + self._uniform((N, nd), *dr.dof_pos_range)
        return kp_scale, kd_scale, rfi, rao, delay, default_dof

    def _extend_body_states(self, sim: SimState):
        """FK of the virtual hand/head bodies (`tracking_env.py:445`)."""
        pid = self.extend_parent_ids
        pq, pp = sim.body_quat[:, pid], sim.body_pos[:, pid]
        pos = rot.quat_rotate(pq, self.extend_pos.expand(pq.shape[:-1] + (3,))) + pp
        quat = rot.quat_mul(pq, self.extend_rot_xyzw.expand(pq.shape))
        ang_vel = sim.body_ang_vel[:, pid]
        lin_vel = sim.body_lin_vel[:, pid] + rot.cross(ang_vel, pos - pp)
        return (torch.cat([sim.body_pos, pos], 1), torch.cat([sim.body_quat, quat], 1),
                torch.cat([sim.body_lin_vel, lin_vel], 1), torch.cat([sim.body_ang_vel, ang_vel], 1))

    def _motion_state_at(self, state: EnvState, step_offset=1):
        t = (state.episode_length + step_offset).to(torch.float32) * self.dt + state.motion_start_times
        return get_motion_state(self.motion_lib.data, state.motion_ids, t), t

    @staticmethod
    def _compute_diffs(sim, mres, body_pos, body_quat, body_vel, body_ang_vel):
        """`tracking_env.py:467`."""
        return {
            "dif_body_pos": mres["rg_pos_t"] - body_pos,
            "dif_body_rot": mres["rg_rot_t"] - body_quat,
            "dif_body_vel": mres["body_vel_t"] - body_vel,
            "dif_body_ang_vel": mres["body_ang_vel_t"] - body_ang_vel,
            "dif_joint_pos": mres["dof_pos"] - sim.dof_pos,
            "dif_joint_vel": mres["dof_vel"] - sim.dof_vel,
        }

    def _extra_terminations(self, term, rs, state):
        """Subclass hook for additional termination conditions."""
        return term

    def _scalar(self, v):
        return torch.tensor(float(v), dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------ reset
    def init_state(self) -> EnvState:
        """`tracking_env.py:484`."""
        N, nd, dev = self.num_envs, self.nd, self.device
        sim0 = tree_map(lambda x: x.expand((N,) + x.shape).clone(), self.engine.default_state())
        kp_s, kd_s, rfi, rao, delay, ddof = self._episodic_dr(N)
        Q = int(self.dr.get("ctrl_delay_step_range", [0, 2])[1]) + 1
        key_len: Dict[str, int] = {}
        for spec in self.history_spec.values():
            for k, n in spec.items():
                key_len[k] = max(key_len.get(k, 0), n)
        hist = {k: torch.zeros((N, n, self.obs_dims[k]), device=dev) for k, n in key_len.items()}
        zero = torch.zeros((N, nd), device=dev)
        z2 = torch.zeros((N, 2), device=dev)
        ecfg, rcfg = self.ecfg, self.config.rewards
        tc, lc = ecfg.termination_curriculum, rcfg.reward_limit.reward_limits_curriculum
        state = EnvState(
            sim=sim0,
            episode_length=torch.zeros((N,), dtype=torch.int64, device=dev),
            actions=zero, last_actions=zero, actions_after_delay=zero, last_dof_vel=zero, torques=zero,
            action_queue=torch.zeros((N, Q, nd), device=dev), action_delay_idx=delay,
            contacts=z2, contacts_filt=z2, last_contacts=z2, last_contacts_filt=z2, feet_air_time=z2,
            motion_ids=torch.zeros((N,), dtype=torch.int64, device=dev),
            motion_start_times=torch.zeros((N,), device=dev),
            motion_len=self.motion_lib.data.lengths[0].expand(N).clone(),
            motion_fail_ema=torch.zeros((self.motion_lib.num_unique,), device=dev),
            terrain_level=torch.zeros((N,), dtype=torch.int64, device=dev),
            origin_shift=torch.zeros((N, 3), device=dev),
            kp_scale=kp_s, kd_scale=kd_s, rfi_lim_scale=rfi, rao_scale=rao, default_dof_pos=ddof,
            push_counter=torch.zeros((N,), dtype=torch.int64, device=dev),
            push_interval=self._sample_push_interval(N),
            average_episode_length=self._scalar(0.0),
            reward_penalty_scale=self._scalar(rcfg.reward_initial_penalty_scale),
            motion_far_threshold=self._scalar(
                tc.terminate_when_motion_far_initial_threshold
                if tc.terminate_when_motion_far_curriculum
                else ecfg.termination_scales.termination_motion_far_threshold),
            dof_far_threshold=self._scalar(tc.terminate_when_dof_far_curriculum.init),
            soft_dof_pos_limit=self._scalar(lc.soft_dof_pos_initial_limit),
            soft_dof_vel_limit=self._scalar(lc.soft_dof_vel_initial_limit),
            soft_torque_limit=self._scalar(lc.soft_torque_initial_limit),
            sdc_alpha=self._scalar(ecfg.soft_dynamic_correction.get("alpha", 0.0)),
            noise_curriculum_value=self._scalar(
                self.config.obs.noise_initial_value
                if bool(self.config.obs.get("add_noise_currculum", False)) else 1.0),
            noise_ou=torch.zeros((N, 6), device=dev),
            sigma_values=self.sigma_init.clone(), sigma_ema=self.sigma_init.clone(),
            history=hist,
            last_episode_length=torch.zeros((N,), dtype=torch.int64, device=dev),
        )
        return self._reset_envs(state, torch.ones((N,), dtype=torch.bool, device=dev))

    def _sample_push_interval(self, N):
        lo, hi = self.dr.get("push_interval_s", [5, 10])
        secs = self._randint((N,), lo, hi)
        return (secs.to(torch.float32) / self.dt).to(torch.int64)

    def reset_to_start(self, state: EnvState) -> EnvState:
        """Every env to motion t=0 with its current motion id (`tracking_env.py:565`)."""
        N = self.num_envs
        return self._reset_envs(state, torch.ones((N,), dtype=torch.bool, device=self.device),
                                force_start_times=torch.zeros((N,), device=self.device),
                                resample_ids=False)

    def _reset_envs(self, state: EnvState, mask, force_start_times=None, resample_ids=True) -> EnvState:
        """Masked reset from the reference pose (`tracking_env.py:574`)."""
        N, nd, dev = self.num_envs, self.nd, self.device
        ecfg = self.ecfg
        data = self.motion_lib.data
        motion_ids = state.motion_ids
        if self.motion_lib.num_unique > 1 and resample_ids:
            probs = data.sampling_prob
            asc = ecfg.get("adaptive_motion_sampling")
            if asc and bool(asc.get("enabled", False)):
                umix = float(asc.get("uniform_mix", 0.5))
                w = state.motion_fail_ema + 1e-3
                probs = umix * probs + (1.0 - umix) * w / w.sum()
            new_ids = torch.multinomial(probs, N, replacement=True, generator=self.gen)
            motion_ids = torch.where(mask, new_ids, motion_ids)
        new_start = sample_time(data, motion_ids, self.gen) if force_start_times is None \
            else force_start_times
        motion_start = torch.where(mask, new_start, state.motion_start_times)
        motion_len = torch.where(mask, data.lengths[motion_ids], state.motion_len)
        episode_length = torch.where(mask, 0, state.episode_length)
        t = (episode_length + 1).to(torch.float32) * self.dt + motion_start
        mres = get_motion_state(data, motion_ids, t)

        nl = float(ecfg.noise_to_initial_level)
        root_pos, root_quat = mres["root_pos"], mres["root_rot"]
        root_vel, root_ang = mres["root_vel"], mres["root_ang_vel"]
        dof_pos, dof_vel = mres["dof_pos"], mres["dof_vel"]
        if nl != 0.0:
            ins = ecfg.init_noise_scale
            rn = lambda *s: torch.randn(s, generator=self.gen, device=dev)
            root_pos = root_pos + rn(N, 3) * float(ins.root_pos) * nl
            root_quat = rot.quat_mul(rot.small_random_quat((N,), float(ins.root_rot) * 3.14 / 180 * nl,
                                                           self.gen, dev), root_quat)
            root_vel = root_vel + rn(N, 3) * float(ins.root_vel) * nl
            root_ang = root_ang + rn(N, 3) * float(ins.root_ang_vel) * nl
            dof_pos = dof_pos + rn(N, nd) * float(ins.dof_pos) * nl
            dof_vel = dof_vel + rn(N, nd) * float(ins.dof_vel) * nl

        m1 = mask[:, None]
        s = state.sim
        sim = dataclasses.replace(
            s, root_pos=torch.where(m1, root_pos, s.root_pos),
            root_quat=torch.where(m1, root_quat, s.root_quat),
            root_lin_vel=torch.where(m1, root_vel, s.root_lin_vel),
            root_ang_vel=torch.where(m1, root_ang, s.root_ang_vel),
            dof_pos=torch.where(m1, dof_pos, s.dof_pos), dof_vel=torch.where(m1, dof_vel, s.dof_vel))
        if nl == 0.0:
            # zero init noise: the reset state IS the reference state, so the
            # pre-FK'd library body states are exact (`tracking_env.py:660-675`)
            nb, m3 = self.nb, mask[:, None, None]
            sim = dataclasses.replace(
                sim, body_pos=torch.where(m3, mres["rg_pos"][:, :nb], s.body_pos),
                body_quat=torch.where(m3, mres["rb_rot"][:, :nb], s.body_quat),
                body_lin_vel=torch.where(m3, mres["body_vel"][:, :nb], s.body_lin_vel),
                body_ang_vel=torch.where(m3, mres["body_ang_vel"][:, :nb], s.body_ang_vel))
        else:
            sim = self.engine.derived_state(self.sim_params, sim)

        kp_s, kd_s, rfi, rao, delay, ddof = self._episodic_dr(N)
        w2 = lambda new, old: torch.where(m1, new, old)
        zero = torch.zeros((N, nd), device=dev)
        m3 = mask[:, None, None]
        return dataclasses.replace(
            state, sim=sim, motion_ids=motion_ids, episode_length=episode_length,
            motion_start_times=motion_start, motion_len=motion_len,
            actions=w2(zero, state.actions), last_actions=w2(zero, state.last_actions),
            actions_after_delay=w2(zero, state.actions_after_delay),
            last_dof_vel=w2(zero, state.last_dof_vel),
            action_queue=torch.where(m3, 0.0, state.action_queue),
            action_delay_idx=torch.where(mask, delay, state.action_delay_idx),
            kp_scale=w2(kp_s, state.kp_scale), kd_scale=w2(kd_s, state.kd_scale),
            rfi_lim_scale=w2(rfi, state.rfi_lim_scale), rao_scale=w2(rao, state.rao_scale),
            default_dof_pos=w2(ddof, state.default_dof_pos),
            contacts=torch.where(m1, 0.0, state.contacts),
            contacts_filt=torch.where(m1, 0.0, state.contacts_filt),
            last_contacts=torch.where(m1, 0.0, state.last_contacts),
            last_contacts_filt=torch.where(m1, 0.0, state.last_contacts_filt),
            feet_air_time=torch.where(m1, 0.0, state.feet_air_time),
            history={k: torch.where(m3, 0.0, v) for k, v in state.history.items()},
        )

    # ------------------------------------------------------------------- step
    def _torque_fn(self, state: EnvState, target, kp_eff, kd_eff):
        """PD torques with RFI/RAO, lanes branch (`tracking_env.py:860-873`)."""
        dr = self.dr
        rfi = bool(dr.get("randomize_torque_rfi", False))
        rao = bool(dr.get("use_rao", False))
        rfi_scale = float(dr.rfi_lim) * state.rfi_lim_scale * self.torque_limits if rfi else None
        rao_tau = state.rao_scale * self.torque_limits if rao else None

        def torque_fn(st):
            tau = kp_eff * (target - st.dof_pos) - kd_eff * st.dof_vel
            if rfi:
                noise = 2.0 * torch.rand(tau.shape, generator=self.gen, device=self.device) - 1.0
                tau = tau + noise * rfi_scale
            if rao:
                tau = tau + rao_tau
            return torch.clamp(tau, -self.torque_limits, self.torque_limits)

        return torque_fn

    def step(self, state: EnvState, actions):
        """One control step -> (state, obs_dict, rew [N,R], done, info) (`tracking_env.py:720`)."""
        N, dev, dr = self.num_envs, self.device, self.dr
        ecfg = self.ecfg
        if self.only_track_leg:
            mres_leg, _ = self._motion_state_at(state, 1)
            na = self.num_actions
            rest = (mres_leg["dof_pos"][:, na:] - state.default_dof_pos[:, na:]) / self.action_scales[na:]
            actions = torch.cat([actions, rest], dim=-1)
        actions = torch.clamp(actions, -self.action_clip, self.action_clip)
        if dr.get("randomize_ctrl_delay", False):
            queue = torch.cat([actions[:, None], state.action_queue[:, :-1]], dim=1)
            after_delay = queue[torch.arange(N, device=dev), state.action_delay_idx]
        else:
            queue, after_delay = state.action_queue, actions

        sim = state.sim
        push_counter = state.push_counter + 1
        push_interval = state.push_interval
        if dr.get("push_robots", False):
            do_push = push_counter >= push_interval
            max_vel = float(dr.max_push_vel_xy)
            push_vel = self._uniform((N, 2), -max_vel, max_vel)
            vel_xy = sim.root_lin_vel[:, :2]
            new_xy = vel_xy + push_vel if dr.get("_push_fixed", False) else push_vel
            sim = dataclasses.replace(sim, root_lin_vel=torch.where(
                do_push[:, None], torch.cat([new_xy, sim.root_lin_vel[:, 2:]], -1), sim.root_lin_vel))
            push_counter = torch.where(do_push, 0, push_counter)
            push_interval = torch.where(do_push, self._sample_push_interval(N), push_interval)

        kp_eff = state.kp_scale * self.p_gains
        kd_eff = state.kd_scale * self.d_gains
        target = after_delay * self.action_scales + state.default_dof_pos
        pstau = dr.get("parallel_serial_tau", {})
        if pstau and pstau.get("enable", False):
            raise _not_ported("parallel_serial_tau torque injection on the lanes branch", "7b")
        sim, torques = self.lanes_engine.control_step_batched(
            self.sim_params, sim, self._torque_fn(state, target, kp_eff, kd_eff), self.decimation,
            paramsT=self.paramsT)
        episode_length = state.episode_length + 1

        base_quat = sim.root_quat
        gravity = self._gravity_vec.expand(N, 3)
        projected_gravity = rot.quat_rotate_inverse(base_quat, gravity)
        base_lin_vel = rot.quat_rotate_inverse(base_quat, sim.root_lin_vel)
        feet_cf = sim.contact_forces[:, self.feet_indices]
        contacts = (torch.linalg.vector_norm(feet_cf, dim=-1) > 1.0).to(torch.float32)
        contacts_filt = ((contacts > 0) | (state.last_contacts > 0)).to(torch.float32)

        st_tmp = dataclasses.replace(state, episode_length=episode_length, sim=sim)
        mres, _ = self._motion_state_at(st_tmp, 1)
        body_pos, body_quat, body_vel, body_ang_vel = self._extend_body_states(sim)
        diffs = self._compute_diffs(sim, mres, body_pos, body_quat, body_vel, body_ang_vel)

        # termination (`tracking_env.py:924-986`)
        term = {}
        tcfg, tscl = ecfg.termination, ecfg.termination_scales
        norm = torch.linalg.vector_norm
        if tcfg.terminate_by_contact:
            term["contact"] = torch.any(
                norm(sim.contact_forces[:, self.termination_contact_indices], dim=-1) > 1.0, dim=1)
        if tcfg.terminate_by_gravity:
            term["gravity"] = norm(projected_gravity[:, :2], dim=-1) > float(tscl.termination_gravity)
        if tcfg.terminate_by_low_height:
            term["low_height"] = sim.root_pos[:, 2] < float(tscl.termination_min_base_height)
        if tcfg.terminate_when_motion_far:
            term["motion_far"] = torch.any(norm(diffs["dif_body_pos"], dim=-1) > state.motion_far_threshold, dim=-1)
        if tcfg.terminate_when_dof_far:
            term["dof_far"] = norm(diffs["dif_joint_pos"], dim=-1) > state.dof_far_threshold
        for name in ("dof_pos", "dof_vel", "torque"):
            if tcfg.get(f"terminate_when_close_to_{name}_limit", False):
                raise _not_ported(f"terminate_when_close_to_{name}_limit", "7b")
        term = self._extra_terminations(term, diffs, state)
        term["nonfinite"] = ~(torch.isfinite(sim.dof_pos).all(-1) & torch.isfinite(sim.dof_vel).all(-1)
                              & torch.isfinite(sim.root_pos).all(-1) & torch.isfinite(sim.root_quat).all(-1))
        reset_buf = torch.zeros((N,), dtype=torch.bool, device=dev)
        for v in term.values():
            reset_buf = reset_buf | v
        time_out = episode_length > self.max_episode_length
        if tcfg.terminate_when_motion_end:
            current_time = episode_length.to(torch.float32) * self.dt + state.motion_start_times
            term["motion_end"] = current_time > state.motion_len
            time_out = time_out | term["motion_end"]
        term["time_out"] = time_out
        reset_buf = reset_buf | time_out

        rew_state = dict(
            sim=sim, torques=torques, actions=actions, last_actions=state.last_actions,
            last_dof_vel=state.last_dof_vel, projected_gravity=projected_gravity,
            contacts=contacts, contacts_filt=contacts_filt, last_contacts=state.last_contacts,
            last_contacts_filt=state.last_contacts_filt, feet_air_time=state.feet_air_time,
            body_vel=body_vel, ref_contact_mask=mres["contact_mask"], reset_buf=reset_buf,
            time_out=time_out, base_lin_vel=base_lin_vel, mres=mres, diffs=diffs,
            body_pos=body_pos, body_quat=body_quat, body_ang_vel=body_ang_vel, **diffs)
        rew_vec, sigma_values, sigma_ema, feet_air_time, errors = self._compute_rewards(state, rew_state)

        n_reset = reset_buf.sum()
        avg_epl = self._update_avg_episode_length(state, episode_length, reset_buf, n_reset)
        motion_fail_ema = state.motion_fail_ema
        asc = ecfg.get("adaptive_motion_sampling")
        if self.motion_lib.num_unique > 1 and asc and bool(asc.get("enabled", False)):
            M, g = self.motion_lib.num_unique, float(asc.get("gamma", 0.1))
            resets = torch.zeros(M, device=dev).index_add_(0, state.motion_ids, reset_buf.float())
            fails = torch.zeros(M, device=dev).index_add_(0, state.motion_ids, (reset_buf & ~time_out).float())
            rate = fails / torch.clamp(resets, min=1.0)
            motion_fail_ema = torch.where(resets > 0, (1.0 - g) * motion_fail_ema + g * rate, motion_fail_ema)
        state2 = dataclasses.replace(
            state, sim=sim, episode_length=episode_length, feet_air_time=feet_air_time,
            average_episode_length=avg_epl, motion_fail_ema=motion_fail_ema,
            sigma_values=sigma_values, sigma_ema=sigma_ema, push_counter=push_counter,
            push_interval=push_interval, action_queue=queue, actions=actions,
            actions_after_delay=after_delay, torques=torques, last_episode_length=episode_length)
        state2 = self._update_curricula(state2, n_reset)
        state2 = self._reset_envs(state2, reset_buf)

        obs_dict, hist = self.compute_observations(state2)
        m1 = reset_buf[:, None]
        state3 = dataclasses.replace(
            state2, history=hist, last_actions=state2.actions, last_dof_vel=state2.sim.dof_vel,
            last_contacts=torch.where(m1, 0.0, contacts), last_contacts_filt=torch.where(m1, 0.0, contacts_filt),
            contacts=torch.where(m1, 0.0, contacts), contacts_filt=torch.where(m1, 0.0, contacts_filt))
        info = {"time_outs": time_out, "nonfinite": term["nonfinite"],
                "log": self._build_log(term, reset_buf, rew_vec, errors, state3)}
        if not self.use_vec_reward:
            rew_vec = rew_vec.sum(-1, keepdim=True)
        return state3, obs_dict, rew_vec, reset_buf, info

    # ---------------------------------------------------------------- rewards
    def _compute_rewards(self, state: EnvState, rs):
        """Config-ordered [N,R] reward vector, penalty curriculum, adaptive
        sigma (`tracking_env.py:1066`)."""
        rews, errors, feet_air_time = self._reward_terms(state, rs)
        curriculum = bool(self.config.rewards.reward_penalty_curriculum)
        cols = []
        for name, scale, pen in zip(self.reward_names, self.reward_scales, self.penalty_mask):
            rew = rews[name] * scale
            cols.append(rew * state.reward_penalty_scale if (curriculum and pen) else rew)
        cols.append((rs["reset_buf"] & ~rs["time_out"]).to(torch.float32) * self.termination_scale)
        rew_vec = torch.nan_to_num(torch.stack(cols, dim=-1), nan=0.0, posinf=0.0, neginf=0.0)

        sigma_values, sigma_ema = state.sigma_values, state.sigma_ema
        ats = self.config.rewards.adaptive_tracking_sigma
        if bool(ats.enable):
            alpha = float(ats.alpha)
            mean_type = str(ats.get("type", "origin")) == "mean"
            new_emas, new_sigs = [], []
            for i, t in enumerate(self.sigma_terms):
                if t in errors:
                    ema = sigma_ema[i] * (1 - alpha) + errors[t].mean() * alpha
                    sig = torch.minimum(ema, sigma_values[i])
                    new_emas.append(ema)
                    new_sigs.append((sig + ema) / 2 if mean_type else sig)
                else:
                    new_emas.append(sigma_ema[i])
                    new_sigs.append(sigma_values[i])
            sigma_ema, sigma_values = torch.stack(new_emas), torch.stack(new_sigs)
        return rew_vec, sigma_values, sigma_ema, feet_air_time, errors

    def _reward_terms(self, state: EnvState, rs):
        """Reward terms, name -> [N] (`tracking_env.py:1105`)."""
        sim: SimState = rs["sim"]
        sig = {t: state.sigma_values[i] for i, t in enumerate(self.sigma_terms)}
        rcfg = self.config.rewards
        norm = torch.linalg.vector_norm
        errors = {}

        def track(err, term):
            errors[term] = err
            return torch.exp(-err / sig[term])

        def msq(x):
            return (x ** 2).mean(-1).mean(-1)

        rews = {}
        if "teleop_upper_body_pos" in sig:
            r_up = track(msq(rs["dif_body_pos"][:, self.upper_body_id]), "teleop_upper_body_pos")
            r_lo = track(msq(rs["dif_body_pos"][:, self.lower_body_id]), "teleop_lower_body_pos")
            rews["teleop_body_position_extend"] = (r_lo * float(rcfg.teleop_body_pos_lowerbody_weight)
                                                   + r_up * float(rcfg.teleop_body_pos_upperbody_weight))
        if "teleop_vr_3point_pos" in sig:
            rews["teleop_vr_3point"] = track(msq(rs["dif_body_pos"][:, self.motion_tracking_id]),
                                             "teleop_vr_3point_pos")
        if "teleop_feet_pos" in sig:
            rews["teleop_body_position_feet"] = track(msq(rs["dif_body_pos"][:, self.feet_indices]),
                                                      "teleop_feet_pos")
        if "teleop_body_rot" in sig:
            rews["teleop_body_rotation_extend"] = track(msq(rs["dif_body_rot"]), "teleop_body_rot")
        if "teleop_body_vel" in sig:
            rews["teleop_body_velocity_extend"] = track(msq(rs["dif_body_vel"]), "teleop_body_vel")
        if "teleop_body_ang_vel" in sig:
            rews["teleop_body_ang_velocity_extend"] = track(msq(rs["dif_body_ang_vel"]), "teleop_body_ang_vel")
        if "teleop_joint_pos" in sig:
            rews["teleop_joint_position"] = track((rs["dif_joint_pos"] ** 2).mean(-1), "teleop_joint_pos")
        if "teleop_joint_vel" in sig:
            rews["teleop_joint_velocity"] = track((rs["dif_joint_vel"] ** 2).mean(-1), "teleop_joint_vel")
        if "teleop_max_joint_pos" in sig:
            rews["teleop_max_joint_position"] = track(torch.abs(rs["dif_joint_pos"]).amax(-1),
                                                      "teleop_max_joint_pos")
        err_cm = torch.abs(rs["contacts_filt"] - rs["ref_contact_mask"]).mean(-1)
        rews["teleop_contact_mask"] = 1.0 - err_cm
        rews["teleop_contact_mask_v2"] = 0.5 - err_cm

        rews["penalty_torques"] = (rs["torques"] ** 2).sum(-1)
        rews["penalty_dof_vel"] = (sim.dof_vel ** 2).sum(-1)
        rews["penalty_dof_acc"] = (((rs["last_dof_vel"] - sim.dof_vel) / self.dt) ** 2).sum(-1)
        rews["penalty_action_rate"] = ((rs["last_actions"] - rs["actions"]) ** 2).sum(-1)
        rews["penalty_orientation"] = (rs["projected_gravity"][:, :2] ** 2).sum(-1)

        feet_cf = sim.contact_forces[:, self.feet_indices]
        feet_vel = sim.body_lin_vel[:, self.feet_indices]
        cf_norm = norm(feet_cf, dim=-1)
        in_contact = cf_norm > 1.0
        rews["penalty_slippage"] = (norm(feet_vel, dim=-1) * in_contact).sum(-1)
        rews["penalty_feet_contact_forces"] = torch.clamp(
            cf_norm - float(rcfg.locomotion_max_contact_force), min=0.0).sum(-1)
        rews["penalty_stumble"] = torch.any(
            norm(feet_cf[..., :2], dim=-1) > 5.0 * torch.abs(feet_cf[..., 2]), dim=-1).to(torch.float32)
        rews["collision"] = (norm(sim.contact_forces[:, self.penalised_contact_indices], dim=-1)
                             > 0.1).to(torch.float32).sum(-1)

        contact_filt_z = (feet_cf[..., 2] > 1.0) | (rs["last_contacts"] > 0)
        first_contact = (rs["feet_air_time"] > 0) & contact_filt_z
        feet_air_time = rs["feet_air_time"] + self.dt
        rews["feet_air_time"] = ((feet_air_time - float(rcfg.desired_feet_air_time)) * first_contact).sum(-1)
        feet_air_time = feet_air_time * (~contact_filt_z)

        lim = self.dof_pos_limits
        m, r = (lim[:, 0] + lim[:, 1]) / 2, lim[:, 1] - lim[:, 0]
        lo_soft = m - 0.5 * r * state.soft_dof_pos_limit
        hi_soft = m + 0.5 * r * state.soft_dof_pos_limit
        rews["limits_dof_pos"] = (torch.clamp(lo_soft - sim.dof_pos, min=0.0)
                                  + torch.clamp(sim.dof_pos - hi_soft, min=0.0)).sum(-1)
        rews["limits_dof_vel"] = torch.clamp(
            torch.abs(sim.dof_vel) - self.dof_vel_limits * state.soft_dof_vel_limit, 0.0, 1.0).sum(-1)
        rews["limits_torque"] = torch.clamp(
            torch.abs(rs["torques"]) - self.torque_limits * state.soft_torque_limit, 0.0, 1.0).sum(-1)
        rews["foot_slip_penalty"] = (in_contact * norm(feet_vel[..., :2], dim=-1)).sum(-1)
        return rews, errors, feet_air_time

    # ---------------------------------------------------------------- curricula
    def _update_avg_episode_length(self, state, episode_length, reset_buf, n_reset):
        """`tracking_env.py:1195`."""
        n0 = float(self.config.rewards.num_compute_average_epl)
        n = n_reset.to(torch.float32)
        cur = torch.where(n > 0, (episode_length * reset_buf).sum() / torch.clamp(n, min=1), 0.0)
        new = state.average_episode_length * (1 - n / n0) + cur * (n / n0)
        return torch.where(n > 0, new, state.average_episode_length)

    def _update_curricula(self, state: EnvState, n_reset):
        """Penalty / termination / limit curricula (`tracking_env.py:1203`)."""
        rcfg, ecfg = self.config.rewards, self.ecfg
        apply = n_reset > 0
        epl = state.average_episode_length

        def ramp(value, down_thr, up_thr, degree, vmin, vmax, up_shrinks):
            up = 1.0 - degree if up_shrinks else 1.0 + degree
            down = 1.0 + degree if up_shrinks else 1.0 - degree
            new = torch.where(epl < down_thr, value * down, torch.where(epl > up_thr, value * up, value))
            return torch.where(apply, torch.clamp(new, vmin, vmax), value)

        out = {}
        if bool(rcfg.reward_penalty_curriculum):
            out["reward_penalty_scale"] = ramp(
                state.reward_penalty_scale, float(rcfg.reward_penalty_level_down_threshold),
                float(rcfg.reward_penalty_level_up_threshold), float(rcfg.reward_penalty_degree),
                float(rcfg.reward_min_penalty_scale), float(rcfg.reward_max_penalty_scale), up_shrinks=False)
        tc = ecfg.termination_curriculum
        if bool(ecfg.termination.terminate_when_motion_far) and bool(tc.terminate_when_motion_far_curriculum):
            out["motion_far_threshold"] = ramp(
                state.motion_far_threshold,
                float(tc.terminate_when_motion_far_curriculum_level_down_threshold),
                float(tc.terminate_when_motion_far_curriculum_level_up_threshold),
                float(tc.terminate_when_motion_far_curriculum_degree),
                float(tc.terminate_when_motion_far_threshold_min),
                float(tc.terminate_when_motion_far_threshold_max), up_shrinks=True)
        if bool(ecfg.termination.terminate_when_dof_far) and bool(tc.terminate_when_dof_far_curriculum.enable):
            dc = tc.terminate_when_dof_far_curriculum
            out["dof_far_threshold"] = ramp(
                state.dof_far_threshold, float(dc.level_down_threshold), float(dc.level_up_threshold),
                float(dc.degree), float(dc.min), float(dc.max), up_shrinks=True)
        lc = rcfg.reward_limit.reward_limits_curriculum
        for name in ("dof_pos", "dof_vel", "torque"):
            if bool(lc[f"soft_{name}_curriculum"]):
                out[f"soft_{name}_limit"] = ramp(
                    getattr(state, f"soft_{name}_limit"),
                    float(lc[f"soft_{name}_curriculum_level_down_threshold"]),
                    float(lc[f"soft_{name}_curriculum_level_up_threshold"]),
                    float(lc[f"soft_{name}_curriculum_degree"]),
                    float(lc[f"soft_{name}_min_limit"]), float(lc[f"soft_{name}_max_limit"]), up_shrinks=True)
        ocfg = self.config.obs
        if bool(ocfg.get("add_noise_currculum", False)):
            out["noise_curriculum_value"] = ramp(
                state.noise_curriculum_value, float(ocfg.soft_dof_pos_curriculum_level_down_threshold),
                float(rcfg.reward_penalty_level_up_threshold), float(ocfg.soft_dof_pos_curriculum_degree),
                float(ocfg.noise_value_min), float(ocfg.noise_value_max), up_shrinks=False)
        return dataclasses.replace(state, **out)

    # ------------------------------------------------------------------- obs
    def _obs_getters(self, state: EnvState):
        """All `_get_obs_*` primitives from post-reset state (`tracking_env.py:1282`)."""
        sim, N = state.sim, self.num_envs
        base_quat = sim.root_quat
        projected_gravity = rot.quat_rotate_inverse(base_quat, self._gravity_vec.expand(N, 3))
        base_lin_vel = rot.quat_rotate_inverse(base_quat, sim.root_lin_vel)
        base_ang_vel = rot.quat_rotate_inverse(base_quat, sim.root_ang_vel)
        mres, motion_times = self._motion_state_at(state, 1)
        body_pos, _, _, _ = self._extend_body_states(sim)
        ref_pos = mres["rg_pos_t"]
        hi = rot.calc_heading_quat_inv(base_quat)[:, None, :]
        dif_global = ref_pos - body_pos
        dif_local = rot.quat_rotate(hi.expand(dif_global.shape[:-1] + (4,)), dif_global)
        ref_rel = ref_pos - sim.root_pos[:, None, :]
        local_ref = rot.quat_rotate(hi.expand(ref_rel.shape[:-1] + (4,)), ref_rel)
        phase = torch.clamp(motion_times / state.motion_len, 0.0, 1.05)[:, None]
        dof_pos = sim.dof_pos - state.default_dof_pos
        return {
            "base_pos_z": sim.root_pos[:, 2:3], "base_lin_vel": base_lin_vel,
            "base_ang_vel": base_ang_vel, "projected_gravity": projected_gravity,
            "base_ang_vel_noise": base_ang_vel, "projected_gravity_noise": projected_gravity,
            "dof_pos_noise": dof_pos, "dof_vel_noise": sim.dof_vel, "dof_pos": dof_pos,
            "dof_vel": sim.dof_vel, "actions": state.actions, "ref_motion_phase": phase,
            "dif_local_rigid_body_pos": dif_local.reshape(N, -1),
            "local_ref_rigid_body_pos": local_ref.reshape(N, -1),
            "dr_base_com": self.dr_obs["base_com"], "dr_base_mass": self.dr_obs["base_mass"],
            "dr_link_mass": self.dr_obs["link_mass"], "dr_friction": self.dr_obs["friction"],
            "dr_kp": state.kp_scale, "dr_kd": state.kd_scale,
            "dr_ctrl_delay": state.action_delay_idx[:, None].to(torch.float32),
        }

    def compute_observations(self, state: EnvState):
        """Config-driven obs assembly, obs = (raw + U(-1,1) * noise) * scale;
        groups concat sorted keys (`tracking_env.py:1350`, `_compute_observations`).
        Returns (obs_dict, new history)."""
        cfgo = self.config.obs
        getters = self._obs_getters(state)
        N = self.num_envs
        noise_mult = state.noise_curriculum_value if bool(cfgo.get("add_noise_currculum", False)) else 1.0

        def noisy(name):
            raw = getters[name]
            nscale = float(cfgo.noise_scales.get(name, 0.0))
            if nscale > 0:
                u = 2.0 * torch.rand(raw.shape, generator=self.gen, device=self.device) - 1.0
                raw = raw + u * nscale * noise_mult
            return raw * float(cfgo.obs_scales.get(name, 1.0))

        new_hist = {}
        for hk in sorted(state.history.keys()):
            buf = state.history[hk]
            new_hist[hk] = torch.cat([noisy(hk)[:, None, :], buf[:, :-1]], dim=1)

        def history_group(group):
            spec = self.history_spec[group]
            return torch.cat([state.history[k][:, : spec[k]].reshape(N, -1) for k in sorted(spec)], dim=-1)

        obs_dict = {}
        for group, names in cfgo.obs_dict.items():
            parts = [history_group(n) if n in self.history_spec else noisy(n) for n in sorted(names)]
            obs_dict[group] = torch.nan_to_num(
                torch.clamp(torch.cat(parts, dim=-1), -self.clip_obs, self.clip_obs),
                nan=0.0, posinf=self.clip_obs, neginf=-self.clip_obs)
        return obs_dict, new_hist

    def obs_dim(self, group):
        """Static obs width per group (`tracking_env.py:1399`)."""
        d = 0
        for name in self.config.obs.obs_dict[group]:
            if name in self.history_spec:
                d += sum(self.obs_dims[k] * n for k, n in self.history_spec[name].items())
            else:
                d += self.obs_dims[name]
        return d

    # ------------------------------------------------------------------- logs
    def _build_log(self, term, reset_buf, rew_vec, errors, state):
        """Per-step scalars (`tracking_env.py:1418`); 0-d tensors, no host sync."""
        log = {}
        denom = reset_buf.to(torch.float32).mean() + 1e-15
        for k, v in term.items():
            log[f"terminate_by_{k}"] = v.to(torch.float32).mean() / denom
        means = rew_vec.mean(0)
        for i, name in enumerate(self.reward_names):
            log[f"rew_{name}"] = means[i]
        log["rew_termination"] = means[-1]
        log["average_episode_length"] = state.average_episode_length
        log["penalty_scale"] = state.reward_penalty_scale
        log["motion_far_threshold"] = state.motion_far_threshold
        log["episode_length_mean"] = state.episode_length.to(torch.float32).mean()
        if self.motion_lib.num_unique > 1:
            log["motion_fail_ema_mean"] = state.motion_fail_ema.mean()
            log["motion_fail_ema_max"] = state.motion_fail_ema.max()
        for i, t in enumerate(self.sigma_terms):
            log[f"adp_sigma_{t}"] = state.sigma_values[i]
        return log
