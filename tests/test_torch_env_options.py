"""Port parity: the tracking env's options that no committed run turns on —
soft dynamic correction (SDC) on the lanes and the per-env branches, the OU
observation-noise process, the probabilistic close-to-limit terminations,
`parallel_serial_tau` on the per-env branch and on the lanes and env-first
batched branches (N = 128; JAX's Pallas kernel in interpret mode) — and the
MPPI snapshots and `obs_key_slices`, against `pbhc_tpu` on the CPU.

The envs are `bench.py`'s v1 training composition with the randomness of
tests/test_torch_env.py switched off, N = 32, under random actions. What is
random in these features is made deterministic or shared: SDC `deter` (and
`prob` at alpha 1, where the gate always opens), the terminations at
probability 1 and 0, the OU process's normal draws taken from JAX's key and
injected into the port, `parallel_serial_tau` with zero limits (its torque
draw itself is held to its joints in a separate check) or, on the batched
branches, where neither package draws a torque, with a zero `rao` bump.

Tolerances: tests/test_torch_env.py's `SIM_TOL`, with the root and body
rotations at 4e-4 under SDC (it slerps the root every substep, and the
slerp is discontinuous at 1e-4: tests/test_torch_motion.py's bound);
observations 2e-3, rewards 1e-3 relative, `done` and the termination logs
exactly. An env whose state parts from JAX's is set aside from then on, but
only where JAX's own step jumps there under a 1e-5 m nudge of the root (a
contact that starts a substep early or late, tests/test_torch_terrain.py);
at most an eighth of the envs.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import pbhc_tpu.sim.pallas_contact as pc  # noqa: E402
from pbhc_tpu.config.loader import compose as jax_compose  # noqa: E402
from pbhc_tpu.envs.tracking_env import MotionTrackingEnv as JaxEnv  # noqa: E402
from pbhc_tpu.utils import noise_tool as jax_noise  # noqa: E402
from pbhc_tpu_torch.config.loader import SNAPSHOT_DIR, compose, load_snapshot  # noqa: E402
from pbhc_tpu_torch.envs.tracking_env import MotionTrackingEnv, obs_width  # noqa: E402
from pbhc_tpu_torch.utils import noise_tool  # noqa: E402
from test_torch_env import OFF, SIM_TOL  # noqa: E402

N = 32
SELS = ["exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking", "rewards=motion_tracking",
        "domain_rand=main", "simulator=tpu"]
BASE = [f"num_envs={N}", "robot.motion.motion_file=assets/motions/Horse-stance_punch.pkl", *OFF]
SDC = ["env.config.soft_dynamic_correction.enable=true", "env.config.soft_dynamic_correction.alpha=0.1"]
ROT_TOL = dict(SIM_TOL, root_quat=4e-4, body_quat=4e-4)


def _envs(ovs, n=N):
    ovs = BASE + list(ovs)
    jenv = JaxEnv(jax_compose("pbhc_tpu/config", SELS, ovs), n, jax.random.PRNGKey(0))
    js = jenv.reset_to_start(jenv.init_state(jax.random.PRNGKey(1)), jax.random.PRNGKey(1))
    js = dataclasses.replace(js, history=jenv._compute_observations(js, jax.random.PRNGKey(2))[1])
    tenv = MotionTrackingEnv(compose(SELS, ovs), n, device="cpu")
    ts = tenv.reset_to_start(tenv.init_state())
    ts.history = tenv.compute_observations(ts)[1]
    return jenv, js, tenv, ts


def _lockstep(jenv, js, tenv, ts, steps, tol=SIM_TOL, scale=0.3, port_step=None, on_step=None):
    """`steps` control steps of both envs under the same random actions, held
    together as the module docstring says. An env that resets draws its new
    start from each package's own generator, so it is compared up to its
    `done` and its terminal rewards. `port_step(js, ts, actions)` replaces the
    port's step (to inject JAX's draws); `on_step(i, js, ts, jout, tout,
    keep)` adds checks. Returns the final states."""
    jstep = jax.jit(jenv.step)
    n = tenv.num_envs
    rng = np.random.default_rng(0)
    keep = np.ones(n, bool)             # not set aside at a jump
    alive = np.ones(n, bool)            # not reset yet
    for i in range(steps):
        acts = (scale * rng.normal(size=(n, tenv.num_actions))).astype(np.float32)
        jprev, jout = js, jstep(js, jnp.asarray(acts))
        tout = (port_step or tenv.step)(*((js, ts) if port_step else (ts,)), torch.as_tensor(acts))
        js, ts = jout[0], tout[0]
        done = np.asarray(jout[3])
        np.testing.assert_array_equal(tout[3].numpy()[keep & alive], done[keep & alive], err_msg=f"done {i}")
        live = keep & alive & ~done
        far = np.zeros(n, bool)
        for f, t in tol.items():
            far |= np.abs(getattr(ts.sim, f).numpy() - np.asarray(getattr(js.sim, f))).reshape(n, -1).max(1) > t
        if (far & live).any():
            jumps = np.zeros(n, bool)
            for dz in (1e-5, -1e-5):
                jn = dataclasses.replace(jprev, sim=dataclasses.replace(
                    jprev.sim, root_pos=jprev.sim.root_pos.at[:, 2].add(dz)))
                jumps |= np.abs(np.asarray(jstep(jn, jnp.asarray(acts))[0].sim.dof_vel)
                                - np.asarray(js.sim.dof_vel)).max(1) > SIM_TOL["dof_vel"]
            assert jumps[far & live].all(), (i, np.nonzero(far & live & ~jumps)[0])
            keep &= ~(far & live)
        np.testing.assert_allclose(tout[2].numpy()[keep & alive], np.asarray(jout[2])[keep & alive], rtol=1e-3,
                                   atol=1e-5, err_msg=f"rewards {i}")
        live = keep & alive & ~done
        for g in ("actor_obs", "critic_obs"):
            np.testing.assert_allclose(tout[1][g].numpy()[live], np.asarray(jout[1][g])[live], atol=2e-3,
                                       err_msg=f"{g} {i}")
        if on_step is not None:
            on_step(i, js, ts, jout, tout, live)
        alive &= ~done
    assert (~keep).sum() <= n // 8, np.nonzero(~keep)[0]
    return js, ts


@pytest.mark.parametrize("solver", ["lanes", "apgd"])
def test_soft_dynamic_correction_matches_jax(solver):
    """SDC (`type: deter`, alpha 0.1) on the lanes engine (its batched
    pre-substep hook) and on the per-env engine (`solver=apgd`), 5 control
    steps; its alpha curriculum moves `sdc_alpha` as JAX's does."""
    jenv, js, tenv, ts = _envs(SDC + [f"simulator.config.solver={solver}"])
    assert tenv.use_sdc and tenv.physics == ("lanes" if solver == "lanes" else "per_env")

    def alpha_same(i, js, ts, jout, tout, keep):
        assert float(ts.sdc_alpha) == pytest.approx(float(js.sdc_alpha), rel=1e-6)

    _, ts = _lockstep(jenv, js, tenv, ts, 5, ROT_TOL, on_step=alpha_same)
    assert bool(torch.isfinite(ts.sim.root_quat).all())


@pytest.mark.parametrize("kind", ["deter", "prob"])
def test_soft_dynamic_correction_pulls_towards_the_reference(kind):
    """With alpha 1 every substep starts from the reference's pose (under
    `type: prob` the gate, a draw below sqrt(alpha), then always opens), so
    the joints end a control step near the reference; without SDC they do
    not."""
    _, _, tenv, ts = _envs(SDC + ["env.config.soft_dynamic_correction.alpha=1.0",
                                  f"env.config.soft_dynamic_correction.type={kind}",
                                  "env.config.soft_dynamic_correction.curriculum.enable=false"])
    free = MotionTrackingEnv(compose(SELS, BASE), N, device="cpu")
    fs = free.reset_to_start(free.init_state())
    fs.history = free.compute_observations(fs)[1]
    acts = torch.full((N, tenv.nd), 0.8)
    for _ in range(3):
        ts, *_ = tenv.step(ts, acts)
        fs, *_ = free.step(fs, acts)
    ref, _ = tenv._motion_state_at(ts, 0)
    err = lambda s: float((s.sim.dof_pos - ref["dof_pos"]).abs().max())
    assert err(ts) < 0.1 < err(fs)


def test_sdc_with_pallas_runs_per_env():
    """`solver: pallas` with SDC takes the per-env branch even at N % 128 == 0,
    as in JAX (`tracking_env.py:791-858`)."""
    env = MotionTrackingEnv(compose(SELS, BASE[1:] + SDC + ["num_envs=128", "simulator.config.solver=pallas"]),
                            128, device="cpu")
    assert env.physics == "per_env"


def _ou_ovs(theta=2.0, sigma=0.5):
    proc = {"enable": True, "kwargs": {"theta": theta, "sigma": sigma}, "scale": {"rpy": 5.0, "base_ang_vel": 0.3}}
    return [f"obs.noise_process={json.dumps(proc)}", "obs.obs_dims.base_ang_vel_noise=3",
            "obs.obs_dims.projected_gravity_noise=3",
            'obs.obs_dict.actor_obs=["base_ang_vel_noise", "projected_gravity_noise", "dof_pos", "actions"]',
            "simulator.config.solver=lanes"]


def test_ou_step_matches_jax_with_the_same_draws():
    x = np.random.default_rng(0).normal(size=(N, 6)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want, _ = jax_noise.ou_step(jnp.asarray(x), key, 0.02, theta=2.0, sigma=0.5)
    draw = np.asarray(jax.random.normal(key, (N, 6)))
    g = torch.Generator().manual_seed(9)
    got, sample = noise_tool.ou_step(torch.as_tensor(x), g, 0.02, theta=2.0, sigma=0.5)
    port_draw = torch.randn((N, 6), generator=torch.Generator().manual_seed(9))
    # each package's step is the same update of its own draw
    np.testing.assert_allclose(got.numpy() - 0.5 * np.sqrt(0.02) * port_draw.numpy(),
                               np.asarray(want) - 0.5 * np.sqrt(0.02) * draw, atol=1e-6)
    assert torch.equal(got, sample)
    assert noise_tool.noise_process_dict.keys() == jax_noise.noise_process_dict.keys()
    ou = noise_tool.OUProcess((3,), dt=0.02)
    assert ou.step().shape == (3,) and noise_tool.PinkNoise((2,)).step().shape == (2,)


def test_ou_observation_noise_matches_jax(monkeypatch):
    """The OU process behind the noised IMU observations, its normal draws
    injected into the port from JAX's key of each step (`tracking_env.py:1036-1045`,
    `:1308-1320`)."""
    jenv, js, tenv, ts = _envs(_ou_ovs())
    assert tenv.noise_process is not None
    randn = torch.randn

    def port_step(js, ts, actions):
        k_obs = jax.random.split(js.rng, 6)[4]
        draw = torch.as_tensor(np.asarray(jax.random.normal(k_obs, (N, 6))))

        def injected(*size, **kw):
            shape = tuple(size[0]) if len(size) == 1 and not isinstance(size[0], int) else tuple(size)
            return draw.clone() if shape == (N, 6) else randn(*size, **kw)

        monkeypatch.setattr(torch, "randn", injected)
        try:
            return tenv.step(ts, actions)
        finally:
            monkeypatch.setattr(torch, "randn", randn)

    def same_noise(i, js, ts, jout, tout, keep):
        np.testing.assert_allclose(ts.noise_ou.numpy()[keep], np.asarray(js.noise_ou)[keep], atol=1e-6)
        assert float(np.abs(np.asarray(js.noise_ou)).max()) > 0.01

    _lockstep(jenv, js, tenv, ts, 4, port_step=port_step, on_step=same_noise)


TERMINATIONS = {"dof_pos_limit": ("dof_pos", 0.2), "dof_vel_limit": ("dof_vel", 0.01),
                "torque_limit": ("torque", 0.05)}


def _termination_ovs(prob):
    ovs = ["simulator.config.solver=lanes"]
    for name, scale in TERMINATIONS.values():
        ovs += [f"env.config.termination.terminate_when_close_to_{name}_limit=true",
                f"env.config.termination_scales.termination_close_to_{name}_limit={scale}",
                f"env.config.termination_probality.terminate_when_close_to_{name}_limit={prob}"]
    return ovs


def test_close_to_limit_terminations_match_jax():
    """The three probabilistic close-to-limit terminations at probability 1
    (the gate always opens), each with its scale tightened so that envs cross
    it: JAX's terminations and logs."""
    jenv, js, tenv, ts = _envs(_termination_ovs(1.0))
    fired = {k: [] for k in TERMINATIONS}

    def same_log(i, js, ts, jout, tout, keep):
        for k in TERMINATIONS:
            key = f"terminate_by_{k}"
            assert float(tout[4]["log"][key]) == pytest.approx(float(jout[4]["log"][key]), abs=1e-6), key
            fired[k].append(float(jout[4]["log"][key]))

    _lockstep(jenv, js, tenv, ts, 3, on_step=same_log)
    assert all(max(v) > 0 for v in fired.values()), fired


def test_close_to_limit_terminations_never_fire_at_probability_0():
    env = MotionTrackingEnv(compose(SELS, BASE + _termination_ovs(0.0)), N, device="cpu")
    state = env.reset_to_start(env.init_state())
    state.history = env.compute_observations(state)[1]
    for _ in range(3):
        state, _, _, done, info = env.step(state, torch.full((N, env.nd), 0.5))
        assert all(float(info["log"][f"terminate_by_{k}"]) == 0.0 for k in TERMINATIONS)


def _pd_torques(env, state):
    """`env`'s torque function at `state` towards the default pose + 0.1."""
    target = state.default_dof_pos + 0.1
    kp, kd = state.kp_scale * env.p_gains, state.kd_scale * env.d_gains
    return env._torque_fn(state, target, kp, kd)(state.sim)


def test_parallel_serial_tau_on_the_per_env_branch():
    """`parallel_serial_tau` runs on the per-env branch (with zero limits the
    parity holds exactly as without it) and its torque draw lands on its
    joints only."""
    pst = ["domain_rand.parallel_serial_tau.enable=true", "domain_rand.parallel_serial_tau.rao_lim=0.0",
           "domain_rand.parallel_serial_tau.rfi_lim=0.0"]
    jenv, js, tenv, ts = _envs(pst + ["simulator.config.solver=apgd"])
    assert tenv.use_pstau and tenv.physics == "per_env"
    _lockstep(jenv, js, tenv, ts, 3)

    env = MotionTrackingEnv(compose(SELS, BASE + ["simulator.config.solver=apgd",
                                                  "domain_rand.parallel_serial_tau.enable=true"]), N, device="cpu")
    state = env.reset_to_start(env.init_state())
    tau = _pd_torques(env, state)
    env.use_pstau = False
    plain = _pd_torques(env, state)
    moved = (tau != plain).any(0).nonzero()[:, 0].tolist()
    assert moved == list(env.dr.parallel_serial_tau.joint_idx)


@pytest.mark.parametrize("solver,physics", [("lanes", "lanes"), ("pallas", "batched")])
def test_parallel_serial_tau_on_the_batched_branches(monkeypatch, solver, physics):
    """`parallel_serial_tau` on the lanes and env-first batched branches at
    N = 128, held in lockstep against JAX, which runs it there without its
    torque injection: with its `rfi_lim` at the default 0.02 and a zero
    `rao` bump the two stay together, which an injection on either side
    would break. The port's lanes torque equals its torque without the
    option, its `rao` bump (default limits) lands on the option's joints."""
    orig = pc.solve_contacts_pallas
    monkeypatch.setattr(pc, "solve_contacts_pallas",
                        lambda A, b, mu, active, iters=32, interpret=False: orig(A, b, mu, active, iters, True))
    pst = ["domain_rand.parallel_serial_tau.enable=true", f"simulator.config.solver={solver}"]
    jenv, js, tenv, ts = _envs(pst + ["domain_rand.parallel_serial_tau.rao_lim=0.0"], n=128)
    assert tenv.use_pstau and tenv.physics == physics
    _lockstep(jenv, js, tenv, ts, 3)

    env = MotionTrackingEnv(compose(SELS, BASE + pst), 128, device="cpu")
    assert env.physics == physics
    state = env.reset_to_start(env.init_state())
    tau = _pd_torques(env, state)
    env.use_pstau = False
    assert torch.equal(tau, _pd_torques(env, state))
    bumped = (state.rao_scale != 0).any(0).nonzero()[:, 0].tolist()
    assert bumped == list(env.dr.parallel_serial_tau.joint_idx)


def test_mppi_snapshot_round_trip():
    """A snapshot of two envs (`get_mppi_buffers`) written into two other
    slots of a later state (`set_mppi_buffers`) carries every env-leading
    field, as JAX's gathers the same fields; the shared scalars stay the
    later state's."""
    jenv, js, tenv, ts = _envs(["simulator.config.solver=lanes"])
    acts = torch.full((N, tenv.nd), 0.1)
    ts, *_ = tenv.step(ts, acts)
    ids = torch.tensor([5, 2])
    snap = MotionTrackingEnv.get_mppi_buffers(ts, ids)
    later, *_ = tenv.step(ts, acts)
    later, *_ = tenv.step(later, acts)
    dst = torch.tensor([0, 7])
    back = MotionTrackingEnv.set_mppi_buffers(later, snap, dst)
    jsnap = JaxEnv.get_mppi_buffers(js, jnp.asarray([5, 2]))
    n_env = 0
    for f in dataclasses.fields(back):
        if f.name in ("sim", "history"):
            continue
        full, got, old = getattr(later, f.name), getattr(back, f.name), getattr(snap, f.name)
        env_leading = full.ndim >= 1 and full.shape[0] == N
        assert env_leading == (np.shape(getattr(jsnap, f.name)) != np.shape(getattr(js, f.name))), f.name
        if env_leading:
            n_env += 1
            assert torch.equal(got[dst], old) and torch.equal(got[8:], full[8:]), f.name
        else:
            assert got is full, f.name
    for f in ("root_pos", "dof_vel", "body_pos", "contact_forces"):
        assert torch.equal(getattr(back.sim, f)[dst], getattr(snap.sim, f))
    for k, v in back.history.items():
        assert torch.equal(v[dst], snap.history[k]) and torch.equal(v[1], later.history[k][1])
    assert n_env > 20 and torch.equal(snap.sim.root_pos, ts.sim.root_pos[ids])


class _Slices:
    """The attributes `obs_key_slices` reads, for both packages' methods."""

    def __init__(self, cfg):
        self.config = cfg
        self.obs_dims = {k: int(v) for k, v in cfg.obs.obs_dims.items()}
        self.history_spec = {g: {k: int(v) for k, v in sorted(dict(s).items())}
                             for g, s in cfg.obs.obs_auxiliary.items()}


SNAPSHOTS = sorted(p.stem for p in SNAPSHOT_DIR.glob("*.json"))


def test_every_snapshot_is_covered():
    assert len(SNAPSHOTS) >= 14 and "kb1_side_kick" in SNAPSHOTS


@pytest.mark.parametrize("run", SNAPSHOTS)
def test_obs_key_slices_match_jax(run):
    """Every obs group of every committed config snapshot: the port's slices
    are JAX's, tile the group and span its width."""
    cfg = load_snapshot(run)
    s = _Slices(cfg)
    for group in cfg.obs.obs_dict:
        got = MotionTrackingEnv.obs_key_slices(s, group)
        assert got == JaxEnv.obs_key_slices(s, group), group
        ends = [e for _, e in sorted(got.values())]
        assert [b for b, _ in sorted(got.values())] == [0] + ends[:-1] and ends[-1] == obs_width(cfg.obs, group)
    if "ref_motion_phase" in cfg.obs.obs_dict.get("actor_obs", []):
        b, e = MotionTrackingEnv.obs_key_slices(s, "actor_obs")["ref_motion_phase"]
        assert e == b + 1
