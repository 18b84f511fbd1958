"""The CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it runs on the machine with the card, where the
repo's conftest (which imports JAX) must be skipped:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernel.py
Without a card every test here skips.

Tolerance atol 1e-4 (the repo's kernel-parity bound): the kernel and the plain
version sum the matvecs in different orders and the kernel fuses multiply-adds.
Kernel 1's reduced matvec modes (bfloat16, float16) against the plain version
in the same mode: max abs 1e-2 and mean abs 3e-6 (MV_ATOL, MV_MEAN_ATOL;
chip_smoke.py states them): a one-ulp difference of the two f32 momentum
points can round y to the neighbouring bfloat16 / float16 value, which moves
a few impulses by up to ~1.5e-3 (one flip at most about a bfloat16 ulp of
the largest |y|, 2.3e-2), while another product rule moves every impulse.
The KungfuBot2 networks (Conv1d through cuDNN, the flax-numerics LayerNorm,
the MLPs) on the card against the CPU, TF32 off for matmul and cuDNN: 1e-5
per unit of each output's largest magnitude (the two devices sum products in
different orders; tests/test_torch_mimic.py holds the CPU to flax the same
way); the MoE and phase-aware networks the same. The per-env engine (`apgd`,
`pgs`: plain PyTorch on both devices) and a lanes control step with soft
dynamic correction (kernel 1 against its plain version inside it): 1e-3 of
each field's scale, chip_smoke.py's control-step bound.
Kernel 3 (`sim/dynamics_kernel.py`) against `_pre_contact_plain` and
`_body_state_plain` on the card, each field's largest difference over its
scale (its largest magnitude, at least 1, as chip_smoke.py's control-step
check): positions (sphere centres and gaps, the Jacobian's lever arms, the
pair frames, body poses and quaternions) 1e-5, velocities (u_plus, body
twists) 1e-4, M^-1 1e-4 (the repo's own bounds for positions and
velocities, tests/test_torch_engine_lanes.py). The two sum in other orders,
the kernel fuses multiply-adds, and it inverts the dof groups by columns of
L^-1 where the plain version goes by rows: M^-1 then differs by ~1.6e-5 of
its scale, and at random states, where |u_plus| reaches ~10 m/s or rad/s,
u_plus by up to 2.4e-4 absolute, 2.4e-5 of its scale (NVIDIA H100 80GB
HBM3, 700 W). The gaps phi and the body positions come out equal bit for
bit: the kernel forms the poses op for op as PyTorch does (the gaps pick the
contact rows; a row flipped in one env of 4096 moved the benchmark's
`step_gap` by 0.1).
"""
import numpy as np
import pytest
import torch

from pbhc_tpu_torch.sim import contact_kernel as ck
from pbhc_tpu_torch.sim import dynamics_kernel as dk

ATOL = 1e-4
MV_ATOL, MV_MEAN_ATOL = 1e-2, 3e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from pbhc_tpu_torch.eval.batch_eval import set_precision

    set_precision()
    return torch.device("cuda")


def _problem(R, N, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    n = 3 * R
    J = torch.randn((n, 40, N), generator=g, device=device) * 0.3
    A = (torch.einsum("ivn,jvn->ijn", J, J) + 1e-2 * torch.eye(n, device=device)[:, :, None]).contiguous()
    b = torch.randn((n, N), generator=g, device=device)
    mu = 0.2 + torch.rand((N,), generator=g, device=device)
    active = (torch.rand((R, N), generator=g, device=device) > 0.3).float()
    x0 = torch.rand((n, N), generator=g, device=device) * 0.5
    return A, b, mu, active, x0


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,iters", [(12, 4096, 16), (12, 128, 32), (1, 50, 16), (17, 1000, 16),
                                       (36, 256, 8), (38, 4096, 16), (38, 1001, 16), (42, 4096, 16),
                                       (42, 333, 8), (21, 4093, 16)])
def test_kernel_matches_plain(cuda_device, R, N, iters):
    args = _problem(R, N, R + N, cuda_device)
    before = ck.apgd_lanes.launches
    out = ck.apgd_lanes(*args, iters=iters)
    ref = ck.apgd_lanes_plain(*args, iters=iters)
    torch.cuda.synchronize()
    assert ck.apgd_lanes.launches == before + 1
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mv_dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("R,N", [(12, 4096), (38, 4096), (21, 1001)])
def test_reduced_modes_match_plain(cuda_device, mv_dtype, R, N):
    """Kernel 1's bfloat16 and float16 matvec modes at the paths' row counts
    (R = 12, 38) and a ragged shape; each launch counted in its mode, and
    the result a reduced-precision one (far from the float32 solve)."""
    args = _problem(R, N, R + N, cuda_device)
    before, in_mode = ck.apgd_lanes.launches, ck.apgd_lanes.mode_launches[mv_dtype]
    out = ck.apgd_lanes(*args, iters=16, mv_dtype=mv_dtype)
    ref = ck.apgd_lanes_plain(*args, iters=16, mv_dtype=mv_dtype)
    f32 = ck.apgd_lanes_plain(*args, iters=16)
    torch.cuda.synchronize()
    assert ck.apgd_lanes.launches == before + 1 and ck.apgd_lanes.mode_launches[mv_dtype] == in_mode + 1
    assert torch.isfinite(out).all()
    diff = (out - ref).abs()
    assert float(diff.max()) <= MV_ATOL and float(diff.mean()) <= MV_MEAN_ATOL, (float(diff.max()),
                                                                                 float(diff.mean()))
    assert float((out - f32).abs().mean()) > 3 * MV_MEAN_ATOL
    assert ck.tile("apgd_lanes", R, mv_dtype) == ck.tile("apgd_lanes", R)


@pytest.mark.cuda
def test_kernel_refuses_too_many_rows(cuda_device):
    R = ck._library().apgd_lanes_max_rows() + 1
    with pytest.raises(ValueError, match="at most"):
        ck.apgd_lanes(*_problem(R, 32, 0, cuda_device), iters=4)


@pytest.mark.cuda
def test_kernel_takes_every_row_of_the_g1_models(cuda_device):
    # contact_cap 0 gives R = 38 (21 spheres + 17 pairs); n = 3R <= 128
    assert ck._library().apgd_lanes_max_rows() >= 42


@pytest.mark.cuda
def test_tile_at_the_paths_row_counts(cuda_device):
    # R = 12: the committed configs (8 ground + 4 pair rows); R = 38: contact_cap 0
    assert [ck.tile("apgd_lanes", R) for R in (12, 38)] == [(8, 1), (4, 2)]
    assert [ck.tile("apgd_envfirst", R) for R in (12, 38)] == [(8, 1), (1, 4)]


def _envfirst_problem(R, N, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    n = 3 * R
    J = torch.randn((N, n, 40), generator=g, device=device) * 0.3
    A = (J @ J.transpose(1, 2) + 1e-2 * torch.eye(n, device=device)).contiguous()
    b = torch.randn((N, n), generator=g, device=device)
    mu = 0.2 + torch.rand((N,), generator=g, device=device)
    active = (torch.rand((N, R), generator=g, device=device) > 0.3).float()
    return A, b, mu, active


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,iters", [(12, 4096, 16), (38, 4096, 16), (12, 128, 32), (1, 50, 16),
                                       (11, 1000, 16), (42, 64, 8), (21, 777, 16), (38, 1001, 16)])
def test_envfirst_kernel_matches_plain(cuda_device, R, N, iters):
    args = _envfirst_problem(R, N, R + N, cuda_device)
    before = ck.apgd_envfirst.launches
    out = ck.apgd_envfirst(*args, iters=iters)
    ref = ck.apgd_envfirst_plain(*args, iters=iters)
    torch.cuda.synchronize()
    assert ck.apgd_envfirst.launches == before + 1
    assert out.shape == (N, R, 3) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=ATOL)


@pytest.mark.cuda
def test_envfirst_kernel_refuses_too_many_rows(cuda_device):
    R = ck._envfirst_library().apgd_envfirst_max_rows() + 1
    with pytest.raises(ValueError, match="at most"):
        ck.apgd_envfirst(*_envfirst_problem(R, 32, 0, cuda_device), iters=4)


@pytest.mark.cuda
@pytest.mark.parametrize("R,N", [(12, 1000), (38, 301), (5, 77)])
def test_every_tile_matches_plain(cuda_device, R, N):
    # the launch functions take every tile (E envs, P threads per contact)
    # that fits a block; the kernels pick one per R
    for name, at_tile, plain, args in (
            ("apgd_lanes", ck.apgd_lanes_at_tile, ck.apgd_lanes_plain, _problem(R, N, R, cuda_device)),
            ("apgd_envfirst", ck.apgd_envfirst_at_tile, ck.apgd_envfirst_plain,
             _envfirst_problem(R, N, R, cuda_device))):
        ref = plain(*args, iters=16)
        before = getattr(ck, name).launches
        taken = []
        for E in (1, 2, 4, 8):
            for P in (1, 2, 4):
                try:
                    out = at_tile(*args, 16, E, P)
                except ValueError:  # more threads or shared memory than a block has
                    continue
                taken.append((E, P))
                torch.cuda.synchronize()
                np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=ATOL,
                                           err_msg=f"{name} E={E} P={P}")
        assert ck.tile(name, R) in taken and len(taken) >= 6
        assert getattr(ck, name).launches == before


def _kb2_env(run, n, device, seed=0):
    from pbhc_tpu_torch.config.loader import Cfg, apply_overrides, load_snapshot
    from pbhc_tpu_torch.envs.general_tracking_env import GeneralTrackingEnv

    motion = ["robot.motion.motion_file=assets/motions/g1_ue_walk_23dof.pkl"] if "23" in run else []
    return GeneralTrackingEnv(Cfg.wrap(apply_overrides(load_snapshot(run), motion)), n, device=device, seed=seed)


@pytest.mark.cuda
def test_kernel_matches_plain_on_29dof_contacts(cuda_device):
    """Kernel 1 on the contact problems of a lanes control step of the 29-DoF
    KungfuBot2 teacher config at its 2048 envs (R = 12), after 10 steps
    holding the default pose from clip start."""
    env = _kb2_env("kb2_teacher29_r5", 2048, cuda_device)
    state = env.reset_to_start(env.init_state())
    obs, state.history = env.compute_observations(state)
    zero = torch.zeros((2048, env.num_actions), device=cuda_device)
    with torch.no_grad():
        for _ in range(10):
            state, obs, _, _, _ = env.step(state, zero)
    seen = []
    lanes = env.lanes_engine

    def record(A, b, mu, active, x0, iters, mv_dtype="float32"):
        seen.append((A.clone(), b.clone(), mu.clone(), active.clone(), x0.clone(), iters))
        return ck.apgd_lanes(A, b, mu, active, x0, iters, mv_dtype)

    lanes.contact_solve = record
    with torch.no_grad():
        env.step(state, zero)
    lanes.contact_solve = ck.apgd_lanes
    assert len(seen) == env.decimation
    for A, b, mu, active, x0, iters in seen:
        assert A.shape == (36, 36, 2048) and iters == 16
        assert float(active.sum(0).gt(0).float().mean()) > 0.5       # most envs in contact
        out = ck.apgd_lanes(A, b, mu, active, x0, iters)
        ref = ck.apgd_lanes_plain(A, b, mu, active, x0, iters)
        torch.cuda.synchronize()
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=ATOL)


@pytest.mark.cuda
def test_kernel_matches_plain_on_heightfield_contacts(cuda_device):
    """Kernel 1 on the contact problems of a lanes control step of the
    committed `terrain_walk_v3` run (heightfield ground) at its 4096 envs
    (R = 12), after 10 steps of its policy from clip start."""
    from pbhc_tpu_torch.eval import batch_eval

    env, actor, _ = batch_eval.load("artifacts/terrain_walk_v3/ckpt/model_6500.pkl", 4096, device=cuda_device)
    assert env.terrain is not None and env.lanes_engine is not None
    state, obs = batch_eval.start_episodes(env)
    with torch.no_grad():
        for _ in range(10):
            state, obs, _, _, _ = env.step(state, actor(obs["actor_obs"])[0])
    seen = []
    lanes = env.lanes_engine

    def record(A, b, mu, active, x0, iters, mv_dtype="float32"):
        seen.append((A.clone(), b.clone(), mu.clone(), active.clone(), x0.clone(), iters))
        return ck.apgd_lanes(A, b, mu, active, x0, iters, mv_dtype)

    lanes.contact_solve = record
    with torch.no_grad():
        env.step(state, actor(obs["actor_obs"])[0])
    lanes.contact_solve = ck.apgd_lanes
    assert len(seen) == env.decimation
    for A, b, mu, active, x0, iters in seen:
        assert A.shape == (36, 36, 4096) and iters == 16
        assert float(active.sum(0).gt(0).float().mean()) > 0.5       # most envs in contact
        out = ck.apgd_lanes(A, b, mu, active, x0, iters)
        ref = ck.apgd_lanes_plain(A, b, mu, active, x0, iters)
        torch.cuda.synchronize()
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=ATOL)


@pytest.mark.cuda
def test_mimic_networks_on_card_match_cpu(cuda_device):
    """The committed 23-DoF teacher's `MimicActorCritic` (Conv1d encoders,
    LayerNorms, MLPs) on the card and on the CPU, on the serving path's
    observations (64 envs, 3 control steps on the CPU)."""
    from pbhc_tpu_torch.agents.convert import from_flax
    from pbhc_tpu_torch.agents.mimic_networks import mimic_net_from_config
    from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload

    env = _kb2_env("kb2_teacher23_r3", 64, "cpu")
    params = load_checkpoint_payload("artifacts/kb2_teacher23_r3/ckpt/model_24000.pkl")["params"]
    cpu = from_flax(params, mimic_net_from_config(env.config, env.num_actions)).eval()
    card = from_flax(params, mimic_net_from_config(env.config, env.num_actions)).to(cuda_device).eval()
    state = env.reset_to_start(env.init_state())
    obs, state.history = env.compute_observations(state)
    with torch.no_grad():
        for _ in range(3):
            state, obs, _, _, _ = env.step(state, cpu.act(obs, True)[0])
        gobs = {k: v.to(cuda_device) for k, v in obs.items()}
        pairs = [(cpu.act(obs, h)[0], card.act(gobs, h)[0]) for h in (False, True)]
        pairs += [(cpu.evaluate(obs), card.evaluate(gobs)),
                  (cpu.priv_latent(obs["priv_obs"]), card.priv_latent(gobs["priv_obs"])),
                  (cpu.hist_latent(obs["prop_history"]), card.hist_latent(gobs["prop_history"]))]
        x = torch.cat([obs["actor_obs"], cpu.actor.motion_encoder(obs["future_motion_targets"]),
                       cpu.hist_latent(obs["prop_history"])], dim=-1)          # the backbone's LayerNorm input
        pairs.append((cpu.actor.ln(x), card.actor.ln(x.to(cuda_device))))
    for want, got in pairs:
        want = want.numpy()
        np.testing.assert_allclose(got.cpu().numpy(), want, atol=1e-5 * max(1.0, np.abs(want).max()))


def _v1_env(n, device, ovs=()):
    from pbhc_tpu_torch.config.loader import compose
    from pbhc_tpu_torch.envs.tracking_env import MotionTrackingEnv

    sels = ["exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking", "rewards=motion_tracking",
            "domain_rand=main", "simulator=tpu"]
    cfg = compose(sels, [f"num_envs={n}", "robot.motion.motion_file=assets/motions/Horse-stance_punch.pkl", *ovs])
    return MotionTrackingEnv(cfg, n, device=device, seed=0)


def _step_rel(a, b):
    """Largest difference of two SimStates relative to each field's scale."""
    return max(float((getattr(a, f).cpu() - getattr(b, f).cpu()).abs().max()) / max(1.0, float(getattr(b, f).abs().max()))
               for f in ("root_pos", "root_quat", "root_lin_vel", "root_ang_vel", "dof_pos", "dof_vel"))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["apgd", "pgs"])
def test_per_env_control_step_on_card_matches_cpu(cuda_device, solver):
    """One per-env control step at 256 envs (settled for 5 steps on the card),
    the same state and torques on the card and on the CPU."""
    env = _v1_env(256, cuda_device, [f"simulator.config.solver={solver}"])
    assert env.physics == "per_env"
    state = env.reset_to_start(env.init_state())
    zero = torch.zeros((256, env.nd), device=cuda_device)
    with torch.no_grad():
        for _ in range(5):
            state, _, _, _, _ = env.step(state, zero)
    eng, params = env.engine, env.sim_params
    kp, kd, target = env.p_gains, env.d_gains, state.default_dof_pos

    def pd(st):
        return torch.clamp(kp.to(st.dof_pos.device) * (target.to(st.dof_pos.device) - st.dof_pos)
                           - kd.to(st.dof_pos.device) * st.dof_vel, -60.0, 60.0)

    card, _ = eng.control_step(params, state.sim, pd, env.decimation)
    from pbhc_tpu_torch.sim.engine import Engine, tree_map

    cpu_eng = Engine(eng.model, eng.opt, device="cpu")
    cpu, _ = cpu_eng.control_step(tree_map(lambda x: x.cpu(), params), tree_map(lambda x: x.cpu(), state.sim),
                                  pd, env.decimation)
    assert float(cpu.contact_forces.abs().sum()) > 0 and _step_rel(card, cpu) <= 1e-3


@pytest.mark.cuda
def test_sdc_lanes_control_step_kernel_matches_plain(cuda_device):
    """A lanes control step with soft dynamic correction (alpha 0.1) at 4096
    envs, kernel 1 against its plain version as the solve."""
    env = _v1_env(4096, cuda_device, ["env.config.soft_dynamic_correction.enable=true"])
    state = env.reset_to_start(env.init_state())
    zero = torch.zeros((4096, env.nd), device=cuda_device)
    with torch.no_grad():
        for _ in range(5):
            state, _, _, _, _ = env.step(state, zero)
    outs = {}
    for name, solve in (("kernel", ck.apgd_lanes), ("plain", ck.apgd_lanes_plain)):
        env.lanes_engine.contact_solve = solve
        pre = env._sdc_pre_fn(state, state.sim)
        outs[name], _ = env.lanes_engine.control_step_batched(
            env.sim_params, state.sim, lambda st: torch.zeros_like(st.dof_pos), env.decimation,
            paramsT=env.paramsT, pre_substep_fn=pre)
    env.lanes_engine.contact_solve = ck.apgd_lanes
    assert _step_rel(outs["kernel"], outs["plain"]) <= 1e-3


@pytest.mark.cuda
def test_moe_and_phase_aware_networks_on_card_match_cpu(cuda_device):
    from pbhc_tpu_torch.agents.networks import MoEMLP, PhaseAwareActor, PhaseAwareCritic, flax_init_

    g = torch.Generator().manual_seed(0)
    x = torch.randn((512, 380), generator=g)
    x[:, 100] = torch.rand((512,), generator=g)
    for net in (MoEMLP(380, (256, 128), 23, 4, 2), PhaseAwareActor(380, (256, 128), 23, 100, embed_type="Learnable"),
                PhaseAwareCritic(380, (256, 128), 21, 100)):
        flax_init_(net, torch.Generator().manual_seed(1))
        with torch.no_grad():
            want = net(x)
            got = net.to(cuda_device)(x.to(cuda_device))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for w, o in zip(want, got):
            np.testing.assert_allclose(o.cpu().numpy(), w.numpy(), atol=1e-5 * max(1.0, float(w.abs().max())))


@pytest.mark.cuda
def test_suite_config_2_launches_kernel_1(cuda_device):
    """The benchmark suite's config 2 (walk tracking, 64 envs, lanes) on the
    card: 4 launches of kernel 1 per control step over the warm-up and the
    timed steps, none of kernel 2, finite reward sums."""
    from pbhc_tpu_torch.eval import benchmarks

    ck.apgd_lanes.launches = ck.apgd_envfirst.launches = 0
    res = benchmarks.bench_walk64("cuda")
    torch.cuda.synchronize()
    d = res["detail"]
    assert d["num_envs"] == 64 and res["value"] > 0 and all(np.isfinite(d["reward_sums"]))
    assert ck.apgd_lanes.launches == 4 * (d["warmup_steps"] + d["steps"])
    assert ck.apgd_envfirst.launches == 0


# ------------------------------------------------------------------ kernel 3

POS_TOL, VEL_TOL, MINV_TOL = 1e-5, 1e-4, 1e-4


def _close(name, got, want, tol):
    assert bool(torch.isfinite(got).all()), f"{name}: not finite"
    err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
    assert err <= tol, f"{name}: max diff {err:.3e} of its scale > {tol:g}"


def _dynamics_matches_plain(lanes, paramsT, stT, tauT):
    """Kernel 3's two entries against the plain version on these inputs,
    each launch counted once."""
    before = (dk.lanes_dynamics.launches, dk.lanes_body_state.launches)
    out = lanes._pre_contact(paramsT, stT, tauT)
    body = dk.lanes_body_state(lanes, stT)
    ref = lanes._pre_contact_plain(paramsT, stT, tauT)
    body_ref = lanes._body_state_plain(stT)
    torch.cuda.synchronize()
    assert (dk.lanes_dynamics.launches, dk.lanes_body_state.launches) == (before[0] + 1, before[1] + 1)
    # the gaps decide the contact rows and which are active: equal bit for bit
    assert torch.equal(out[3], ref[3]), "phi"
    assert torch.equal(body[0], body_ref[0]), "body_pos"
    _close("u_plus", out[0], ref[0], VEL_TOL)
    _close("M_inv", out[1], ref[1], MINV_TOL)
    _close("Jf", out[2], ref[2], POS_TOL)
    _close("phi", out[3], ref[3], POS_TOL)
    if lanes.P:
        _close("C", out[4], ref[4], POS_TOL)
    else:
        assert out[4] is None
    for name, a, b, atol in zip(("body_pos", "body_quat", "body_lin_vel", "body_ang_vel"), body, body_ref,
                                (POS_TOL, POS_TOL, VEL_TOL, VEL_TOL)):
        _close(name, a, b, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("robot,N,options", [
    ("g1_23dof_lock_wrist", 4096, {}), ("g1_23dof_lock_wrist", 4096, {"self_collision": False}),
    ("g1_29dof_rev_1_0", 2048, {}), ("g1_29dof_rev_1_0", 2048, {"energy_projection": False}),
    ("g1_29dof_rev_1_0", 1001, {"self_collision": False})])
def test_dynamics_kernel_matches_plain(cuda_device, robot, N, options):
    """Kernel 3 at the benchmark's shapes (kb1's 23-DoF model at 4096 envs,
    kb2's 29-DoF model at 2048), with pairs and without, with the energy
    projection off and at a ragged N, on random states."""
    from pbhc_tpu_torch.eval.kernel_bench import dynamics_problem
    from pbhc_tpu_torch.model.g1 import load_g1_sim_model
    from pbhc_tpu_torch.sim.engine import Engine, EngineOptions

    lanes = Engine(load_g1_sim_model(robot), EngineOptions(**options), device=cuda_device).lanes()
    _dynamics_matches_plain(lanes, *dynamics_problem(lanes, N, N))


@pytest.mark.cuda
@pytest.mark.parametrize("run", ["kb1_side_kick", "kb2_teacher29_r5", "terrain_walk_v3"])
def test_dynamics_kernel_matches_plain_on_rollout_states(cuda_device, run):
    """Kernel 3 on the states of each path's rollout after 10 control steps
    from clip start: the side-kick's policy at 4096 envs, the 29-DoF teacher's
    env at 2048 holding the default pose, the heightfield run's policy at
    4096 (its ground rows' gaps read the heightfield in PyTorch); the PD
    torques of the step's targets."""
    from pbhc_tpu_torch.eval import batch_eval

    if run == "kb2_teacher29_r5":
        env = _kb2_env(run, 2048, cuda_device)
        state = env.reset_to_start(env.init_state())
        obs, state.history = env.compute_observations(state)
        act = lambda o: torch.zeros((2048, env.num_actions), device=cuda_device)
    else:
        ckpt = {"kb1_side_kick": "artifacts/kb1_side_kick/ckpt/model_10500.pkl",
                "terrain_walk_v3": "artifacts/terrain_walk_v3/ckpt/model_6500.pkl"}[run]
        env, actor, _ = batch_eval.load(ckpt, 4096, device=cuda_device)
        state, obs = batch_eval.start_episodes(env)
        act = lambda o: batch_eval.act_mean(actor, o)
    with torch.no_grad():
        for _ in range(10):
            state, obs, _, _, _ = env.step(state, act(obs))
        lanes = env.lanes_engine
        assert lanes is not None and (run != "terrain_walk_v3" or env.terrain is not None)
        target = act(obs) * env.action_scales + state.default_dof_pos
        sim = state.sim
        tau = torch.clamp(state.kp_scale * env.p_gains * (target - sim.dof_pos) - state.kd_scale * env.d_gains
                          * sim.dof_vel, -env.torque_limits, env.torque_limits)
        _dynamics_matches_plain(lanes, env.paramsT, lanes._to_lanes(sim), tau.T)


@pytest.mark.cuda
def test_graphed_control_step_counts_kernel_3(cuda_device):
    """A graphed serving step adds 4 launches of kernel 3's dynamics entry
    (one a substep), 1 of its body-state entry and 4 of kernel 1, as the
    eager step does."""
    from pbhc_tpu_torch.eval import batch_eval

    env, actor, _ = batch_eval.load("artifacts/kb1_side_kick/ckpt/model_10500.pkl", 512, device=cuda_device)
    state, obs = batch_eval.start_episodes(env)
    counts = lambda: (dk.lanes_dynamics.launches, dk.lanes_body_state.launches, ck.apgd_lanes.launches)
    for graphed in (0, 1, 2, 3):
        before = counts()
        with torch.no_grad():
            state, obs, *_ = env.step(state, batch_eval.act_mean(actor, obs))
        torch.cuda.synchronize()
        assert env.stage_graphs.counts["engine"]["graphed"] == graphed
        assert tuple(b - a for a, b in zip(before, counts())) == (4, 1, 4)
    assert torch.isfinite(state.sim.body_pos).all()
