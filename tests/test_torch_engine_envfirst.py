"""Port parity: the env-first batched step (`solver: pallas`) and kernel 2's
plain version, against `pbhc_tpu` on the CPU.

JAX reaches its Pallas kernel `_apgd_kernel` through `solve_contacts_pallas`,
patched here to interpret mode as tests/test_pallas_contact.py does. N = 128.

Tolerances:
- kernel 2's plain version vs `solve_contacts_pallas(interpret=True)`:
  atol 1e-4, the repo's kernel-parity bound (the two sum the matvecs in
  different orders);
- `_pre_contact` vs `vmap(Engine._pre_contact)`: atol 1e-4 on u_plus, J, phi
  and C; M_inv relative 1e-4 of its largest entry (the port inverts M by a
  branch-sparse Cholesky, JAX by Gauss-Jordan: the same matrix to f32
  rounding of its scale, which reaches ~1e2 on the light distal links; seen
  8e-6 relative);
- `substep_batched`: states and impulses atol 1e-4;
- 10 control steps of the tracking env with `solver=pallas`: the serving
  path's tolerances of tests/test_torch_env.py (`SIM_TOL`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import pbhc_tpu.sim.pallas_contact as pc  # noqa: E402
from pbhc_tpu.config.loader import compose as jax_compose  # noqa: E402
from pbhc_tpu.envs.tracking_env import MotionTrackingEnv as JaxEnv  # noqa: E402
from pbhc_tpu.model.g1 import load_g1_sim_model as jax_sim_model  # noqa: E402
from pbhc_tpu.sim import engine as je  # noqa: E402
from pbhc_tpu_torch.config.loader import compose  # noqa: E402
from pbhc_tpu_torch.envs.tracking_env import MotionTrackingEnv  # noqa: E402
from pbhc_tpu_torch.model.g1 import load_g1_sim_model  # noqa: E402
from pbhc_tpu_torch.sim import contact_kernel as ck  # noqa: E402
from pbhc_tpu_torch.sim import engine as te  # noqa: E402
from test_torch_env import OFF, SIM_TOL  # noqa: E402

N = 128
ATOL = 1e-4
SELS = ["exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking", "rewards=motion_tracking",
        "domain_rand=main", "simulator=tpu"]
MOTION = "assets/motions/Horse-stance_punch.pkl"
# the training config's engine options (`config/simulator/tpu.yaml`) and the
# defaults, which solve every row: R = 12 and R = 38
OPTIONS = {"training": dict(solver_iters=16, contact_cap=8, pair_cap=4, pos_iters=4),
           "all_rows": {}}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pc.solve_contacts_pallas

    def patched(A, b, mu, active, iters=32, interpret=False):
        return orig(A, b, mu, active, iters=iters, interpret=True)

    monkeypatch.setattr(pc, "solve_contacts_pallas", patched)


@pytest.mark.parametrize("R", [12, 38])
def test_plain_kernel_matches_pallas_interpret(R):
    rng = np.random.default_rng(R)
    n = 3 * R
    J = (rng.normal(size=(N, n, 40)) * 0.3).astype(np.float32)
    A = (np.einsum("niv,njv->nij", J, J) + 1e-2 * np.eye(n)).astype(np.float32)
    b = rng.normal(size=(N, n)).astype(np.float32)
    mu = rng.uniform(0.2, 1.2, size=N).astype(np.float32)
    active = (rng.uniform(size=(N, R)) > 0.3).astype(np.float32)
    ref = pc.solve_contacts_pallas(*map(jnp.asarray, (A, b, mu, active)), iters=16)
    before = ck.apgd_envfirst.launches
    out = ck.apgd_envfirst(*map(torch.as_tensor, (A, b, mu, active)), iters=16)
    assert ck.apgd_envfirst.launches == before       # CPU tensors: plain version, no launch
    assert out.shape == (N, R, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def _engines(options):
    jeng = je.Engine(jax_sim_model(), je.EngineOptions(solver="pallas", **options))
    teng = te.Engine(load_g1_sim_model(), te.EngineOptions(**options), device="cpu")
    return jeng, teng


def _states(jeng, kind):
    """Standing, or the feet-penetrating bounce of
    tests/test_pallas_contact.py::test_restitution_parity_across_solvers
    (restitution 0.5, falling at 1 m/s), with a little noise on the joints."""
    params = jeng.default_params()
    rng = np.random.default_rng(0)
    if kind == "standing":
        st = jeng.default_state(root_pos=(0.0, 0.0, 0.793))
        rest = 0.0
    else:
        st = dataclasses.replace(jeng.default_state(root_pos=(0.0, 0.0, 0.76)),
                                 root_lin_vel=jnp.asarray([0.0, 0.0, -1.0]))
        rest = 0.5
    batch = lambda x: np.broadcast_to(np.asarray(x), (N,) + np.shape(x)).astype(np.float32).copy()
    params = {f.name: batch(getattr(params, f.name)) for f in dataclasses.fields(params)}
    params["restitution"][:] = rest
    params["friction"] = rng.uniform(0.5, 1.2, size=N).astype(np.float32)
    st = {f.name: batch(getattr(st, f.name)) for f in dataclasses.fields(st)}
    st["dof_pos"] += (0.05 * rng.normal(size=st["dof_pos"].shape)).astype(np.float32)
    st["dof_vel"] += (0.3 * rng.normal(size=st["dof_vel"].shape)).astype(np.float32)
    tau = (5.0 * rng.normal(size=(N, jeng.nd))).astype(np.float32)
    return params, st, tau


def _both(jeng, params, st, tau):
    jp = je.SimParams(**{k: jnp.asarray(v) for k, v in params.items()})
    js = je.SimState(**{k: jnp.asarray(v) for k, v in st.items()})
    tp = te.SimParams(**{k: torch.as_tensor(v) for k, v in params.items()})
    ts = te.SimState(**{k: torch.as_tensor(v) for k, v in st.items()})
    return jp, js, tp, ts, jnp.asarray(tau), torch.as_tensor(tau)


@pytest.mark.parametrize("kind", ["standing", "bounce"])
def test_pre_contact_matches_jax(kind):
    jeng, teng = _engines(OPTIONS["all_rows"])
    jp, js, tp, ts, jt, tt = _both(jeng, *_states(jeng, kind))
    ref = jax.jit(jax.vmap(jeng._pre_contact))(jp, js, jt)
    out = teng._pre_contact(tp, ts, tt)
    for name, r, o in zip(("u_plus", "M_inv", "J", "phi", "C"), ref, out):
        r = np.asarray(r)
        assert tuple(o.shape) == r.shape, name
        atol = ATOL * max(1.0, np.abs(r).max()) if name == "M_inv" else ATOL
        np.testing.assert_allclose(o.numpy(), r, atol=atol, err_msg=name)


@pytest.mark.parametrize("opts", sorted(OPTIONS))
@pytest.mark.parametrize("kind", ["standing", "bounce"])
def test_substep_batched_matches_jax(kind, opts):
    jeng, teng = _engines(OPTIONS[opts])
    jp, js, tp, ts, jt, tt = _both(jeng, *_states(jeng, kind))
    jst, jlam = jax.jit(lambda s, t: jeng.substep_batched(jp, s, t))(js, jt)
    tst, tlam = teng.substep_batched(tp, ts, tt)
    assert float(np.abs(np.asarray(jlam)).max()) > 1e-3     # contacts were solved
    np.testing.assert_allclose(tlam.numpy(), np.asarray(jlam), atol=ATOL, err_msg="impulses")
    for f in ("root_pos", "root_quat", "root_lin_vel", "root_ang_vel", "dof_pos", "dof_vel"):
        np.testing.assert_allclose(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)), atol=ATOL,
                                   err_msg=f)


def test_env_pallas_ten_control_steps():
    ovs = [f"num_envs={N}", f"robot.motion.motion_file={MOTION}", "simulator.config.solver=pallas", *OFF]
    jenv = JaxEnv(jax_compose("pbhc_tpu/config", SELS, ovs), N, jax.random.PRNGKey(0))
    js = jenv.reset_to_start(jenv.init_state(jax.random.PRNGKey(1)), jax.random.PRNGKey(1))
    _, hist = jenv._compute_observations(js, jax.random.PRNGKey(2))
    js = dataclasses.replace(js, history=hist)
    tenv = MotionTrackingEnv(compose(SELS, ovs), N, device="cpu")
    assert tenv.solver == "pallas" and tenv.lanes_engine is None
    ts = tenv.reset_to_start(tenv.init_state())
    ts.history = tenv.compute_observations(ts)[1]
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(0)
    before = ck.apgd_envfirst.launches
    for i in range(10):
        acts = (0.3 * rng.normal(size=(N, tenv.nd))).astype(np.float32)
        js, jobs, jrew, jdone, _ = jstep(js, jnp.asarray(acts))
        ts, tobs, trew, tdone, _ = tenv.step(ts, torch.as_tensor(acts))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone), err_msg=f"done step {i}")
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=1e-3, atol=1e-5,
                                   err_msg=f"rewards step {i}")
        for f, tol in SIM_TOL.items():
            np.testing.assert_allclose(getattr(ts.sim, f).numpy(), np.asarray(getattr(js.sim, f)),
                                       atol=tol, err_msg=f"{f} step {i}")
        for g in ("actor_obs", "critic_obs"):
            np.testing.assert_allclose(tobs[g].numpy(), np.asarray(jobs[g]), atol=2e-3, err_msg=g)
    assert ck.apgd_envfirst.launches == before           # CPU: the plain version ran


def test_env_pallas_needs_multiple_of_128_envs():
    """Kernel 2's batched step needs N % 128 == 0; at other N `solver: pallas`
    takes the per-env branch, as the JAX env does (`tracking_env.py:874-896`;
    its parity: tests/test_torch_engine_perenv.py)."""
    cfg = compose(SELS, ["num_envs=64", f"robot.motion.motion_file={MOTION}",
                         "simulator.config.solver=pallas"])
    env = MotionTrackingEnv(cfg, 64, device="cpu")
    assert env.physics == "per_env" and env.engine.opt.solver == "pallas"
    assert MotionTrackingEnv(compose(SELS, [f"num_envs={N}", f"robot.motion.motion_file={MOTION}",
                                            "simulator.config.solver=pallas"]), N, device="cpu").physics == "batched"
    state = env.reset_to_start(env.init_state())
    state.history = env.compute_observations(state)[1]
    before = ck.apgd_envfirst.launches
    state, _, _, _, _ = env.step(state, torch.zeros((64, env.nd)))
    assert bool(torch.isfinite(state.sim.dof_vel).all()) and ck.apgd_envfirst.launches == before
