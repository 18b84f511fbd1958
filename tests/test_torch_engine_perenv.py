"""Port parity: the per-env engine (`spd_inverse`, `Engine._solve_contacts`
with APGD and with sequential PGS, `substep`, `control_step`), against
`pbhc_tpu`'s per-env functions under `jax.vmap` on the CPU, and the tracking
env's per-env branch (`solver: pallas` at N % 128 != 0, `apgd`, `pgs`).

The JAX package runs these solves as XLA code, not through a Pallas kernel,
and so does the port (plain PyTorch over the env batch). N = 64 envs (96 for
the env's `pallas` fallback), standing or bouncing states from
tests/test_torch_engine_envfirst.py, on the plane and on the terrain_walk_v3
heightfield.

Tolerances:
- `spd_inverse`: 1e-5 per unit of the largest entry of the inverse (both
  run the same Gauss-Jordan updates in f32);
- `substep` and `control_step` (4 substeps, each warm-started from the one
  before when `warm_start`): states and impulses 1e-4 absolute, as
  tests/test_torch_engine_envfirst.py holds `substep_batched` (the port
  inverts M by the lanes engine's Cholesky, JAX by Gauss-Jordan; the solves
  sum in other orders); contact forces 1e-2 N per 100 N of load (the
  impulses' bound over dt = 5 ms); world positions on the heightfield two
  f32 ulps per substep beyond that, as in tests/test_torch_terrain.py;
- 10 control steps of the env's per-env branch: tests/test_torch_env.py's
  `SIM_TOL`, observations 2e-3, rewards 1e-3 relative, `done` exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu.envs import terrain as jterrain  # noqa: E402
from pbhc_tpu.model.g1 import load_g1_sim_model as jax_sim_model  # noqa: E402
from pbhc_tpu.sim import engine as je  # noqa: E402
from pbhc_tpu_torch.config.loader import load_snapshot  # noqa: E402
from pbhc_tpu_torch.model.g1 import load_g1_sim_model  # noqa: E402
from pbhc_tpu_torch.sim import contact_kernel as ck  # noqa: E402
from pbhc_tpu_torch.sim import engine as te  # noqa: E402
from test_torch_env_options import _envs, _lockstep  # noqa: E402

N = 64
ATOL = 1e-4
# the training config's rows (R = 12) and the defaults, which solve every row (R = 38)
OPTIONS = {"training": dict(solver_iters=16, contact_cap=8, pair_cap=4, pos_iters=4), "all_rows": {}}


def _engines(solver, options):
    jeng = je.Engine(jax_sim_model(), je.EngineOptions(solver=solver, **options))
    teng = te.Engine(load_g1_sim_model(), te.EngineOptions(solver=solver, **options), device="cpu")
    return jeng, teng


def _states(jeng, kind, n=N, origins=None):
    """n envs standing (at `origins` on a heightfield) or bouncing (falling at
    1 m/s with restitution 0.5), with noise on the joints, per-env friction
    and torques; numpy dicts."""
    rng = np.random.default_rng(0)
    batch = lambda x: np.broadcast_to(np.asarray(x), (n,) + np.shape(x)).astype(np.float32).copy()
    params = jeng.default_params()
    params = {f.name: batch(getattr(params, f.name)) for f in dataclasses.fields(params)}
    params["friction"] = rng.uniform(0.5, 1.2, size=n).astype(np.float32)
    z, vz = (0.793, 0.0) if kind == "standing" else (0.76, -1.0)
    st = jeng.default_state(root_pos=(0.0, 0.0, z))
    st = {f.name: batch(getattr(st, f.name)) for f in dataclasses.fields(st)}
    st["root_lin_vel"][:, 2] = vz
    params["restitution"][:] = 0.0 if kind == "standing" else 0.5
    if origins is not None:
        st["root_pos"] = (origins + np.asarray([0.0, 0.0, 0.755])).astype(np.float32)
    st["dof_pos"] += (0.05 * rng.normal(size=st["dof_pos"].shape)).astype(np.float32)
    st["dof_vel"] += (0.3 * rng.normal(size=st["dof_vel"].shape)).astype(np.float32)
    tau = (5.0 * rng.normal(size=(n, jeng.nd))).astype(np.float32)
    return params, st, tau


def _both(params, st):
    jp = je.SimParams(**{k: jnp.asarray(v) for k, v in params.items()})
    js = je.SimState(**{k: jnp.asarray(v) for k, v in st.items()})
    tp = te.SimParams(**{k: torch.as_tensor(v) for k, v in params.items()})
    ts = te.SimState(**{k: torch.as_tensor(v) for k, v in st.items()})
    return jp, js, tp, ts


def _ulp(x):
    return float(np.spacing(np.float32(np.abs(np.asarray(x)).max())))


def _compare(tst, jst, substeps=1, fields=("root_pos", "root_quat", "root_lin_vel", "root_ang_vel", "dof_pos",
                                          "dof_vel")):
    for f in fields:
        r = np.asarray(getattr(jst, f))
        atol = ATOL + (2 * substeps * _ulp(r) if f in ("root_pos", "body_pos") else 0.0)
        np.testing.assert_allclose(getattr(tst, f).numpy(), r, atol=atol, err_msg=f)


def test_spd_inverse_matches_jax():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(N, 29, 29)).astype(np.float32)
    M = (np.einsum("nij,nkj->nik", X, X) / 29 + 0.05 * np.eye(29)).astype(np.float32)
    want = np.asarray(jax.jit(je.spd_inverse)(jnp.asarray(M)))
    got = te.spd_inverse(torch.as_tensor(M)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(np.einsum("nij,njk->nik", M, got), np.broadcast_to(np.eye(29), M.shape), atol=1e-3)


@pytest.mark.parametrize("solver,opts,warm", [("apgd", "training", True), ("apgd", "all_rows", False),
                                              ("pgs", "training", True), ("pgs", "all_rows", False)])
def test_substep_matches_jax(solver, opts, warm):
    """One substep from a warm start (the impulses of a first substep, fed to
    both) or from zero, on a bouncing batch."""
    jeng, teng = _engines(solver, OPTIONS[opts])
    params, st, tau = _states(jeng, "bounce")
    jp, js, tp, ts = _both(params, st)
    jsub = jax.jit(jax.vmap(jeng.substep))
    lam_warm = None
    if warm:
        _, lam0 = jsub(jp, js, jnp.asarray(tau), jnp.zeros((N, jeng.KT, 3)))
        lam_warm = np.asarray(lam0)
        assert np.abs(lam_warm).max() > 1e-3
    jst, jlam = jsub(jp, js, jnp.asarray(tau), None if lam_warm is None else jnp.asarray(lam_warm))
    tst, tlam = teng.substep(tp, ts, torch.as_tensor(tau), None if lam_warm is None else torch.as_tensor(lam_warm))
    assert float(np.abs(np.asarray(jlam)).max()) > 1e-3     # contacts were solved
    np.testing.assert_allclose(tlam.numpy(), np.asarray(jlam), atol=ATOL, err_msg="impulses")
    _compare(tst, jst)


@pytest.mark.parametrize("solver,opts,warm_start", [("apgd", "training", True), ("apgd", "training", False),
                                                    ("apgd", "all_rows", True), ("pgs", "training", True)])
def test_control_step_matches_jax(solver, opts, warm_start):
    """4 substeps under a standing batch's PD torques with a pre-substep hook
    (a 5% pull of the joint velocities towards 0): the impulses carry from
    substep to substep when `warm_start`."""
    jeng, teng = _engines(solver, dict(OPTIONS[opts], warm_start=warm_start))
    params, st, tau = _states(jeng, "standing")
    jp, js, tp, ts = _both(params, st)
    kp, kd = 40.0, 2.0

    def jstep(p, s, tau_env):
        return jeng.control_step(p, s, lambda x, key: tau_env - kp * x.dof_pos - kd * x.dof_vel, 4,
                                 pre_substep_fn=lambda x: dataclasses.replace(x, dof_vel=0.95 * x.dof_vel))

    jst, jtau = jax.jit(jax.vmap(jstep))(jp, js, jnp.asarray(tau))
    tt = torch.as_tensor(tau)
    tst, ttau = teng.control_step(tp, ts, lambda x: tt - kp * x.dof_pos - kd * x.dof_vel, 4,
                                  pre_substep_fn=lambda x: dataclasses.replace(x, dof_vel=0.95 * x.dof_vel))
    np.testing.assert_allclose(ttau.numpy(), np.asarray(jtau), atol=1e-3, err_msg="torques")
    _compare(tst, jst, 4, ("root_pos", "root_quat", "root_lin_vel", "root_ang_vel", "dof_pos", "dof_vel",
                           "body_pos", "body_quat"))
    cf = np.asarray(jst.contact_forces)
    assert np.abs(cf).max() > 10.0                             # standing on its soles
    np.testing.assert_allclose(tst.contact_forces.numpy(), cf, atol=1e-2 * max(1.0, np.abs(cf).max() / 100.0))


@pytest.mark.parametrize("solver", ["apgd", "pgs"])
def test_substep_on_heightfield(solver):
    """The training rows on the terrain_walk_v3 field, envs standing at tile
    origins 29-181 m from the world origin."""
    terr = jterrain.Terrain.from_run_config(dict(load_snapshot("terrain_walk_v3").terrain))
    jeng, teng = _engines(solver, OPTIONS["training"])
    for e in (jeng, teng):
        e.set_terrain(terr.height_field, terr.cfg.horizontal_scale)
    rows, cols = terr.env_origins.shape[:2]
    origins = np.stack([terr.env_origins[i % min(rows, 3), (i * 7) % cols] for i in range(N)])
    params, st, tau = _states(jeng, "standing", origins=origins)
    jp, js, tp, ts = _both(params, st)
    jst, jlam = jax.jit(jax.vmap(jeng.substep))(jp, js, jnp.asarray(tau))
    tst, tlam = teng.substep(tp, ts, torch.as_tensor(tau))
    assert float(np.abs(np.asarray(jlam)).max()) > 1e-3
    np.testing.assert_allclose(tlam.numpy(), np.asarray(jlam), atol=ATOL, err_msg="impulses")
    _compare(tst, jst)


@pytest.mark.parametrize("solver,n", [("pallas", 96), ("apgd", 64)])
def test_env_per_env_branch_ten_control_steps(solver, n):
    """The tracking env's per-env branch: `pallas` at N = 96 (JAX's fallback
    at N % 128 != 0) and `apgd`, 10 control steps under random actions, held
    as tests/test_torch_env_options.py holds its envs (an env whose state
    parts from JAX's at a jump that JAX's own step shows under a 1e-5 m
    nudge is set aside, at most an eighth of them)."""
    jenv, js, tenv, ts = _envs([f"num_envs={n}", f"simulator.config.solver={solver}"], n)
    assert tenv.physics == "per_env" and tenv.engine.opt.solver == solver
    before = (ck.apgd_lanes.launches, ck.apgd_envfirst.launches)
    _lockstep(jenv, js, tenv, ts, 10)
    assert (ck.apgd_lanes.launches, ck.apgd_envfirst.launches) == before     # no kernel on this branch
