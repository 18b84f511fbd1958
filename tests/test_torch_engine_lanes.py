"""Port parity: the lanes physics engine against `pbhc_tpu`'s LanesEngine.

Setups follow tests/test_engine_lanes.py::test_lanes_parity_with_contact
(G1 23-DoF, per-env mass/CoM/friction draws, root at z = 0.755 m so the
soles touch the ground, small random joint state, PD torques), drawn from a
numpy seed. Engine options are the side-kick run's (16 APGD iterations,
8 ground + 4 pair active rows, 4 position iterations). The JAX side of the
whole control step is held against the port in tests/test_torch_env.py.

Tolerances: positions and quaternions 1e-5 absolute, velocities 1e-4, the
mass matrix 1e-4 relative, contact forces 1e-3 relative to their largest
magnitude (impulses / dt magnify the solver's f32 noise 200x).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu.model.g1 import load_g1_sim_model as jax_sim_model  # noqa: E402
from pbhc_tpu.sim import engine as je  # noqa: E402
from pbhc_tpu.sim.engine_lanes import LanesEngine as JaxLanes  # noqa: E402
from pbhc_tpu_torch.model.g1 import load_g1_sim_model  # noqa: E402
from pbhc_tpu_torch.sim import engine as te  # noqa: E402
from pbhc_tpu_torch.sim.engine_lanes import LanesEngine, _spd_inverse_lanes  # noqa: E402

N = 8
OPTIONS = dict(solver_iters=16, contact_cap=8, pair_cap=4, pos_iters=4)
KP, KD = 100.0, 2.0


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(1.0, np.abs(np.asarray(a)).max())


@pytest.fixture(scope="module")
def setup():
    kw = OPTIONS
    jeng = je.Engine(jax_sim_model(), je.EngineOptions(**kw))
    teng = te.Engine(load_g1_sim_model(), te.EngineOptions(**kw), device="cpu")
    rng = np.random.default_rng(0)
    p0 = jeng.default_params()
    nb, nd = jeng.nb, jeng.nd
    pn = dict(mass=np.asarray(p0.mass)[None] * rng.uniform(0.9, 1.1, (N, nb)),
              com=np.asarray(p0.com)[None] + rng.normal(size=(N, nb, 3)) * 0.002,
              inertia=np.broadcast_to(np.asarray(p0.inertia), (N, nb, 3, 3)),
              friction=rng.uniform(0.5, 1.2, N), restitution=np.zeros(N),
              armature=np.broadcast_to(np.asarray(p0.armature), (N, nd)),
              dof_damping=np.broadcast_to(np.asarray(p0.dof_damping), (N, nd)),
              dof_frictionloss=np.broadcast_to(np.asarray(p0.dof_frictionloss), (N, nd)))
    st0 = jeng.default_state(root_pos=(0.0, 0.0, 0.755))
    sn = {f.name: np.broadcast_to(np.asarray(getattr(st0, f.name)),
                                  (N,) + np.shape(getattr(st0, f.name))).copy()
          for f in dataclasses.fields(st0)}
    sn["dof_pos"] = rng.normal(size=(N, nd)) * 0.02
    sn["dof_vel"] = rng.normal(size=(N, nd)) * 0.05
    jp = je.SimParams(**{k: jnp.asarray(v, jnp.float32) for k, v in pn.items()})
    tp = te.SimParams(**{k: torch.tensor(np.asarray(v), dtype=torch.float32) for k, v in pn.items()})
    js = jax.vmap(jeng.derived_state)(jp, je.SimState(**{k: jnp.asarray(v, jnp.float32) for k, v in sn.items()}))
    ts = teng.derived_state(tp, te.SimState(**{k: torch.tensor(v, dtype=torch.float32) for k, v in sn.items()}))
    jl = JaxLanes(jeng)
    jl.jit_substep = jax.jit(jl._substep)
    return jeng, jl, teng, LanesEngine(teng), jp, tp, js, ts


def test_derived_state(setup):
    *_, js, ts = setup
    for f in ("body_pos", "body_quat", "body_lin_vel", "body_ang_vel"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), atol=1e-5, err_msg=f)


def test_mass_matrix_and_inverse(setup):
    _, jl, _, tl, jp, tp, js, ts = setup
    jpT = {"mass": jp.mass.T, "com": jnp.moveaxis(jp.com, 0, -1).transpose(1, 0, 2),
           "inertia": jnp.transpose(jp.inertia, (2, 3, 1, 0)), "armature": jp.armature.T}
    tpT = tl.params_to_lanes(tp)
    jst, tst = jl._to_lanes(js), tl._to_lanes(ts)
    p_w, R_w = jl._fk(jst["q"], jst["rq"], jst["rp"])
    I_o, Phi_d, _, _ = jl._spatial_quantities(jpT, p_w, R_w)
    M = jl._mass_matrix(jpT, I_o, Phi_d)
    jMinv = np.asarray(jl._m_inverse(M))
    M = np.asarray(M)
    tp_w, tR_w = tl._fk(tst["q"], tst["rq"], tst["rp"])
    tI_o, tPhi_d, _, _ = tl._spatial_quantities(tpT, tp_w, tR_w)
    tM = tl._mass_matrix(tpT, tI_o, tPhi_d)
    assert _rel(M, tM.numpy()) < 1e-4
    Minv = tl._m_inverse(tM).numpy()
    eye = np.einsum("ijn,jkn->ikn", Minv, tM.numpy())
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(M.shape[0])[:, :, None], eye.shape), atol=1e-3)
    assert _rel(jMinv, Minv) < 1e-3


def test_spd_inverse_lanes():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(7, 7, 16)).astype(np.float32)
    M = np.einsum("ikn,jkn->ijn", X, X) + 0.5 * np.eye(7)[:, :, None]
    inv = _spd_inverse_lanes(torch.as_tensor(M, dtype=torch.float32)).numpy()
    ref = np.linalg.inv(np.moveaxis(M.astype(np.float64), -1, 0))
    np.testing.assert_allclose(np.moveaxis(inv, -1, 0), ref, rtol=1e-3, atol=1e-3)


def test_active_set_indices_match_jax():
    rng = np.random.default_rng(5)
    phi = rng.normal(size=(64, 38)).astype(np.float32)
    phi[:, 3] = phi[:, 4]                                    # a tie: the lower index wins
    for kw in (dict(contact_cap=8, pair_cap=4), dict(contact_cap=8, pair_cap=0), dict(contact_cap=0)):
        ref = je.active_set_indices(je.EngineOptions(**kw), 21, 17, jnp.asarray(phi))
        out = te.active_set_indices(te.EngineOptions(**kw), 21, 17, torch.as_tensor(phi))
        if ref is None:
            assert out is None
        else:
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("substeps", [1, 4])
def test_substeps_match_jax(setup, substeps):
    """1 substep, and 4 substeps warm-started from each other's impulses."""
    _, jl, _, tl, jp, tp, js, ts = setup
    jpT = {"mass": jp.mass.T, "com": jnp.transpose(jp.com, (2, 1, 0)),
           "inertia": jnp.transpose(jp.inertia, (2, 3, 1, 0)), "friction": jp.friction,
           "restitution": jp.restitution, "armature": jp.armature.T,
           "dof_damping": jp.dof_damping.T, "dof_frictionloss": jp.dof_frictionloss.T}
    tpT = tl.params_to_lanes(tp)
    jst, tst = jl._to_lanes(js), tl._to_lanes(ts)
    jsub = jl.jit_substep
    jlam = jnp.zeros((jl.KT, 3, N))
    tlam = torch.zeros((tl.KT, 3, N))
    for _ in range(substeps):
        jtau = -KP * jst["q"] - KD * jst["qd"]
        ttau = -KP * tst["q"] - KD * tst["qd"]
        jst, jlam = jsub(jpT, jst, jtau, jlam)
        tst, tlam = tl._substep(tpT, tst, ttau, tlam)
    for k, tol in (("rp", 1e-5), ("rq", 1e-5), ("q", 1e-5), ("rv", 1e-4), ("rw", 1e-4), ("qd", 1e-4)):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), atol=tol, err_msg=k)
    assert _rel(np.asarray(jlam), tlam.numpy()) < 1e-3


def test_control_step_stands_on_soles(setup):
    """Port only: a PD control step keeps both soles loaded with about the
    robot's weight (the JAX side of the control step is in test_torch_env)."""
    *_, tl, _, tp, _, ts = setup
    tout, ttau = tl.control_step_batched(tp, ts, lambda st: -KP * st.dof_pos - KD * st.dof_vel, 4)
    assert torch.isfinite(tout.body_pos).all() and ttau.shape == (N, tl.nd)
    assert ((tout.contact_forces[..., 2].sum(1) - 311.0).abs() < 40).all()


def test_contact_solve_is_the_kernel_wrapper(setup):
    from pbhc_tpu_torch.sim.contact_kernel import apgd_lanes

    assert setup[3].contact_solve is apgd_lanes


def test_non_f32_matvec_is_refused():
    eng = te.Engine(load_g1_sim_model(), te.EngineOptions(contact_matvec_dtype="bfloat16"), device="cpu")
    with pytest.raises(NotImplementedError, match="float32"):
        LanesEngine(eng)
