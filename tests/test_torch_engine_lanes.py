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

The reduced-precision matvec (`contact_matvec_dtype` bfloat16 / float16) is
held to JAX by two bounds on the impulses, MV_ATOL and MV_MEAN_ATOL (see
there), for the solve alone (R = 12 and 38) and for a substep at N = 128
under each `lanes_contact_kernel`, where the substep's state gets a bound of
its own (MV_STATE_TOL).
"""
import functools
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
from pbhc_tpu.sim import pallas_contact  # noqa: E402
from pbhc_tpu_torch.model.g1 import load_g1_sim_model  # noqa: E402
from pbhc_tpu_torch.sim import contact_kernel as ck  # noqa: E402
from pbhc_tpu_torch.sim import engine as te  # noqa: E402
from pbhc_tpu_torch.sim import engine_lanes  # noqa: E402
from pbhc_tpu_torch.sim.engine_lanes import LanesEngine, _spd_inverse_lanes  # noqa: E402

N = 8
OPTIONS = dict(solver_iters=16, contact_cap=8, pair_cap=4, pos_iters=4)
KP, KD = 100.0, 2.0


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(1.0, np.abs(np.asarray(a)).max())


def _setup(n, **options):
    """JAX's and the port's engines with `options` and the same per-env
    params and state at `n` envs: (jeng, jl, teng, tl, jp, tp, js, ts)."""
    jeng = je.Engine(jax_sim_model(), je.EngineOptions(**options))
    teng = te.Engine(load_g1_sim_model(), te.EngineOptions(**options), device="cpu")
    rng = np.random.default_rng(0)
    p0 = jeng.default_params()
    nb, nd = jeng.nb, jeng.nd
    pn = dict(mass=np.asarray(p0.mass)[None] * rng.uniform(0.9, 1.1, (n, nb)),
              com=np.asarray(p0.com)[None] + rng.normal(size=(n, nb, 3)) * 0.002,
              inertia=np.broadcast_to(np.asarray(p0.inertia), (n, nb, 3, 3)),
              friction=rng.uniform(0.5, 1.2, n), restitution=np.zeros(n),
              armature=np.broadcast_to(np.asarray(p0.armature), (n, nd)),
              dof_damping=np.broadcast_to(np.asarray(p0.dof_damping), (n, nd)),
              dof_frictionloss=np.broadcast_to(np.asarray(p0.dof_frictionloss), (n, nd)))
    st0 = jeng.default_state(root_pos=(0.0, 0.0, 0.755))
    sn = {f.name: np.broadcast_to(np.asarray(getattr(st0, f.name)),
                                  (n,) + np.shape(getattr(st0, f.name))).copy()
          for f in dataclasses.fields(st0)}
    sn["dof_pos"] = rng.normal(size=(n, nd)) * 0.02
    sn["dof_vel"] = rng.normal(size=(n, nd)) * 0.05
    jp = je.SimParams(**{k: jnp.asarray(v, jnp.float32) for k, v in pn.items()})
    tp = te.SimParams(**{k: torch.tensor(np.asarray(v), dtype=torch.float32) for k, v in pn.items()})
    js = jax.vmap(jeng.derived_state)(jp, je.SimState(**{k: jnp.asarray(v, jnp.float32) for k, v in sn.items()}))
    ts = teng.derived_state(tp, te.SimState(**{k: torch.tensor(v, dtype=torch.float32) for k, v in sn.items()}))
    jl = JaxLanes(jeng)
    jl.jit_substep = jax.jit(jl._substep)
    return jeng, jl, teng, LanesEngine(teng), jp, tp, js, ts


@pytest.fixture(scope="module")
def setup():
    return _setup(N, **OPTIONS)


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


def _substeps(setup, substeps):
    """`substeps` substeps of both engines under PD torques, each warm-started
    from its own impulses: the lanes states and impulses (JAX's, the port's)."""
    _, jl, _, tl, jp, tp, js, ts = setup
    n = tp.friction.shape[0]
    jpT = {"mass": jp.mass.T, "com": jnp.transpose(jp.com, (2, 1, 0)),
           "inertia": jnp.transpose(jp.inertia, (2, 3, 1, 0)), "friction": jp.friction,
           "restitution": jp.restitution, "armature": jp.armature.T,
           "dof_damping": jp.dof_damping.T, "dof_frictionloss": jp.dof_frictionloss.T}
    tpT = tl.params_to_lanes(tp)
    jst, tst = jl._to_lanes(js), tl._to_lanes(ts)
    jlam = jnp.zeros((jl.KT, 3, n))
    tlam = torch.zeros((tl.KT, 3, n))
    for _ in range(substeps):
        jtau = -KP * jst["q"] - KD * jst["qd"]
        ttau = -KP * tst["q"] - KD * tst["qd"]
        jst, jlam = jl.jit_substep(jpT, jst, jtau, jlam)
        tst, tlam = tl._substep(tpT, tst, ttau, tlam)
    return jst, jlam, tst, tlam


@pytest.mark.parametrize("substeps", [1, 4])
def test_substeps_match_jax(setup, substeps):
    """1 substep, and 4 substeps warm-started from each other's impulses."""
    jst, jlam, tst, tlam = _substeps(setup, substeps)
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


# The reduced-precision matvec against JAX. Both round A once and y at every
# iteration to the dtype and sum in f32; the two packages' f32 y differ by
# an ulp where their sums run in other orders, and such an ulp can round y
# to the neighbouring bfloat16 / float16 value. Those flips move a few
# impulses by up to ~8e-4 (0.6e-3 to 0.8e-3 over six seeded problems), so
# MV_ATOL bounds the largest difference at 2e-3, and the mean difference
# (JAX's rule: at most 8e-7) at MV_MEAN_ATOL = 3e-6. Another product rule
# moves every impulse: rounding the bfloat16 product (torch's bfloat16
# multiply) is 9e-5 from JAX on the mean, the exact float16 product 1.1e-5.
MV_ATOL = 2e-3
MV_MEAN_ATOL = 3e-6


def _problem(R, n, seed):
    """A random SPD contact problem with a warm start, env-last, as numpy
    (tests/test_torch_contact_kernel.py's recipe)."""
    rng = np.random.default_rng(seed)
    k = 3 * R
    J = (rng.normal(size=(k, 40, n)) * 0.3).astype(np.float32)
    A = (np.einsum("ivn,jvn->ijn", J, J) + 1e-2 * np.eye(k)[:, :, None]).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    mu = rng.uniform(0.2, 1.2, size=n).astype(np.float32)
    active = (rng.uniform(size=(R, n)) > 0.3).astype(np.float32)
    x0 = (rng.uniform(size=(k, n)) * 0.5).astype(np.float32)
    return A, b, mu, active, x0


def _other_rule(monkeypatch, mv_dtype):
    """Swap `matvec_plain` for the product rule JAX does not use with
    `mv_dtype`: the bfloat16 product rounded, the float16 product exact."""
    def matvec(A_mv, y, dt):
        prod = A_mv * ck.round_to(y, dt)[None]
        return torch.sum(ck.round_to(prod, dt) if dt == "bfloat16" else prod, dim=1)

    monkeypatch.setattr(ck, "matvec_plain", matvec)


@pytest.mark.parametrize("mv_dtype", ["bfloat16", "float16"])
def test_matvec_product_rule_matches_jax(mv_dtype):
    """One [36,36,128] matvec as the lanes engine writes it in JAX, compiled
    as the engine's scans compile it: XLA on the CPU keeps the bfloat16
    product of the rounded operands exact in f32 and rounds the float16
    product to float16 (run op by op, outside `jit`, it rounds both).
    `matvec_plain` follows it to f32 summation noise; the other rule misses
    by orders more."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(36, 36, 128)).astype(np.float32)
    y = rng.normal(size=(36, 128)).astype(np.float32)
    dt = jnp.dtype(mv_dtype)
    ref = np.asarray(jax.jit(lambda A, y: jnp.sum((A.astype(dt) * y.astype(dt)[None]).astype(jnp.float32),
                                                  axis=1))(A, y))
    tA, ty = torch.as_tensor(A), torch.as_tensor(y)
    port = ck.matvec_plain(ck.round_to(tA, mv_dtype), ty, mv_dtype).numpy()
    prod = ck.round_to(tA, mv_dtype) * ck.round_to(ty, mv_dtype)[None]
    other = torch.sum(prod if mv_dtype == "float16" else ck.round_to(prod, mv_dtype), dim=1).numpy()
    assert np.abs(port - ref).max() <= 1e-5
    assert np.abs(other - ref).max() > 1e-3


@pytest.mark.parametrize("R", [12, 38])
@pytest.mark.parametrize("mv_dtype", ["bfloat16", "float16"])
def test_reduced_matvec_solve_matches_jax(monkeypatch, mv_dtype, R):
    """The plain solve in each reduced dtype against JAX's `_apgd` (R = 12:
    the committed caps; 38: every row, `contact_cap: 0`); the other product
    rule misses JAX by more than the bound."""
    jl = JaxLanes(je.Engine(jax_sim_model(), je.EngineOptions(solver_iters=16, contact_matvec_dtype=mv_dtype)))
    A, b, mu, active, x0 = _problem(R, 128, R)
    ref = np.asarray(jl._apgd(*map(jnp.asarray, (A, b, mu, active)), x0=jnp.asarray(x0)))
    args = list(map(torch.as_tensor, (A, b, mu, active, x0)))
    diff = np.abs(ck.apgd_lanes_plain(*args, 16, mv_dtype).numpy() - ref)
    assert diff.max() <= MV_ATOL and diff.mean() <= MV_MEAN_ATOL, (diff.max(), diff.mean())
    f32 = np.abs(ck.apgd_lanes_plain(*args, 16).numpy() - ref)
    _other_rule(monkeypatch, mv_dtype)
    other = np.abs(ck.apgd_lanes_plain(*args, 16, mv_dtype).numpy() - ref)
    assert other.mean() > 3 * MV_MEAN_ATOL and f32.mean() > 3 * MV_MEAN_ATOL, (other.mean(), f32.mean())


def test_matvec_dtype_is_checked():
    assert te.EngineOptions(contact_matvec_dtype="float16").contact_matvec_dtype == "float16"
    with pytest.raises(ValueError, match="float32, bfloat16, float16"):
        te.EngineOptions(contact_matvec_dtype="float64")


# One substep in bfloat16. The two packages' f32 Delassus matrices differ by
# their einsums' rounding, and where that crosses a bfloat16 rounding point
# an entry of the rounded A moves by a bfloat16 ulp (2^-8 relative): flips
# in A as well as in y. At N = 128 they move a few impulses by up to 2e-3
# (MV_STEP_LAM: max 5e-3) and the joint velocities of light links by up to
# 6e-3 (MV_STEP_TOL), but the mean impulse by 2.2e-6 and the mean joint
# velocity by 5.4e-5: the mean bounds, 1e-5 and 1.5e-4, hold the port to
# JAX's product rule, which the rounded bfloat16 product misses (3.6e-5 and
# 5.4e-4). The float32 solve of `pallas` stays within the float32 bounds.
MV_STEP_TOL = {"rp": 1e-5, "rq": 1e-5, "q": 1e-4, "rv": 1e-4, "rw": 1e-3, "qd": 1e-2}
MV_STEP_LAM = (5e-3, 1e-5)
MV_STEP_QD_MEAN = 1.5e-4
MV_N = 128


@pytest.fixture(scope="module", params=["xla", "pallas", "auto"])
def bf16_setup(request):
    return request.param, _setup(MV_N, **OPTIONS, contact_matvec_dtype="bfloat16",
                                 lanes_contact_kernel=request.param)


def test_bf16_substep_matches_jax(bf16_setup, monkeypatch):
    """One substep at N = 128 with `contact_matvec_dtype: bfloat16` under each
    `lanes_contact_kernel`, against JAX's: `pallas` solves in f32 (JAX's
    Pallas kernel, here in interpret mode, ignores the dtype), `xla` and
    `auto` on the CPU in bfloat16; the position pass is in bfloat16 on every
    branch. Where the solve is in bfloat16, the rounded bfloat16 product
    misses the mean bounds."""
    key, setup = bf16_setup
    monkeypatch.setattr(pallas_contact, "solve_contacts_pallas_lanes",
                        functools.partial(pallas_contact.solve_contacts_pallas_lanes, interpret=True))
    assert setup[3].solve_dtype(MV_N) == ("float32" if key == "pallas" else "bfloat16")
    jst, jlam, tst, tlam = _substeps(setup, 1)
    for k, tol in MV_STEP_TOL.items():
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), atol=tol, err_msg=k)
    lam = np.abs(tlam.numpy() - np.asarray(jlam))
    qd = np.abs(tst["qd"].numpy() - np.asarray(jst["qd"]))
    assert lam.max() <= MV_STEP_LAM[0] and lam.mean() <= MV_STEP_LAM[1] and qd.mean() <= MV_STEP_QD_MEAN, \
        (lam.max(), lam.mean(), qd.mean())
    if key != "pallas":
        _other_rule(monkeypatch, "bfloat16")
        monkeypatch.setattr(engine_lanes, "matvec_plain", ck.matvec_plain)
        _, _, tst, tlam = _substeps(setup, 1)
        lam = np.abs(tlam.numpy() - np.asarray(jlam))
        qd = np.abs(tst["qd"].numpy() - np.asarray(jst["qd"]))
        assert lam.mean() > 2 * MV_STEP_LAM[1] and qd.mean() > 2 * MV_STEP_QD_MEAN, (lam.mean(), qd.mean())
