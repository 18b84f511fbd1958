"""Port parity at 29 DoF: the `g1_29dof_rev_1_0` models, FK, the engine's
tables and the lanes engine, against `pbhc_tpu` on the CPU.

The KungfuBot2 29-DoF runs (`artifacts/kb2_{teacher,student}29_r5`) build
this robot (21 contact spheres, 17 self-collision pairs, 29 joints); every
later check of the 29-DoF path rests on these. Setups are the 23-DoF ones of
tests/test_torch_engine_lanes.py (per-env mass/CoM/friction draws, root at
z = 0.755 m, small random joint state, PD torques) at the KungfuBot2 runs'
engine options (16 APGD iterations, 8 ground + 4 pair active rows, R = 12).

Tolerances: models and engine tables exactly; FK 1e-5 (velocities 1e-4:
lever arms times rates of order 1); after lanes substeps positions and
quaternions 1e-5, velocities 1e-4, contact impulses 1e-3 relative to the
largest (as the 23-DoF test).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pbhc_tpu.model import g1 as jg1  # noqa: E402
from pbhc_tpu.model import kinematics as jk  # noqa: E402
from pbhc_tpu.sim import engine as je  # noqa: E402
from pbhc_tpu.sim.engine_lanes import LanesEngine as JaxLanes  # noqa: E402
from pbhc_tpu_torch.config.loader import load_snapshot  # noqa: E402
from pbhc_tpu_torch.model import g1 as tg1  # noqa: E402
from pbhc_tpu_torch.model import kinematics as tk  # noqa: E402
from pbhc_tpu_torch.sim import engine as te  # noqa: E402
from pbhc_tpu_torch.sim.engine_lanes import LanesEngine  # noqa: E402

ROBOT = "g1_29dof_rev_1_0"
N = 8
OPTIONS = dict(solver_iters=16, contact_cap=8, pair_cap=4, pos_iters=4)
KP, KD = 100.0, 2.0
EXTEND = [dict(e) for e in load_snapshot("kb2_teacher29_r5").robot.motion.extend_config]


def _equal_models(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, list):
            assert len(x) == len(y), f.name
            for u, v in zip(x, y):
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v), err_msg=f.name)
        elif x is None:
            assert y is None, f.name
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f.name)


def test_models_equal():
    jm, tm = jg1.load_g1_sim_model(ROBOT), tg1.load_g1_sim_model(ROBOT)
    _equal_models(jm, tm)
    assert (tm.num_dof, len(tm.contact_body), len(tm.contact_pairs)) == (29, 21, 17)
    _equal_models(jg1.load_g1_motion_model(ROBOT, EXTEND), tg1.load_g1_motion_model(ROBOT, EXTEND))


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def test_fk_matches_jax():
    jm, tm = jg1.load_g1_sim_model(ROBOT), tg1.load_g1_sim_model(ROBOT)
    rng = np.random.default_rng(29)
    n = 32
    rp = rng.normal(size=(n, 3)).astype(np.float32)
    rq = _quats(rng, n)
    q = rng.uniform(-1.0, 1.0, size=(n, 29)).astype(np.float32)
    rv, rw = rng.normal(size=(2, n, 3)).astype(np.float32)
    qd = rng.normal(size=(n, 29)).astype(np.float32)
    jp, jq, jR = jax.vmap(jk.fk_root_dof, in_axes=(None, 0, 0, 0))(jm, jnp.asarray(rp), jnp.asarray(rq),
                                                                   jnp.asarray(q))
    tp, tq, tR = tk.fk_root_dof(tm, torch.as_tensor(rp), torch.as_tensor(rq), torch.as_tensor(q))
    for a, b in ((tp, jp), (tq, jq), (tR, jR)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    jv, jw = jax.vmap(jk.fk_velocities, in_axes=(None, 0, 0, 0, 0, 0))(
        jm, jp, jR, jnp.asarray(rv), jnp.asarray(rw), jnp.asarray(qd))
    tv, tw = tk.fk_velocities(tm, tp, tR, torch.as_tensor(rv), torch.as_tensor(rw), torch.as_tensor(qd))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jeng = je.Engine(jg1.load_g1_sim_model(ROBOT), je.EngineOptions(**OPTIONS))
    teng = te.Engine(tg1.load_g1_sim_model(ROBOT), te.EngineOptions(**OPTIONS), device="cpu")
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


def test_engine_tables_equal(setup):
    jeng, _, teng, *_ = setup
    assert (teng.nb, teng.nd, teng.K, teng.P, teng.KT) == (jeng.nb, jeng.nd, jeng.K, jeng.P, jeng.KT) \
        == (30, 29, 21, 17, 38)
    for name in ("contact_anc", "contact_pos", "contact_radius", "pair_i", "pair_j", "subtree",
                 "dof_limits", "pair_rsum"):
        np.testing.assert_array_equal(np.asarray(getattr(teng, name)), np.asarray(getattr(jeng, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(teng.dof_anc_np, np.asarray(jeng.dof_anc))
    np.testing.assert_array_equal(teng.anc_body_dof_np, np.asarray(jeng.anc_body_dof))
    rows = te.active_set_indices(te.EngineOptions(**OPTIONS), teng.K, teng.P, torch.zeros((1, teng.KT)))
    assert rows.shape[-1] == 12                            # R of the KungfuBot2 runs at 29 DoF


def test_derived_state(setup):
    *_, js, ts = setup
    for f in ("body_pos", "body_quat", "body_lin_vel", "body_ang_vel"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), atol=1e-5, err_msg=f)


@pytest.mark.parametrize("substeps", [1, 4])
def test_lanes_substeps_match_jax(setup, substeps):
    _, jl, _, tl, jp, tp, js, ts = setup
    jpT = {"mass": jp.mass.T, "com": jnp.transpose(jp.com, (2, 1, 0)),
           "inertia": jnp.transpose(jp.inertia, (2, 3, 1, 0)), "friction": jp.friction,
           "restitution": jp.restitution, "armature": jp.armature.T,
           "dof_damping": jp.dof_damping.T, "dof_frictionloss": jp.dof_frictionloss.T}
    tpT = tl.params_to_lanes(tp)
    jst, tst = jl._to_lanes(js), tl._to_lanes(ts)
    jlam = jnp.zeros((jl.KT, 3, N))
    tlam = torch.zeros((tl.KT, 3, N))
    for _ in range(substeps):
        jst, jlam = jl.jit_substep(jpT, jst, -KP * jst["q"] - KD * jst["qd"], jlam)
        tst, tlam = tl._substep(tpT, tst, -KP * tst["q"] - KD * tst["qd"], tlam)
    for k, tol in (("rp", 1e-5), ("rq", 1e-5), ("q", 1e-5), ("rv", 1e-4), ("rw", 1e-4), ("qd", 1e-4)):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), atol=tol, err_msg=k)
    lam = np.asarray(jlam)
    assert np.abs(lam).max() > 1e-3                        # the soles are in contact
    assert np.abs(lam - tlam.numpy()).max() / np.abs(lam).max() < 1e-3
