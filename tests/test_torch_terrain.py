"""Port parity: heightfield terrain, against `pbhc_tpu` on the CPU.

Covers `envs/terrain.py` (the field and tile origins, bit for bit), the
ground lookup of both engines, one lanes substep and one env-first batched
substep (`solver: pallas`, kernel 2's plain version against the Pallas
kernel in interpret mode) over the terrain, the twins of
tests/test_terrain_urci.py's engine and curriculum tests, 10 serving steps
of the committed `terrain_walk_v3` run, and one KungfuBot2 teacher step on a
heightfield (the future-frame fetch carries the tile shift).

Envs stand at tile origins 29-181 m from the world origin, where one f32
ulp is 1.9e-6 to 1.5e-5 m. Randomness is switched off as in
tests/test_torch_env.py, and the initial terrain levels are fixed (the
committed runs start every env on row 0; the curriculum test injects
levels), since JAX's threefry and torch's generators draw different
numbers.

Tolerances, in metres where they bound a position:
- the field, the tile origins and `sample_origins`: exactly equal;
- the ground lookup: 1e-6 m (both evaluate the same f32 expression; XLA may
  fuse a multiply-add, a few ulps of heights under 0.2 m);
- substeps: the plane tests' bounds (tests/test_torch_engine_lanes.py,
  tests/test_torch_engine_envfirst.py), with each world position allowed
  one more ulp of its coordinate per f32 addition that moves it (two per
  substep: the velocity step and the position correction), since a
  rounding of `x + dx` at 181 m may fall on either side for a dx that
  differs in its last bits;
- the serving steps: tests/test_torch_env.py's `SIM_TOL`, world positions
  again plus two ulps of their coordinate per substep (40 substeps).
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
from pbhc_tpu.envs import terrain as jterrain  # noqa: E402
from pbhc_tpu.envs.tracking_env import MotionTrackingEnv as JaxEnv  # noqa: E402
from pbhc_tpu.eval import batch_eval as jax_eval  # noqa: E402
from pbhc_tpu.model.g1 import load_g1_sim_model as jax_sim_model  # noqa: E402
from pbhc_tpu.sim import engine as je  # noqa: E402
from pbhc_tpu.sim.engine_lanes import LanesEngine as JaxLanes  # noqa: E402
from pbhc_tpu_torch.config.loader import compose, load_snapshot  # noqa: E402
from pbhc_tpu_torch.envs import terrain as tterrain  # noqa: E402
from pbhc_tpu_torch.envs.tracking_env import MotionTrackingEnv  # noqa: E402
from pbhc_tpu_torch.eval import batch_eval  # noqa: E402
from pbhc_tpu_torch.model.g1 import load_g1_sim_model  # noqa: E402
from pbhc_tpu_torch.sim import engine as te  # noqa: E402
from pbhc_tpu_torch.sim.engine_lanes import LanesEngine  # noqa: E402
from test_torch_env import OFF, SIM_TOL  # noqa: E402

V3 = dict(load_snapshot("terrain_walk_v3").terrain)
V3_CKPT = "artifacts/terrain_walk_v3/ckpt/model_6500.pkl"
SMALL = dict(num_rows=3, num_cols=4, border_size=1.0)   # default proportions: every tile kind
SELS = ["exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking", "rewards=motion_tracking",
        "domain_rand=main", "simulator=tpu", "terrain=locomotion"]
OPTIONS = dict(solver_iters=16, contact_cap=8, pair_cap=4, pos_iters=4)   # the terrain runs' engine
KP, KD = 100.0, 2.0
POS_FIELDS = ("root_pos", "body_pos")


def _ulp(x):
    return float(np.spacing(np.float32(np.abs(np.asarray(x)).max())))


@pytest.fixture(scope="module")
def v3_terrains():
    return jterrain.Terrain.from_run_config(V3), tterrain.Terrain.from_run_config(V3)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pc.solve_contacts_pallas

    def patched(A, b, mu, active, iters=32, interpret=False):
        return orig(A, b, mu, active, iters=iters, interpret=True)

    monkeypatch.setattr(pc, "solve_contacts_pallas", patched)


@pytest.mark.parametrize("which", ["terrain_walk_v3", "small"])
def test_terrain_bit_identical(which, v3_terrains):
    if which == "small":
        pair = jterrain.Terrain(jterrain.TerrainConfig(**SMALL)), tterrain.Terrain(tterrain.TerrainConfig(**SMALL))
    else:
        pair = v3_terrains
        assert pair[1].height_field.shape == (1300, 2100)
    j, t = pair
    assert t.height_field.dtype == j.height_field.dtype == np.float32
    np.testing.assert_array_equal(t.height_field, j.height_field)
    np.testing.assert_array_equal(t.env_origins, j.env_origins)
    np.testing.assert_array_equal(t.sample_origins(64, max_row=2), j.sample_origins(64, max_row=2))
    xy = np.random.default_rng(0).uniform(-1.0, 1.05 * t.height_field.shape[0] * 0.1, (256, 2))
    np.testing.assert_array_equal(t.height_at(xy), j.height_at(xy))


def test_terrain_config_from_group():
    """The env's reading of a `terrain:` group (`tracking_env.py:152-161`)."""
    cfg = tterrain.TerrainConfig.from_group(V3)
    assert cfg == tterrain.TerrainConfig(**{k: V3[k] for k in (
        "horizontal_scale", "num_rows", "num_cols", "terrain_length", "terrain_width", "border_size")},
        terrain_proportions=tuple(V3["terrain_proportions"]))
    assert tterrain.TerrainConfig.from_group({"mesh_type": "heightfield"}) == tterrain.TerrainConfig()


def _xy_samples(field, hs):
    """Random points over the field and past its borders, cell corners, and
    points exactly on the far border."""
    H, W = field.shape
    rng = np.random.default_rng(1)
    pts = [rng.uniform([-2.0, -2.0], [H * hs + 2.0, W * hs + 2.0], (512, 2)),
           rng.integers(0, [H, W], (64, 2)) * hs,
           np.asarray([[(H - 1) * hs, (W - 1) * hs], [(H - 1) * hs, 0.0], [0.0, (W - 1) * hs],
                       [H * hs, W * hs], [-0.05, -0.05]])]
    return np.concatenate(pts).astype(np.float32)


def test_ground_height_both_engines(v3_terrains):
    field, hs = v3_terrains[0].height_field, V3["horizontal_scale"]
    jeng = je.Engine(jax_sim_model())
    jeng.set_terrain(field, hs)
    teng = te.Engine(load_g1_sim_model(), device="cpu")
    teng.set_terrain(field, hs)
    assert teng.terrain_hf.dtype == torch.float32
    xy = _xy_samples(field, hs)
    ref = np.asarray(jeng.ground_height(jnp.asarray(xy)))
    out = teng.ground_height(torch.as_tensor(xy)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert np.abs(ref).max() > 0.05                       # the samples met raised cells
    # the lanes layout: xy [2,K,N]
    xyl = np.moveaxis(xy.reshape(-1, 7, 2), -1, 0)
    ref_l = np.asarray(JaxLanes(jeng)._ground_height(jnp.asarray(xyl)))
    out_l = LanesEngine(teng)._ground_height(torch.as_tensor(xyl)).numpy()
    np.testing.assert_allclose(out_l, ref_l, atol=1e-6)
    np.testing.assert_allclose(out_l, out.reshape(-1, 7), atol=0)


def _terrain_states(jeng, field_origins, n, rng):
    """n envs standing at tile origins (rows 0-2, all columns) with a little
    joint noise and per-env friction."""
    rows, cols = field_origins.shape[:2]
    idx = [(i % min(rows, 3), (i * 7) % cols) for i in range(n)]
    origins = np.stack([field_origins[i, j] for i, j in idx])
    params = jeng.default_params()
    batch = lambda x: np.broadcast_to(np.asarray(x), (n,) + np.shape(x)).astype(np.float32).copy()
    params = {f.name: batch(getattr(params, f.name)) for f in dataclasses.fields(params)}
    params["friction"] = rng.uniform(0.5, 1.2, size=n).astype(np.float32)
    st = jeng.default_state(root_pos=(0.0, 0.0, 0.755))
    st = {f.name: batch(getattr(st, f.name)) for f in dataclasses.fields(st)}
    st["root_pos"] = (origins + np.asarray([0.0, 0.0, 0.755])).astype(np.float32)
    st["dof_pos"] += (0.02 * rng.normal(size=st["dof_pos"].shape)).astype(np.float32)
    st["dof_vel"] += (0.05 * rng.normal(size=st["dof_vel"].shape)).astype(np.float32)
    return params, st


def _both(jeng, teng, params, st):
    jp = je.SimParams(**{k: jnp.asarray(v) for k, v in params.items()})
    tp = te.SimParams(**{k: torch.as_tensor(v) for k, v in params.items()})
    js = jax.vmap(jeng.derived_state)(jp, je.SimState(**{k: jnp.asarray(v) for k, v in st.items()}))
    ts = teng.derived_state(tp, te.SimState(**{k: torch.as_tensor(v) for k, v in st.items()}))
    return jp, js, tp, ts


@pytest.mark.parametrize("substeps", [1, 4])
def test_lanes_substeps_on_heightfield(v3_terrains, substeps):
    """tests/test_torch_engine_lanes.py::test_substeps_match_jax over the
    terrain_walk_v3 field, 8 envs on tiles of rows 0-2."""
    n = 8
    terr = v3_terrains[0]
    jeng = je.Engine(jax_sim_model(), je.EngineOptions(**OPTIONS))
    teng = te.Engine(load_g1_sim_model(), te.EngineOptions(**OPTIONS), device="cpu")
    for e in (jeng, teng):
        e.set_terrain(terr.height_field, terr.cfg.horizontal_scale)
    jp, js, tp, ts = _both(jeng, teng, *_terrain_states(jeng, terr.env_origins, n, np.random.default_rng(0)))
    jl, tl = JaxLanes(jeng), LanesEngine(teng)
    jpT = {"mass": jp.mass.T, "com": jnp.transpose(jp.com, (2, 1, 0)),
           "inertia": jnp.transpose(jp.inertia, (2, 3, 1, 0)), "friction": jp.friction,
           "restitution": jp.restitution, "armature": jp.armature.T,
           "dof_damping": jp.dof_damping.T, "dof_frictionloss": jp.dof_frictionloss.T}
    tpT = tl.params_to_lanes(tp)
    jst, tst = jl._to_lanes(js), tl._to_lanes(ts)
    jsub = jax.jit(jl._substep)
    jlam, tlam = jnp.zeros((jl.KT, 3, n)), torch.zeros((tl.KT, 3, n))
    for _ in range(substeps):
        jst, jlam = jsub(jpT, jst, -KP * jst["q"] - KD * jst["qd"], jlam)
        tst, tlam = tl._substep(tpT, tst, -KP * tst["q"] - KD * tst["qd"], tlam)
    assert float(np.abs(np.asarray(jlam)).max()) > 1e-3      # contacts were solved
    rp_tol = 1e-5 + 2 * substeps * _ulp(jst["rp"])
    for k, tol in (("rp", rp_tol), ("rq", 1e-5), ("q", 1e-5), ("rv", 1e-4), ("rw", 1e-4), ("qd", 1e-4)):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), atol=tol, err_msg=k)
    lam = np.asarray(jlam)
    assert np.abs(lam - tlam.numpy()).max() / max(1.0, np.abs(lam).max()) < 1e-3


def test_envfirst_substep_on_heightfield(v3_terrains):
    """tests/test_torch_engine_envfirst.py::test_substep_batched_matches_jax
    over the terrain_walk_v3 field (N = 128, the training config's rows)."""
    n = 128
    terr = v3_terrains[0]
    jeng = je.Engine(jax_sim_model(), je.EngineOptions(solver="pallas", **OPTIONS))
    teng = te.Engine(load_g1_sim_model(), te.EngineOptions(**OPTIONS), device="cpu")
    for e in (jeng, teng):
        e.set_terrain(terr.height_field, terr.cfg.horizontal_scale)
    rng = np.random.default_rng(2)
    jp, js, tp, ts = _both(jeng, teng, *_terrain_states(jeng, terr.env_origins, n, rng))
    tau = (5.0 * rng.normal(size=(n, jeng.nd))).astype(np.float32)
    ref = jax.jit(jax.vmap(jeng._pre_contact))(jp, js, jnp.asarray(tau))
    out = teng._pre_contact(tp, ts, torch.as_tensor(tau))
    np.testing.assert_allclose(out[3].numpy(), np.asarray(ref[3]), atol=1e-4, err_msg="phi")
    jst, jlam = jax.jit(lambda s, t: jeng.substep_batched(jp, s, t))(js, jnp.asarray(tau))
    tst, tlam = teng.substep_batched(tp, ts, torch.as_tensor(tau))
    assert float(np.abs(np.asarray(jlam)).max()) > 1e-3
    np.testing.assert_allclose(tlam.numpy(), np.asarray(jlam), atol=1e-4, err_msg="impulses")
    for f in ("root_pos", "root_quat", "root_lin_vel", "root_ang_vel", "dof_pos", "dof_vel"):
        r = np.asarray(getattr(jst, f))
        atol = 1e-4 + (2 * _ulp(r) if f == "root_pos" else 0.0)
        np.testing.assert_allclose(getattr(tst, f).numpy(), r, atol=atol, err_msg=f)


def test_engine_heightfield_contact():
    """Twin of tests/test_terrain_urci.py::test_engine_heightfield_contact:
    on a flat field raised 0.5 m the body comes to rest on it, not through it."""
    terr = tterrain.Terrain(tterrain.TerrainConfig(num_rows=2, num_cols=2, border_size=2.0))
    teng = te.Engine(load_g1_sim_model(), te.EngineOptions(), device="cpu")
    teng.set_terrain(terr.height_field * 0 + 0.5, terr.cfg.horizontal_scale)
    assert float(teng.ground_height(torch.tensor([[3.0, 3.0]]))[0]) == pytest.approx(0.5)
    params = te.tree_map(lambda x: x[None], teng.default_params())
    params = dataclasses.replace(params, friction=params.friction.reshape(1),
                                 restitution=params.restitution.reshape(1))
    st = te.tree_map(lambda x: x[None], teng.default_state(root_pos=(3.0, 3.0, 1.4)))
    lanes = LanesEngine(teng)
    zero = torch.zeros((1, teng.nd))
    for _ in range(100):                      # 400 substeps, 2 s
        st, _ = lanes.control_step_batched(params, st, lambda s: zero, 4)
    assert torch.isfinite(st.root_pos).all()
    assert float(st.root_pos[0, 2]) > 0.45


def _curriculum_envs():
    ovs = ["num_envs=4", "terrain.num_rows=3", "terrain.num_cols=2", "terrain.border_size=2.0",
           "terrain.curriculum=true", "terrain.max_init_terrain_level=1",
           "robot.motion.motion_file=assets/motions/Horse-stance_pose.pkl"]
    jenv = JaxEnv(jax_compose("pbhc_tpu/config", SELS, ovs), 4, jax.random.PRNGKey(0))
    tenv = MotionTrackingEnv(compose(SELS, ovs), 4, device="cpu")
    return jenv, tenv


def test_terrain_curriculum_reset():
    """Twin of tests/test_terrain_urci.py::test_terrain_curriculum_reset with
    the levels injected: spawns on the assigned tile origin, the shifted
    reference fetch, a row up after a near-complete episode and a row down
    after an early failure, each against JAX."""
    jenv, tenv = _curriculum_envs()
    np.testing.assert_array_equal(tenv.terrain_origins.numpy(), np.asarray(jenv.terrain_origins))
    np.testing.assert_array_equal(tenv.terrain_types.numpy(), np.asarray(jenv.terrain_types))
    assert (tenv.terrain_curriculum, tenv.max_init_terrain_level) == (jenv.terrain_curriculum, 1)
    ts = tenv.init_state()
    lvl = ts.terrain_level.numpy()
    assert ((0 <= lvl) & (lvl <= 1)).all()
    origins = tenv.terrain_origins.numpy()[lvl, tenv.terrain_types.numpy()]
    np.testing.assert_allclose(ts.sim.root_pos[:, :2].numpy(), origins[:, :2], atol=1e-4)
    mres, _ = tenv._motion_state_at(ts, 1)
    np.testing.assert_allclose(mres["root_pos"][:, :2].numpy(), ts.sim.root_pos[:, :2].numpy(), atol=1e-4)

    js = jenv.init_state(jax.random.PRNGKey(1))
    mask_j, mask_t = jnp.ones(4, bool), torch.ones(4, dtype=torch.bool)
    start_j, start_t = jnp.zeros(4), torch.zeros(4)
    n = int(0.95 * float(ts.motion_len[0]) / tenv.dt)
    for levels, last, want in (([0, 1, 1, 0], [0, 0, 0, 0], [0, 1, 1, 0]),      # init resets keep levels
                               ([1, 1, 1, 1], [n, n, 3, 3], [2, 2, 0, 0])):     # up, up, down, down
        js = jenv._reset_envs(dataclasses.replace(
            js, terrain_level=jnp.asarray(levels, jnp.int32), last_episode_length=jnp.asarray(last, jnp.int32)),
            mask_j, jax.random.PRNGKey(2),
            force_start_times=start_j)
        ts = tenv._reset_envs(dataclasses.replace(
            ts, terrain_level=torch.tensor(levels), last_episode_length=torch.tensor(last)), mask_t,
            force_start_times=start_t)
        np.testing.assert_array_equal(ts.terrain_level.numpy(), want)
        np.testing.assert_array_equal(np.asarray(js.terrain_level), want)
        np.testing.assert_allclose(ts.origin_shift.numpy(), np.asarray(js.origin_shift), atol=2e-5)
        np.testing.assert_allclose(ts.sim.root_pos.numpy(), np.asarray(js.sim.root_pos), atol=2e-5)
        np.testing.assert_allclose(ts.sim.body_pos.numpy(), np.asarray(js.sim.body_pos), atol=2e-5)
        jm, _ = jenv._motion_state_at(js, 1)
        tm, _ = tenv._motion_state_at(ts, 1)
        for k in ("root_pos", "rg_pos"):
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), atol=2e-5, err_msg=k)

    ts, obs, rew, done, info = tenv.step(ts, torch.zeros((4, tenv.nd)))
    assert torch.isfinite(obs["actor_obs"]).all() and torch.isfinite(rew).all()
    assert float(info["log"]["terrain_level_mean"]) == 1.0 and float(info["log"]["terrain_level_max"]) == 2.0


@pytest.fixture(scope="module")
def v3_serving():
    mp = pytest.MonkeyPatch()
    mp.setenv("PBHC_MOTION_CACHE", "0")
    n = 128
    jenv, algo, payload = jax_eval._load(V3_CKPT, n, OFF)
    ap = payload["actor_params"]
    js = jenv.reset_to_start(jenv.init_state(jax.random.PRNGKey(1)), jax.random.PRNGKey(1))
    jobs, hist = jenv._compute_observations(js, jax.random.PRNGKey(2))
    js = dataclasses.replace(js, history=hist)
    jstep = jax.jit(jenv.step)
    jact = jax.jit(lambda o: algo.actor.apply(ap, o)[0])
    tenv, actor, _ = batch_eval.load(V3_CKPT, n, OFF, device="cpu")
    ts, tobs = batch_eval.start_episodes(tenv)
    yield jenv, jstep, jact, js, jobs, tenv, actor, ts, tobs
    mp.undo()


def test_terrain_walk_v3_serving_ten_steps(v3_serving):
    """The committed terrain run's `episode_ratio` loop for 10 control steps
    at 128 envs (every env on row 0 of its column's tile), both packages.

    A walking policy lands its feet, and a control step in which a sole
    sphere touches down is not continuous in the state: whether the contact
    starts in one substep or the next flips under f32 noise (the packages'
    root heights differ by ~2e-6 m). Such an env is compared up to that step
    and set aside from then on, but only where JAX's own step shows the
    jump: stepped again from its state with the root raised or lowered by
    1e-5 m, it moves a joint velocity by more than the tolerance. At most an
    eighth of the envs may be set aside."""
    jenv, jstep, jact, js, jobs, tenv, actor, ts, tobs = v3_serving
    n = tenv.num_envs
    assert tenv.terrain is not None and tenv.lanes_engine is not None
    np.testing.assert_array_equal(ts.terrain_level.numpy(), np.zeros(n))
    np.testing.assert_allclose(ts.origin_shift.numpy(), np.asarray(js.origin_shift), atol=2e-5)
    assert float(ts.sim.root_pos[:, 1].max()) > 150.0          # the far columns' tiles
    jumped = np.zeros(n, bool)
    substeps = 0
    for i in range(10):
        ja = jact(jobs["actor_obs"])
        with torch.no_grad():
            ta, _ = actor(tobs["actor_obs"])
        keep = ~jumped
        np.testing.assert_allclose(ta.numpy()[keep], np.asarray(ja)[keep], atol=2e-3, err_msg=f"actions {i}")
        nudged = [dataclasses.replace(js, sim=dataclasses.replace(js.sim, root_pos=js.sim.root_pos.at[:, 2].add(dz)))
                  for dz in (1e-5, -1e-5)]
        js, jobs, jrew, jdone, jinfo = jstep(js, ja)
        ts, tobs, trew, tdone, tinfo = tenv.step(ts, ta)
        substeps += tenv.decimation
        for jn in nudged:
            jumped |= np.abs(np.asarray(jstep(jn, ja)[0].sim.dof_vel)
                             - np.asarray(js.sim.dof_vel)).max(1) > SIM_TOL["dof_vel"]
        keep = ~jumped
        np.testing.assert_array_equal(tdone.numpy()[keep], np.asarray(jdone)[keep], err_msg=f"done step {i}")
        np.testing.assert_allclose(trew.numpy()[keep], np.asarray(jrew)[keep], rtol=1e-3, atol=1e-5,
                                   err_msg=f"rewards step {i}")
        for f, tol in SIM_TOL.items():
            r = np.asarray(getattr(js.sim, f))
            atol = tol + (2 * substeps * _ulp(r) if f in POS_FIELDS else 0.0)
            np.testing.assert_allclose(getattr(ts.sim, f).numpy()[keep], r[keep], atol=atol,
                                       err_msg=f"{f} step {i}")
        for g in ("actor_obs", "critic_obs"):
            np.testing.assert_allclose(tobs[g].numpy()[keep], np.asarray(jobs[g])[keep], atol=2e-3,
                                       err_msg=f"{g} step {i}")
    assert jumped.sum() <= n // 8, np.nonzero(jumped)[0]
    for k in ("terrain_level_mean", "terrain_level_max"):
        assert float(tinfo["log"][k]) == float(jinfo["log"][k]) == 0.0


def test_kb2_teacher_step_on_heightfield():
    """One control step of the committed KungfuBot2 teacher's config with its
    terrain group set to a heightfield, both packages: the future-target
    observations carry the tile's height shift."""
    ckpt = "artifacts/kb2_teacher23_r3/ckpt/model_24000.pkl"
    n = 32
    ovs = OFF + ["obs.noise_scales.roll_pitch=0", "terrain.mesh_type=heightfield", "terrain.curriculum=true",
                 "terrain.max_init_terrain_level=0"]
    jenv, _, _ = jax_eval._load(ckpt, n, ovs)
    js = jenv.reset_to_start(jenv.init_state(jax.random.PRNGKey(1)), jax.random.PRNGKey(1))
    _, hist = jenv._compute_observations(js, jax.random.PRNGKey(2))
    js = dataclasses.replace(js, history=hist)
    tenv, _, _ = batch_eval.load(ckpt, n, ovs, device="cpu")
    ts, _ = batch_eval.start_episodes(tenv)
    assert tenv.terrain is not None
    assert float(np.abs(np.asarray(js.origin_shift)[:, 2]).max()) > 1e-3   # some tiles are not at z = 0
    acts = (0.2 * np.random.default_rng(3).normal(size=(n, tenv.num_actions))).astype(np.float32)
    js, jobs, jrew, jdone, _ = jax.jit(jenv.step)(js, jnp.asarray(acts))
    ts, tobs, trew, tdone, _ = tenv.step(ts, torch.as_tensor(acts))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=1e-3, atol=1e-5)
    for g in ("actor_obs", "priv_obs", "future_motion_targets", "prop_history"):
        np.testing.assert_allclose(tobs[g].numpy(), np.asarray(jobs[g]), atol=2e-3, err_msg=g)
    for f, tol in SIM_TOL.items():
        r = np.asarray(getattr(js.sim, f))
        atol = tol + (2 * tenv.decimation * _ulp(r) if f in POS_FIELDS else 0.0)
        np.testing.assert_allclose(getattr(ts.sim, f).numpy(), r, atol=atol, err_msg=f)
