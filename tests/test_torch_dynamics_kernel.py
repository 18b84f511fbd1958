"""Kernel 3 (`sim/dynamics_kernel.py`, `csrc/lanes_dynamics.cu`) on the CPU.

- The packed model tables against the model, for both G1 models and with
  `self_collision` off (no pair tables).
- The size checks: the Python caps equal the kernel's, and a model beyond a
  cap raises in the wrapper (and gets -1 from the launch function).
- On the CPU, `_pre_contact` and `derived_state_lanes` return the plain
  version's outputs bit for bit and launch nothing.
- The kernel's own source, built for the host with g++ (`lanes_dynamics_host.cpp`:
  a block's threads as std::threads, `__syncthreads` a std::barrier, shared
  memory poisoned with NaN), against the plain version at ragged N and at
  every tile width. Tolerances, as on the card (tests/test_torch_cuda_kernel.py),
  of each field's scale (its largest magnitude, at least 1): positions (x,
  the gaps, the Jacobian's lever arms, the pair frames, body poses) 1e-5;
  velocities (u_plus, body twists) 1e-4; M^-1 1e-4. The two sum in other
  orders and the inverse goes by another route (L^-1 columns, not rows),
  which moves M^-1 by about 1e-5 of its scale at these states.
"""
import copy
import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pbhc_tpu_torch.eval.kernel_bench import dynamics_problem
from pbhc_tpu_torch.maths import rotations as rot
from pbhc_tpu_torch.model.g1 import load_g1_sim_model
from pbhc_tpu_torch.sim import dynamics_kernel as dk
from pbhc_tpu_torch.sim.engine import Engine, EngineOptions

ROOT = Path(__file__).resolve().parents[1]
MODELS = ("g1_23dof_lock_wrist", "g1_29dof_rev_1_0")
POS_TOL, VEL_TOL, MINV_TOL = 1e-5, 1e-4, 1e-4
_engines = {}


def lanes_engine(robot, **options):
    key = (robot, tuple(sorted(options.items())))
    if key not in _engines:
        _engines[key] = Engine(load_g1_sim_model(robot), EngineOptions(**options), device="cpu").lanes()
    return _engines[key]


def problem(lanes, N, seed):
    return dynamics_problem(lanes, N, seed)


# ------------------------------------------------------------------ tables

@pytest.mark.parametrize("robot,self_collision", [(MODELS[0], True), (MODELS[1], True), (MODELS[0], False)])
def test_packed_tables_match_model(robot, self_collision):
    lanes = lanes_engine(robot, self_collision=self_collision)
    eng, model, tb = lanes.e, lanes.e.model, lanes.tables
    nb, nd = lanes.nb, lanes.nd
    T = lambda name: tb.table(name).numpy()
    assert tb.ints.dtype == torch.int32 and tb.floats.dtype == torch.float32
    assert tb.dims == {"nb": nb, "nd": nd, "nv": nd + 6, "K": lanes.K, "P": lanes.P, "levels": len(model.levels) + 1,
                       "groups": len(lanes._dof_groups),
                       "max_group": max(b - a for a, b in lanes._dof_groups)}
    parent = np.asarray(model.parent[:nb])
    np.testing.assert_array_equal(T("parent"), parent)
    start, bodies = T("level_start"), T("level_body")
    assert start[0] == 0 and start[-1] == nb and list(bodies[start[0]:start[1]]) == [0]
    for lv, ids in enumerate(model.levels, start=1):
        np.testing.assert_array_equal(bodies[start[lv]:start[lv + 1]], np.asarray(ids))
        assert all(start[lv - 1] <= list(bodies).index(parent[b]) < start[lv] for b in ids)
    cs, child = T("child_start"), T("child")
    for b in range(nb):
        np.testing.assert_array_equal(child[cs[b]:cs[b + 1]], np.nonzero(parent == b)[0])
    body_dof = T("body_dof")
    np.testing.assert_array_equal(T("dof_body"), np.asarray(model.dof_body))
    assert body_dof[0] == -1 and all(body_dof[model.dof_body[d]] == d for d in range(nd))
    np.testing.assert_array_equal(T("dof_anc").reshape(nd, nd), eng.dof_anc_np > 0)
    groups = lanes._dof_groups
    np.testing.assert_array_equal(T("group_start"), [a for a, _ in groups] + [nd])
    for g, (a, b) in enumerate(groups):
        assert (T("dof_group")[a:b] == g).all()
    np.testing.assert_array_equal(T("contact_body"), eng.contact_body)
    np.testing.assert_array_equal(T("contact_anc").reshape(lanes.K, nd), eng.contact_anc.numpy() > 0)
    np.testing.assert_array_equal(T("pair_i"), eng.pair_i)
    np.testing.assert_array_equal(T("pair_j"), eng.pair_j)
    assert len(T("pair_i")) == lanes.P == (17 if self_collision else 0)
    R_local = rot.quat_to_matrix(torch.as_tensor(np.asarray(model.local_quat[:nb], dtype=np.float32)))
    np.testing.assert_array_equal(T("R_local").reshape(nb, 3, 3), R_local.numpy())
    np.testing.assert_array_equal(T("local_pos").reshape(nb, 3), np.asarray(model.local_pos[:nb], np.float32))
    np.testing.assert_array_equal(T("axis").reshape(nd, 3), np.asarray(model.dof_axis, np.float32))
    np.testing.assert_array_equal(T("contact_pos").reshape(lanes.K, 3), eng.contact_pos.numpy())
    if lanes.P:
        np.testing.assert_array_equal(T("pair_rsum"), eng.pair_rsum.numpy())


# ------------------------------------------------------------------ caps

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The kernel source built for the host (see the module docstring)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    out = tmp_path_factory.mktemp("lanes_dynamics") / "liblanes_dynamics_host.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I", str(ROOT / "pbhc_tpu_torch" / "csrc"),
                    "-o", str(out), str(ROOT / "tests" / "lanes_dynamics_host.cpp")], check=True)
    return dk.declare(ctypes.CDLL(str(out)))


def test_caps_match_the_kernel(host_lib):
    assert dk.caps(host_lib) == dk.CAPS


@pytest.mark.parametrize("cap,dim", [("bodies", "nb"), ("dofs", "nd"), ("contacts", "K"), ("pairs", "P"),
                                     ("levels", "levels"), ("groups", "groups")])
def test_beyond_a_cap_raises(host_lib, cap, dim):
    lanes = lanes_engine(MODELS[1])
    tb = lanes.tables
    dk.check_caps(tb.dims)                               # both G1 models are within the caps
    big = dict(tb.dims, **{dim: dk.CAPS[cap] + 1})
    with pytest.raises(ValueError, match=cap):
        dk.check_caps(big)
    wide = copy.copy(tb)
    wide.dims, wide._model = big, None
    P, st, tau = problem(lanes, 3, 0)
    with pytest.raises(ValueError, match=cap):
        dk.launch_dynamics(host_lib, wide, P, st, tau, 0.005, True)
    # the launch function's own check, past the wrapper's
    m = wide.model()
    if dim == "nd":
        m.nv = m.nd + 6
    assert host_lib.lanes_dynamics_launch(m, dk.Inputs(), dk.Outputs(), 3, 0.005, 1, 0, None) == -1


def test_wrong_shape_or_device_raises(host_lib):
    lanes = lanes_engine(MODELS[0])
    P, st, tau = problem(lanes, 3, 0)
    with pytest.raises(ValueError, match="q has shape"):
        dk.launch_dynamics(host_lib, lanes.tables, P, dict(st, q=st["q"][:5]), tau, 0.005, True)
    with pytest.raises(TypeError, match="q"):
        dk.launch_dynamics(host_lib, lanes.tables, P, dict(st, q=st["q"].double()), tau, 0.005, True)
    with pytest.raises(ValueError, match="device"):
        dk.lanes_dynamics(lanes, P, st, tau.to("meta"))


# ------------------------------------------------------------------ CPU path

@pytest.mark.parametrize("robot", MODELS)
def test_cpu_path_is_the_plain_version(robot):
    lanes = lanes_engine(robot)
    P, st, tau = problem(lanes, 16, 1)
    before = (dk.lanes_dynamics.launches, dk.lanes_body_state.launches)
    out, ref = lanes._pre_contact(P, st, tau), lanes._pre_contact_plain(P, st, tau)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    derived = lanes.derived_state_lanes(st, lanes.e.default_state())
    for a, b in zip((derived.body_pos, derived.body_quat, derived.body_lin_vel, derived.body_ang_vel),
                    lanes._body_state_plain(st)):
        assert torch.equal(a, b)
    assert (dk.lanes_dynamics.launches, dk.lanes_body_state.launches) == before == (0, 0)


# ------------------------------------------------------------------ the kernel, built for the host

def _assert_close(name, a, b, tol):
    assert bool(torch.isfinite(a).all()), f"{name}: not finite"
    err = float((a - b).abs().max()) / max(1.0, float(b.abs().max())) if a.numel() else 0.0
    assert err <= tol, f"{name}: max diff {err:.3e} of its scale > {tol:g}"


@pytest.mark.parametrize("robot,options", [
    (MODELS[0], {}), (MODELS[1], {}), (MODELS[0], {"self_collision": False}),
    (MODELS[1], {"energy_projection": False}), (MODELS[0], {"terrain": True})])
def test_host_build_matches_plain(host_lib, robot, options):
    options = dict(options)
    terrain = options.pop("terrain", False)
    lanes = lanes_engine(robot, **options)
    if terrain:   # a rough heightfield: the ground rows' gap reads it in PyTorch
        lanes = Engine(load_g1_sim_model(robot), EngineOptions(), device="cpu").lanes()
        hf = np.random.default_rng(4).uniform(-0.2, 0.2, (40, 40)).astype(np.float32)
        lanes.e.set_terrain(hf, 0.1)
    N = 7
    P, st, tau = problem(lanes, N, 2)
    ref = lanes._pre_contact_plain(P, st, tau)
    if lanes.opt.energy_projection:   # the projection scales some env's u_plus at these states
        off = Engine(lanes.e.model, dataclasses.replace(lanes.opt, energy_projection=False), device="cpu").lanes()
        assert not torch.equal(off._pre_contact_plain(P, st, tau)[0], ref[0])
    for E in (1, 2, 4):
        out = dk.finish(lanes, *dk.launch_dynamics(host_lib, lanes.tables, P, st, tau, lanes.opt.dt,
                                                   lanes.opt.energy_projection, E))
        _assert_close("u_plus", out[0], ref[0], VEL_TOL)
        _assert_close("M_inv", out[1], ref[1], MINV_TOL)
        _assert_close("Jf", out[2], ref[2], POS_TOL)
        _assert_close("phi", out[3], ref[3], POS_TOL)
        if lanes.P:
            _assert_close("C", out[4], ref[4], POS_TOL)
        else:
            assert out[4] is None and ref[4] is None
        body = dk.launch_body_state(host_lib, lanes.tables, st, E)
        for name, a, b, atol in zip(("body_pos", "body_quat", "body_lin_vel", "body_ang_vel"), body,
                                    lanes._body_state_plain(st), (POS_TOL, POS_TOL, VEL_TOL, VEL_TOL)):
            _assert_close(name, a, b, atol)
