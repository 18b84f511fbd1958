"""The lanes engine's control step replayed as one CUDA graph, the engine's
stage of `StageGraphs` (`pbhc_tpu_torch/sim/step_graph.py`): the rule by
which a step replays, the
host-free index tables that make capture possible, the torque function's
pure form, and on a card the graphed step against the eager one.

This file imports no JAX. Its `cuda` tests run on the card with
    python -m pytest --noconftest -m cuda tests/test_torch_engine_graph.py
and skip without one.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from pbhc_tpu_torch.eval import batch_eval
from pbhc_tpu_torch.model.g1 import load_g1_sim_model
from pbhc_tpu_torch.sim import contact_kernel, step_graph
from pbhc_tpu_torch.sim.engine import Engine, EngineOptions, SimState

torch.set_num_threads(2)

CKPT = "artifacts/kb1_side_kick/ckpt/model_10500.pkl"
CUDA = torch.device("cuda")
# every method whose replacement on the instance keeps a step eager
SHADOWED = ("control_step_batched", "contact_solve", "_substep", "_integrate")


@pytest.fixture(scope="module")
def lanes():
    opt = EngineOptions(dt=0.005, solver="lanes", solver_iters=16, contact_cap=8, pair_cap=4)
    return Engine(load_g1_sim_model(), opt, device="cpu").lanes()


def test_graph_is_eligible_on_a_card_with_the_engine_unhooked(lanes):
    assert step_graph.eligible(lanes, CUDA)
    assert step_graph.eligible(lanes, "cuda:0")


def test_graph_is_not_eligible_off_a_card_or_with_a_pre_substep_hook(lanes):
    assert not step_graph.eligible(lanes, torch.device("cpu"))
    env = types.SimpleNamespace(device=CUDA, lanes_engine=lanes, use_sdc=False)
    assert step_graph.engine_eligible(env)
    env.use_sdc = True          # soft dynamic correction: a pre-substep hook
    assert not step_graph.engine_eligible(env)


@pytest.mark.parametrize("name", SHADOWED)
def test_a_shadowed_engine_method_keeps_the_step_eager(lanes, name):
    inner = getattr(lanes, name)
    setattr(lanes, name, lambda *a, **kw: inner(*a, **kw))
    try:
        assert not step_graph.eligible(lanes, CUDA)
    finally:
        if name == "contact_solve":
            lanes.contact_solve = inner
        else:
            delattr(lanes, name)
    assert step_graph.eligible(lanes, CUDA)


def test_a_plain_contact_solve_keeps_the_step_eager(lanes):
    lanes.contact_solve = contact_kernel.apgd_lanes_plain
    try:
        assert not step_graph.eligible(lanes, CUDA)
    finally:
        lanes.contact_solve = contact_kernel.apgd_lanes
    assert step_graph.eligible(lanes, CUDA)


def test_step_path_index_tables_are_device_tensors(lanes):
    for name in ("_pos", "_joint_slot", "_dof_body", "_contact_body", "_pair_i", "_pair_j"):
        t = getattr(lanes, name)
        assert isinstance(t, torch.Tensor) and t.dtype == torch.int64 and t.device == lanes.device, name
    for name in ("_levels", "_parent_pos", "_level_parent"):
        assert all(isinstance(t, torch.Tensor) and t.dtype == torch.int64 and t.device == lanes.device
                   for t in getattr(lanes, name)), name
    assert isinstance(lanes._grav, torch.Tensor) and lanes._grav.device == lanes.device
    assert all(isinstance(a, int) and isinstance(b, int) for a, b in lanes._dof_groups)
    for name, v in vars(lanes).items():
        assert not isinstance(v, np.ndarray), name
        if isinstance(v, (list, tuple)):
            assert not any(isinstance(x, np.ndarray) for x in v), name


class _NoHostIndex(TorchFunctionMode):
    """Fails on any tensor indexed by a numpy array: on a card each such
    index is a pageable host-to-device copy that synchronises."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.__getitem__:
            index = args[1] if isinstance(args[1], tuple) else (args[1],)
            assert not any(isinstance(i, np.ndarray) for i in index), "a numpy array indexes a tensor"
        return func(*args, **(kwargs or {}))


def test_a_control_step_indexes_with_no_host_array(lanes):
    e = lanes.e
    N = 8
    batch = lambda t: t.expand(N, *t.shape).clone()
    s0 = e.default_state(root_pos=(0.0, 0.0, 0.78))
    states = SimState(**{f.name: batch(getattr(s0, f.name)) for f in dataclasses.fields(s0)})
    params = e.default_params()
    params = dataclasses.replace(params, **{f.name: batch(getattr(params, f.name))
                                            for f in dataclasses.fields(params)})
    tau = lambda st: -20.0 * st.dof_pos - st.dof_vel
    with _NoHostIndex():
        out, _ = lanes.control_step_batched(params, states, tau, 4)
    assert torch.isfinite(out.body_pos).all() and torch.isfinite(out.contact_forces).all()


def _closure_torques(env, state, target, kp_eff, kd_eff, st):
    """The lanes branch's torque function as a closure over the step's
    tensors: PD, RFI noise from the env's generator, RAO, clamped."""
    dr = env.dr
    rfi_scale = float(dr.rfi_lim) * state.rfi_lim_scale * env.torque_limits
    rao_tau = state.rao_scale * env.torque_limits
    tau = kp_eff * (target - st.dof_pos) - kd_eff * st.dof_vel
    noise = 2.0 * torch.rand(tau.shape, generator=env.gen, device=env.device) - 1.0
    tau = tau + noise * rfi_scale
    tau = tau + rao_tau
    return torch.clamp(tau, -env.torque_limits, env.torque_limits)


def test_pure_torques_match_the_closure_from_one_generator_state():
    env, actor, _ = batch_eval.load(CKPT, 16, device="cpu", seed=7)
    assert env.dr.get("randomize_torque_rfi") and env.dr.get("use_rao") and env.physics == "lanes"
    state, obs = batch_eval.start_episodes(env)
    with torch.no_grad():
        state, obs, *_ = env.step(state, batch_eval.act_mean(actor, obs))
        actions = batch_eval.act_mean(actor, obs)
    assert bool((state.rao_scale != 0).any())
    target = actions * env.action_scales + state.default_dof_pos
    kp, kd = state.kp_scale * env.p_gains, state.kd_scale * env.d_gains
    inputs = env._torque_inputs(state, target, kp, kd)
    assert set(inputs) == {"target", "kp_eff", "kd_eff", "rfi_scale", "rao_tau"}
    g0 = env.gen.get_state()
    want = [_closure_torques(env, state, target, kp, kd, state.sim) for _ in range(4)]
    env.gen.set_state(g0)
    got = [env._torques(inputs, state.sim) for _ in range(4)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    env.gen.set_state(g0)
    assert torch.equal(env._torques(env._torque_inputs(state, target, kp, kd), state.sim), want[0])


def test_a_cpu_env_steps_its_lanes_engine_eagerly():
    env, actor, _ = batch_eval.load(CKPT, 8, device="cpu")
    state, obs = batch_eval.start_episodes(env)
    with torch.no_grad():
        for _ in range(2):
            state, obs, *_ = env.step(state, batch_eval.act_mean(actor, obs))
    assert env.stage_graphs.counts["engine"] == {"graphed": 0, "eager": 2} and not env.stage_graphs.graphs


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and kernel 1 run on a card only")
    batch_eval.set_precision()
    return CUDA


def _state_tensors(state):
    sim = {f"sim.{f.name}": getattr(state.sim, f.name) for f in dataclasses.fields(state.sim)}
    return {**sim, "torques": state.torques}


def _steps(env, actor, state, obs, n):
    outs = []
    with torch.no_grad():
        for _ in range(n):
            state, obs, *_ = env.step(state, batch_eval.act_mean(actor, obs))
            outs.append({k: v.clone() for k, v in _state_tensors(state).items()})
    return outs


@pytest.mark.cuda
def test_graphed_control_steps_match_eager_ones(cuda_device):
    """8 graphed control steps and 8 eager ones at 4096 envs from one state
    and one generator state agree bit for bit, but the contact forces: the
    engine sums each body's impulse rows with `index_add_`, whose float
    atomics add in any order (1e-6 relative)."""
    env, actor, _ = batch_eval.load(CKPT, 4096, device=cuda_device, seed=2**31 + 11)
    state, obs = batch_eval.start_episodes(env)
    with torch.no_grad():
        for _ in range(3):          # the first runs eagerly and captures; the next replay
            state, obs, *_ = env.step(state, batch_eval.act_mean(actor, obs))
    assert env.stage_graphs.counts["engine"] == {"graphed": 2, "eager": 1}
    g0 = env.gen.get_state()
    graphed = _steps(env, actor, state, obs, 8)
    assert env.stage_graphs.counts["engine"]["graphed"] == 10
    env.gen.set_state(g0)
    lanes = env.lanes_engine
    lanes.control_step_batched = lanes.control_step_batched   # shadowed: eager
    try:
        eager = _steps(env, actor, state, obs, 8)
    finally:
        del lanes.control_step_batched
    assert env.stage_graphs.counts["engine"] == {"graphed": 10, "eager": 9}
    for i, (a, b) in enumerate(zip(graphed, eager)):
        for k in a:
            if k == "sim.contact_forces":
                scale = float(b[k].abs().max())
                assert float((a[k] - b[k]).abs().max()) <= 1e-6 * max(scale, 1.0), (i, k)
            else:
                assert torch.equal(a[k], b[k]), (i, k, float((a[k] - b[k]).abs().max()))


@pytest.mark.cuda
def test_replays_count_kernel_1_and_a_recorded_step_runs_eagerly(cuda_device):
    from portbench.window import HostCopies, StepRecorder

    env, actor, _ = batch_eval.load(CKPT, 4096, device=cuda_device, seed=5)
    state, obs = batch_eval.start_episodes(env)

    def step():
        nonlocal state, obs
        with torch.no_grad():
            state, obs, *_ = env.step(state, batch_eval.act_mean(actor, obs))

    step()
    step()
    before, modes = contact_kernel.apgd_lanes.launches, dict(contact_kernel.apgd_lanes.mode_launches)
    step()
    assert env.stage_graphs.counts["engine"] == {"graphed": 2, "eager": 1}
    assert contact_kernel.apgd_lanes.launches - before == env.decimation == 4
    assert contact_kernel.apgd_lanes.mode_launches["float32"] - modes["float32"] == 4
    recorder = StepRecorder(env, HostCopies(cuda_device))
    recorder.arm()
    step()
    torch.cuda.synchronize()
    rec = recorder.record
    assert len(rec["subs"]) == 4 and len(rec["solves"]) == 4
    assert env.stage_graphs.counts["engine"] == {"graphed": 2, "eager": 2}
    before = contact_kernel.apgd_lanes.launches
    step()
    assert env.stage_graphs.counts["engine"] == {"graphed": 3, "eager": 2}
    assert contact_kernel.apgd_lanes.launches - before == 4
    assert torch.isfinite(state.sim.body_pos).all()
