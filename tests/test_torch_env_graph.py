"""The five stages of a control step, the lanes engine's among them,
replayed as CUDA graphs
(`pbhc_tpu_torch/sim/step_graph.py`, `StageGraphs`): a step that reads no
host data, the rule by which its stages replay, and the data flow of a
replay. On the CPU a stand-in graph replays a stage by running its captured
region again on the graph's static buffers, packing into the same output
buffers, so that what a replay reads, hands back and clones is checked
against the eager step; on a card the `cuda` tests replay real graphs.

This file imports no JAX. Its `cuda` tests run on the card with
    python -m pytest --noconftest -m cuda tests/test_torch_env_graph.py
and skip without one.
"""
import dataclasses
import gc
import types
import weakref

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from pbhc_tpu_torch.eval import batch_eval
from pbhc_tpu_torch.sim import step_graph

torch.set_num_threads(2)

CKPTS = {"kb1": "artifacts/kb1_side_kick/ckpt/model_10500.pkl",
         "kb2": "artifacts/kb2_teacher29_r5/ckpt/model_3000.pkl"}
CUDA = torch.device("cuda")
# the index tables a step reads (GeneralTrackingEnv adds `key_body_id`)
TABLES = ("feet_indices", "penalised_contact_indices", "termination_contact_indices", "upper_body_id",
          "lower_body_id", "motion_tracking_id", "extend_parent_ids")


@pytest.fixture(scope="module", params=sorted(CKPTS))
def loaded(request):
    env, actor, _ = batch_eval.load(CKPTS[request.param], 12, device="cpu", seed=2**31 + 3)
    return request.param, env, actor


def _force_resets(env, state):
    """Every third env half a step short of its clip's end, so that the next
    step ends its motion and resets it, and every third but one three and a
    half steps short (the jump of its reference may end it sooner)."""
    assert env.ecfg.termination.terminate_when_motion_end
    i = torch.arange(env.num_envs, device=env.device) % 3
    steps = torch.where(i == 0, 0.5, 3.5) + state.episode_length.to(torch.float32)
    start = state.motion_len - steps * env.dt
    return dataclasses.replace(state, motion_start_times=torch.where(i < 2, start, state.motion_start_times))


def _leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree))
    else:
        return {}
    return {k: v for name, x in items for k, v in _leaves(x, f"{prefix}.{name}").items()}


def test_the_step_index_tables_are_device_int64(loaded):
    kind, env, _ = loaded
    names = TABLES + (("key_body_id",) if kind == "kb2" else ())
    for name in names:
        t = getattr(env, name)
        assert isinstance(t, torch.Tensor) and t.dtype == torch.int64 and t.device == env.device, name
    for name, v in vars(env).items():
        assert not isinstance(v, np.ndarray) or name == "teleop_marker_coords", name
    for lo, hi in env.draw_bounds.values():
        assert lo.dtype == hi.dtype == torch.float32 and lo.device == env.device


class _NoHostData(TorchFunctionMode):
    """Fails on a torch function that builds a tensor from host data or
    receives a numpy array or a list index: on a card each is a pageable
    host-to-device copy that synchronises."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.tensor, torch.asarray) or func is torch.as_tensor and not isinstance(args[0], torch.Tensor):
            raise AssertionError(f"{func.__name__} builds a tensor from host data")

        def visit(x):
            assert not isinstance(x, np.ndarray), f"a numpy array reaches {func}"
            if isinstance(x, (list, tuple)):
                for v in x:
                    visit(v)

        visit(list(args) + list(kwargs.values()))
        if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__):
            index = args[1] if isinstance(args[1], tuple) else (args[1],)
            assert not any(isinstance(i, list) for i in index), "a list indexes a tensor"
        return func(*args, **kwargs)


def test_a_step_with_resets_reads_no_host_data(loaded):
    _, env, actor = loaded
    state, obs = batch_eval.start_episodes(env)
    state = _force_resets(env, state)
    with torch.no_grad():
        actions = batch_eval.act_mean(actor, obs)
        with _NoHostData():
            state, obs, _, done, _ = env.step(state, actions)
    assert bool(done.any()) and not bool(done.all())
    assert bool((state.episode_length[done] == 0).all())


@pytest.fixture
def on_card(loaded):
    """The loaded CPU env as the eligibility rule would see it on a card:
    only `device` changes (no op runs)."""
    _, env, _ = loaded
    cpu = env.device
    env.device = CUDA
    try:
        yield env
    finally:
        env.device = cpu


def test_stages_may_replay_on_a_card_and_not_on_the_cpu(loaded, on_card):
    assert step_graph.env_eligible(on_card)
    on_card.device = torch.device("cpu")
    assert not step_graph.env_eligible(on_card)


def test_stages_stay_eager_with_soft_dynamic_correction_or_a_hooked_engine(on_card):
    on_card.use_sdc = True
    try:
        assert not step_graph.env_eligible(on_card)
    finally:
        on_card.use_sdc = False
    lanes = on_card.lanes_engine
    lanes.control_step_batched = lanes.control_step_batched
    try:
        assert not step_graph.env_eligible(on_card)
    finally:
        del lanes.control_step_batched
    assert step_graph.env_eligible(on_card)


def test_stages_stay_eager_when_data_parallel(on_card):
    shard = on_card.shard
    on_card.shard = types.SimpleNamespace(distributed=True)
    try:
        assert not step_graph.env_eligible(on_card)
    finally:
        on_card.shard = shard
    assert step_graph.env_eligible(on_card)


def test_stages_stay_eager_with_a_teleop_source(on_card):
    on_card.teleop_source = object()
    try:
        assert not step_graph.env_eligible(on_card)
    finally:
        on_card.teleop_source = None
    assert step_graph.env_eligible(on_card)


@pytest.mark.parametrize("stage,name", [(s, n) for s, names in step_graph.STAGES.items() for n in names])
def test_a_shadowed_stage_method_keeps_its_stage_eager(on_card, stage, name):
    inner = getattr(on_card, name)
    setattr(on_card, name, lambda *a, **kw: inner(*a, **kw))
    try:
        assert not step_graph.stage_eligible(on_card, stage)
        assert step_graph.env_eligible(on_card)
    finally:
        delattr(on_card, name)
    assert step_graph.stage_eligible(on_card, stage)


def test_each_stage_method_is_the_envs():
    from pbhc_tpu_torch.envs.general_tracking_env import GeneralTrackingEnv

    for names in step_graph.STAGES.values():
        for name in names:
            assert callable(getattr(GeneralTrackingEnv, name)), name


# ------------------------------------------------- replay on a stand-in graph

class _Graph:
    """A stand-in for `torch.cuda.CUDAGraph` on the CPU: `replay` runs the
    captured region again on the same static buffers and writes its packed
    outputs into the buffers the capture returned."""

    def __init__(self):
        self.region, self.packs, self.generators = None, None, []

    def register_generator_state(self, g):
        self.generators.append(g)

    def replay(self):
        for dt, p in self.region()[-1].items():
            self.packs[dt].copy_(p)


def _capture(graph, region):
    """As a capture: the region's draws leave its generators where they were."""
    states = [g.get_state() for g in graph.generators]
    out = region()
    for g, st in zip(graph.generators, states):
        g.set_state(st)
    graph.region, graph.packs = region, out[-1]
    return out


@pytest.fixture
def stand_in(monkeypatch):
    """Stages replay on the CPU through `_Graph` while `rule["on"]` holds."""
    rule = {"on": True}
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(step_graph, "_capture", _capture)
    monkeypatch.setattr(step_graph, "_observed", lambda fn, args: (fn(*args), 0))
    monkeypatch.setattr(step_graph, "env_eligible", lambda env: rule["on"])
    monkeypatch.setattr(step_graph, "engine_eligible", lambda env: rule["on"])
    return rule


def _run(env, actor, state, obs, n):
    outs = []
    with torch.no_grad():
        for _ in range(n):
            out = env.step(state, batch_eval.act_mean(actor, obs))
            state, obs = out[0], out[1]
            outs.append({k: v.clone() for k, v in _leaves(out).items()})
    return outs, state, obs


def test_replayed_stages_match_the_eager_step(loaded, stand_in):
    """After a first step that captures every stage, the engine's among them,
    eight steps with resets replay them; the same steps run eagerly from the same state and
    generator state give the same outputs bit for bit, and leave the
    generator where the replays left it."""
    _, env, actor = loaded
    env.stage_graphs = step_graph.StageGraphs()
    state, obs = batch_eval.start_episodes(env)
    _, state, obs = _run(env, actor, state, obs, 1)        # eager, and captures every stage
    state = _force_resets(env, state)
    g0 = env.gen.get_state()
    graphed, _, _ = _run(env, actor, state, obs, 8)
    g_graphed = env.gen.get_state()
    counts = env.stage_graphs.counts
    assert all(c == {"graphed": 8, "eager": 1} for c in counts.values()), counts
    assert len(env.stage_graphs.graphs) == 5
    for graph in env.stage_graphs.graphs.values():
        assert {id(g) for g in graph.graph.generators} == {id(env.gen), id(env.shared_gen)}
    stand_in["on"] = False
    env.gen.set_state(g0)
    eager, _, _ = _run(env, actor, state, obs, 8)
    assert all(c["eager"] == 9 for c in counts.values())
    assert eager[0][".3"].any() and not eager[0][".3"].all()
    for i, (a, b) in enumerate(zip(graphed, eager)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (i, k)
    assert torch.equal(env.gen.get_state(), g_graphed)


def test_a_replay_copies_in_only_what_its_stage_reads_and_hands_back_the_rest(loaded, stand_in):
    """The resets stage reads a fraction of the state's tensors, and hands
    back what it leaves unchanged (the curricula's scalars) as the caller's
    own tensors; what it makes comes back as views of one clone a dtype."""
    _, env, actor = loaded
    env.stage_graphs = step_graph.StageGraphs()
    state, obs = batch_eval.start_episodes(env)
    _run(env, actor, state, obs, 1)
    for key, graph in env.stage_graphs.graphs.items():
        assert 0 < len(graph.copy_in) < len(key[2]), key[0]
    reset_buf = torch.arange(env.num_envs) % 2 == 0
    out = env.stage_graphs.run(env, "resets", env._resets_stage, state, reset_buf)
    assert env.stage_graphs.counts["resets"] == {"graphed": 1, "eager": 1}
    assert out.average_episode_length is state.average_episode_length
    assert out.sigma_values is state.sigma_values
    bases = {t.untyped_storage().data_ptr() for t in _leaves(out).values()
             if not any(t is x for x in _leaves(state).values())}
    assert len(bases) <= 3


# an env tensor and where it is held: an attribute of the env, or a value of
# one of its dicts (the engine's lanes parameters)
REPLACED = {"p_gains": vars, "paramsT.mass": lambda env: env.paramsT}


@pytest.mark.parametrize("replaced", sorted(REPLACED))
def test_replaced_env_tensors_capture_the_stage_anew(loaded, stand_in, replaced):
    _, env, actor = loaded
    env.stage_graphs = step_graph.StageGraphs()
    state, obs = batch_eval.start_episodes(env)
    _, state, obs = _run(env, actor, state, obs, 2)
    before = dict(env.stage_graphs.graphs)
    holder, name = REPLACED[replaced](env), replaced.rsplit(".", 1)[-1]
    tensor = holder[name]
    holder[name] = tensor.clone()
    try:
        _run(env, actor, state, obs, 1)
    finally:
        holder[name] = tensor
    assert all(c == {"graphed": 1, "eager": 2} for c in env.stage_graphs.counts.values())
    assert all(env.stage_graphs.graphs[k] is not g for k, g in before.items())


def test_a_stage_that_syncs_or_writes_an_argument_stays_eager(loaded, stand_in, monkeypatch):
    _, env, actor = loaded
    env.stage_graphs = step_graph.StageGraphs()
    observed = step_graph._observed
    monkeypatch.setattr(step_graph, "_observed", lambda fn, args: (observed(fn, args)[0],
                                                                    int(fn.__name__ == "_resets_stage")))
    inner = env._actions_stage

    def writes(state, actions):
        out = inner(state, actions)
        state.push_counter.add_(0)
        return out

    monkeypatch.setattr(env, "_actions_stage", writes, raising=False)
    monkeypatch.setattr(step_graph, "STAGES", {**step_graph.STAGES, "actions": step_graph.STAGES["actions"][1:]})
    state, obs = batch_eval.start_episodes(env)
    _run(env, actor, state, obs, 3)
    counts, graphs = env.stage_graphs.counts, env.stage_graphs.graphs
    assert counts["resets"] == {"graphed": 0, "eager": 3} and counts["actions"] == {"graphed": 0, "eager": 3}
    assert counts["rewards"] == {"graphed": 2, "eager": 1}
    assert sorted(k[0] for k, g in graphs.items() if g is None) == ["actions", "resets"]


def test_a_cpu_env_runs_every_stage_eagerly(loaded):
    _, env, actor = loaded
    env.stage_graphs = step_graph.StageGraphs()
    state, obs = batch_eval.start_episodes(env)
    _run(env, actor, state, obs, 2)
    assert all(c == {"graphed": 0, "eager": 2} for c in env.stage_graphs.counts.values())
    assert not env.stage_graphs.graphs


def test_a_dropped_env_is_freed_without_the_cyclic_collector():
    """The stage graphs do not hold their env: a dropped env and its graphs
    go at once, never inside another env's capture, where the collector
    freeing a graph would invalidate the capture."""
    env, actor, _ = batch_eval.load(CKPTS["kb1"], 8, device="cpu")
    state, obs = batch_eval.start_episodes(env)
    _run(env, actor, state, obs, 1)
    ref = weakref.ref(env)
    enabled = gc.isenabled()
    gc.disable()
    try:
        del env, actor, state, obs
        assert ref() is None
    finally:
        if enabled:
            gc.enable()


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs run on a card only")
    batch_eval.set_precision()
    return CUDA


CARD_ENVS = {"kb1": 4096, "kb2": 2048}
# the reward terms that read the contact forces
CONTACT_TERMS = ("penalty_feet_contact_forces", "penalty_slippage", "penalty_stumble", "collision",
                 "feet_air_time", "foot_slip_penalty", "teleop_contact_mask", "teleop_contact_mask_v2")


def _fed_by_contact_forces(env, key, a, b) -> bool:
    """Whether the outputs `a` and `b` at `key` differ only where the contact
    forces feed them: the forces, and the reward columns and logs of the
    terms that read them."""
    if key.endswith("contact_forces"):
        return True
    if key == ".2":
        cols = [i for i, n in enumerate(env.reward_names) if n not in CONTACT_TERMS] + [len(env.reward_names)]
        return torch.equal(a[:, cols], b[:, cols])
    return key.startswith(".4.log.rew_") and key[len(".4.log.rew_"):] in CONTACT_TERMS


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(CARD_ENVS))
def test_replayed_steps_match_eager_ones_on_the_card(cuda_device, kind):
    """Eight replayed steps with resets and eight eager ones from the same
    state and generator state agree bit for bit, but what the contact forces
    feed (1e-6 relative): the engine sums each body's impulse rows with
    `index_add_`, whose float atomics add in any order, and the reward terms
    that read the forces follow them. The replayed steps run with CUDA's
    sync debug mode "error"."""
    env, actor, _ = batch_eval.load(CKPTS[kind], CARD_ENVS[kind], device=cuda_device, seed=2**31 + 17)
    state, obs = batch_eval.start_episodes(env)
    with torch.no_grad():
        for _ in range(2):       # the first runs eagerly and captures; the next replays
            state, obs, *_ = env.step(state, batch_eval.act_mean(actor, obs))
    state = _force_resets(env, state)
    torch.cuda.synchronize()
    g0 = env.gen.get_state()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graphed, _, _ = _run(env, actor, state, obs, 8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = env.stage_graphs.counts
    assert all(c == {"graphed": 9, "eager": 1} for c in counts.values()), counts
    env.gen.set_state(g0)
    lanes = env.lanes_engine
    lanes.control_step_batched = lanes.control_step_batched   # shadowed: every stage eager
    try:
        eager, _, _ = _run(env, actor, state, obs, 8)
    finally:
        del lanes.control_step_batched
    assert all(c == {"graphed": 9, "eager": 9} for c in counts.values())
    assert eager[0][".3"].any() and not eager[0][".3"].all()
    worst = {}
    for i, (a, b) in enumerate(zip(graphed, eager)):
        for k in a:
            if not torch.equal(a[k], b[k]):
                assert _fed_by_contact_forces(env, k, a[k], b[k]), (i, k)
                scale = max(float(b[k].float().abs().max()), 1.0)
                worst[k] = max(worst.get(k, 0.0), float((a[k].float() - b[k].float()).abs().max()) / scale)
    assert all(v <= 1e-6 for v in worst.values()), worst


@pytest.mark.cuda
def test_a_recorded_step_and_a_planted_fault_behave_as_eager_ones(cuda_device):
    from portbench import faults
    from portbench.window import HostCopies, StepRecorder

    env, actor, _ = batch_eval.load(CKPTS["kb1"], 4096, device=cuda_device, seed=5)
    state, obs = batch_eval.start_episodes(env)

    def step():
        nonlocal state, obs
        with torch.no_grad():
            out = env.step(state, batch_eval.act_mean(actor, obs))
        state, obs = out[0], out[1]
        return out

    step()
    step()
    counts = env.stage_graphs.counts
    assert all(c == {"graphed": 1, "eager": 1} for c in counts.values())
    recorder = StepRecorder(env, HostCopies(cuda_device))
    recorder.arm()
    step()
    torch.cuda.synchronize()
    assert len(recorder.record["subs"]) == 4 and len(recorder.record["solves"]) == 4
    assert all(c == {"graphed": 1, "eager": 2} for c in counts.values())
    # a planted 1% reward fault scales what the replayed step returns (two
    # replays of one step differ by the contact forces' atomics)
    g0, s0, o0 = env.gen.get_state(), state, obs
    clean = step()[2].clone()
    faults.reward_altered(type("L", (), {"env": env})())
    env.gen.set_state(g0)
    state, obs = s0, o0
    altered = step()[2]
    assert all(c == {"graphed": 3, "eager": 2} for c in counts.values())
    assert torch.allclose(altered, clean * 1.01, rtol=1e-5, atol=1e-7)
    assert not torch.allclose(altered, clean, rtol=1e-3, atol=0.0)
    del env.step
    step()
    assert all(c == {"graphed": 4, "eager": 2} for c in counts.values())
