"""The learner's minibatch steps replayed as CUDA graphs
(`pbhc_tpu_torch/agents/mh_ppo.py`, `MHPPO._minibatch`): the rule by
which a step replays, Adam's bias corrections and PPOMimic's `priv_reg`
coefficient as device scalars, and the data flow of a replay. On the CPU a
stand-in graph replays a step by running its captured region again on the
graph's static buffers, packing into the same output buffers (as
`tests/test_torch_env_graph.py` does for the env's stages), so that what a
replay reads, writes and hands back is checked against the eager step; on a
card the `cuda` tests replay real graphs at the benchmark cells' sizes.

This file imports no JAX. Its `cuda` tests run on the card with
    python -m pytest --noconftest -m cuda tests/test_torch_learner_graph.py
and skip without one.
"""
import copy
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from pbhc_tpu_torch.agents import mh_ppo
from pbhc_tpu_torch.agents.mh_ppo import Adam
from pbhc_tpu_torch.sim import step_graph

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TEACHER = "artifacts/kb2_teacher29_r5/ckpt/model_3000.pkl"
CKPTS = {"kb1": "artifacts/kb1_side_kick/ckpt/model_10500.pkl", "kb2-teacher": TEACHER,
         "kb2-student": "artifacts/kb2_student29_r5/ckpt/model_1750.pkl"}
CUDA = torch.device("cuda")
# options no committed run selects: a run's snapshot with other networks, fresh weights
VARIANTS = {"kb1-phase": ("kb1", ["algo.config.phase_embed.type=Sinusoidal"]),
            "kb2-moe": ("kb2-teacher", ["algo.config.module_dict.actor.layer_config.type=MoEMLP",
                                        "algo.config.module_dict.critic.layer_config.type=MoEMLP"])}


def _build(kind, envs, device, seed, steps=None):
    """The committed run `kind` as the benchmark's loops build it: its
    snapshot at `envs` envs on `device`, its checkpoint restored; or a
    `VARIANTS` entry, built from its run's snapshot with fresh weights."""
    from pbhc_tpu_torch.config.loader import Cfg, apply_overrides, snapshot_for_checkpoint
    from pbhc_tpu_torch.train import build
    from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload, restore_train_state

    run, over = VARIANTS.get(kind, (kind, []))
    cfg = snapshot_for_checkpoint(ROOT / CKPTS[run])
    cfg["num_envs"], cfg["seed"], cfg["device"] = envs, seed, str(device)
    over = over + ([f"algo.config.num_steps_per_env={steps}"] if steps else [])
    if kind == "kb2-student":
        over.append(f"algo.config.teacher_model_path={ROOT / TEACHER}")
    env, algo, ts = build(Cfg.wrap(apply_overrides(cfg, over)))
    if kind in VARIANTS:
        return env, algo, ts
    return env, algo, restore_train_state(ts, load_checkpoint_payload(ROOT / CKPTS[kind]))


@pytest.fixture(scope="module", params=["kb1", "kb2-teacher"])
def built(request):
    """A learner at 8 envs and 4 steps an iteration on the CPU, an `rl`
    iteration for the teacher, and one rollout."""
    env, algo, ts = _build(request.param, 8, "cpu", 2**31 + 7, steps=4)
    if request.param == "kb2-teacher":
        ts.iteration += 1
        # a schedule that moves the `priv_reg` coefficient every iteration
        algo.priv_reg_schedule = [0.0, 1.0, float(ts.iteration - 1), 8.0]
    return request.param, algo, ts, algo.rollout(ts)


def _opts(ts):
    return mh_ppo.train_state_parts(ts)[1]


# ------------------------------------------------------------------- the rule

@pytest.fixture
def on_card(built):
    """The CPU learner as the rule would see it on a card: only `device`
    changes (no op runs)."""
    _, algo, ts, _ = built
    cpu = algo.device
    algo.device = CUDA
    try:
        yield algo, ts
    finally:
        algo.device = cpu


def test_steps_may_replay_on_a_card_and_not_on_the_cpu(on_card):
    algo, ts = on_card
    assert mh_ppo.learner_eligible(algo, _opts(ts))
    algo.device = torch.device("cpu")
    assert not mh_ppo.learner_eligible(algo, _opts(ts))


def test_steps_stay_eager_when_data_parallel(on_card):
    algo, ts = on_card
    shard = algo.shard
    algo.shard = types.SimpleNamespace(distributed=True)
    try:
        assert not mh_ppo.learner_eligible(algo, _opts(ts))
    finally:
        algo.shard = shard
    assert mh_ppo.learner_eligible(algo, _opts(ts))


@pytest.mark.parametrize("name", mh_ppo.LEARNER_STEPS)
def test_a_shadowed_update_method_keeps_every_step_eager(on_card, name):
    algo, ts = on_card
    setattr(algo, name, lambda *a, **kw: None)
    try:
        assert not mh_ppo.learner_eligible(algo, _opts(ts))
    finally:
        delattr(algo, name)
    assert mh_ppo.learner_eligible(algo, _opts(ts))


@pytest.mark.parametrize("which", [0, 1])
def test_a_shadowed_optimizer_step_keeps_every_step_eager(on_card, which):
    algo, ts = on_card
    opts = _opts(ts)
    assert len(opts) == 2
    opts[which].step = lambda grads, lr: None
    try:
        assert not mh_ppo.learner_eligible(algo, opts)
    finally:
        del opts[which].step
    assert mh_ppo.learner_eligible(algo, opts)


def test_the_train_states_parts_are_its_networks_and_optimizers(built):
    kind, _, ts, _ = built
    nets, opts = mh_ppo.train_state_parts(ts)
    names = {"kb1": ("actor", "critic", "actor_opt", "critic_opt"), "kb2-teacher": ("net", "opt", "hist_opt")}[kind]
    assert [*nets, *opts] == [getattr(ts, n) for n in names]


# -------------------------------------------- Adam and the coefficient on the device

def _leaf_shapes(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _leaf_shapes(v, out)
    else:
        out.append(tuple(np.shape(tree)))
    return out


def _shapes(kind):
    from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload

    payload = load_checkpoint_payload(ROOT / CKPTS[kind])
    return _leaf_shapes({k: v for k, v in payload.items() if k.endswith("params")}, [])


def _python_float_step(opt, grads, lr):
    """`Adam.step` as it divided by Python floats: the bias corrections
    formed on the host each step."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = g_norm < opt.max_grad_norm
    opt.count += 1
    bc1 = float(np.float32(1.0) - np.float32(opt.b1) ** np.float32(opt.count))
    bc2 = float(np.float32(1.0) - np.float32(opt.b2) ** np.float32(opt.count))
    for p, g, m, v in zip(opt.params, grads, opt.mu, opt.nu):
        g = torch.where(keep, g, g / g_norm * opt.max_grad_norm)
        m.copy_((1.0 - opt.b1) * g + opt.b1 * m)
        v.copy_((1.0 - opt.b2) * (g * g) + opt.b2 * v)
        p.add_(-lr * ((m / bc1) / (torch.sqrt(v / bc2) + opt.eps)))


def _adam_against_python_floats(kind, leaves, device):
    """30 steps at the run's parameter shapes on `device`, every third one
    clipped, with the lr a device tensor: parameters and moments bit for
    bit, and the count once a step."""
    shapes = _shapes(kind)
    assert len(shapes) == leaves
    g = torch.Generator().manual_seed(11)
    start = [(torch.randn(s, generator=g) * 0.1).to(device) for s in shapes]
    with torch.no_grad():
        a, b = Adam([p.clone() for p in start], 1.0), Adam([p.clone() for p in start], 1.0)
        lr = torch.tensor(3e-4, device=device)
        for i in range(30):
            scale = 10.0 if i % 3 == 0 else 1e-3
            grads = [(torch.randn(s, generator=g) * scale).to(device) for s in shapes]
            a.step(grads, lr)
            _python_float_step(b, grads, lr)
            assert a.count == b.count == i + 1
    for x, y in zip((*a.params, *a.mu, *a.nu), (*b.params, *b.mu, *b.nu)):
        assert torch.equal(x, y)
    assert not torch.equal(a.params[0], start[0])


ADAM_SHAPES = [("kb1", 17), ("kb2-teacher", 41)]


@pytest.mark.parametrize("kind,leaves", ADAM_SHAPES)
def test_adam_with_device_corrections_equals_the_python_float_step(kind, leaves):
    """On the CPU the step divides by the corrections."""
    _adam_against_python_floats(kind, leaves, "cpu")


def test_the_priv_reg_coefficient_on_the_device_gives_the_floats_loss():
    """`coefficient * priv_reg` inside the RL loss, the coefficient a device
    scalar or a Python float, over the schedule's ramp: bit for bit."""
    g = torch.Generator().manual_seed(3)
    sched = np.asarray([0.0, 0.1, 3000.0, 3000.0], dtype=np.float32)
    scalar = torch.zeros(())
    for it in (0, 2999, 3000, 3001, 3777, 4500, 6000, 9000):
        stage = np.clip((np.float32(it) - sched[2]) / sched[3], np.float32(0), np.float32(1))
        coef = float(stage * (sched[1] - sched[0]) + sched[0])
        surr, ent, vloss, priv, lb = (torch.rand((), generator=g) * 10 for _ in range(5))
        scalar.fill_(coef)
        as_float = surr - 0.005 * ent + 1.0 * vloss + coef * priv + 0.01 * lb
        on_device = surr - 0.005 * ent + 1.0 * vloss + scalar * priv + 0.01 * lb
        assert torch.equal(as_float, on_device), it


@pytest.mark.parametrize("built", ["kb2-teacher"], indirect=True)
def test_the_rl_step_reads_the_iterations_coefficient(built):
    """`update_rl` with the coefficient from `_priv_reg_coef_at` and with the
    Python float `priv_reg_coef` gives: the same parameters, bit for bit."""
    _, algo, ts, rollout = built
    batch = _first_batch(algo, ts, rollout)
    outs = []
    for as_float in (False, True):
        state = copy.deepcopy(ts)
        if as_float:
            algo._priv_reg_coef_at = lambda it: algo.priv_reg_coef(it)
        try:
            algo.update_rl(state, batch)
        finally:
            vars(algo).pop("_priv_reg_coef_at", None)
        outs.append([p.clone() for p in state.opt.params])
    assert float(algo.priv_reg_scalar) == algo.priv_reg_coef(ts.iteration) > 0
    assert all(torch.equal(x, y) for x, y in zip(*outs))


def _first_batch(algo, ts, rollout):
    """The first minibatch `learn` would hand its first step."""
    _, obs, traj, *_ = rollout
    with torch.no_grad():
        last = ts.critic(obs["critic_obs"]) if hasattr(ts, "critic") else ts.net.evaluate(obs)
    returns, adv = algo._gae(traj, last)
    T, N = traj["values"].shape[:2]
    flat = {k: v.reshape(T * N, *v.shape[2:]) for k, v in traj.items()}
    flat["returns"], flat["advantages"] = returns.reshape(T * N, -1), adv.reshape(T * N)
    return {k: v[: T * N // algo.num_minibatches] for k, v in flat.items()}


# ------------------------------------------------------ replay on a stand-in graph

# what the last step held fixed: the tensors a stand-in capture leaves as they were
_HELD = []


class _Graph:
    """A stand-in for `torch.cuda.CUDAGraph` on the CPU: `replay` runs the
    captured region again, as a replay, on the same static buffers and
    writes its packed outputs into the buffers the capture returned."""

    in_graph = False

    def __init__(self):
        self.region, self.packs, self.generators = None, None, []

    def register_generator_state(self, g):
        self.generators.append(g)

    def replay(self):
        _Graph.in_graph = True
        try:
            packs = self.region()[-1]
        finally:
            _Graph.in_graph = False
        for dt, p in packs.items():
            self.packs[dt].copy_(p)


def _capture(graph, region):
    """As a capture, which issues no kernel: nothing is counted or written
    from the host, the held tensors the region writes in place are as they
    were, and its draws leave its generators where they were."""
    states = [g.get_state() for g in graph.generators]
    held = [(t, t.detach().clone()) for t in _HELD[-1]]
    _Graph.in_graph = True
    try:
        out = region()
    finally:
        _Graph.in_graph = False
    with torch.no_grad():
        for t, was in held:
            t.copy_(was)
    for g, st in zip(graph.generators, states):
        g.set_state(st)
    graph.region, graph.packs = region, out[-1]
    return out


@pytest.fixture
def stand_in(monkeypatch, built):
    """Minibatch steps replay on the CPU through `_Graph` while `rule["on"]`
    holds and the rest of `learner_eligible` does."""
    _, algo, _, _ = built
    rule, real = {"on": True}, mh_ppo.learner_eligible

    def eligible(learner, optimizers):
        cpu = learner.device
        learner.device = CUDA
        try:
            return rule["on"] and real(learner, optimizers)
        finally:
            learner.device = cpu

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(step_graph, "_capture", _capture)
    monkeypatch.setattr(step_graph, "_observed", lambda fn, args: (fn(*args), 0))
    monkeypatch.setattr(mh_ppo, "capturing", lambda t: _Graph.in_graph)
    monkeypatch.setattr(mh_ppo, "learner_eligible", eligible)
    fixed = mh_ppo._learner_fixed
    monkeypatch.setattr(mh_ppo, "_learner_fixed", lambda *a: _HELD.append(fixed(*a)) or _HELD[-1])
    algo.graphs = step_graph.StageGraphs(mh_ppo.LEARNER_STEPS)
    return rule


STEP = {"kb1": "_minibatch_update", "kb2-teacher": "update_rl", "kb2-student": "update_distill",
        "kb1-phase": "_minibatch_update", "kb2-moe": "update_rl"}


def _state(ts):
    """Every tensor a step changes: parameters, moments, the lr, and counts."""
    opts = _opts(ts)
    return ([t.detach().clone() for o in opts for t in (*o.params, *o.mu, *o.nu)] + [ts.lr.clone()],
            [o.count for o in opts])


def test_replayed_steps_match_the_eager_ones(built, stand_in):
    """Two iterations from one rollout: the first step of the first runs
    eagerly and captures, the other 2 x 20 - 1 replay; the same iterations
    run eagerly from the same state and generator state give the same
    parameters, moments, lr, counts and log bit for bit."""
    kind, algo, ts0, rollout = built
    steps = algo.num_epochs * algo.num_minibatches
    g0 = algo.perm_gen.get_state()
    ts, logs = copy.deepcopy(ts0), []
    for _ in range(2):
        ts, log = algo.learn(ts, rollout)
        logs.append(log)
    graphed = _state(ts)
    assert algo.graphs.counts[STEP[kind]] == {"graphed": 2 * steps - 1, "eager": 1}
    assert len(algo.graphs.graphs) == 1
    (graph,) = algo.graphs.graphs.values()
    assert [id(g) for g in graph.graph.generators] == [id(algo.gen)]
    assert 0 < len(graph.copy_in) <= len(rollout[2]) + 3
    stand_in["on"] = False
    algo.perm_gen.set_state(g0)
    ts, eager_logs = copy.deepcopy(ts0), []
    for _ in range(2):
        ts, log = algo.learn(ts, rollout)
        eager_logs.append(log)
    eager = _state(ts)
    assert algo.graphs.counts[STEP[kind]]["eager"] == 1 + 2 * steps
    assert graphed[1] == eager[1]
    assert _opts(ts)[0].count == _opts(ts0)[0].count + 2 * steps
    for a, b in zip(graphed[0], eager[0]):
        assert torch.equal(a, b)
    for a, b in zip(logs, eager_logs):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(graphed[0][0], _state(ts0)[0][0])


def test_a_shadowed_optimizer_step_after_capture_runs_eagerly(built, stand_in):
    kind, algo, ts0, rollout = built
    ts = copy.deepcopy(ts0)
    batch = _first_batch(algo, ts, rollout)
    for _ in range(2):
        algo._minibatch(ts, STEP[kind], batch, len(batch["actions"]))
    assert algo.graphs.counts[STEP[kind]] == {"graphed": 1, "eager": 1}
    opt = _opts(ts)[0]
    before = [p.detach().clone() for p in opt.params]
    opt.step = lambda grads, lr: None
    try:
        algo._minibatch(ts, STEP[kind], batch, len(batch["actions"]))
    finally:
        del opt.step
    assert algo.graphs.counts[STEP[kind]] == {"graphed": 1, "eager": 2}
    assert all(torch.equal(a, b) for a, b in zip(before, opt.params))
    algo._minibatch(ts, STEP[kind], batch, len(batch["actions"]))
    assert algo.graphs.counts[STEP[kind]] == {"graphed": 2, "eager": 2}


def test_a_replaced_optimizer_list_captures_the_step_anew(built, stand_in):
    """An optimizer list no longer holding what the graph read captures the
    step anew: kb1's critic moments replaced by copies; the teacher's
    `hist_opt.params` emptied (as the distillation fault that lets the
    history encoder's gradients through empties the student's)."""
    kind, algo, ts0, rollout = built
    ts = copy.deepcopy(ts0)
    batch = _first_batch(algo, ts, rollout)
    for _ in range(2):
        algo._minibatch(ts, STEP[kind], batch, len(batch["actions"]))
    (first,) = algo.graphs.graphs.values()
    opt = _opts(ts)[-1]
    name = "mu" if kind == "kb1" else "params"
    kept = getattr(opt, name)
    setattr(opt, name, [t.clone() for t in kept] if kind == "kb1" else [])
    try:
        for _ in range(2):
            algo._minibatch(ts, STEP[kind], batch, len(batch["actions"]))
    finally:
        setattr(opt, name, kept)
    assert algo.graphs.counts[STEP[kind]] == {"graphed": 2, "eager": 2}
    (second,) = algo.graphs.graphs.values()
    assert second is not first


def test_a_cpu_learner_runs_every_step_eagerly(built):
    kind, algo, ts0, rollout = built
    algo.graphs = step_graph.StageGraphs(mh_ppo.LEARNER_STEPS)
    algo.learn(copy.deepcopy(ts0), rollout)
    steps = algo.num_epochs * algo.num_minibatches
    assert algo.graphs.counts[STEP[kind]] == {"graphed": 0, "eager": steps} and not algo.graphs.graphs


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    """The card, with cuDNN's deterministic algorithms: the conv encoders'
    weight gradient is otherwise summed in any order, and two eager runs
    differ as a replay and an eager run would (`PERF.md` §6). The
    other tests of the process keep the default."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs run on a card only")
    from pbhc_tpu_torch.eval import batch_eval

    batch_eval.set_precision()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield CUDA
    torch.backends.cudnn.deterministic = deterministic


# the benchmark cells' envs, and their runs' for the variants
CARD_ENVS = {"kb1": 4096, "kb2-teacher": 2048, "kb2-student": 2048, "kb1-phase": 4096, "kb2-moe": 2048}


def _gap(a, b) -> float:
    """|a - b| over |b|'s largest, 0 where equal."""
    if torch.equal(a, b):
        return 0.0
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,leaves", ADAM_SHAPES)
def test_adam_on_the_card_equals_the_python_float_step(cuda_device, kind, leaves):
    """On the card the step multiplies by the corrections' reciprocals, as
    PyTorch's CUDA kernels divide by a Python float."""
    assert Adam([torch.zeros(1, device=cuda_device)], 1.0).corrections[0].is_cuda
    _adam_against_python_floats(kind, leaves, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(CARD_ENVS))
def test_replayed_steps_match_eager_ones_on_the_card(cuda_device, kind):
    """Two iterations of the cell's size from one rollout, graphed (the
    second's steps all replays, with CUDA's sync debug mode "error") and
    eager (the update method shadowed on the instance) from the same state
    and generator state: parameters, moments, lr, counts and log agree bit
    for bit. The teacher's checkpoint iteration is `rl+dagger`, as is the
    MoE teacher's first: their DAgger pass runs eagerly in both."""
    env, algo, ts0 = _build(kind, CARD_ENVS[kind], cuda_device, 2**31 + 29)
    rollout = algo.rollout(ts0)
    name = STEP[kind]
    steps = algo.num_minibatches * (1 if name == "update_distill" else algo.num_epochs)
    g0 = algo.perm_gen.get_state()
    ts, logs = copy.deepcopy(ts0), []
    ts, log = algo.learn(ts, rollout)
    logs.append(log)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts, log = algo.learn(ts, rollout)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    logs.append(log)
    graphed = _state(ts)
    assert algo.graphs.counts[name] == {"graphed": 2 * steps - 1, "eager": 1}, algo.graphs.counts
    algo.perm_gen.set_state(g0)
    setattr(algo, name, getattr(algo, name))
    try:
        ts, eager_logs = copy.deepcopy(ts0), []
        for _ in range(2):
            ts, log = algo.learn(ts, rollout)
            eager_logs.append(log)
    finally:
        delattr(algo, name)
    eager = _state(ts)
    assert algo.graphs.counts[name] == {"graphed": 2 * steps - 1, "eager": 1 + 2 * steps}
    assert graphed[1] == eager[1]
    gaps = [_gap(a, b) for a, b in zip(graphed[0], eager[0])]
    log_gaps = {k: _gap(a[k], b[k]) for a, b in zip(logs, eager_logs) for k in a}
    print(kind, "largest gap: state", max(gaps), "log", max(log_gaps.values()))
    assert max(gaps) == 0.0 and max(log_gaps.values()) == 0.0, (max(gaps), log_gaps)


@pytest.mark.cuda
def test_a_shadowed_step_and_a_replaced_list_on_the_card(cuda_device):
    """The student's BC step: after capture, a shadowed optimizer step runs
    eagerly; an emptied `hist_opt.params` (the history encoder's gradients
    let through) captures the step anew, and the history encoder then moves."""
    env, algo, ts = _build("kb2-student", CARD_ENVS["kb2-student"], cuda_device, 2**31 + 31)
    rollout = algo.rollout(ts)
    T, N = rollout[2]["values"].shape[:2]
    keys = ("actor_obs", "priv_obs", "future_motion_targets", "prop_history", "teacher_actions")
    batch = {k: rollout[2][k].reshape(T * N, -1)[: T * N // 4] for k in keys}
    rows = T * N // 4
    counts = algo.graphs.counts["update_distill"]
    for _ in range(2):
        algo._minibatch(ts, "update_distill", batch, rows)
    assert counts == {"graphed": 1, "eager": 1}
    opt = ts.opt
    before = [p.detach().clone() for p in opt.params]
    opt.step = lambda grads, lr: None
    try:
        algo._minibatch(ts, "update_distill", batch, rows)
    finally:
        del opt.step
    assert counts == {"graphed": 1, "eager": 2}
    assert all(torch.equal(a, b) for a, b in zip(before, opt.params))
    hist = [p.detach().clone() for p in ts.hist_opt.params]
    kept, ts.hist_opt.params = ts.hist_opt.params, []
    try:
        for _ in range(2):
            algo._minibatch(ts, "update_distill", batch, rows)
    finally:
        ts.hist_opt.params = kept
    assert counts == {"graphed": 2, "eager": 3}
    assert not all(torch.equal(a, b) for a, b in zip(hist, kept))
