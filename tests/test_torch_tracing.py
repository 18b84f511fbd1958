"""The program's spans (`pbhc_tpu_torch.utils.profiling.span`): off, one
shared no-op context that records nothing; under a profiler, named ranges on
its timeline with in-memory records (parent, host times, host syncs) grouped
by profiler session; and the spans of the env step, the lanes engine and the
learners (MHPPO's and PPOMimic's).

This file imports no JAX. Its `cuda` test runs on the card with
    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
and skips without one.
"""
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pbhc_tpu_torch.utils import profiling
from pbhc_tpu_torch.utils.profiling import KEEP_SESSIONS, SYNC_WARNING, span

torch.set_num_threads(2)

CKPT = "artifacts/kb1_side_kick/ckpt/model_10500.pkl"
STAGES = ["env.actions", "env.engine", "env.rewards", "env.resets", "env.observations"]
ENGINE = ["engine.dynamics", "engine.contact", "engine.position_pass"]


def cpu_profile():
    """A CPU profiler session whose spans make a session of records of their
    own: a span opened with no profiler running ends the one before."""
    with span("between"):
        pass
    return profile(activities=[ProfilerActivity.CPU])


def children(records, i):
    return [r for r in records if r.parent == i]


def test_off_span_is_the_shared_noop_and_records_nothing():
    assert not torch.autograd._profiler_enabled()
    before = [len(s) for s in profiling.sessions()]
    a, b = span("a"), span("b")
    assert a is b
    with span("a"):
        with span("b"):
            torch.ones(2) * 2
    assert [len(s) for s in profiling.sessions()] == before


def test_nested_spans_keep_their_parents_and_sit_on_the_timeline():
    with cpu_profile() as prof:
        with span("outer"):
            with span("inner"):
                torch.ones(8) * 2
            with span("inner"):
                pass
        with span("second"):
            pass
    rec = profiling.sessions()[-1]
    assert [(r.name, r.parent) for r in rec] == [("outer", None), ("inner", 0), ("inner", 0), ("second", None)]
    assert all(r.end_ns >= r.start_ns for r in rec)
    assert rec[0].start_ns <= rec[1].start_ns and rec[2].end_ns <= rec[0].end_ns
    assert profiling.totals(rec)["inner"]["count"] == 2
    assert profiling.root_of(rec, 2) == "outer"
    names = [e.name for e in prof.events()]
    assert {"outer", "inner", "second"} <= set(names) and names.count("inner") == 2


def test_each_profile_is_a_session_and_eight_are_kept():
    for k in range(KEEP_SESSIONS + 3):
        with cpu_profile():
            for _ in range(k + 1):
                with span(f"s{k}"):
                    pass
    got = profiling.sessions()
    assert len(got) == KEEP_SESSIONS
    assert [len(s) for s in got] == list(range(4, KEEP_SESSIONS + 4))
    assert got[-1][0].name == f"s{KEEP_SESSIONS + 2}" and got[-2][0].name == f"s{KEEP_SESSIONS + 1}"


def test_sync_warnings_count_against_the_innermost_span_and_others_pass():
    with pytest.warns(UserWarning, match="another warning") as seen:
        with cpu_profile():
            with span("outer"):
                with span("inner"):
                    warnings.warn(SYNC_WARNING)
                    warnings.warn(SYNC_WARNING + " (Triggered internally)")
                warnings.warn(SYNC_WARNING)
                warnings.warn("another warning")
    rec = profiling.sessions()[-1]
    assert [(r.name, r.syncs) for r in rec] == [("outer", 1), ("inner", 2)]
    assert not [w for w in seen if SYNC_WARNING in str(w.message)]
    # outside a recording span the warning is an ordinary warning again
    with pytest.warns(UserWarning, match=SYNC_WARNING):
        warnings.warn(SYNC_WARNING)


def test_env_step_spans_cover_the_step_by_stage():
    from pbhc_tpu_torch.eval import batch_eval

    env, actor, _ = batch_eval.load(CKPT, 16, device="cpu")
    assert env.physics == "lanes"
    state, obs = batch_eval.start_episodes(env)
    with torch.no_grad():
        state, obs, *_ = env.step(state, batch_eval.act_mean(actor, obs))
        with cpu_profile():
            actions = batch_eval.act_mean(actor, obs)
            env.step(state, actions)
    rec = profiling.sessions()[-1]
    assert [r.name for r in rec if r.parent is None] == ["policy", "env.step"]
    step = next(i for i, r in enumerate(rec) if r.name == "env.step")
    kids = children(rec, step)
    assert [r.name for r in kids] == STAGES
    assert sum(r.seconds for r in kids) >= 0.9 * rec[step].seconds
    engine = next(i for i, r in enumerate(rec) if r.name == "env.engine")
    subs = children(rec, engine)
    assert [r.name for r in subs] == ENGINE * env.decimation
    assert all(r.syncs == 0 for r in rec)


def test_learner_spans():
    from pbhc_tpu_torch.config.loader import Cfg, apply_overrides, snapshot_for_checkpoint
    from pbhc_tpu_torch.train import build

    cfg = snapshot_for_checkpoint(CKPT)
    cfg["num_envs"], cfg["device"] = 16, "cpu"
    env, algo, ts = build(Cfg.wrap(apply_overrides(cfg, ["algo.config.num_steps_per_env=2"])))
    with cpu_profile():
        rollout = algo.rollout(ts)
    rec = profiling.sessions()[-1]
    t = profiling.totals(rec)
    assert rec[0].name == "learner.rollout" and rec[0].parent is None
    assert t["policy"]["count"] == t["env.step"]["count"] == algo.num_steps == 2
    assert all(r.parent == 0 for r in rec if r.name in ("policy", "env.step"))
    with cpu_profile():
        algo.learn(ts, rollout)
    rec = profiling.sessions()[-1]
    t = profiling.totals(rec)
    assert rec[0].name == "learner.update" and t["learner.update"]["count"] == 1
    assert t["learner.gae"]["count"] == 1
    assert t["learner.minibatch"]["count"] == algo.num_epochs * algo.num_minibatches
    assert all(r.parent == 0 for r in rec[1:])


@pytest.fixture(scope="module")
def mimic():
    """KungfuBot2's 29-DoF teacher at 16 envs and 2 steps an iteration, fresh
    weights: its first iteration (0) is an rl+dagger one."""
    from pbhc_tpu_torch.config.loader import Cfg, apply_overrides, load_snapshot
    from pbhc_tpu_torch.train import build

    cfg = load_snapshot("kb2_teacher29_r5")
    cfg["num_envs"], cfg["device"] = 16, "cpu"
    return build(Cfg.wrap(apply_overrides(cfg, ["algo.config.num_steps_per_env=2"])))


def test_mimic_learner_spans(mimic):
    env, algo, ts = mimic
    for mode in ("rl+dagger", "rl"):
        assert algo.mode(ts) == mode
        with cpu_profile():
            rollout = algo.rollout(ts)
        rec = profiling.sessions()[-1]
        t = profiling.totals(rec)
        assert rec[0].name == "learner.rollout" and rec[0].parent is None
        assert t["policy"]["count"] == t["env.step"]["count"] == algo.num_steps == 2
        assert all(r.parent == 0 for r in rec if r.name in ("policy", "env.step"))
        with cpu_profile():
            ts, _ = algo.learn(ts, rollout)
        rec = profiling.sessions()[-1]
        t = profiling.totals(rec)
        assert rec[0].name == "learner.update" and t["learner.update"]["count"] == 1
        assert t["learner.gae"]["count"] == 1
        assert t["learner.minibatch"]["count"] == algo.num_epochs * algo.num_minibatches
        assert t.get("learner.dagger", {"count": 0})["count"] == (mode == "rl+dagger")
        assert all(r.parent == 0 for r in rec[1:])


def test_general_env_step_records_the_future_targets_in_its_observations(mimic):
    env, algo, ts = mimic
    with torch.no_grad():
        actions = ts.net.act(ts.obs)[0]
        with cpu_profile():
            env.step(ts.env_state, actions)
    rec = profiling.sessions()[-1]
    fut = [i for i, r in enumerate(rec) if r.name == "env.future_targets"]
    assert len(fut) == 1 and rec[rec[fut[0]].parent].name == "env.observations"
    step = next(i for i, r in enumerate(rec) if r.name == "env.step")
    assert [r.name for r in children(rec, step)] == STAGES


def test_mimic_spans_are_free_without_a_profiler(mimic):
    env, algo, ts = mimic
    before = [len(s) for s in profiling.sessions()]
    assert span("learner.dagger") is span("env.future_targets")
    algo.learn(ts, algo.rollout(ts))
    assert [len(s) for s in profiling.sessions()] == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA's sync debug mode counts syncs on a card only")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_syncs_are_counted_and_the_mode_restored(cuda_device):
    x = torch.ones(4096, device=cuda_device)
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    with span("between"):
        pass
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with span("copy"):
            assert torch.cuda.get_sync_debug_mode() == 1
            torch.tensor(1.0, device=cuda_device)
        with span("device"):
            y = x * 2 + 1
        torch.cuda.synchronize()
    assert torch.cuda.get_sync_debug_mode() == before
    rec = profiling.sessions()[-1]
    assert [(r.name, r.syncs) for r in rec] == [("copy", 1), ("device", 0)]
    # the spans are host ranges: no copy of them among the device's events
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert dev and not [e for e in dev if e.name in ("copy", "device")]
    assert float(y[0]) == 3.0
