"""The benchmark's plain references of KungfuBot2's 29-DoF student
distillation (`portbench/reference/ppomimic_distill.py`,
`portbench/reference/general_distill.py`) against the program on the CPU: the
student at the configuration's widths with seeded random weights, its frozen
teacher from the committed checkpoint, a few envs and samples; the counts of
`portbench/counts/ppomimic_distill.py` against hand counts and the program's
modules; the `teacher` span of a distillation rollout.

The references are plain torch written apart from the program (a
convolution as windows times a matrix, flax's layouts), so every comparison
allows float32 rounding of another order of operations, and no more.
"""
import copy
import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench" / "configs" / "kb2-student-g1-29dof.json").read_text())
# three clips of the committed library: the 29-DoF clip, an up-converted clip with a contact mask and
# one without
CLIPS = (0, 1, 9)
ENVS, STEPS = 16, 2
# float32 rounding of another order of operations (the benchmark's own limits are 2e-6 and up)
RTOL = 2e-5
STUDENT_GROUPS = ("actor_obs", "priv_obs", "future_motion_targets", "prop_history")
TEACHER_GROUPS = ("teacher_actor_obs", "teacher_future_motion_targets")


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    from pbhc_tpu_torch.motion.motion_lib import load_joblib
    from pbhc_tpu_torch.motion.package import dump

    lib = load_joblib(ROOT / CONFIG["motion_file"])
    keys = list(lib)
    path = tmp_path_factory.mktemp("kb2s") / "three.pkl"
    dump({keys[i]: lib[keys[i]] for i in CLIPS}, path)
    return path


@pytest.fixture(scope="module")
def built(library):
    """The student's run at 16 envs with fresh weights (the snapshot's
    composition, the committed teacher) as the benchmark's loop builds it."""
    from pbhc_tpu_torch.config.loader import Cfg, apply_overrides, snapshot_for_checkpoint
    from pbhc_tpu_torch.train import build

    cfg = snapshot_for_checkpoint(ROOT / CONFIG["checkpoint"])
    cfg["num_envs"], cfg["seed"], cfg["device"] = ENVS, 5, "cpu"
    return build(Cfg.wrap(apply_overrides(cfg, [f"robot.motion.motion_file={library}",
                                                f"algo.config.teacher_model_path={ROOT / CONFIG['teacher_checkpoint']}",
                                                f"algo.config.num_steps_per_env={STEPS}"])))


@pytest.fixture(scope="module")
def learner():
    from portbench.reference import ppomimic_distill

    return ppomimic_distill.Reference(CONFIG, ROOT, "cpu")


def _obs(env, rows, seed, groups=STUDENT_GROUPS + TEACHER_GROUPS):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(rows, env.obs_dim(k), generator=g) for k in groups}


def _close(a, b, what):
    a, b = a.double(), b.double()
    gap = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    assert gap < RTOL, (what, gap)


def test_the_program_runs_the_configurations_widths(built):
    from portbench.loops.train_ppomimic import check_widths

    env, algo, ts = built
    check_widths(CONFIG, env, ts.net)
    check_widths(CONFIG["teacher"], env, algo.teacher.net)
    assert algo.mode(ts) == "distill" and env.physics == "lanes"
    assert {g: env.obs_dim(g) for g in (*STUDENT_GROUPS, *TEACHER_GROUPS)} == {
        "actor_obs": 1087, "priv_obs": 66, "future_motion_targets": 720, "prop_history": 920,
        "teacher_actor_obs": 272, "teacher_future_motion_targets": 1380}


def test_the_committed_students_history_encoder_is_its_teachers():
    """The committed student (iteration 1750) holds the history encoder of
    the committed teacher (iteration 3000) bit for bit: it was grafted and
    never moved."""
    def leaves(path):
        with open(ROOT / path, "rb") as f:
            h = pickle.load(f)["params"]["params"]["actor"]["history_encoder"]
        return {f"{m}/{k}": np.asarray(v) for m, d in h.items() for k, v in d.items()}

    student, teacher = leaves(CONFIG["checkpoint"]), leaves(CONFIG["teacher_checkpoint"])
    assert set(student) == set(teacher) and len(student) == 8
    for k in student:
        np.testing.assert_array_equal(student[k], teacher[k], err_msg=k)


def test_student_act_and_critic_match_the_reference(built, learner):
    env, algo, ts = built
    leaves = learner.from_program([p.detach() for p in ts.opt.params])
    assert [tuple(a.shape) for a in leaves] == [tuple(b.shape) for b in learner.start]
    obs = _obs(env, 64, 1, STUDENT_GROUPS)
    with torch.no_grad():
        mean = ts.net.act(obs, True)[0]
        values = ts.net.evaluate(obs)
    _close(mean, learner.act_mean(obs, leaves), "mean")
    _close(values, learner.values(obs, leaves), "values")


def test_teacher_action_on_its_groups_matches_the_reference(built, learner):
    """The frozen teacher, from the committed checkpoint in both, acting
    through its history latent on the teacher groups."""
    env, algo, ts = built
    obs = _obs(env, 64, 2)
    _close(algo.teacher(obs), learner.teacher_actions(obs), "teacher")


def test_batch_eval_act_mean_matches_the_reference(built, learner):
    """`batch_eval.act_mean` of a `MimicActorCritic` (the serving path)
    against the reference's `act_mean`, for the student and for the
    teacher."""
    from pbhc_tpu_torch.eval.batch_eval import act_mean

    from portbench.reference.ppomimic_distill import act_mean as ref_act_mean

    env, algo, ts = built
    obs = _obs(env, 64, 3)
    with torch.no_grad():
        got = act_mean(ts.net, obs)
        got_teacher = act_mean(algo.teacher.net, {"actor_obs": obs["teacher_actor_obs"],
                                                  "future_motion_targets": obs["teacher_future_motion_targets"],
                                                  "prop_history": obs["prop_history"], "priv_obs": obs["priv_obs"]})
    _close(got, ref_act_mean(learner, obs, learner.from_program([p.detach() for p in ts.opt.params])), "student")
    _close(got_teacher, ref_act_mean(learner.teacher, {"actor_obs": obs["teacher_actor_obs"],
                                                       "future_motion_targets": obs["teacher_future_motion_targets"],
                                                       "prop_history": obs["prop_history"]}), "teacher")


def test_one_bc_minibatch_matches_the_reference(built, learner):
    """Loss, clipped gradient and Adam step of one `update_distill`
    minibatch; the history encoder gets a zero gradient and its leaves stay
    as they were, bit for bit."""
    env, algo, ts0 = built
    ts = algo.new_train_state(copy.deepcopy(ts0.net))
    start = learner.from_program([p.detach().clone() for p in ts.opt.params])
    hist_before = [p.detach().clone() for p in ts.hist_opt.params]
    rows = 64
    samples = _obs(env, 4 * rows, 4, STUDENT_GROUPS)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        samples["teacher_actions"] = ts.net.act(samples, True)[0] + 0.3 * torch.randn(4 * rows, 29, generator=g)
    got = algo.update_distill(ts, {k: v[:rows] for k, v in samples.items()})

    opt = {"count": 0, "mu": [torch.zeros_like(p) for p in start], "nu": [torch.zeros_like(p) for p in start]}
    want = learner.follow_bc(samples, 1, start, opt, torch.tensor(float(ts.lr)))
    _close(got.reshape(1), want["losses"][0]["bc"].reshape(1), "loss")
    prog_grads = learner.from_program([m / (1.0 - learner.ADAM_B1) for m in ts.opt.mu])
    norms = [float(x.norm()) for x in want["first_grads"]]
    med = float(np.median([n for n in norms if n > 0]))
    for i, (a, b) in enumerate(zip(prog_grads, want["first_grads"])):
        assert float((a - b).norm()) <= RTOL * max(float(b.norm()), med), ("grad", i)
    for i in learner.history_leaves:
        assert float(prog_grads[i].abs().max()) == 0.0 and float(want["first_grads"][i].abs().max()) == 0.0
    for a, b in zip(ts.hist_opt.params, hist_before):
        assert torch.equal(a.detach(), b)
    # Adam's first step is lr g / (|g| + eps): an entry whose gradient is near eps moves by a share of
    # lr that the gradient's last bits decide, so the steps agree to 1% of their size, not to rounding
    after = learner.from_program([p.detach() for p in ts.opt.params])
    for i, (a, b, s) in enumerate(zip(after, want["params"], start)):
        step = float((b - s).norm())
        assert float((a - b).norm()) <= 1e-2 * step + 1e-9, ("param", i)


def test_a_control_step_with_the_teacher_groups_matches_the_reference(built, library):
    """One 29-DoF control step of the student env, recorded as the
    benchmark records it: the engine, the torques, the reward and every
    observation part, the two teacher groups included; a teacher group off
    by a little fails it."""
    from portbench.loops.train_ppomimic import Recorder
    from portbench.reference import general_distill

    env, algo, ts = built
    state, obs = ts.env_state, ts.obs
    rec = Recorder(env, lambda key, t: t.detach().clone())
    with torch.no_grad():
        state, obs, *_ = env.step(state, ts.net.act(obs, True)[0])
        rec.arm()
        env.step(state, ts.net.act(obs, True)[0])
    assert "step" not in vars(env) and rec.record is not None
    assert set(TEACHER_GROUPS) <= set(rec.record["obs"])
    ref = general_distill.Reference({**CONFIG, "motion_file": str(library)}, ROOT, "cpu")
    assert set(TEACHER_GROUPS) <= set(ref.snap_obs["obs_dict"])
    parts = ref.parts(rec.record)
    assert set(parts) == {"velocity", "position", "body", "force", "torque", "reward", "observation"}
    assert max(parts.values()) < 1e-5, parts
    # the last 660 columns of the teacher's future targets are its key bodies: the student's have none
    bad = copy.deepcopy(rec.record)
    bad["obs"]["teacher_future_motion_targets"][:, -1] += 1e-2
    assert ref.observation_gap(bad) > 1e-4


def test_the_counts_are_the_hand_counts_and_the_program_modules_macs(built):
    """`portbench/counts/ppomimic_distill.py` against the widths counted by
    hand and against the multiply-accumulates of the program's Linear and
    Conv1d modules, counted by hooks on one sample."""
    from portbench.counts import ppomimic_distill as counts
    from portbench.counts import work

    env, algo, ts = built
    count = [0]

    def hook(m, inputs, out):
        if isinstance(m, torch.nn.Linear):
            count[0] += out[..., :1].numel() * m.in_features * m.out_features
        else:
            count[0] += out.shape[0] * out.shape[-1] * m.out_channels * m.in_channels * m.kernel_size[0]

    kinds = (torch.nn.Linear, torch.nn.Conv1d)
    nets = (ts.net, algo.teacher.net)
    handles = [m.register_forward_hook(hook) for n in nets for m in n.modules() if isinstance(m, kinds)]

    def macs(fn):
        count[0] = 0
        with torch.no_grad():
            fn(_obs(env, 1, 0))
        return count[0]

    student, critic = macs(lambda o: ts.net.act(o, True)), macs(ts.net.evaluate)
    teacher = macs(algo.teacher)
    for h in handles:
        h.remove()
    c = CONFIG
    assert (student, critic, teacher) == (1_729_984, 1_684_032, 1_143_664)
    assert counts.rollout_macs(c) == student + critic + teacher == 4_557_680
    assert counts.update_macs(c) * c["num_learning_epochs"] == pytest.approx(student, rel=1e-12)
    assert counts.update_nograd_macs(c) == 0 and counts.serve_macs(c) == student
    samples = c["num_envs"] * c["num_steps_per_env"]
    solves = c["num_steps_per_env"] * work.solve_flops_per_control_step(c)
    assert work.train_iteration_flops(c) == pytest.approx(samples * 2 * (4_557_680 + 3 * 1_729_984) + solves,
                                                          rel=1e-12)


def test_a_distillation_rollout_records_the_teacher_inside_policy(built):
    from pbhc_tpu_torch.utils import profiling

    env, algo, ts0 = built
    ts = algo.new_train_state(copy.deepcopy(ts0.net), ts0.env_state, ts0.obs)
    # a span opened with no profiler running ends the session before, so the rollout makes its own
    with profiling.span("between"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        algo.rollout(ts)
    rec = profiling.sessions()[-1]
    t = profiling.totals(rec)
    assert t["teacher"]["count"] == t["policy"]["count"] == algo.num_steps
    assert all(rec[r.parent].name == "policy" for r in rec if r.name == "teacher")
