"""The benchmark's plain references of KungfuBot2's 29-DoF teacher
(`portbench/reference/ppomimic.py`, `portbench/reference/general.py`) against
the program on the CPU, at the configuration's widths with seeded random
weights and a few envs and samples; the counts of `portbench/counts/ppomimic.py`
against the program's modules; and the committed motion library against a
fresh build of it.

The references are plain torch written apart from the program (a
convolution as windows times a matrix, flax's layouts), so every comparison
allows float32 rounding of another order of operations, and no more.
"""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pbhc_tpu_torch.agents.networks import gaussian_log_prob

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench" / "configs" / "kb2-teacher-g1-29dof.json").read_text())
# three clips of the committed library: the 29-DoF clip, an up-converted clip with a contact mask and
# one without
CLIPS = (0, 1, 9)
ENVS, STEPS = 16, 2
# float32 rounding of another order of operations (the benchmark's own limits are 1e-4 and up)
RTOL = 2e-5


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    from pbhc_tpu_torch.motion.motion_lib import load_joblib
    from pbhc_tpu_torch.motion.package import dump

    lib = load_joblib(ROOT / CONFIG["motion_file"])
    keys = list(lib)
    path = tmp_path_factory.mktemp("kb2") / "three.pkl"
    dump({keys[i]: lib[keys[i]] for i in CLIPS}, path)
    return path


@pytest.fixture(scope="module")
def built(library):
    from pbhc_tpu_torch.config.loader import Cfg, apply_overrides, snapshot_for_checkpoint
    from pbhc_tpu_torch.train import build

    cfg = snapshot_for_checkpoint(ROOT / CONFIG["checkpoint"])
    cfg["num_envs"], cfg["seed"], cfg["device"] = ENVS, 5, "cpu"
    return build(Cfg.wrap(apply_overrides(cfg, [f"robot.motion.motion_file={library}",
                                                f"algo.config.num_steps_per_env={STEPS}"])))


@pytest.fixture(scope="module")
def learner():
    from portbench.reference import ppomimic

    return ppomimic.Reference(CONFIG, ROOT, "cpu")


def _obs(env, rows, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(rows, env.obs_dim(k), generator=g)
            for k in ("actor_obs", "priv_obs", "future_motion_targets", "prop_history")}


def _close(a, b, what):
    a, b = a.double(), b.double()
    gap = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    assert gap < RTOL, (what, gap)


def test_the_program_runs_the_configurations_widths(built):
    from portbench.loops.train_ppomimic import check_widths

    env, algo, ts = built
    check_widths(CONFIG, env, ts.net)
    assert env.num_actions == CONFIG["actor"]["out"] and env.physics == "lanes"


@pytest.mark.parametrize("hist", [False, True], ids=["privileged", "history"])
def test_act_and_evaluate_match_the_reference(built, learner, hist):
    env, algo, ts = built
    leaves = learner.from_program([p.detach() for p in ts.opt.params])
    assert [tuple(a.shape) for a in leaves] == [tuple(b.shape) for b in learner.start]
    obs = _obs(env, 64, 1)
    with torch.no_grad():
        mean, std = ts.net.act(obs, hist)
        values = ts.net.evaluate(obs)
    want_mean, want_std = learner.policy(obs, leaves, rollout=hist)
    _close(mean, want_mean, "mean")
    torch.testing.assert_close(std, want_std, rtol=0, atol=0)
    _close(values, learner.values(obs, leaves), "values")


def test_the_reference_restarts_at_a_later_iteration(built, learner):
    """`restarted` takes the program's parameters (torch's layouts), lr and
    iteration, as the benchmark's check does for the `rl` iteration after the
    checkpoint's `rl+dagger` one, and leaves the reference it came from as it
    was."""
    env, algo, ts = built
    program = [p.detach() for p in ts.opt.params]
    later = learner.restarted(program, 4.5e-5, learner.iteration + 1)
    assert [torch.equal(a, b) for a, b in zip(later.start, learner.from_program(program))] == [True] * len(program)
    assert (later.lr0, later.iteration, later.rollout_history) == (4.5e-5, learner.iteration + 1, False)
    assert later.priv_reg_coef == algo.priv_reg_coef(learner.iteration + 1)
    assert learner.rollout_history and learner.iteration % algo.dagger_update_freq == 0
    assert learner.priv_reg_coef == algo.priv_reg_coef(learner.iteration)
    assert not any(a is b for a, b in zip(later.start, learner.start))


def test_one_rl_minibatch_matches_the_reference(built, learner):
    """Loss terms, the clipped gradient and the Adam step of one `update_rl`
    minibatch, with `priv_reg` on (the checkpoint's iteration 3000)."""
    env, algo, ts0 = built
    ts = algo.new_train_state(copy.deepcopy(ts0.net))
    ts.iteration, ts.lr = learner.iteration, torch.tensor(learner.lr0)
    assert learner.priv_reg_coef > 0
    start = learner.from_program([p.detach().clone() for p in ts.opt.params])
    g = torch.Generator().manual_seed(2)
    obs = _obs(env, 64, 3)
    with torch.no_grad():
        mean, std = ts.net.act(obs)
        values = ts.net.evaluate(obs)
    actions = mean + std * torch.randn(mean.shape, generator=g)
    rows = {"actions": actions, "mean": mean + 0.05 * torch.randn(mean.shape, generator=g), "std": std * 1.1,
            "logp": gaussian_log_prob(mean, std, actions) + 0.1 * torch.randn(64, generator=g),
            "values": values, "returns": values + torch.randn(values.shape, generator=g),
            "adv": torch.randn(64, generator=g)}
    batch = {**obs, **{k: v for k, v in rows.items() if k != "adv"}, "advantages": rows["adv"]}
    got = algo.update_rl(ts, batch)

    params = [p.clone().requires_grad_(True) for p in start]
    terms, named = learner.minibatch(params, obs, rows)
    for k in ("surrogate", "entropy", "value_loss", "kl", "priv_reg"):
        _close(got[k].reshape(1), terms[k].detach().reshape(1), k)
    lr = torch.tensor(learner.lr0)
    kl = terms["kl"]
    lr = torch.where(kl > learner.desired_kl * 2.0, torch.clamp(lr / 1.5, min=1e-5),
                     torch.where((kl < learner.desired_kl / 2.0) & (kl > 0.0), torch.clamp(lr * 1.5, max=1e-2), lr))
    grads = torch.autograd.grad(named["loss"], params, allow_unused=True)
    grads = [torch.zeros_like(p) if x is None else x for x, p in zip(grads, params)]
    state = {"count": 0, "mu": [torch.zeros_like(p) for p in params], "nu": [torch.zeros_like(p) for p in params]}
    clipped = learner.adam(params, grads, state, lr)
    prog_grads = learner.from_program([m / (1.0 - learner.ADAM_B1) for m in ts.opt.mu])
    norms = [float(x.norm()) for x in clipped]
    med = float(np.median(norms))
    for i, (a, b) in enumerate(zip(prog_grads, clipped)):
        assert float((a - b).norm()) <= RTOL * max(float(b.norm()), med), ("grad", i)
    # Adam's first step is lr g / (|g| + eps): an entry whose gradient is near eps moves by a share of
    # lr that the gradient's last bits decide, so the steps agree to 1% of their size, not to rounding
    after = learner.from_program([p.detach() for p in ts.opt.params])
    for i, (a, b, s) in enumerate(zip(after, params, start)):
        step = float((b.detach() - s).norm())
        assert float((a - b.detach()).norm()) <= 1e-2 * step + 1e-9, ("param", i)
    torch.testing.assert_close(ts.lr, lr, rtol=0, atol=0)


def test_one_dagger_pass_matches_the_reference(built, learner):
    """The DAgger pass: its minibatches' mean loss and the history
    encoder after it; nothing else moves."""
    env, algo, ts0 = built
    ts = algo.new_train_state(copy.deepcopy(ts0.net))
    before = [p.detach().clone() for p in ts.opt.params]
    obs = _obs(env, STEPS * ENVS, 4)
    flat = {k: obs[k] for k in ("priv_obs", "prop_history")}
    loss = algo._dagger_pass(ts, flat, STEPS)
    want = learner.dagger({k: v.reshape(STEPS, ENVS, -1) for k, v in flat.items()}, learner.from_program(before))
    _close(loss.reshape(1), torch.stack(want["losses"]).mean().reshape(1), "loss")
    got = learner.from_program([p.detach() for p in ts.hist_opt.params])
    for i, (a, b, s) in enumerate(zip(got, want["params"], want["start"])):
        # as for the RL step: Adam's steps agree to 1% of their size
        assert float((a - b).norm()) <= 1e-2 * float((b - s).norm()), ("history encoder", i)
    hist = {id(p) for p in ts.hist_opt.params}
    for p, b in zip(ts.opt.params, before):
        if id(p) not in hist:
            assert torch.equal(p.detach(), b)


def test_a_control_step_over_three_clips_matches_the_reference(built, library):
    """One 29-DoF control step with envs on different clips, recorded as the
    benchmark records it: the engine's substeps and closing state, the PD
    torques, the summed reward and every observation part, future targets
    included."""
    from portbench.loops.train_ppomimic import Recorder
    from portbench.reference import general

    env, algo, ts = built
    state, obs = ts.env_state, ts.obs
    assert len(set(state.motion_ids.tolist())) == len(CLIPS)
    rec = Recorder(env, lambda key, t: t.detach().clone())
    with torch.no_grad():
        actions, _ = ts.net.act(obs)
        state, obs, *_ = env.step(state, actions)
        rec.arm()
        env.step(state, ts.net.act(obs)[0])
    assert "step" not in vars(env) and rec.record is not None
    ref = general.Reference({**CONFIG, "motion_file": str(library)}, ROOT, "cpu")
    parts = ref.parts(rec.record)
    assert set(parts) == {"velocity", "position", "body", "force", "torque", "reward", "observation"}
    assert max(parts.values()) < 1e-5, parts
    assert int(rec.record["obs"]["future_motion_targets"].shape[-1]) == CONFIG["actor"]["motion_encoder"]["in"]


def test_the_counts_are_the_program_modules_macs(built):
    """`portbench/counts/ppomimic.py` against the multiply-accumulates of the
    program's Linear and Conv1d modules, counted by hooks on one sample."""
    from portbench.counts import ppomimic

    env, algo, ts = built
    net, count = ts.net, [0]

    def hook(m, inputs, out):
        if isinstance(m, torch.nn.Linear):
            count[0] += out[..., :1].numel() * m.in_features * m.out_features
        else:
            count[0] += out.shape[0] * out.shape[-1] * m.out_channels * m.in_channels * m.kernel_size[0]

    kinds = (torch.nn.Linear, torch.nn.Conv1d)
    handles = [m.register_forward_hook(hook) for m in net.modules() if isinstance(m, kinds)]

    def macs(fn):
        count[0] = 0
        with torch.no_grad():
            fn(_obs(env, 1, 0))
        return count[0]

    act_priv, act_hist = macs(lambda o: net.act(o, False)), macs(lambda o: net.act(o, True))
    value = macs(net.evaluate)
    priv, hist = macs(lambda o: net.priv_latent(o["priv_obs"])), macs(lambda o: net.hist_latent(o["prop_history"]))
    for h in handles:
        h.remove()
    c = CONFIG
    f, share = 1.0 / c["dagger_update_freq"], 1.0 / (c["dagger_update_freq"] * c["num_learning_epochs"])
    assert ppomimic.rollout_macs(c) == pytest.approx((1 - f) * act_priv + f * act_hist + value, rel=1e-12)
    assert ppomimic.update_macs(c) == pytest.approx(act_priv + value + priv + share * hist, rel=1e-12)
    assert ppomimic.update_nograd_macs(c) == pytest.approx(hist + share * priv, rel=1e-12)
    assert ppomimic.serve_macs(c) == act_hist
    assert (act_priv, value) == (1_111_664, 1_097_712)


def test_the_committed_library_is_a_fresh_build(tmp_path):
    import importlib.util

    from pbhc_tpu_torch.motion.motion_lib import load_joblib

    spec = importlib.util.spec_from_file_location("build_kb2_library", ROOT / "portbench/data/build_kb2_library.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = load_joblib(mod.build(tmp_path / "lib.pkl", tmp_path))
    committed = load_joblib(ROOT / CONFIG["motion_file"])
    assert list(fresh) == list(committed) and len(fresh) == 11
    for key, clip in committed.items():
        assert set(clip) == set(fresh[key]), key
        for name, value in clip.items():
            np.testing.assert_array_equal(np.asarray(fresh[key][name]), np.asarray(value), err_msg=f"{key} {name}")


def _hinges(robot: str) -> list:
    """(name, axis) of each hinge of an MJCF file, in its order, read here
    from the XML (MuJoCo's default axis is z)."""
    import re
    import xml.etree.ElementTree as ET

    text = re.sub(r"<!--.*?-->", "", (ROOT / "assets" / "robots" / "g1" / f"{robot}.xml").read_text(), flags=re.S)
    return [(j.get("name"), np.array(j.get("axis", "0 0 1").split(), dtype=np.float32))
            for j in ET.fromstring(text).find("worldbody").iter("joint") if j.get("type", "hinge") == "hinge"]


def _rotvec(q):
    """Rotation vectors of x-y-z-w quaternions, the angle in [0, pi]."""
    q = np.where(q[:, 3:] < 0, -q, q).astype(np.float64)
    s = np.linalg.norm(q[:, :3], axis=1, keepdims=True)
    angle = 2.0 * np.arctan2(s, q[:, 3:])
    return q[:, :3] * np.where(s > 1e-12, angle / np.maximum(s, 1e-12), 2.0 / q[:, 3:])


def test_the_library_up_converts_by_the_mjcfs_joint_names():
    """The committed library against its raw clips, with the 23 -> 29 mapping
    worked out here from the two MJCFs' joint names, apart from the
    program's converter: the 29-DoF clip as it is; each 23-DoF clip's dofs
    placed by joint name, zero at the wrists; its `pose_aa` the root's
    rotation vector, each 29-DoF hinge's MJCF axis times its angle and the
    extended bodies' zeros; the other arrays as they were (`smpl_joints`,
    of the 23-DoF bodies, dropped)."""
    from portbench.reference.motion import load_clips

    h23, h29 = _hinges("g1_23dof_lock_wrist"), _hinges("g1_29dof_rev_1_0")
    names29 = [n for n, _ in h29]
    at = [names29.index(n) for n, _ in h23]
    axes = np.stack([a for _, a in h29])
    motions = ROOT / "assets" / "motions"
    clip29 = next(p for p in motions.glob("*.pkl") if "29dof" in p.name)
    raws = [clip29, *sorted(p for p in motions.glob("*.pkl") if p != clip29)]
    lib = list(load_clips(ROOT / CONFIG["motion_file"]).values())
    assert len(lib) == len(raws) == 11 and len(at) == 23 and len(names29) == 29
    for path, got in zip(raws, lib):
        (raw,) = load_clips(path).values()
        if path == clip29:
            assert set(got) == set(raw)
            for k, v in raw.items():
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=f"{path.name} {k}")
            continue
        dof23 = np.asarray(raw["dof"], dtype=np.float32)
        want = np.zeros((len(dof23), 29), np.float32)
        want[:, at] = dof23
        np.testing.assert_array_equal(np.asarray(got["dof"]), want, err_msg=path.name)
        pose = np.asarray(got["pose_aa"])
        extend = np.asarray(raw["pose_aa"]).shape[1] - 1 - 23
        assert pose.shape == (len(dof23), 1 + 29 + extend, 3), path.name
        # scipy's float64 rotation vector rounded to float32 against this one
        np.testing.assert_allclose(pose[:, 0], _rotvec(np.asarray(raw["root_rot"])), rtol=0, atol=1e-6,
                                   err_msg=path.name)
        np.testing.assert_array_equal(pose[:, 1:30], axes[None] * want[:, :, None], err_msg=path.name)
        np.testing.assert_array_equal(pose[:, 30:], 0.0, err_msg=path.name)
        assert set(got) == set(raw) - {"smpl_joints"}, path.name
        for k in set(got) - {"dof", "pose_aa"}:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(raw[k]), err_msg=f"{path.name} {k}")
