"""The `train_ppomimic` loop: whole PPOMimic iterations back to back (closed
loop), as the `train` loop runs MHPPO's (`loops/train.py`, whose window,
profiled slices and learner numbers this loop shares): the rollout under
the stochastic actor, then the update (`algo.rollout`, `algo.learn`).

Every `dagger_update_freq`-th iteration is `rl+dagger`: its rollout acts
through the history latent and a DAgger pass follows the RL epochs; the rest
are `rl`, with the `priv_reg` term at the coefficient its schedule gives.

Set-up builds the env and learner from the run's config with the
configuration file's motion library (`pbhc_tpu_torch.train.build`), restores
the committed checkpoint (params, lr and iteration, fresh Adam moments),
checks every width and count of the configuration file against the program,
and runs the checkpoint's iteration, which must be `rl+dagger`: its DAgger
pass is recorded for the learner's check, and a control step of it is held
to the file's rows. Then `warmup_iterations` more, as the `train` loop runs
them, the first an `rl` one from fresh Adam moments: its rollout, the first
`check_updates` calls of `update_rl` and the optimizer's state around them
are recorded for the learner's check. (An `rl+dagger` rollout acts through
the history latent, so its RL updates see ratios spread wide, and a sample
within rounding of the clip edge would take the other branch in the
reference.) The window records one control step for the env step's check,
drawn from the seed as the `train` loop draws it.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

from portbench import faults, judge
from portbench.window import (HostCopies, StepRecorder, check_rows, check_sizes, host, load_config, patched, sync,
                              to)

_spec = importlib.util.spec_from_file_location("portbench_loops_train_base", Path(__file__).with_name("train.py"))
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)

# PPOMimic's RL minibatch update and DAgger minibatch: the calls the learner's check records
# (the `train` loop's warm-up records the copy's `UPDATE`)
base.UPDATE = UPDATE = "update_rl"
DAGGER = "update_dagger"


class Recorder(StepRecorder):
    """`StepRecorder`, with the contact state the step was given (the
    privileged observation's contact mask) and the step's timeouts (which
    split the termination term off the summed reward)."""

    def _recorded(self, inner, state, actions):
        filt = self.copy("pre.contacts_filt", state.contacts_filt)
        out = super()._recorded(inner, state, actions)
        self.record["pre"]["contacts_filt"] = filt
        self.record["time_out"] = self.copy("time_out", out[4]["time_outs"])
        return out


def _linears(mlp):
    return [(m.in_features, m.out_features) for m in mlp.linear_layers()]


def check_widths(config: dict, env, net):
    """Raise unless the program's networks have the configuration file's
    widths: each encoder's input group, steps, layers and output, the
    privileged MLP, both LayerNorms and both backbones."""
    a, got, want = config["actor"], {}, {}

    def mlp(key, module, in_dim, hidden, out):
        got[key] = _linears(module)
        dims = [in_dim, *hidden, out]
        want[key] = list(zip(dims[:-1], dims[1:]))

    for name in ("motion_encoder", "history_encoder"):
        e, m = a[name], getattr(net.actor, name)
        got[f"{name}.in"], want[f"{name}.in"] = env.obs_dim(e["group"]), e["in"]
        got[f"{name}.steps"], want[f"{name}.steps"] = m.tsteps, e["steps"]
        convs = [getattr(m, f"Conv_{i}") for i in range(m.num_convs)]
        got[name] = (m.Dense_0.in_features * m.tsteps, m.Dense_0.out_features,
                     [c.out_channels for c in convs], [c.kernel_size[0] for c in convs],
                     [c.stride[0] for c in convs], m.Dense_1.out_features)
        want[name] = (e["in"], e["hidden"], e["channels"], e["kernels"], e["strides"], e["out"])
    p = a["priv_encoder"]
    got["priv_encoder.in"], want["priv_encoder.in"] = env.obs_dim(p["group"]), p["in"]
    mlp("priv_encoder", net.actor.priv_encoder, p["in"], p["hidden"], p["out"])
    mlp("actor.backbone", net.actor.backbone, a["layernorm"], a["hidden"], a["out"])
    c = config["critic"]
    mlp("critic.backbone", net.critic, c["in"], c["hidden"], c["out"])
    got["actor.layernorm"], want["actor.layernorm"] = net.actor.ln.weight.numel(), a["layernorm"]
    got["critic.layernorm"], want["critic.layernorm"] = net.critic_ln.weight.numel(), c["layernorm"]
    for k, v in got.items():
        if want[k] != v:
            raise ValueError(f"the program runs {k}={v}, the configuration file states {want[k]}")


class Loop(base.Loop):
    def __init__(self, root, config: dict, traffic: dict, seed: int, device: str, overrides=()):
        from pbhc_tpu_torch.train import build
        from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload, restore_train_state

        self.config, self.traffic, self.seed = config, traffic, seed
        library = f"robot.motion.motion_file={Path(root) / config['motion_file']}"
        cfg = load_config(root, config, seed, device, [library, *overrides])
        self.env, self.algo, ts = build(cfg)
        self.ts = restore_train_state(ts, load_checkpoint_payload(Path(root) / config["checkpoint"]))
        self.device = self.env.device
        self.opts = [self.ts.opt, self.ts.hist_opt]
        if self.env.physics != config["solver"]:
            raise ValueError(f"the program runs the {self.env.physics} engine, the configuration file "
                             f"states {config['solver']}")
        check_sizes(config, self.env, {
            "num_steps_per_env": self.algo.num_steps, "num_learning_epochs": self.algo.num_epochs,
            "num_mini_batches": self.algo.num_minibatches, "dagger_update_freq": self.algo.dagger_update_freq})
        check_widths(config, self.env, self.ts.net)
        self.env_steps_per_unit = self.algo.num_steps * self.env.num_envs
        self.logs = []
        self.steps = Recorder(self.env, HostCopies(self.device))

    def warmup(self, rng, spans):
        """The checkpoint's `rl+dagger` iteration, its DAgger pass recorded
        and a control step of it held to the file's rows; then the `train`
        loop's warm-up from the `rl` iteration that follows, with fresh Adam
        moments as at the checkpoint: its first `check_updates` calls of
        `update_rl` recorded for the learner's check."""
        algo, opt = self.algo, self.ts.opt
        if algo.mode(self.ts) != "rl+dagger":
            raise ValueError(f"the checkpoint's iteration {self.ts.iteration} starts an {algo.mode(self.ts)} "
                             "iteration: the DAgger pass is recorded on an rl+dagger one")
        dagger = self._dagger_iteration(rng, spans)
        if algo.mode(self.ts) != "rl":
            raise ValueError(f"iteration {self.ts.iteration} is {algo.mode(self.ts)}: the learner's check "
                             "records an rl one")
        for m in (*opt.mu, *opt.nu):
            m.zero_()
        opt.count = 0
        state = {"lr": float(self.ts.lr), "iteration": self.ts.iteration}
        super().warmup(rng, spans)
        # the learner's leaves are `opt`'s; `hist_opt` holds a subset of them
        n = len(opt.params)
        for key in ("start", "moment1", "params"):
            self.capture[key] = self.capture[key][:n]
        self.capture.update(state, dagger=dagger)

    def _dagger_iteration(self, rng, spans) -> dict:
        """One iteration with its DAgger pass recorded: the rollout's samples
        it reads, the parameters when it begins, each minibatch's loss and the
        history encoder's parameters at its end."""
        algo, d = self.algo, {"losses": []}
        inner_pass, inner_dagger = algo._dagger_pass, getattr(algo, DAGGER)

        def dagger_pass(ts_, flat, T):
            d["rollout"] = {k: host(flat[k]).reshape(T, -1, flat[k].shape[-1]) for k in ("priv_obs", "prop_history")}
            d["start"] = [host(p) for p in ts_.opt.params]
            out = inner_pass(ts_, flat, T)
            d["end"] = [host(p) for p in ts_.hist_opt.params]
            return out

        def dagger(ts_, priv_obs, prop_history, rows=None):
            loss = inner_dagger(ts_, priv_obs, prop_history, rows)
            d["losses"].append(host(loss))
            return loss

        self.steps.arm(rng.randrange(algo.num_steps))
        with patched(algo, "_dagger_pass", dagger_pass), patched(algo, DAGGER, dagger):
            self.iteration(spans)
        self.steps.disarm()
        if "end" not in d:
            raise ValueError("the rl+dagger iteration ran no DAgger pass")
        if self.steps.record is not None:
            sync(self.device)
            check_rows(self.config, self.steps.record)
        self.steps.record = None
        return d


def numbers(refs, cap: dict, device) -> tuple:
    """(program's numbers, control's numbers): the `train` loop's (the
    learner's on the recorded iteration's first RL updates, the env step's
    on the step recorded in the window), and the DAgger pass's:
    `dagger_loss_gap`, its minibatches' losses, |a - b| over |b|, worst
    minibatch; `dagger_change_gap`, the history encoder's change over the
    pass, measured as `change_gap`."""
    start = to(cap["start"], device)
    refs = {**refs, **{k: refs[k].restarted(start, cap["lr"], cap["iteration"])
                       for k in ("learner", "learner_lo") if k in refs}}
    prog, ctrl = base.numbers(refs, cap, device)
    d = to(cap["dagger"], device)
    ro, ref = d["rollout"], refs["learner"]
    start = ref.from_program(d["start"])
    want = ref.dagger(ro, start)
    ref_change = [p - s for p, s in zip(want["params"], want["start"])]
    prog_start = [d["start"][i] for i in ref.history_leaves]

    def gaps(losses, change):
        loss = max(abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(losses, want["losses"]))
        return {"dagger_loss_gap": loss, "dagger_change_gap": judge.leaf_gap(change, ref_change)}

    judge.check_leaves(d["end"], want["params"])
    prog.update(gaps(d["losses"], [p - s for p, s in zip(d["end"], prog_start)]))
    if "learner_lo" in refs:
        lo = refs["learner_lo"].dagger(ro, start)
        ctrl.update(gaps(lo["losses"], [p - s for p, s in zip(lo["params"], lo["start"])]))
    return prog, ctrl


def future_offset(loop):
    """The future targets are fetched one control step later than the
    offsets the observation states."""
    loop.env.tar_obs_steps = loop.env.tar_obs_steps + 1.0


# the faults a training cell of this learner can have (one chip: no exchange between chips to leave out)
FAULTS = {
    "state_unchanged": faults.optimizer_state_unchanged,
    "env_state_unchanged": faults.env_state_unchanged,
    "half_batch": faults.half_batch(UPDATE),
    "altered_answer": faults.solve_altered,
    "position_pass_dropped": faults.position_pass_dropped,
    "reward_altered": faults.reward_altered,
    "observation_stale": faults.observation_stale,
    "future_offset": future_offset,
}
