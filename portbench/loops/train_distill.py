"""The `train_distill` loop: whole distillation iterations of KungfuBot2's
student back to back (closed loop), as the `train` loop runs MHPPO's
(`loops/train.py`, whose window, profiled slices and span names this loop
shares): the rollout, then the update (`algo.rollout`, `algo.learn`).

In a distillation iteration (PPOMimic's `dagger_only` path) the student acts
with its deterministic mean through its history latent, the critic is
evaluated, and the frozen teacher acts through its own history latent on
the two groups the env computes for it (the span `teacher`, inside
`policy`); then one behaviour-cloning pass of `num_mini_batches` consecutive
minibatches (`update_distill`) fits the student's mean to the teacher's
action, with the history encoder's gradients zeroed.

Set-up builds the env, the student and its teacher from the run's config
with the configuration file's motion library and teacher checkpoint
(`pbhc_tpu_torch.train.build`), restores the student's checkpoint (params,
lr and iteration, fresh Adam moments), checks every width and count of the
configuration file against the program, the teacher's included, and runs
the warm-up: one iteration that moves Adam off its first step (a control
step of it held to the file's rows), then the recorded one, then the rest
of `warmup_iterations`. The recorded iteration keeps for the check its
rollout's samples, the teacher's actions with the groups they came from,
the first `check_updates` calls of `update_distill` and the optimizer's
state around them. The window records one control step for the env step's
check, drawn from the seed as the `train` loop draws it, and at its end the
student's history encoder is compared with the teacher's.
"""
from __future__ import annotations

import importlib.util
import statistics
from pathlib import Path

import torch

from portbench import faults, judge
from portbench.window import HostCopies, check_rows, check_sizes, host, load_config, patched, sync, to

_spec = importlib.util.spec_from_file_location("portbench_loops_train_ppomimic_base",
                                               Path(__file__).with_name("train_ppomimic.py"))
mimic = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mimic)
base = mimic.base

# the behaviour-cloning minibatch: the call the learner's check records
UPDATE = "update_distill"
# the student's groups a minibatch reads, and the teacher's own groups the env computes
OBS_GROUPS = ("actor_obs", "priv_obs", "future_motion_targets", "prop_history")
TEACHER_GROUPS = ("teacher_actor_obs", "teacher_future_motion_targets")


class Loop(base.Loop):
    def __init__(self, root, config: dict, traffic: dict, seed: int, device: str, overrides=()):
        from pbhc_tpu_torch.train import build
        from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload, restore_train_state

        root = Path(root)
        self.config, self.traffic, self.seed = config, traffic, seed
        cfg = load_config(root, config, seed, device, [
            f"robot.motion.motion_file={root / config['motion_file']}",
            f"algo.config.teacher_model_path={root / config['teacher_checkpoint']}", *overrides])
        self.env, self.algo, ts = build(cfg)
        self.ts = restore_train_state(ts, load_checkpoint_payload(root / config["checkpoint"]))
        self.device = self.env.device
        self.opts = [self.ts.opt, self.ts.hist_opt]
        self.teacher_net = self.algo.teacher.net
        if self.env.physics != config["solver"]:
            raise ValueError(f"the program runs the {self.env.physics} engine, the configuration file "
                             f"states {config['solver']}")
        if self.algo.mode(self.ts) != "distill":
            raise ValueError(f"the program runs {self.algo.mode(self.ts)} iterations, not distillation: "
                             f"{config['bc_passes_per_iteration']} behaviour-cloning pass an iteration")
        check_sizes(config, self.env, {
            "num_steps_per_env": self.algo.num_steps, "num_learning_epochs": self.algo.num_epochs,
            "num_mini_batches": self.algo.num_minibatches})
        mimic.check_widths(config, self.env, self.ts.net)
        t = config["teacher"]
        mimic.check_widths(t, self.env, self.teacher_net)
        got = self.env.obs_dim(t["actor"]["group"])
        if got != t["actor"]["in"]:
            raise ValueError(f"the program runs teacher.actor.in={got}, the configuration file states "
                             f"{t['actor']['in']}")
        self.env_steps_per_unit = self.algo.num_steps * self.env.num_envs
        self.logs = []
        self.steps = mimic.Recorder(self.env, HostCopies(self.device))

    def warmup(self, rng, spans):
        """One iteration with a control step held to the file's rows, the
        recorded iteration, then the rest of `warmup_iterations`."""
        self.steps.arm(rng.randrange(self.algo.num_steps))
        self.iteration(spans)
        self.steps.disarm()
        if self.steps.record is not None:
            sync(self.device)
            check_rows(self.config, self.steps.record)
        self.steps.record = None
        self.capture = self._recorded_iteration(spans)
        for _ in range(int(self.traffic["warmup_iterations"]) - 2):
            self.iteration(spans)
        self.logs.clear()

    def _recorded_iteration(self, spans) -> dict:
        algo, ts, opt = self.algo, self.ts, self.ts.opt
        n_upd = int(self.traffic["check_updates"])
        cap = {"teacher": [], "updates": [], "lr": float(ts.lr), "count": opt.count,
               "start": [host(p) for p in opt.params], "mu": [host(m) for m in opt.mu],
               "nu": [host(v) for v in opt.nu]}
        inner_teacher, inner_update = algo.teacher, getattr(algo, UPDATE)

        def teacher(obs):
            out = inner_teacher(obs)
            cap["teacher"].append({"actions": host(out), **{g: host(obs[g]) for g in TEACHER_GROUPS}})
            return out

        def update(ts_, batch, rows=None):
            out = inner_update(ts_, batch, rows)
            if len(cap["updates"]) == n_upd:
                return out
            cap["updates"].append({"bc": host(out)})
            if len(cap["updates"]) == 1:
                cap["moment1"] = [host(m) for m in opt.mu]
            if len(cap["updates"]) == n_upd:
                cap["params"] = [host(p) for p in opt.params]
            return out

        with patched(algo, "teacher", teacher):
            with spans("rollout"):
                rollout = algo.rollout(ts)
        _, obs, traj, _ = rollout[:4]
        cap["rollout"] = {k: host(traj[k]) for k in (*OBS_GROUPS, "actions", "values", "teacher_actions", "dones")}
        cap["rollout"]["last_actor_obs"] = host(obs["actor_obs"])
        with patched(algo, UPDATE, update):
            with spans("learn"):
                self.ts, log = algo.learn(ts, rollout)
        self.logs.append(torch.stack([v.detach().float() for v in log.values()]).isfinite().all())
        if len(cap["updates"]) < n_upd:
            raise ValueError(f"the distillation pass ran {len(cap['updates'])} minibatches, the check "
                             f"follows {n_upd}")
        return cap

    def finish(self):
        super().finish()
        student = self.ts.net.actor.history_encoder.parameters()
        teacher = self.teacher_net.actor.history_encoder.parameters()
        self.capture["history_frozen"] = max(float((a.detach() - b.detach()).abs().max())
                                             for a, b in zip(student, teacher))

    def release(self):
        super().release()
        del self.teacher_net


def numbers(refs, cap: dict, device) -> tuple:
    """(program's numbers, control's numbers) of a distillation run:

    - `forward_gap`: the recorded iteration's student means and values
      against the reference's on its samples, from the leaves it started
      with;
    - `teacher_gap`: the teacher's recorded actions against the reference
      teacher's on the groups it was handed, max |a - b| over max |b|;
    - `loss_gap`, `grad_gap`, `change_gap`: the first `check_updates`
      behaviour-cloning minibatches, as the `train` loop defines them, from
      the recorded leaves and Adam state;
    - `history_frozen`: the largest |student history encoder - teacher
      history encoder| at the window's end (0: it never moved);
    - `env_action_gap` and the env step's numbers, as the `train` loop's.
    """
    ref, ref_lo = refs["learner"], refs.get("learner_lo")
    ro = to(cap["rollout"], device)
    T, N = ro["actions"].shape[:2]
    flat = {k: v.reshape(T * N, *v.shape[2:]) for k, v in ro.items() if k != "last_actor_obs"}
    start = ref.from_program(to(cap["start"], device))
    opt = {"count": cap["count"], "mu": ref.from_program(to(cap["mu"], device)),
           "nu": ref.from_program(to(cap["nu"], device))}
    lr = torch.tensor(cap["lr"], dtype=torch.float32, device=device)
    steps = len(cap["updates"])
    obs = {g: flat[g] for g in OBS_GROUPS}
    teacher = {k: torch.cat([s[k] for s in cap["teacher"]]).to(device) for k in ("actions", *TEACHER_GROUPS)}
    tobs = {g: teacher[g] for g in TEACHER_GROUPS}
    tobs["prop_history"] = flat["prop_history"]
    t_actions = teacher["actions"]

    def follow(r):
        with torch.no_grad():
            fwd = {"mean": r.act_mean(obs, start), "values": r.values(obs, start), "teacher": r.teacher_actions(tobs)}
        return fwd, r.follow_bc(flat, steps, start, opt, lr)

    want_fwd, out = follow(ref)
    # the leaves the loss reaches: the student's motion encoder, LayerNorm and
    # backbone (the history encoder's gradient is zeroed, and the sigma, the
    # privileged encoder and the critic get none); the rest are held by
    # `history_frozen` or never move
    moving = [i for i, g in enumerate(out["first_grads"]) if float(g.norm()) > 0]
    pick = lambda leaves: [leaves[i] for i in moving]
    grads_ref = pick(out["first_grads"])
    med = statistics.median(float(g.norm()) for g in grads_ref)
    keep = [i for i, g in enumerate(grads_ref) if float(g.norm()) >= 1e-3 * med]
    ref_change = pick([p - s for p, s in zip(out["params"], out["start"])])

    def gaps(fwd, losses, first_grads, change):
        return {
            "forward_gap": max(judge.rel_max(fwd["mean"], want_fwd["mean"]),
                               judge.rel_max(fwd["values"], want_fwd["values"])),
            "teacher_gap": judge.rel_max(fwd["teacher"], want_fwd["teacher"]),
            "loss_gap": max(abs(ref.total_loss(a) - ref.total_loss(b)) / ref.loss_scale(b)
                            for a, b in zip(losses, out["losses"])),
            "grad_gap": judge.leaf_gap(pick(first_grads), grads_ref),
            "change_gap": judge.leaf_gap(pick(change), ref_change, keep),
        }

    mu0 = to(cap["mu"], device)
    prog_grads = [(m - ref.ADAM_B1 * m0).to(device) / (1.0 - ref.ADAM_B1)
                  for m, m0 in zip(to(cap["moment1"], device), mu0)]
    prog_change = [(p - s).to(device) for p, s in zip(to(cap["params"], device), to(cap["start"], device))]
    judge.check_leaves(prog_grads, out["first_grads"])
    prog = gaps({"mean": flat["actions"], "values": flat["values"], "teacher": t_actions},
                cap["updates"], prog_grads, prog_change)
    ctrl = {}
    if ref_lo is not None:
        fwd_lo, lo = follow(ref_lo)
        ctrl = gaps(fwd_lo, lo["losses"], lo["first_grads"], [p - s for p, s in zip(lo["params"], lo["start"])])
    prog["history_frozen"] = cap["history_frozen"]
    # the env's observation of the actions it was given, at every step
    sl = ref.action_slice()
    nxt = torch.cat([ro["actor_obs"][1:], ro["last_actor_obs"][None]])
    ok = ~ro["dones"]
    prog["env_action_gap"] = float((nxt[..., sl][ok] - ref.observed_actions(ro["actions"])[ok]).abs().max()) \
        if bool(ok.any()) else 0.0
    judge.step_numbers(refs, cap["step"], device, prog, ctrl)
    return prog, ctrl


def history_grads_kept(loop):
    """The history encoder's gradients reach Adam: nothing holds the
    grafted encoder frozen."""
    loop.ts.hist_opt.params = []


def _teacher_inputs(obs):
    return {"actor_obs": obs["teacher_actor_obs"], "future_motion_targets": obs["teacher_future_motion_targets"],
            "priv_obs": obs["priv_obs"], "prop_history": obs["prop_history"]}


def teacher_privileged(loop):
    """The teacher acts through its privileged latent, not its history
    latent."""
    net = loop.teacher_net

    def teacher(obs):
        with torch.no_grad():
            return net.act(_teacher_inputs(obs), False)[0]

    loop.algo.teacher = teacher


def teacher_student_targets(loop):
    """The teacher is fed the student's future targets (zero-padded to its
    width) in place of its own."""
    inner = loop.algo.teacher

    def teacher(obs):
        fut, own = obs["future_motion_targets"], obs["teacher_future_motion_targets"]
        padded = torch.cat([fut, fut.new_zeros(fut.shape[0], own.shape[1] - fut.shape[1])], dim=-1)
        return inner({**obs, "teacher_future_motion_targets": padded})

    loop.algo.teacher = teacher


# the faults a distillation cell can have (one chip: no exchange between chips to leave out)
FAULTS = {
    "half_batch": faults.half_batch(UPDATE),
    "update_skipped": faults.optimizer_state_unchanged,
    "history_grads_kept": history_grads_kept,
    "teacher_privileged": teacher_privileged,
    "teacher_student_targets": teacher_student_targets,
    "observation_stale": faults.observation_stale,
    "altered_answer": faults.solve_altered,
}
