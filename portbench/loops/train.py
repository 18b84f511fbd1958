"""The `train` loop: whole training iterations of the program's learner back
to back (closed loop), the rollout under the stochastic actor, then the
update (`algo.rollout`, `algo.learn`: `algo.train_iteration`'s two halves).

Set-up builds the env and learner from the run's config
(`pbhc_tpu_torch.train.build`), restores the committed checkpoint and runs
`warmup_iterations`. The first of them, which goes through the window's own
calls, is recorded for the learner's check: its rollout, the first
`check_updates` minibatch updates and the optimizers' state around them.
The window records one control step for the env step's check, drawn from
the seed over its whole length: a reservoir of one over its iterations, a
step drawn uniformly within the iteration.
"""
from __future__ import annotations

import statistics

import torch

from portbench import faults, judge
from portbench.window import HostCopies, StepRecorder, check_rows, check_sizes, host, load_config, patched, sync, to

# MHPPO's update of one minibatch: the call the learner's check records
UPDATE = "_minibatch_update"


class Loop:
    def __init__(self, root, config: dict, traffic: dict, seed: int, device: str, overrides=()):
        from pbhc_tpu_torch.train import build
        from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload, restore_train_state

        self.config, self.traffic, self.seed = config, traffic, seed
        cfg = load_config(root, config, seed, device, overrides)
        self.env, self.algo, ts = build(cfg)
        self.ts = restore_train_state(ts, load_checkpoint_payload(root / config["checkpoint"]))
        self.device = self.env.device
        self.opts = [self.ts.actor_opt, self.ts.critic_opt]
        hidden = cfg.algo.config.module_dict
        check_sizes(config, self.env, {
            "num_steps_per_env": self.algo.num_steps, "num_learning_epochs": self.algo.num_epochs,
            "num_mini_batches": self.algo.num_minibatches})
        for key in ("actor", "critic"):
            if list(hidden[key].layer_config.hidden_dims) != config[key]["hidden"]:
                raise ValueError(f"the program's {key} is not the configuration file's")
        self.env_steps_per_unit = self.algo.num_steps * self.env.num_envs
        self.logs = []
        self.steps = StepRecorder(self.env, HostCopies(self.device))

    def unit(self, i, rng, spans):
        """Iteration `i` of the window; it holds the recorded step with
        probability 1 / (i + 1)."""
        if rng.randrange(i + 1) == 0:
            self.steps.arm(rng.randrange(self.algo.num_steps))
        self.iteration(spans)

    def finish(self):
        sync(self.device)
        self.capture["step"] = self.steps.record

    def iteration(self, spans):
        with spans("rollout"):
            rollout = self.algo.rollout(self.ts)
        with spans("learn"):
            self.ts, log = self.algo.learn(self.ts, rollout)
        self.logs.append(torch.stack([v.detach().float() for v in log.values()]).isfinite().all())

    def warmup(self, rng, spans):
        """`warmup_iterations` iterations: the first recorded for the
        learner's check, a step of the second for the env step's (its host
        buffers are the window's)."""
        algo, env, ts = self.algo, self.env, self.ts
        n_upd = int(self.traffic["check_updates"])
        cap = {"start": [host(p) for o in self.opts for p in o.params], "updates": []}
        steps = []
        inner_step = env.step

        def step(state, actions):
            out = inner_step(state, actions)
            steps.append((host(out[2]), host(out[4]["time_outs"])))
            return out

        inner_update = getattr(algo, UPDATE)

        def update(ts_, batch, rows=None):
            out = inner_update(ts_, batch, rows)
            if len(cap["updates"]) == n_upd:
                return out
            cap["updates"].append({k: host(v) for k, v in out.items()})
            if len(cap["updates"]) == 1:
                cap["moment1"] = [host(m) for o in self.opts for m in o.mu]
            if len(cap["updates"]) == n_upd:
                cap["params"] = [host(p) for o in self.opts for p in o.params]
            return out

        with patched(env, "step", step), patched(algo, UPDATE, update):
            with spans("rollout"):
                rollout = algo.rollout(ts)
            cap["perm_state"] = algo.perm_gen.get_state()
            _, obs, traj, _ = rollout[:4]
            cap["rollout"] = {k: host(v) for k, v in traj.items()}
            cap["rollout"]["last_obs"] = {k: host(v) for k, v in obs.items()}
            with spans("learn"):
                self.ts, log = algo.learn(ts, rollout)
        cap["rollout"]["rew_raw"] = torch.stack([r for r, _ in steps])
        cap["rollout"]["time_outs"] = torch.stack([t for _, t in steps])
        self.logs.append(torch.stack([v.detach().float() for v in log.values()]).isfinite().all())
        self.steps.arm(rng.randrange(algo.num_steps))
        for _ in range(int(self.traffic["warmup_iterations"]) - 1):
            self.iteration(spans)
        self.steps.disarm()
        if self.steps.record is not None:
            sync(self.device)
            check_rows(self.config, self.steps.record)
        # the first epoch's order of the recorded update, drawn again from
        # the learner's permutation generator as it stood
        g = torch.Generator(device=self.device)
        g.set_state(cap.pop("perm_state"))
        cap["perm0"] = host(torch.randperm(algo.num_steps * env.num_envs, generator=g, device=self.device))
        self.capture = cap
        self.steps.record = None
        self.logs.clear()

    def failed(self) -> int:
        return sum(int(not bool(ok)) for ok in self.logs)

    def profile_units(self, traffic, profiler):
        """One more iteration: `profile_steps` control steps of its rollout
        in one profiled slice, its update in another."""
        env, k = self.env, int(traffic["profile_steps"])
        first = max(0, (self.algo.num_steps - k) // 2)
        inner_step, calls = env.step, [0]

        def step(state, actions):
            if calls[0] == first:
                profiler.start("rollout")
            elif calls[0] == first + k:
                profiler.stop()
            calls[0] += 1
            return inner_step(state, actions)

        with patched(env, "step", step):
            rollout = self.algo.rollout(self.ts)
        profiler.stop()
        profiler.start("learn")
        self.ts, _ = self.algo.learn(self.ts, rollout)
        profiler.stop()
        return {"rollout": k, "learn": 1}

    def release(self):
        self.steps.disarm()
        del self.env, self.algo, self.ts, self.opts, self.steps


def numbers(refs, cap: dict, device) -> tuple:
    """(program's numbers, control's numbers) of a training run: the
    learner's on the recorded warm-up iteration, the env step's on the step
    recorded in the window. `refs` holds the references in float32 and, for
    the control, in its precision."""
    ref, ref_lo = refs["learner"], refs.get("learner_lo")
    ro = to({k: v for k, v in cap["rollout"].items()}, device)
    perm0 = cap["perm0"].to(device)
    steps = len(cap["updates"])
    out = ref.follow(ro, perm0, steps)
    T, N = ro["actions"].shape[:2]
    grads_ref = out["first_grads"]
    med = statistics.median(float(g.norm()) for g in grads_ref)
    keep = [i for i, g in enumerate(grads_ref) if float(g.norm()) >= 1e-3 * med]
    ref_change = [p - s for p, s in zip(out["params"], out["start"])]

    def learner(forward, losses, first_grads, change):
        return {
            "forward_gap": max(judge.rel_max(forward["mean"], out["forward"]["mean"]),
                               judge.rel_max(forward["values"], out["forward"]["values"])),
            "loss_gap": max(abs(ref.total_loss(a) - ref.total_loss(b)) / ref.loss_scale(b)
                            for a, b in zip(losses, out["losses"])),
            "grad_gap": judge.leaf_gap(first_grads, grads_ref),
            "change_gap": judge.leaf_gap(change, ref_change, keep),
        }

    prog_grads = [m.to(device) / (1.0 - ref.ADAM_B1) for m in cap["moment1"]]
    prog_change = [(p - s).to(device) for p, s in zip(cap["params"], cap["start"])]
    judge.check_leaves(prog_grads, grads_ref)
    prog = learner({"mean": ro["mean"].reshape(T * N, -1), "values": ro["values"].reshape(T * N, -1)},
                   cap["updates"], prog_grads, prog_change)
    ctrl = {}
    if ref_lo is not None:
        lo = ref_lo.follow(ro, perm0, steps)
        ctrl = learner(lo["forward"], lo["losses"], lo["first_grads"],
                       [p - s for p, s in zip(lo["params"], lo["start"])])
    # the env's observation of the actions it was given, at every step
    sl = ref.action_slice()
    nxt = torch.cat([ro["actor_obs"][1:], ro["last_obs"]["actor_obs"][None]])
    ok = ~ro["dones"]
    prog["env_action_gap"] = float((nxt[..., sl][ok] - ref.observed_actions(ro["actions"])[ok]).abs().max()) \
        if bool(ok.any()) else 0.0
    judge.step_numbers(refs, cap["step"], device, prog, ctrl)
    return prog, ctrl


# the faults a training cell can have (one chip: no exchange between chips to leave out)
FAULTS = {
    "state_unchanged": faults.optimizer_state_unchanged,
    "env_state_unchanged": faults.env_state_unchanged,
    "half_batch": faults.half_batch(UPDATE),
    "altered_answer": faults.solve_altered,
    "position_pass_dropped": faults.position_pass_dropped,
    "reward_altered": faults.reward_altered,
    "observation_stale": faults.observation_stale,
}
