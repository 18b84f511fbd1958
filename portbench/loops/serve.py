"""The `serve` loop: control steps of the deterministic actor with no grad,
`env.step(state, batch_eval.act_mean(actor, obs))`, back to back (closed
loop), every env starting the clip at time 0 (`batch_eval.start_episodes`).

Two reservoirs drawn from the seed over the whole window keep what the check
reads: `check_steps` steps' observations, actions and next observations (the
networks and the env's observation of the action), and one step recorded
whole for the env step's check.
"""
from __future__ import annotations

import torch

from portbench import faults, judge
from portbench.window import HostCopies, Spans, StepRecorder, check_rows, check_sizes, sync, to


class Loop:
    def __init__(self, root, config: dict, traffic: dict, seed: int, device: str, overrides=()):
        from pbhc_tpu_torch.eval import batch_eval

        self.be, self.config, self.traffic, self.seed = batch_eval, config, traffic, seed
        self.env, self.actor, _ = batch_eval.load(root / config["checkpoint"], config["num_envs"],
                                                  list(overrides), device=device, seed=seed)
        self.device = self.env.device
        check_sizes(config, self.env, {})
        self.state, self.obs = batch_eval.start_episodes(self.env)
        self.env_steps_per_unit = self.env.num_envs
        self.bad = torch.zeros((), dtype=torch.int64, device=self.device)
        self.copies = HostCopies(self.device)
        self.steps = StepRecorder(self.env, self.copies)
        self.samples = []

    def step(self, spans):
        with torch.no_grad():
            with spans("act_mean"):
                actions = self.be.act_mean(self.actor, self.obs)
            with spans("env.step"):
                self.state, self.obs, _, done, info = self.env.step(self.state, actions)
        self.bad += info["nonfinite"].any().to(torch.int64)
        return actions, done

    def warmup(self, rng, spans):
        """`warmup_steps` steps, the last recorded into every buffer the
        window's recordings reuse."""
        for _ in range(int(self.traffic["warmup_steps"]) - 1):
            self.step(spans)
        self.steps.arm()
        self.record(0, spans)
        for slot in range(1, int(self.traffic["check_steps"])):
            for key, b in list(self.copies.buf.items()):
                if key.startswith("0."):
                    self.copies(f"{slot}.{key[2:]}", b)
        sync(self.device)
        check_rows(self.config, self.steps.record)
        self.samples, self.steps.record = [], None

    def record(self, slot, spans):
        """One step, its inputs and outputs copied into `slot`."""
        copy = lambda key, t: self.copies(f"{slot}.{key}", t)
        obs = {g: copy(f"obs.{g}", v) for g, v in self.obs.items()}
        actions, done = self.step(spans)
        rec = {"obs": obs, "actions": copy("actions", actions), "done": copy("done", done),
               "next_obs": {g: copy(f"next_obs.{g}", v) for g, v in self.obs.items()}}
        if slot < len(self.samples):
            self.samples[slot] = rec
        else:
            self.samples.append(rec)

    def unit(self, i, rng, spans):
        """Step `i` of the window, kept in a reservoir of `check_steps`
        steps, and recorded whole with probability 1 / (i + 1)."""
        k = int(self.traffic["check_steps"])
        slot = i if i < k else rng.randrange(i + 1)
        if rng.randrange(i + 1) == 0:
            self.steps.arm()
        if slot < k:
            self.record(slot, spans)
        else:
            self.step(spans)

    def finish(self):
        sync(self.device)
        self.capture = {"samples": self.samples, "step": self.steps.record}

    def failed(self) -> int:
        return int(self.bad)

    def profile_units(self, traffic, profiler):
        k = int(traffic["profile_steps"])
        off = Spans(False, self.device)
        profiler.start("serve")
        for _ in range(k):
            self.step(off)
        profiler.stop()
        return {"serve": k}

    def release(self):
        self.steps.disarm()
        del self.env, self.actor, self.state, self.obs, self.steps


def numbers(refs, cap: dict, device) -> tuple:
    """(program's numbers, control's numbers) of a serving run."""
    ref, ref_lo = refs["learner"], refs.get("learner_lo")
    prog, ctrl = {}, {}
    sl = ref.action_slice()
    fwd_p, fwd_c, env_gap = [], [], 0.0
    for s in cap["samples"]:
        s = to(s, device)
        want = ref.act_mean(s["obs"])
        fwd_p.append(judge.rel_max(s["actions"], want))
        if ref_lo is not None:
            fwd_c.append(judge.rel_max(ref_lo.act_mean(s["obs"]), want))
        ok = ~s["done"]
        if bool(ok.any()):
            seen = s["next_obs"]["actor_obs"][:, sl][ok]
            env_gap = max(env_gap, float((seen - ref.observed_actions(s["actions"])[ok]).abs().max()))
    prog["forward_gap"] = max(fwd_p)
    if fwd_c:
        ctrl["forward_gap"] = max(fwd_c)
    prog["env_action_gap"] = env_gap
    judge.step_numbers(refs, cap["step"], device, prog, ctrl)
    return prog, ctrl


FAULTS = {
    "state_unchanged": faults.env_state_unchanged,
    "half_batch": faults.actor_half_batch,
    "altered_answer": faults.action_altered,
    "position_pass_dropped": faults.position_pass_dropped,
    "reward_altered": faults.reward_altered,
    "observation_stale": faults.observation_stale,
}
