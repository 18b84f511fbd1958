"""The `serve_mimic` loop: the `serve` loop (`loops/serve.py`) for a mimic
policy (KungfuBot2's `MimicActorCritic`): control steps of its deterministic
mean through the history latent with no grad,
`env.step(state, batch_eval.act_mean(actor, obs))`, back to back (closed
loop), every env starting its clip at time 0.

What it adds to the `serve` loop: the configuration file's motion library
applied to the run's config; every width of the configuration file checked
against the program's network; the recorded step kept with the contact
state and timeouts that the general env's step reference reads
(`loops/train_ppomimic.py::Recorder`); the networks' check through the
history latent (`reference/ppomimic_distill.py::act_mean`); and faults that
act on the mimic network's `act`, which `batch_eval.act_mean` calls.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

from portbench.reference.ppomimic_distill import act_mean


def _load(name):
    path = Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_loops_{name}_base", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


serve = _load("serve")
mimic = _load("train_ppomimic")


class Loop(serve.Loop):
    def __init__(self, root, config: dict, traffic: dict, seed: int, device: str, overrides=()):
        library = f"robot.motion.motion_file={Path(root) / config['motion_file']}"
        super().__init__(Path(root), config, traffic, seed, device, [library, *overrides])
        if self.env.physics != config["solver"]:
            raise ValueError(f"the program runs the {self.env.physics} engine, the configuration file "
                             f"states {config['solver']}")
        mimic.check_widths(config, self.env, self.actor)
        self.steps = mimic.Recorder(self.env, self.copies)


class _ThroughHistory:
    """A `reference/ppomimic.py` reference whose `act_mean` acts through the
    history latent, as the served policy does."""

    def __init__(self, ref):
        self.ref = ref

    def act_mean(self, obs):
        return act_mean(self.ref, obs)

    def __getattr__(self, name):
        return getattr(self.ref, name)


def numbers(refs, cap: dict, device) -> tuple:
    """(program's numbers, control's numbers) of a serving run, as the
    `serve` loop's: `forward_gap` on the served means against the
    reference's through the history latent, `env_action_gap` and the env
    step's numbers."""
    refs = {**refs, **{k: _ThroughHistory(refs[k]) for k in ("learner", "learner_lo") if k in refs}}
    return serve.numbers(refs, cap, device)


def _acting(loop, change):
    """The network's `act` with `change` applied to the mean it returns."""
    inner = loop.actor.act

    def act(obs, hist_encoding=False):
        mean, std = inner(obs, hist_encoding)
        return change(mean), std

    loop.actor.act = act


def actor_half_batch(loop):
    """The actor acts for the first half of the envs; the rest get zeros."""
    def change(mean):
        half = mean.shape[0] // 2
        return torch.cat([mean[:half], torch.zeros_like(mean[half:])])

    _acting(loop, change)


def action_altered(loop):
    """One action of every step is off by 0.01 where the actor produces it."""
    def change(mean):
        bump = torch.zeros_like(mean)
        bump.view(-1)[0] = 0.01
        return mean + bump

    _acting(loop, change)


def privileged_latent(loop):
    """The policy is served through its privileged latent, not its history
    latent."""
    inner = loop.actor.act
    loop.actor.act = lambda obs, hist_encoding=False: inner(obs, False)


FAULTS = {**serve.FAULTS, "half_batch": actor_half_batch, "altered_answer": action_altered,
          "privileged_latent": privileged_latent}
