"""Faults planted under the timed path, each a function of the loop that the
harness calls after set-up: the check has to read every one as not correct
(`portbench/tests/test_portbench_check.py`, and `portbench/control.py` on
the card at the cell's own size). A loop module lists the ones its cells can
have in its `FAULTS`."""
from __future__ import annotations

import torch


def optimizer_state_unchanged(loop):
    """Every optimizer step returns the parameters and moments unchanged."""
    for o in loop.opts:
        o.step = lambda grads, lr: None


def half_batch(method: str):
    """Each minibatch update (the learner's `method`) sees the first half of
    its rows, the mean taken over them."""
    def plant(loop):
        inner = getattr(loop.algo, method)
        setattr(loop.algo, method,
                lambda ts, batch, rows=None: inner(ts, {k: v[: len(v) // 2] for k, v in batch.items()}))
    return plant


def solve_altered(loop):
    """Kernel 1's impulses come back 1% too large."""
    engine = loop.env.lanes_engine
    inner = engine.contact_solve
    engine.contact_solve = lambda *a, **kw: inner(*a, **kw) * 1.01


def env_state_unchanged(loop):
    """The env step returns the state it was given, and that state's
    observations."""
    env = loop.env
    inner = env.step

    def step(state, actions):
        out = inner(state, actions)
        return (state, env.compute_observations(state)[0], *out[2:])

    env.step = step


def position_pass_dropped(loop):
    """The engine integrates each substep without the split-impulse
    position correction."""
    engine = loop.env.lanes_engine
    inner = engine._integrate
    engine._integrate = lambda stateT, u_new, dpos=None: inner(stateT, u_new, None)


def reward_altered(loop):
    """Every reward of the step comes back 1% too large."""
    env = loop.env
    inner = env.step

    def step(state, actions):
        out = inner(state, actions)
        return (*out[:2], out[2] * 1.01, *out[3:])

    env.step = step


def observation_stale(loop):
    """The env step hands back the observations of the step before."""
    env, inner, last = loop.env, loop.env.step, []

    def step(state, actions):
        out = inner(state, actions)
        stale = last[0] if last else out[1]
        last[:] = [out[1]]
        return (out[0], stale, *out[2:])

    env.step = step


def actor_half_batch(loop):
    """The actor acts for the first half of the envs; the rest get zeros."""
    inner = loop.actor.forward

    def forward(obs):
        mean, std = inner(obs)
        half = mean.shape[0] // 2
        return torch.cat([mean[:half], torch.zeros_like(mean[half:])]), std

    loop.actor.forward = forward


def action_altered(loop):
    """One action of every step is off by 0.01 where the actor produces it."""
    inner = loop.actor.forward

    def forward(obs):
        mean, std = inner(obs)
        bump = torch.zeros_like(mean)
        bump.view(-1)[0] = 0.01
        return mean + bump, std

    loop.actor.forward = forward
