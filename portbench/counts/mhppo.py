"""Multiply-accumulates per sample of KungfuBot v1's networks (dense MLPs),
from the sizes in the configuration file."""
from portbench.counts.work import mlp_macs


def _actor(c):
    a = c["actor"]
    return mlp_macs(a["in"], a["hidden"], a["out"])


def _critic(c):
    v = c["critic"]
    return mlp_macs(v["in"], v["hidden"], v["out"])


def rollout_macs(c):
    """Per env-step of the rollout: the actor and the critic."""
    return _actor(c) + _critic(c)


def update_macs(c):
    """Per sample per epoch, the passes the update differentiates."""
    return _actor(c) + _critic(c)


def update_nograd_macs(c):
    return 0


def serve_macs(c):
    """Per env-step of serving: the actor's mean."""
    return _actor(c)
