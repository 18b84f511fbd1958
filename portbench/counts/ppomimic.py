"""Multiply-accumulates per sample of KungfuBot2's mimic networks (PPOMimic),
from the sizes in the configuration file.

An encoder of steps is a per-step dense layer, strided VALID convolutions
over time, each counted as output length x output channels x input channels
x kernel, and a dense head over the flattened output. The actor is the
motion encoder, the privileged MLP or the history encoder, and the backbone;
the critic reruns the motion encoder before its own MLP. LayerNorms, the
activations and the once-an-iteration value of the last observation are
left out.

Every `dagger_update_freq`-th iteration differs: its rollout acts through
the history encoder in place of the privileged one, and after the RL epochs
a DAgger pass runs once over every sample: the privileged encoder's forward
(no gradient) and the history encoder's forward and backward. Both are
amortised over the period here: `rollout_macs` averages the two encoders,
and the DAgger pass is spread over the period's iterations and the
iteration's epochs, since `work.train_iteration_flops` multiplies the update
counts by the epochs.
"""
from portbench.counts.work import mlp_macs


def encoder_macs(e) -> int:
    """One conv encoder of the configuration (`actor.motion_encoder`,
    `actor.history_encoder`), per sample."""
    t, per_step = e["steps"], e["in"] // e["steps"]
    macs, chans = t * per_step * e["hidden"], e["hidden"]
    for out, k, s in zip(e["channels"], e["kernels"], e["strides"]):
        t = (t - k) // s + 1
        macs += t * out * chans * k
        chans = out
    return macs + t * chans * e["out"]


def _parts(c):
    a = c["actor"]
    motion, hist = encoder_macs(a["motion_encoder"]), encoder_macs(a["history_encoder"])
    p = a["priv_encoder"]
    priv = mlp_macs(p["in"], p["hidden"], p["out"])
    backbone = mlp_macs(a["layernorm"], a["hidden"], a["out"])
    critic = mlp_macs(c["critic"]["in"], c["critic"]["hidden"], c["critic"]["out"])
    return motion, hist, priv, backbone, critic


def _dagger_share(c) -> float:
    """The DAgger pass's weight per sample per epoch of an iteration."""
    return 1.0 / (c["dagger_update_freq"] * c["num_learning_epochs"])


def rollout_macs(c):
    """Per env-step of the rollout: the actor (its latent through the
    privileged encoder, or the history encoder one iteration in
    `dagger_update_freq`) and the critic."""
    motion, hist, priv, backbone, critic = _parts(c)
    f = 1.0 / c["dagger_update_freq"]
    return motion + (1.0 - f) * priv + f * hist + backbone + motion + critic


def update_macs(c):
    """Per sample per epoch, the passes the update differentiates: the
    actor through the privileged latent, the critic, the privileged latent
    again for `priv_reg`; and the DAgger pass's history encoder, amortised."""
    motion, hist, priv, backbone, critic = _parts(c)
    return motion + priv + backbone + motion + critic + priv + _dagger_share(c) * hist


def update_nograd_macs(c):
    """Per sample per epoch, the forward passes without a gradient: the
    history latent of `priv_reg`, and the DAgger pass's privileged target,
    amortised."""
    motion, hist, priv, backbone, critic = _parts(c)
    return hist + _dagger_share(c) * priv


def serve_macs(c):
    """Per env-step of serving: the actor's mean through the history
    latent, as the deployed teacher acts."""
    motion, hist, priv, backbone, critic = _parts(c)
    return motion + hist + backbone
