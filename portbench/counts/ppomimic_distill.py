"""Multiply-accumulates per sample of KungfuBot2's student distillation
(PPOMimic's `dagger_only` path with a frozen teacher), from the sizes in the
configuration file, counted as `counts/ppomimic.py` counts the mimic
networks.

The rollout runs three networks a sample: the student's actor through its
history latent (the motion encoder, the history encoder and the backbone),
the critic (the motion encoder again and its MLP), and the frozen teacher
through its own history latent on its own groups (`teacher.actor`).

The update is one behaviour-cloning pass an iteration
(`bc_passes_per_iteration`): `num_mini_batches` consecutive minibatches that
together visit every sample once, each differentiating the student's actor
through its history latent (the history encoder's gradient is computed and
then zeroed). `work.train_iteration_flops` multiplies the update's counts by
`num_learning_epochs`, which distillation does not read, so `update_macs`
divides by it: the product is then the one pass. Nothing runs without a
gradient in the update (the teacher's actions come from the rollout).
"""
from portbench.counts.ppomimic import encoder_macs
from portbench.counts.work import mlp_macs


def actor_macs(a) -> int:
    """An actor block of the configuration acting through its history
    latent: motion encoder, history encoder, backbone."""
    return encoder_macs(a["motion_encoder"]) + encoder_macs(a["history_encoder"]) \
        + mlp_macs(a["layernorm"], a["hidden"], a["out"])


def critic_macs(c) -> int:
    """The critic reruns the student's motion encoder before its MLP."""
    return encoder_macs(c["actor"]["motion_encoder"]) + mlp_macs(c["critic"]["in"], c["critic"]["hidden"],
                                                                 c["critic"]["out"])


def rollout_macs(c):
    """Per env-step of the rollout: the student, the critic and the teacher."""
    return actor_macs(c["actor"]) + critic_macs(c) + actor_macs(c["teacher"]["actor"])


def update_macs(c):
    """Per sample per epoch as `work` multiplies it: the student's actor,
    differentiated, `bc_passes_per_iteration` times an iteration."""
    return actor_macs(c["actor"]) * c["bc_passes_per_iteration"] / c["num_learning_epochs"]


def update_nograd_macs(c):
    return 0


def serve_macs(c):
    """Per env-step of serving the student: its actor's mean through the
    history latent, as it is deployed."""
    return actor_macs(c["actor"])
