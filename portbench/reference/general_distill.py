"""Plain reference of one control step of KungfuBot2's general-tracking env
as a student distillation runs it: the step of `reference/general.py`, and
the two observation groups that the student env computes for its frozen
teacher.

A distillation run's env computes, beside the student's own groups,
`teacher_actor_obs` and `teacher_future_motion_targets`: the parts that the
teacher's run lists under `actor_obs` and `future_motion_targets` (its own
snapshot's `obs_dict`), each computed as the student env computes a part of
that name, with the student run's scales, noise and clip. They are checked
as every other group is (`observation_gap`): the parts without noise over
their largest entry, the noised ones by how far they lie outside the noise's
range, the history parts exactly. The teacher's future targets hold the key
bodies in the reference anchor's frame at every future offset, which the
student's do not.

Departures from the published description: none taken.
"""
from __future__ import annotations

import json
from pathlib import Path

from . import general
from .precision import set_full_float32

# the student env's group -> the teacher run's group whose parts it holds
TEACHER_GROUPS = {"teacher_actor_obs": "actor_obs", "teacher_future_motion_targets": "future_motion_targets"}


class Reference(general.Reference):
    def __init__(self, config: dict, root, device, precision: str = "float32"):
        if precision == "float32":
            set_full_float32()
        super().__init__(config, root, device, precision)
        with open(Path(root) / config["teacher"]["snapshot"]) as f:
            teacher = json.load(f)["obs"]["obs_dict"]
        obs_dict = dict(self.snap_obs["obs_dict"])
        for group, own in TEACHER_GROUPS.items():
            obs_dict[group] = list(teacher[own])
        self.snap_obs = {**self.snap_obs, "obs_dict": obs_dict}
