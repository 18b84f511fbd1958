"""Eval-time callbacks (counterpart of `pbhc_tpu/eval/callbacks.py`).

The hook interface of the reference's RL_EvalCallback and its analysis
callbacks: per-step values into the live dashboard (`eval/dashboard.py`),
contact forces, and an open-loop replay of a clip's recorded actions in
place of the policy's.

The hooks receive and return an `actor_state` dict:
    {"step": int, "obs": obs dict, "actions": [N,nd], "env_state": EnvState}
`on_pre_eval_env_step` may rewrite "actions" (a tensor or a numpy array);
`on_post_eval_env_step` sees the post-step env state. Values read off the
env state are copied to the host, one per logged scalar.
"""
from __future__ import annotations

import numpy as np
import torch

from pbhc_tpu_torch.motion.motion_lib import load_motion_dict


class RLEvalCallback:
    """`callbacks.py:21`: every hook passes its input through."""

    def __init__(self, config, env):
        self.config = config
        self.env = env

    def on_pre_evaluate_policy(self):
        pass

    def on_pre_eval_env_step(self, actor_state):
        return actor_state

    def on_post_eval_env_step(self, actor_state):
        return actor_state

    def on_post_evaluate_policy(self):
        pass


class AnalysisPlotCallback(RLEvalCallback):
    """Root height, the first 6 joints' positions and actions, and the torque
    norm of env `env_index` into the dashboard (`callbacks.py:41`)."""

    def __init__(self, config, env, dashboard, env_index: int = 0):
        super().__init__(config, env)
        self.dash = dashboard
        self.i = env_index

    def on_post_eval_env_step(self, actor_state):
        st = actor_state["env_state"]
        sim, i = st.sim, self.i
        scalars = {"root_z": float(sim.root_pos[i, 2])}
        for j in range(min(6, self.env.nd)):
            scalars[f"dof_pos_{j}"] = float(sim.dof_pos[i, j])
            scalars[f"action_{j}"] = float(actor_state["actions"][i, j])
        scalars["torque_norm"] = float(torch.linalg.vector_norm(st.torques[i]))
        self.dash.log_step(scalars)
        return actor_state


class ForcePlotCallback(RLEvalCallback):
    """Total vertical and largest contact force of env `env_index` (`callbacks.py:64`)."""

    def __init__(self, config, env, dashboard, env_index: int = 0):
        super().__init__(config, env)
        self.dash = dashboard
        self.i = env_index

    def on_post_eval_env_step(self, actor_state):
        cf = actor_state["env_state"].sim.contact_forces[self.i].detach().cpu().numpy()   # [B,3]
        self.dash.log_step({"contact_fz_total": float(cf[:, 2].sum()),
                            "contact_f_max": float(np.abs(cf).max())})
        return actor_state


class OpenLoopReplayCallback(RLEvalCallback):
    """Every env takes the clip's recorded action at the step's time instead
    of the policy's (`callbacks.py:82`)."""

    def __init__(self, config, env, motion_file=None):
        super().__init__(config, env)
        mf = motion_file or str(env.config.robot.motion.motion_file)
        raw = load_motion_dict(mf)
        clip = raw[next(iter(raw.keys()))]
        if "action" not in clip:
            raise ValueError(f"{mf} carries no recorded actions for open-loop replay")
        self.actions = np.asarray(clip["action"], dtype=np.float32)   # [T,nd]
        self.fps = float(clip["fps"])

    def on_pre_eval_env_step(self, actor_state):
        t = actor_state["step"] * self.env.dt
        frame = min(int(t * self.fps), len(self.actions) - 1)
        a = self.actions[frame]
        actor_state["actions"] = np.broadcast_to(a, (self.env.num_envs,) + a.shape).copy()
        return actor_state


def build_callbacks(names, config, env, dashboard=None):
    """Callbacks by name (`eval_agent callbacks=plot,force,openloop`)."""
    out = []
    for n in names:
        n = n.strip()
        if not n:
            continue
        if n in ("plot", "analysis_plot"):
            out.append(AnalysisPlotCallback(config, env, dashboard))
        elif n == "force":
            out.append(ForcePlotCallback(config, env, dashboard))
        elif n in ("openloop", "open_loop"):
            out.append(OpenLoopReplayCallback(config, env))
        else:
            raise ValueError(f"unknown eval callback {n!r}")
    return out
