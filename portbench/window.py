"""What the loops share: the measured window, host spans, the recorders that
copy what the timed path hands on for the check, and the program's set-up
from a configuration file.

A loop (`portbench/loops/<loop>.py`, named by the mix's `loop` key) brings a
`Loop` class, the `numbers` that judge its recordings, and the `FAULTS` it
can have. The program is reached through its own entry points; a recorder
replaces an attribute of an instance (the env's `step`, the lanes engine's
`control_step_batched` and `contact_solve`) for the one call it records,
passes the call through unchanged and puts the attribute back.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import torch

# the env state's fields the step's check reads, as the step found them
PRE_FIELDS = ("action_queue", "action_delay_idx", "kp_scale", "kd_scale", "rfi_lim_scale", "rao_scale",
              "default_dof_pos", "last_actions", "last_dof_vel", "last_contacts", "feet_air_time",
              "soft_dof_pos_limit", "soft_dof_vel_limit", "soft_torque_limit", "reward_penalty_scale",
              "episode_length", "motion_ids", "motion_start_times", "motion_len", "sigma_values")
SUB_FIELDS = ("root_pos", "root_quat", "root_lin_vel", "root_ang_vel", "dof_pos", "dof_vel")
POST_FIELDS = SUB_FIELDS + ("body_pos", "body_quat", "body_lin_vel", "body_ang_vel", "contact_forces")
PARAM_FIELDS = ("mass", "com", "inertia", "friction", "restitution", "armature", "dof_damping", "dof_frictionloss")


def host(t):
    """A copy of `t` on the host (a copy on the CPU too: never an alias)."""
    return t.detach().to("cpu", copy=True)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to(tree, device):
    """Every tensor of a nested dict / list on `device`."""
    if isinstance(tree, dict):
        return {k: to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class Spans:
    """Host-clock spans around calls into the program's layers, each closed by
    a synchronise at its boundary. Off (`on` false), a span costs nothing."""

    def __init__(self, on: bool, device):
        self.on, self.device = on, device
        self.seconds = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name):
        if not self.on:
            yield
            return
        sync(self.device)
        t = time.perf_counter()
        yield
        sync(self.device)
        self.seconds[name].append(time.perf_counter() - t)


@contextlib.contextmanager
def patched(obj, name, value):
    """`obj.name` set to `value` on the instance while the block runs, then
    as it was."""
    had, before = name in vars(obj), vars(obj).get(name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        if had:
            setattr(obj, name, before)
        else:
            delattr(obj, name)


class HostCopies:
    """Copies of device tensors into host buffers kept by key, pinned on a
    card and enqueued on the stream so that the host never waits for them.
    A recording made in set-up allocates the buffers the window reuses."""

    def __init__(self, device):
        self.pin, self.buf = device.type == "cuda", {}

    def __call__(self, key, t):
        t = t.detach()
        b = self.buf.get(key)
        if b is None or b.shape != t.shape or b.dtype != t.dtype:
            b = self.buf[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=self.pin)
        return b.copy_(t, non_blocking=True)


class StepRecorder:
    """Records one control step of a lanes-engine env for the step's check:
    the state fields and actions it was given, each substep's state and
    torques as the engine hands them to the torque function, the engine's
    parameters, every contact solve's inputs and output, the engine's
    closing state, and the step's rewards, torques, dones and observations. `arm(skip)`
    records the env's `skip`-th next step; each tensor goes through
    `copy(key, tensor)`."""

    def __init__(self, env, copy):
        self.env, self.copy = env, copy
        self.record, self.armed = None, None

    def arm(self, skip: int = 0):
        env, inner, calls = self.env, self.env.step, [0]
        self.own = "step" in vars(env)

        def step(state, actions):
            if calls[0] < skip:
                calls[0] += 1
                return inner(state, actions)
            self.disarm()
            return self._recorded(inner, state, actions)

        self.armed = inner
        env.step = step

    def disarm(self):
        if self.armed is not None:
            if self.own:
                self.env.step = self.armed
            else:
                del self.env.step
            self.armed = None

    def _recorded(self, inner, state, actions):
        env, c = self.env, self.copy
        engine = env.lanes_engine
        rec = {"actions": c("actions", actions), "subs": [], "solves": [],
               "pre": {f: c(f"pre.{f}", getattr(state, f)) for f in PRE_FIELDS}}
        rec["pre"]["history"] = {k: c(f"pre.history.{k}", v) for k, v in state.history.items()}
        inner_cs, inner_solve = engine.control_step_batched, engine.contact_solve

        def control_step(params, states, torque_fn, decimation, paramsT=None, pre_substep_fn=None):
            if paramsT is None:
                paramsT = {k: torch.movedim(getattr(params, k), 0, -1) for k in PARAM_FIELDS}
            rec["params"] = {k: c(f"params.{k}", paramsT[k]) for k in PARAM_FIELDS}

            def torques(st):
                tau = torque_fn(st)
                i = len(rec["subs"])
                rec["subs"].append({**{f: c(f"sub{i}.{f}", getattr(st, f)) for f in SUB_FIELDS},
                                    "tau": c(f"sub{i}.tau", tau)})
                return tau

            out, tau = inner_cs(params, states, torques, decimation, paramsT=paramsT, pre_substep_fn=pre_substep_fn)
            rec["post_sim"] = {f: c(f"post.{f}", getattr(out, f)) for f in POST_FIELDS}
            return out, tau

        def solve(A, b, mu, active, x0, iters, mv_dtype="float32"):
            out = inner_solve(A, b, mu, active, x0, iters=iters, mv_dtype=mv_dtype)
            i = len(rec["solves"])
            rec["solves"].append({**{k: c(f"solve{i}.{k}", t) for k, t in (
                ("A", A), ("b", b), ("mu", mu), ("active", active), ("x0", x0), ("out", out))},
                "iters": int(iters)})
            return out

        with patched(engine, "control_step_batched", control_step), patched(engine, "contact_solve", solve):
            out = inner(state, actions)
        rec["rew"], rec["torques"], rec["done"] = c("rew", out[2]), c("torques", out[0].torques), c("done", out[3])
        rec["obs"] = {k: c(f"obs.{k}", v) for k, v in out[1].items()}
        self.record = rec
        return out


def load_config(root: Path, config: dict, seed: int, device: str, overrides):
    from pbhc_tpu_torch.config.loader import Cfg, apply_overrides, snapshot_for_checkpoint

    cfg = snapshot_for_checkpoint(root / config["checkpoint"])
    cfg["num_envs"], cfg["seed"], cfg["device"] = config["num_envs"], seed, device
    return Cfg.wrap(apply_overrides(cfg, overrides))


def check_sizes(config: dict, env, extra: dict):
    """Raise unless the program runs the sizes that the configuration file
    states (the counts and the check are computed from the file). The rows
    each contact solve is handed are checked on the recorded step
    (`check_rows`)."""
    got = {"num_envs": env.num_envs, "decimation": env.decimation, **extra}
    if env.lanes_engine is not None:
        got["solver_iters"] = env.lanes_engine.opt.solver_iters
    want = {k: config.get(k) for k in got}
    got["actor.out"], want["actor.out"] = env.num_actions, config["actor"]["out"]
    for key in ("actor", "critic"):
        if "group" in config.get(key, {}):
            got[f"{key}.in"], want[f"{key}.in"] = env.obs_dim(config[key]["group"]), config[key]["in"]
    if "group" in config.get("critic", {}):
        got["critic.out"], want["critic.out"] = env.num_rew_fn, config["critic"]["out"]
    for k, v in got.items():
        if want[k] != v:
            raise ValueError(f"the program runs {k}={v}, the configuration file states {want[k]}")


def check_rows(config: dict, record: dict):
    """Raise unless every contact solve of a recorded step was handed the
    configuration file's rows and iterations."""
    for s in record["solves"]:
        rows = s["active"].shape[0]
        if rows != config["contact_rows"] or s["iters"] != config["solver_iters"]:
            raise ValueError(f"the program solves {rows} contact rows in {s['iters']} iterations, the "
                             f"configuration file states {config['contact_rows']} in {config['solver_iters']}")


def run_window(loop, seconds: float, spans, rng):
    """Drive `loop` for `seconds` of host clock and return the window's
    counts. Training runs whole iterations: the one in progress at the end
    finishes and counts. Serving times each step between CUDA events recorded
    after it, read after the window, so that no step waits for the device."""
    dev = loop.device
    sync(dev)
    cuda = dev.type == "cuda"
    marks = []
    mark = (lambda: marks.append(torch.cuda.Event(enable_timing=True)) or marks[-1].record()) if cuda \
        else (lambda: marks.append(time.perf_counter()))
    t0 = time.perf_counter()
    mark()
    units = 0
    while True:
        loop.unit(units, rng, spans)
        mark()
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    if cuda:
        unit_s = [a.elapsed_time(b) / 1e3 for a, b in zip(marks[:-1], marks[1:])]
    else:
        unit_s = [b - a for a, b in zip(marks[:-1], marks[1:])]
    loop.finish()
    return {"seconds": window_s, "units": units, "env_steps": units * loop.env_steps_per_unit, "unit_s": unit_s}

