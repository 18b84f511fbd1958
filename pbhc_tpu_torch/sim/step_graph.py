"""A control step replayed as CUDA graphs: the lanes engine's, then the env's
four stages.

On a card the env step is bound by the host: the lanes engine's control step
(`LanesEngine.control_step_batched`: `decimation` substeps of FK, CRBA, RNEA,
M⁻¹, the Jacobian, the Delassus products, kernel 1, the energy safeguard and
the position pass, then the closing derived state) issues thousands of small
kernels, one eager op at a time, and the env's stages around it
(`MotionTrackingEnv.step`: actions, rewards, resets, observations) about a
thousand more. `ControlStepGraph` captures the engine's control step once and
replays it with one `cudaGraphLaunch`; `StageGraph` does the same for each of
the env's stages. The kernels and their arithmetic are the eager step's; only
how they are issued changes.

Every tensor the engine's captured region reads is of one of two kinds:
- fixed for the graph's life and held by identity: the engine's tables, the
  lanes parameters `paramsT`, the torque limits. A graph whose `paramsT`
  tensors were replaced is captured anew;
- copied into a static buffer before each replay: the six `SimState` fields
  the engine reads (`SIM_IN`) and the torque function's tensors.
The torque function is a pure function `torques(inputs, st)` of the substep
state and those tensors. Its random draws come from the env's generator,
registered with the graph, so that a replay draws what the eager step would
have drawn from the same generator state. The returned state and torques are
cloned out of the graph's memory pool: the caller keeps step t's state while
step t+1 runs.

An env stage is a method of the env that is a pure function of its
arguments (the `EnvState`, the actions, the engine's outputs and the earlier
stages' outputs): the env's own tensors (index tables, gains, limits, the
motion library, the domain-randomised parameters) are fixed and held by
identity, and a stage whose env tensors were replaced is captured anew. On a
stage's first eligible call at a key (the stage and the names, shapes and
dtypes of its arguments) it runs eagerly, with CUDA's sync debug mode
counting its synchronising operations; if it ran none it is captured on that
call's arguments, else it stays eager at that key. Capture records which
arguments the stage reads: only those are copied in before a replay, and an
argument it hands back unchanged is handed back as the caller's own tensor.
What the stage makes is packed inside the graph into one buffer per dtype,
cloned out after the replay and handed back as views of the clones. Both of
the env's generators are registered with every stage graph.

`eligible` is the rule by which a control step's engine may replay, and
`env_eligible` the rule for the env's stages. They read only what the code
can observe. The engine: the device, the soft-dynamic-correction hook, and
whether the engine's step is hooked on the instance; a recorder that
replaces `control_step_batched` or `contact_solve` for one call, a planted
fault, or a swapped plain solve keeps that step eager. The stages: the
engine's rule with no soft dynamic correction, one process (a data-parallel
step all-reduces its rewards' scalars eagerly), no teleop source, and for
each stage none of the methods it calls (`STAGES`) shadowed on the env
instance; else the stage runs eagerly, as it always does off a card.

The spans inside the engine (`engine.dynamics`, `engine.contact`,
`engine.position_pass`) and inside a stage (`env.future_targets`) fire only
on eager steps: a replay issues no op from Python. An engine replay sits in
the span `engine.graph_replay`, a stage's in `env.graph_replay` inside the
stage's own span. Kernel 1's launch counters count replays: each adds the
launches it captured.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import warnings

import torch
from torch.overrides import TorchFunctionMode

from pbhc_tpu_torch.sim.contact_kernel import apgd_lanes
from pbhc_tpu_torch.utils.profiling import SYNC_WARNING, span

# the engine methods whose shadowing on the instance keeps a step eager
# (`contact_solve` is an instance attribute: it keeps the step eager when it
# is not kernel 1's wrapper)
HOOKS = ("control_step_batched", "_substep", "_integrate")
# the SimState fields the lanes engine reads (`LanesEngine._to_lanes`)
SIM_IN = ("root_pos", "root_quat", "root_lin_vel", "root_ang_vel", "dof_pos", "dof_vel")


def eligible(engine, device, pre_substep_fn=None) -> bool:
    """Whether a control step of the lanes `engine` on `device` may replay a
    captured graph: on a CUDA device, with no pre-substep hook (soft dynamic
    correction runs eagerly), with kernel 1's wrapper as the contact solve,
    and with none of `HOOKS` shadowed on the engine instance."""
    return (torch.device(device).type == "cuda" and pre_substep_fn is None
            and engine.contact_solve is apgd_lanes
            and not any(name in vars(engine) for name in HOOKS))


@contextlib.contextmanager
def _capturing(graph):
    """A capture into `graph` with Python's cyclic garbage collector paused: a
    collection inside the capture that frees another graph (an env dropped
    in a reference cycle) would invalidate it. thread_local: other threads
    of the process (a data-parallel rank's, a listener's) may use the device
    while this one captures."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            yield
    finally:
        if enabled:
            gc.enable()


class ControlStepGraph:
    """One lanes control step captured at the shapes and layouts of the
    `sim` and `inputs` it is built from. `replay(sim, inputs)` ->
    (SimState, torques), as `engine.control_step_batched(params, sim,
    partial(torques, inputs), decimation, paramsT=paramsT)` returns them."""

    def __init__(self, engine, params, paramsT: dict, torques, decimation: int, generator, sim, inputs: dict):
        self.paramsT, self.fixed = paramsT, tuple(paramsT.values())
        self.sim_in = {f: torch.empty_like(getattr(sim, f)).copy_(getattr(sim, f)) for f in SIM_IN}
        self.inputs = {k: torch.empty_like(v).copy_(v) for k, v in inputs.items()}
        static = dataclasses.replace(sim, **self.sim_in)
        launches, modes = apgd_lanes.launches, dict(apgd_lanes.mode_launches)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        with _capturing(self.graph):
            self.out, self.tau = engine.control_step_batched(
                params, static, functools.partial(torques, self.inputs), decimation, paramsT=paramsT)
        # a capture issues no kernel: each replay counts what it captured
        self.launches = apgd_lanes.launches - launches
        self.mode_launches = {m: apgd_lanes.mode_launches[m] - n for m, n in modes.items()}
        apgd_lanes.launches = launches
        apgd_lanes.mode_launches.update(modes)

    def holds(self, paramsT: dict, inputs: dict) -> bool:
        """Whether this graph replays a step on `paramsT` (the same tensors)
        with torque inputs of `inputs`' names, shapes and dtypes."""
        return (paramsT is self.paramsT and all(a is b for a, b in zip(paramsT.values(), self.fixed))
                and inputs.keys() == self.inputs.keys()
                and all(v.shape == self.inputs[k].shape and v.dtype == self.inputs[k].dtype
                        for k, v in inputs.items()))

    def replay(self, sim, inputs: dict):
        for f, buf in self.sim_in.items():
            buf.copy_(getattr(sim, f))
        for k, buf in self.inputs.items():
            buf.copy_(inputs[k])
        self.graph.replay()
        apgd_lanes.launches += self.launches
        for m, n in self.mode_launches.items():
            apgd_lanes.mode_launches[m] += n
        out = dataclasses.replace(self.out, **{f.name: getattr(self.out, f.name).clone()
                                               for f in dataclasses.fields(self.out)})
        return out, self.tau.clone()


class StepGraphs:
    """The captured control steps of one env's lanes engine, one a number of
    envs and matvec mode. `step` runs a control step: the first eligible one
    at a key eagerly, then captured on that call's inputs; later ones replay.
    `counts` holds the graphed and the eager control steps."""

    def __init__(self, engine, generator):
        self.engine, self.generator = engine, generator
        self.graphs = {}
        self.counts = {"graphed": 0, "eager": 0}

    def step(self, params, paramsT: dict, sim, torques, inputs: dict, decimation: int, pre_substep_fn=None):
        engine, key = self.engine, None
        if eligible(engine, sim.root_pos.device, pre_substep_fn):
            N = sim.root_pos.shape[0]
            key = (N, engine.solve_dtype(N), decimation)
            graph = self.graphs.get(key)
            if graph is not None and graph.holds(paramsT, inputs):
                self.counts["graphed"] += 1
                with span("engine.graph_replay"):
                    return graph.replay(sim, inputs)
        self.counts["eager"] += 1
        out = engine.control_step_batched(params, sim, functools.partial(torques, inputs), decimation,
                                          paramsT=paramsT, pre_substep_fn=pre_substep_fn)
        if key is not None:
            self.graphs[key] = ControlStepGraph(engine, params, paramsT, torques, decimation, self.generator,
                                                sim, inputs)
        return out


# ---------------------------------------------------------------- env stages

# the env methods each stage calls, its own first: one shadowed on the env
# instance keeps that stage eager
STAGES = {
    "actions": ("_actions_stage", "_motion_state_at", "_uniform", "_randint", "_sample_push_interval",
                "_torque_inputs"),
    "rewards": ("_rewards_stage", "_motion_state_at", "_extend_body_states", "_compute_diffs",
                "_extra_terminations", "_gate", "_compute_rewards", "_reward_terms", "_update_sigmas",
                "_update_avg_episode_length", "_update_curricula"),
    "resets": ("_resets_stage", "_reset_envs", "_episodic_dr", "_uniform", "_randint"),
    "observations": ("_observations_stage", "compute_observations", "_obs_getters", "_motion_state_at",
                     "_extend_body_states", "_build_log", "_env_mean_logs"),
}


def env_eligible(env) -> bool:
    """Whether the stages of `env`'s next control step may replay captured
    graphs: on a CUDA device, with the lanes engine eligible to replay and no
    soft dynamic correction, in one process, with no teleop source. Each
    stage besides needs its `STAGES` methods unshadowed (`stage_eligible`)."""
    return (env.device.type == "cuda" and env.lanes_engine is not None and not env.use_sdc
            and eligible(env.lanes_engine, env.device) and not env.shard.distributed
            and env.teleop_source is None)


def stage_eligible(env, stage: str) -> bool:
    """Whether none of the methods that `stage` calls is shadowed on `env`."""
    return not any(name in vars(env) for name in STAGES[stage])


def _flatten(tree, leaves: list):
    """Append the tensors of `tree` (dataclasses, dicts, lists and tuples of
    them) to `leaves` in order; return a hashable description of the rest."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return None
    if isinstance(tree, dict):
        return dict, tuple(tree), tuple(_flatten(v, leaves) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return type(tree), tuple(_flatten(v, leaves) for v in tree)
    if dataclasses.is_dataclass(tree):
        return type(tree), tuple(_flatten(getattr(tree, f.name), leaves) for f in dataclasses.fields(tree))
    return "const", tree


def _build(spec, leaves):
    """The tree that `_flatten` described by `spec`, its tensors taken in
    order from the iterator `leaves`."""
    if spec is None:
        return next(leaves)
    kind = spec[0]
    if kind is dict:
        return dict(zip(spec[1], [_build(s, leaves) for s in spec[2]]))
    if kind is list or kind is tuple:
        return kind(_build(s, leaves) for s in spec[1])
    if kind == "const":
        return spec[1]
    return kind(**{f.name: _build(s, leaves) for f, s in zip(dataclasses.fields(kind), spec[1])})


def _fixed(env) -> tuple:
    """The env's own tensors and their holders, which its stages read as
    fixed: held by identity."""
    return (*(v for v in vars(env).values() if isinstance(v, (torch.Tensor, dict))
              or dataclasses.is_dataclass(v)), env.motion_lib.data)


def _observed(fn, args):
    """`fn(*args)` and the number of synchronising CUDA operations it ran
    (CUDA's sync debug mode "warn"); its warnings are passed on after it, so
    that the program's spans count its syncs as before."""
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    for w in caught:
        warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    return out, sum(SYNC_WARNING in str(w.message) for w in caught)


# the in-place operators besides the methods named with a trailing "_"
_IN_PLACE = {"__setitem__", *(f"__i{op}__" for op in ("add", "sub", "mul", "truediv", "floordiv", "mod", "pow",
                                                       "and", "or", "xor", "lshift", "rshift", "matmul"))}


class _Reads(TorchFunctionMode):
    """Records which of the tensors `owner` ({id: index}) the torch functions
    called under it receive, and whether one of them is written in place."""

    def __init__(self, owner: dict):
        super().__init__()
        self.owner, self.seen, self.written = owner, set(), False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._visit(args)
        self._visit(kwargs.values())
        name = getattr(func, "__name__", "")
        if (args and isinstance(args[0], torch.Tensor) and id(args[0]) in self.owner
                and (name in _IN_PLACE or name.endswith("_") and not name.endswith("__"))):
            self.written = True
        return func(*args, **kwargs)

    def _visit(self, xs):
        for x in xs:
            if isinstance(x, torch.Tensor):
                i = self.owner.get(id(x))
                if i is not None:
                    self.seen.add(i)
            elif isinstance(x, (list, tuple)):
                self._visit(x)
            elif isinstance(x, dict):
                self._visit(x.values())


def _capture(graph, region):
    """`region()` captured into `graph`: what it returns, its tensors the
    graph's static outputs."""
    with _capturing(graph):
        return region()


class StageGraph:
    """One env stage `fn(*args)` captured at the shapes and layouts of the
    `args` it is built from (their tensors `leaves`, the rest described by
    `spec`). `replay(leaves)` -> what `fn` returns on arguments of those
    tensors. `written` is true where the stage writes an argument in place:
    such a graph is never replayed."""

    def __init__(self, fn, spec, leaves: list, generators, fixed: tuple):
        self.fixed = fixed
        static = [torch.empty_like(t).copy_(t) for t in leaves]
        owner = {id(t): i for i, t in enumerate(static)}
        reads = _Reads(owner)

        def region():
            with reads:
                out = fn(*_build(spec, iter(static)))
            outs = []
            out_spec = _flatten(out, outs)
            # each output an argument handed back ("arg", index) or a slice of
            # the dtype's packed buffer ("pack", dtype, index); one slot an object
            slot, parts, order = {}, {}, []
            for t in outs:
                if id(t) not in slot:
                    if id(t) in owner:
                        slot[id(t)] = ("arg", owner[id(t)])
                    else:
                        part = parts.setdefault(t.dtype, [])
                        slot[id(t)] = ("pack", t.dtype, len(part))
                        part.append(t)
                order.append(slot[id(t)])
            packs = {dt: torch.cat([t.reshape(-1) for t in part]) for dt, part in parts.items()}
            return out_spec, order, {dt: [(t.numel(), t.shape) for t in part] for dt, part in parts.items()}, packs

        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        self.spec, self.order, layout, self.packs = _capture(self.graph, region)
        self.sizes = {dt: [n for n, _ in v] for dt, v in layout.items()}
        self.shapes = {dt: [shape for _, shape in v] for dt, v in layout.items()}
        self.written = reads.written
        # the arguments the stage reads, copied in before each replay
        self.copy_in = [(i, static[i]) for i in sorted(reads.seen)]

    def holds(self, fixed: tuple) -> bool:
        """Whether the env's fixed tensors are the ones this graph read."""
        return len(fixed) == len(self.fixed) and all(a is b for a, b in zip(fixed, self.fixed))

    def replay(self, leaves: list):
        for i, buf in self.copy_in:
            buf.copy_(leaves[i])
        self.graph.replay()
        made = {dt: [v.view(shape) for v, shape in zip(p.clone().split(self.sizes[dt]), self.shapes[dt])]
                for dt, p in self.packs.items()}
        return _build(self.spec, iter([leaves[s[1]] if s[0] == "arg" else made[s[1]][s[2]] for s in self.order]))


class StageGraphs:
    """The captured stages of one env's control steps, one a stage and key.
    `run(env, stage, fn, *args)` runs one stage: eagerly where the rules do
    not let it replay, else the first call at a key eagerly and then
    captured on that call's arguments, later ones replayed. `counts` holds,
    per stage, the graphed and the eager calls. (The env is passed, not
    held: the env holds this.)"""

    def __init__(self):
        self.graphs = {}
        self.counts = {stage: {"graphed": 0, "eager": 0} for stage in STAGES}

    def run(self, env, stage: str, fn, *args):
        key = None
        if env_eligible(env) and stage_eligible(env, stage):
            leaves = []
            spec = _flatten(args, leaves)
            if not any(t.requires_grad for t in leaves):
                key = (stage, spec, tuple((t.shape, t.dtype, t.device) for t in leaves))
                fixed = _fixed(env)
                graph = self.graphs.get(key)
                if graph is not None and graph.holds(fixed):
                    self.counts[stage]["graphed"] += 1
                    with span("env.graph_replay"):
                        return graph.replay(leaves)
        self.counts[stage]["eager"] += 1
        if key is None or (key in self.graphs and self.graphs[key] is None):
            return fn(*args)
        out, syncs = _observed(fn, args)
        graph = None
        if not syncs:
            gens = list({id(g): g for g in (env.gen, env.shared_gen)}.values())
            graph = StageGraph(fn, spec, leaves, gens, fixed)
        self.graphs[key] = None if graph is None or graph.written else graph
        return out
