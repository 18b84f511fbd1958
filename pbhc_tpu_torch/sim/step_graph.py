"""A control step replayed as CUDA graphs, one a stage.

On a card the env step is bound by the host: its five stages
(`MotionTrackingEnv.step`: actions, the lanes engine's control step,
rewards, resets, observations) issue thousands of small kernels, one eager
op at a time. The engine's stage alone (`LanesEngine.control_step_batched`:
`decimation` substeps of FK, CRBA, RNEA, M⁻¹, the Jacobian, the Delassus
products, kernel 1, the energy safeguard and the position pass, then the
closing derived state) issues about 7,400. `StageGraph` captures one stage
once and replays it with one `cudaGraphLaunch`; `StageGraphs` keeps one
such graph a stage and key. The kernels and their arithmetic are the eager
step's; only how they are issued changes.

A stage is a method of the env that is a pure function of its arguments
(the `EnvState`, the actions, the engine's state and torque inputs, the
earlier stages' outputs). The env's own tensors (index tables, gains,
limits, the motion library, the domain-randomised parameters and the
engine's lanes parameters `paramsT`, and the tensors its dicts and
dataclasses hold) are fixed and held by identity: a stage whose env tensors
were replaced is captured anew. On a stage's first eligible call at a key
(the stage and the names, shapes and dtypes of its arguments) it runs
eagerly, with CUDA's sync debug mode counting its synchronising operations;
if it ran none it is captured on that call's arguments, else it stays eager
at that key. Capture records which arguments the stage reads: only those
are copied in before a replay (the engine's stage reads six of the
`SimState`'s fields and the torque inputs), and an argument it hands back
unchanged is handed back as the caller's own tensor. A stage that writes an
argument in place is never replayed. What the stage makes is packed inside
the graph into one buffer per dtype, each tensor in its own memory order,
cloned out after the replay (the caller keeps step t's state while step t+1
runs) and handed back as views of the clones with the eager call's strides.
Both of the env's generators are registered with every graph, so that a
replay draws what the eager stage would have drawn (the engine's torque
noise, the resets' draws) from the same generator state.

The rules read only what the code can observe. The engine's stage
(`engine_eligible`): a CUDA device, the lanes engine, no soft dynamic
correction (its pre-substep hook runs eagerly), kernel 1's wrapper as the
contact solve and none of the engine's `HOOKS` shadowed on its instance
(`eligible`): a recorder that replaces `control_step_batched` or
`contact_solve` for one call, a planted fault, or a swapped plain solve
keeps that step eager, all five stages included. The other four stages
(`env_eligible`): the engine's rule, one process (a data-parallel step
all-reduces its rewards' scalars eagerly) and no teleop source. Each stage
besides needs none of the env methods it calls (`STAGES`) shadowed on the
env instance (`stage_eligible`); else it runs eagerly, as every stage does
off a card.

The spans inside the engine (`engine.dynamics`, `engine.contact`,
`engine.position_pass`) and inside a stage (`env.future_targets`) fire only
on eager steps: a replay issues no op from Python. A replay sits inside
its stage's span, in `engine.graph_replay` for the engine's stage and in
`env.graph_replay` for the others. The kernels' launch counters
(`COUNTERS`) count replays: each adds the launches its capture made.

Another owner goes through the same mechanism under its own rule
(`StageGraphs.run_step`): a learner's minibatch steps
(`agents/mh_ppo.py::MHPPO._minibatch`), which also write held tensors in
place (parameters and moments) and take host values written before each
replay.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import warnings

import torch
from torch.overrides import TorchFunctionMode

from pbhc_tpu_torch.sim.contact_kernel import apgd_envfirst, apgd_lanes
from pbhc_tpu_torch.sim.dynamics_kernel import lanes_body_state, lanes_dynamics
from pbhc_tpu_torch.utils.profiling import SYNC_WARNING, span

# the counted kernel wrappers: a replay adds to each one's `launches` (and
# to kernel 1's `mode_launches`) what its capture launched
COUNTERS = (apgd_lanes, apgd_envfirst, lanes_dynamics, lanes_body_state)

# the engine methods whose shadowing on the instance keeps a step eager
# (`contact_solve` is an instance attribute: it keeps the step eager when it
# is not kernel 1's wrapper)
HOOKS = ("control_step_batched", "_substep", "_integrate")

# the env methods each stage calls, its own first: one shadowed on the env
# instance keeps that stage eager. The methods, not every method of the env
# class: a step recorder shadows `step` for the steps before the one it
# records, and those stay graphed.
STAGES = {
    "actions": ("_actions_stage", "_motion_state_at", "_uniform", "_randint", "_sample_push_interval",
                "_torque_inputs"),
    "engine": ("_engine_stage", "_torques"),
    "rewards": ("_rewards_stage", "_motion_state_at", "_extend_body_states", "_compute_diffs",
                "_extra_terminations", "_gate", "_compute_rewards", "_reward_terms", "_update_sigmas",
                "_update_avg_episode_length", "_update_curricula"),
    "resets": ("_resets_stage", "_reset_envs", "_episodic_dr", "_uniform", "_randint"),
    "observations": ("_observations_stage", "compute_observations", "_obs_getters", "_motion_state_at",
                     "_extend_body_states", "_build_log", "_env_mean_logs"),
}


def eligible(engine, device) -> bool:
    """Whether a control step of the lanes `engine` on `device` may replay a
    captured graph: on a CUDA device, with kernel 1's wrapper as the contact
    solve, and with none of `HOOKS` shadowed on the engine instance."""
    return (torch.device(device).type == "cuda" and engine.contact_solve is apgd_lanes
            and not any(name in vars(engine) for name in HOOKS))


def engine_eligible(env) -> bool:
    """Whether the engine's stage of `env`'s next control step may replay:
    on a CUDA device, on the lanes engine, with no soft dynamic correction,
    and with the engine `eligible`."""
    return (env.device.type == "cuda" and env.lanes_engine is not None and not env.use_sdc
            and eligible(env.lanes_engine, env.device))


def env_eligible(env) -> bool:
    """Whether the other stages of `env`'s next control step may replay:
    `engine_eligible`, in one process, with no teleop source."""
    return engine_eligible(env) and not env.shard.distributed and env.teleop_source is None


def stage_eligible(env, stage: str) -> bool:
    """Whether none of the methods that `stage` calls is shadowed on `env`."""
    return not any(name in vars(env) for name in STAGES[stage])


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
    """The env's own tensors, its dicts and dataclasses (the motion library's
    data among them), and the tensors these hold one level down, alone or in
    tuples (`paramsT`'s values, `draw_bounds`' pairs, `sim_params`' fields),
    which its stages read as fixed: held by identity."""
    held = []
    for v in (*vars(env).values(), env.motion_lib.data):
        if isinstance(v, torch.Tensor):
            held.append(v)
        elif isinstance(v, dict) or dataclasses.is_dataclass(v):
            held.append(v)
            for x in v.values() if isinstance(v, dict) else vars(v).values():
                if isinstance(x, torch.Tensor):
                    held.append(x)
                elif isinstance(x, tuple):
                    held.extend(t for t in x if isinstance(t, torch.Tensor))
    return tuple(held)


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


def _counts() -> list:
    """Every counter of `COUNTERS`, then kernel 1's by mode."""
    return [w.launches for w in COUNTERS] + list(apgd_lanes.mode_launches.values())


def _set_counts(counts: list):
    for w, n in zip(COUNTERS, counts):
        w.launches = n
    for m, n in zip(list(apgd_lanes.mode_launches), counts[len(COUNTERS):]):
        apgd_lanes.mode_launches[m] = n


def _memory_order(t) -> list:
    """`t`'s dims from the outermost in memory to the innermost."""
    return sorted(range(t.dim()), key=lambda d: -t.stride(d))


class StageGraph:
    """One env stage `fn(*args)` captured at the shapes and layouts of the
    `args` it is built from (their tensors `leaves`, the rest described by
    `spec`). `replay(leaves)` -> what `fn` returns on arguments of those
    tensors. `written` is true where the stage writes an argument in place:
    such a graph is never replayed. A capture issues no kernel: each replay
    adds to the counters (`COUNTERS`) the launches its capture made."""

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
            # each packed in its memory order, so that a dense view (the
            # engine's outputs are transposed views) packs with no copy and
            # comes back with the strides the eager call gave it
            dims = {dt: [_memory_order(t) for t in part] for dt, part in parts.items()}
            packs = {dt: torch.cat([t.permute(d).reshape(-1) for t, d in zip(part, dims[dt])])
                     for dt, part in parts.items()}
            layout = {dt: [(t.numel(), t.permute(d).shape, [d.index(i) for i in range(t.dim())])
                           for t, d in zip(part, dims[dt])] for dt, part in parts.items()}
            return out_spec, order, layout, packs

        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        before = _counts()
        self.spec, self.order, self.layout, self.packs = _capture(self.graph, region)
        after = _counts()
        self.launches = [b - a for a, b in zip(before, after)]
        _set_counts(before)
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
        _set_counts([n + d for n, d in zip(_counts(), self.launches)])
        made = {dt: [v.view(shape).permute(back) for v, (_, shape, back) in
                     zip(p.clone().split([n for n, _, _ in self.layout[dt]]), self.layout[dt])]
                for dt, p in self.packs.items()}
        return _build(self.spec, iter([leaves[s[1]] if s[0] == "arg" else made[s[1]][s[2]] for s in self.order]))


class StageGraphs:
    """The captured steps of one owner, one graph a stage and key: an env's
    control-step stages (`run`, `STAGES`) or another owner's (`run_step`,
    the `stages` it names). Each runs eagerly where its owner's rules do not
    let it replay, else the first call at a key eagerly and then captured on
    that call's arguments, later ones replayed. `counts` holds, per stage,
    the graphed and the eager calls. (The owner is passed, not held: the
    owner holds this.)"""

    def __init__(self, stages=tuple(STAGES)):
        self.graphs = {}
        self.counts = {stage: {"graphed": 0, "eager": 0} for stage in stages}

    def run(self, env, stage: str, fn, *args):
        """`fn(*args)`, the stage `stage` of `env`'s control step."""
        ok = (engine_eligible if stage == "engine" else env_eligible)(env) and stage_eligible(env, stage)
        return self.run_step(stage, fn, args, ok, lambda: _fixed(env), lambda: (env.gen, env.shared_gen),
                             "engine.graph_replay" if stage == "engine" else "env.graph_replay")

    def run_step(self, stage, fn, args, ok: bool, fixed_of=None, generators_of=None, replay_span=None,
                 before=None):
        """`fn(*args)` for `stage`: eagerly where not `ok`, else replayed
        where a graph captured at its key holds the tensors `fixed_of()`
        gives (by identity), its captures registering the generators
        `generators_of()` gives. A replay sits in the span `replay_span`,
        after `before()` has run on the host."""
        key = None
        if ok:
            leaves = []
            spec = _flatten(args, leaves)
            if not any(t.requires_grad for t in leaves):
                key = (stage, spec, tuple((t.shape, t.dtype, t.device) for t in leaves))
                fixed = fixed_of()
                graph = self.graphs.get(key)
                if graph is not None and graph.holds(fixed):
                    self.counts[stage]["graphed"] += 1
                    with span(replay_span):
                        if before is not None:
                            before()
                        return graph.replay(leaves)
        self.counts[stage]["eager"] += 1
        if key is None or (key in self.graphs and self.graphs[key] is None):
            return fn(*args)
        out, syncs = _observed(fn, args)
        graph = None
        if not syncs:
            gens = list({id(g): g for g in generators_of()}.values())
            graph = StageGraph(fn, spec, leaves, gens, fixed)
        self.graphs[key] = None if graph is None or graph.written else graph
        return out
