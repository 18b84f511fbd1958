"""The lanes engine's control step replayed as one CUDA graph.

On a card the env step is bound by the host: the lanes engine's control step
(`LanesEngine.control_step_batched`: `decimation` substeps of FK, CRBA, RNEA,
M⁻¹, the Jacobian, the Delassus products, kernel 1, the energy safeguard and
the position pass, then the closing derived state) issues thousands of small
kernels, one eager op at a time. `ControlStepGraph` captures that whole
control step once and replays it with one `cudaGraphLaunch`. The kernels and
their arithmetic are the eager step's; only how they are issued changes.

Every tensor the captured region reads is of one of two kinds:
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

`eligible` is the rule by which a control step may replay. It reads only
what the code can observe: the device, the soft-dynamic-correction hook,
and whether the engine's step is hooked on the instance. A recorder that
replaces `control_step_batched` or `contact_solve` for one call, a planted
fault, or a swapped plain solve keeps that step eager.

The spans inside the engine (`engine.dynamics`, `engine.contact`,
`engine.position_pass`) fire only on eager steps: a replay issues no op
from Python. A replay sits in the span `engine.graph_replay`. Kernel 1's
launch counters count replays: each adds the launches it captured.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from pbhc_tpu_torch.sim.contact_kernel import apgd_lanes
from pbhc_tpu_torch.utils.profiling import span

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
        # thread_local: other threads of the process (a data-parallel rank's,
        # a listener's) may use the device while this one captures
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
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
