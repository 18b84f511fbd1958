"""What decides `correct`: the numbers that compare the timed path's outputs
with the plain reference's (`portbench/reference/`), each held to the limit in
`portbench/limits/<cell>.json`.

Every number is a gap between two outputs on the same inputs, the first being
the program's (or, for the control, the reference's in TF32), the second the
reference's in float32:

- `forward_gap`: the networks' outputs (the rollout's action means and
  values, or the served actions), max |a - b| over max |b|.
- `solve_gap`: kernel 1's impulses on the inputs the timed path handed it,
  max |a - b| over max |b|, worst launch of the recorded step.
- `step_gap`: the recorded env step followed from the program's own state
  (`reference/tracking.py`): the worst of each substep's velocity change and
  positions, the closing body states and contact forces, the torques against
  the PD law and the physics columns of the reward.
- `env_action_gap`: the last action as the env's next observation holds it,
  against the action the policy gave, over envs that did not reset: exact,
  max |a - b|.
- `loss_gap`: each of the first minibatch updates' loss, |a - b| over the
  sum of the absolute terms of b (the terms can cancel), worst step.
- `grad_gap`: the first update's clipped gradient as the optimizer got it
  (its first moment over 1 - b1), by the worst leaf: the gap between the two
  norms over the larger of the leaf's reference norm and the median leaf's.
- `change_gap`: the parameters' change after the recorded updates, measured
  as `grad_gap`. Leaves whose reference gradient is under a thousandth of
  the median leaf's are left out: Adam moves them by round-off alone.
"""
from __future__ import annotations

import math
import statistics

from .reference import apgd
from .window import to


def rel_max(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def leaf_gap(a_leaves, b_leaves, keep=None) -> float:
    """Worst leaf's |‖a‖ - ‖b‖| over max(‖b‖, the median leaf's ‖b‖)."""
    na = [float(x.double().norm()) for x in a_leaves]
    nb = [float(x.double().norm()) for x in b_leaves]
    med = statistics.median(nb)
    idx = range(len(nb)) if keep is None else keep
    return max(abs(na[i] - nb[i]) / max(nb[i], med, 1e-30) for i in idx)


def check_leaves(prog, ref):
    if [p.numel() for p in prog] != [r.numel() for r in ref]:
        raise ValueError("the program's parameters do not line up with the reference's leaves")


def step_numbers(refs, rec, device, prog: dict, ctrl: dict):
    """The env step's numbers from a recorded step, into `prog` (and the
    control's into `ctrl`): `solve_gap` on the kernel's own inputs,
    `step_gap` the worst part of the step followed from the program's
    state (`reference/tracking.py`)."""
    if rec is None:
        return
    rec = to(rec, device)
    solves = rec["solves"]
    args = lambda s: (s["A"], s["b"], s["mu"], s["active"], s["x0"], s["iters"])
    want = [apgd.solve(*args(s), "float32") for s in solves]
    prog["solve_gap"] = max(rel_max(s["out"], w) for s, w in zip(solves, want))
    prog["step_gap"] = max(refs["step"].parts(rec).values())
    if "step_lo" in refs:
        lo = refs["step_lo"]
        ctrl["solve_gap"] = max(rel_max(apgd.solve(*args(s), lo.precision), w) for s, w in zip(solves, want))
        ctrl["step_gap"] = max(refs["step"].parts(rec, lo).values())


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): every limited number present and within its limit."""
    ok = all(numbers.get(k) is not None and numbers[k] <= lim for k, lim in limits.items())
    # a value that is not finite is shown as text: the line stays JSON
    shown = lambda v: v if v is None or math.isfinite(v) else str(v)
    return ok, {k: {"value": shown(numbers.get(k)), "limit": lim} for k, lim in limits.items()}
